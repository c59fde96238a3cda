"""The plain reference: f32 PyTorch and NumPy written from the reference's
description. It imports nothing of the port and nothing of JAX."""
