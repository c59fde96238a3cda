"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
700 W limit), and the card's own name and power limit as ``nvidia-smi``
reports them, printed beside every run's numbers."""

from __future__ import annotations

import subprocess

BF16_FLOPS = 989e12  # FLOP/s, bf16 and fp16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12  # bytes/s


def least_seconds(ops) -> float:
    """The least time the card needs for ``ops`` [(flops, bytes)]: per operation the larger of its
    FLOPs over the bf16 peak and its bytes over the HBM bandwidth."""
    return sum(max(f / BF16_FLOPS, b / HBM_BYTES_PER_S) for f, b in ops)


def card() -> str:
    """``name, power.limit`` of the first card, or why it could not be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi failed"
