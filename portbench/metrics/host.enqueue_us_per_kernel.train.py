"""The host's time in the training step's forward and backward and its optimizer (the program's
``train.forward_backward`` and ``train.optimizer`` spans) in the traced window, over the device kernels the
window ran, in microseconds.

The time holds the cost of the profiler's ranges opened inside the spans (the ``block.*_train`` and
``block.*_train_bwd`` spans of each layer, the ``optim.*`` spans), so the number compares two versions of the
program only where both open the same spans there."""

from portbench.yardstick import spans


def read(ctx: dict) -> float | None:
    host, kernels = spans.total_s("train.forward_backward", "train.optimizer"), ctx["trace"]["kernels"]
    if host is None or not kernels:
        return None
    return 1e6 * host / kernels
