"""Int8 quantised serving path, the port of the JAX package's ``ops/quant.py``.

A *serving* mode beside the bf16 kernels: strict-parity scoring stays
f32/bf16. Scheme, as in the JAX package: weights per-output-channel symmetric
int8; activations dynamically quantised per row (symmetric, abs-max);
y = (x_q @ w_q) * (sx * sw), the bias added in f32. LayerNorm, softmax and
the heads stay f32; embeddings stay full precision (gathers are no matmul
work).

* ``quantize_kernel`` / ``dense_q8`` / ``quantize_dense_tree`` /
  ``is_quantized`` / ``cast_residual_bf16``: the JAX functions at the same
  names, on torch trees. ``models/core.py:dense`` sends a ``kernel_q8`` node
  to ``dense_q8``; an int8 attention or FFN node takes the unfused route
  under every backend (the JAX package's ``models/core.py`` :282-286,
  :478-481), so ``int8-ffn`` runs the attention-block kernels beside the
  int8 FFN and full ``int8`` runs no block kernel.
* The int8 product is ``torch._int_mm`` (int8 x int8 -> int32, exact), a
  plain matrix product as the JAX package's ``lax.dot_general`` is: the JAX
  module is XLA, no Pallas kernel. Its CUDA form takes M > 16 rows, K and N
  multiples of 8 and, at some shapes, only a column-major weight;
  ``int8_matmul`` zero-pads the operands to those (exact in integer
  arithmetic), keeps the weight column-major and slices the padding off. The per-row quant and the
  dequant are plain torch passes.
* ``quantize_for_serving``: the ``--quantize int8|int8-ffn`` modes of
  ``cli/export.py`` on a loaded model, in the JAX script's order
  (``scripts/export.py`` :126-151): quantised on the JAX-layout tree (so
  ImageBERT-B's label conv, taps there, stays unquantised as in JAX), the
  scoring heads ``cls`` skipped, ``cast_residual_bf16`` under bf16, then the
  spec's own ``from_jax`` step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Params = dict

QUANT_KERNEL = "kernel_q8"
QUANT_SCALE = "kernel_scale"
# --quantize modes -> quantize_dense_tree's only_paths: int8-ffn quantises only the FFN denses
# (the >=2048-wide contractions), the attention projections stay bf16
MODES = {"int8": None, "int8-ffn": ("ffn",)}
SKIP_PATHS = ("cls",)  # the margin-sensitive scoring heads stay full precision
# torch._int_mm on CUDA: more than 16 rows, K and N multiples of 8
INT_MM_MIN_ROWS, INT_MM_MULTIPLE = 17, 8


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-8) / 127, the IEEE quotient on every device: the divisor is a
    0-d tensor on amax's device, since CUDA divides by a Python scalar as a
    product with its rounded reciprocal (a scale one ulp off JAX's and the CPU's)."""
    return torch.clamp_min(amax, 1e-8) / torch.full((), 127.0, device=amax.device)


def quantize_kernel(kernel: torch.Tensor) -> dict:
    """f32 [..., in, out] -> {kernel_q8 int8 [..., in, out], kernel_scale f32
    [..., out]}. Leading dims (the stacked [L, in, out] encoder kernels)
    quantise per (layer, output channel). ``kernel_q8`` is stored once in the
    layout ``torch._int_mm`` takes fastest on the card, each [in, out] matrix
    column-major (its transpose contiguous): 4.5-5.9x faster than row-major
    at the FFN shapes on the H100 (``cli/perf_lab.py int8``, ``PERF.md``); the
    values are the same."""
    k = kernel.float()
    scale = _scale(k.abs().amax(dim=-2))  # per output channel
    q = torch.clamp(torch.round(k / scale[..., None, :]), -127, 127).to(torch.int8)
    return {QUANT_KERNEL: q.transpose(-1, -2).contiguous().transpose(-1, -2), QUANT_SCALE: scale}


def _pad_to(n: int, multiple: int) -> int:
    return (-n) % multiple


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a int8 [M, K] @ w int8 [K, N] -> int32 [M, N], exact: ``torch._int_mm``,
    on CUDA with M, K and N zero-padded to its shape rules first (the padding
    adds zero products) and sliced off after."""
    m, k = a.shape
    n = w.shape[1]
    if not a.is_cuda:
        return torch._int_mm(a, w)
    pk, pn = _pad_to(k, INT_MM_MULTIPLE), _pad_to(n, INT_MM_MULTIPLE)
    pm = max(INT_MM_MIN_ROWS - m, 0)
    if pk or pm:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        w = F.pad(w, (0, pn, 0, pk))
    if w.stride(0) != 1:  # cuBLASLt refuses a row-major weight at some shapes (K=8): column-major, as stored
        w = w.t().contiguous().t()
    out = torch._int_mm(a, w)
    return out[:m, :n] if (pm or pn) else out


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The dynamic activation quant of ``dense_q8``: x [..., K] -> (int8 [..., K],
    f32 per-row scales [..., 1]), symmetric abs-max."""
    xf = x.float()
    x_scale = _scale(xf.abs().amax(dim=-1, keepdim=True))
    return torch.clamp(torch.round(xf / x_scale), -127, 127).to(torch.int8), x_scale


def dequantize(acc: torch.Tensor, x_scale: torch.Tensor, p: Params) -> torch.Tensor:
    """The int32 sums -> ``acc * x_scale * kernel_scale + bias`` in f32, in
    that order (the JAX function's roundings)."""
    return acc.float() * x_scale * p[QUANT_SCALE] + p["bias"].float()


def dense_q8(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Quantised dense: dynamic per-row activation quant (``quantize_rows``),
    the int8 product with int32 sums, then ``dequantize``."""
    x_q, x_scale = quantize_rows(x)
    lead = x_q.shape[:-1]
    acc = int8_matmul(x_q.reshape(-1, x_q.shape[-1]), p[QUANT_KERNEL]).reshape(*lead, -1)
    return dequantize(acc, x_scale, p)


def quantize_dense_tree(params, *, skip_paths: tuple[str, ...] = (),
                        only_paths: tuple[str, ...] | None = None) -> Params:
    """Replace every {kernel, bias} dense of the tree with its int8 form.

    ``skip_paths``: substrings of the '/'-joined path to leave in full
    precision; ``only_paths``: if given, quantise only the denses whose path
    contains one of them (``("ffn",)``: the FFN-only serving mode)."""

    def rec(node, path: str):
        if isinstance(node, dict):
            if "kernel" in node and "bias" in node and node["kernel"].dim() >= 2:
                wanted = only_paths is None or any(s in path for s in only_paths)
                if wanted and not any(s in path for s in skip_paths):
                    return {**quantize_kernel(node["kernel"]), "bias": node["bias"]}
            return {k: rec(v, f"{path}/{k}") for k, v in node.items()}
        return node

    return rec(params, "")


def is_quantized(p: Params) -> bool:
    return QUANT_KERNEL in p


def cast_residual_bf16(params: Params, *, skip_paths: tuple[str, ...] = ()) -> Params:
    """Cast the remaining f32 leaves of a quantised tree to bf16 (embeddings,
    LayerNorms, biases), keeping the ``kernel_scale`` factors f32 (they
    multiply an int32 sum; bf16 would re-quantise the dequantisation);
    ``skip_paths`` keeps whole subtrees f32."""

    def rec(node, keys: tuple[str, ...]):
        if isinstance(node, dict):
            return {k: rec(v, (*keys, k)) for k, v in node.items()}
        if node.dtype != torch.float32 or QUANT_SCALE in keys:
            return node
        if skip_paths and any(s in "/".join(keys) for s in skip_paths):
            return node
        return node.to(torch.bfloat16)

    return rec(params, ())


def quantize_for_serving(spec, params: Params, mode: str, bf16_residual: bool) -> Params:
    """A loaded model's params (``checkpoint.load_checkpoint``'s) -> its
    ``mode`` ("int8" or "int8-ffn") tree, in the form that scores: quantised
    on the JAX-layout tree with ``cls`` skipped, the residual leaves cast to
    bf16 when ``bf16_residual``, then ``spec.from_jax``."""
    from ..checkpoint.npz import params_from_jax, params_to_jax

    if mode not in MODES:
        raise ValueError(f"unknown quantize mode {mode!r}, expected one of {tuple(MODES)}")
    if spec.name == "two_tower":
        raise ValueError("--quantize is not supported for two_tower embedders")
    tree = quantize_dense_tree(params_from_jax(params_to_jax(params)), skip_paths=SKIP_PATHS,
                               only_paths=MODES[mode])
    if bf16_residual:
        tree = cast_residual_bf16(tree, skip_paths=SKIP_PATHS)
    return spec.from_jax(tree)
