"""Multi-head attention for short cross-modal sequences (10-43 tokens), and
the attention backend that the encoder blocks follow (the JAX package's
``ops/attention.py``):

* ``"xla"`` (the default): the unfused route of ``models/core.py``, whose
  attention core is ``mha_xla``, plain PyTorch;
* ``"pallas"``: the same route with the core as the hand-written ``mha``
  kernel (``csrc/mha.cu``), one launch per self-attention;
* ``"pallas_packed"``: the fused blocks of ``models/core.py:KERNEL_BLOCKS``.

``best_mha`` picks between the ``mha`` kernel and ``mha_xla`` by timing both
once per shape on the card (the JAX package's ``_backend_choice``/``best_mha``,
``ops/pallas_attention.py`` :1011-1053); a kernel that fails to build or
launch raises, it never falls back.

BERT semantics (reference ``pixelmodel.py:640-833``): scores = QK^T / sqrt(Dh)
+ bias, softmax over keys, no padding mask unless a bias is given
(ImageBERT-A gives none). Softmax runs in float32 whatever the compute
dtype: with 2-class heads downstream, a bf16 softmax would burn the whole
1e-3 parity budget. The probabilities are rounded to the value dtype before
the PV product, as the JAX package's XLA and Pallas paths both do.
"""

from __future__ import annotations

import contextlib
import functools

import torch

BACKENDS = ("xla", "pallas", "pallas_packed")
_backend = "xla"


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, H] -> [B, N, S, H/N]."""
    b, s, h = x.shape
    return x.reshape(b, s, num_heads, h // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, N, S, Hd] -> [B, S, N*Hd]."""
    b, n, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, n * hd)


def mha_xla(
    q: torch.Tensor,  # [B, N, F, Hd]
    k: torch.Tensor,  # [B, N, T, Hd]
    v: torch.Tensor,  # [B, N, T, Hd]
    bias: torch.Tensor | None = None,  # additive, broadcastable to [B, N, F, T]
) -> torch.Tensor:
    """f32 scores and softmax on the given (possibly bf16) q/k/v; the output
    has v's dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(v.dtype)


def set_attention_backend(name: str) -> None:
    """Select "xla" (the default), "pallas" or "pallas_packed" for the encoder blocks."""
    global _backend
    if name not in BACKENDS:
        raise ValueError(f"unknown attention backend {name!r}, expected one of {BACKENDS}")
    _backend = name


def packed_attention_active() -> bool:
    return _backend == "pallas_packed"


@contextlib.contextmanager
def attention_backend(name: str):
    """The backend ``name`` inside the block, the previous one after it."""
    prev = _backend
    set_attention_backend(name)
    try:
        yield
    finally:
        set_attention_backend(prev)


def mha(q, k, v, bias=None) -> torch.Tensor:
    """Backend-dispatching attention core of the unfused route: the ``mha``
    kernel under "pallas", ``mha_xla`` otherwise. [B, N, S, Dh] in and out."""
    if _backend == "pallas":
        from .library import mha as mha_kernel  # here: library imports kernels, which imports this module

        return mha_kernel(q, k, v, bias)
    return mha_xla(q, k, v, bias)


def mha_packed(q, k, v, num_heads: int, bias=None) -> torch.Tensor:
    """Packed-layout attention, the ``mha_packed`` kernel: [B, S, H] in and out."""
    from .library import mha_packed as mha_packed_kernel

    return mha_packed_kernel(q, k, v, num_heads, bias)


def mask_to_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[.., T] 1/0 keep-mask -> additive bias with -10000 at masked slots
    (the reference's ``(1 - mask) * -10000``, ``pixelmodel.py:787-798``)."""
    return ((1.0 - mask.float()) * -10000.0).to(dtype)


@functools.lru_cache(maxsize=16)
def _backend_choice(shape_key) -> tuple[str, float, float]:
    """Time the ``mha`` kernel and ``mha_xla`` once per (B, N, S, Dh, has_bias,
    dtype) on the current CUDA device, on random inputs of that shape (a
    [B, 1, 1, S] key-mask bias when ``has_bias``): 10 calls each after one
    warm-up, between CUDA events. -> (the faster: "pallas" or "xla", kernel ms
    a call, mha_xla ms a call). A kernel that fails raises."""
    from .library import mha as mha_kernel

    b, n, s, dh, has_bias, dtype_name = shape_key
    dtype = getattr(torch, dtype_name.removeprefix("torch."))
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, n, s, dh, generator=gen, device="cuda").to(dtype) for _ in range(3))
    bias = torch.randn(b, 1, 1, s, generator=gen, device="cuda") if has_bias else None

    def time_fn(fn) -> float:
        fn(q, k, v, bias)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn(q, k, v, bias)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 10

    t_kernel, t_xla = time_fn(mha_kernel), time_fn(mha_xla)
    return ("pallas" if t_kernel < t_xla else "xla"), t_kernel, t_xla


def backend_choice(q, bias=None) -> str:
    """The route ``best_mha`` takes for ``q``'s shape and dtype: the faster of
    the two on the card; "xla" for a CPU tensor, where there is no kernel to time."""
    if not q.is_cuda:
        return "xla"
    return _backend_choice((*q.shape, bias is not None, str(q.dtype)))[0]


def best_mha(q, k, v, bias=None) -> torch.Tensor:
    """Attention on the route ``backend_choice`` picks (cached per shape and dtype)."""
    if backend_choice(q, bias) == "pallas":
        from .library import mha as mha_kernel

        return mha_kernel(q, k, v, bias)
    return mha_xla(q, k, v, bias)
