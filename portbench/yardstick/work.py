"""The work each operation of a cell needs, counted from the shapes: FLOPs and
bytes per operation, each input read once and each output written once
(bf16 operands and activations, f32 weight gradients), whatever kernel runs
it and however often it reads. Recomputation, padding rows and layout
copies are the program's choice and are not counted; only the pairs that are
scored or stepped are.

Classes: ``gemm`` (the model's matrix products) and ``attention`` (the
softmax attention core: QK^T, softmax, PV, and in training their backward).
``model_flops`` is every counted operation's FLOPs."""

from __future__ import annotations

from collections import defaultdict

BF16, F32 = 2, 4


def gemm(m: int, k: int, n: int, out_bytes: int = BF16, a_bytes: int = BF16, b_bytes: int = BF16):
    """[m, k] x [k, n] -> (flops, bytes)."""
    return 2 * m * k * n, m * k * a_bytes + k * n * b_bytes + m * n * out_bytes


def attention_forward(pairs: int, heads: int, s: int, h: int, masked: bool):
    """QK^T, softmax and PV over ``heads`` heads of width h / heads: reads qkv [s, 3h], writes ctx [s, h]."""
    return 4 * pairs * s * s * h, pairs * (s * 3 * h * BF16 + s * h * BF16 + (s * F32 if masked else 0))


def attention_backward(pairs: int, heads: int, s: int, h: int, masked: bool):
    """dV, dP, dQ, dK: reads qkv [s, 3h] and dctx [s, h], writes dqkv [s, 3h]."""
    return 8 * pairs * s * s * h, pairs * (2 * s * 3 * h * BF16 + s * h * BF16 + (s * F32 if masked else 0))


def label_conv(rows: int, h: int, taps: int = 8, left: int = 3):
    """The SAME ``taps``-tap conv over ``taps`` positions of ``rows`` boxes, at the (position, tap) pairs
    that fall inside: reads [rows, taps h] and the taps [taps, h, h], writes [rows, taps h] f32."""
    inside = sum(1 for w in range(taps) for t in range(taps) if 0 <= t - w + left < taps)
    return 2 * rows * inside * h * h, rows * taps * h * BF16 + taps * h * h * BF16 + rows * taps * h * F32


def label_conv_backward(rows: int, h: int, taps: int = 8, left: int = 3):
    """dx (bf16) and the taps' f32 gradient of ``label_conv``."""
    f, _ = label_conv(rows, h, taps, left)
    dx = rows * taps * h * BF16 + taps * h * h * BF16 + rows * taps * h * BF16
    dw = 2 * rows * taps * h * BF16 + taps * h * h * F32
    return [(f, dx), (f, dw)]


def _encoder_sites(rows: int, c: dict):
    h, i = c["hidden_size"], c["intermediate_size"]
    return [(rows, h, 3 * h), (rows, h, h), (rows, h, i), (rows, i, h)]


def imagebert_a_score(batch_rows: list[int], c: dict) -> dict:
    """-> {"gemm": [(flops, bytes)], "attention": [...], "model_flops": N} of scoring batches of
    ``batch_rows`` pairs each."""
    out = defaultdict(list)
    h, layers, s = c["hidden_size"], c["num_hidden_layers"], c["seq_len"]
    for pairs in batch_rows:
        for _ in range(layers):
            out["gemm"] += [gemm(m, k, n) for m, k, n in _encoder_sites(pairs * s, c)]
            out["attention"].append(attention_forward(pairs, c["num_attention_heads"], s, h, masked=False))
        out["gemm"] += [gemm(pairs * 10, c["feature_dim"], h, out_bytes=F32), gemm(pairs, h, h, out_bytes=F32),
                        gemm(pairs, h, 2, out_bytes=F32)]
    return {**out, "model_flops": sum(f for ops in out.values() for f, _ in ops)}


def imagebert_b_train(steps: int, batch: int, c: dict) -> dict:
    """-> {"gemm", "attention", "model_flops"} of ``steps`` training steps of ``batch`` pairs: the
    forward, dx and weight-gradient products, the attention core forward and backward;
    ``model_flops`` is 3 x the forward's FLOPs."""
    out = defaultdict(list)
    h, layers, s = c["hidden_size"], c["num_hidden_layers"], c["seq_len"]
    rows, boxes = batch * s, batch * 10
    fwd_flops = 0
    for _ in range(steps):
        sites = _encoder_sites(rows, c) * layers + [(boxes, h, h), (batch, h, h)]  # + featureemb, pooler
        for m, k, n in sites:
            f = gemm(m, k, n)
            out["gemm"] += [f, gemm(m, n, k), gemm(k, m, n, out_bytes=F32)]  # forward, dx, weight gradient
            fwd_flops += f[0]
        f = gemm(boxes, c["feature_dim"], h)  # the feature dense: its input needs no gradient
        out["gemm"] += [f, gemm(c["feature_dim"], boxes, h, out_bytes=F32)]
        conv = label_conv(boxes, h)
        out["gemm"] += [conv, *label_conv_backward(boxes, h)]
        fwd_flops += f[0] + conv[0]
        for _ in range(layers):
            a = attention_forward(batch, c["num_attention_heads"], s, h, masked=True)
            out["attention"] += [a, attention_backward(batch, c["num_attention_heads"], s, h, masked=True)]
            fwd_flops += a[0]
    return {**out, "model_flops": 3 * fwd_flops}
