"""Perf lab: targeted measurements of the port on the card, the counterpart
of the JAX package's ``scripts/perf_lab.py``. Each subcommand prints one JSON
line a measurement:

  model    <name> [B]              whole-model scoring throughput (bf16, the engine's default route)
  model_q8 <name> [B] [ffn|full]   the int8 serving mode (``ops/quant.py``; FFN-only by default)
  artifact <dir> [B]               a reloaded ``cli/export.py`` artifact's throughput
  stages   <name> [B]              per-stage split: embed / encoder / total (LXMERT: total)
  train    <name> [B]              a full train step (the train blocks' kernels)
  grad     <name> [B] [nodrop]     forward + backward of the loss alone (dropout off with nodrop)
  opt      <name>                  clip + optimizer + EMA alone
  attn     <S> [B]                 the attention block at sequence S (key mask); attn_nobias without it
  ffn      <S> [B]                 the FFN block
  cross    <F> <T> [B]             the cross-attention block, F queries over T keys
  dualcross <F> <T> [B]            the dual cross block (both directions, one attention launch)
  int8     [M K N]                 ``torch._int_mm`` vs ``gemm_bf16``, and the int8 dense vs the bf16 dense
  host     [rows] [batch]          host input-pipeline rows/s (no device)
  trace    <name> <B> <dir>        a ``torch.profiler`` trace around scoring steps, the program's spans in it
  trace_train <name> <B> <dir>     the same around 2 training steps

Device times are CUDA events around ``--iters`` calls after one warm-up (the
host's clock on the CPU); inputs are staged on the device first. Every line
carries the card's name and power limit. Example, on the card:

  python -m kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.perf_lab model_q8 imagebert_a 512 ffn

The JAX script's Pallas tuning knobs mean nothing here and are refused:
``KMR_BLOCKS`` (its ``block_b`` sweep; the port's kernels choose their own
tiles) and the ``attn_hm``/``attn_hp``/``cross_hp`` variants (no port kernel:
the head-major variant is an optional item of ROADMAP.md Queue 2) exit 2.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, dense: bf16 and int8 tensor-core rates, HBM3
PEAK_BF16_FLOPS, PEAK_INT8_OPS, HBM_BYTES_PER_S = 989e12, 1979e12, 3.35e12
REFUSED = {"attn_hm": "ROADMAP.md Queue 2 (the optional head-major attention variant)",
           "attn_hp": "ROADMAP.md Queue 2 (no head-packed attention kernel in the port)",
           "cross_hp": "ROADMAP.md Queue 2 (no head-packed cross-attention kernel in the port)"}
H, N_HEADS, INTER = 768, 12, 3072
CARD = "cpu"  # every line's "card": nvidia-smi's name and power limit, set by main on the card


def card() -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if not torch.cuda.is_available():
        return "cpu"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=30, check=True)
    return r.stdout.strip().splitlines()[0]


def emit(**kw) -> None:
    print(json.dumps({**kw, "card": CARD}), flush=True)


def timed_ms(fn, device: torch.device, iters: int) -> float:
    """ms a call of ``fn``: CUDA events around ``iters`` calls after a warm-up (host clock on the CPU)."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def scorer_engine(name: str, device, params=None, precision=None):
    from ..models import get_model
    from ..parallel import ScoringEngine

    spec = get_model(name)
    engine = ScoringEngine(spec, spec.init_params(0) if params is None else params, device=device,
                           precision=precision)
    return spec, engine


def _feats(spec, engine, b: int) -> dict:
    from ..data.batchspec import example_batch

    batch = example_batch(spec.name, spec.config, b, np.random.default_rng(0))
    batch.setdefault("labels", np.ones((b,), np.int32))
    return engine.to_device(batch)


def time_engine(spec, engine, b: int, iters: int) -> float:
    from ..ops import attention

    feats = _feats(spec, engine, b)

    def run():
        with torch.inference_mode(), attention.attention_backend(engine.attention_backend):
            return spec.apply(engine.params, feats, spec.config, engine.precision)["score"]

    return timed_ms(run, engine.device, iters)


def cmd_model(name: str, b: int, device, iters: int) -> None:
    spec, engine = scorer_engine(name, device)
    ms = time_engine(spec, engine, b, iters)
    emit(cmd="model", model=name, B=b, backend=engine.attention_backend, ms=ms, pairs_per_sec=b / ms * 1e3)


def cmd_model_q8(name: str, b: int, mode: str, device, iters: int) -> None:
    """The int8 serving tree of ``cli/export.py --quantize`` (the residual leaves bf16 on the card) on the
    engine's default route: ``int8-ffn`` keeps the attention-block kernels, ``int8`` runs no block kernel."""
    from ..models import get_model
    from ..ops.quant import quantize_for_serving
    from ..parallel.engine import default_precision

    if mode not in ("ffn", "full"):
        raise SystemExit(f"model_q8 mode must be 'ffn' or 'full', got {mode!r}")
    spec = get_model(name)
    prec = default_precision(device)
    params = quantize_for_serving(spec, spec.init_params(0), "int8-ffn" if mode == "ffn" else "int8",
                                  bf16_residual=prec.compute_dtype == torch.bfloat16)
    spec, engine = scorer_engine(name, device, params, prec)
    ms = time_engine(spec, engine, b, iters)
    emit(cmd="model_q8", model=name, B=b, mode=mode, backend=engine.attention_backend, ms=ms,
         pairs_per_sec=b / ms * 1e3)


def cmd_artifact(artifact_dir: str, b: int | None, device, iters: int) -> None:
    from ..data.batchspec import example_batch
    from ..models import get_model
    from ..serving import load_scorer

    scorer = load_scorer(artifact_dir)
    meta = scorer.meta
    b = scorer.batch_size or b or 8192
    spec = get_model(meta["model"], overrides=meta.get("config_overrides") or None)
    batch = example_batch(meta["model"], spec.config, b, np.random.default_rng(0))
    dev = torch.device(meta["device"])
    feats = {k: torch.from_numpy(batch[k]).to(dev) for k in scorer.feature_keys}

    def run():
        with torch.inference_mode():
            return scorer.module(feats)

    ms = timed_ms(run, dev, iters)
    emit(cmd="artifact", dir=str(artifact_dir), model=meta["model"], B=b, backend=meta.get("attention_backend"),
         quantize=meta.get("quantize"), overrides=meta.get("config_overrides"), ms=ms, pairs_per_sec=b / ms * 1e3)


def cmd_stages(name: str, b: int, device, iters: int) -> None:
    from ..models import core, imagebert_a, imagebert_b
    from ..ops import attention

    spec, engine = scorer_engine(name, device)
    feats, cfg, prec, p = _feats(spec, engine, b), spec.config, engine.precision, engine.params
    total = time_engine(spec, engine, b, iters)
    if name == "lxmert":
        emit(cmd="stages", model=name, B=b, total_ms=total)
        return
    mod = imagebert_a if name == "imagebert_a" else imagebert_b
    scope = attention.attention_backend(engine.attention_backend)
    with torch.inference_mode(), scope:
        embed_ms = timed_ms(lambda: mod.embed(p, feats, cfg, prec), engine.device, iters)
        x = mod.embed(p, feats, cfg, prec)
        bias = None if name == "imagebert_a" else attention.mask_to_bias(imagebert_b.input_mask(feats))
        enc_ms = timed_ms(lambda: core.encoder(p["bert"]["encoder"], x, bias, cfg, prec), engine.device, iters)
    emit(cmd="stages", model=name, B=b, embed_ms=embed_ms, encoder_ms=enc_ms, total_ms=total)


def _trainer(name: str, device, dropout: bool = True):
    from ..models import get_model
    from ..train import Trainer

    spec = get_model(name, overrides=None if dropout else {"hidden_dropout_prob": 0.0,
                                                            "attention_probs_dropout_prob": 0.0})
    trainer = Trainer(spec, device=device)
    return spec, trainer, trainer.init_state(seed=0)


def _train_batch(spec, trainer, b: int) -> dict:
    from ..data.batchspec import example_batch

    batch = example_batch(spec.name, spec.config, b, np.random.default_rng(0))
    batch["labels"] = np.ones((b,), np.int32)
    return trainer.to_device(batch)


def cmd_train(name: str, b: int, device, iters: int) -> None:
    spec, trainer, state = _trainer(name, device)
    batch = _train_batch(spec, trainer, b)
    ms = timed_ms(lambda: trainer.train_step(state, batch, seed=1), trainer.device, iters)
    emit(cmd="train", model=name, B=b, ms=ms, pairs_per_sec=b / ms * 1e3)


def cmd_grad(name: str, b: int, with_dropout: bool, device, iters: int) -> None:
    spec, trainer, state = _trainer(name, device, dropout=with_dropout)
    batch = _train_batch(spec, trainer, b)
    ms = timed_ms(lambda: trainer.grads(state, batch, seed=1), trainer.device, iters)
    emit(cmd="grad", model=name, B=b, dropout=with_dropout, ms=ms)


def cmd_opt(name: str, device, iters: int) -> None:
    _, trainer, state = _trainer(name, device)
    grads = [torch.full_like(p, 1e-6) for p in state.leaves()]
    ms = timed_ms(lambda: trainer.apply(state, [g.clone() for g in grads]), trainer.device, iters)
    emit(cmd="opt", model=name, ms=ms)


def _block_weights(device, seed: int = 0) -> dict:
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(*shape, generator=gen)).to(device, dtype)

    bf = torch.bfloat16
    return {"wqkv": randn(H, 3 * H, scale=H**-0.5, dtype=bf), "bqkv": randn(3 * H, scale=0.05),
            "wq": randn(H, H, scale=H**-0.5, dtype=bf), "bq": randn(H, scale=0.05),
            "wkv": randn(H, 2 * H, scale=H**-0.5, dtype=bf), "bkv": randn(2 * H, scale=0.05),
            "wo": randn(H, H, scale=H**-0.5, dtype=bf), "bo": randn(H, scale=0.05),
            "w1": randn(H, INTER, scale=H**-0.5, dtype=bf), "b1": randn(INTER, scale=0.05),
            "w2": randn(INTER, H, scale=INTER**-0.5, dtype=bf), "b2": randn(H, scale=0.05),
            "g": 1.0 + randn(H, scale=0.1), "be": randn(H, scale=0.05), "randn": randn}


def _key_mask(b: int, s: int, device, seed: int = 7) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(-10000.0 * (rng.random((b, s)) < 0.3).astype(np.float32)).to(device)


def cmd_attn(s: int, b: int, with_bias: bool, device, iters: int) -> None:
    from ..models.core import KERNEL_BLOCKS

    w = _block_weights(device)
    dt = torch.bfloat16 if device.type == "cuda" else torch.float32
    x, bias = w["randn"](b, s, H, dtype=dt), _key_mask(b, s, device) if with_bias else None
    ms = timed_ms(lambda: KERNEL_BLOCKS.attention(x, w["wqkv"], w["bqkv"], w["wo"], w["bo"], w["g"], w["be"],
                                                  N_HEADS, bias), device, iters)
    emit(cmd="attn" if with_bias else "attn_nobias", S=s, B=b, bias=with_bias, ms=ms)


def cmd_ffn(s: int, b: int, device, iters: int) -> None:
    from ..models.core import KERNEL_BLOCKS

    w = _block_weights(device)
    dt = torch.bfloat16 if device.type == "cuda" else torch.float32
    x = w["randn"](b, s, H, dtype=dt)
    ms = timed_ms(lambda: KERNEL_BLOCKS.ffn(x, w["w1"], w["b1"], w["w2"], w["b2"], w["g"], w["be"]), device, iters)
    emit(cmd="ffn", S=s, B=b, ms=ms)


def cmd_cross(f: int, t: int, b: int, dual: bool, device, iters: int) -> None:
    from ..models.core import KERNEL_BLOCKS

    w = _block_weights(device)
    dt = torch.bfloat16 if device.type == "cuda" else torch.float32
    x, ctx = w["randn"](b, f, H, dtype=dt), w["randn"](b, t, H, dtype=dt)
    if dual:
        lb, vb = _key_mask(b, f, device), _key_mask(b, t, device, 8)
        ms = timed_ms(lambda: KERNEL_BLOCKS.dual(x, ctx, w["wqkv"], w["bqkv"], w["wo"], w["bo"], w["g"], w["be"],
                                                 N_HEADS, lb, vb), device, iters)
        emit(cmd="dualcross", F=f, T=t, B=b, ms=ms)
        return
    bias = _key_mask(b, t, device)
    ms = timed_ms(lambda: KERNEL_BLOCKS.cross(x, ctx, w["wq"], w["bq"], w["wkv"], w["bkv"], w["wo"], w["bo"], w["g"],
                                              w["be"], N_HEADS, bias), device, iters)
    emit(cmd="cross", F=f, T=t, B=b, ms=ms)


def cmd_int8(m: int, k: int, n: int, device, iters: int) -> None:
    """One [M, K] x [K, N] product: ``torch._int_mm`` (int8 -> int32; the weight row-major and column-major)
    and ``gemm_bf16`` (bf16 -> f32, on the card; the plain product on the CPU), each beside its bound; then the whole dense layer, ``dense_q8`` (the
    row quant, the int8 product and the dequant) against the bf16 dense of ``models/core.py``."""
    from ..models.core import Precision, dense
    from ..ops.library import gemm
    from ..ops.quant import dense_q8, quantize_kernel

    ops = 2.0 * m * k * n
    gen = torch.Generator().manual_seed(0)
    a8 = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8).to(device)
    w8 = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8).to(device)
    int8_bound = max((m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S, ops / PEAK_INT8_OPS) * 1e3
    # torch._int_mm itself, the weight row-major (as drawn) and column-major (as quantize_kernel stores it)
    for case, w in (("matmul_int8_row_major_weight", w8), ("matmul_int8", w8.t().contiguous().t())):
        int8_ms = timed_ms(lambda w=w: torch._int_mm(a8, w), device, iters)
        emit(cmd="int8", case=case, M=m, K=k, N=n, ms=int8_ms, tops=ops / int8_ms / 1e9, bound_ms=int8_bound)
    x = torch.randn(m, k, generator=gen).to(device)
    wf = torch.randn(k, n, generator=gen) / k**0.5
    ab, wb, zero = x.to(torch.bfloat16), wf.to(device, torch.bfloat16), torch.zeros(n, device=device)
    bf_ms = timed_ms(lambda: gemm(ab, wb, zero, "f32"), device, iters)
    bf_bound = max((2 * m * k + 2 * k * n + 4 * m * n) / HBM_BYTES_PER_S, ops / PEAK_BF16_FLOPS) * 1e3
    emit(cmd="int8", case="matmul_bf16", M=m, K=k, N=n, ms=bf_ms, tflops=ops / bf_ms / 1e9, bound_ms=bf_bound)
    emit(cmd="int8", case="ratio_int8_over_bf16", value=bf_ms / int8_ms,
         note="2.0 = int8 at double the bf16 rate; ~1.0 = no int8 gain")
    pq = {**quantize_kernel(wf), "bias": torch.zeros(n)}
    pq = {key: v.to(device) for key, v in pq.items()}
    pb = {"kernel": wf.to(device, torch.bfloat16), "bias": zero}
    q8_ms = timed_ms(lambda: dense_q8(pq, x), device, iters)
    dense_ms = timed_ms(lambda: dense(pb, x, Precision(torch.bfloat16)), device, iters)
    emit(cmd="int8", case="dense_q8", M=m, K=k, N=n, ms=q8_ms, tops=ops / q8_ms / 1e9)
    emit(cmd="int8", case="dense_bf16", M=m, K=k, N=n, ms=dense_ms, tflops=ops / dense_ms / 1e9)


def cmd_host(n_rows: int, batch_size: int, reps: int = 3) -> None:
    """Host input-pipeline rows/s (no device) over a synthetic testB-format TSV: the native parser alone, the
    native pipeline and the per-example Python path; best of ``reps``."""
    from .. import VOCAB_PATH
    from ..data import Featurizer, batches_from_files
    from ..data.fast_pipeline import native_batches_from_files
    from ..data.native import parse_pairs_native
    from ..data.synthetic import SYNTHETIC_LABELS, make_tsv
    from ..tokenization import FullTokenizer

    def best(fn) -> float:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return min(times)

    rows = make_tsv(n_rows, seed=0, header=False, n_queries=max(1, n_rows * 500 // 29005))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "rows.tsv")
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(rows) + "\n")
        with open(path, "rb") as f:
            buf = f.read()
        fz = Featurizer(FullTokenizer.google_style(VOCAB_PATH), dict(SYNTHETIC_LABELS))
        parse_pairs_native(("\n".join(rows[:64]) + "\n").encode())  # the library's build, untimed
        dt = best(lambda: parse_pairs_native(buf))
        emit(cmd="host", case="native_parse_only", rows=n_rows, mb=len(buf) / 1e6, rows_per_s=n_rows / dt,
             mb_per_s=len(buf) / 1e6 / dt)

        def drain(batches):
            assert sum(int(b["valid"].sum()) for b in batches) == n_rows

        cases = [("native_pipeline", lambda: native_batches_from_files([path], fz, "imagebert_b", batch_size)),
                 ("python_pipeline", lambda: batches_from_files([path], fz.for_model("imagebert_b"), batch_size,
                                                                prefetch=0))]
        for case, make in cases:
            dt = best(lambda make=make: drain(make()))
            emit(cmd="host", case=case, rows=n_rows, batch=batch_size, rows_per_s=n_rows / dt)


def cmd_trace(name: str, b: int, log_dir: str, train: bool, device) -> None:
    """``utils/observability.py:device_profile`` around 3 scoring steps (or 2 training steps), after a warm-up;
    the trace, with the program's spans (``block.*``; training's ``train.*``, ``optim.*``) on its clock, goes
    into ``log_dir``."""
    from ..utils import device_profile

    if train:
        spec, trainer, state = _trainer(name, device)
        batch = _train_batch(spec, trainer, b)
        trainer.train_step(state, batch, seed=1)
        run, n = (lambda: trainer.train_step(state, batch, seed=2)), 2
    else:
        spec, engine = scorer_engine(name, device)
        feats = _feats(spec, engine, b)
        from ..ops import attention

        def run():
            with torch.inference_mode(), attention.attention_backend(engine.attention_backend):
                return spec.apply(engine.params, feats, spec.config, engine.precision)["score"]

        run()
        n = 3
    t0 = time.perf_counter()
    with device_profile(log_dir):
        for _ in range(n):
            run()
        if device.type == "cuda":
            torch.cuda.synchronize()
    files = sorted(os.listdir(log_dir))
    emit(cmd="trace_train" if train else "trace", model=name, B=b, steps=n, dir=log_dir,
         seconds=time.perf_counter() - t0, files=files)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cmd")
    ap.add_argument("args", nargs="*")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--iters", type=int, default=8, help="timed calls after one warm-up")
    args = ap.parse_args(argv)
    if args.cmd in REFUSED:
        ap.error(f"{args.cmd} names a Pallas variant with no port kernel: {REFUSED[args.cmd]}")
    if os.environ.get("KMR_BLOCKS"):
        ap.error("KMR_BLOCKS is the JAX kernels' block_b sweep; the port's kernels choose their own tiles")
    from ..parallel import resolve_device
    from ..utils import enable_persistent_compile_cache

    global CARD
    device = resolve_device(args.device)
    CARD = card() if device.type == "cuda" else "cpu"
    enable_persistent_compile_cache()
    a, it = args.args, args.iters

    def arg(i, default, cast=int):
        return cast(a[i]) if len(a) > i else default

    cmds = {
        "model": lambda: cmd_model(a[0], arg(1, 8192), device, it),
        "model_q8": lambda: cmd_model_q8(a[0], arg(1, 8192), arg(2, "ffn", str), device, it),
        "artifact": lambda: cmd_artifact(a[0], arg(1, None), device, it),
        "stages": lambda: cmd_stages(a[0], arg(1, 8192), device, it),
        "train": lambda: cmd_train(a[0], arg(1, 256), device, it),
        "grad": lambda: cmd_grad(a[0], arg(1, 256), arg(2, "", str) != "nodrop", device, it),
        "opt": lambda: cmd_opt(a[0], device, it),
        "attn": lambda: cmd_attn(int(a[0]), arg(1, 512), True, device, it),
        "attn_nobias": lambda: cmd_attn(int(a[0]), arg(1, 512), False, device, it),
        "ffn": lambda: cmd_ffn(int(a[0]), arg(1, 512), device, it),
        "cross": lambda: cmd_cross(int(a[0]), int(a[1]), arg(2, 512), False, device, it),
        "dualcross": lambda: cmd_cross(int(a[0]), int(a[1]), arg(2, 512), True, device, it),
        "int8": lambda: cmd_int8(arg(0, 8192), arg(1, 2048), arg(2, 2048), device, it),
        "host": lambda: cmd_host(arg(0, 4000), arg(1, 512)),
        "trace": lambda: cmd_trace(a[0], int(a[1]), a[2], False, device),
        "trace_train": lambda: cmd_trace(a[0], int(a[1]), a[2], True, device),
    }
    if args.cmd not in cmds:
        ap.error(f"unknown subcommand {args.cmd!r}; one of {sorted(cmds)} (refused: {sorted(REFUSED)})")
    cmds[args.cmd]()


if __name__ == "__main__":
    main()
