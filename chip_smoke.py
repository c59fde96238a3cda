#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

1. Build: compiles the CUDA kernels of the port's ``csrc/`` with nvcc (one
   process per source, all at once) into ``build/kernels/``.
2. Kernel checks: each kernel at ImageBERT-A's shapes (B=256, S=40, H=768,
   N=12, I=3072, bf16, seeded inputs) against its plain PyTorch version on
   the same card, within two bf16 ulps (CARD_ATOL, CARD_RTOL); then every
   kernel checked again and timed at the main path's batch (B=512), beside
   its bound, its plain version and one PyTorch library call of the same
   function (a yardstick the port never calls).
3. Full-width scoring: a 2048-row synthetic TSV scored end to end through
   ``ScoringEngine`` (12 x 768, bf16, batch 512, random weights from seed 0),
   with every launch counter read around that run alone; the scores are held
   against the plain path on the card (max |d score| <= SCORE_BAND) and
   against the f32 plain path on the CPU for a few pairs.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result, when any phase fails or no CUDA device is present. The full nvcc
report (ptxas registers, shared memory, spills) goes to
``build/kernels/nvcc.log``; its summary lines are printed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = "kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch"
TPU_PKG_DIR = "kddcup_2020_multimodalitiesrecall_2nd_place_tpu"  # the reference, named in "replaces"

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

CHECK_B, MAIN_B, S, H, N, I = 256, 512, 40, 768, 12, 3072
# bf16 outputs: |d| <= CARD_ATOL + CARD_RTOL * |plain| elementwise, i.e. two bf16 ulps of the
# plain value (2^-6 relative) above a 1.6e-2 floor: kernel and plain version round the same
# intermediates, but their long sums run in another order, which can flip one bf16 rounding
CARD_ATOL, CARD_RTOL = 1.6e-2, 2.0**-6
F32_OUT_BAND = 1e-3  # f32 outputs of the residual epilogue (summation order only), abs
SCORE_BAND = 1e-2  # kernel path vs plain path, scores on the card
CPU_SCORE_BAND = 5e-2  # bf16 kernels vs the f32 plain path on the CPU
N_ROWS, SEED = 2048, 0


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "unavailable"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn over iters launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes_of(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(bytes_moved: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.gen = torch.Generator(device="cpu").manual_seed(SEED)
        self.errors: dict[str, float] = {}
        self.failures: list[str] = []

    def randn(self, *shape, scale=1.0, dtype=None):
        t = scale * self.torch.randn(*shape, generator=self.gen)
        return t.to(self.dev, dtype or self.torch.float32)

    def check(self, name: str, kernel_name: str, got, want, atol: float, rtol: float = 0.0) -> None:
        torch = self.torch
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        ok = got.shape == want.shape and bool(torch.isfinite(got).all())
        d = (got - want).abs() if ok else None
        err = d.max().item() if ok else float("inf")
        ok = ok and bool((d <= atol + rtol * want.abs()).all())
        self.errors[kernel_name] = max(self.errors.get(kernel_name, 0.0), err)
        log(f"check {name}: max_abs_err={err:.6g} band=|d| <= {atol:g} + {rtol:g}*|plain| "
            f"max|plain|={want.abs().max().item():.4g} {'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(name)

    # ---- phase 2: kernels against their plain versions --------------------------

    def layer_weights(self):
        w = {
            "wqkv": self.randn(H, 3 * H, scale=0.02, dtype=self.torch.bfloat16),
            "bqkv": self.randn(3 * H, scale=0.02),
            "wo": self.randn(H, H, scale=0.02, dtype=self.torch.bfloat16),
            "bo": self.randn(H, scale=0.02),
            "w1": self.randn(H, I, scale=0.02, dtype=self.torch.bfloat16),
            "b1": self.randn(I, scale=0.02),
            "w2": self.randn(I, H, scale=0.02, dtype=self.torch.bfloat16),
            "b2": self.randn(H, scale=0.02),
            "gamma": 1.0 + self.randn(H, scale=0.1),
            "beta": self.randn(H, scale=0.1),
        }
        return w

    def check_kernels(self, w) -> None:
        from importlib import import_module

        k = import_module(f"{PKG}.ops.kernels")
        ab = import_module(f"{PKG}.ops.attention_block")
        fb = import_module(f"{PKG}.ops.ffn_block")
        att = import_module(f"{PKG}.ops.attention")
        torch = self.torch
        m = CHECK_B * S
        x = self.randn(CHECK_B, S, H, dtype=torch.bfloat16)
        x2d = x.reshape(m, H)
        qkv = k.gemm(x2d, w["wqkv"], w["bqkv"], "bias")
        self.check("gemm qkv [bias]", "gemm_bf16", qkv, k.gemm_plain(x2d, w["wqkv"], w["bqkv"], "bias"), CARD_ATOL, CARD_RTOL)
        for epi in ("gelu_tanh", "gelu_erf"):
            self.check(f"gemm ffn-up [{epi}]", "gemm_bf16", k.gemm(x2d, w["w1"], w["b1"], epi),
                       k.gemm_plain(x2d, w["w1"], w["b1"], epi), CARD_ATOL, CARD_RTOL)
        hmid = k.gemm_plain(x2d, w["w1"], w["b1"], "gelu_tanh")
        self.check("gemm out-proj [residual]", "gemm_bf16", k.gemm(x2d, w["wo"], w["bo"], "residual", x2d),
                   k.gemm_plain(x2d, w["wo"], w["bo"], "residual", x2d), F32_OUT_BAND)
        self.check("gemm ffn-down [residual]", "gemm_bf16", k.gemm(hmid, w["w2"], w["b2"], "residual", x2d),
                   k.gemm_plain(hmid, w["w2"], w["b2"], "residual", x2d), F32_OUT_BAND)
        mask = (torch.rand(CHECK_B, S, generator=self.gen) > 0.3).float()
        mask[:, 0] = 1.0
        key_bias = att.mask_to_bias(mask).to(self.dev)
        for label, kb in (("no bias", None), ("key mask", key_bias)):
            self.check(f"attn_core [{label}]", "attn_core", k.attn_core(qkv, kb, CHECK_B, S, N),
                       k.attn_core_plain(qkv, kb, CHECK_B, S, N), CARD_ATOL, CARD_RTOL)
        y = self.randn(m, H, scale=2.0) + 0.5
        self.check("layernorm", "layernorm", k.layernorm(y, w["gamma"], w["beta"]),
                   k.layernorm_plain(y, w["gamma"], w["beta"], out_dtype=torch.bfloat16), CARD_ATOL, CARD_RTOL)
        aw = [w[n] for n in ("wqkv", "bqkv", "wo", "bo", "gamma", "beta")]
        for label, kb in (("no bias", None), ("key mask", key_bias)):
            self.check(f"attention_block [{label}]", "attention_block", ab.attention_block(x, *aw, N, kb),
                       ab.attention_block_plain(x, *aw, N, kb), CARD_ATOL, CARD_RTOL)
        fw = [w[n] for n in ("w1", "b1", "w2", "b2", "gamma", "beta")]
        for approx in (True, False):
            self.check(f"ffn_block [gelu {'tanh' if approx else 'erf'}]", "ffn_block",
                       fb.ffn_block(x, *fw, approximate_gelu=approx),
                       fb.ffn_block_plain(x, *fw, approximate_gelu=approx), CARD_ATOL, CARD_RTOL)

    def time_kernels(self, w) -> dict[str, dict]:
        """Kernel / plain / library / bound times at the main path's batch, each
        kernel's output also held against its plain version at that batch."""
        from importlib import import_module

        k = import_module(f"{PKG}.ops.kernels")
        ab = import_module(f"{PKG}.ops.attention_block")
        fb = import_module(f"{PKG}.ops.ffn_block")
        torch = self.torch
        F = torch.nn.functional
        b, m = MAIN_B, MAIN_B * S
        x = self.randn(b, S, H, dtype=torch.bfloat16)
        x2d = x.reshape(m, H)
        qkv = k.gemm(x2d, w["wqkv"], w["bqkv"], "bias")
        hmid = k.gemm(x2d, w["w1"], w["b1"], "gelu_tanh")
        rows = {}

        def row(name, key, kernel_fn, plain_fn, library_fn, nbytes, flops, peak, atol=CARD_ATOL, rtol=CARD_RTOL):
            self.check(f"{name} [B={b}]", key, kernel_fn(), plain_fn(), atol, rtol)
            bms, by = bound_ms(nbytes, flops, peak)
            r = {
                "ms": cuda_ms(torch, kernel_fn),
                "plain_ms": cuda_ms(torch, plain_fn, iters=5),
                "bound_ms": bms,
                "bound_by": by,
                "library_ms": cuda_ms(torch, library_fn) if library_fn else None,
            }
            rows[name] = r
            lib = f"{r['library_ms']:.4f}" if r["library_ms"] is not None else "n/a"
            log(f"time {name}: ms={r['ms']:.4f} bound_ms={bms:.4f} ({by}) plain_ms={r['plain_ms']:.4f} "
                f"library_ms={lib} achieved={flops / r['ms'] / 1e9:.1f} TFLOP/s")

        def gemm_site(name, a, wt, bias, epi, res=None):
            mm, kk = a.shape
            nn = wt.shape[1]
            out_bytes = mm * nn * (4 if epi == "residual" else 2)
            nbytes = mm * kk * 2 + kk * nn * 2 + nn * 4 + out_bytes + (mm * nn * 2 if res is not None else 0)
            band = (F32_OUT_BAND, 0.0) if epi == "residual" else (CARD_ATOL, CARD_RTOL)
            row(name, "gemm_bf16", lambda: k.gemm(a, wt, bias, epi, res),
                lambda: k.gemm_plain(a, wt, bias, epi, res),
                lambda: torch.matmul(a, wt), nbytes, 2.0 * mm * nn * kk, PEAK_BF16_FLOPS, *band)

        gemm_site("gemm_bf16 qkv", x2d, w["wqkv"], w["bqkv"], "bias")
        ctx = k.attn_core(qkv, None, b, S, N)
        gemm_site("gemm_bf16 out-proj", ctx, w["wo"], w["bo"], "residual", x2d)
        gemm_site("gemm_bf16 ffn-up", x2d, w["w1"], w["b1"], "gelu_tanh")
        gemm_site("gemm_bf16 ffn-down", hmid, w["w2"], w["b2"], "residual", x2d)

        q, kk_, v = (t.reshape(b, S, N, 64).transpose(1, 2).contiguous() for t in qkv.split(H, dim=1))
        row("attn_core", "attn_core", lambda: k.attn_core(qkv, None, b, S, N), lambda: k.attn_core_plain(qkv, None, b, S, N),
            lambda: F.scaled_dot_product_attention(q, kk_, v), m * 3 * H * 2 + m * H * 2,
            4.0 * b * N * S * S * 64, PEAK_BF16_FLOPS)
        y = self.randn(m, H)
        row("layernorm", "layernorm", lambda: k.layernorm(y, w["gamma"], w["beta"]),
            lambda: k.layernorm_plain(y, w["gamma"], w["beta"], out_dtype=torch.bfloat16),
            lambda: F.layer_norm(y, (H,), w["gamma"], w["beta"], 1e-12),
            m * H * 4 + 2 * H * 4 + m * H * 2, 8.0 * m * H, PEAK_F32_FLOPS)
        aw = [w[n] for n in ("wqkv", "bqkv", "wo", "bo", "gamma", "beta")]
        fw = [w[n] for n in ("w1", "b1", "w2", "b2", "gamma", "beta")]
        row("attention_block", "attention_block", lambda: ab.attention_block(x, *aw, N), lambda: ab.attention_block_plain(x, *aw, N),
            None, 2 * m * H * 2 + nbytes_of(aw),
            2.0 * m * H * 3 * H + 4.0 * b * N * S * S * 64 + 2.0 * m * H * H, PEAK_BF16_FLOPS)
        row("ffn_block", "ffn_block", lambda: fb.ffn_block(x, *fw), lambda: fb.ffn_block_plain(x, *fw), None,
            2 * m * H * 2 + nbytes_of(fw), 4.0 * m * H * I, PEAK_BF16_FLOPS)
        return rows

    # ---- phase 3: the main path ----------------------------------------------

    def score_main_path(self) -> tuple[dict, dict]:
        from importlib import import_module

        import numpy as np

        torch = self.torch
        pkg = import_module(PKG)
        data = import_module(f"{PKG}.data")
        synthetic = import_module(f"{PKG}.data.synthetic")
        models = import_module(f"{PKG}.models")
        imagebert_a = import_module(f"{PKG}.models.imagebert_a")
        engine_mod = import_module(f"{PKG}.parallel.engine")
        tok = import_module(f"{PKG}.tokenization")
        k = import_module(f"{PKG}.ops.kernels")
        ab = import_module(f"{PKG}.ops.attention_block")
        fb = import_module(f"{PKG}.ops.ffn_block")

        work = pkg.BUILD_DIR / "smoke"
        work.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        tsv = work / "pairs.tsv"
        tsv.write_text("\n".join(synthetic.make_tsv(N_ROWS, seed=SEED)) + "\n")
        labels = work / "labels.txt"
        labels.write_text("".join(f"{key}\t{val}\n" for key, val in synthetic.SYNTHETIC_LABELS.items()))
        spec = models.get_model("imagebert_a")
        cfg = spec.config
        if (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads) != (H, 12, N):
            raise RuntimeError(f"not the full-width config: {cfg} (is KMR_CONFIG_OVERRIDES set?)")
        params = spec.init_params(SEED)
        engine = engine_mod.ScoringEngine(spec, params, device=self.dev, precision=models.Precision.bf16())
        featurizer = data.Featurizer(tok.FullTokenizer.google_style(pkg.VOCAB_PATH),
                                     data.load_multimodal_labels(labels))
        log(f"setup: {N_ROWS}-row TSV and {cfg.num_hidden_layers}x{cfg.hidden_size} params in "
            f"{time.perf_counter() - t0:.1f} s")

        batches = list(data.batches_from_files([tsv], featurizer.imagebert_a, MAIN_B))
        engine.score_batch(batches[0])  # warm-up: CUDA context, library handles, allocator
        torch.cuda.synchronize()

        counted = (*k.WRAPPERS, ab.attention_block, fb.ffn_block)
        for w in counted:
            w.launches = 0
        stats = engine_mod.ScoringStats()
        result = engine.score_files([tsv], featurizer, MAIN_B, stats=stats)
        torch.cuda.synchronize()
        launches = {w.__name__: w.launches for w in counted}
        log(f"main path: {stats.pairs} pairs in {stats.batches} batches, {stats.seconds:.3f} s, "
            f"{stats.pairs_per_second:.1f} pairs/s end to end (host parse + featurize included)")
        log(f"launches: {json.dumps(launches)}")
        if stats.pairs != N_ROWS:
            raise RuntimeError(f"main path scored {stats.pairs} pairs, expected {N_ROWS}")

        # device time of the model alone on staged batches, and the plain path on the card
        staged = [engine.to_device(bt) for bt in batches]

        def run_all(blocks):
            return [imagebert_a.score(engine.params, bt, cfg, engine.precision, blocks) for bt in staged]

        with torch.inference_mode():
            dev_ms = cuda_ms(torch, lambda: run_all(models.KERNEL_BLOCKS), iters=3, warmup=1)
            plain_dev_ms = cuda_ms(torch, lambda: run_all(models.PLAIN_BLOCKS), iters=1, warmup=1)
            kern = torch.cat(run_all(models.KERNEL_BLOCKS)).float().cpu()
            plain = torch.cat(run_all(models.PLAIN_BLOCKS)).float().cpu()
        valid = torch.from_numpy(np.concatenate([bt["valid"] for bt in batches]))
        kern, plain = kern[valid], plain[valid]
        n_pad = len(batches) * MAIN_B
        log(f"device: model alone {dev_ms:.3f} ms for {n_pad} padded pairs = "
            f"{n_pad / dev_ms * 1e3:.1f} pairs/s (plain path {plain_dev_ms:.3f} ms)")
        if not bool(torch.isfinite(kern).all()) or kern.shape != (N_ROWS,):
            raise RuntimeError("kernel-path scores are not finite or of the wrong shape")
        d_score = (kern - plain).abs().max().item()
        engine_scores = torch.tensor([result[str(q)][str(p)] for bt in batches
                                      for q, p, ok in zip(bt["query_id"], bt["product_id"], bt["valid"]) if ok])
        d_engine = (engine_scores - kern).abs().max().item()
        same_rank, n_q = self.ranking_agreement(batches, kern, plain)
        log(f"scores: range [{kern.min().item():.5f}, {kern.max().item():.5f}], max |d| kernel vs plain "
            f"on the card = {d_score:.6g} (band {SCORE_BAND:g}), engine vs staged = {d_engine:.3g}, "
            f"identical per-query ranking in {same_rank}/{n_q} queries")
        if d_score > SCORE_BAND or d_engine > 1e-6:
            raise RuntimeError("kernel-path scores disagree with the plain path")

        # a small input against the f32 plain path on the CPU (the CPU tests' reference)
        small = {key: val[:8] for key, val in staged[0].items()}
        with torch.inference_mode():
            ref = imagebert_a.score(params, {key: val.cpu() for key, val in small.items()}, cfg,
                                    models.Precision.f32())
        d_cpu = (kern[:8] - ref).abs().max().item()
        log(f"scores: max |d| bf16 kernels vs f32 plain on the CPU, 8 pairs = {d_cpu:.6g} (band {CPU_SCORE_BAND:g})")
        if not d_cpu <= CPU_SCORE_BAND:
            raise RuntimeError("kernel-path scores disagree with the f32 CPU reference")
        rates = {"pairs": stats.pairs, "seconds": stats.seconds, "pairs_per_second": stats.pairs_per_second,
                 "device_ms": dev_ms, "device_pairs": n_pad, "device_pairs_per_second": n_pad / dev_ms * 1e3,
                 "plain_device_ms": plain_dev_ms, "max_abs_score_err": d_score,
                 "max_abs_score_err_vs_cpu_f32": d_cpu, "identical_rankings": [same_rank, n_q]}
        return launches, stats.batches, rates

    @staticmethod
    def ranking_agreement(batches, kern, plain) -> tuple[int, int]:
        keys = [(q, p) for bt in batches for q, p, ok in zip(bt["query_id"], bt["product_id"], bt["valid"]) if ok]
        by_q: dict = {}
        for i, (q, p) in enumerate(keys):
            by_q.setdefault(int(q), []).append(i)
        same = sum(
            sorted(ix, key=lambda i: -kern[i].item()) == sorted(ix, key=lambda i: -plain[i].item())
            for ix in by_q.values()
        )
        return same, len(by_q)


KERNELS = [
    # name, source, TPU kernel it replaces, the rows of time_kernels() that make up one layer's launches
    ("attention_block", f"{PKG}/ops/attention_block.py", f"{TPU_PKG_DIR}/ops/pallas_attention.py:479",
     ["attention_block"]),
    ("ffn_block", f"{PKG}/ops/ffn_block.py", f"{TPU_PKG_DIR}/ops/pallas_ffn.py:79", ["ffn_block"]),
    ("gemm_bf16", f"{PKG}/csrc/gemm_bf16.cu", f"{TPU_PKG_DIR}/ops/pallas_attention.py:200",
     ["gemm_bf16 qkv", "gemm_bf16 out-proj", "gemm_bf16 ffn-up", "gemm_bf16 ffn-down"]),
    ("attn_core", f"{PKG}/csrc/attn_core.cu", f"{TPU_PKG_DIR}/ops/pallas_attention.py:327", ["attn_core"]),
    ("layernorm", f"{PKG}/csrc/layernorm.cu", f"{TPU_PKG_DIR}/ops/pallas_attention.py:237",
     ["layernorm", "layernorm"]),
]
LAUNCH_KEY = {"gemm_bf16": "gemm"}


def kernel_line(times: dict, launches: dict, errors: dict) -> dict:
    out = []
    for name, source, replaces, rows in KERNELS:
        rs = [times[r] for r in rows]
        lib = [r["library_ms"] for r in rs]
        out.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[LAUNCH_KEY.get(name, name)],
            "max_abs_err": errors[name],
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "operations" if any(r["bound_by"] == "operations" for r in rs) else "bytes",
            "library_ms": None if None in lib else sum(lib),
            "per": f"{len(rows)} launch(es) of one layer at B={MAIN_B}, S={S}",
        })
    return {"kernels": out}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    try:
        from importlib import import_module

        build = import_module(f"{PKG}.ops._build")
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script ({e})", file=sys.stderr)
        return 2
    try:
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
        t0 = time.perf_counter()
        logs = build.build_all()
        log(f"build: {time.perf_counter() - t0:.1f} s for {list(build.SOURCES)}")
        (build.BUILD_DIR / "kernels" / "nvcc.log").write_text(
            "\n".join(f"--- {n} ---\n{t}" for n, t in logs.items()))
        for name, text in logs.items():
            for line in text.splitlines():
                if "Used" in line or "spill" in line:
                    log(f"ptxas {name}: {line.strip()}")

        smoke = Smoke(torch)
        weights = smoke.layer_weights()
        smoke.check_kernels(weights)
        if smoke.failures:
            raise RuntimeError(f"kernels disagree with their plain versions: {smoke.failures}")
        times = smoke.time_kernels(weights)
        if smoke.failures:
            raise RuntimeError(f"kernels disagree with their plain versions: {smoke.failures}")
        launches, n_batches, rates = smoke.score_main_path()
        expected = {"attention_block": 12 * n_batches, "ffn_block": 12 * n_batches,
                    "gemm": 48 * n_batches, "attn_core": 12 * n_batches, "layernorm": 24 * n_batches}
        if launches != expected or n_batches == 0:
            raise RuntimeError(f"main path launches {launches}, expected {expected}")
        log(json.dumps({"end_to_end": rates}))
        log(json.dumps(kernel_line(times, launches, smoke.errors)))
        log(f"nvidia-smi: {nvidia_smi()}")
    except Exception:  # any phase failing fails the run, with its traceback
        traceback.print_exc()
        return 1
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
