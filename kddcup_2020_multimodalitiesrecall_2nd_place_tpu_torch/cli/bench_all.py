"""Per-model device throughput report, one JSON line a scorer (the port of
the JAX package's ``scripts/bench_all.py``).

Each of the four scorers (ImageBERT-A, -B, -C and LXMERT) at full width with
random weights from seed 0, through ``ScoringEngine`` on the card's default
route (bf16, the fused blocks' kernels), on one ``data/batchspec.py``
``example_batch`` of ``--batch-size`` pairs staged on the device: the mean of
``--iters`` batches between CUDA events, after one warm-up. ``--ensemble``
adds the four-scorer sum and the delta-C pass (C rescoring only its trigger
rows, ~0% of testB), as the JAX script does. Every line carries the card's
name and power limit. Example:

  python -m kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.bench_all --batch-size 512
"""

from __future__ import annotations

import argparse
import json

import torch

from .perf_lab import card, scorer_engine, time_engine

MODELS = ("imagebert_a", "imagebert_b", "imagebert_c", "lxmert")
TESTB_PAIRS = 29005


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch-size", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--ensemble", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    from ..parallel import resolve_device
    from ..utils import enable_persistent_compile_cache

    device = resolve_device(args.device)
    name_of_card = card() if device.type == "cuda" else "cpu"
    enable_persistent_compile_cache()
    b, lines, ms_of = args.batch_size, [], {}
    for name in MODELS:
        spec, engine = scorer_engine(name, device)
        ms = time_engine(spec, engine, b, args.iters)
        ms_of[name] = ms
        lines.append({"model": name, "pairs_per_sec_per_chip": b / ms * 1e3, "ms": ms, "batch": b,
                      "backend": engine.attention_backend,
                      "precision": "bf16" if engine.precision.compute_dtype == torch.bfloat16 else "f32"})
        del engine
    if args.ensemble:
        total = sum(ms_of.values())
        delta = total - ms_of["imagebert_c"]
        lines.append({"model": "ensemble_4x", "ensemble_pairs_per_sec_per_chip": b / total * 1e3, "batch": b,
                      "testB_device_seconds": TESTB_PAIRS / (b / total * 1e3)})
        lines.append({"model": "ensemble_delta_c", "ensemble_pairs_per_sec_per_chip": b / delta * 1e3, "batch": b,
                      "testB_device_seconds": TESTB_PAIRS / (b / delta * 1e3),
                      "note": "C as delta pass, trigger rows ~0% of testB"})
    for line in lines:
        line["card"] = name_of_card
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
