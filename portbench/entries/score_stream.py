"""Scoring batches the caller holds through ``ScoringEngine.score_stream`` (the
path of ``cli/cascade.py``'s rerank and of a live teacher): the parser
bypassed, H2D of each batch, the model, D2H, one batch in flight. The window
cycles through the batches until its time is up; the rate is the pairs
scored over its time.

``correct``: a sample of the batches' pairs, drawn from the seed, scored again
by the plain f32 reference from the same arrays, held against the scores of
every cycle."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..reference import judge
from ..reference.models import imagebert_a_scores
from ..reference.tokenizer import Tokenizer
from ..yardstick import packed, staged, trace, weights
from . import score_files

REFERENCE_BLOCK = 256


def _batches(run) -> list[dict]:
    tok = Tokenizer()
    lut, _ = packed.label_lut(lambda text: list(tok.pieces(text)))
    return staged.make_batches(run.traffic, run.seed, tok.query_ids, lut)


def setup(run) -> dict:
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringEngine

    cfg = run.config
    batches = _batches(run)
    spec = get_model(cfg["model"], overrides=cfg["bert"])
    precision = Precision.bf16() if cfg["precision"] == "bf16" else Precision.f32()
    engine = ScoringEngine(spec, weights.make_weights(cfg["model"], cfg["bert"], run.seed, run.device),
                           device=run.device, precision=precision, attention_backend=cfg["attention_backend"])
    if run.trace:
        for name in ("score_batch", "to_device", "_finish"):
            setattr(engine, name, trace.ranged(getattr(engine, name), f"port.ScoringEngine.{name}"))
    engine.score_batch(batches[0]).float().cpu()
    n = len(batches) * run.traffic["batch_size"]
    rng = np.random.default_rng([run.seed, 1])
    sample = np.sort(rng.choice(n, size=min(run.traffic["sample_pairs"], n), replace=False))
    return {"engine": engine, "batches": batches, "sample": sample}


def window(run, st: dict, seconds: float):
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringStats

    batches, stats, scored = st["batches"], ScoringStats(), []
    t0 = time.perf_counter()
    deadline = t0 + seconds

    def feed():
        while True:
            for b in batches:
                if time.perf_counter() >= deadline:
                    return
                yield b

    for _, _, scores in st["engine"].score_stream(feed(), stats):
        scored.append(scores)
    elapsed = time.perf_counter() - t0
    st["scored"] = scored
    attempted = len(scored) * run.traffic["batch_size"]
    counts = {"attempted": attempted, "failed": attempted - stats.pairs, "pairs": stats.pairs,
              "batches": len(scored), "seconds": elapsed}
    return {"score_pairs_per_s": stats.pairs / elapsed}, counts


def work(run, st: dict, counts: dict) -> dict:
    return {**score_files.work_of([run.traffic["batch_size"]] * counts["batches"], run.config),
            "batches": counts["batches"]}


def after_trace(run, st: dict) -> dict:
    return {}


def sample_reference(run, st: dict, lowp: bool = False) -> np.ndarray:
    cfg, size = run.config, run.traffic["batch_size"]
    rows = st["sample"]
    keys = ("input_ids", "features", "label_ids")
    inputs = {k: np.concatenate([st["batches"][i // size][k][i % size][None] for i in rows]) for k in keys}
    params = weights.make_weights(cfg["model"], cfg["bert"], run.seed, run.device)
    out = []
    with torch.no_grad():
        for i in range(0, len(rows), REFERENCE_BLOCK):
            block = {k: torch.from_numpy(v[i:i + REFERENCE_BLOCK]).to(run.device) for k, v in inputs.items()}
            block = {k: v.long() if k != "features" else v for k, v in block.items()}
            out.append(imagebert_a_scores(params, block, cfg["bert"], lowp).cpu().numpy())
    return np.concatenate(out)


def check(run, st: dict) -> list[tuple[str, float, float]]:
    scored, size, n_batches = st.pop("scored"), run.traffic["batch_size"], len(st["batches"])
    st.pop("engine", None)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = sample_reference(run, st)
    rows = st["sample"]
    gap = 0.0
    for k, scores in enumerate(scored):
        here = rows[rows // size == k % n_batches]
        if len(here):
            got = scores[here % size] if len(scores) == size else np.full(len(here), np.nan)
            gap = max(gap, judge.widest_gap(got, ref[np.isin(rows, here)]))
    return [("score_gap", gap, run.limits["score_gap"])]
