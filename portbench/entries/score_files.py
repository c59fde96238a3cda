"""Scoring a TSV file pass after pass through ``ScoringEngine.score_files``,
the path ``cli/score.py`` runs: the native parser on a prefetch thread,
featurize, H2D, the model, D2H. A closed loop with one batch in flight; the
window holds whole passes, and the rate is every pass's pairs over their time.

``correct``: a sample of the file's pairs, drawn from the seed, scored again
by the plain f32 reference from the raw rows (its own parse, tokenizer and
featurizer), held against the scores of every pass; and each pass's count of
pairs and of parse errors against the file's."""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from ..reference import featurize as ref_featurize
from ..reference import judge
from ..reference.models import imagebert_a_scores
from ..reference.tokenizer import Tokenizer
from ..yardstick import steady, testb, trace, weights
from ..yardstick import work as yardwork

REFERENCE_BLOCK = 256


def setup(run) -> dict:
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch import VOCAB_PATH
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import Featurizer
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.fast_pipeline import assemble_batches
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.native import get_lib, parse_pairs_native
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringEngine
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.tokenization import FullTokenizer

    cfg, tr = run.config, run.traffic
    data_dir = tempfile.mkdtemp(prefix="portbench-", dir=run.tmpdir)
    tsv = testb.write_testb_tsv(os.path.join(data_dir, "pairs.tsv"), tr, run.seed)
    steady.flush_dir(data_dir)
    spec = get_model(cfg["model"], overrides=cfg["bert"])
    featurizer = Featurizer(FullTokenizer.google_style(VOCAB_PATH), dict(testb.LABEL_TEXTS),
                            sen2forest=spec.sen2forest)
    precision = Precision.bf16() if cfg["precision"] == "bf16" else Precision.f32()
    engine = ScoringEngine(spec, weights.make_weights(cfg["model"], cfg["bert"], run.seed, run.device),
                           device=run.device, precision=precision, attention_backend=cfg["attention_backend"])
    if run.trace:
        for name in ("score_files", "score_batch", "to_device", "_finish"):
            setattr(engine, name, trace.ranged(getattr(engine, name), f"port.ScoringEngine.{name}"))
    # warm-up: the parser library, its threads and the one batch shape, on the file's first rows
    get_lib()
    with open(tsv.path, "rb") as f:
        head = f.read(int(tsv.offsets[min(len(tsv.offsets) - 1, tr["batch_size"] + 64)]))
    batch = next(iter(assemble_batches(parse_pairs_native(head), featurizer, spec.featurizer_layout,
                                       tr["batch_size"])))
    engine.score_batch(batch).float().cpu()
    rng = np.random.default_rng([run.seed, 1])
    sample = np.sort(rng.choice(tsv.pairs, size=min(tr["sample_pairs"], tsv.pairs), replace=False))
    return {"engine": engine, "featurizer": featurizer, "spec": spec, "tsv": tsv, "dir": data_dir,
            "sample": sample}


def window(run, st: dict, seconds: float):
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringStats

    engine, tsv, batch = st["engine"], st["tsv"], run.traffic["batch_size"]
    passes = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        stats = ScoringStats()
        result = engine.score_files([tsv.path], st["featurizer"], batch, stats=stats)
        passes.append((result, stats.pairs, stats.pipeline.errors))
        if time.perf_counter() >= deadline:
            break
    elapsed = time.perf_counter() - t0
    st["passes"] = passes
    pairs = sum(p for _, p, _ in passes)
    attempted = len(passes) * tsv.pairs
    counts = {"attempted": attempted, "failed": max(attempted - pairs, 0), "pairs": pairs, "passes": len(passes),
              "seconds": elapsed}
    return {"score_pairs_per_s": pairs / elapsed}, counts


def _batch_rows(pairs: int, batch: int) -> list[int]:
    return [batch] * (pairs // batch) + ([pairs % batch] if pairs % batch else [])


def work(run, st: dict, counts: dict) -> dict:
    rows = _batch_rows(st["tsv"].pairs, run.traffic["batch_size"]) * counts["passes"]
    return {**work_of(rows, run.config), "batches": len(rows)}


def work_of(rows: list[int], cfg: dict) -> dict:
    return yardwork.imagebert_a_score(rows, {**cfg["bert"], "seq_len": cfg["seq_len"], "feature_dim": cfg["feature_dim"]})


def after_trace(run, st: dict) -> dict:
    """The host loader alone over the cell's file, one pass, no model."""
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import PipelineStats
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.fast_pipeline import native_batches_from_files

    stats = PipelineStats()
    t0 = time.perf_counter()
    for _ in native_batches_from_files([st["tsv"].path], st["featurizer"], st["spec"].featurizer_layout,
                                       run.traffic["batch_size"], stats=stats):
        pass
    return {"loader_rows_per_s": stats.parsed / (time.perf_counter() - t0)}


def reference_scores(run, rows: list[dict], lowp: bool = False) -> np.ndarray:
    cfg = run.config
    params = weights.make_weights(cfg["model"], cfg["bert"], run.seed, run.device)
    tok = Tokenizer()
    out = []
    with torch.no_grad():
        for i in range(0, len(rows), REFERENCE_BLOCK):
            inputs = ref_featurize.imagebert_a_inputs(rows[i:i + REFERENCE_BLOCK], tok, testb.LABEL_TEXTS)
            inputs = {k: torch.from_numpy(v).to(run.device) for k, v in inputs.items()}
            out.append(imagebert_a_scores(params, inputs, cfg["bert"], lowp).cpu().numpy())
    return np.concatenate(out)


def sampled_rows(st: dict) -> list[dict]:
    return [ref_featurize.parse(line) for line in testb.read_rows(st["tsv"].path, st["tsv"].offsets[st["sample"]])]


def sample_reference(run, st: dict, lowp: bool = False) -> np.ndarray:
    """The reference's scores of the sampled pairs that parse (f32, or fp8 with ``lowp``)."""
    return reference_scores(run, [r for r in sampled_rows(st) if r is not None], lowp)


def check(run, st: dict, lowp: bool = False) -> list[tuple[str, float, float]]:
    passes, tsv = st.pop("passes"), st["tsv"]
    st.pop("engine", None)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        rows = sampled_rows(st)
        unparsed = sum(r is None for r in rows)
        rows = [r for r in rows if r is not None]
        ref = reference_scores(run, rows, lowp)
        missing, gap = unparsed, 0.0
        for result, _, _ in passes:
            got = [result.get(str(r["query_id"]), {}).get(str(r["product_id"])) for r in rows]
            missing += sum(g is None for g in got)
            gap = max(gap, judge.widest_gap([np.nan if g is None else g for g in got], ref))
        limits = run.limits
        return [
            ("pairs_per_pass_gap", float(max(abs(p - tsv.pairs) for _, p, _ in passes)), 0.0),
            ("parse_errors_gap", float(max(abs(e - tsv.malformed) for _, _, e in passes)), 0.0),
            ("missing_pairs", float(missing), 0.0),
            ("score_gap", gap, limits["score_gap"]),
        ]
    finally:
        shutil.rmtree(st["dir"], ignore_errors=True)
