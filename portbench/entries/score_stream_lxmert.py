"""LXMERT batches the caller holds, scored through ``ScoringEngine.score_stream``
(``score_stream``'s window: H2D of each batch, the model, D2H, one batch in
flight, the batches cycled until the time is up).

``correct``: a sample of the batches' pairs, drawn from the seed, scored again
by the plain f32 reference (``reference/lxmert.py``) from the same arrays,
held against the scores of every cycle."""

from __future__ import annotations

import gc

import numpy as np
import torch

from ..reference import judge
from ..reference.lxmert import lxmert_scores
from ..reference.tokenizer import Tokenizer
from ..yardstick import lxmert, packed, trace
from . import score_stream

REFERENCE_BLOCK = 256

window = score_stream.window
after_trace = score_stream.after_trace


def span_cross_blocks_from_outside() -> bool:
    """A bridge for a program whose cross block opens no span of its own (the version before this cell): the
    block the model calls wrapped in the program's own ``span``, so that ``cross.enqueue_share.score`` reads
    the same spans in the traced runs of both versions. -> whether it wrapped; a program whose block opens
    the span is left as it is."""
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import lxmert as model
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.utils.observability import span

    cross = model.KERNEL_BLOCKS.cross
    if "block.cross_attention" in cross.__code__.co_consts:
        return False

    def spanned(*args, **kwargs):
        with span("block.cross_attention"):  # a literal: it marks the wrapper as spanned to a second call
            return cross(*args, **kwargs)

    model.KERNEL_BLOCKS = model.KERNEL_BLOCKS._replace(cross=spanned)
    return True


def setup(run) -> dict:
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringEngine

    cfg, dims = run.config, lxmert.dims(run.config)
    tok = Tokenizer()
    lut, _ = packed.label_lut(lambda text: list(tok.pieces(text)))
    batches = lxmert.make_batches(run.traffic, run.seed, tok.query_ids, lut)
    spec = get_model(cfg["model"], overrides=dims)
    precision = Precision.bf16() if cfg["precision"] == "bf16" else Precision.f32()
    engine = ScoringEngine(spec, lxmert.make_weights(dims, run.seed, run.device), device=run.device,
                           precision=precision, attention_backend=cfg["attention_backend"])
    if run.trace:
        span_cross_blocks_from_outside()
        for name in ("score_batch", "to_device", "_finish"):
            setattr(engine, name, trace.ranged(getattr(engine, name), f"port.ScoringEngine.{name}"))
    engine.score_batch(batches[0]).float().cpu()
    n = len(batches) * run.traffic["batch_size"]
    rng = np.random.default_rng([run.seed, 1])
    sample = np.sort(rng.choice(n, size=min(run.traffic["sample_pairs"], n), replace=False))
    return {"engine": engine, "batches": batches, "sample": sample}


def work(run, st: dict, counts: dict) -> dict:
    return {**lxmert.score([run.traffic["batch_size"]] * counts["batches"], lxmert.dims(run.config)),
            "batches": counts["batches"]}


def sample_reference(run, st: dict, lowp: bool = False) -> np.ndarray:
    dims, size = lxmert.dims(run.config), run.traffic["batch_size"]
    rows = st["sample"]
    inputs = {k: np.concatenate([st["batches"][i // size][k][i % size][None] for i in rows])
              for k in lxmert.INPUT_KEYS}
    params = lxmert.make_weights(dims, run.seed, run.device)
    out = []
    with torch.no_grad():
        for i in range(0, len(rows), REFERENCE_BLOCK):
            block = {k: torch.from_numpy(v[i:i + REFERENCE_BLOCK]).to(run.device) for k, v in inputs.items()}
            block = {k: v.long() if v.dtype == torch.int32 else v for k, v in block.items()}
            out.append(lxmert_scores(params, block, dims, lowp).cpu().numpy())
    return np.concatenate(out)


def check(run, st: dict) -> list[tuple[str, float, float]]:
    scored, size, n_batches = st.pop("scored"), run.traffic["batch_size"], len(st["batches"])
    st.pop("engine", None)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = sample_reference(run, st)
    rows = st["sample"]
    gap = 0.0
    for k, scores in enumerate(scored):
        here = rows[rows // size == k % n_batches]
        if len(here):
            got = scores[here % size] if len(scores) == size else np.full(len(here), np.nan)
            gap = max(gap, judge.widest_gap(got, ref[np.isin(rows, here)]))
    return [("score_gap", gap, run.limits["score_gap"])]
