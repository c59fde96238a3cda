"""Training from packed shards through ``Trainer.train_step``, the calls
``cli/train.py --packed-dir`` makes each step (``PackedDataset.batches``, the
step's dropout seed from the run's seed and the global step), with no
checkpoint and no valid pass. Set-up builds the trainer and drives it
through its first steps on the window's own feed; the window goes on with the
same state and the same stream, and its rate is the pairs stepped over its
time.

``correct``: the plain f32 reference follows those first steps from the same
weights, batches and dropout masks, all worked out again from the seed; held
against it (``limits/<cell>.json``): the first step's row probabilities, and
each leaf's change after the steps, of the parameters and of the EMA shadows.
Read beside them: each step's loss, each leaf's first gradient as the
optimizer got it (from Adam's first moment), and whether the steps reach the
value clip and the staircase's second stair."""

from __future__ import annotations

import dataclasses
import gc
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from ..reference import judge
from ..reference.tokenizer import Tokenizer
from ..reference.train import train_steps
from ..yardstick import packed, steady, trace, weights
from ..yardstick import work as yardwork

FIRST_MOMENT_SHARE = 0.1  # Adam's first moment after one step is (1 - b1) x the gradient


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of a step, as ``cli/train.py`` derives it from ``--seed`` and the global step."""
    return (seed + 1) * 1_000_003 + step


def _traced_iter(it, name: str):
    while True:
        with torch.profiler.record_function(name):
            batch = next(it)
        yield batch


def instances(run) -> dict:
    tok = Tokenizer()
    lut = packed.label_lut(lambda text: list(tok.pieces(text)))
    return packed.make_instances(run.traffic, run.seed, run.config["bert"]["vocab_size"], lut)


def _norms(tensors) -> list[float]:
    return torch.stack([t.detach().float().norm() for t in tensors]).tolist()


def _peak_gradient(moment: list[torch.Tensor], decayed: list[torch.Tensor]) -> float:
    """The largest |gradient| a step handed Adam, read back from its first moment before the step (times
    b1, ``decayed``) and after it: m' = b1 m + (1 - b1) g."""
    return float(torch.stack([(a - b).abs().max() for a, b in zip(moment, decayed)]).max()) / FIRST_MOMENT_SHARE


def setup(run) -> dict:
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import PackedDataset
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train import Trainer, recipe_for

    cfg, tr = run.config, run.traffic
    data_dir = tempfile.mkdtemp(prefix="portbench-", dir=run.tmpdir)
    manifest = packed.write_shards(instances(run), data_dir, tr["shard_size"])
    steady.flush_dir(data_dir)
    spec = get_model(cfg["model"], overrides=cfg["bert"])
    tc = dataclasses.replace(recipe_for(spec.name), **cfg["recipe"])
    precision = Precision.bf16() if cfg["precision"] == "bf16" else Precision.f32()
    first_probs = []

    def observed(*args, **kwargs):
        """The model's forward as the step calls it; the first step's probabilities are kept for the check."""
        out = spec.apply(*args, **kwargs)
        if not first_probs:
            first_probs.append(out["probs"][:, 1].detach().float().cpu().numpy())
        return out

    trainer = Trainer(dataclasses.replace(spec, apply=observed), tc, precision=precision, device=run.device)
    state = trainer.init_state(weights.banded(weights.make_weights(cfg["model"], cfg["bert"], run.seed, run.device)))
    if run.trace:
        for name in ("to_device", "grads", "apply"):
            setattr(trainer, name, trace.ranged(getattr(trainer, name), f"port.Trainer.{name}"))
    dataset = PackedDataset(data_dir)
    steady.prefault(a for shard in getattr(dataset, "_maps", ()) for a in shard.values())
    batches = dataset.batches(tr["batch_size"], epochs=None, seed=run.seed)
    start = [p.detach().clone() for p in state.leaves()]
    losses, grad_norms, clip_peak = [], None, 0.0
    for _ in range(tr["checked_steps"]):
        decayed = [m * (1.0 - FIRST_MOMENT_SHARE) for m in state.optimizer.m]
        metrics = trainer.train_step(state, next(batches), step_seed(run.seed, state.step))
        losses.append(float(metrics["loss"]))
        clip_peak = max(clip_peak, _peak_gradient(state.optimizer.m, decayed))
        if grad_norms is None:
            grad_norms = [g / FIRST_MOMENT_SHARE for g in _norms(state.optimizer.m)]
    names = state.optimizer.names
    change = {n: (p.detach() - s).cpu() for n, p, s in zip(names, state.leaves(), start)}
    ema = {n: (e - s).cpu() for n, e, s in zip(names, state.ema.shadow, start)}
    del start, decayed
    return {"trainer": trainer, "state": state, "batches": _traced_iter(batches, "port.PackedDataset.batches")
            if run.trace else batches, "dir": data_dir, "shard_sizes": manifest["shard_sizes"],
            "program": {"losses": losses, "probs": first_probs[0], "grads": dict(zip(names, grad_norms)),
                        "change": change, "ema": ema, "clip_peak": clip_peak}}


def window(run, st: dict, seconds: float):
    trainer, state, batches = st["trainer"], st["state"], st["batches"]
    sync = torch.cuda.synchronize if run.device.type == "cuda" else (lambda: None)
    sync()
    steps = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        trainer.train_step(state, next(batches), step_seed(run.seed, state.step))
        steps += 1
        if time.perf_counter() >= deadline:
            break
    sync()
    elapsed = time.perf_counter() - t0
    pairs = steps * run.traffic["batch_size"]
    return {"train_pairs_per_s": pairs / elapsed}, {"attempted": steps, "failed": 0, "steps": steps,
                                                    "pairs": pairs, "seconds": elapsed}


def work(run, st: dict, counts: dict) -> dict:
    cfg = run.config
    return yardwork.imagebert_b_train(counts["steps"], run.traffic["batch_size"],
                                      {**cfg["bert"], "seq_len": cfg["seq_len"], "feature_dim": cfg["feature_dim"]})


def after_trace(run, st: dict) -> dict:
    return {}


def checked_batches(run, shard_sizes: list[int]) -> list[dict]:
    """The first steps' batches, gathered from the instances drawn again, in the epoch's order."""
    fields = instances(run)
    b, n = run.traffic["batch_size"], run.traffic["checked_steps"]
    rows = packed.epoch_rows(shard_sizes, run.seed, 0)[: b * n]
    out = []
    for k in range(n):
        idx = rows[k * b:(k + 1) * b]
        batch = {}
        for key in ("input_ids", "len_query", "num_boxes", "segment_ids", "boxes", "features", "label_ids", "labels"):
            a = fields[key][idx]
            a = a.astype(np.float32) if a.dtype.kind == "f" else a.astype(np.int64)
            batch[key] = torch.from_numpy(a).to(run.device)
        out.append(batch)
    return out


def reference_numbers(run, shard_sizes: list[int], lowp: bool = False, half_batch: bool = False) -> dict:
    """The reference's (f32, or fp8 with ``lowp``) first steps -> the losses, each leaf's first-gradient
    norm and first gradient, and each leaf's change of the parameters and of the EMA shadows (on the host)."""
    batches = checked_batches(run, shard_sizes)
    if half_batch:
        batches = [{k: v[: len(v) // 2] for k, v in bt.items()} for bt in batches]
    params = weights.make_weights(run.config["model"], run.config["bert"], run.seed, run.device)
    seeds = [step_seed(run.seed, k) for k in range(len(batches))]
    ref = train_steps(params, batches, seeds, run.config["bert"], run.config["recipe"], lowp)
    names = list(ref["start"])
    return {"losses": ref["losses"], "probs": ref["probs"].cpu().numpy(),
            "grads": dict(zip(names, _norms(ref["grads"][n] for n in names))),
            "grad_tensors": {n: ref["grads"][n].cpu() for n in names},
            "grad_max_abs": ref["grad_max_abs"], "stairs": ref["stairs"], "clip_peak": max(ref["clipped_max_abs"]),
            "clip_value": run.config["recipe"]["clip_value"],
            "change": {n: (ref["params"][n] - ref["start"][n]).cpu() for n in names},
            "ema": {n: (ref["ema"][n] - ref["start"][n]).cpu() for n in names}}


def gaps(program: dict, ref: dict) -> dict[str, float]:
    """The readings: each row's probability in the first step (``probs1_gap``, the widest gap), the
    first step's loss, the worst and the median leaf's first-gradient norm, and the worst leaf's change of
    the parameters and of the EMA shadows over the elements whose reference gradient is not nought to
    rounding (``judge.moving``); and by how much the largest gradient that the checked steps handed the
    optimizer passes the value clip, as a share of it (``clip_excess``: the reference's, and a program's
    that clips, are nought to rounding). A run holds those its limits file names (``PERF.md`` says why
    the others are read but not held)."""
    grads = judge.leaf_gaps(program["grads"], ref["grads"])
    keep = judge.moving(ref["grad_tensors"])
    change = judge.leaf_gaps(judge.kept_norms(program["change"], keep), judge.kept_norms(ref["change"], keep))
    ema = judge.leaf_gaps(judge.kept_norms(program["ema"], keep), judge.kept_norms(ref["ema"], keep))
    return {"probs1_gap": judge.widest_gap(program["probs"], ref["probs"]),
            "loss1_gap": judge.loss_gap(program["losses"][:1], ref["losses"][:1]),
            "grad_gap": max(grads.values()),
            "grad_median_gap": float(np.median(list(grads.values()))),
            "change_gap": max(change.values()),
            "ema_gap": max(ema.values()),
            "clip_excess": max(0.0, program["clip_peak"] / ref["clip_value"] - 1.0)}


def check(run, st: dict) -> list[tuple[str, float, float]]:
    for key in ("trainer", "state", "batches"):
        st.pop(key, None)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = reference_numbers(run, st["shard_sizes"])
        # read, not held: whether the checked steps reach the value clip and the staircase's second stair
        print(f"[reading] checked steps' largest |gradient| {ref['grad_max_abs']} against the value clip "
              f"{run.config['recipe']['clip_value']}; learning-rate stairs {ref['stairs']}", file=sys.stderr)
        found = gaps(st["program"], ref)
        return [(name, found[name], limit) for name, limit in run.limits.items()]
    finally:
        shutil.rmtree(st["dir"], ignore_errors=True)
