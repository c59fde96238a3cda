#!/usr/bin/env python3
"""The training weight-gradient glue timed in turns on one NVIDIA GPU: ``python3 chip_glue_ab.py``.

Two ways to compute a block's weight gradients from bf16 operands: "copies" (f32 copies of
both operands, then a TF32 ``torch.matmul``; the port's glue before ImageBERT-B's training
landed) and "mm" (``ops/train_blocks.py:weight_grads``: one ``torch.mm`` with an f32 out,
no copies). Each runs ImageBERT-A's, ImageBERT-B's and LXMERT's full-width training step at
B=256 (random weights from seed 0, the batches of ``chip_smoke.py``'s phase 5), in the order
copies, mm, mm, copies: TRAIN_STEPS timed steps (``chip_smoke.Smoke.timed_train_steps``: CUDA
events, launch counts exact) and 2 profiled steps (the kernels' sum, and the ``direct_copy``
kernels' share). Prints one JSON line a run and writes them all to
``build/glue_ab.json``."""

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch import VOCAB_PATH, data, models, train  # noqa: E402
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops import _build, band_conv, train_blocks  # noqa: E402
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.tokenization import FullTokenizer  # noqa: E402

MM = train_blocks.weight_grads


def copies_weight_grads(a, d):
    """f32 copies of both operands and a TF32 product (exact products of bf16 values)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return torch.matmul(a.float().T, d.float()), d.float().sum(0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def use(fn):
    train_blocks.weight_grads = fn
    band_conv.weight_grads = fn


def profile(trainer, state, batches):
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    dev = [trainer.to_device(b) for b in batches]
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i, b in enumerate(dev):
            grads, _ = trainer.grads(state, b, seed=300 + i)
            trainer.apply(state, grads)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / len(batches)
    copies = sum(e.self_device_time_total for e in kernels if "direct_copy" in e.key) / 1e3 / len(batches)
    return busy, copies


def main():
    t0 = time.perf_counter()
    _build.build_all()
    smoke = cs.Smoke(torch, 0)
    cases = {}
    for name, per in (("imagebert_a", cs.PER_STEP), ("imagebert_b", cs.PER_STEP_B)):
        spec, params, batches, (tsv, labels, _), _ = smoke.sampled_train_batches(name)
        tc = train.recipe_for(name)
        if name == "imagebert_a":  # chip_smoke's phase 5: a short warmup, so the few steps move the parameters
            tc = dataclasses.replace(tc, num_warmup_steps=cs.TRAIN_STEPS // 2, num_train_steps=10 * cs.TRAIN_STEPS)
        cases[name] = (spec, params, tc, batches, per)
    spec = models.get_model("lxmert")
    fz = data.Featurizer(FullTokenizer.hf_style(VOCAB_PATH), data.load_multimodal_labels(labels))
    staged = list(data.batches_from_files([tsv], fz.lxmert, cs.TRAIN_B))
    rng = np.random.default_rng(0)
    batches = [{**staged[i % len(staged)], "labels": rng.integers(0, 2, cs.TRAIN_B).astype(np.int32)}
               for i in range(cs.TRAIN_STEPS)]
    tc = dataclasses.replace(train.recipe_for("lxmert"), num_warmup_steps=cs.TRAIN_STEPS // 2,
                             num_train_steps=10 * cs.TRAIN_STEPS)
    cases["lxmert"] = (spec, spec.init_params(0), tc, batches, cs.PER_STEP_LXMERT)
    print(f"setup {time.perf_counter() - t0:.1f} s", flush=True)

    out = {"card": cs.nvidia_smi(), "runs": []}
    for name, (spec, params, tc, batches, per) in cases.items():
        for label, fn in (("copies", copies_weight_grads), ("mm", MM), ("mm", MM),
                          ("copies", copies_weight_grads)):
            use(fn)
            trainer = train.Trainer(spec, tc, precision=models.Precision.bf16(), device="cuda")
            state = trainer.init_state(params)
            _, steps = smoke.timed_train_steps(trainer, state, batches, per, f"{name} {label}")
            busy, copies = profile(trainer, state, batches[:2])
            row = {"model": name, "glue": label, **steps["device_ms_per_step"], "kernels_ms": busy,
                   "direct_copy_ms": copies, "pairs_per_second": steps["device_pairs_per_second"]}
            out["runs"].append(row)
            print(json.dumps(row), flush=True)
            del trainer, state
            torch.cuda.empty_cache()
    use(MM)
    (REPO / "build").mkdir(exist_ok=True)
    (REPO / "build" / "glue_ab.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
