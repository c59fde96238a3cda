"""Data-parallel cases of the port's ``Trainer`` (``tests/test_torch_distributed.py``), and the rank process that
runs them.

``run_case(name, rank, world)`` trains one tiny model ``STEPS`` steps on its rows of a global batch from a numpy
seed (every rank's when ``world`` is 1) and returns each step's loss and a parameter checksum. Run as a script, it
is one gloo rank on the CPU:

    python tests/torch_distributed_worker.py <rank> <world> <port> <out.json> <case> [<case> ...]
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

TINY = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 37}
TOWER = {"bert": TINY, "embed_dim": 16}
GLOBAL_B, STEPS, LR = 16, 2, 1e-3
CASES = ("imagebert_b", "imagebert_a_mlm", "two_tower", "imagebert_b_no_dropout")


def global_batch(name: str, seed: int = 7) -> dict[str, np.ndarray]:
    """The case's global batch: the model's inputs, labels, and A's masked-LM entries or the towers' groups."""
    rng = np.random.default_rng(seed)
    b, vocab = GLOBAL_B, 21128
    batch = {
        "input_ids": rng.integers(0, vocab, (b, 20)).astype(np.int32),
        "features": rng.standard_normal((b, 10, 2048)).astype(np.float32),
        "label_ids": rng.integers(0, vocab, (b, 10, 8)).astype(np.int32),
        "labels": rng.integers(0, 2, (b,)).astype(np.int32),
    }
    if name == "imagebert_a_mlm":
        batch["segment_ids"] = np.zeros((b, 20), np.int32)
        batch["masked_lm_positions"] = rng.integers(0, 20, (b, 4)).astype(np.int32)
        batch["masked_lm_ids"] = rng.integers(0, vocab, (b, 4)).astype(np.int32)
        batch["masked_lm_weights"] = (rng.random((b, 4)) < 0.7).astype(np.float32)
        return batch
    batch["len_query"] = rng.integers(2, 21, (b,)).astype(np.int32)
    batch["num_boxes"] = rng.integers(1, 11, (b,)).astype(np.int32)
    batch["boxes"] = rng.standard_normal((b, 10, 5)).astype(np.float32)
    batch["segment_ids"] = np.array([[0] * 20 + [1] * 10] * b, np.int32)
    if name == "two_tower":
        batch["query_group"] = np.repeat(np.arange(b // 2), 2).astype(np.int32)  # pairs of rows share a query
        batch["query_group"][-4:] = [5, 6, 6, 7]  # a group that straddles the ranks' halves
    return batch


def make_trainer(name: str, device: str = "cpu"):
    """(trainer, spec) of the case: a tiny model in f32 with its family's recipe at LR."""
    os.environ["KMR_TOWER_CONFIG_OVERRIDES"] = json.dumps(TOWER)
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train import Trainer, recipe_for

    model = {"imagebert_a_mlm": "imagebert_a", "imagebert_b_no_dropout": "imagebert_b"}.get(name, name)
    overrides = None if model == "two_tower" else dict(TINY)
    if name == "imagebert_b_no_dropout":
        overrides.update(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    spec = get_model(model, overrides=overrides)
    tc = dataclasses.replace(recipe_for(model), learning_rate=LR)
    if name == "imagebert_a_mlm":
        tc = dataclasses.replace(tc, mlm_loss_weight=0.1, ms_loss_weight=0.5)
    if tc.optimizer == "bert_adamw":  # no warmup, so the steps move the parameters
        tc = dataclasses.replace(tc, num_warmup_steps=0)
    return Trainer(spec, tc, precision=Precision.f32(), device=device), spec


def checksum(state) -> float:
    return float(sum(float(p.detach().double().abs().sum()) for p in state.leaves()))


def run_case(name: str, rank: int = 0, world: int = 1, device: str = "cpu") -> dict:
    """STEPS steps of the case on this rank's rows (rank r of ``world`` holds rows r*B/world ..)."""
    trainer, spec = make_trainer(name, device)
    # every rank but 0 starts from other weights: init_state must broadcast rank 0's
    state = trainer.init_state(spec.init_params(3 + rank))
    full = global_batch(name)
    rows = GLOBAL_B // world
    local = {k: v[rank * rows:(rank + 1) * rows] for k, v in full.items()}
    losses, metrics = [], {}
    for step in range(STEPS):
        metrics = trainer.train_step(state, local, seed=100 + step)
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "checksum": checksum(state), "step": state.step,
            "metrics": {k: float(v) for k, v in metrics.items()}}


def main() -> None:
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import maybe_initialize, process_count

    torch.set_num_threads(2)
    assert maybe_initialize(f"tcp://localhost:{port}", world, rank, device="cpu")
    assert process_count() == world
    results = {name: run_case(name, rank, world) for name in sys.argv[5:]}
    with open(out, "w", encoding="utf-8") as f:
        json.dump(results, f)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
