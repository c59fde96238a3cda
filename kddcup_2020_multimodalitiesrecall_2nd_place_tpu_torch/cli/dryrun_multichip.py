"""Multi-rank dry run, the port of the JAX package's ``__graft_entry__.py
multichip N`` (``dryrun_multichip``): N ranks of one ``torch.distributed``
group run, each on its rows of the batches,

1. one data-parallel train step of a tiny ImageBERT-B (Adam on the staircase,
   per-value clip, EMA 0.997; f32 on the plain train blocks, as the JAX dry
   run trains it in f32: its 8-wide heads fit no kernel): a finite loss, the
   same on every rank, step 1;
2. one sharded scoring step with the trained params (each rank scores its rows
   through ``ScoringEngine`` in f32, the scores all-gathered): finite, [B];
3. ``recall_sharded`` (the catalog split over the ranks) against numpy's argsort;
4. the full-config stage (12 x 768, the real ``bert_config.json``): one
   data-parallel ImageBERT-A train step and one sharded scoring step at real
   shapes, in the device's default precision (on the card bf16, the train
   and scoring blocks' kernels; ``--tiny-only`` leaves it out, for the CPU);
5. the sharded fusion: ``ensemble/vectorized.py:fusion_filter_device`` over
   pair rows split across the ranks and all-gathered, equal to the
   one-process result (merge within 1e-6, keep bit-equal).

``--device cpu`` spawns N gloo processes on the CPU; ``--device cuda`` (the
default) N ranks on the one card, also over gloo (NCCL takes one rank a
device). The last line reads ``dryrun_multichip(N): ok, ...``. Example:

  python -m kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.dryrun_multichip 2
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

RANK_TIMEOUT_S = 900
TINY_B = {"vocab_size": 101, "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
          "intermediate_size": 37, "max_position_embeddings": 64}


def _b_batch(b: int, vocab: int, rng) -> dict:
    return {
        "input_ids": rng.integers(0, vocab, (b, 20)).astype(np.int32),
        "segment_ids": np.array([[0] * 20 + [1] * 10] * b, np.int32),
        "boxes": rng.standard_normal((b, 10, 5)).astype(np.float32),
        "features": rng.standard_normal((b, 10, 2048)).astype(np.float32),
        "label_ids": rng.integers(0, vocab, (b, 10, 8)).astype(np.int32),
        "len_query": rng.integers(3, 21, (b,)).astype(np.int32),
        "num_boxes": rng.integers(1, 11, (b,)).astype(np.int32),
        "labels": rng.integers(0, 2, (b,)).astype(np.int32),
    }


def _a_batch(b: int, vocab: int, rng) -> dict:
    return {
        "input_ids": rng.integers(0, vocab, (b, 20)).astype(np.int32),
        "segment_ids": np.zeros((b, 20), np.int32),
        "boxes": rng.standard_normal((b, 10, 5)).astype(np.float32),
        "features": rng.standard_normal((b, 10, 2048)).astype(np.float32),
        "label_ids": rng.integers(0, vocab, (b, 10, 8)).astype(np.int32),
    }


def rank_main(rank: int, world: int, port: int, device_name: str, tiny_only: bool, out: str) -> None:
    """One rank of the dry run; rank 0 writes the stages' results to ``out``."""
    import torch
    import torch.distributed as dist

    from ..ensemble.vectorized import fusion_filter_device
    from ..models import Precision, get_model
    from ..models.core import TRAIN_PLAIN_BLOCKS
    from ..models.two_tower import recall_sharded
    from ..parallel import ScoringEngine, make_mesh, maybe_initialize, resolve_device, shard_batch
    from ..parallel.distributed import all_gather_rows
    from ..train import TrainConfig, Trainer

    device = resolve_device(device_name)
    assert maybe_initialize(f"tcp://localhost:{port}", world, rank, device=device_name, backend="gloo")
    mesh = make_mesh()
    rng = np.random.default_rng(0)  # the same stream on every rank

    def gathered(t: torch.Tensor) -> torch.Tensor:
        return all_gather_rows(t.contiguous())

    # 1. the tiny DP train step, in f32 on the plain blocks (its 8-wide heads fit no kernel)
    spec = get_model("imagebert_b", overrides=TINY_B)
    trainer = Trainer(spec, TrainConfig(optimizer="adam_staircase", clip="value", ema_decay=0.997),
                      precision=Precision.f32(), device=device, blocks=TRAIN_PLAIN_BLOCKS)
    state = trainer.init_state(seed=0)
    b = 8 * world  # each rank's rows on the train blocks' dropout blocks (8 pairs)
    batch = _b_batch(b, TINY_B["vocab_size"], rng)
    metrics = trainer.train_step(state, shard_batch(mesh, batch), seed=1)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"non-finite loss {loss}"
    assert state.step == 1
    # 2. one sharded scoring step (B's AM head takes fed labels: scorers feed ones)
    engine = ScoringEngine(spec, trainer.eval_params(state), device=device, precision=Precision.f32())
    local = shard_batch(mesh, {**batch, "labels": np.ones((b,), np.int32)})
    with torch.no_grad():
        scores = gathered(engine.score_batch(local).float())
    assert scores.shape == (b,) and bool(torch.isfinite(scores).all()), scores
    # 3. sharded recall against numpy
    q = rng.standard_normal((4, 16)).astype(np.float32)
    catalog = rng.standard_normal((8 * world, 16)).astype(np.float32)
    _, top_i = recall_sharded(torch.from_numpy(q).to(device), torch.from_numpy(catalog).to(device), mesh, k=3,
                              chunk=8)
    top_i = top_i.cpu().numpy()
    want = np.argsort(-(q @ catalog.T), axis=1)[:, :3]
    assert top_i.shape == (4, 3) and (top_i >= 0).all() and (np.sort(top_i, 1) == np.sort(want, 1)).all()
    result = {"loss": loss, "recall": top_i.tolist()}
    # 4. the full-config stage
    if not tiny_only:
        full = get_model("imagebert_a")
        assert full.config.num_hidden_layers == 12 and full.config.hidden_size == 768
        b_full = 8 * world
        full_batch = _a_batch(b_full, full.config.vocab_size, np.random.default_rng(2))
        full_batch["labels"] = rng.integers(0, 2, (b_full,)).astype(np.int32)
        full_trainer = Trainer(full, device=device)
        full_state = full_trainer.init_state(seed=2)
        full_loss = float(full_trainer.train_step(full_state, shard_batch(mesh, full_batch), seed=3)["loss"])
        assert np.isfinite(full_loss), f"non-finite full-config loss {full_loss}"
        full_engine = ScoringEngine(full, full_trainer.eval_params(full_state), device=device)
        with torch.no_grad():
            full_scores = gathered(full_engine.score_batch(shard_batch(mesh, full_batch)).float())
        assert full_scores.shape == (b_full,) and bool(torch.isfinite(full_scores).all())
        result.update(full_loss=full_loss, full_scores=full_scores[:2].cpu().tolist())
        del full_state, full_engine, full_trainer
    # 5. the sharded fusion
    n_pairs, n_products = 16 * world, 24
    pair_scores = rng.random((n_pairs, 4)).astype(np.float32)
    pcodes = rng.integers(0, n_products, (n_pairs,)).astype(np.int64)
    shard = shard_batch(mesh, {"s": pair_scores, "p": pcodes})
    merge_d, keep_d = fusion_filter_device(gathered(torch.from_numpy(shard["s"]).to(device)),
                                           gathered(torch.from_numpy(shard["p"]).to(device)), n_products)
    merge_h, keep_h = fusion_filter_device(torch.from_numpy(pair_scores), torch.from_numpy(pcodes), n_products)
    np.testing.assert_allclose(merge_d.cpu().numpy(), merge_h.numpy(), atol=1e-6)
    assert bool((keep_d.cpu() == keep_h).all())
    result.update(keep=int(keep_d.sum()), n_pairs=n_pairs)
    # every rank agrees on the loss (the all-reduced metric)
    losses = [torch.zeros(1) for _ in range(world)]
    dist.all_gather(losses, torch.tensor([loss]))
    assert len({float(x) for x in losses}) == 1, losses
    if rank == 0:
        Path(out).write_text(json.dumps(result))
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv: list[str] | None = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=2, help="ranks")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--tiny-only", action="store_true", help="leave out the full-config (12 x 768) stage")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)  # a spawned rank
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args.rank, args.n, args.port, args.device, args.tiny_only, args.out)
        return ""
    from ..parallel import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: raise here, before spawning
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    with tempfile.TemporaryDirectory() as d:
        out = str(Path(d) / "rank0.json")
        cmd = [sys.executable, "-m", __spec__.name, str(args.n), "--device",
               args.device, "--port", str(port), "--out", out] + (["--tiny-only"] if args.tiny_only else [])
        procs = [subprocess.Popen([*cmd, "--rank", str(r)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for r in range(args.n)]
        try:
            errs = [p.communicate(timeout=RANK_TIMEOUT_S)[1] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, err) in enumerate(zip(procs, errs)):
            if p.returncode != 0:
                raise SystemExit(f"dryrun_multichip({args.n}): rank {r} failed (exit {p.returncode}):\n{err[-4000:]}")
        res = json.loads(Path(out).read_text())
    full = (f", full-config 12x768 loss={res['full_loss']:.4f} scores[:2]={[round(s, 4) for s in res['full_scores']]}"
            if "full_loss" in res else "")
    line = (f"dryrun_multichip({args.n}): ok, loss={res['loss']:.4f}{full}, "
            f"sharded fusion keep={res['keep']}/{res['n_pairs']}")
    print(line, flush=True)
    return line


if __name__ == "__main__":
    main()
