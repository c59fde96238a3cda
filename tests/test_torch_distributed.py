"""The port's data parallelism (``parallel/mesh.py``, ``parallel/distributed.py``, the data-parallel ``Trainer``,
``cli/train.py --distributed``) against the JAX package's and against one rank.

* ``process_shard``, ``stride_lines`` and ``local_rows`` equal to JAX's (``tests/test_distributed.py:24-78``).
* Two gloo processes on the CPU (``tests/torch_distributed_worker.py``, a free port found as
  ``tests/test_distributed.py`` finds one, a time limit each): two steps of ImageBERT-B at dropout 0.1, of
  ImageBERT-A with the MLM and Multi-Similarity losses, of the two-tower (in-batch negatives, a query group
  across the ranks), and of B at dropout 0. The ranks' losses are equal; each loss is within 1e-6 of the port's
  one-process run on the global batch (of max(1, |loss|), as JAX's test scales its checksum) and the parameter
  checksum within 1e-6 relative of it; B at dropout 0
  is held to the JAX ``Trainer``'s two steps on the global batch (losses 1e-5, parameters 7 LR, the budgets of
  ``tests/test_torch_imagebert_b_train.py``).
* The dropout masks of a rank's rows (the train blocks' hash masks and the embeddings') equal the global
  batch's rows, bit for bit.
* ``cli/train.py --distributed`` at world 1 under gloo (``torchrun``'s environment) writes the checkpoint and
  metrics of the run without it, bit for bit.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.parallel import distributed as jax_distributed
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import core
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops import dropout
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import distributed, mesh
import torch_distributed_worker as worker

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:  # a free localhost port for the rendezvous
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    return {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_", "MASTER_", "RANK", "WORLD_"))}


@pytest.mark.parametrize("n_files", [1, 3, 10])
@pytest.mark.parametrize("count", [1, 2, 4])
def test_process_shard_matches_jax(n_files, count):
    files = [f"train{i}.tsv" for i in range(n_files)]
    for pid in range(count):
        got = distributed.process_shard(files, process_id=pid, process_count=count)
        assert got == jax_distributed.process_shard(files, process_id=pid, process_count=count)
    slices = [distributed.process_shard(files, process_id=p, process_count=count) for p in range(count)]
    if n_files >= count:
        assert sorted(f for s, _ in slices for f in s) == sorted(files)


@pytest.mark.parametrize("count", [2, 3])
def test_stride_lines_matches_jax(count):
    lines = [f"row{i}" for i in range(11)]
    slices = [list(distributed.stride_lines(iter(lines), process_id=p, process_count=count)) for p in range(count)]
    for p in range(count):
        assert slices[p] == list(jax_distributed.stride_lines(iter(lines), process_id=p, process_count=count))
    assert sorted(x for s in slices for x in s) == sorted(lines)


def test_local_rows_and_single_process_helpers():
    assert distributed.local_rows(256, process_id=0, process_count=8) == 32
    with pytest.raises(AssertionError):
        distributed.local_rows(100, process_id=0, process_count=8)
    assert distributed.process_count() == 1 and distributed.process_index() == 0
    m = mesh.make_mesh()
    assert m.shape == {mesh.DATA_AXIS: 1, mesh.MODEL_AXIS: 1}
    batch = {"x": np.arange(32, dtype=np.int32).reshape(16, 2)}
    assert distributed.global_batch_from_local(m, batch) is batch
    np.testing.assert_array_equal(mesh.shard_batch(m, batch)["x"], batch["x"])
    assert mesh.batch_sharding(mesh.Mesh(4, 2), 16) == slice(8, 12)
    assert mesh.data_parallel_batch_size(mesh.Mesh(4, 0), 32) == 128
    with pytest.raises(ValueError):
        mesh.make_mesh(n_model=2)
    x = torch.ones(3)
    assert distributed.all_gather_rows(x) is x and distributed.all_reduce_sum(x) is x


def test_maybe_initialize_needs_a_group(monkeypatch):
    for k in distributed.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.delenv("KMR_DISTRIBUTED", raising=False)
    assert distributed.maybe_initialize(device="cpu") is False
    with pytest.raises(RuntimeError, match="torchrun"):
        distributed.maybe_initialize(force=True, device="cpu")
    monkeypatch.setenv("KMR_DISTRIBUTED", "1")
    with pytest.raises(RuntimeError, match="torchrun"):
        distributed.maybe_initialize(device="cpu")


@pytest.mark.parametrize("kind", ["ffn", "attn"])
@pytest.mark.parametrize("world", [2, 4])
def test_rank_masks_are_the_global_batch_rows(kind, world):
    """A rank's train-block masks (the hidden draw and, for attention, each head's probabilities) and its
    embedding dropout mask are its rows of the one-rank masks, bit for bit."""
    global_b, s, h, heads, rate, seed = 32, 6, 8, 2, 0.3, 12345
    block = dropout.pick_block(global_b, dropout.train_block(kind))
    want_h = dropout.hidden_keep(seed, rate, global_b * s, h, block * s)
    want_p = dropout.cross_probs_keep(seed, rate, global_b, heads, s, s, block)
    gen = torch.Generator().manual_seed(5)
    x = torch.ones(global_b, s, h)
    want_e = core.dropout(x, rate, gen)
    rows = global_b // world
    for r in range(world):
        with dropout.batch_shard(r * rows, global_b):
            blk, sd = dropout.shard_block(kind, rows, None, seed)
            assert blk == block
            got_h = dropout.hidden_keep(sd, rate, rows * s, h, blk * s)
            got_p = dropout.cross_probs_keep(sd, rate, rows, heads, s, s, blk)
            got_e = core.dropout(x[:rows], rate, torch.Generator().manual_seed(5))
        assert torch.equal(got_h, want_h[r * rows * s:(r + 1) * rows * s])
        assert torch.equal(got_p, want_p[r * rows:(r + 1) * rows])
        assert torch.equal(got_e, want_e[r * rows:(r + 1) * rows])
    assert dropout.shard_rows() is None


def test_shard_block_refuses_rows_off_the_blocks():
    with dropout.batch_shard(4, 16), pytest.raises(ValueError, match="dropout blocks"):
        dropout.shard_block("attn", 4, None, 1)  # 4 rows of the global batch's 8-pair attention blocks


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every case on 2 gloo ranks (one process pair), and on one process over the global batch."""
    out = tmp_path_factory.mktemp("dp")
    port = free_port()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_distributed_worker.py"), str(r), "2",
                               str(port), str(out / f"r{r}.json"), *worker.CASES],
                              cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=RANK_TIMEOUT_S)
        assert p.returncode == 0, err[-3000:]
    ranks = [json.loads((out / f"r{r}.json").read_text()) for r in range(2)]
    return ranks, {name: worker.run_case(name) for name in worker.CASES}


@pytest.mark.parametrize("name", worker.CASES)
def test_two_ranks_equal_one_rank_on_the_global_batch(two_ranks, name):
    ranks, single = two_ranks
    r0, r1, ref = ranks[0][name], ranks[1][name], single[name]
    assert r0["losses"] == r1["losses"] and r0["checksum"] == r1["checksum"] and r0["step"] == worker.STEPS
    assert r0["metrics"] == r1["metrics"]
    for got, want in zip(r0["losses"], ref["losses"], strict=True):  # 1e-6 of max(1, |loss|), 2 ulp at the tower's 7.6
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)
    assert abs(r0["checksum"] - ref["checksum"]) <= 1e-6 * abs(ref["checksum"])
    for k, v in ref["metrics"].items():
        assert r0["metrics"][k] == pytest.approx(v, rel=1e-5, abs=1e-6), k


def test_two_ranks_match_jax_trainer(two_ranks):
    """B at dropout 0 on 2 ranks against the JAX Trainer's two steps on the 8-device CPU mesh over the global
    batch: each step's loss within 1e-5; and the port's one-rank parameters (within 1e-6 of the two ranks',
    above) within 7 LR of JAX's."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import Precision as JaxPrecision
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import imagebert_b as jax_b
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models.core import BertConfig as JaxBertConfig
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models.registry import ModelSpec as JaxModelSpec
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ops.pallas_train import train_fused
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.parallel import make_mesh as jax_make_mesh
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import TrainConfig as JaxTrainConfig
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import Trainer as JaxTrainer
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import params_from_jax, params_to_jax
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train.optim import flatten_paths

    name = "imagebert_b_no_dropout"
    trainer, spec = worker.make_trainer(name)
    jcfg = JaxBertConfig(**dataclasses.asdict(spec.config))
    jspec = JaxModelSpec("imagebert_b", jcfg, init=lambda rng: jax_b.init_params(rng, jcfg), apply=jax_b.apply,
                         featurizer_layout="imagebert_b")
    tc = trainer.tc
    jtc = JaxTrainConfig(learning_rate=tc.learning_rate, optimizer=tc.optimizer, clip=tc.clip,
                         clip_value=tc.clip_value, ema_decay=tc.ema_decay)
    jtree = params_to_jax(spec.init_params(3))
    batch = worker.global_batch(name)
    with train_fused("interpret"):
        jt = JaxTrainer(jspec, jtc, mesh=jax_make_mesh(), precision=JaxPrecision.f32())
        state = jt.init_state(jax.random.key(0))
        params, shadow = (jax.device_put(jax.tree.map(jnp.asarray, jtree), jt._replicated) for _ in range(2))
        state = state._replace(params=params, opt_state=jt.tx.init(params), ema=state.ema._replace(shadow=shadow))
        losses = []
        for step in range(worker.STEPS):
            state, metrics = jt.train_step(state, batch, jax.random.key(step))
            losses.append(float(metrics["loss"]))
        jax_params = flatten_paths(params_from_jax(jax.tree.map(np.asarray, state.params)))
    np.testing.assert_allclose(two_ranks[0][0][name]["losses"], losses, rtol=0, atol=1e-5)
    # the port's one-rank run, whose checksum the two ranks match within 1e-6 relative
    pstate = trainer.init_state(spec.init_params(3))
    for step in range(worker.STEPS):
        trainer.train_step(pstate, batch, seed=100 + step)
    got = flatten_paths(params_from_jax(params_to_jax(spec.eval_params(pstate.params))))
    for pname, value in jax_params.items():
        np.testing.assert_allclose(got[pname].numpy(), value.numpy(), atol=7 * tc.learning_rate, rtol=0,
                                   err_msg=pname)


def test_train_cli_distributed_world_one_is_the_plain_run(tmp_path):
    """``cli/train.py --distributed`` under a one-process gloo group (torchrun's environment) trains bit for bit
    as the run without it: its checkpoint and its logged metrics."""
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import load_npz
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import synthetic

    header, *rows = synthetic.make_tsv(24, seed=3)
    tsv = tmp_path / "pairs.tsv"
    tsv.write_text("\n".join([header, *rows]) + "\n")
    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"{k}\t{v}\n" for k, v in synthetic.SYNTHETIC_LABELS.items()))
    env = {**_env(), "KMR_TOWER_CONFIG_OVERRIDES": json.dumps(worker.TOWER)}
    outs = {}
    for mode in ("plain", "distributed"):
        out = tmp_path / mode
        argv = [sys.executable, "-m", "kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.train",
                "--model", "two_tower", "--train-tsv", str(tsv), "--labels", str(labels), "--steps", "2",
                "--batch-size", "8", "--out", str(out), "--device", "cpu", "--checkpoint-every", "2"]
        run_env = dict(env)
        if mode == "distributed":
            argv.append("--distributed")
            run_env.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()), RANK="0", WORLD_SIZE="1",
                           LOCAL_RANK="0")
        p = subprocess.run(argv, cwd=ROOT, env=run_env, capture_output=True, text=True, timeout=RANK_TIMEOUT_S)
        assert p.returncode == 0, p.stderr[-3000:]
        report = json.loads(p.stdout.strip().splitlines()[-1])
        assert report["world_size"] == 1 and report["steps"] == 2
        outs[mode] = out
    a, b = (load_npz(outs[m] / "step_2.npz") for m in ("plain", "distributed"))
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint.npz import flatten_tree

    fa, fb = flatten_tree(a), flatten_tree(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    assert (outs["plain"] / "metrics.jsonl").read_text() == (outs["distributed"] / "metrics.jsonl").read_text()
