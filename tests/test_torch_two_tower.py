"""The port's two-tower model (``models/two_tower.py``) against the JAX
package's, mirroring ``tests/test_two_tower.py`` (but for ``recall_sharded``,
a mesh's, which the port has not yet).

At the tiny tower of ``KMR_TOWER_CONFIG_OVERRIDES`` (H=32, 2 layers, 4 heads,
I=37, embed_dim 16), from the same numpy parameters and inputs:

* ``embed_query``, ``embed_product`` and ``apply`` within 1e-5 in f32, on a
  batch with a product of no boxes and a query of one token (bf16 within
  2e-2: the embeddings are unit vectors rounded at bf16 casts);
* ``contrastive_loss`` with and without groups within 1e-6, its gradients
  within 1e-5;
* ``top_k_products``: JAX's indices exactly and its scores within 1e-6, with
  duplicated catalog rows (exact ties, in JAX's order), a catalog smaller
  than k and ``num_valid`` padding;
* one ``Trainer`` step against the JAX ``Trainer`` on the 8-device CPU mesh
  (loss 1e-5, gradients 1e-4 abs + rel), the kernel route equal to the plain
  route, and the tree's round trip through ``params_from_jax``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import Precision as JaxPrecision
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import get_model as jax_get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import two_tower as jax_two_tower
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.parallel import make_mesh
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import Trainer as JaxTrainer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import recipe_for as jax_recipe_for
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import (
    load_checkpoint,
    params_from_jax,
    params_to_jax,
    save_npz,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model, two_tower
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models.core import TRAIN_PLAIN_BLOCKS
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train import Trainer, recipe_for
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train.optim import flatten_paths
from torch_parity import TINY, numpy_like

TOWER = {"bert": TINY, "embed_dim": 16}


@pytest.fixture(autouse=True)
def _tiny_tower(monkeypatch):
    monkeypatch.setenv("KMR_TOWER_CONFIG_OVERRIDES", json.dumps(TOWER))


def jax_tree(seed: int) -> dict:
    """Numpy params in the JAX two-tower tree layout (the env's tiny config)."""
    tcfg = jax_two_tower.two_tower_config()
    return numpy_like(jax.eval_shape(lambda: jax_two_tower.init_params(jax.random.key(0), tcfg)), seed)


def tower_batch(b: int, seed: int, vocab: int = 21128) -> dict[str, np.ndarray]:
    """A batch of both towers' inputs; row 0's product has no box, row 1's query is one token."""
    rng = np.random.default_rng(seed)
    batch = {
        "input_ids": rng.integers(0, vocab, (b, 20)).astype(np.int32),
        "len_query": rng.integers(2, 21, (b,)).astype(np.int32),
        "boxes": rng.standard_normal((b, 10, 5)).astype(np.float32),
        "features": rng.standard_normal((b, 10, 2048)).astype(np.float32),
        "label_ids": rng.integers(0, vocab, (b, 10, 8)).astype(np.int32),
        "num_boxes": rng.integers(1, 11, (b,)).astype(np.int32),
    }
    batch["num_boxes"][0] = 0
    batch["len_query"][1] = 1
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("part", ["embed_query", "embed_product", "apply"])
def test_towers_match_jax(part):
    tree, batch = jax_tree(1), tower_batch(6, 2)
    tcfg = jax_two_tower.two_tower_config()
    want = jax.jit(lambda p, b: getattr(jax_two_tower, part)(p, b, tcfg))(jax.tree.map(jnp.asarray, tree), batch)
    spec = get_model("two_tower")
    got = getattr(two_tower, part)(spec.from_jax(params_from_jax(tree)), _torch(batch), spec.config, Precision.f32())
    if part == "apply":
        assert got.keys() == want.keys() == {"q_emb", "p_emb", "score", "probs"}
        for key in got:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5, rtol=0, err_msg=key)
    else:
        assert got.shape == (6, 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, atol=1e-5)


def test_towers_bf16_match_jax():
    """bf16 matmul inputs on both sides (the port's engine casts the matmul
    kernels once; the label conv and the projections are the GEMM's "f32"
    epilogue, whose plain version runs on the CPU)."""
    tree, batch = jax_tree(3), tower_batch(5, 4)
    tcfg = jax_two_tower.two_tower_config()
    want = jax.jit(lambda p, b: jax_two_tower.apply(p, b, tcfg, JaxPrecision.bf16()))(
        jax.tree.map(jnp.asarray, tree), batch)
    spec = get_model("two_tower")
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import cast_matmul_weights

    params = cast_matmul_weights(spec.from_jax(params_from_jax(tree)), torch.bfloat16, spec.matmul_kernels)
    got = two_tower.apply(params, _torch(batch), spec.config, Precision.bf16())
    for key in ("q_emb", "p_emb", "score"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-2, rtol=0, err_msg=key)


@pytest.mark.parametrize("grouped", [False, True], ids=["no_groups", "groups"])
def test_contrastive_loss_matches_jax(grouped):
    rng = np.random.default_rng(5)
    q, p = rng.standard_normal((2, 8, 16)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    q[3] = q[2]  # one query twice: a false negative without the group mask
    groups = np.array([7, 8, 9, 9, 10, 11, 11, 12], np.int32) if grouped else None

    def jax_loss(q_, p_):
        return jax_two_tower.contrastive_loss(q_, p_, 0.05, None if groups is None else jnp.asarray(groups))

    (want, want_m), (gq, gp) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(q),
                                                                                         jnp.asarray(p))
    qt, pt = torch.from_numpy(q).requires_grad_(), torch.from_numpy(p).requires_grad_()
    got, got_m = two_tower.contrastive_loss(qt, pt, 0.05, None if groups is None else torch.from_numpy(groups))
    got.backward()
    assert got.item() == pytest.approx(float(want), abs=1e-6)
    assert got_m["in_batch_accuracy"].item() == float(want_m["in_batch_accuracy"])
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(gq), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gp), atol=1e-5, rtol=0)


def test_contrastive_group_mask_removes_false_negatives():
    rng = np.random.default_rng(0)
    q, p = (torch.nn.functional.normalize(torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)), dim=1)
            for _ in range(2))
    q[1] = q[0]
    plain, _ = two_tower.contrastive_loss(q, p, 0.1)
    masked, _ = two_tower.contrastive_loss(q, p, 0.1, torch.tensor([7, 7, 8, 9]))
    distinct, _ = two_tower.contrastive_loss(q, p, 0.1, torch.tensor([1, 2, 3, 4]))
    assert masked.item() < plain.item() and distinct.item() == pytest.approx(plain.item(), rel=1e-6)


def _catalog(case: str, rng):
    """-> (queries [Q, D] f32, catalog [N, D] f32, k, chunk, num_valid)."""
    q = rng.standard_normal((7, 16)).astype(np.float32)
    if case == "random":
        return q, rng.standard_normal((1000, 16)).astype(np.float32), 5, 128, None
    if case == "duplicates":  # 300 rows drawn from 40: exact ties, which JAX orders by index
        base = rng.standard_normal((40, 16)).astype(np.float32)
        return q, base[rng.integers(0, 40, 300)], 9, 64, None
    if case == "smaller_than_k":
        return q, rng.standard_normal((3, 16)).astype(np.float32), 5, 128, None
    return q, -np.abs(rng.standard_normal((50, 16))).astype(np.float32), 5, 16, 37  # num_valid padding


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["random", "duplicates", "smaller_than_k", "num_valid"])
def test_top_k_products_matches_jax(case, dtype):
    q, cat, k, chunk, num_valid = _catalog(case, np.random.default_rng(11))
    jcat = jnp.asarray(cat, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want_s, want_i = jax.jit(lambda q_, c_: jax_two_tower.top_k_products(q_, c_, k=k, chunk=chunk,
                                                                        num_valid=num_valid))(jnp.asarray(q), jcat)
    tcat = torch.from_numpy(cat).to(getattr(torch, dtype))
    got_s, got_i = two_tower.top_k_products(torch.from_numpy(q), tcat, k=k, chunk=chunk, num_valid=num_valid)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-6, rtol=0)
    if case == "smaller_than_k":
        assert (got_i.numpy()[:, 3:] == -1).all() and np.isneginf(got_s.numpy()[:, 3:]).all()
    if case == "num_valid":
        assert (got_i.numpy() < num_valid).all()


def test_top_k_stable_orders_ties_by_position():
    s = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 3.0], [0.0, 0.0, 0.0, 0.0, 0.0, 1.0]])
    vals, pos = two_tower.top_k_stable(s, 3)
    assert pos.tolist() == [[1, 2, 4], [5, 0, 1]] and vals.tolist() == [[3.0, 3.0, 3.0], [1.0, 0.0, 0.0]]


@pytest.fixture(scope="module")
def jax_step():
    """The JAX Trainer's loss and gradients of one tower step on the 8-device CPU mesh."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KMR_TOWER_CONFIG_OVERRIDES", json.dumps(TOWER))
        tree = jax_tree(7)
        batch = {**tower_batch(8, 8), "labels": np.ones(8, np.int32),
                 "query_group": np.array([0, 0, 1, 2, 3, 3, 4, 5], np.int32)}
        tc = dataclasses.replace(jax_recipe_for("two_tower"), num_warmup_steps=0)
        trainer = JaxTrainer(jax_get_model("two_tower"), tc, mesh=make_mesh(), precision=JaxPrecision.f32())
        params = jax.device_put(jax.tree.map(jnp.asarray, tree), trainer._replicated)
        (loss, metrics), grads = jax.jit(jax.value_and_grad(trainer._loss_fn, has_aux=True))(
            params, batch, jax.random.key(1))
    return {"tree": tree, "batch": batch, "loss": float(loss), "accuracy": float(metrics["in_batch_accuracy"]),
            "grads": jax.tree.map(np.asarray, grads)}


def test_trainer_step_matches_jax(jax_step):
    spec = get_model("two_tower")
    trainer = Trainer(spec, dataclasses.replace(recipe_for("two_tower"), num_warmup_steps=0),
                      precision=Precision.f32(), device="cpu")
    state = trainer.init_state(spec.from_jax(params_from_jax(jax_step["tree"])))
    dev_batch = trainer.to_device(jax_step["batch"])
    assert "query_group" in dev_batch
    grads, metrics = trainer.grads(state, dev_batch, seed=0)
    assert metrics["loss"].item() == pytest.approx(jax_step["loss"], abs=1e-5)
    assert metrics["in_batch_accuracy"].item() == jax_step["accuracy"]
    want = flatten_paths(params_from_jax(jax_step["grads"]))  # kdd_conv1 as its taps on both sides
    assert set(want) == set(state.optimizer.names)
    for name, g in zip(state.optimizer.names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-4, err_msg=name)
    applied = trainer.apply(state, grads)
    assert np.isfinite(applied["grad_norm"].item()) and state.step == 1


def test_trainer_kernel_route_equals_plain_route(jax_step):
    """The train blocks at dropout 0 (the kernel route, their plain versions on
    the CPU) and the plain oracles give one loss and one set of gradients."""
    spec = get_model("two_tower")
    out = []
    for kw in ({}, {"blocks": TRAIN_PLAIN_BLOCKS}):
        trainer = Trainer(spec, recipe_for("two_tower"), precision=Precision.f32(), device="cpu", **kw)
        state = trainer.init_state(spec.from_jax(params_from_jax(jax_step["tree"])))
        out.append(trainer.grads(state, trainer.to_device(jax_step["batch"]), seed=3))
    (g0, m0), (g1, m1) = out
    assert m0["loss"].item() == pytest.approx(m1["loss"].item(), abs=1e-6)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4)


def test_tree_round_trip_and_npz_load(tmp_path):
    """params_to_jax inverts params_from_jax on the tower tree (its two
    encoders, the label conv's taps), and the JAX tree's npz loads in the port."""
    tree = jax_tree(9)
    spec = get_model("two_tower")
    params = spec.from_jax(params_from_jax(tree))
    assert "qkv" in params["query_encoder"]["attention"] and "kernel" in params["kdd_conv1"]
    back = params_to_jax(params)
    assert flatten_paths(back).keys() == flatten_paths(tree).keys()
    for name, value in flatten_paths(tree).items():
        np.testing.assert_array_equal(flatten_paths(back)[name], value, err_msg=name)
    save_npz(tmp_path / "tower.npz", tree)
    loaded = load_checkpoint("two_tower", tmp_path / "tower.npz", spec)
    for name, value in flatten_paths(params).items():
        torch.testing.assert_close(flatten_paths(loaded)[name], value, rtol=0, atol=0)
    with pytest.raises(ValueError, match="npz param tree"):
        load_checkpoint("two_tower", tmp_path / "tower.pth", spec)


def test_random_init_is_seeded_and_unit():
    spec = get_model("two_tower")
    p0, p1 = spec.init_params(4), spec.init_params(4)
    torch.testing.assert_close(p0["kdd_conv1"]["kernel"], p1["kdd_conv1"]["kernel"], rtol=0, atol=0)
    out = spec.apply(p0, _torch(tower_batch(4, 6)), spec.config, Precision.f32())
    assert out["q_emb"].shape == out["p_emb"].shape == (4, 16)
    # row 0's product has no box: its pooled mean is 0, and so its embedding under the zero projection bias of
    # a fresh init (the 1e-12 floor of the L2 norm keeps it finite, as in the JAX package)
    norms = out["p_emb"].norm(dim=1).numpy()
    assert norms[0] == 0.0
    np.testing.assert_allclose(norms[1:], 1.0, atol=1e-5)
    assert torch.allclose(out["probs"][:, 1], out["score"]) and (out["score"].abs() <= 1 + 1e-5).all()
