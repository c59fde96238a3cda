"""The port's training stack against the JAX package's.

BERT-Adam, the decay mask, the schedules, clipping, EMA, the NSP and MS
losses, and one ``Trainer`` step of a tiny ImageBERT-A (2 layers, H=64,
dropout 0, warmup 0): the JAX ``Trainer`` on the 8-device CPU mesh (B=8) with
its train kernels in interpret mode (``train_fused("interpret")``), the port's
``Trainer`` on the CPU (its train blocks' plain versions), both in f32 from
the same numpy parameters and batch. Budgets: the loss within 1e-5 and every
gradient within 1e-4 abs + rel (f32 on both sides, summation order only); the
parameters after the step within 7 LR: Adam without bias correction moves a
parameter by ~3.16 LR in its gradient's sign, so a near-zero gradient whose
sign differs between the two sides moves it ~6.3 LR apart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import Precision as JaxPrecision
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import heads as jax_heads
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import imagebert_a as jax_imagebert_a
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models.core import BertConfig as JaxBertConfig
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models.registry import ModelSpec as JaxModelSpec
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ops.pallas_train import train_fused
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.parallel import make_mesh
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import TrainConfig as JaxTrainConfig
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import Trainer as JaxTrainer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import ema as jax_ema
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import losses as jax_losses
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import optim as jax_optim
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import params_from_jax, params_to_jax
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model, heads
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models.core import TRAIN_PLAIN_BLOCKS
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train import (
    BertAdamW,
    Ema,
    Trainer,
    TrainConfig,
    clip_by_global_norm,
    clip_by_value,
    decay_mask,
    exponential_staircase_schedule,
    make_loss_fn,
    ms_loss,
    polynomial_warmup_schedule,
    recipe_for,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train.optim import flatten_paths
from torch_parity import imagebert_a_batch, jax_imagebert_a_params

TINY = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 128,
        "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
B = 8
LR = 1e-3


def _tree(seed: int):
    """A small param tree with decayed and undecayed names, numpy f32."""
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"enc": {"dense": {"kernel": f(4, 3), "bias": f(3)}, "LayerNorm": {"gamma": f(3)}},
            "cls": {"output_weights": f(2, 3), "output_bias": f(2)}}


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in flatten_paths(tree).items()}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)) for k, v in tree.items()}


# ---- optimizer, schedules, clipping, EMA, losses ---------------------------------


def test_bert_adamw_matches_jax():
    params, sched = _tree(0), jax_optim.polynomial_warmup_schedule(0.1, 10, 2)
    tx = jax_optim.bert_adamw(sched)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = _to_torch(params)
    opt = BertAdamW(tp, polynomial_warmup_schedule(0.1, 10, 2))
    leaves = list(flatten_paths(tp).values())
    for step in range(4):
        grads = _tree(10 + step)
        upd, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        opt.update(leaves, list(flatten_paths(_to_torch(grads)).values()))
    want = _flat_np(jax.tree.map(np.asarray, jp))
    for name, leaf in flatten_paths(tp).items():
        np.testing.assert_allclose(leaf.numpy(), want[name], rtol=1e-5, atol=1e-6, err_msg=name)
    assert opt.step == 4


def test_decay_mask_matches_jax_on_imagebert_a():
    cfg = JaxBertConfig(**{**TINY, "vocab_size": 97})
    jtree = jax_imagebert_a_params(cfg, 0)
    jmask = _flat_np(jax_optim.decay_mask(jtree))
    mask = decay_mask(params_from_jax(jtree))
    assert mask["bert/encoder/attention/qkv/kernel"] and not mask["bert/encoder/attention/qkv/bias"]
    for name, decayed in mask.items():
        if "/qkv/" not in name:
            assert decayed == bool(jmask[name]), name
    for part in ("query", "key", "value"):
        assert jmask[f"bert/encoder/attention/{part}/kernel"] and not jmask[f"bert/encoder/attention/{part}/bias"]


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 999, 1000, 5000])
def test_schedules_match_jax(step):
    """Within 1e-6 of the initial LR: the JAX schedule runs in f32, the port's in
    Python floats (1 - 999/1000 differs by 1e-3 relative between the two)."""
    for port, ref in ((polynomial_warmup_schedule(1e-4, 1000, 100), jax_optim.polynomial_warmup_schedule(1e-4, 1000, 100)),
                      (polynomial_warmup_schedule(1e-4, 1000, 0), jax_optim.polynomial_warmup_schedule(1e-4, 1000, 0)),
                      (exponential_staircase_schedule(2e-5), jax_optim.exponential_staircase_schedule(2e-5))):
        assert port(step) == pytest.approx(float(ref(step)), rel=1e-6, abs=1e-10)


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clipping_matches_jax(scale):
    grads = jax.tree.map(lambda a: a * scale, _tree(3))
    jclipped, jnorm = jax_optim.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 1.0)
    tg = list(flatten_paths(_to_torch(grads)).values())
    norm = clip_by_global_norm(tg, 1.0)
    assert norm.item() == pytest.approx(float(jnorm), rel=1e-6)
    for got, want in zip(tg, _flat_np(jax.tree.map(np.asarray, jclipped)).values()):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    tv = list(flatten_paths(_to_torch(grads)).values())
    clip_by_value(tv, 1.0)
    for got, want in zip(tv, _flat_np(jax_optim.clip_by_value(jax.tree.map(jnp.asarray, grads), 1.0)).values()):
        np.testing.assert_array_equal(got.numpy(), want)


def test_ema_matches_jax():
    params = [torch.zeros(3)]
    ema, state = Ema(params, 0.997), jax_ema.ema_init({"w": jnp.zeros(3)})
    for i in range(5):
        value = np.full(3, float(i + 1), np.float32)
        ema.update([torch.from_numpy(value)])
        state = jax_ema.ema_update(state, {"w": jnp.asarray(value)}, 0.997)
    np.testing.assert_allclose(ema.shadow[0].numpy(), np.asarray(state.shadow["w"]), rtol=1e-6)
    assert ema.num_updates == int(state.num_updates) == 5


def test_nsp_loss_matches_jax():
    r = np.random.default_rng(4)
    p = {"output_weights": r.standard_normal((2, 16)).astype(np.float32),
         "output_bias": r.standard_normal(2).astype(np.float32)}
    pooled, labels = r.standard_normal((8, 16)).astype(np.float32), r.integers(0, 2, 8).astype(np.int32)
    want = float(jax_heads.nsp_loss(jax.tree.map(jnp.asarray, p), jnp.asarray(pooled), jnp.asarray(labels)))
    got = heads.nsp_loss(_to_torch(p), torch.from_numpy(pooled), torch.from_numpy(labels)).item()
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("mining", [False, True])
def test_ms_loss_matches_jax(mining):
    r = np.random.default_rng(5)
    emb, labels = r.standard_normal((8, 16)).astype(np.float32), np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32)
    want = float(jax_losses.ms_loss(jnp.asarray(labels), jnp.asarray(emb), ms_mining=mining))
    got = ms_loss(torch.from_numpy(labels), torch.from_numpy(emb), ms_mining=mining).item()
    assert got == pytest.approx(want, rel=1e-5)


# ---- one Trainer step against the JAX Trainer -----------------------------------------


def _jax_spec(cfg):
    return JaxModelSpec("imagebert_a", cfg, init=lambda rng: jax_imagebert_a.init_params(rng, cfg),
                        apply=jax_imagebert_a.apply, featurizer_layout="imagebert_a")


@pytest.fixture(scope="module")
def step_case():
    """The JAX Trainer's loss, gradients and stepped params on one batch, and the inputs."""
    spec = get_model("imagebert_a", overrides=TINY)
    jcfg = JaxBertConfig(**dataclasses.asdict(spec.config))
    jtree = jax_imagebert_a_params(jcfg, 11)
    batch = imagebert_a_batch(B, jcfg.vocab_size, 12)
    batch["labels"] = np.random.default_rng(13).integers(0, 2, B).astype(np.int32)
    batch["boxes"] = np.zeros((B, 10, 5), np.float32)
    tc = JaxTrainConfig(learning_rate=LR, num_warmup_steps=0, num_train_steps=1000)
    with train_fused("interpret"):
        trainer = JaxTrainer(_jax_spec(jcfg), tc, mesh=make_mesh(), precision=JaxPrecision.f32())
        state = trainer.init_state(jax.random.key(0))
        params = jax.device_put(jax.tree.map(jnp.asarray, jtree), trainer._replicated)
        state = state._replace(params=params, opt_state=trainer.tx.init(params))
        rng = jax.random.key(1)
        (loss, _), grads = jax.jit(jax.value_and_grad(trainer._loss_fn, has_aux=True))(params, batch, rng)
        state, metrics = trainer.train_step(state, batch, rng)
    return {"spec": spec, "jtree": jtree, "batch": batch, "loss": float(loss), "metrics": metrics,
            "grads": jax.tree.map(np.asarray, grads), "stepped": jax.tree.map(np.asarray, state.params)}


def test_trainer_step_matches_jax(step_case):
    spec, batch = step_case["spec"], step_case["batch"]
    tc = TrainConfig(learning_rate=LR, num_warmup_steps=0, num_train_steps=1000)
    trainer = Trainer(spec, tc, precision=Precision.f32(), device="cpu")
    state = trainer.init_state(params_from_jax(step_case["jtree"]))
    grads, metrics = trainer.grads(state, trainer.to_device(batch), seed=0)
    assert metrics["loss"].item() == pytest.approx(step_case["loss"], abs=1e-5)
    want = flatten_paths(params_from_jax(step_case["grads"]))  # JAX's q/k/v gradients concatenated as qkv
    for name, g in zip(state.optimizer.names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-4, err_msg=name)
    applied = trainer.apply(state, grads)
    assert applied["grad_norm"].item() == pytest.approx(float(step_case["metrics"]["grad_norm"]), rel=1e-4)
    stepped = flatten_paths(params_from_jax(step_case["stepped"]))
    for name, p in flatten_paths(state.params).items():
        np.testing.assert_allclose(p.detach().numpy(), stepped[name].numpy(), atol=7 * LR, rtol=0, err_msg=name)
    assert state.step == 1


def test_trainer_kernel_route_equals_plain_route_with_dropout():
    """At dropout 0.1 the kernel route (plain versions of its kernels on the CPU)
    and the plain oracle route train on the same masks: equal loss and gradients."""
    spec = get_model("imagebert_a", overrides={**TINY, "hidden_dropout_prob": 0.1,
                                               "attention_probs_dropout_prob": 0.1})
    batch = imagebert_a_batch(4, spec.config.vocab_size, 14)
    batch["labels"] = np.array([0, 1, 1, 0], np.int32)
    out = []
    for blocks in (None, TRAIN_PLAIN_BLOCKS):
        kw = {} if blocks is None else {"blocks": blocks}
        trainer = Trainer(spec, recipe_for("imagebert_a"), precision=Precision.f32(), device="cpu", **kw)
        state = trainer.init_state(seed=3)
        out.append(trainer.grads(state, trainer.to_device(batch), seed=21))
    (g0, m0), (g1, m1) = out
    assert m0["loss"].item() == pytest.approx(m1["loss"].item(), abs=1e-6)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4)


def test_params_to_jax_inverts_params_from_jax():
    cfg = JaxBertConfig(**{**TINY, "vocab_size": 97})
    jtree = jax_imagebert_a_params(cfg, 1)
    back = params_to_jax(params_from_jax(jtree))
    assert flatten_paths(back).keys() == flatten_paths(jtree).keys()  # the MLM head included: the MLM loss trains it
    for name, value in flatten_paths(jtree).items():
        np.testing.assert_array_equal(flatten_paths(back)[name], value, err_msg=name)


def test_unported_recipes_raise():
    """Every model of the registry has a recipe (two_tower's is JAX's: BERT-Adam
    at 1e-4, 1000 warmup steps, global-norm clip); a model or an optimizer
    outside the recipes raises, as the JAX package's recipe_for and
    make_optimizer do."""
    tc = recipe_for("two_tower")
    assert (tc.optimizer, tc.learning_rate, tc.num_warmup_steps, tc.clip) == ("bert_adamw", 1e-4, 1000, "global_norm")
    assert callable(make_loss_fn(get_model("two_tower"), tc, Precision.f32()))
    spec = get_model("imagebert_a", overrides=TINY)
    with pytest.raises(ValueError, match="no_such_model"):
        recipe_for("no_such_model")
    with pytest.raises(ValueError, match="no_such_model"):
        make_loss_fn(dataclasses.replace(spec, name="no_such_model"), recipe_for("imagebert_a"), Precision.f32())
    with pytest.raises(ValueError, match="sgd"):
        Trainer(spec, TrainConfig(optimizer="sgd"), device="cpu").init_state(seed=0)
