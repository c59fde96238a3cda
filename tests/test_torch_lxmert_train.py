"""The port's LXMERT training against the JAX package's.

A tiny LXMERT (2/2/2 layers, H=32, 4 heads, the config of
``tests/test_torch_lxmert.py``) on one hand-built batch with ragged masks
(pair 0 with no box, so every visn key is masked), as
``tests/test_train.py:208-319`` trains the JAX model: the loss and every
gradient of the port's ``make_loss_fn`` against the JAX ``make_loss_fn``
under ``train_fused("interpret")`` (its train kernels in interpret mode) at
dropout 0, for ``logit_fc`` cross entropy and for ``am_loss``; one
``Trainer`` step against the JAX ``Trainer`` on the 8-device CPU mesh (B=8);
the checkpoint round trip; ``visual_attention``'s ``qkv`` after a step; and
the kernel route against the plain route at dropout 0.1.

Budgets, as ``tests/test_torch_train.py``: the loss within 1e-5 and every
gradient within 1e-4 abs + rel (f32 on both sides, summation order only);
the parameters after a step within 7 LR (Adam without bias correction moves
a parameter ~3.16 LR in its gradient's sign); scores of the JAX apply on the
written tree within 1e-4 of the port's (``tests/test_torch_lxmert.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import BertConfig as JaxBertConfig
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import LxmertConfig as JaxLxmertConfig
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import Precision as JaxPrecision
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import lxmert as jax_lxmert
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models.registry import ModelSpec as JaxModelSpec
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ops.pallas_train import train_fused
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.parallel import make_mesh
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import TrainConfig as JaxTrainConfig
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import Trainer as JaxTrainer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import optim as jax_optim
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train.trainer import make_loss_fn as jax_make_loss_fn
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import params_from_jax, params_to_jax
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model, lxmert
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models.core import TRAIN_PLAIN_BLOCKS
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train import Trainer, TrainConfig, decay_mask, recipe_for
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train.optim import flatten_paths
from test_torch_lxmert import jax_lxmert_params, lxmert_batch

TINY = dict(vocab_size=101, hidden_size=32, num_hidden_layers=3, num_attention_heads=4, intermediate_size=57,
            max_position_embeddings=64, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
DEPTHS = dict(l_layers=2, x_layers=2, r_layers=2)
B, LR = 8, 1e-3
VA = "bert/encoder/x_layers/visual_attention"


def _specs(**bert):
    """(the port's tiny LXMERT spec, the JAX spec of the same config)."""
    spec = get_model("lxmert", overrides={**TINY, **bert, **DEPTHS})
    jcfg = JaxLxmertConfig(bert=JaxBertConfig(**dataclasses.asdict(spec.config.bert)), **DEPTHS,
                           visual_feat_dim=spec.config.visual_feat_dim)
    jspec = JaxModelSpec("lxmert", jcfg, init=lambda rng: jax_lxmert.init_params(rng, jcfg),
                         apply=jax_lxmert.apply, featurizer_layout="lxmert")
    return spec, jspec


def _batch(lcfg, seed: int) -> dict[str, np.ndarray]:
    batch = lxmert_batch(B, lcfg, seed)
    batch["labels"] = np.random.default_rng(seed + 100).integers(0, 2, B).astype(np.int32)
    return batch


def _tc(cls, **kw):
    return cls(learning_rate=LR, num_warmup_steps=0, num_train_steps=1000, **kw)


@pytest.fixture(scope="module")
def case():
    """The JAX loss and gradients under both losses, and the JAX Trainer's stepped
    params under cross entropy, on one tree and batch."""
    spec, jspec = _specs()
    jtree = jax_lxmert_params(jspec.config, 11)
    batch = _batch(jspec.config, 12)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {"spec": spec, "jspec": jspec, "jtree": jtree, "batch": batch}
    with train_fused("interpret"):
        for name, am in (("ce", False), ("am", True)):
            loss_fn = jax_make_loss_fn(jspec, _tc(JaxTrainConfig, am_loss=am), JaxPrecision.f32())
            (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                jax.tree.map(jnp.asarray, jtree), jbatch, jax.random.key(1))
            out[name] = (float(loss), jax.tree.map(np.asarray, grads))
        trainer = JaxTrainer(jspec, _tc(JaxTrainConfig), mesh=make_mesh(), precision=JaxPrecision.f32())
        state = trainer.init_state(jax.random.key(0))
        params = jax.device_put(jax.tree.map(jnp.asarray, jtree), trainer._replicated)
        state = state._replace(params=params, opt_state=trainer.tx.init(params))
        state, metrics = trainer.train_step(state, batch, jax.random.key(1))
    out["grad_norm"] = float(metrics["grad_norm"])
    out["stepped"] = jax.tree.map(np.asarray, state.params)
    return out


@pytest.mark.parametrize("loss", ["ce", "am"])
def test_loss_and_gradients_match_jax(case, loss):
    spec, batch = case["spec"], case["batch"]
    trainer = Trainer(spec, _tc(TrainConfig, am_loss=loss == "am"), precision=Precision.f32(), device="cpu")
    state = trainer.init_state(params_from_jax(case["jtree"]))
    grads, metrics = trainer.grads(state, trainer.to_device(batch), seed=0)
    want_loss, want_grads = case[loss]
    assert metrics["loss"].item() == pytest.approx(want_loss, abs=1e-5)
    want = flatten_paths(params_from_jax(want_grads))  # JAX's q/k/v gradients as the port's fused forms
    assert f"{VA}/qkv/kernel" not in state.optimizer.names and f"{VA}/kv/kernel" in state.optimizer.names
    for name, g in zip(state.optimizer.names, grads, strict=True):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-4, err_msg=name)
    by_name = dict(zip(state.optimizer.names, grads))
    # logit_W gets a gradient on the AM head only, logit_fc on the CE head only
    assert (by_name["logit_W"].abs().max().item() > 0) == (loss == "am")
    assert (by_name["logit_fc/fc2/kernel"].abs().max().item() > 0) == (loss == "ce")


def test_trainer_step_matches_jax(case):
    spec, batch = case["spec"], case["batch"]
    trainer = Trainer(spec, _tc(TrainConfig), precision=Precision.f32(), device="cpu")
    state = trainer.init_state(params_from_jax(case["jtree"]))
    metrics = trainer.train_step(state, batch, seed=0)
    assert metrics["grad_norm"].item() == pytest.approx(case["grad_norm"], rel=1e-4)
    stepped = flatten_paths(params_from_jax(case["stepped"]))
    for name, p in flatten_paths(state.params).items():
        np.testing.assert_allclose(p.detach().numpy(), stepped[name].numpy(), atol=7 * LR, rtol=0, err_msg=name)
    assert state.step == 1

    # the tree scored and saved: visual_attention's qkv rebuilt from the trained query and kv ...
    tree = trainer.eval_params(state)
    va = tree["bert"]["encoder"]["x_layers"]["visual_attention"]
    for n in ("kernel", "bias"):
        assert torch.equal(va["qkv"][n], torch.cat([va["query"][n], va["kv"][n]], dim=-1))
    # ... which the JAX apply scores, once written back, as the port does (f32)
    jtree = params_to_jax(tree)
    bt = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = lxmert.score(tree, bt, spec.config, Precision.f32()).numpy()
    want = jax.jit(lambda p, b: jax_lxmert.apply(p, b, case["jspec"].config, JaxPrecision.f32())["score"])(
        jax.tree.map(jnp.asarray, jtree), {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)


def test_decay_mask_matches_jax(case):
    """Decayed exactly where JAX decays query/key/value, logit_W and the rest."""
    jmask = {k: bool(v) for k, v in flatten_paths(jax_optim.decay_mask(case["jtree"])).items()}
    spec = case["spec"]
    mask = decay_mask(spec.train_params(params_from_jax(case["jtree"])))
    assert mask[f"{VA}/query/kernel"] and mask[f"{VA}/kv/kernel"] and mask["logit_W"]
    assert not (mask[f"{VA}/query/bias"] or mask[f"{VA}/kv/bias"])
    for name, decayed in mask.items():
        if "/qkv/" in name or "/kv/" in name:
            parts = ("query", "key", "value") if "/qkv/" in name else ("key", "value")
            stem, leaf = name.rsplit("/", 2)[0], name.rsplit("/", 1)[1]
            assert all(jmask[f"{stem}/{p}/{leaf}"] == decayed for p in parts), name
        else:
            assert decayed == jmask[name], name


def test_params_to_jax_inverts_params_from_jax(case):
    jtree = {**case["jtree"], "cls": {"predictions": case["jtree"]["cls"]["predictions"]}}
    back = params_to_jax(params_from_jax(case["jtree"]))  # LXMERT's NSP head: not read, not trained, not written
    assert "logit_W" in back and flatten_paths(back).keys() == flatten_paths(jtree).keys()
    for name, value in flatten_paths(jtree).items():
        np.testing.assert_array_equal(flatten_paths(back)[name], value, err_msg=name)


def test_kernel_route_equals_plain_route_with_dropout():
    """At dropout 0.1 the kernel route (its kernels' plain versions on the CPU) and
    the plain oracle route train on the same masks: equal loss and gradients."""
    spec, _ = _specs(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    batch = _batch(spec.config, 14)
    out = []
    for blocks in (None, TRAIN_PLAIN_BLOCKS):
        kw = {} if blocks is None else {"blocks": blocks}
        trainer = Trainer(spec, recipe_for("lxmert"), precision=Precision.f32(), device="cpu", **kw)
        state = trainer.init_state(seed=3)
        out.append(trainer.grads(state, trainer.to_device(batch), seed=21))
    (g0, m0), (g1, m1) = out
    assert m0["loss"].item() == pytest.approx(m1["loss"].item(), abs=1e-6)
    for a, b in zip(g0, g1, strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4)
    # dropout moved the loss: the same step at dropout 0 differs
    spec0, _ = _specs()
    trainer = Trainer(spec0, recipe_for("lxmert"), precision=Precision.f32(), device="cpu")
    loss0 = trainer.grads(trainer.init_state(seed=3), trainer.to_device(batch), seed=21)[1]["loss"].item()
    assert abs(loss0 - m0["loss"].item()) > 1e-6
