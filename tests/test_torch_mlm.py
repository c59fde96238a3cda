"""The port's tied-embedding MLM head, its loss in training, the gradient
group norms and the optimizer override, against the JAX package.

* ``heads.mlm_logits`` / ``mlm_loss`` against the JAX ``models/heads.py``
  :166-194 in f32: within 1e-5.
* The MLM head is drawn last from a seed's stream: every other tensor of
  ImageBERT-A's and LXMERT's init is what it is without the head (bit for
  bit), and the tree has the JAX tree's leaves and shapes.
* One ``Trainer`` step of a tiny ImageBERT-A with ``mlm_loss_weight=1`` (the
  batch of ``tests/test_train.py:169-200``) and LXMERT's MLM term on its
  ``lang`` stream (``tests/test_train.py:203-252``) against the JAX loss and
  gradients (dropout off, f32 on both sides): the loss and the MLM loss
  within 1e-5, every gradient within 1e-4 abs + rel, ``cls/predictions`` and
  ``word_embeddings`` (both routes: the gather and the tied product)
  included; A's stepped parameters within 7 LR of JAX's optimizer (Adam
  without bias correction moves a parameter ~3.16 LR in its gradient's sign).
* ``grad_group_norms`` on the port's trained trees (fused ``qkv``, LXMERT's
  ``query``/``kv``, B's taps) against the JAX function on the JAX tree: the
  same keys, values within 1e-5 relative.
* ``optimizer="bert_adamw"`` on ImageBERT-B: one step against the JAX
  ``Trainer`` with the same override: the loss within 1e-5, the gradients
  within 1e-4, the moments within 1e-5, the step and the EMA shadows within
  0.1 LR, and each leaf's weight-decay term as JAX's (the test's docstring).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import Precision as JaxPrecision
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import heads as jax_heads
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import imagebert_a as jax_imagebert_a
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import imagebert_b as jax_imagebert_b
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import lxmert as jax_lxmert
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models.core import BertConfig as JaxBertConfig
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models.registry import ModelSpec as JaxModelSpec
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.parallel import make_mesh
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import TrainConfig as JaxTrainConfig
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import Trainer as JaxTrainer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import optim as jax_optim
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train.trainer import make_loss_fn as jax_make_loss_fn
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train.trainer import make_optimizer as jax_make_optimizer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import params_from_jax, params_to_jax
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model, heads
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train import Trainer, TrainConfig, grad_group_norms
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train.optim import flatten_paths
from test_torch_lxmert import jax_lxmert_params, lxmert_batch
from test_torch_lxmert_train import _specs as lxmert_specs
from torch_parity import imagebert_a_batch, imagebert_b_batch, jax_imagebert_a_params, jax_imagebert_b_params
from torch_parity import numpy_like

TINY = {"vocab_size": 211, "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
        "intermediate_size": 37, "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
B, P, LR = 8, 6, 1e-3


def _tc(cls, **kw):
    return cls(learning_rate=LR, num_warmup_steps=0, num_train_steps=1000, **kw)


def _masked(batch: dict, vocab_size: int, text_len: int, seed: int) -> dict:
    """``batch`` with P masked positions a pair inside the text, their ids and 0/1 weights."""
    r = np.random.default_rng(seed)
    return {**batch, "masked_lm_positions": r.integers(1, text_len - 1, (B, P)).astype(np.int32),
            "masked_lm_ids": r.integers(0, vocab_size, (B, P)).astype(np.int32),
            "masked_lm_weights": (r.random((B, P)) > 0.4).astype(np.float32)}


def test_mlm_head_matches_jax():
    cfg = JaxBertConfig(**TINY)
    p = numpy_like(jax.eval_shape(lambda: jax_heads.mlm_head_init(jax.random.key(0), cfg)), 3)
    r = np.random.default_rng(4)
    hidden = r.standard_normal((B, P, cfg.hidden_size)).astype(np.float32)
    table = (0.1 * r.standard_normal((cfg.vocab_size, cfg.hidden_size))).astype(np.float32)
    ids = r.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    weights = (r.random((B, P)) > 0.3).astype(np.float32)
    want = jax_heads.mlm_logits(jax.tree.map(jnp.asarray, p), hidden, table, JaxPrecision.f32())
    got = heads.mlm_logits(jax.tree.map(torch.from_numpy, p), torch.from_numpy(hidden), torch.from_numpy(table),
                           Precision.f32())
    assert got.shape == (B, P, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    want_loss = float(jax_heads.mlm_loss(want, ids, weights))
    got_loss = heads.mlm_loss(got, torch.from_numpy(ids), torch.from_numpy(weights)).item()
    assert got_loss == pytest.approx(want_loss, abs=1e-5)


@pytest.mark.parametrize("name", ["imagebert_a", "lxmert"])
def test_mlm_head_drawn_last(name, monkeypatch):
    """Every tensor but the head's is the one the seed drew before the head
    existed, and the tree has the JAX tree's leaves and shapes (LXMERT's NSP
    head ``cls/seq_relationship`` apart, which the port never holds)."""
    if name == "imagebert_a":
        spec = get_model(name, overrides=TINY)
        jcfg = JaxBertConfig(**dataclasses.asdict(spec.config))
        jshapes = jax.eval_shape(lambda: jax_imagebert_a.init_params(jax.random.key(0), jcfg))
    else:
        spec, jspec = lxmert_specs()
        jshapes = jax.eval_shape(lambda: jax_lxmert.init_params(jax.random.key(0), jspec.config))
        del jshapes["cls"]["seq_relationship"]
    full = flatten_paths(spec.init_params(5))
    assert {k for k in full if k.startswith("cls/predictions/")} == {
        "cls/predictions/transform/dense/kernel", "cls/predictions/transform/dense/bias",
        "cls/predictions/transform/LayerNorm/gamma", "cls/predictions/transform/LayerNorm/beta",
        "cls/predictions/output_bias"}
    want = {k: tuple(v.shape) for k, v in flatten_paths(jshapes).items()}
    assert {k: v.shape for k, v in flatten_paths(params_to_jax(spec.init_params(5))).items()} == want
    monkeypatch.setattr(heads, "mlm_head_init", lambda cfg, gen: {})
    without = flatten_paths(spec.init_params(5))
    assert without.keys() == {k for k in full if not k.startswith("cls/predictions/")}
    for k, v in without.items():
        assert torch.equal(v, full[k]), k


@pytest.fixture(scope="module")
def a_case():
    """The JAX loss, MLM loss and gradients of a tiny ImageBERT-A with the MLM
    loss on, and its optimizer's step, on one tree and batch."""
    spec = get_model("imagebert_a", overrides=TINY)
    jcfg = JaxBertConfig(**dataclasses.asdict(spec.config))
    jspec = JaxModelSpec("imagebert_a", jcfg, init=lambda rng: jax_imagebert_a.init_params(rng, jcfg),
                         apply=jax_imagebert_a.apply, featurizer_layout="imagebert_a")
    jtree = jax_imagebert_a_params(jcfg, 11)
    batch = imagebert_a_batch(B, jcfg.vocab_size, 12)
    batch["labels"] = np.random.default_rng(13).integers(0, 2, B).astype(np.int32)
    batch["boxes"] = np.zeros((B, 10, 5), np.float32)
    batch = _masked(batch, jcfg.vocab_size, 20, 14)
    jtc = _tc(JaxTrainConfig, mlm_loss_weight=1.0)
    loss_fn = jax_make_loss_fn(jspec, jtc, JaxPrecision.f32())
    params = jax.tree.map(jnp.asarray, jtree)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, batch, None)
    # the JAX Trainer's apply phase: global-norm clip, then BERT-Adam
    clipped, norm = jax_optim.clip_by_global_norm(grads, 1.0)
    tx = jax_make_optimizer(jtc)
    updates, _ = tx.update(clipped, tx.init(params), params)
    return {"spec": spec, "jtree": jtree, "batch": batch, "loss": float(loss), "mlm": float(metrics["mlm_loss"]),
            "grads": jax.tree.map(np.asarray, grads), "grad_norm": float(norm),
            "stepped": jax.tree.map(np.asarray, optax.apply_updates(params, updates))}


def test_imagebert_a_mlm_step_matches_jax(a_case):
    c = a_case
    trainer = Trainer(c["spec"], _tc(TrainConfig, mlm_loss_weight=1.0), precision=Precision.f32(), device="cpu")
    dev_batch = trainer.to_device(c["batch"])
    assert {"masked_lm_positions", "masked_lm_ids", "masked_lm_weights"} <= dev_batch.keys()
    state = trainer.init_state(params_from_jax(c["jtree"]))
    grads, metrics = trainer.grads(state, dev_batch, seed=0)
    assert metrics["loss"].item() == pytest.approx(c["loss"], abs=1e-5)
    assert metrics["mlm_loss"].item() == pytest.approx(c["mlm"], abs=1e-5)
    want = flatten_paths(params_from_jax(c["grads"]))
    by_name = dict(zip(state.optimizer.names, grads, strict=True))
    for name, g in by_name.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-4, err_msg=name)
    assert all(by_name[f"cls/predictions/{k}"].abs().max() > 0 for k in ("output_bias", "transform/dense/kernel"))
    # the tied product reaches every row of the table, the gather only the rows of the ids fed
    fed = np.unique(np.concatenate([c["batch"]["input_ids"].ravel(), c["batch"]["label_ids"].ravel()]))
    unfed = np.setdiff1d(np.arange(c["spec"].config.vocab_size), fed)
    assert len(unfed) > 0 and (by_name["bert/embeddings/word_embeddings"][unfed].abs().sum(dim=1) > 0).all()
    applied = trainer.apply(state, grads)
    assert applied["grad_norm"].item() == pytest.approx(c["grad_norm"], rel=1e-4)
    stepped = flatten_paths(params_from_jax(c["stepped"]))
    for name, p in flatten_paths(state.params).items():
        np.testing.assert_allclose(p.detach().numpy(), stepped[name].numpy(), atol=7 * LR, rtol=0, err_msg=name)
    # off, the masked-LM entries stay on the host and the loss has no MLM term
    off = Trainer(c["spec"], _tc(TrainConfig), precision=Precision.f32(), device="cpu")
    assert "masked_lm_ids" not in off.to_device(c["batch"])
    assert "mlm_loss" not in off.grads(off.init_state(params_from_jax(c["jtree"])), off.to_device(c["batch"]), 0)[1]


def test_lxmert_mlm_term_matches_jax():
    spec, jspec = lxmert_specs()
    jtree = jax_lxmert_params(jspec.config, 21)
    batch = lxmert_batch(B, jspec.config, 22)
    batch["labels"] = np.random.default_rng(23).integers(0, 2, B).astype(np.int32)
    batch = _masked(batch, jspec.config.bert.vocab_size, 23, 24)
    loss_fn = jax_make_loss_fn(jspec, _tc(JaxTrainConfig, mlm_loss_weight=1.0), JaxPrecision.f32())
    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, jtree), {k: jnp.asarray(v) for k, v in batch.items()}, None)
    trainer = Trainer(spec, _tc(TrainConfig, mlm_loss_weight=1.0), precision=Precision.f32(), device="cpu")
    state = trainer.init_state(params_from_jax(jtree))
    got, got_metrics = trainer.grads(state, trainer.to_device(batch), seed=0)
    assert got_metrics["loss"].item() == pytest.approx(float(loss), abs=1e-5)
    assert got_metrics["mlm_loss"].item() == pytest.approx(float(metrics["mlm_loss"]), abs=1e-5)
    want = flatten_paths(params_from_jax(jax.tree.map(np.asarray, grads)))
    by_name = dict(zip(state.optimizer.names, got, strict=True))
    assert "cls/predictions/output_bias" in by_name and "bert/embeddings/word_embeddings" in by_name
    for name, g in by_name.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-4, err_msg=name)
    assert by_name["cls/predictions/output_bias"].abs().max() > 0


@pytest.mark.parametrize("name", ["imagebert_a", "imagebert_b", "lxmert"])
def test_grad_group_norms_match_jax(name):
    if name == "lxmert":
        spec, jspec = lxmert_specs()
        jgrads = jax_lxmert_params(jspec.config, 31)
        del jgrads["cls"]["seq_relationship"]  # LXMERT's NSP head: the port holds no such leaf
    else:
        spec = get_model(name, overrides=TINY)
        jcfg = JaxBertConfig(**dataclasses.asdict(spec.config))
        jgrads = (jax_imagebert_a_params if name == "imagebert_a" else jax_imagebert_b_params)(jcfg, 31)
    want = {k: float(v) for k, v in jax_optim.grad_group_norms(jax.tree.map(jnp.asarray, jgrads)).items()}
    named = flatten_paths(spec.train_params(spec.from_jax(params_from_jax(jgrads))))
    got = grad_group_norms(list(named), list(named.values()))
    assert got.keys() == want.keys()
    for group, value in want.items():
        assert got[group].item() == pytest.approx(value, rel=1e-5), group


def _decay_part(stepped: np.ndarray, init: np.ndarray, m: np.ndarray, v: np.ndarray) -> np.ndarray:
    """What a BERT-Adam step moved a leaf by besides m / (sqrt(v) + eps), in
    units of the LR: wd * p where the leaf is decayed, 0 where it is not (f64)."""
    moved = (stepped.astype(np.float64) - init) / -LR
    return moved - m / (np.sqrt(v.astype(np.float64)) + 1e-6)


def test_bert_adamw_on_b_matches_jax():
    """``--optimizer bert_adamw`` on ImageBERT-B: B's recipe (per-value clip,
    EMA) with BERT-Adam in place of the staircase Adam, one step against the
    JAX Trainer with the same override. The loss within 1e-5 and every
    gradient within 1e-4 abs + rel; the moments after the step within a
    tenth of that (m = 0.1 g, sqrt(v) = 0.032 |g|); the step itself (~3.16 LR
    a leaf: no bias correction) and the EMA shadows (0.9 of it) within 0.1 LR,
    where the staircase Adam's step (~1 LR) or no step at all lies over 2 LR
    away; the decay term (wd * p, ~2e-4 LR) of each leaf as JAX's within the
    f32 spacing of the params, so the decay mask on B's taps is JAX's."""
    spec = get_model("imagebert_b", overrides=TINY)
    jcfg = JaxBertConfig(**dataclasses.asdict(spec.config))
    jspec = JaxModelSpec("imagebert_b", jcfg, init=lambda rng: jax_imagebert_b.init_params(rng, jcfg),
                         apply=jax_imagebert_b.apply, featurizer_layout="imagebert_b")
    jtree = jax_imagebert_b_params(jcfg, 41)
    batch = imagebert_b_batch(B, jcfg.vocab_size, 42)
    batch["labels"] = np.random.default_rng(43).integers(0, 2, B).astype(np.int32)
    kw = dict(optimizer="bert_adamw", clip="value", ema_decay=0.997)
    trainer = JaxTrainer(jspec, _tc(JaxTrainConfig, **kw), mesh=make_mesh(), precision=JaxPrecision.f32())
    state = trainer.init_state(jax.random.key(0))
    params, shadow = (jax.device_put(jax.tree.map(jnp.asarray, jtree), trainer._replicated) for _ in range(2))
    state = state._replace(params=params, opt_state=trainer.tx.init(params), ema=state.ema._replace(shadow=shadow))
    (loss, _), jgrads = jax.jit(jax.value_and_grad(trainer._loss_fn, has_aux=True))(params, batch, None)
    state, _ = trainer.train_step(state, batch, None)
    (moments, count) = state.opt_state

    def port_layout(tree):
        return flatten_paths(params_from_jax(jax.tree.map(np.asarray, tree)))

    port = Trainer(spec, _tc(TrainConfig, **kw), precision=Precision.f32(), device="cpu")
    pstate = port.init_state(spec.from_jax(params_from_jax(jtree)))
    assert type(pstate.optimizer).__name__ == "BertAdamW"
    names = pstate.optimizer.names
    init = {n: p.detach().numpy().copy() for n, p in zip(names, pstate.leaves(), strict=True)}
    grads, metrics = port.grads(pstate, port.to_device(batch), seed=0)
    assert metrics["loss"].item() == pytest.approx(float(loss), abs=1e-5)
    want = port_layout(jgrads)
    for name, g in zip(names, grads, strict=True):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-4, err_msg=name)
    port.apply(pstate, grads)
    assert pstate.optimizer.step == int(count) == 1
    want_m, want_v, stepped = port_layout(moments.m), port_layout(moments.v), port_layout(state.params)
    decayed = 0
    for name, p, m, v in zip(names, pstate.leaves(), pstate.optimizer.m, pstate.optimizer.v, strict=True):
        p, m, v = p.detach().numpy(), m.numpy(), v.numpy()
        jp, jm, jv = stepped[name].numpy(), want_m[name].numpy(), want_v[name].numpy()
        np.testing.assert_allclose(m, jm, atol=1e-5, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(np.sqrt(v), np.sqrt(jv), atol=3e-6, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(p - init[name], jp - init[name], atol=0.1 * LR, rtol=0, err_msg=name)
        want_decay = _decay_part(jp, init[name], jm, jv)
        spacing = np.spacing(np.maximum(np.abs(p), np.abs(jp))).astype(np.float64) / LR
        assert (np.abs(_decay_part(p, init[name], m, v) - want_decay) <= 8 * spacing + 1e-6).all(), name
        decayed += bool(np.abs(want_decay).max() > 1e-5)
    assert 0 < decayed < len(names)  # both kinds of leaf are exercised
    ema = flatten_paths(params_to_jax(port.eval_params(pstate)))
    for name, value in flatten_paths(jax.tree.map(np.asarray, state.ema.shadow)).items():
        np.testing.assert_allclose(ema[name], value, atol=0.1 * LR, rtol=0, err_msg=name)
