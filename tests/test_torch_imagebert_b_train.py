"""The port's ImageBERT-B/C training against the JAX package's.

A tiny ImageBERT-B (2 layers, H=32, 4 heads, I=37, the config of
``tests/torch_parity.py``, dropout 0) on numpy params and batches from
seeds: one ``Trainer`` step of the port on the CPU (its train blocks' plain
versions, the label conv as its 8 taps) against the JAX ``Trainer`` on the
8-device CPU mesh (B=8) with its train kernels in interpret mode
(``train_fused("interpret")``), both in f32, for B and for C on a featurized
batch that holds the sen2forest trigger; the word-match loss and its head's
gradients; bias-corrected Adam on the staircase against ``optax.adam``; the
AM and word-match losses; the band <-> taps round trip; the checkpoint round
trip; the kernel route against the plain route at dropout 0.1.

Budgets, as ``tests/test_torch_train.py``: the loss within 1e-5 and every
gradient within 1e-4 abs + rel (f32 on both sides, summation order only);
the parameters after the step, and the EMA shadows (which move 0.9 of the
step at the first update), within 7 LR: Adam with bias correction moves a
parameter by ~LR in its gradient's sign at step 1, so a near-zero gradient
whose sign differs between the two sides moves it ~2 LR apart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu import data as jax_data
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import Precision as JaxPrecision
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import heads as jax_heads
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import imagebert_b as jax_imagebert_b
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models.core import BertConfig as JaxBertConfig
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models.registry import ModelSpec as JaxModelSpec
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ops.pallas_train import train_fused
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.parallel import make_mesh
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.tokenization import FullTokenizer as JaxTokenizer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import TrainConfig as JaxTrainConfig
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import Trainer as JaxTrainer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import optim as jax_optim
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train.trainer import make_loss_fn as jax_make_loss_fn
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch import VOCAB_PATH, data
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import params_from_jax, params_to_jax
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import synthetic
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.tsv import SEN2FOREST_SRC
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model, heads, imagebert_b
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models.core import TRAIN_PLAIN_BLOCKS
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.band_conv import (
    band_conv_train,
    band_conv_train_plain,
    band_taps,
    conv_band,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.tokenization import FullTokenizer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train import Adam, Trainer, TrainConfig, recipe_for
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train import exponential_staircase_schedule
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train.optim import flatten_paths
from torch_parity import TINY, imagebert_b_batch, jax_imagebert_b_params, numpy_like

NO_DROPOUT = {**TINY, "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
B, LR, WM = 8, 1e-3, 0.5


def _specs(name: str):
    """(the port's tiny spec, the JAX spec of the same config)."""
    spec = get_model(name, overrides=NO_DROPOUT)
    jcfg = JaxBertConfig(**dataclasses.asdict(spec.config))
    jspec = JaxModelSpec(name, jcfg, init=lambda rng: jax_imagebert_b.init_params(rng, jcfg),
                         apply=jax_imagebert_b.apply, featurizer_layout="imagebert_b")
    return spec, jspec


def _tc(cls, **kw):
    return dataclasses.replace(cls(), learning_rate=LR, optimizer="adam_staircase", clip="value", ema_decay=0.997,
                               **kw)


def _word_match_tree(jcfg, seed: int) -> dict:
    shapes = jax.eval_shape(lambda: jax_heads.word_match_head_init(jax.random.key(0), jcfg))
    return numpy_like(shapes, seed)


def _c_batch(tmp_path_factory, vocab_size: int) -> dict:
    """One featurized C batch (the sen2forest rewrite on its trigger rows), the
    JAX featurizer's equal to the port's, with labels from a seed."""
    header, *rows = synthetic.make_tsv(40, seed=11)
    lines = [header, *sorted(rows, key=lambda line: SEN2FOREST_SRC not in line)]  # trigger rows first
    tsv = tmp_path_factory.mktemp("c") / "pairs.tsv"
    tsv.write_text("\n".join(lines) + "\n")
    labels = tsv.parent / "labels.txt"
    labels.write_text("".join(f"{k}\t{v}\n" for k, v in synthetic.SYNTHETIC_LABELS.items()))
    port_fz = data.Featurizer(FullTokenizer.google_style(VOCAB_PATH), data.load_multimodal_labels(labels),
                              sen2forest=True)
    ref_fz = jax_data.Featurizer(JaxTokenizer.google_style(VOCAB_PATH), jax_data.load_multimodal_labels(labels),
                                 sen2forest=True)
    got = next(iter(data.batches_from_files([tsv], port_fz.imagebert_b, B)))
    want = next(iter(jax_data.batches_from_files([tsv], ref_fz.imagebert_b, B)))
    assert 0 < sum(SEN2FOREST_SRC in line for line in lines[1:B + 1]) < B
    batch = {}
    for k in imagebert_b.INPUT_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        batch[k] = got[k]
    assert batch["input_ids"].max() < vocab_size
    batch["labels"] = np.random.default_rng(17).integers(0, 2, B).astype(np.int32)
    return batch


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX Trainer's loss, gradients, stepped params and EMA shadows after
    one step, for B on a seeded batch and for C on a featurized one; and the
    JAX loss and gradients with the word-match loss on."""
    out = {}
    for name in ("imagebert_b", "imagebert_c"):
        spec, jspec = _specs(name)
        jtree = jax_imagebert_b_params(jspec.config, 11)
        if name == "imagebert_b":
            batch = imagebert_b_batch(B, jspec.config.vocab_size, 12)
            batch["labels"] = np.random.default_rng(13).integers(0, 2, B).astype(np.int32)
        else:
            batch = _c_batch(tmp_path_factory, jspec.config.vocab_size)
        with train_fused("interpret"):
            trainer = JaxTrainer(jspec, _tc(JaxTrainConfig), mesh=make_mesh(), precision=JaxPrecision.f32())
            state = trainer.init_state(jax.random.key(0))
            params, shadow = (jax.device_put(jax.tree.map(jnp.asarray, jtree), trainer._replicated) for _ in range(2))
            state = state._replace(params=params, opt_state=trainer.tx.init(params),
                                   ema=state.ema._replace(shadow=shadow))
            rng = jax.random.key(1)
            (loss, _), grads = jax.jit(jax.value_and_grad(trainer._loss_fn, has_aux=True))(params, batch, rng)
            state, _ = trainer.train_step(state, batch, rng)
        out[name] = {"spec": spec, "jtree": jtree, "batch": batch, "loss": float(loss),
                     "grads": jax.tree.map(np.asarray, grads), "stepped": jax.tree.map(np.asarray, state.params),
                     "ema": jax.tree.map(np.asarray, state.ema.shadow)}
    # the word-match loss on B's tree and batch, with its head and targets
    spec, jspec = _specs("imagebert_b")
    jtree = {**out["imagebert_b"]["jtree"], "kdd_query_match": _word_match_tree(jspec.config, 14)}
    batch = dict(out["imagebert_b"]["batch"])
    r = np.random.default_rng(15)
    batch["word_match_labels"] = r.integers(0, 2, (B, heads.WORD_MATCH_POSITIONS)).astype(np.int32)
    batch["word_match_weights"] = (r.random((B, heads.WORD_MATCH_POSITIONS)) > 0.4).astype(np.float32)
    with train_fused("interpret"):
        loss_fn = jax_make_loss_fn(jspec, _tc(JaxTrainConfig, word_match_loss_weight=WM), JaxPrecision.f32())
        (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jax.tree.map(jnp.asarray, jtree), {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(1))
    out["word_match"] = {"jtree": jtree, "batch": batch, "loss": float(loss),
                         "wm_loss": float(metrics["word_match_loss"]), "grads": jax.tree.map(np.asarray, grads)}
    return out


@pytest.mark.parametrize("name", ["imagebert_b", "imagebert_c"])
def test_trainer_step_matches_jax(case, name):
    c = case[name]
    trainer = Trainer(c["spec"], _tc(TrainConfig), precision=Precision.f32(), device="cpu")
    state = trainer.init_state(c["spec"].from_jax(params_from_jax(c["jtree"])))
    assert "kdd_conv1/weights" in state.optimizer.names and "kdd_conv1/kernel" not in state.optimizer.names
    grads, metrics = trainer.grads(state, trainer.to_device(c["batch"]), seed=0)
    assert metrics["loss"].item() == pytest.approx(c["loss"], abs=1e-5)
    want = flatten_paths(params_from_jax(c["grads"]))  # JAX's q/k/v gradients as qkv; the taps as they are
    for pname, g in zip(state.optimizer.names, grads, strict=True):
        np.testing.assert_allclose(g.numpy(), want[pname].numpy(), atol=1e-4, rtol=1e-4, err_msg=pname)
    trainer.apply(state, grads)
    assert state.step == 1
    stepped = flatten_paths(params_from_jax(c["stepped"]))
    for pname, p in flatten_paths(state.params).items():
        np.testing.assert_allclose(p.detach().numpy(), stepped[pname].numpy(), atol=7 * LR, rtol=0, err_msg=pname)
    # the EMA shadows, banded by eval_params and written back as taps
    ema = flatten_paths(params_to_jax(trainer.eval_params(state)))
    for pname, value in flatten_paths(c["ema"]).items():
        np.testing.assert_allclose(ema[pname], value, atol=7 * LR, rtol=0, err_msg=pname)


def test_word_match_loss_and_gradients_match_jax(case):
    c = case["word_match"]
    spec = case["imagebert_b"]["spec"]
    trainer = Trainer(spec, _tc(TrainConfig, word_match_loss_weight=WM), precision=Precision.f32(), device="cpu")
    dev_batch = trainer.to_device(c["batch"])
    assert {"word_match_labels", "word_match_weights"} <= dev_batch.keys()  # the loss reads them
    state = trainer.init_state(spec.from_jax(params_from_jax(c["jtree"])))
    grads, metrics = trainer.grads(state, dev_batch, seed=0)
    assert metrics["loss"].item() == pytest.approx(c["loss"], abs=1e-5)
    assert metrics["word_match_loss"].item() == pytest.approx(c["wm_loss"], abs=1e-5)
    want = flatten_paths(params_from_jax(c["grads"]))
    by_name = dict(zip(state.optimizer.names, grads, strict=True))
    for pname, g in by_name.items():
        np.testing.assert_allclose(g.numpy(), want[pname].numpy(), atol=1e-4, rtol=1e-4, err_msg=pname)
    assert by_name["kdd_query_match/output_weights"].abs().max().item() > 0
    # off, the batch's targets stay on the host and the head gets no gradient
    off = Trainer(spec, _tc(TrainConfig), precision=Precision.f32(), device="cpu")
    assert "word_match_labels" not in off.to_device(c["batch"])


def test_init_state_adds_the_word_match_head_only_when_on():
    spec = get_model("imagebert_b", overrides=NO_DROPOUT)
    on = Trainer(spec, _tc(TrainConfig, word_match_loss_weight=WM), device="cpu").init_state(seed=2)
    off = Trainer(spec, _tc(TrainConfig), device="cpu").init_state(seed=2)
    assert "kdd_query_match" in on.params and "kdd_query_match" not in off.params
    head = on.params["kdd_query_match"]
    assert head["output_weights"].shape == (heads.WORD_MATCH_POSITIONS, 2, spec.config.hidden_size)
    again = Trainer(spec, _tc(TrainConfig, word_match_loss_weight=WM), device="cpu").init_state(seed=2)
    assert torch.equal(again.params["kdd_query_match"]["kdd"]["kernel"], head["kdd"]["kernel"])


@pytest.mark.parametrize("step", [0, 1, 2499, 2500, 5000])
def test_adam_staircase_matches_optax(step):
    """From the same moments at update count ``step``, two updates of the port's
    Adam on the staircase and of ``optax.adam`` on the JAX schedule."""
    r = np.random.default_rng(step)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    params = {"w": f(4, 3), "b": f(3)}
    mu, nu = {"w": f(4, 3), "b": f(3)}, {"w": np.abs(f(4, 3)), "b": np.abs(f(3))}
    tx = optax.adam(jax_optim.exponential_staircase_schedule(0.1))
    adam_state, sched_state = tx.init(jax.tree.map(jnp.asarray, params))
    count = jnp.asarray(step, jnp.int32)
    state = (adam_state._replace(count=count, mu=jax.tree.map(jnp.asarray, mu), nu=jax.tree.map(jnp.asarray, nu)),
             sched_state._replace(count=count))
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = Adam(tp, exponential_staircase_schedule(0.1))
    opt.m, opt.v, opt.step = [torch.from_numpy(mu[k].copy()) for k in opt.names], \
        [torch.from_numpy(nu[k].copy()) for k in opt.names], step
    lrs = []
    for _ in range(2):
        grads = {"w": f(4, 3), "b": f(3)}
        upd, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, upd)
        lrs.append(opt.update(list(tp.values()), [torch.from_numpy(grads[k]) for k in opt.names]))
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert opt.step == step + 2
    assert lrs[0] == pytest.approx(float(jax_optim.exponential_staircase_schedule(0.1)(step)), rel=1e-6)


@pytest.mark.parametrize("label", [0, 1])
def test_am_loss_matches_jax(label):
    """Pooled outputs spread so that some rows pass the 0.35 margin and some do not."""
    r = np.random.default_rng(20 + label)
    p = {"am_kernel": r.standard_normal((16, 2)).astype(np.float32)}
    pooled = r.standard_normal((8, 16)).astype(np.float32)
    pooled[:4] += 2.0 * p["am_kernel"][:, label]  # these rows' cosines on the label's class pass the margin
    labels = np.full(8, label, np.int32)
    labels[::3] = 1 - label
    want = float(jax_heads.am_loss(jax.tree.map(jnp.asarray, p), jnp.asarray(pooled), jnp.asarray(labels)))
    got = heads.am_loss({"am_kernel": torch.from_numpy(p["am_kernel"])}, torch.from_numpy(pooled),
                        torch.from_numpy(labels)).item()
    assert got == pytest.approx(want, rel=1e-6)


def test_word_match_loss_head_matches_jax():
    cfg = JaxBertConfig(**{**NO_DROPOUT, "vocab_size": 97})
    tree = _word_match_tree(cfg, 3)
    r = np.random.default_rng(4)
    seq = r.standard_normal((5, 30, cfg.hidden_size)).astype(np.float32)
    labels = r.integers(0, 2, (5, 18)).astype(np.int32)
    weights = (r.random((5, 18)) > 0.5).astype(np.float32)
    want = float(jax_heads.word_match_loss(jax.tree.map(jnp.asarray, tree), jnp.asarray(seq), jnp.asarray(labels),
                                           jnp.asarray(weights), JaxPrecision.f32()))
    head = jax.tree.map(torch.from_numpy, tree)
    got = heads.word_match_loss(head, torch.from_numpy(seq), torch.from_numpy(labels), torch.from_numpy(weights),
                                Precision.f32()).item()
    assert got == pytest.approx(want, rel=1e-5)


def test_band_and_taps_round_trip_bit_for_bit():
    gen = torch.Generator().manual_seed(0)
    taps, bias = torch.randn(8, 16, 24, generator=gen), torch.randn(24, generator=gen)
    conv = imagebert_b.label_conv_band(taps, bias)
    assert conv["kernel"].shape == (8 * 16, 8 * 24)
    back = imagebert_b.label_conv_taps(conv)
    assert torch.equal(back["weights"], taps) and torch.equal(back["biases"], bias)
    band = conv["kernel"].reshape(8, 16, 8, 24)
    for t in range(8):  # block (t, w) is tap t - w + 3, or zero outside the kernel
        for w in range(8):
            k = t - w + 3
            want = taps[k] if 0 <= k < 8 else torch.zeros(16, 24)
            assert torch.equal(band[t, :, w, :], want), (t, w)
    assert torch.equal(band_taps(conv_band(taps, 3), 8, 3), taps)
    # a model's tree: train_params then eval_params gives back the band it started from
    spec = get_model("imagebert_b", overrides=NO_DROPOUT)
    params = spec.init_params(4)
    again = spec.eval_params(spec.train_params(params))
    assert torch.equal(again["kdd_conv1"]["kernel"], params["kdd_conv1"]["kernel"])
    assert torch.equal(again["kdd_conv1"]["bias"], params["kdd_conv1"]["bias"])


def test_band_conv_function_matches_its_plain_version():
    """The Function's forward and its folded tap gradients against autograd
    through the plain band, f32 on the CPU."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(12, 8 * 16, generator=gen)
    taps, bias = torch.randn(8, 16, 16, generator=gen), torch.randn(16, generator=gen)
    dy = torch.randn(12, 8 * 16, generator=gen)
    outs = []
    for fn in (band_conv_train, band_conv_train_plain):
        leaves = [t.clone().requires_grad_() for t in (x, taps, bias)]
        y = fn(*leaves, 3)
        outs.append((y.detach(), *torch.autograd.grad(y, leaves, dy)))
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_params_to_jax_inverts_params_from_jax_on_b():
    spec, jspec = _specs("imagebert_b")
    jtree = {**jax_imagebert_b_params(jspec.config, 1), "kdd_query_match": _word_match_tree(jspec.config, 2)}
    for params in (params_from_jax(jtree), spec.from_jax(params_from_jax(jtree))):  # taps, and banded
        back = params_to_jax(params)
        assert flatten_paths(back).keys() == flatten_paths(jtree).keys()
        for name, value in flatten_paths(jtree).items():
            np.testing.assert_array_equal(flatten_paths(back)[name], value, err_msg=name)


def test_trainer_kernel_route_equals_plain_route_with_dropout():
    """At dropout 0.1 the kernel route (plain versions of its kernels on the CPU,
    the label conv's Function) and the plain oracle route train on the same
    masks: equal loss and gradients."""
    spec = get_model("imagebert_b", overrides={**TINY, "hidden_dropout_prob": 0.1,
                                               "attention_probs_dropout_prob": 0.1})
    batch = imagebert_b_batch(4, spec.config.vocab_size, 14)
    batch["labels"] = np.array([0, 1, 1, 0], np.int32)
    out = []
    for blocks in (None, TRAIN_PLAIN_BLOCKS):
        kw = {} if blocks is None else {"blocks": blocks}
        trainer = Trainer(spec, recipe_for("imagebert_b"), precision=Precision.f32(), device="cpu", **kw)
        state = trainer.init_state(seed=3)
        out.append(trainer.grads(state, trainer.to_device(batch), seed=21))
    (g0, m0), (g1, m1) = out
    assert m0["loss"].item() == pytest.approx(m1["loss"].item(), abs=1e-6)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4)
