"""One distillation ``Trainer`` step of the port against the JAX package's.

Tiny ImageBERT-A, ImageBERT-B and LXMERT (H=32, 4 heads, dropout 0; A and B
2 layers, LXMERT 1/1/1) on numpy params and batches from seeds, with a
teacher's probabilities and weights in the batch (one row at weight 0): the
port's ``Trainer`` on the CPU (its train blocks' plain versions) against the
JAX ``Trainer`` on a one-device CPU mesh with its train kernels in interpret
mode (``train_fused("interpret")``), both in f32, pure-soft
(``hard_loss_weight`` 0: no family loss) and hard + soft (0.5 / 1.0), at
temperature 2. The loss and ``distill_loss`` within 1e-5 and every gradient
within 1e-4 abs + rel, as the earlier slices hold their steps; the params
after the step within 7 LR (``tests/test_torch_train.py``'s budget).

The JAX step runs on one device, not on the suite's 8-device mesh: XLA's CPU
runtime runs every device's collectives on one thread pool of a thread a
core, and LXMERT's step lets a device enter two collectives at once (an
all-gather beside an all-reduce). With 8 devices on 8 cores that can leave a
device no thread to reach the rendezvous the others wait in, and XLA aborts
the process after its 40 s termination timeout (a worker crash under
``-n 6``). One device has no cross-device rendezvous; the step computes the
same loss and gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import BertConfig as JaxBertConfig
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import LxmertConfig as JaxLxmertConfig
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import Precision as JaxPrecision
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import imagebert_a as jax_imagebert_a
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import imagebert_b as jax_imagebert_b
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import lxmert as jax_lxmert
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models.registry import ModelSpec as JaxModelSpec
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ops.pallas_train import train_fused
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.parallel import make_mesh
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import TrainConfig as JaxTrainConfig
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import Trainer as JaxTrainer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import params_from_jax
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train import Trainer, TrainConfig, make_loss_fn
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train.optim import flatten_paths
from torch_parity import TINY, imagebert_a_batch, imagebert_b_batch, numpy_like
from test_torch_lxmert import lxmert_batch

B, LR, T = 8, 1e-3, 2.0
BERT = {**TINY, "vocab_size": 101, "max_position_embeddings": 64, "hidden_dropout_prob": 0.0,
        "attention_probs_dropout_prob": 0.0}
LX_DEPTHS = {"l_layers": 1, "x_layers": 1, "r_layers": 1}
MODES = {"pure_soft": {"distill_weight": 1.0, "hard_loss_weight": 0.0},
         "hard_and_soft": {"distill_weight": 1.0, "hard_loss_weight": 0.5}}


def _specs(name: str):
    """(the port's tiny spec, the JAX spec of the same config)."""
    if name == "lxmert":
        spec = get_model("lxmert", overrides={**BERT, **LX_DEPTHS})
        jcfg = JaxLxmertConfig(bert=JaxBertConfig(**dataclasses.asdict(spec.config.bert)), **LX_DEPTHS,
                               visual_feat_dim=spec.config.visual_feat_dim)
        return spec, JaxModelSpec("lxmert", jcfg, init=lambda rng: jax_lxmert.init_params(rng, jcfg),
                                  apply=jax_lxmert.apply, featurizer_layout="lxmert")
    spec = get_model(name, overrides=BERT)
    jcfg = JaxBertConfig(**dataclasses.asdict(spec.config))
    module = jax_imagebert_a if name == "imagebert_a" else jax_imagebert_b
    return spec, JaxModelSpec(name, jcfg, init=lambda rng: module.init_params(rng, jcfg), apply=module.apply,
                              featurizer_layout=name)


def _tc(cls, name: str, mode: str):
    recipe = {"optimizer": "adam_staircase", "clip": "value", "ema_decay": 0.997} if name == "imagebert_b" else {}
    return cls(learning_rate=LR, num_warmup_steps=0, num_train_steps=1000, distill_temperature=T, **recipe,
               **MODES[mode])


def _case(name: str, seed: int) -> tuple[dict, dict]:
    """(a JAX-layout tree, a batch with hard labels and a teacher's probabilities and weights)."""
    spec, jspec = _specs(name)
    tree = numpy_like(jax.eval_shape(lambda: jspec.init_params(jax.random.key(0))), seed)
    rng = np.random.default_rng(seed + 1)
    if name == "imagebert_a":
        batch = imagebert_a_batch(B, BERT["vocab_size"], seed + 2)
        batch["boxes"] = np.zeros((B, 10, 5), np.float32)
    elif name == "imagebert_b":
        batch = imagebert_b_batch(B, BERT["vocab_size"], seed + 2)
        tree["cls"]["seq_relationship"]["am_kernel"] = rng.standard_normal((BERT["hidden_size"], 2)).astype(np.float32)
    else:
        batch = lxmert_batch(B, jspec.config, seed + 2)
    batch["labels"] = rng.integers(0, 2, B).astype(np.int32)
    batch["teacher_prob"] = rng.random(B).astype(np.float32)
    batch["teacher_weight"] = np.ones(B, np.float32)
    batch["teacher_weight"][-1] = 0.0  # a padded tail row
    return tree, batch


@pytest.fixture(scope="module")
def jax_results():
    """The JAX Trainer's loss, metrics, gradients and stepped params, per (model, mode), computed once."""
    cache = {}

    def get(name: str, mode: str) -> dict:
        if (name, mode) not in cache:
            _, jspec = _specs(name)
            tree, batch = _case(name, 20)
            with train_fused("interpret"):
                trainer = JaxTrainer(jspec, _tc(JaxTrainConfig, name, mode),
                                     mesh=make_mesh(devices=jax.devices()[:1]), precision=JaxPrecision.f32())
                state = trainer.init_state(jax.random.key(0))
                params, shadow = (jax.device_put(jax.tree.map(jnp.asarray, tree), trainer._replicated)
                                  for _ in range(2))  # two buffers: the step donates both
                state = state._replace(params=params, opt_state=trainer.tx.init(params))
                if state.ema is not None:
                    state = state._replace(ema=state.ema._replace(shadow=shadow))
                rng = jax.random.key(1)
                (loss, metrics), grads = jax.jit(jax.value_and_grad(trainer._loss_fn, has_aux=True))(
                    params, batch, rng)
                state, _ = trainer.train_step(state, batch, rng)
            cache[(name, mode)] = {"tree": tree, "batch": batch, "loss": float(loss),
                                   "distill_loss": float(metrics["distill_loss"]),
                                   "grads": jax.tree.map(np.asarray, grads),
                                   "stepped": jax.tree.map(np.asarray, state.params)}
        return cache[(name, mode)]

    return get


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["imagebert_a", "imagebert_b", "lxmert"])
def test_distill_trainer_step_matches_jax(jax_results, name, mode):
    want = jax_results(name, mode)
    spec, _ = _specs(name)
    trainer = Trainer(spec, _tc(TrainConfig, name, mode), precision=Precision.f32(), device="cpu")
    state = trainer.init_state(spec.from_jax(params_from_jax(want["tree"])))
    dev_batch = trainer.to_device(want["batch"])
    assert {"teacher_prob", "teacher_weight"} <= dev_batch.keys()
    grads, metrics = trainer.grads(state, dev_batch, seed=0)
    assert metrics["loss"].item() == pytest.approx(want["loss"], abs=1e-5)
    assert metrics["distill_loss"].item() == pytest.approx(want["distill_loss"], abs=1e-5)
    if mode == "pure_soft":
        assert metrics["loss"].item() == metrics["distill_loss"].item()
    wanted = flatten_paths(spec.train_params(params_from_jax(want["grads"])) if name == "lxmert"
                           else params_from_jax(want["grads"]))
    for pname, g in zip(state.optimizer.names, grads, strict=True):
        np.testing.assert_allclose(g.numpy(), wanted[pname].numpy(), atol=1e-4, rtol=1e-4, err_msg=pname)
    trainer.apply(state, grads)
    stepped = flatten_paths(spec.train_params(params_from_jax(want["stepped"])) if name == "lxmert"
                            else params_from_jax(want["stepped"]))
    for pname, p in flatten_paths(state.params).items():
        np.testing.assert_allclose(p.detach().numpy(), stepped[pname].numpy(), atol=7 * LR, rtol=0, err_msg=pname)


def test_pure_soft_builds_no_family_loss():
    """hard_loss_weight 0: the family's loss is never computed (its head gets no gradient where the soft loss
    does not read it: LXMERT's logit_W with the logit_fc head)."""
    spec, _ = _specs("lxmert")
    tree, batch = _case("lxmert", 30)
    trainer = Trainer(spec, _tc(TrainConfig, "lxmert", "pure_soft"), precision=Precision.f32(), device="cpu")
    state = trainer.init_state(spec.from_jax(params_from_jax(tree)))
    grads, metrics = trainer.grads(state, trainer.to_device(batch), seed=0)
    by_name = dict(zip(state.optimizer.names, grads))
    assert by_name["logit_W"].abs().max().item() == 0.0 and by_name["logit_fc/fc2/kernel"].abs().max().item() > 0
    assert "mlm_loss" not in metrics
    with pytest.raises(ValueError, match="cross-encoder"):
        make_loss_fn(dataclasses.replace(spec, name="two_tower"), TrainConfig(distill_weight=1.0), Precision.f32())
    # without the teacher's entries the loss is the family's alone
    no_teacher = {k: v for k, v in batch.items() if not k.startswith("teacher_")}
    hard = Trainer(spec, _tc(TrainConfig, "lxmert", "hard_and_soft"), precision=Precision.f32(), device="cpu")
    _, m = hard.grads(hard.init_state(spec.from_jax(params_from_jax(tree))), hard.to_device(no_teacher), seed=0)
    assert "distill_loss" not in m
