"""Training engine on one device, the port of the JAX package's
``train/trainer.py``.

Per-model recipes mirror the reference training scripts (``recipe_for``):

* ImageBERT-A: BERT-Adam (poly decay + warmup), global-norm clip 1.0, NSP
  loss (+ the Multi-Similarity term of its fine-tune, + ``mlm_loss_weight``
  times the tied-embedding MLM loss on the masked query positions).
* LXMERT: BERT-Adam, global-norm clip 1.0, cross entropy on ``logit_fc``,
  or with ``am_loss`` on the AM-margin logits of the ``logit_W`` cosines
  (+ ``mlm_loss_weight`` times the MLM loss on the ``lang`` stream).
* ImageBERT-B/C: Adam with bias correction on the 0.94/2500 staircase,
  per-value clip +-1, AM-softmax loss (+ ``word_match_loss_weight`` times the
  word-match loss, off by default as the reference trained), EMA 0.997; the
  label conv trains as its 8 taps (``models/imagebert_b.py``).

``TrainConfig.optimizer`` overrides a recipe's optimizer (``bert_adamw`` or
``adam_staircase``). A step is the JAX package's two phases: ``grads``
(forward and backward of the loss) and ``apply`` (clip, optimizer, EMA),
with the same metrics (``loss``, ``accuracy``, ``grad_norm``, ``mlm_loss``,
``distill_loss``, and with ``grad_summaries`` each group's norm before and
after the clip). ``distill_weight`` adds the soft loss against a teacher's
probabilities (``train/distill.py``) to, or with ``hard_loss_weight`` 0 in
place of, the family's loss.
``save_state`` / ``load_state`` write and read a resumable state
(``state_<N>.npz``: params, moments, EMA shadows, step, the config).

Parameters are float32 leaves on the device in the port's tree layout
(query/key/value fused as ``qkv``; the spec's ``train_params`` keeps
LXMERT's ``visual_attention`` as ``query`` and ``kv`` only, and
``eval_params`` rebuilds its ``qkv``; ImageBERT-B's ``kdd_conv1`` as taps,
banded again by ``eval_params``); matmul inputs are rounded to
``precision.compute_dtype`` inside the model, whose encoder blocks are the
train blocks of ``blocks`` (the kernels' by default). Dropout comes from a
``torch.Generator`` seeded per step from the caller's int. Data parallelism
across devices is not ported (ROADMAP.md Queue 1 item 12).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..checkpoint.npz import unflatten_tree
from ..models import ModelSpec, Precision, heads
from ..models.core import TRAIN_KERNEL_BLOCKS, Params, TrainBlocks
from ..parallel.engine import default_precision, resolve_device
from .distill import TEACHER_KEYS, distill_soft_ce, match_logodds
from .ema import Ema
from .losses import ms_loss
from .optim import (
    Adam,
    BertAdamW,
    Optimizer,
    clip_by_global_norm,
    clip_by_value,
    exponential_staircase_schedule,
    flatten_paths,
    grad_group_norms,
    polynomial_warmup_schedule,
)

TRAINED = ("imagebert_a", "imagebert_b", "imagebert_c", "lxmert")
# the word-match loss's batch entries (data/sampling.py, ImageBERT-B's recipe)
WORD_MATCH_KEYS = ("word_match_labels", "word_match_weights")
# the MLM loss's batch entries (data/sampling.py, ImageBERT-A's recipe)
MLM_KEYS = ("masked_lm_positions", "masked_lm_ids", "masked_lm_weights")
# the stream the MLM head reads, by model (the JAX package's trainer.py :180-183, :210-213)
MLM_SEQUENCE = {"imagebert_a": "sequence", "lxmert": "lang"}


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-5
    num_train_steps: int = 100_000
    num_warmup_steps: int = 30_000
    optimizer: str = "bert_adamw"  # or "adam_staircase"
    clip: str = "global_norm"  # "global_norm" | "value" | "none"
    clip_value: float = 1.0
    ema_decay: float | None = None
    ms_loss_weight: float = 0.0
    # LXMERT --taskAMSloss: train the cosine logit_W head instead of logit_fc (tasks/kdd_model.py:207-210)
    am_loss: bool = False
    # ImageBERT-B's word-match loss; 0 = off, as the reference trained (model_triple.py:207-210)
    word_match_loss_weight: float = 0.0
    # the tied-embedding MLM loss of ImageBERT-A and LXMERT; 0 = off
    mlm_loss_weight: float = 0.0
    # per-group gradient norms before and after the clip (run_pretraining_predict_score.py:234-258); off
    grad_summaries: bool = False
    # teacher -> student distillation (train/distill.py): with distill_weight > 0 and teacher_prob in the
    # batch, the loss is hard_loss_weight * the family's loss + distill_weight * the T^2-softened soft CE;
    # hard_loss_weight = 0 skips the family's loss (pure-soft distillation on unlabeled pairs)
    distill_weight: float = 0.0
    distill_temperature: float = 1.0
    hard_loss_weight: float = 1.0


def recipe_for(model_name: str) -> TrainConfig:
    if model_name == "imagebert_a":
        return TrainConfig(learning_rate=2e-5, optimizer="bert_adamw", clip="global_norm")
    if model_name in ("imagebert_b", "imagebert_c"):
        return TrainConfig(learning_rate=2e-5, optimizer="adam_staircase", clip="value", ema_decay=0.997)
    if model_name == "lxmert":
        return TrainConfig(learning_rate=1e-4, optimizer="bert_adamw", clip="global_norm")
    if model_name == "two_tower":
        return TrainConfig(learning_rate=1e-4, optimizer="bert_adamw", num_warmup_steps=1000, clip="global_norm")
    raise ValueError(model_name)


def make_optimizer(tc: TrainConfig, params: Params) -> Optimizer:
    if tc.optimizer == "bert_adamw":
        return BertAdamW(params, polynomial_warmup_schedule(tc.learning_rate, tc.num_train_steps,
                                                            tc.num_warmup_steps))
    if tc.optimizer == "adam_staircase":
        return Adam(params, exponential_staircase_schedule(tc.learning_rate))
    raise ValueError(tc.optimizer)


class _GatherPositions(torch.autograd.Function):
    """seq [B, S, H], pos [B, P] -> the rows of ``seq`` at ``pos`` [B, P, H]
    (``take_along_axis``). The backward sums the gradients of a repeated
    position in a fixed order, as one [S, P] x [P, H] one-hot product a pair;
    ``gather``'s own backward (``scatter_add``) sums them by atomics on the
    card, in a varying order, so two runs of one step would differ."""

    @staticmethod
    def forward(ctx, seq: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(pos)
        ctx.seq_len = seq.shape[1]
        return seq.gather(1, pos[..., None].expand(-1, -1, seq.shape[-1]))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (pos,) = ctx.saved_tensors
        one_hot = torch.nn.functional.one_hot(pos, ctx.seq_len).to(g.dtype)  # [B, P, S]
        return torch.bmm(one_hot.transpose(1, 2), g), None


def make_loss_fn(model: ModelSpec, tc: TrainConfig, precision: Precision,
                 blocks: TrainBlocks = TRAIN_KERNEL_BLOCKS) -> Callable:
    """-> loss_fn(params, batch, gen) -> (loss, metrics): ImageBERT-A's NSP
    loss, plus ``ms_loss_weight`` times the Multi-Similarity loss of the
    pooled output; ImageBERT-B/C's ``am_loss``, plus
    ``word_match_loss_weight`` times the word-match loss when the batch
    carries its labels; LXMERT's cross entropy on ``logit_fc``, or with
    ``am_loss`` on the AM-margin logits of the clipped ``logit_W`` cosines;
    for A and LXMERT, plus ``mlm_loss_weight`` times the MLM loss when the
    batch carries its masked positions (the JAX package's
    ``train/trainer.py`` :174-213). With ``distill_weight`` and a batch that
    carries ``teacher_prob``: ``hard_loss_weight`` times that loss plus
    ``distill_weight`` times ``distill_soft_ce`` of the student's match
    log-odds (``distill_loss`` in the metrics); ``hard_loss_weight`` 0 builds
    no family loss at all (the JAX package's :126-145, :216-227)."""
    if tc.distill_weight and model.name == "two_tower":
        raise ValueError("distillation targets the cross-encoder scorers")
    if model.name not in TRAINED:
        raise NotImplementedError(f"training {model.name!r} is not yet ported, see ROADMAP.md Queue 1 item 11")
    am = model.name == "lxmert" and tc.am_loss
    head = {"use_am_head": True} if am else {}

    def mlm_term(params: Params, out: dict, batch: dict) -> torch.Tensor:
        """The tied-embedding MLM loss over the masked positions of the text
        stream (the JAX package's :129-141): gathered from ``out``, through
        ``cls/predictions`` and the word-embedding table."""
        seq = out[MLM_SEQUENCE[model.name]]
        pos = batch["masked_lm_positions"].long()
        hidden = _GatherPositions.apply(seq, pos)
        logits = heads.mlm_logits(params["cls"]["predictions"], hidden,
                                  params["bert"]["embeddings"]["word_embeddings"], precision)
        return heads.mlm_loss(logits, batch["masked_lm_ids"], batch["masked_lm_weights"])

    mlm = tc.mlm_loss_weight and model.name in MLM_SEQUENCE
    # pure-soft distillation never builds the family's loss
    compute_hard = not (tc.distill_weight and tc.hard_loss_weight == 0.0)

    def loss_fn(params: Params, batch: dict, gen: torch.Generator):
        out = model.apply(params, batch, model.config, precision, blocks, train=True, gen=gen, **head)
        labels = batch["labels"]
        metrics = {}
        if not compute_hard:
            loss = torch.zeros((), device=labels.device)
        elif model.name == "lxmert":
            logits = heads.am_margin_logits(out["logit"].float().clamp(-1.0, 1.0), labels) if am else out["logit"]
            loss = heads.cross_entropy(logits, labels)
        elif model.name == "imagebert_a":
            loss = heads.nsp_loss(params["cls"]["seq_relationship"], out["pooled"], labels)
            if tc.ms_loss_weight:
                loss = loss + tc.ms_loss_weight * ms_loss(labels, out["pooled"])
        else:
            loss = heads.am_loss(params["cls"]["seq_relationship"], out["pooled"], labels)
            if tc.word_match_loss_weight and "word_match_labels" in batch:
                wm = heads.word_match_loss(params["kdd_query_match"], out["sequence"], batch["word_match_labels"],
                                           batch["word_match_weights"], precision)
                metrics["word_match_loss"] = wm.detach()
                loss = loss + tc.word_match_loss_weight * wm
        if compute_hard and mlm and "masked_lm_positions" in batch:
            term = mlm_term(params, out, batch)
            metrics["mlm_loss"] = term.detach()
            loss = loss + tc.mlm_loss_weight * term
        if tc.distill_weight and "teacher_prob" in batch:
            d = distill_soft_ce(match_logodds(model.name, params, out, batch), batch["teacher_prob"],
                                tc.distill_temperature, batch.get("teacher_weight"))
            metrics["distill_loss"] = d.detach()
            loss = tc.hard_loss_weight * loss + tc.distill_weight * d
        accuracy = (out["probs"].argmax(dim=-1) == labels.long()).float().mean()
        return loss, {**metrics, "loss": loss.detach(), "accuracy": accuracy}

    return loss_fn


@dataclass
class TrainState:
    params: Params  # f32 leaves on the device, requiring grad
    optimizer: Optimizer
    ema: Ema | None

    @property
    def step(self) -> int:
        return self.optimizer.step

    def leaves(self) -> list[torch.Tensor]:
        return list(flatten_paths(self.params).values())


class Trainer:
    """One model trained on one device (cuda unless the caller asks for cpu)."""

    def __init__(self, model: ModelSpec, tc: TrainConfig | None = None, precision: Precision | None = None,
                 device=None, blocks: TrainBlocks = TRAIN_KERNEL_BLOCKS):
        self.model = model
        self.tc = tc if tc is not None else recipe_for(model.name)
        self.device = resolve_device(device)
        self.precision = precision if precision is not None else default_precision(self.device)
        self.loss_fn = make_loss_fn(model, self.tc, self.precision, blocks)

    def init_state(self, params: Params | None = None, seed: int = 0) -> TrainState:
        """Fresh optimizer state over ``params`` (or the model's random init from ``seed``), copied to the
        device, in the tree the spec trains (``ModelSpec.train_params``). With
        the word-match loss on, a ``kdd_query_match`` head is added from
        ``seed`` where ``params`` has none (the JAX package's :303-309)."""
        params = self.model.train_params(params if params is not None else self.model.init_params(seed))
        if self.tc.word_match_loss_weight and "kdd_query_match" not in params:
            gen = torch.Generator().manual_seed(seed + 1)
            params = {**params, "kdd_query_match": heads.word_match_head_init(self.model.config, gen)}

        def leaf(t):
            return t.detach().to(self.device, torch.float32).clone().requires_grad_()

        def to_leaves(tree):
            return {k: to_leaves(v) if isinstance(v, dict) else leaf(v) for k, v in tree.items()}

        params = to_leaves(params)
        leaves = list(flatten_paths(params).values())
        return TrainState(params, make_optimizer(self.tc, params),
                          Ema(leaves, self.tc.ema_decay) if self.tc.ema_decay else None)

    def save_state(self, state: TrainState, path) -> None:
        """Write the resumable state to ``path`` (an npz): every trained leaf
        in the port's layout (``params/<path>``), the optimizer's moments
        (``m/``, ``v/``) and count, the EMA shadows (``ema/``) and count, the
        model's name and the ``TrainConfig`` as JSON."""
        arrays = {"model": np.array(self.model.name), "step": np.array(state.step, np.int64),
                  "train_config": np.array(json.dumps(dataclasses.asdict(self.tc)))}
        for prefix, tensors in self._state_tensors(state).items():
            for name, t in zip(state.optimizer.names, tensors, strict=True):
                arrays[f"{prefix}/{name}"] = t.detach().cpu().numpy()
        if state.ema is not None:
            arrays["ema_num_updates"] = np.array(state.ema.num_updates, np.int64)
        np.savez(path, **arrays)

    @torch.no_grad()
    def load_state(self, state: TrainState, path) -> TrainState:
        """Fill ``state`` (from ``init_state``) in place from a ``save_state``
        file, bit for bit; -> ``state``. Raises ``ValueError`` when the file
        holds another model, a run of another ``TrainConfig`` (every field
        but the ``grad_summaries`` switch, which changes no state), or other
        leaves or shapes than ``state``."""
        with np.load(path) as f:
            arrays = {k: f[k] for k in f.files}
        saved = str(arrays["model"])
        if saved != self.model.name:
            raise ValueError(f"{path} holds a {saved} train state, not {self.model.name}")
        saved_tc = json.loads(str(arrays["train_config"]))
        ours = dataclasses.asdict(self.tc)
        differ = sorted(k for k in ours.keys() | saved_tc.keys()
                        if k != "grad_summaries" and saved_tc.get(k) != ours.get(k))
        if differ:
            raise ValueError(f"{path} holds a run of another train config: "
                             + ", ".join(f"{k} {saved_tc.get(k)!r} there, {ours.get(k)!r} here" for k in differ))
        targets = self._state_tensors(state)
        want = {f"{prefix}/{name}": t for prefix, tensors in targets.items()
                for name, t in zip(state.optimizer.names, tensors, strict=True)}
        have = {k for k in arrays if "/" in k}
        if have != set(want):
            raise ValueError(f"{path} holds other leaves than this trainer's state: missing "
                             f"{sorted(set(want) - have)[:5]}, unexpected {sorted(have - set(want))[:5]}")
        bad = [k for k, t in want.items() if tuple(arrays[k].shape) != tuple(t.shape)]
        if bad:
            raise ValueError(f"{path}: shapes differ from this trainer's state at {bad[:5]}, e.g. "
                             f"{bad[0]} {arrays[bad[0]].shape} vs {tuple(want[bad[0]].shape)}")
        for k, t in want.items():
            t.copy_(torch.from_numpy(arrays[k]))
        state.optimizer.step = int(arrays["step"])
        if state.ema is not None:
            state.ema.num_updates = int(arrays["ema_num_updates"])
        return state

    @staticmethod
    def _state_tensors(state: TrainState) -> dict[str, list[torch.Tensor]]:
        """The tensors of a resumable state, each list in ``optimizer.names`` order."""
        out = {"params": state.leaves(), "m": state.optimizer.m, "v": state.optimizer.v}
        if state.ema is not None:
            out["ema"] = state.ema.shadow
        return out

    def to_device(self, batch: dict) -> dict[str, torch.Tensor]:
        """The entries the loss reads: the model's inputs, the labels and,
        with the word-match or MLM loss on, their entries where the batch
        has them; with distillation on, the teacher's probabilities and
        weights (a live teacher's are already on the device)."""
        keys = [*self.model.input_keys, "labels"]
        if self.tc.word_match_loss_weight:
            keys += [k for k in WORD_MATCH_KEYS if k in batch]
        if self.tc.mlm_loss_weight:
            keys += [k for k in MLM_KEYS if k in batch]
        if self.tc.distill_weight:
            keys += [k for k in TEACHER_KEYS if k in batch]

        def on_device(v) -> torch.Tensor:
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
            return t.to(self.device)

        return {k: on_device(batch[k]) for k in keys}

    def grads(self, state: TrainState, batch: dict, seed: int) -> tuple[list[torch.Tensor], dict]:
        """Phase 1: the loss and its gradient w.r.t. every leaf (zeros where unused)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        leaves = state.leaves()
        loss, metrics = self.loss_fn(state.params, batch, gen)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)], metrics

    def apply(self, state: TrainState, grads: list[torch.Tensor]) -> dict:
        """Phase 2: clip, optimizer update and EMA, in place; with
        ``grad_summaries``, each group's gradient norm before and after the
        clip (the JAX package's :271-283)."""
        metrics = {}
        names = state.optimizer.names
        if self.tc.grad_summaries:
            metrics.update({f"grad_norm_pre_clip/{g}": n for g, n in grad_group_norms(names, grads).items()})
        if self.tc.clip == "global_norm":
            metrics["grad_norm"] = clip_by_global_norm(grads, self.tc.clip_value)
        elif self.tc.clip == "value":
            clip_by_value(grads, self.tc.clip_value)
        if self.tc.grad_summaries and self.tc.clip != "none":
            metrics.update({f"grad_norm_post_clip/{g}": n for g, n in grad_group_norms(names, grads).items()})
        leaves = state.leaves()
        state.optimizer.update(leaves, grads)
        if state.ema is not None:
            state.ema.update(leaves)
        return metrics

    def train_step(self, state: TrainState, batch: dict[str, np.ndarray], seed: int) -> dict:
        """One step on a host batch; -> metrics as 0-d device tensors."""
        grads, metrics = self.grads(state, self.to_device(batch), seed)
        metrics.update(self.apply(state, grads))
        return metrics

    def eval_params(self, state: TrainState) -> Params:
        """The parameters to score or save with (the EMA shadows when kept), in
        the tree the model scores (``ModelSpec.eval_params``)."""
        if state.ema is None:
            return self.model.eval_params(state.params)
        return self.model.eval_params(unflatten_tree(dict(zip(state.optimizer.names, state.ema.shadow))))
