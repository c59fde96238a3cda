"""Teacher -> student distillation for the serving path, the port of the JAX
package's ``train/distill.py``.

No reference counterpart: the reference serves a 4-model ensemble
(``code/main.py:59``, weights 0.2/0.2/0.3/0.3) at 12-layer depth per
scorer. Distillation compresses that ensemble (or any single scorer) into
one shallower student of the same family, which scores at about 12/L of the
teacher's depth.

Two teacher modes, one loss:

* **Offline** (``TeacherScores``): soft targets from reference-format score
  files, one scorer's or several fused with the ensemble weights; the
  (query_id, product_id) join needs no teacher forward pass.
* **Live** (``LiveTeacher``): a full-depth teacher checkpoint scores every
  batch in serving mode (fed label = 1, like testB scoring:
  ``evaluate_normal.py:240-243``) through a ``ScoringEngine``: on the card the
  scoring blocks' kernels ("pallas_packed", bf16), whatever attention backend
  the process holds. Its probabilities stay on the device.

The loss is the temperature-softened binary soft-target cross entropy on the
match log-odds (the two-class heads reduce to one log-odds scalar), scaled by
T^2 so the gradient's size does not depend on the temperature (Hinton et
al. 2015).

Depth mapping (``init_student_from_teacher``) works on param trees in the
JAX package's layout with numpy leaves (``checkpoint.params_to_jax``), where
each encoder leaf carries a leading [L] axis; the port's derived forms (the
fused ``qkv``, LXMERT's ``visual_attention`` forms, ImageBERT-B's label-conv
band) are rebuilt from the mapped tree by ``spec.from_jax(params_from_jax(..))``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ensemble.fusion import DEFAULT_WEIGHTS, ScoreTable, fuse, load_csv_scores, load_tsv_scores
from ..models import heads

_EPS = 1e-6

# keys that never feed a model forward pass
HOST_ONLY_KEYS = ("product_id", "query_id", "valid")
AUX_PREFIXES = ("masked_lm", "word_match", "teacher_")
# the entries the distillation loss reads, beside the model's inputs
TEACHER_KEYS = ("teacher_prob", "teacher_weight")


def model_batch_of(batch: dict) -> dict:
    return {k: v for k, v in batch.items() if k not in HOST_ONLY_KEYS and not k.startswith(AUX_PREFIXES)}


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def teacher_logodds(probs: torch.Tensor) -> torch.Tensor:
    """Match probability -> log-odds, clipped away from the saturated ends
    (score files quantise near 0/1; the clip bounds the soft target's implied
    logit rather than sending it to +-inf)."""
    p = torch.as_tensor(probs, dtype=torch.float32).clamp(_EPS, 1.0 - _EPS)
    return torch.log(p) - torch.log1p(-p)


def distill_soft_ce(student_logodds: torch.Tensor, teacher_probs: torch.Tensor, temperature: float = 1.0,
                    weights: torch.Tensor | None = None, weight_sum: torch.Tensor | None = None) -> torch.Tensor:
    """T^2-scaled soft binary cross entropy between the temperature-softened
    teacher and student match distributions. With x = s/T and
    pT = sigmoid(t/T): CE = softplus(x) - pT * x (the stable form of
    -[pT log sig(x) + (1-pT) log sig(-x)]); the mean, or the ``weights``-weighted
    mean over at least one unit of weight (``weight_sum`` in place of the
    weights' sum: a data-parallel rank's global one)."""
    t = teacher_logodds(teacher_probs)
    x = student_logodds.float() / temperature
    p_t = torch.sigmoid(t / temperature)
    ce = (torch.logaddexp(x, torch.zeros_like(x)) - p_t * x) * (temperature**2)  # softplus(x), as jax.nn's
    if weights is None:
        return ce.mean()
    w = weights.float()
    return (ce * w).sum() / (w.sum() if weight_sum is None else weight_sum).clamp_min(1.0)


def match_logodds(model_name: str, params, out: dict, batch: dict) -> torch.Tensor:
    """The student's serving-mode match log-odds, per family: ImageBERT-A's
    NSP logits; ImageBERT-B/C's AM margin applied at the fed label 1 whatever
    hard label the batch carries (the teacher's targets were made the same
    way); LXMERT's ``logit`` (``logit_fc``, or the ``logit_W`` cosines)."""
    if model_name == "imagebert_a":
        logits = heads.nsp_logits(params["cls"]["seq_relationship"], out["pooled"])
    elif model_name in ("imagebert_b", "imagebert_c"):
        cos = heads.am_cosines(params["cls"]["seq_relationship"], out["pooled"])
        logits = heads.am_margin_logits(cos, torch.ones_like(batch["labels"]))
    elif model_name == "lxmert":
        logits = out["logit"].float()
    else:
        raise ValueError(f"no distillation log-odds for {model_name!r}")
    return logits[:, 1] - logits[:, 0]


# ---------------------------------------------------------------------------
# student init
# ---------------------------------------------------------------------------


def evenly_spaced_layers(num_student: int, num_teacher: int) -> tuple[int, ...]:
    """Teacher layer indices for each student layer: evenly spaced through
    the stack, always ending on the teacher's last layer (the DistilBERT-style
    mapping), e.g. 12 -> 4 gives (2, 5, 8, 11)."""
    if not 1 <= num_student <= num_teacher:
        raise ValueError(f"bad depths student={num_student} teacher={num_teacher}")
    return tuple(round((i + 1) * num_teacher / num_student) - 1 for i in range(num_student))


def stacking_layer_map(num_deep: int, num_shallow: int) -> tuple[int, ...]:
    """Shallow layer index feeding each deep layer when GROWING a stack: deep
    layer i copies shallow layer ``floor(i * num_shallow / num_deep)``, so each
    shallow layer expands into a contiguous run in depth order, e.g. 6 -> 12
    gives (0,0,1,1,2,2,3,3,4,4,5,5) (the adjacent-duplication variant of
    progressive stacking, Gong et al. 2019)."""
    if not 1 <= num_shallow <= num_deep:
        raise ValueError(f"bad depths deep={num_deep} shallow={num_shallow}")
    return tuple(i * num_shallow // num_deep for i in range(num_deep))


def init_student_from_teacher(student_params: dict, teacher_params: dict) -> dict:
    """Copy teacher weights into a student of the same family at any depth;
    both trees in the JAX package's layout, numpy leaves.

    Encoder leaves are scan-stacked (a leading [L] axis), so a depth change is
    an index-take on a leaf pair that agrees on its trailing dims: a
    SHALLOWER student takes the evenly spaced teacher layers, a DEEPER one
    duplicates each teacher layer into a contiguous run. Same-shape leaves
    (embeddings, pooler, heads, LXMERT's stacks at equal depth) copy as they
    are. The depth mapping applies ONLY under a key that holds "encoder"; any
    other leading-dim mismatch (a larger vocab or ``max_position_embeddings``
    by --student-overrides) keeps the student's fresh init. LXMERT's three
    stacks map each at its own depth.

    The trees must have the same leaves, as the JAX package's ``tree_map``
    requires, with one exception: an MLM head ``cls/predictions`` the teacher
    lacks (the importer leaves it out of inference-only ImageBERT-A bundles)
    keeps the student's init. Any other difference raises."""

    def merge(path: tuple[str, ...], s, t):
        if isinstance(s, dict) or isinstance(t, dict):
            if not (isinstance(s, dict) and isinstance(t, dict)):
                raise ValueError(f"student and teacher trees differ at {'/'.join(path)}")
            missing, extra = s.keys() - t.keys(), t.keys() - s.keys()
            if path == ("cls",):
                missing -= {"predictions"}
            elif not path and s.get("cls", {}).keys() == {"predictions"}:
                missing -= {"cls"}  # LXMERT's cls holds only the MLM head
            if missing or extra:
                raise ValueError(f"student and teacher trees differ at {'/'.join(path) or 'the root'}: "
                                 f"the teacher lacks {sorted(missing)}, has extra {sorted(extra)}")
            return {k: merge((*path, k), v, t[k]) if k in t else v for k, v in s.items()}
        s, t = np.asarray(s), np.asarray(t)
        if s.shape == t.shape:
            return t
        in_encoder = any("encoder" in k for k in path)
        if in_encoder and s.ndim == t.ndim and s.ndim >= 1 and s.shape[1:] == t.shape[1:]:
            if s.shape[0] < t.shape[0]:
                idx = np.asarray(evenly_spaced_layers(s.shape[0], t.shape[0]))
            else:
                idx = np.asarray(stacking_layer_map(s.shape[0], t.shape[0]))
            return t[idx]
        return s

    return merge((), student_params, teacher_params)


# ---------------------------------------------------------------------------
# teacher sources
# ---------------------------------------------------------------------------


def _load_scores(path) -> ScoreTable:
    return load_csv_scores(path) if str(path).endswith(".csv") else load_tsv_scores(path)


@dataclass
class TeacherScores:
    """Offline soft targets from reference-format score files, keyed by
    (query_id, product_id). Several files fuse into one weighted-average
    teacher: pass the ensemble weights (0.2/0.2/0.3/0.3, ``main.py:59``) to
    distil the full ensemble."""

    probs: dict[tuple[str, str], float]

    @classmethod
    def from_ensemble_files(cls, scores_b, scores_c, scores_a, scores_lxmert,
                            weights: tuple[float, float, float, float] | None = None) -> "TeacherScores":
        """The full reference ensemble as the teacher: the four score files
        fused with ``code/main.py:49-59`` semantics (the pair universe from the
        LXMERT table, missing B/C/A pairs backfilled with the LXMERT score,
        weights 0.2/0.2/0.3/0.3 by default)."""
        fusion = fuse(_load_scores(scores_b), _load_scores(scores_c), _load_scores(scores_a),
                      _load_scores(scores_lxmert), weights=weights or DEFAULT_WEIGHTS)
        return cls({(qid, pid): s for qid, row in fusion.merge.items() for pid, s in row.items()})

    @classmethod
    def from_files(cls, paths: list[str], weights: list[float] | None = None) -> "TeacherScores":
        if weights is None:
            weights = [1.0 / len(paths)] * len(paths)
        if len(weights) != len(paths):
            raise ValueError("one weight per score file required")
        tables = [_load_scores(p) for p in paths]
        probs: dict[tuple[str, str], float] = {}
        for qid, row in tables[0].items():
            for pid in row:
                s = 0.0
                for tab, w in zip(tables, weights):
                    try:
                        s += w * tab[qid][pid]
                    except KeyError:
                        raise KeyError(f"pair ({qid}, {pid}) missing from one of the teacher score files; all "
                                       f"files must cover the same pairs (fuse/backfill upstream if not)") from None
                probs[(qid, pid)] = s
        return cls(probs)

    def __len__(self) -> int:
        return len(self.probs)

    def attach(self, batch: dict) -> dict:
        """Add ``teacher_prob``/``teacher_weight`` arrays to a stacked batch
        (weight 0 for padded tail rows; a valid pair without a score is an
        error: offline distillation needs score files that cover the TSV)."""
        qids, pids = batch["query_id"], batch["product_id"]
        valid = batch.get("valid", np.ones(len(qids), dtype=bool))
        probs = np.zeros(len(qids), dtype=np.float32)
        weight = np.zeros(len(qids), dtype=np.float32)
        missing = []
        for i, (q, p, v) in enumerate(zip(qids, pids, valid)):
            if not v:
                continue
            key = (str(int(q)), str(int(p)))
            got = self.probs.get(key)
            if got is None:
                missing.append(key)
                continue
            probs[i] = got
            weight[i] = 1.0
        if missing:
            raise KeyError(f"{len(missing)} pairs in the batch have no teacher score, first: {missing[0]} -- score "
                           f"the distillation TSV with the teacher(s) first")
        return {**batch, "teacher_prob": probs, "teacher_weight": weight}


class LiveTeacher:
    """A full-depth teacher scoring every batch in serving mode (fed label =
    1), through a ``ScoringEngine`` on ``device`` (cuda unless the caller asks
    for cpu) at ``precision`` (the engine's default: bf16 on the card, through
    the scoring blocks' kernels; f32 on the CPU)."""

    def __init__(self, spec, params, device=None, precision=None):
        from ..parallel.engine import ScoringEngine  # here: the engine imports the data layer and the kernels

        self.spec = spec
        self.engine = ScoringEngine(spec, params, device=device, precision=precision)

    def attach(self, batch: dict) -> dict:
        """``batch`` with ``teacher_prob``, the teacher's f32 probabilities as
        a tensor on the engine's device, and ``teacher_weight``, the valid mask."""
        model_batch = model_batch_of(batch)
        if "labels" in model_batch:
            # the serving-mode fed label (testB feeds 1: evaluate_normal.py:240)
            model_batch["labels"] = np.ones_like(batch["labels"])
        # score_batch runs under inference_mode; the clone, made outside it, is a plain tensor, which the
        # student's loss may save for its backward
        probs = self.engine.score_batch(model_batch).float().clone()
        valid = batch.get("valid", np.ones(probs.shape[0], dtype=bool))
        return {**batch, "teacher_prob": probs, "teacher_weight": np.asarray(valid, np.float32)}
