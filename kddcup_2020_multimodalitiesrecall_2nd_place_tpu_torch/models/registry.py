"""Model registry. Only ImageBERT-A is ported so far; the other scorers of
the ensemble (``code/main.py:59``) raise until their slice lands."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Callable

import torch

from .. import BERT_CONFIG_PATH
from . import imagebert_a
from .core import BertConfig, Params

PORTED = ("imagebert_a",)
NOT_YET_PORTED = ("imagebert_b", "imagebert_c", "lxmert", "two_tower")


@dataclass(frozen=True)
class ModelSpec:
    name: str
    config: Any
    init: Callable[[torch.Generator], Params]
    apply: Callable[..., dict]
    featurizer_layout: str  # which Featurizer method builds its batches
    input_keys: tuple[str, ...]

    def init_params(self, seed: int = 0) -> Params:
        return self.init(torch.Generator().manual_seed(seed))


def _bert_config() -> BertConfig:
    cfg = BertConfig.from_json_file(BERT_CONFIG_PATH)
    # test/debug hook shared with the JAX package: shrink the model without
    # touching call sites, e.g. KMR_CONFIG_OVERRIDES='{"hidden_size":32,...}'
    overrides = os.environ.get("KMR_CONFIG_OVERRIDES")
    if overrides:
        cfg = cfg.replace(**json.loads(overrides))
    return cfg


def get_model(name: str, overrides: dict | None = None) -> ModelSpec:
    """``overrides``: BertConfig fields to change for this one spec."""
    if name in NOT_YET_PORTED:
        raise NotImplementedError(f"model {name!r} is not yet ported, see ROADMAP.md")
    if name not in PORTED:
        raise ValueError(f"unknown model {name!r}")
    cfg = _bert_config()
    if overrides:
        cfg = cfg.replace(**overrides)
    return ModelSpec(
        name,
        cfg,
        init=lambda gen: imagebert_a.init_params(cfg, gen),
        apply=imagebert_a.apply,
        featurizer_layout="imagebert_a",
        input_keys=imagebert_a.INPUT_KEYS,
    )
