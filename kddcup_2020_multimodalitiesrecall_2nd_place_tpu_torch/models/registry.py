"""Model registry: the four scorers of the ensemble (``code/main.py:59``:
0.3 A + 0.2 B + 0.2 C + 0.3 LXMERT); ImageBERT-C is ImageBERT-B with the
sen2forest query rewrite (``sen2forest``). And the two-tower recall model,
which scores (a pair's cosine) on ImageBERT-B's batch layout."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Callable

import torch

from .. import BERT_CONFIG_PATH
from . import imagebert_a, imagebert_b, lxmert, two_tower
from .core import BertConfig, Params

PORTED = ("imagebert_a", "imagebert_b", "imagebert_c", "lxmert", "two_tower")
LXMERT_DEPTHS = ("l_layers", "x_layers", "r_layers")


def _as_loaded(params: Params) -> Params:
    return params


@dataclass(frozen=True)
class ModelSpec:
    name: str
    config: Any
    init: Callable[[torch.Generator], Params]
    apply: Callable[..., dict]
    featurizer_layout: str  # which Featurizer method builds its batches
    input_keys: tuple[str, ...]
    matmul_kernels: tuple[tuple[str, ...], ...]  # the param paths cast to the compute dtype
    sen2forest: bool = False  # the featurizer rewrites queries first (ImageBERT-C)
    # the model's own step after checkpoint.params_from_jax (ImageBERT-B bands its label conv)
    from_jax: Callable[[Params], Params] = _as_loaded
    # the tree a trainer holds, and back to the tree scored and saved (LXMERT trains visual_attention
    # as query and kv, and rebuilds its qkv; ImageBERT-B trains its label conv's taps, and bands them)
    train_params: Callable[[Params], Params] = _as_loaded
    eval_params: Callable[[Params], Params] = _as_loaded

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
    """``overrides``: BertConfig fields to change for this one spec; for
    LXMERT, ``l_layers`` / ``x_layers`` / ``r_layers`` set the stack depths
    (the JAX package's ``models/registry.py`` :68-74). ``two_tower``'s config
    is ``two_tower_config``'s (``KMR_TOWER_CONFIG_OVERRIDES``, not
    ``KMR_CONFIG_OVERRIDES``), with ``overrides`` on its BertConfig."""
    if name not in PORTED:
        raise ValueError(f"unknown model {name!r}")
    if name == "two_tower":
        tcfg = two_tower.two_tower_config(overrides)
        return ModelSpec(
            name,
            tcfg,
            init=lambda gen: two_tower.init_params(tcfg, gen),
            apply=two_tower.apply,
            featurizer_layout="imagebert_b",
            input_keys=two_tower.INPUT_KEYS,
            matmul_kernels=two_tower.MATMUL_KERNELS,
            from_jax=two_tower.from_jax,
            train_params=imagebert_b.train_params,
            eval_params=imagebert_b.eval_params,
        )
    overrides = dict(overrides or {})
    depths = {k: overrides.pop(k) for k in LXMERT_DEPTHS if k in overrides}
    cfg = _bert_config()
    if overrides:
        cfg = cfg.replace(**overrides)
    if name == "lxmert":
        lcfg = lxmert.LxmertConfig(bert=cfg, **depths)
        return ModelSpec(
            name,
            lcfg,
            init=lambda gen: lxmert.init_params(lcfg, gen),
            apply=lxmert.apply,
            featurizer_layout="lxmert",
            input_keys=lxmert.INPUT_KEYS,
            matmul_kernels=lxmert.MATMUL_KERNELS,
            train_params=lxmert.train_params,
            eval_params=lxmert.eval_params,
        )
    if name in ("imagebert_b", "imagebert_c"):
        return ModelSpec(
            name,
            cfg,
            init=lambda gen: imagebert_b.init_params(cfg, gen),
            apply=imagebert_b.apply,
            featurizer_layout="imagebert_b",
            input_keys=imagebert_b.INPUT_KEYS,
            matmul_kernels=imagebert_b.MATMUL_KERNELS,
            sen2forest=(name == "imagebert_c"),
            from_jax=imagebert_b.from_jax,
            train_params=imagebert_b.train_params,
            eval_params=imagebert_b.eval_params,
        )
    return ModelSpec(
        name,
        cfg,
        init=lambda gen: imagebert_a.init_params(cfg, gen),
        apply=imagebert_a.apply,
        featurizer_layout="imagebert_a",
        input_keys=imagebert_a.INPUT_KEYS,
        matmul_kernels=imagebert_a.MATMUL_KERNELS,
    )
