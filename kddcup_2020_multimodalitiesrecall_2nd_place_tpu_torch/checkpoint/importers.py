"""Checkpoint importers, the port's own copy of the JAX package's
``checkpoint/importers.py``: reference TF1/PyTorch name schemas -> param
trees in the JAX package's layout, numpy leaves (``npz.params_from_jax``
then takes them as it takes an npz tree).

Three naming schemas exist in the reference (SURVEY.md section 5):

* ImageBERT-A: plain TF scopes under ``bert/``, ``featureemb/``, ``cls/``
  (assignment-map schema ``pixelmodel.get_assignment_map_from_checkpoint``,
  ``pixelmodel.py:360-384``).
* ImageBERT-B/C: same plus the ``kdd_*`` image-path variables; at eval the
  reference restores **EMA shadow variables** ``<name>/ExponentialMovingAverage``
  (``evaluate_normal.py:204-206``).
* LXMERT: PyTorch ``state_dict`` of ``KDDModel`` (``tasks/kdd_model.py:154-181``)
  with optional ``module.`` (DataParallel) prefixes and HF ``gamma/beta``
  legacy renames (``lxrt/entry.py:143-176``, ``modeling.py:816-828``).

Importers consume a flat ``{name: np.ndarray}`` dict. For TF checkpoints use
``tf_bundle.read_tf_checkpoint`` (pure-Python reader of the tensor_bundle
format, no TensorFlow needed); for ``.pth`` use ``torch_io.read_torch_state_dict``.
``MissingVariable`` is caught in one place only, the optional MLM head of
ImageBERT-A; any other absent variable raises it.
"""

from __future__ import annotations

import numpy as np

from ..models.core import BertConfig
from ..models.lxmert import LxmertConfig

Array = np.ndarray
FlatDict = dict[str, Array]


class MissingVariable(KeyError):
    pass


def _get(d: FlatDict, name: str, suffix: str = "") -> Array:
    key = name + suffix
    if key not in d:
        raise MissingVariable(key)
    return np.asarray(d[key])


# --------------------------------------------------------------------------
# TF schemas (ImageBERT-A and B/C)
# --------------------------------------------------------------------------


def _tf_dense(d: FlatDict, scope: str, s: str) -> dict:
    return {"kernel": _get(d, f"{scope}/kernel", s), "bias": _get(d, f"{scope}/bias", s)}


def _tf_slim_fc(d: FlatDict, scope: str, s: str) -> dict:
    return {"kernel": _get(d, f"{scope}/weights", s), "bias": _get(d, f"{scope}/biases", s)}


def _tf_ln(d: FlatDict, scope: str, s: str) -> dict:
    return {"gamma": _get(d, f"{scope}/gamma", s), "beta": _get(d, f"{scope}/beta", s)}


def _tf_encoder(d: FlatDict, num_layers: int, s: str, prefix: str = "bert/encoder") -> dict:
    layers = []
    for i in range(num_layers):
        lp = f"{prefix}/layer_{i}"
        layers.append(
            {
                "attention": {
                    "query": _tf_dense(d, f"{lp}/attention/self/query", s),
                    "key": _tf_dense(d, f"{lp}/attention/self/key", s),
                    "value": _tf_dense(d, f"{lp}/attention/self/value", s),
                    "output": {
                        "dense": _tf_dense(d, f"{lp}/attention/output/dense", s),
                        "LayerNorm": _tf_ln(d, f"{lp}/attention/output/LayerNorm", s),
                    },
                },
                "ffn": {
                    "intermediate": _tf_dense(d, f"{lp}/intermediate/dense", s),
                    "output": {
                        "dense": _tf_dense(d, f"{lp}/output/dense", s),
                        "LayerNorm": _tf_ln(d, f"{lp}/output/LayerNorm", s),
                    },
                },
            }
        )
    return _stack_layers(layers)


def _stack_layers(layers: list[dict]) -> dict:
    def rec(*nodes):
        if isinstance(nodes[0], dict):
            return {k: rec(*[n[k] for n in nodes]) for k in nodes[0]}
        return np.stack(nodes, axis=0)

    return rec(*layers)


def imagebert_a_from_tf(d: FlatDict, cfg: BertConfig, ema: bool = False) -> dict:
    """TF variable dict -> ImageBERT-A params (schema of ImageBertKDD.ckpt)."""
    s = "/ExponentialMovingAverage" if ema else ""
    emb = {
        "word_embeddings": _get(d, "bert/embeddings/word_embeddings", s),
        "token_type_embeddings": _get(d, "bert/embeddings/token_type_embeddings", s),
        "position_embeddings": _get(d, "bert/embeddings/position_embeddings", s),
        "LayerNorm": _tf_ln(d, "bert/embeddings/LayerNorm", s),
        "word_embeddings_labelembedding": _get(
            d, "bert/embeddings/word_embeddings_labelembedding", s
        ),
    }
    params = {
        "bert": {
            "embeddings": emb,
            "encoder": _tf_encoder(d, cfg.num_hidden_layers, s),
            "pooler": {"dense": _tf_dense(d, "bert/pooler/dense", s)},
        },
        "featureemb": _tf_slim_fc(d, "featureemb/fully_connected", s),
        "cls": {
            "seq_relationship": {
                "output_weights": _get(d, "cls/seq_relationship/output_weights", s),
                "output_bias": _get(d, "cls/seq_relationship/output_bias", s),
            },
        },
    }
    try:
        params["cls"]["predictions"] = {
            "transform": {
                "dense": _tf_dense(d, "cls/predictions/transform/dense", s),
                "LayerNorm": _tf_ln(d, "cls/predictions/transform/LayerNorm", s),
            },
            "output_bias": _get(d, "cls/predictions/output_bias", s),
        }
    except MissingVariable:
        pass  # MLM head absent from inference-only checkpoints
    return params


def imagebert_b_from_tf(d: FlatDict, cfg: BertConfig, ema: bool = True) -> dict:
    """TF variable dict -> ImageBERT-B/C params.

    ``ema=True`` restores the 0.9999-EMA shadow weights exactly as
    ``evaluate_normal.py:204-206`` does. EMA shadows exist only for
    trainables; any missing shadow falls back to the raw variable, matching
    ``ExponentialMovingAverage.variables_to_restore`` semantics.
    """

    def get(name: str) -> Array:
        if ema and name + "/ExponentialMovingAverage" in d:
            return np.asarray(d[name + "/ExponentialMovingAverage"])
        return _get(d, name)

    view = _FallbackView(d, ema)
    conv1 = _get(view, "kdd_conv1/weights")
    if conv1.ndim == 4:  # TF layout [1, 8, H_in, H_out] -> [8, H_in, H_out]
        conv1 = conv1[0]
    conv2_k = _get(view, "kdd_conv2/weights")
    if conv2_k.ndim == 4:  # [1, 1, 2048, H] 1x1 conv == dense [2048, H]
        conv2_k = conv2_k[0, 0]
    return {
        "bert": {
            "embeddings": {
                "word_embeddings": get("bert/embeddings/word_embeddings"),
                "token_type_embeddings": get("bert/embeddings/token_type_embeddings"),
                "position_embeddings": get("bert/embeddings/position_embeddings"),
                "LayerNorm": _tf_ln(view, "bert/embeddings/LayerNorm", ""),
            },
            "encoder": _tf_encoder(view, cfg.num_hidden_layers, ""),
            "pooler": {"dense": _tf_dense(view, "bert/pooler/dense", "")},
        },
        "kdd_conv1": {"weights": conv1, "biases": _get(view, "kdd_conv1/biases")},
        "kdd_dense1": _tf_slim_fc(view, "kdd_dense1", ""),
        "kdd_conv2": {"kernel": conv2_k, "bias": _get(view, "kdd_conv2/biases")},
        "kdd_featureemb": _tf_slim_fc(view, "kdd_featureemb/fully_connected", ""),
        "cls": {
            "seq_relationship": {"am_kernel": get("cls/seq_relationship/am_kernel")}
        },
    }


class _FallbackView(dict):
    """Dict view preferring ``<name>/ExponentialMovingAverage`` keys."""

    def __init__(self, base: FlatDict, ema: bool):
        super().__init__()
        self._base = base
        self._ema = ema

    def __contains__(self, key):  # pragma: no cover
        return key in self._base or (self._ema and key + "/ExponentialMovingAverage" in self._base)

    def __getitem__(self, key):
        if self._ema:
            shadow = key + "/ExponentialMovingAverage"
            if shadow in self._base:
                return self._base[shadow]
        return self._base[key]


# --------------------------------------------------------------------------
# PyTorch schema (LXMERT / KDDModel BEST.pth)
# --------------------------------------------------------------------------


def normalize_torch_keys(sd: FlatDict) -> FlatDict:
    """Strip DataParallel/encoder prefixes, apply gamma/beta renames."""
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module.") :]
        if k.startswith("lxrt_encoder.model."):
            k = k[len("lxrt_encoder.model.") :]
        # HF legacy: LayerNorm gamma/beta stored as weight/bias or vice versa
        if "gamma" in k:
            k = k.replace("gamma", "weight")
        if "beta" in k:
            k = k.replace("beta", "bias")
        out[k] = np.asarray(v)
    return out


def _pt_linear(d: FlatDict, name: str) -> dict:
    return {
        "kernel": _get(d, f"{name}.weight").T,  # torch [out,in] -> [in,out]
        "bias": _get(d, f"{name}.bias"),
    }


def _pt_ln(d: FlatDict, name: str) -> dict:
    return {"gamma": _get(d, f"{name}.weight"), "beta": _get(d, f"{name}.bias")}


def _pt_att(d: FlatDict, base: str, att: str = "self") -> dict:
    return {
        "query": _pt_linear(d, f"{base}.{att}.query"),
        "key": _pt_linear(d, f"{base}.{att}.key"),
        "value": _pt_linear(d, f"{base}.{att}.value"),
        "output": {
            "dense": _pt_linear(d, f"{base}.output.dense"),
            "LayerNorm": _pt_ln(d, f"{base}.output.LayerNorm"),
        },
    }


def _pt_bert_layer(d: FlatDict, base: str) -> dict:
    return {
        "attention": _pt_att(d, f"{base}.attention"),
        "ffn": {
            "intermediate": _pt_linear(d, f"{base}.intermediate.dense"),
            "output": {
                "dense": _pt_linear(d, f"{base}.output.dense"),
                "LayerNorm": _pt_ln(d, f"{base}.output.LayerNorm"),
            },
        },
    }


def _pt_ffn(d: FlatDict, inter: str, outp: str) -> dict:
    return {
        "intermediate": _pt_linear(d, f"{inter}.dense"),
        "output": {
            "dense": _pt_linear(d, f"{outp}.dense"),
            "LayerNorm": _pt_ln(d, f"{outp}.LayerNorm"),
        },
    }


def lxmert_from_torch(sd: FlatDict, lcfg: LxmertConfig) -> dict:
    """Normalized torch state_dict -> LXMERT params (KDDModel schema)."""
    d = normalize_torch_keys(sd)
    pfx = "bert." if any(k.startswith("bert.") for k in d) else ""

    emb = {
        "word_embeddings": _get(d, f"{pfx}embeddings.word_embeddings.weight"),
        "position_embeddings": _get(d, f"{pfx}embeddings.position_embeddings.weight"),
        "token_type_embeddings": _get(d, f"{pfx}embeddings.token_type_embeddings.weight"),
        "LayerNorm": _pt_ln(d, f"{pfx}embeddings.LayerNorm"),
    }
    enc = f"{pfx}encoder"
    layer = _stack_layers([_pt_bert_layer(d, f"{enc}.layer.{i}") for i in range(lcfg.l_layers)])
    r_layers = _stack_layers(
        [_pt_bert_layer(d, f"{enc}.r_layers.{i}") for i in range(lcfg.r_layers)]
    )
    x_layers = []
    for i in range(lcfg.x_layers):
        b = f"{enc}.x_layers.{i}"
        x_layers.append(
            {
                "visual_attention": _pt_att(d, f"{b}.visual_attention", att="att"),
                "lang_self_att": _pt_att(d, f"{b}.lang_self_att"),
                "visn_self_att": _pt_att(d, f"{b}.visn_self_att"),
                "lang_ffn": _pt_ffn(d, f"{b}.lang_inter", f"{b}.lang_output"),
                "visn_ffn": _pt_ffn(d, f"{b}.visn_inter", f"{b}.visn_output"),
            }
        )
    label_conv_w = _get(d, f"{enc}.visn_fc.label_conv.weight")  # [1, 8, 1, 1]
    visn_fc = {
        "visn_fc": _pt_linear(d, f"{enc}.visn_fc.visn_fc"),
        "visn_layer_norm": _pt_ln(d, f"{enc}.visn_fc.visn_layer_norm"),
        "box_fc": _pt_linear(d, f"{enc}.visn_fc.box_fc"),
        "box_layer_norm": _pt_ln(d, f"{enc}.visn_fc.box_layer_norm"),
        "label_conv": {
            "weights": label_conv_w.reshape(-1),
            "biases": _get(d, f"{enc}.visn_fc.label_conv.bias"),
        },
        "label_fc": _pt_linear(d, f"{enc}.visn_fc.label_fc"),
        "label_layer_norm": _pt_ln(d, f"{enc}.visn_fc.label_layer_norm"),
    }
    params = {
        "bert": {
            "embeddings": emb,
            "encoder": {
                "layer": layer,
                "r_layers": r_layers,
                "x_layers": _stack_layers(x_layers),
                "visn_fc": visn_fc,
            },
            "pooler": {"dense": _pt_linear(d, f"{pfx}pooler.dense")},
        },
    }
    # heads live outside the bert prefix in KDDModel
    if "logit_fc.0.weight" in d:
        params["logit_fc"] = {
            "fc1": _pt_linear(d, "logit_fc.0"),
            "LayerNorm": _pt_ln(d, "logit_fc.2"),
            "fc2": _pt_linear(d, "logit_fc.3"),
        }
    if "logit_W" in d:
        params["logit_W"] = _get(d, "logit_W")
    if "cls.seq_relationship.weight" in d:
        params["cls"] = {
            "seq_relationship": _pt_linear(d, "cls.seq_relationship"),
            "predictions": {
                "transform": {
                    "dense": _pt_linear(d, "cls.predictions.transform.dense"),
                    "LayerNorm": _pt_ln(d, "cls.predictions.transform.LayerNorm"),
                },
                "output_bias": _get(d, "cls.predictions.bias"),
            },
        }
    return params
