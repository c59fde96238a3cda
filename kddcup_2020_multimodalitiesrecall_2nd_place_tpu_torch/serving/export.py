"""AOT serving export: compile-once, deploy-without-model-code artifacts (the
port of the JAX package's ``serving/export.py``).

The reference "deployed" a model by rebuilding its TF graph and restoring a
checkpoint inside every predict script
(``imagebert_lds/src/run_pretraining_predict_score.py:522-593``). Here the
scoring computation (the same ``spec.apply`` that ``ScoringEngine`` runs) is
traced once by ``torch.export`` into an ``ExportedProgram``, saved as a
``.pt2`` file beside a ``meta.json``, and reloaded by :func:`load_scorer`
without any model Python: weights baked in, like a frozen graph.

* **Weights are baked in**: the param tree, prepared as the engine prepares
  it (no MLM head, matmul kernels cast to the compute dtype, on the export's device), is
  held by the traced module as buffers. One artifact = one (model, weights,
  batch size, device) tuple.
* **The "xla" attention backend is the default export path**: plain PyTorch
  operators only, portable wherever the same torch loads. With
  ``backend="pallas_packed"`` the fused blocks' hand-written kernels are
  traced as the ``kmr::`` custom ops of ``ops/library.py``, which the loading
  process must register, as a JAX ``pallas_packed`` artifact is pinned to its
  compiler. ``meta.json`` lists the custom ops an artifact calls.
* **Fixed batch size**: serving pads the tail batch, as the engine does;
  ``batch_size=None`` traces a symbolic batch instead (any size, no padding).
* **The two-tower embedders** (``export_tower``): the query or the product
  tower alone, the recall stage that the cross-encoder artifacts rerank
  after, on the "xla" backend as the JAX package pins it. On the card that
  backend's encoder blocks are plain PyTorch operators (cuBLAS products,
  ``ops/attention.py:mha_xla``); in bf16 the label conv and the projection
  are still ``gemm_bf16`` through the ``kmr::gemm`` custom op, as under every
  backend, which ``meta.json`` lists.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

BLOB = "scorer.pt2"
META = "meta.json"
# torch.export specialises a dimension that is 0 or 1 in the example inputs,
# so a symbolic batch is traced at this size
TRACE_BATCH = 2
CUSTOM_OP_NAMESPACE = "kmr"


class _Scorer(torch.nn.Module):
    """``spec.apply(params, feats)["score"]``, or with ``side`` a two-tower
    spec's query or product embedding, with the param tree held as buffers
    (named by their tree path, ``__``-joined)."""

    def __init__(self, spec, params, precision, side: str | None = None):
        super().__init__()
        self.spec, self.precision, self.side = spec, precision, side
        self.paths = []
        stack = [((), params)]
        while stack:
            path, node = stack.pop()
            if isinstance(node, dict):
                stack.extend(((*path, k), v) for k, v in node.items())
            else:
                self.register_buffer("__".join(path), node)
                self.paths.append(path)

    def forward(self, feats: dict[str, torch.Tensor]) -> torch.Tensor:
        tree: dict = {}
        for path in self.paths:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = getattr(self, "__".join(path))
        if self.side is not None:
            from ..models import two_tower

            return two_tower.SIDES[self.side][0](tree, feats, self.spec.config, self.precision)
        return self.spec.apply(tree, feats, self.spec.config, self.precision)["score"]


def _export(module, example: dict, batch_size: int | None, backend: str):
    dynamic = None
    if batch_size is None:
        batch = torch.export.Dim("batch")
        dynamic = ({k: {0: batch} for k in example},)
    from ..ops.attention import attention_backend

    with attention_backend(backend), torch.no_grad():
        return torch.export.export(module, (example,), dynamic_shapes=dynamic)


def _prepared(spec, params, precision, device):
    from ..checkpoint.npz import cast_matmul_weights, scoring_params, tree_to

    return tree_to(cast_matmul_weights(scoring_params(params), precision.compute_dtype, spec.matmul_kernels), device)


def export_scorer(spec, params, batch_size: int | None, precision=None, backend: str = "xla", device=None):
    """Export ``spec``'s scoring function with ``params`` (the float32 tree
    that ``ScoringEngine`` takes) baked in -> ``torch.export.ExportedProgram``.

    ``batch_size``: the fixed batch, or None for a batch-polymorphic artifact.
    ``precision``: default bf16 on CUDA, f32 on the CPU (the engine's).
    ``backend``: the attention backend traced into the artifact ("xla", the
    portable default, or "pallas_packed", the kernels as custom ops).
    ``device``: default CUDA, as every entry point of the port."""
    from ..data.batchspec import batch_spec
    from ..ops.attention import BACKENDS
    from ..parallel.engine import default_precision, resolve_device

    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}, expected one of {BACKENDS}")
    device = resolve_device(device)
    precision = precision if precision is not None else default_precision(device)
    if backend != "xla":
        from ..ops import library  # noqa: F401  (the kernels as custom ops)
    module = _Scorer(spec, _prepared(spec, params, precision, device), precision).eval()
    specs = batch_spec(spec.name, spec.config, TRACE_BATCH if batch_size is None else batch_size)
    example = {k: torch.zeros(shape, dtype=torch.from_numpy(np.zeros(0, dt)).dtype, device=device)
               for k, (shape, dt) in specs.items()}
    return _export(module, example, batch_size, backend)


# each tower embedder's parameters (the product tower's label conv reads the word embeddings), and its features:
# trailing shape and dtype (the JAX package's export_tower)
TOWER_PARAMS = {"query": ("bert", "query_encoder", "query_proj"),
                "product": ("bert", "kdd_conv1", "kdd_dense1", "kdd_conv2", "product_encoder", "product_proj")}
TOWER_FEATURES = {
    "query": {"input_ids": ((20,), torch.int32), "len_query": ((), torch.int32)},
    "product": {"boxes": ((10, 5), torch.float32), "features": ((10, 2048), torch.float32),
                "label_ids": ((10, 8), torch.int32), "num_boxes": ((), torch.int32)},
}


def export_tower(spec, params, side: str, batch_size: int | None, precision=None, device=None):
    """Export one embedder of a two-tower ``spec`` (the cascade's recall stage)
    with ``params`` baked in -> ``torch.export.ExportedProgram``: ``side``
    "query" embeds input_ids [B, 20] and len_query [B], "product" embeds
    boxes, features, label_ids and num_boxes (what ``cli/recall.py build``
    streams through the product tower), each to [B, D] unit embeddings. Traced
    on the "xla" backend whatever the global one is, as the JAX package's
    ``export_tower`` pins it. ``batch_size`` None: batch-polymorphic. Only
    the side's own parameters are baked in."""
    from ..parallel.engine import default_precision, resolve_device

    if side not in TOWER_FEATURES:
        raise ValueError(f"side must be 'query' or 'product', got {side!r}")
    device = resolve_device(device)
    precision = precision if precision is not None else default_precision(device)
    prepared = _prepared(spec, params, precision, device)
    module = _Scorer(spec, {k: prepared[k] for k in TOWER_PARAMS[side]}, precision, side=side).eval()
    b = TRACE_BATCH if batch_size is None else batch_size
    example = {k: torch.zeros((b, *shape), dtype=dt, device=device) for k, (shape, dt) in TOWER_FEATURES[side].items()}
    return _export(module, example, batch_size, "xla")


def custom_ops_of(exported) -> list[str]:
    """The ``kmr::`` custom ops an exported program calls."""
    return sorted({n.target.name() for n in exported.graph.nodes
                   if n.op == "call_function" and getattr(n.target, "namespace", None) == CUSTOM_OP_NAMESPACE})


def save_scorer(out_dir, exported, spec, batch_size: int | None, backend: str, extra: dict | None = None) -> dict:
    """Write the ``.pt2`` artifact and its ``meta.json``; returns the meta.
    ``spec``: a ModelSpec, or a tower embedder's name (``two_tower_query``,
    ``two_tower_product``). ``extra``: more meta fields (e.g. config overrides)."""
    from ..data.batchspec import batch_spec

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    torch.export.save(exported, out / BLOB)
    buffers = list(exported.state_dict.values())
    if isinstance(spec, str):
        name, keys = spec, TOWER_FEATURES[spec.removeprefix("two_tower_")]
    else:
        name, keys = spec.name, batch_spec(spec.name, spec.config, 1)
    meta = {
        "model": name,
        "batch_size": batch_size,
        "attention_backend": backend,
        "torch_version": torch.__version__,
        "device": str(buffers[0].device) if buffers else "cpu",
        "feature_keys": sorted(keys),
        "custom_ops": custom_ops_of(exported),
        **(extra or {}),
    }
    (out / META).write_text(json.dumps(meta, indent=1))
    return meta


@dataclass
class ServingScorer:
    """A reloaded artifact: ``scores = scorer(feats)`` (a tower embedder's:
    embeddings [B, D]), with tail padding."""

    exported: object
    meta: dict

    def __post_init__(self):
        self.module = self.exported.module()

    @property
    def batch_size(self) -> int | None:
        """The artifact's fixed batch size, or None for batch-polymorphic."""
        b = self.meta["batch_size"]
        return None if b is None else int(b)

    @property
    def feature_keys(self) -> set[str]:
        """The feature-dict keys the artifact was traced with."""
        return set(self.meta["feature_keys"])

    def __call__(self, feats: dict) -> np.ndarray:
        want = self.feature_keys
        if set(feats) != want:  # a readable error instead of a pytree mismatch
            raise ValueError(
                f"artifact expects feature keys {sorted(want)}; missing {sorted(want - set(feats))}, "
                f"unexpected {sorted(set(feats) - want)}"
            )
        device = torch.device(self.meta["device"])
        tensors = {k: torch.as_tensor(v).to(device) for k, v in feats.items()}
        n = next(iter(tensors.values())).shape[0]
        b = self.batch_size
        if b is not None:
            if n > b:
                raise ValueError(f"batch {n} exceeds artifact batch size {b}")
            if n < b:  # pad the tail batch, as ScoringEngine does
                tensors = {k: torch.cat([v, v.new_zeros(b - n, *v.shape[1:])]) for k, v in tensors.items()}
        with torch.inference_mode():
            scores = self.module(tensors)
        return scores.float().cpu().numpy()[:n]


def load_scorer(artifact_dir) -> ServingScorer:
    """Reload an artifact. It imports no model module; an artifact that calls
    the kernels' custom ops imports ``ops/library.py``, which registers them."""
    d = Path(artifact_dir)
    meta = json.loads((d / META).read_text())
    if meta["custom_ops"]:
        from ..ops import library  # noqa: F401
    return ServingScorer(exported=torch.export.load(d / BLOB), meta=meta)
