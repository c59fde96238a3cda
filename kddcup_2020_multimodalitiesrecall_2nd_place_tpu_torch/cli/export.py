"""Export a model and its weights as an AOT serving artifact (the port of the
JAX package's ``scripts/export.py``): the scoring computation traced once by
``torch.export``, weights baked in, reloaded without model Python.

Example:

  python -m kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.export \\
      --model imagebert_a --checkpoint a.npz --batch-size 512 --out artifacts/a/
  # later, to score with it:
  #   from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.serving import load_scorer
  #   scorer = load_scorer("artifacts/a"); scores = scorer(feats)

``--checkpoint`` takes the formats ``cli/score.py`` takes (an npz tree or
flat-variable npz, a torch ``.pth``, a TF1 bundle prefix); without one the
parameters are random (seed 0). A distilled student's shape comes from the
``student_config.json`` beside the checkpoint unless ``--config-overrides``
is given, as in ``cli/score.py``. The weights are prepared as ``ScoringEngine``
prepares them (matmul kernels cast to the compute dtype), so an artifact
scores as the engine does. ``--backend pallas_packed`` traces the fused
blocks' CUDA kernels as custom ops (``ops/library.py``), which the loading
process registers; ``xla`` (the default) traces plain operators only.

``--quantize int8|int8-ffn`` exports the int8 serving tree (``ops/quant.py``,
as the JAX script makes it, ``scripts/export.py`` :126-151): every dense but
the ``cls`` heads, or with ``int8-ffn`` only the FFN denses, as int8 weights
with per-channel scales and a dynamic per-row activation quant
(``torch._int_mm``); under bf16 the remaining leaves are cast to bf16 but
the scales and ``cls``; ``meta.json`` records the mode. An int8 attention or
FFN node takes the unfused route, so under ``--backend pallas_packed``
``int8-ffn`` keeps the attention-block kernels and ``int8`` runs none.

``--model two_tower --side query|product`` exports one embedder of the
recall towers (``serving.export_tower``: [B, D] unit embeddings; the
checkpoint a two-tower npz tree), as the JAX script does: ``--side`` is
required, ``--quantize`` is refused, and the backend is ``xla``, which the
JAX package pins for the towers. On the card that backend's encoder blocks
are plain PyTorch operators; in bf16 the label conv and the projection run
``gemm_bf16`` (the ``kmr::gemm`` custom op, listed in ``meta.json``).
"""

from __future__ import annotations

import argparse
import json

import torch

from ..models import Precision, get_model
from ..parallel import resolve_device
from ..parallel.engine import default_precision
from ..serving import export_scorer, export_tower, save_scorer
from ..checkpoint import load_checkpoint
from ..ops.quant import quantize_for_serving
from .score import load_student_overrides


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True,
                    choices=["imagebert_a", "imagebert_b", "imagebert_c", "lxmert", "two_tower"])
    ap.add_argument("--side", choices=["query", "product"], default=None,
                    help="two_tower only: which embedder to export")
    ap.add_argument("--checkpoint", default=None,
                    help="npz / TF1 bundle prefix / torch state dict (random init if absent)")
    ap.add_argument("--batch-size", type=int, default=8192,
                    help="0 = batch-polymorphic artifact (a symbolic leading dim; any batch size)")
    ap.add_argument("--precision", choices=["f32", "bf16"], default=None,
                    help="default: bf16 on cuda, f32 on cpu")
    ap.add_argument("--backend", choices=["xla", "pallas_packed"], default="xla",
                    help="xla = plain operators; pallas_packed = the CUDA kernels as custom ops")
    ap.add_argument("--config-overrides", default=None,
                    help='JSON model-config overrides, e.g. \'{"num_hidden_layers": 4}\' (read from '
                         'student_config.json beside --checkpoint when absent)')
    ap.add_argument("--quantize", choices=["int8", "int8-ffn"], default=None,
                    help="int8 serving weights (ops/quant.py): int8 quantises every dense but the cls heads, "
                         "int8-ffn only the FFN denses; under bf16 the other leaves are cast to bf16")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.model == "two_tower":
        if args.side is None:
            ap.error("--side query|product is required for two_tower")
        if args.quantize:
            ap.error("--quantize is not supported for two_tower embedders")
        if args.backend != "xla":
            ap.error("two_tower embedders export with the xla backend only")

    device = resolve_device(args.device)
    overrides = (json.loads(args.config_overrides) if args.config_overrides
                 else load_student_overrides(args.checkpoint))
    spec = get_model(args.model, overrides=overrides)
    params = load_checkpoint(args.model, args.checkpoint, spec)
    prec = {"f32": Precision.f32, "bf16": Precision.bf16}[args.precision]() if args.precision \
        else default_precision(device)
    bsz = None if args.batch_size == 0 else args.batch_size
    extra = {"precision": "f32" if prec.compute_dtype == torch.float32 else "bf16"}
    if args.quantize:
        params = quantize_for_serving(spec, params, args.quantize, bf16_residual=prec.compute_dtype == torch.bfloat16)
        extra["quantize"] = args.quantize
    if overrides:
        extra["config_overrides"] = overrides
    if args.model == "two_tower":
        exported = export_tower(spec, params, args.side, bsz, precision=prec, device=device)
        meta = save_scorer(args.out, exported, f"two_tower_{args.side}", bsz, "xla", extra=extra)
    else:
        exported = export_scorer(spec, params, bsz, precision=prec, backend=args.backend, device=device)
        meta = save_scorer(args.out, exported, spec, bsz, args.backend, extra=extra)
    print(json.dumps({**meta, "out": args.out}))


if __name__ == "__main__":
    main()
