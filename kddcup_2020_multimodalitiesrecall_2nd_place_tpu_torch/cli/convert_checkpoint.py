"""Convert a reference checkpoint (TF1 bundle or PyTorch ``.pth``) to an npz
param tree, the port of the JAX package's ``scripts/convert_checkpoint.py``
(the same flags, the same npz keys, the same report line). The npz loads in
the port's ``cli/score.py`` and the JAX package's ``scripts/score.py``:

  python -m kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.convert_checkpoint \\
      --model imagebert_a --checkpoint models/ImageBertKDD.ckpt-85002 --out a.npz
  python -m kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.convert_checkpoint \\
      --model imagebert_b \\
      --checkpoint models/model_attention_kdd_am_word_match_finetune_valid.ckpt-251 \\
      --out b.npz   # the EMA shadow weights, as evaluate_normal.py restores them
  python -m kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.convert_checkpoint \\
      --model lxmert --checkpoint models/BEST.pth --out lxmert.npz

Runs on the host only (numpy; torch only to read a ``.pth``).
"""

from __future__ import annotations

import argparse

import numpy as np

from ..checkpoint import (
    flatten_tree,
    imagebert_a_from_tf,
    imagebert_b_from_tf,
    lxmert_from_torch,
    read_tf_checkpoint,
    read_torch_state_dict,
    save_npz,
)
from ..models import get_model


def main(argv: list[str] | None = None) -> int:
    """-> the number of parameters written."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True, choices=["imagebert_a", "imagebert_b", "imagebert_c", "lxmert"])
    ap.add_argument("--checkpoint", required=True, help="TF bundle prefix (no .index suffix) or .pth path")
    ap.add_argument("--out", required=True, help="output .npz")
    ap.add_argument("--no-ema", action="store_true", help="for B/C: load raw variables instead of EMA shadows")
    args = ap.parse_args(argv)

    spec = get_model(args.model)
    if args.model == "lxmert":
        params = lxmert_from_torch(read_torch_state_dict(args.checkpoint), spec.config)
    else:
        flat = read_tf_checkpoint(args.checkpoint)
        if args.model == "imagebert_a":
            params = imagebert_a_from_tf(flat, spec.config)
        else:
            params = imagebert_b_from_tf(flat, spec.config, ema=not args.no_ema)
    save_npz(args.out, params)
    n = sum(int(np.prod(np.shape(x))) for x in flatten_tree(params).values())
    print(f"wrote {args.out}: {n:,} parameters")
    return n


if __name__ == "__main__":
    main()
