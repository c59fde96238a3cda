"""Materialise training instances into packed memory-mapped shards (the port
of the JAX package's ``scripts/build_packed.py``, same flags).

Runs the model's hard-negative sampler (``data/sampling.py``, seeded by
``--seed``: A's recipe with MLM-masked query ids, B's with word-match
targets, C's on sen2forest-rewritten queries) ONCE over the train TSVs and
writes per-field ``.npy`` shards and a ``manifest.json``
(``data/packed.py``, the JAX package's format byte for byte), which
``cli/train.py --packed-dir`` and the JAX package's ``scripts/train.py
--packed-dir`` both read. Host only: it touches no GPU. Example:

  python -m kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.build_packed \\
      --model imagebert_b --train-tsv train.tsv --labels multimodal_labels.txt \\
      --query-labels query_labels.txt --out packed/b --shard-size 65536

Prints one JSON line: the directory, instances, shards, fields, the seconds
the drain took, instances/s and the bytes written.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from .. import VOCAB_PATH
from ..data import Featurizer, HardNegativeSampler, QueryLabelIndex, SamplerConfig, load_multimodal_labels
from ..data import write_packed_shards
from ..models import get_model
from ..tokenization import FullTokenizer


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True, choices=["imagebert_a", "imagebert_b", "imagebert_c"])
    ap.add_argument("--train-tsv", required=True, nargs="+")
    ap.add_argument("--labels", required=True, help="multimodal_labels.txt")
    ap.add_argument("--query-labels", required=True, help="query_labels.txt for hard-negative mining")
    ap.add_argument("--out", required=True)
    ap.add_argument("--shard-size", type=int, default=65536)
    ap.add_argument("--max-instances", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--feature-dtype", default="float16", choices=["float16", "float32"],
                    help="on-disk dtype of the 2048-dim RoI features (cast to float32 when a batch is assembled)")
    args = ap.parse_args(argv)

    spec = get_model(args.model)
    featurizer = Featurizer(FullTokenizer.google_style(VOCAB_PATH), load_multimodal_labels(args.labels),
                            sen2forest=spec.sen2forest)
    sampler_cfg = (SamplerConfig.imagebert_a(args.seed) if spec.name == "imagebert_a"
                   else SamplerConfig.imagebert_b(args.seed))
    sampler = HardNegativeSampler(featurizer, QueryLabelIndex.load(args.query_labels), sampler_cfg)

    def lines():
        for path in args.train_tsv:
            with open(path, "r", encoding="utf-8") as f:
                yield from f

    t0 = time.perf_counter()
    manifest = write_packed_shards(sampler.examples(lines()), args.out, shard_size=args.shard_size,
                                   feature_dtype=np.dtype(args.feature_dtype), max_instances=args.max_instances)
    seconds = time.perf_counter() - t0
    n = manifest["num_instances"]
    report = {"out": args.out, "num_instances": n, "shards": len(manifest["shard_sizes"]),
              "fields": sorted(manifest["fields"]), "seconds": seconds,
              "instances_per_second": n / seconds if seconds > 0 else 0.0,
              "bytes": sum(p.stat().st_size for p in Path(args.out).iterdir())}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
