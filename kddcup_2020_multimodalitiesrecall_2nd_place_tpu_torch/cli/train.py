"""Train ImageBERT-A, -B or -C with hard-negative sampling (the port of the
JAX package's ``scripts/train.py``, with the flags its cross-encoder paths use).

Each step samples a batch of (positive, mined negative) pairs from the TSV
files (``data/sampling.py``, seeded by ``--seed``: A's recipe with MLM-masked
query ids; B's with word-match targets, and for C the sen2forest query
rewrite), runs one ``Trainer`` step (A: BERT-Adam, global-norm clip 1.0, NSP
loss, + ``--ms-weight`` times the Multi-Similarity loss; B/C: Adam on the
0.94/2500 staircase, per-value clip 1.0, AM loss, + ``--word-match-weight``
times the word-match loss, EMA 0.997), writes a JSON line of its metrics to
``<out>/metrics.jsonl`` every 20 steps, and ``<out>/step_<N>.npz`` (the JAX
package's param tree, the EMA shadows where the recipe keeps them, loadable
by ``cli/score.py`` and ``scripts/score.py``) every ``--checkpoint-every``
steps and at the end. Runs on the card by default (bf16, the kernels of the
train blocks); ``--device cpu`` runs the plain versions in f32. Example:

  python -m kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.train \\
      --model imagebert_b --train-tsv train.tsv --labels multimodal_labels.txt \\
      --query-labels query_labels.txt --steps 1000 --batch-size 256 --out runs/b

``--model two_tower``, ``--packed-dir``, ``--distributed``,
``--resume``/``--init-from``, ``--distill-from``, ``--valid-tsv`` and
``--mlm-weight`` are not ported yet and exit 2 naming the ROADMAP item.
LXMERT trains through ``train.Trainer`` (as the JAX package trains it, on
batches in its featurizer's layout), not here: the JAX CLI cannot train it
either (no sampler yields LXMERT's layout, ROADMAP.md Queue 3, JAX fault 3),
so ``--model lxmert`` exits 2 until that sampler exists.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import sys
import time
from pathlib import Path

import torch

from .. import VOCAB_PATH
from ..checkpoint import params_to_jax, save_npz
from ..data import Featurizer, HardNegativeSampler, QueryLabelIndex, SamplerConfig, load_multimodal_labels
from ..data import pad_batch, stack_examples
from ..models import get_model
from ..parallel import resolve_device
from ..tokenization import FullTokenizer
from ..train import Trainer, TrainState, recipe_for

LOG_EVERY = 20
# flags of scripts/train.py that are not ported: flag -> the ROADMAP item that ports it
NOT_PORTED = {
    "--packed-dir": "Queue 1 item 9c (data/packed.py)",
    "--distributed": "Queue 1 item 12 (multi-device)",
    "--resume": "Queue 1 item 9c (resumable train state)",
    "--init-from": "Queue 1 item 10 (depth-mapped init)",
    "--distill-from": "Queue 1 item 10 (distillation)",
    "--valid-tsv": "Queue 1 item 9c (the training-time valid loop)",
}


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of one step, a deterministic function of --seed."""
    return (seed + 1) * 1_000_003 + step


def run(argv: list[str] | None = None) -> tuple[Trainer, TrainState, dict]:
    """Parse ``argv`` and train; -> the trainer, its final state and the run's report."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True,
                    choices=["imagebert_a", "imagebert_b", "imagebert_c", "lxmert", "two_tower"])
    ap.add_argument("--train-tsv", nargs="+", default=None)
    ap.add_argument("--labels", required=True, help="multimodal_labels.txt")
    ap.add_argument("--query-labels", default=None, help="query_labels.txt for hard-negative mining")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=None, help="override the recipe learning rate")
    ap.add_argument("--warmup-steps", type=int, default=None, help="override the recipe warmup length")
    ap.add_argument("--total-steps", type=int, default=None,
                    help="override the decay horizon of the polynomial schedule (recipe: 100k)")
    ap.add_argument("--ms-weight", type=float, default=0.0,
                    help="Multi-Similarity loss weight (A's MS-loss fine-tune)")
    ap.add_argument("--word-match-weight", type=float, default=0.0,
                    help="ImageBERT-B/C word-match loss weight (0 = off, as the reference trained)")
    ap.add_argument("--mlm-weight", type=float, default=0.0, help="auxiliary MLM loss weight (not yet ported)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--checkpoint-every", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    for flag in NOT_PORTED:
        ap.add_argument(flag, default=None, nargs="?", const=True)
    args = ap.parse_args(argv)
    for flag, item in NOT_PORTED.items():
        if getattr(args, flag.lstrip("-").replace("-", "_")) is not None:
            ap.error(f"{flag} is not yet ported, see ROADMAP.md {item}")
    if args.mlm_weight:
        ap.error("--mlm-weight (the MLM head) is not yet ported, see ROADMAP.md Queue 1 item 9c")
    if args.model == "lxmert":
        ap.error("--model lxmert: no sampler yields LXMERT's batch layout, in the JAX package either "
                 "(ROADMAP.md Queue 3, JAX fault 3); LXMERT trains through train.Trainer")
    if args.model == "two_tower":
        ap.error("training two_tower is not yet ported, see ROADMAP.md Queue 1 item 11")
    if not args.train_tsv:
        ap.error("--train-tsv is required")
    if not args.query_labels:
        ap.error("--query-labels is required for cross-encoder training")

    device = resolve_device(args.device)
    spec = get_model(args.model)
    featurizer = Featurizer(FullTokenizer.google_style(VOCAB_PATH), load_multimodal_labels(args.labels),
                            sen2forest=spec.sen2forest)
    sampler_cfg = (SamplerConfig.imagebert_a(args.seed) if spec.name == "imagebert_a"
                   else SamplerConfig.imagebert_b(args.seed))
    sampler = HardNegativeSampler(featurizer, QueryLabelIndex.load(args.query_labels), sampler_cfg)
    overrides = {"ms_loss_weight": args.ms_weight, "word_match_loss_weight": args.word_match_weight}
    for name, value in (("learning_rate", args.lr), ("num_warmup_steps", args.warmup_steps),
                        ("num_train_steps", args.total_steps)):
        if value is not None:
            overrides[name] = value
    trainer = Trainer(spec, dataclasses.replace(recipe_for(spec.name), **overrides), device=device)
    state = trainer.init_state(seed=args.seed)

    def lines():
        for path in args.train_tsv:
            with open(path, "r", encoding="utf-8") as f:
                yield from f

    def batches():
        while True:  # epochs
            n_yielded, buf = 0, []
            for example in sampler.examples(lines()):
                buf.append(example)
                if len(buf) == args.batch_size:
                    n_yielded += 1
                    yield pad_batch(stack_examples(buf), args.batch_size)
                    buf = []
            if n_yielded == 0:
                raise SystemExit(f"no full {args.batch_size}-row batch from one pass over {args.train_tsv}: "
                                 "fewer usable rows than --batch-size")

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    pairs, save_seconds = 0, 0.0
    with open(out_dir / "metrics.jsonl", "a", encoding="utf-8") as metrics_file:
        for step, batch in enumerate(itertools.islice(batches(), args.steps)):
            metrics = trainer.train_step(state, batch, step_seed(args.seed, step))
            pairs += len(batch["labels"])
            if step % LOG_EVERY == 0:
                line = json.dumps({"step": step, **{k: float(v) for k, v in metrics.items()}})
                metrics_file.write(line + "\n")
                metrics_file.flush()
                print(line)
            if (step + 1) % args.checkpoint_every == 0 or step + 1 == args.steps:
                t_save = time.perf_counter()
                save_npz(out_dir / f"step_{step + 1}.npz", params_to_jax(trainer.eval_params(state)))
                save_seconds += time.perf_counter() - t_save
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0 - save_seconds  # sampling and training; checkpoint writes apart
    report = {"steps": state.step, "pairs": pairs, "seconds": seconds, "checkpoint_seconds": save_seconds,
              "pairs_per_second": pairs / seconds if seconds > 0 else 0.0, "device": str(device),
              "sampler": dataclasses.asdict(sampler.stats), "out": str(out_dir)}
    print(json.dumps(report))
    return trainer, state, report


def main(argv: list[str] | None = None) -> dict:
    return run(argv)[2]


if __name__ == "__main__":
    main(sys.argv[1:])
