"""Train ImageBERT-A, -B or -C with hard-negative sampling, or the two-tower
recall model on positive rows (the port of the JAX package's
``scripts/train.py``).

Each step takes a batch of (positive, mined negative) pairs, either sampled
from the TSV files as the run goes (``--train-tsv``: ``data/sampling.py``,
seeded by ``--seed``: A's recipe with MLM-masked query ids; B's with
word-match targets, and for C the sen2forest query rewrite) or read from
shards that ``cli/build_packed.py`` drained from the same sampler once
(``--packed-dir``: ``data/packed.py``, shuffled per epoch from ``--seed``,
the float16 features cast to float32 on the host). ``Trainer.to_device``
moves the word-match entries only with ``--word-match-weight`` and the
masked-LM entries only with ``--mlm-weight``, as the JAX script filters them.
Then one ``Trainer`` step (A: BERT-Adam, global-norm clip 1.0, NSP loss, +
``--ms-weight`` times the Multi-Similarity loss, + ``--mlm-weight`` times the
tied-embedding MLM loss; B/C: Adam on the 0.94/2500 staircase, per-value clip
1.0, AM loss, + ``--word-match-weight`` times the word-match loss, EMA 0.997;
``--optimizer`` overrides the recipe's). Every 20 steps a JSON line of the
metrics goes to ``<out>/metrics.jsonl`` (with ``--grad-summaries``, each
parameter group's gradient norm before and after the clip); every
``--checkpoint-every`` steps and at the end, ``<out>/step_<N>.npz`` (the JAX
package's param tree, the EMA shadows where the recipe keeps them, loadable
by ``cli/score.py`` and ``scripts/score.py``) and ``<out>/state_<N>.npz``
(the resumable state, ``Trainer.save_state``).

``--valid-tsv``/``--answers`` score the eval weights through one
``ScoringEngine`` every ``--valid-every`` steps and at the end, log
``valid_ndcg5`` and keep the best as ``<out>/best.npz`` (the JAX tree) and
``<out>/best_metadata.json`` (the reference's finetune_valid workflow; a
resumed run into the same ``--out`` starts from the best recorded there).
``--resume state_<N>.npz`` continues that run: the step count, the LR
schedule, the dropout seeds, the log and checkpoint steps and the batch
stream follow the resumed step (``--packed-dir`` skips the batches already
trained by index, reading none of them; ``--train-tsv`` samples them again);
``--steps`` is the number of steps this invocation runs.

Runs on the card by default (bf16, the kernels of the train blocks and, in
the valid pass, of the scoring blocks); ``--device cpu`` runs the plain
versions in f32. Example:

  python -m kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.train \\
      --model imagebert_b --train-tsv train.tsv --labels multimodal_labels.txt \\
      --query-labels query_labels.txt --steps 1000 --batch-size 256 --out runs/b

``--layers L`` trains an L-layer variant of the model (a distillation student,
or one stage of a progressive-stacking schedule) and writes its shape to
``<out>/student_config.json``, where ``cli/score.py`` and ``cli/export.py``
find it beside ``step_<N>.npz`` and ``best.npz``. ``--init-from <ckpt>``
starts from a checkpoint of the same family at any depth, in any format
``cli/score.py`` reads (the port's ``step_<N>.npz`` and ``best.npz`` are the
counterparts of the JAX script's orbax directories): a deeper one is
compressed to evenly spaced layers, a shallower one grown by duplicating each
layer into a contiguous run (``train/distill.py:init_student_from_teacher``);
the optimizer state, and B/C's EMA, start fresh from those params.
``--distill-from <ckpt>`` scores every batch with a live teacher of the same
family (``train/distill.py:LiveTeacher``: on the card the scoring blocks'
kernels, in bf16, fed label 1) and trains on ``--hard-loss-weight`` times the
family's loss plus ``--distill-weight`` times the soft cross entropy at
``--distill-temperature`` (``distill_loss`` in the metrics; a hard-loss weight
of 0 is pure-soft distillation). ``--resume`` with ``--init-from``,
``--layers`` with ``--model lxmert`` and ``--distill-from`` with
``--model two_tower`` exit 2, as in the JAX script.

``--model two_tower`` trains the recall towers with in-batch negatives: the
rows of ``--train-tsv`` in ImageBERT-B's layout, as they come (each a
positive pair; no sampler, so no ``--query-labels``), in batches of
``--batch-size`` with the ragged tail of each pass dropped, and the rows'
``query_id`` as the ``query_group`` that keeps one query's products out of
each other's negatives; the two-tower recipe (BERT-Adam at 1e-4, 1000 warmup
steps, global-norm clip, the contrastive loss; ``loss`` and
``in_batch_accuracy`` in the metrics). Its ``step_<N>.npz`` is what
``cli/recall.py`` and ``cli/cascade.py`` load; ``--valid-tsv`` scores the
pairs' cosines. ``--packed-dir`` and ``--distill-from`` exit 2 for it, as in
the JAX script.

``--distributed`` trains data-parallel on ``torch.distributed``
(``parallel/distributed.py``, the process group from ``torchrun``'s
environment; NCCL on ``cuda``, gloo on ``cpu``), as the JAX script's
multi-host mode: ``--batch-size`` stays global, each rank reads its slice of
``--train-tsv`` (files dealt round-robin, or every file's lines strided when
there are fewer files than ranks) or its share of ``--packed-dir``'s
instances, and contributes ``--batch-size / world`` rows a step; the
``Trainer`` all-reduces the gradients and the metrics, and only rank 0 logs,
writes checkpoints and runs the valid pass. Example, two ranks on one host:

  torchrun --standalone --nproc_per_node 2 -m \
      kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.train --distributed \
      --model imagebert_a --packed-dir packed_a --labels multimodal_labels.txt --steps 1000 \
      --batch-size 512 --out runs/a

``--am-loss`` is not ported yet and exits 2 naming the ROADMAP item. LXMERT trains through
``train.Trainer`` (as the JAX package trains it, on batches in its
featurizer's layout) or ``cli/distill.py``, not here: the JAX CLI cannot
train it either (no sampler yields LXMERT's layout, ROADMAP.md Queue 3, JAX
fault 3), so ``--model lxmert`` exits 2 until that sampler exists.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import VOCAB_PATH
from ..checkpoint import load_checkpoint, params_from_jax, params_to_jax, save_npz
from ..data import Featurizer, HardNegativeSampler, PackedDataset, QueryLabelIndex, SamplerConfig
from ..data import iter_batches, load_multimodal_labels, pad_batch, stack_examples
from ..eval import evaluate_scores, load_answers
from ..models import get_model
from ..parallel import ScoringEngine, resolve_device
from ..parallel.distributed import local_rows, maybe_initialize, process_count, process_index, process_shard
from ..parallel.distributed import TORCHRUN_ENV, stride_lines
from ..tokenization import FullTokenizer
from ..train import LiveTeacher, Trainer, TrainState, init_student_from_teacher, recipe_for
from .score import load_student_overrides

LOG_EVERY = 20
# flags of scripts/train.py that are not ported: flag -> the ROADMAP item that ports it
NOT_PORTED = {
    "--am-loss": "Queue 3, JAX fault 3 (LXMERT's training CLI)",
}


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of one step, a deterministic function of --seed and the run's global step."""
    return (seed + 1) * 1_000_003 + step


def run(argv: list[str] | None = None) -> tuple[Trainer, TrainState, dict]:
    """Parse ``argv`` and train; -> the trainer, its final state and the run's report."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True,
                    choices=["imagebert_a", "imagebert_b", "imagebert_c", "lxmert", "two_tower"])
    ap.add_argument("--train-tsv", nargs="+", default=None)
    ap.add_argument("--packed-dir", default=None, help="a shard directory of cli/build_packed.py (or the JAX "
                    "package's scripts/build_packed.py), in place of --train-tsv")
    ap.add_argument("--labels", required=True, help="multimodal_labels.txt")
    ap.add_argument("--query-labels", default=None, help="query_labels.txt for hard-negative mining (--train-tsv)")
    ap.add_argument("--steps", type=int, default=1000, help="steps this invocation runs")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=None, help="override the recipe learning rate")
    ap.add_argument("--warmup-steps", type=int, default=None, help="override the recipe warmup length")
    ap.add_argument("--total-steps", type=int, default=None,
                    help="override the decay horizon of the polynomial schedule (recipe: 100k)")
    ap.add_argument("--optimizer", default=None, choices=["bert_adamw", "adam_staircase"],
                    help="override the recipe optimizer (B/C: the staircase Adam, which assumes a pretrained init)")
    ap.add_argument("--ms-weight", type=float, default=0.0,
                    help="Multi-Similarity loss weight (A's MS-loss fine-tune)")
    ap.add_argument("--word-match-weight", type=float, default=0.0,
                    help="ImageBERT-B/C word-match loss weight (0 = off, as the reference trained)")
    ap.add_argument("--mlm-weight", type=float, default=0.0, help="ImageBERT-A's auxiliary MLM loss weight")
    ap.add_argument("--grad-summaries", action="store_true",
                    help="log each parameter group's gradient norm before and after the clip")
    ap.add_argument("--resume", default=None, help="a state_<N>.npz of an earlier run to continue")
    ap.add_argument("--init-from", default=None,
                    help="params checkpoint of the same family at ANY depth to start from (any format cli/score.py "
                         "reads): deeper ones compress to evenly spaced layers, shallower ones grow by duplicating "
                         "each layer into a contiguous run; the optimizer state starts fresh")
    ap.add_argument("--layers", type=int, default=None,
                    help="the encoder depth (num_hidden_layers), recorded in <out>/student_config.json")
    ap.add_argument("--distill-from", default=None,
                    help="a teacher checkpoint of the same family: online distillation, the teacher scores every "
                         "batch and the soft cross entropy joins the family's loss")
    ap.add_argument("--distill-weight", type=float, default=1.0, help="soft-loss weight with --distill-from")
    ap.add_argument("--distill-temperature", type=float, default=2.0)
    ap.add_argument("--hard-loss-weight", type=float, default=0.5,
                    help="the family's loss weight with --distill-from; 0 = pure-soft distillation")
    ap.add_argument("--valid-tsv", nargs="+", default=None,
                    help="valid TSVs: the training-time nDCG@5 loop and best.npz")
    ap.add_argument("--answers", default=None, help="valid_answer.json of --valid-tsv")
    ap.add_argument("--valid-every", type=int, default=0, help="steps between valid passes (0: at the end only)")
    ap.add_argument("--valid-batch-size", type=int, default=None, help="default: --batch-size")
    ap.add_argument("--out", required=True)
    ap.add_argument("--checkpoint-every", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--distributed", action="store_true",
                    help="data-parallel over the torch.distributed group of torchrun's environment "
                         "(--batch-size stays global)")
    for flag in NOT_PORTED:
        ap.add_argument(flag, default=None, nargs="?", const=True)
    args = ap.parse_args(argv)
    for flag, item in NOT_PORTED.items():
        if getattr(args, flag.lstrip("-").replace("-", "_")) is not None:
            ap.error(f"{flag} is not yet ported, see ROADMAP.md {item}")
    # the JAX script's checks, in its order
    if bool(args.valid_tsv) != bool(args.answers):
        ap.error("--valid-tsv and --answers must be given together")
    if args.resume and args.init_from:
        ap.error("--resume and --init-from are mutually exclusive: resume restores the full optimizer state, "
                 "init-from depth-maps params only")
    if args.layers is not None and args.model == "lxmert":
        ap.error("--layers targets single-stream depth; lxmert's three stack depths need cli/distill.py "
                 "--student-overrides")
    if args.distill_from and args.model == "two_tower":
        ap.error("--distill-from targets the cross-encoder scorers (the two_tower embedders have no teacher "
                 "probability to match)")
    if args.model == "lxmert":
        ap.error("--model lxmert: no sampler yields LXMERT's batch layout, in the JAX package either "
                 "(ROADMAP.md Queue 3, JAX fault 3); LXMERT trains through train.Trainer")
    if bool(args.train_tsv) == bool(args.packed_dir):
        ap.error("exactly one of --train-tsv / --packed-dir is required")
    if args.model == "two_tower" and args.packed_dir:
        ap.error("--packed-dir shards are pos/neg cross-encoder instances; the label-blind in-batch InfoNCE would "
                 "train hard negatives as positives -- two_tower trains on positive rows from --train-tsv")
    if args.train_tsv and not args.query_labels and args.model != "two_tower":
        ap.error("--query-labels is required for cross-encoder training")

    if args.distributed:
        missing = [k for k in TORCHRUN_ENV if k not in os.environ]
        if missing:
            ap.error(f"--distributed reads the process group from torchrun's environment; {missing} are not set")
        maybe_initialize(force=True, device=args.device)
    rank, world = process_index(), process_count()
    lead = rank == 0  # the rank that logs, writes checkpoints and runs the valid pass
    local_bs = local_rows(args.batch_size)
    train_files, line_stride = (process_shard(args.train_tsv) if args.train_tsv and world > 1
                                else (args.train_tsv, False))
    device = resolve_device(args.device)
    spec = get_model(args.model, overrides={"num_hidden_layers": args.layers} if args.layers else None)
    featurizer = Featurizer(FullTokenizer.google_style(VOCAB_PATH), load_multimodal_labels(args.labels),
                            sen2forest=spec.sen2forest)
    overrides = {"ms_loss_weight": args.ms_weight, "word_match_loss_weight": args.word_match_weight,
                 "mlm_loss_weight": args.mlm_weight, "grad_summaries": args.grad_summaries}
    for name, value in (("learning_rate", args.lr), ("num_warmup_steps", args.warmup_steps),
                        ("num_train_steps", args.total_steps), ("optimizer", args.optimizer)):
        if value is not None:
            overrides[name] = value
    if args.distill_from:
        overrides.update(distill_weight=args.distill_weight, distill_temperature=args.distill_temperature,
                         hard_loss_weight=args.hard_loss_weight)
    trainer = Trainer(spec, dataclasses.replace(recipe_for(spec.name), **overrides), device=device)
    if args.init_from:
        # the depth mapping runs on trees in the JAX package's layout; the optimizer state and the EMA
        # start from the mapped params
        loaded = load_checkpoint(args.model, args.init_from,
                                 get_model(args.model, overrides=load_student_overrides(args.init_from)))
        mapped = init_student_from_teacher(params_to_jax(spec.init_params(args.seed)), params_to_jax(loaded))
        state = trainer.init_state(spec.from_jax(params_from_jax(mapped)), seed=args.seed)
        if lead:
            print(f"initialised from {args.init_from} (depth-mapped)")
    else:
        state = trainer.init_state(seed=args.seed)
    if args.resume:
        trainer.load_state(state, args.resume)
        if lead:
            print(f"resumed from {args.resume} at step {state.step}")
    start = state.step
    live_teacher = None
    if args.distill_from:
        teacher_spec = get_model(args.model, overrides=load_student_overrides(args.distill_from))
        live_teacher = LiveTeacher(teacher_spec, load_checkpoint(args.model, args.distill_from, teacher_spec),
                                   device=device, precision=trainer.precision)
        if lead:
            print(f"online distillation from {args.distill_from} (soft {args.distill_weight} / hard "
                  f"{args.hard_loss_weight}, T={args.distill_temperature})")

    sampler = None
    if spec.name == "two_tower":
        batches = itertools.islice(positive_batches(featurizer, train_files, local_bs, line_stride), start, None)
    elif args.packed_dir:
        dataset = PackedDataset(args.packed_dir)
        missing = [k for k in (*spec.input_keys, "labels") if k not in dataset.fields]
        if missing:
            raise ValueError(f"{args.packed_dir} holds no {missing}, which {spec.name} reads: shards of another "
                             "model's sampler")
        if lead:
            print(f"packed dataset: {len(dataset)} instances")
        batches = dataset.batches(local_bs, epochs=None, seed=args.seed, skip=start, process_id=rank,
                                  process_count=world)
    else:
        sampler_cfg = (SamplerConfig.imagebert_a(args.seed) if spec.name == "imagebert_a"
                       else SamplerConfig.imagebert_b(args.seed))
        sampler = HardNegativeSampler(featurizer, QueryLabelIndex.load(args.query_labels), sampler_cfg)
        batches = itertools.islice(sampled_batches(sampler, train_files, local_bs, line_stride), start, None)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.layers is not None and lead:
        # the sidecar cli/distill.py writes: cli/score.py and cli/export.py rebuild the spec from it
        (out_dir / "student_config.json").write_text(
            json.dumps({"model": args.model, "overrides": {"num_hidden_layers": args.layers}}))
    answers = load_answers(args.answers) if args.answers and lead else None
    engine, best, valid_seconds, valid_passes = None, None, 0.0, []
    if args.resume and answers is not None and (out_dir / "best_metadata.json").exists():
        best = json.loads((out_dir / "best_metadata.json").read_text())  # the resumed run's best so far
    def clock() -> float:
        """The host clock after the device's queued work, so a timed span holds its own work only."""
        if device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    t0 = clock()
    pairs, save_seconds = 0, 0.0
    with open(out_dir / "metrics.jsonl", "a", encoding="utf-8") if lead else contextlib.nullcontext() as metrics_file:

        def log(line: dict) -> None:
            if not lead:
                return
            text = json.dumps(line)
            metrics_file.write(text + "\n")
            metrics_file.flush()
            print(text)

        for i, batch in enumerate(itertools.islice(batches, args.steps)):
            step = state.step
            if live_teacher is not None:
                batch = live_teacher.attach(batch)
            metrics = trainer.train_step(state, batch, step_seed(args.seed, step))
            pairs += len(batch["labels"]) * world
            if step % LOG_EVERY == 0:
                log({"step": step, **{k: float(v) for k, v in metrics.items()}})
            last = i + 1 == args.steps
            if lead and (state.step % args.checkpoint_every == 0 or last):
                t_save = clock()
                save_npz(out_dir / f"step_{state.step}.npz", params_to_jax(trainer.eval_params(state)))
                trainer.save_state(state, out_dir / f"state_{state.step}.npz")
                save_seconds += time.perf_counter() - t_save
            if answers is not None and ((args.valid_every and state.step % args.valid_every == 0) or last):
                t_valid = clock()
                params = trainer.eval_params(state)
                if engine is None:
                    engine = ScoringEngine(spec, params, device=device, precision=trainer.precision)
                else:
                    engine.update_params(params)
                result = engine.score_files(args.valid_tsv, featurizer, args.valid_batch_size or args.batch_size)
                ndcg = evaluate_scores(result, answers)
                log({"step": state.step, "valid_ndcg5": ndcg})
                if best is None or ndcg > best["valid_ndcg5"]:
                    best = {"step": state.step, "valid_ndcg5": ndcg}
                    save_npz(out_dir / "best.npz", params_to_jax(params))
                    (out_dir / "best_metadata.json").write_text(json.dumps(best))
                valid_seconds += time.perf_counter() - t_valid
                valid_passes.append({"step": state.step, "valid_ndcg5": ndcg,
                                     "seconds": time.perf_counter() - t_valid})
    # sampling or reading shards, and training; checkpoint writes and valid passes apart
    seconds = clock() - t0 - save_seconds - valid_seconds
    report = {"steps": state.step - start, "step": state.step, "pairs": pairs, "seconds": seconds,
              "checkpoint_seconds": save_seconds, "valid_seconds": valid_seconds, "valid": valid_passes,
              "best": best, "pairs_per_second": pairs / seconds if seconds > 0 else 0.0, "device": str(device),
              "data": "packed" if args.packed_dir else "sampler" if sampler is not None else "positive rows",
              "sampler": dataclasses.asdict(sampler.stats) if sampler is not None else None, "out": str(out_dir),
              "world_size": world}
    if lead:
        print(json.dumps(report))
    return trainer, state, report


def tsv_lines(paths: list[str], stride: bool = False):
    """The lines of ``paths``, one file after another; with ``stride``, this
    rank's lines of them (``parallel/distributed.py:stride_lines``)."""
    def lines():
        for path in paths:
            with open(path, "r", encoding="utf-8") as f:
                yield from f

    return stride_lines(lines()) if stride else lines()


def sampled_batches(sampler: HardNegativeSampler, paths: list[str], batch_size: int, stride: bool = False):
    """Batches of ``batch_size`` sampled examples, epoch after epoch over ``paths``
    (this rank's lines of them with ``stride``)."""
    while True:  # epochs
        n_yielded, buf = 0, []
        for example in sampler.examples(tsv_lines(paths, stride)):
            buf.append(example)
            if len(buf) == batch_size:
                n_yielded += 1
                yield pad_batch(stack_examples(buf), batch_size)
                buf = []
        if n_yielded == 0:
            raise SystemExit(f"no full {batch_size}-row batch from one pass over {paths}: "
                             "fewer usable rows than --batch-size")


def positive_batches(featurizer: Featurizer, paths: list[str], batch_size: int, stride: bool = False):
    """The two-tower's batches: the TSV rows in ImageBERT-B's layout (this
    rank's lines with ``stride``), epoch after epoch, each full batch with
    ``query_group`` (the rows' query ids); the ragged tail of a pass is
    dropped (in-batch negatives need full batches)."""
    while True:  # epochs
        n_yielded = 0
        for b in iter_batches(tsv_lines(paths, stride), featurizer.imagebert_b, batch_size):
            if b["valid"].all():
                n_yielded += 1
                b["query_group"] = b["query_id"].astype(np.int32)
                yield b
        if n_yielded == 0:
            raise SystemExit(f"no full {batch_size}-row batch from one pass over {paths}: "
                             "fewer usable rows than --batch-size")


def main(argv: list[str] | None = None) -> dict:
    return run(argv)[2]


if __name__ == "__main__":
    main(sys.argv[1:])
