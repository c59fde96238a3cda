"""Distil the ensemble (or one scorer) into a shallower serving student, the
port of the JAX package's ``scripts/distill.py`` (the same flags, plus
``--device``).

The reference serves four 12-layer scorers and fuses them (``code/main.py``);
this trains ONE L-layer student of a family, which scores at about 12/L of
the teacher's depth:

  # offline: a student of the full 4-model ensemble on already-scored pairs
  # (--teacher-ensemble fuses with code/main.py's semantics, the LXMERT
  # backfill included; --teacher-scores is the strict-coverage weighted
  # average of any set of files)
  python -m kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.distill \\
      --model imagebert_b --student-layers 4 --tsv valid.tsv --labels multimodal_labels.txt \\
      --teacher-ensemble B.txt C.txt A.txt L.csv --steps 2000 --batch-size 256 --out runs/student

  # live: one teacher checkpoint scores every batch; the student starts from its layers
  python -m kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.distill \\
      --model imagebert_b --student-layers 4 --tsv train0.tsv --labels multimodal_labels.txt \\
      --teacher-checkpoint model_attention_kdd_am_word_match_finetune_valid.ckpt-251 \\
      --init-from-teacher --steps 2000 --out runs/student

The rows of ``--tsv`` are featurized in the family's serving layout (fed
label 1) and the student trains pure-soft (``hard_loss_weight`` 0: the TSV
rows carry no relevance labels). A live teacher (``train/distill.py:
LiveTeacher``) scores on the card through the scoring blocks' kernels in
bf16; its probabilities stay on the device. ``--init-from-teacher`` maps the
teacher's layers into the student (``init_student_from_teacher``), and B/C's
EMA restarts from those params.

Writes ``<out>/student_config.json`` (the student's shape), ``metrics.jsonl``
(every 20 steps; with ``--valid-tsv``, ``valid_ndcg5``; at the end
``distill_tau`` and ``distill_mae``, the student's agreement with the teacher
over the distillation pairs), ``step_<N>.npz`` and ``state_<N>.npz`` every
``--checkpoint-every`` steps and at the end, ``best.npz`` and
``best_metadata.json`` with the valid loop, and ``student_final.npz``. The
port writes npz files where the JAX script writes orbax directories; the
sidecar sits beside them, so ``cli/score.py --checkpoint <out>/best.npz``
rebuilds the student. Runs on the card by default; ``--device cpu`` runs the
plain versions in f32.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import VOCAB_PATH
from ..checkpoint import load_checkpoint, params_from_jax, params_to_jax, save_npz
from ..data import Featurizer, load_multimodal_labels
from ..data.pipeline import iter_batches
from ..eval import evaluate_scores, load_answers
from ..models import get_model
from ..parallel import ScoringEngine, resolve_device
from ..tokenization import FullTokenizer
from ..train import LiveTeacher, TeacherScores, Trainer, init_student_from_teacher, model_batch_of, recipe_for
from ..utils import log_metrics
from .train import LOG_EVERY, step_seed


def rank_agreement(qids, student, teacher) -> float:
    """Mean per-query Kendall tau between student and teacher scores."""
    qids = np.asarray(qids)
    taus = []
    for q in np.unique(qids):
        m = qids == q
        a, b = np.asarray(student)[m], np.asarray(teacher)[m]
        if len(a) < 2:
            continue
        ii, jj = np.triu_indices(len(a), k=1)
        taus.append(float(np.mean(np.sign(a[ii] - a[jj]) * np.sign(b[ii] - b[jj]))))
    return float(np.mean(taus)) if taus else float("nan")


def _host(v) -> np.ndarray:
    return v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def main(argv: list[str] | None = None) -> dict:
    """Parse ``argv``, distil and write the run; -> the run's report."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True, choices=["imagebert_a", "imagebert_b", "imagebert_c", "lxmert"],
                    help="student family (layout and head follow the family)")
    ap.add_argument("--student-layers", type=int, default=None,
                    help="student encoder depth (the teacher keeps the config's)")
    ap.add_argument("--student-overrides", default=None,
                    help='JSON config overrides for the student, e.g. \'{"num_hidden_layers": 4}\' or LXMERT stack '
                         'depths \'{"l_layers": 3, "x_layers": 2, "r_layers": 2}\'')
    ap.add_argument("--tsv", required=True, nargs="+",
                    help="pair rows to distil on (the family's serving layout, fed label = 1)")
    ap.add_argument("--labels", required=True, help="multimodal_labels.txt")
    ap.add_argument("--teacher-scores", nargs="+", default=None,
                    help="offline teacher: score file(s) covering the --tsv pairs; several fuse by --teacher-weights")
    ap.add_argument("--teacher-weights", nargs="+", type=float, default=None)
    ap.add_argument("--teacher-ensemble", nargs=4, default=None, metavar=("B", "C", "A", "LXMERT"),
                    help="offline teacher = the full reference ensemble: four score files in code/main.py order, "
                         "fused with its semantics (LXMERT pair universe, backfill, 0.2/0.2/0.3/0.3 or "
                         "--teacher-weights)")
    ap.add_argument("--teacher-checkpoint", default=None,
                    help="live teacher: a full-depth checkpoint of the same family (any format cli/score.py "
                         "reads), scoring every batch in serving mode")
    ap.add_argument("--init-from-teacher", action="store_true",
                    help="initialise the student from evenly spaced teacher layers (needs --teacher-checkpoint)")
    ap.add_argument("--temperature", type=float, default=2.0)
    ap.add_argument("--distill-weight", type=float, default=1.0)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--warmup-steps", type=int, default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--checkpoint-every", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--valid-tsv", nargs="+", default=None,
                    help="valid TSVs: the student's nDCG@5 loop and best.npz (the flow of cli/train.py)")
    ap.add_argument("--answers", default=None, help="valid_answer.json for the valid loop")
    ap.add_argument("--valid-every", type=int, default=0, help="steps between valid passes (0 = only at the end)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if bool(args.valid_tsv) != bool(args.answers):
        ap.error("--valid-tsv and --answers must be given together")
    # the distillation SIGNAL comes from exactly one of offline scores / fused ensemble / live checkpoint; a
    # checkpoint may ride along with an offline teacher only to initialise the student
    if args.teacher_scores and args.teacher_ensemble:
        ap.error("--teacher-scores and --teacher-ensemble are exclusive")
    offline = bool(args.teacher_scores or args.teacher_ensemble)
    if not offline and not args.teacher_checkpoint:
        ap.error("one of --teacher-scores / --teacher-ensemble / --teacher-checkpoint is required")
    if offline and args.teacher_checkpoint and not args.init_from_teacher:
        ap.error("--teacher-checkpoint alongside an offline teacher is only meaningful with --init-from-teacher "
                 "(otherwise two signals)")
    if args.init_from_teacher and not args.teacher_checkpoint:
        ap.error("--init-from-teacher requires --teacher-checkpoint")
    if bool(args.student_layers) == bool(args.student_overrides):
        ap.error("exactly one of --student-layers / --student-overrides")
    if args.model == "lxmert" and args.student_layers:
        # LXMERT's depth lives in its three stack fields: a bare layer count would build a 9/5/5 "student"
        ap.error('lxmert students need --student-overrides with the stack depths, e.g. '
                 '\'{"l_layers": 3, "x_layers": 2, "r_layers": 2}\'')

    device = resolve_device(args.device)
    overrides = (json.loads(args.student_overrides) if args.student_overrides
                 else {"num_hidden_layers": args.student_layers})
    student = get_model(args.model, overrides=overrides)
    tok = FullTokenizer.hf_style(VOCAB_PATH) if args.model == "lxmert" else FullTokenizer.google_style(VOCAB_PATH)
    featurizer = Featurizer(tok, load_multimodal_labels(args.labels), sen2forest=student.sen2forest)

    teacher_params = live = None
    if args.teacher_ensemble:
        weights = tuple(args.teacher_weights) if args.teacher_weights else None
        table = TeacherScores.from_ensemble_files(*args.teacher_ensemble, weights=weights)
        print(f"ensemble teacher: {len(table)} fused pairs")
        attach = table.attach
    elif args.teacher_scores:
        table = TeacherScores.from_files(args.teacher_scores, args.teacher_weights)
        print(f"offline teacher: {len(table)} scored pairs from {len(args.teacher_scores)} file(s)")
        attach = table.attach
    if args.teacher_checkpoint:
        teacher_spec = get_model(args.model)
        teacher_params = load_checkpoint(args.model, args.teacher_checkpoint, teacher_spec)
        if not offline:
            live = LiveTeacher(teacher_spec, teacher_params, device=device)
            attach = live.attach

    tc = dataclasses.replace(
        recipe_for(student.name), distill_weight=args.distill_weight, distill_temperature=args.temperature,
        hard_loss_weight=0.0,  # pure-soft: the TSV rows carry no labels
        **({"learning_rate": args.lr} if args.lr is not None else {}),
        **({"num_warmup_steps": args.warmup_steps} if args.warmup_steps is not None else {}))
    trainer = Trainer(student, tc, device=device)
    if args.init_from_teacher:
        mapped = init_student_from_teacher(params_to_jax(student.init_params(args.seed)), params_to_jax(teacher_params))
        state = trainer.init_state(student.from_jax(params_from_jax(mapped)), seed=args.seed)  # a fresh EMA of them
        print("student initialised from evenly spaced teacher layers")
    else:
        state = trainer.init_state(seed=args.seed)

    def lines():
        for path in args.tsv:
            with open(path, "r", encoding="utf-8") as f:
                yield from f

    def batches():
        while True:  # epochs
            n = 0
            for b in iter_batches(lines(), featurizer.for_model(args.model), args.batch_size):
                n += 1
                yield attach(b)
            if n == 0:
                raise SystemExit(f"no rows parsed from {args.tsv}")

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    # cli/score.py reads this to rebuild the student's spec on reload
    (out_dir / "student_config.json").write_text(json.dumps({"model": args.model, "overrides": overrides}))
    answers = load_answers(args.answers) if args.answers else None
    engine, best, valid_passes = None, None, []

    def clock() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    with open(out_dir / "metrics.jsonl", "a", encoding="utf-8") as metrics_file:

        def log(step: int, metrics: dict) -> None:  # one JSON line to the file and to stdout
            log_metrics(step, metrics, metrics_file)
            log_metrics(step, metrics)

        def run_valid(step: int) -> None:
            nonlocal engine, best
            t0 = clock()
            params = trainer.eval_params(state)
            if engine is None:
                engine = ScoringEngine(student, params, device=device, precision=trainer.precision)
            else:
                engine.update_params(params)
            ndcg = evaluate_scores(engine.score_files(args.valid_tsv, featurizer, args.batch_size), answers)
            log(step, {"valid_ndcg5": ndcg})
            if best is None or ndcg > best["valid_ndcg5"]:
                best = {"step": step, "valid_ndcg5": ndcg}
                save_npz(out_dir / "best.npz", params_to_jax(params))
                (out_dir / "best_metadata.json").write_text(json.dumps(best))
            valid_passes.append({"step": step, "valid_ndcg5": ndcg, "seconds": clock() - t0})

        t0 = clock()
        pairs, save_seconds = 0, 0.0
        for step, batch in enumerate(itertools.islice(batches(), args.steps)):
            metrics = trainer.train_step(state, batch, step_seed(args.seed, step))
            pairs += int(np.asarray(batch["valid"]).sum())
            if step % LOG_EVERY == 0:
                log(step, metrics)
            if (args.checkpoint_every and (step + 1) % args.checkpoint_every == 0) or step + 1 == args.steps:
                t_save = clock()
                save_npz(out_dir / f"step_{step + 1}.npz", params_to_jax(trainer.eval_params(state)))
                trainer.save_state(state, out_dir / f"state_{step + 1}.npz")
                save_seconds += time.perf_counter() - t_save
            if answers is not None and ((args.valid_every and (step + 1) % args.valid_every == 0)
                                        or step + 1 == args.steps):
                run_valid(step + 1)
        # the teacher, the featurizer and the steps; checkpoint writes and valid passes apart (as cli/train.py)
        valid_seconds = sum(v["seconds"] for v in valid_passes)
        seconds = clock() - t0 - save_seconds - valid_seconds
        if answers is not None:
            print(f"best valid nDCG@5 {best['valid_ndcg5']:.4f} (checkpoint {out_dir / 'best.npz'})")

        # one agreement pass: the student's ranking against the teacher's over the distillation pairs
        final = trainer.eval_params(state)
        scorer = ScoringEngine(student, final, device=device, precision=trainer.precision)
        qids, s_scores, t_scores = [], [], []
        for b in iter_batches(lines(), featurizer.for_model(args.model), args.batch_size):
            b = attach(b)
            s = _host(scorer.score_batch(model_batch_of(b)))
            keep = _host(b["teacher_weight"]) > 0
            qids.append(np.asarray(b["query_id"])[keep])
            s_scores.append(s[keep])
            t_scores.append(_host(b["teacher_prob"])[keep])
        qids = np.concatenate(qids)
        s_scores, t_scores = np.concatenate(s_scores), np.concatenate(t_scores)
        tau = rank_agreement(qids, s_scores, t_scores)
        mae = float(np.mean(np.abs(s_scores - t_scores)))
        print(f"student-teacher agreement over {len(qids)} pairs: mean per-query Kendall tau {tau:.4f}, "
              f"score MAE {mae:.4f}")
        log(args.steps, {"distill_tau": tau, "distill_mae": mae})
    save_npz(out_dir / "student_final.npz", params_to_jax(final))
    print(f"student saved to {out_dir / 'student_final.npz'}")
    report = {"steps": args.steps, "pairs": pairs, "seconds": seconds, "checkpoint_seconds": save_seconds,
              "valid_seconds": valid_seconds, "pairs_per_second": pairs / seconds if seconds > 0 else 0.0,
              "teacher": "live" if live else "offline", "valid": valid_passes, "best": best, "distill_tau": tau,
              "distill_mae": mae, "device": str(device), "out": str(out_dir)}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
