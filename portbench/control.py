"""The readings that the limits of ``portbench/limits/`` are set from, on the card
at a cell's own size, many seeds in one process (the benchmark's own runs do
not run this):

* ``program``: the numbers that decide ``correct`` for the program, as a run
  reads them (set-up, a window of ``--seconds``, the check);
* ``control``: the same numbers for the reference at fp8 (``reference/lowp.py``)
  put in the program's place, against the f32 reference;
* ``half_batch`` (training): the f32 reference stepped on the first half of
  each batch, the mean over the rest, in the program's place.

  python3 portbench/control.py --workload imagebert_b.train_packed --seeds 1 2 3 --control-seeds 3

Prints one JSON line a (seed, reading).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from portbench import harness  # noqa: E402


def readings(run, seed: int, seconds: float, control: bool) -> list[dict]:
    import numpy as np

    run.seed = seed
    entry = run.entry
    state = entry.setup(run)
    entry.window(run, state, seconds)
    if hasattr(entry, "sample_reference"):  # a scoring entry: the control is the reference's scores at fp8
        gap = None
        if control:
            gap = float(np.max(np.abs(entry.sample_reference(run, state, lowp=True) - entry.sample_reference(run, state))))
        out = [{"reading": "program", **dict((n, v) for n, v, _ in entry.check(run, state))}]
        return out + ([{"reading": "control", "score_gap": gap}] if control else [])
    program = state["program"]
    checks = dict((n, v) for n, v, _ in entry.check(run, state))
    out = [{"reading": "program", **checks, "losses": program["losses"]}]
    if control:
        ref = entry.reference_numbers(run, state["shard_sizes"])
        for name, kw in (("control", {"lowp": True}), ("half_batch", {"half_batch": True})):
            other = entry.reference_numbers(run, state["shard_sizes"], **kw)
            out.append({"reading": name, **entry.gaps(other, ref), "losses": other["losses"]})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3, help="the control on the first N seeds")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args()
    os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" / "portbench" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "portbench" / "triton")
    import torch

    if not torch.cuda.is_available():
        print("control readings need the card", file=sys.stderr)
        return 2
    run = harness.resolve(args.workload, repo=REPO)
    run.device = torch.device("cuda", 0)
    run.tmpdir = os.environ.get("TMPDIR") or None
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        for line in readings(run, seed, args.seconds, i < args.control_seeds):
            print(json.dumps({"workload": args.workload, "seed": seed, **line,
                              "seconds": round(time.perf_counter() - t0, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
