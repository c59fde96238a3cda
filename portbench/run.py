"""Run one cell of the port's benchmark once, on the card of this machine.

  python3 portbench/run.py --workload imagebert_a.score_tsv --seed 7 --seconds 10 --trace 0

Prints each number that decides ``correct`` beside its limit as the last
lines on standard error, and one JSON line as the last line of standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with ``--trace
1``), ``device`` and, traced, ``breakdown``; ``checks`` comes last. Exits 2,
printing no result, without CUDA or with fewer cards than the cell asks for,
3 when a JAX module was loaded, and 4 when a traced run finds nothing to read
for a per-layer metric ``BENCHMARK.json`` lists for the cell (a kernel class
that matched no device time, say). Kernel and build caches stay in the
checkout's ``build/``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from portbench.yardstick import steady  # noqa: E402

steady.pin_thread_env()  # before numpy or torch is imported

from portbench import harness  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    started = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)

    cache = REPO / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    run = harness.resolve(args.workload, repo=REPO)

    import torch

    steady.pin_torch_threads()
    if not torch.cuda.is_available() or torch.cuda.device_count() < run.workload["chips"]:
        print(f"[portbench] needs {run.workload['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from portbench.yardstick import peaks

    print(f"[portbench] card: {peaks.card()}; peaks {peaks.BF16_FLOPS:.3e} FLOP/s bf16, "
          f"{peaks.HBM_BYTES_PER_S:.3e} B/s", file=sys.stderr)
    run.seed = args.seed % 2**40  # the seeds a step and a generator derive from it stay in 64 bits
    run.seconds = args.seconds
    run.trace = bool(args.trace)
    run.device = torch.device("cuda", 0)
    run.tmpdir = os.environ.get("TMPDIR") or None
    torch.cuda.reset_peak_memory_stats()
    out = harness.run_cell(run, started)

    found = harness.forbidden_modules()
    if found:
        print(f"[portbench] JAX modules loaded in this process: {found}", file=sys.stderr)
        return 3
    unread = out.pop("unread", [])
    if unread:
        print(f"[portbench] per-layer metrics of this cell that the traced window gave nothing to read: "
              f"{unread}", file=sys.stderr)
        return 4
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": run.workload["chips"],
                     "memory_peak_bytes": out.pop("memory_peak_bytes")}
    if run.trace:
        out["device"].update(busy_s=out.pop("busy_s"), window_s=out.pop("window_s"))
    checks = out.pop("checks")
    for name, value, limit in checks:
        print(f"[check] {name} {value!r} limit {limit!r}", file=sys.stderr)
    out["checks"] = {name: {"value": value if math.isfinite(value) else str(value), "limit": limit}
                     for name, value, limit in checks}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
