"""The port's multi-process loader: the same batches at every worker count,
with and without the shared-memory hand-off, on the native and the Python
path, equal to the per-example serial pipeline; chunking equal to the JAX
package's; parse errors counted; a worker's failure raised with its
traceback; its shared-memory blocks named ``kmr_<pid>_<n>`` (never the
standard library's ``psm_*``) and none left behind; a worker spawned from a
program that imports torch holds no torch. Spawns are few: each costs about
a second."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch import VOCAB_PATH
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import Featurizer, PipelineStats, iter_batches
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import multiworker
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.multiworker import MultiWorkerLoader, chunk_spans
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.synthetic import SYNTHETIC_LABELS, make_testb_tsv
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.tokenization import FullTokenizer

REPO = Path(__file__).resolve().parents[1]
BATCH = 8
CHUNK = 150_000  # ~2-3 rows a span: spans cross batch and file boundaries


@pytest.fixture(scope="module")
def featurizer():
    return Featurizer(FullTokenizer.google_style(VOCAB_PATH), dict(SYNTHETIC_LABELS))


@pytest.fixture(scope="module")
def tsv_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mw")
    paths = []
    for i, n in enumerate((23, 14)):  # one malformed row each
        p = d / f"part{i}.tsv"
        p.write_text("\n".join(make_testb_tsv(n, seed=40 + i, pairs_per_query=5)) + "\n")
        paths.append(p)
    return paths


def _kmr_blocks(pids) -> set[str]:
    prefixes = tuple(f"{multiworker.SHM_PREFIX}{pid}_" for pid in pids)
    try:
        return {n for n in os.listdir("/dev/shm") if n.startswith(prefixes)}
    except FileNotFoundError:
        return set()


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_chunk_spans_match_jax(tsv_files):
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.data.multiworker import chunk_spans as jax_chunk_spans

    for chunk in (CHUNK, 1 << 20, 1 << 30):
        spans = chunk_spans(tsv_files, chunk)
        assert spans == jax_chunk_spans(tsv_files, chunk)
        assert spans[0][1] == 0 and sum(e - s for _, s, e in spans) == sum(p.stat().st_size for p in tsv_files)
    assert len(chunk_spans(tsv_files, CHUNK)) > 10


def test_worker_counts_agree_and_match_serial(tsv_files, featurizer):
    def lines():
        for p in tsv_files:
            yield from p.read_text().splitlines(keepends=True)

    serial_stats = PipelineStats()
    serial = list(iter_batches(lines(), featurizer.imagebert_b, BATCH, serial_stats))
    assert serial_stats.errors == 2 and serial_stats.parsed == 37
    for workers, use_native, use_shm in ((0, True, True), (0, False, True), (1, True, True), (2, True, True),
                                         (2, True, False), (2, False, True)):
        stats = PipelineStats()
        loader = MultiWorkerLoader(tsv_files, featurizer, "imagebert_b", BATCH, num_workers=workers,
                                   chunk_bytes=CHUNK, stats=stats, use_native=use_native, use_shm=use_shm)
        _equal(list(loader), serial)
        assert (stats.parsed, stats.errors, stats.batches) == (37, 2, len(serial)), (workers, use_native, use_shm)
        if workers:
            assert len(loader.worker_pids) == workers
            assert _kmr_blocks(loader.worker_pids) == set()  # every block consumed and removed


def test_shm_blocks_carry_the_port_prefix():
    full = {"a": np.arange(6, dtype=np.int64).reshape(2, 3), "b": np.ones((2, 5), np.float32)}
    name, metas = multiworker._shm_pack(full)
    assert name.startswith(f"kmr_{os.getpid()}_") and not name.startswith("psm_")
    if os.path.isdir("/dev/shm"):
        assert name in os.listdir("/dev/shm")
    back = multiworker._shm_unpack(name, metas)
    assert all(np.array_equal(back[k], full[k]) for k in full)
    assert _kmr_blocks([os.getpid()]) == set()


def test_worker_failure_propagates(tsv_files, featurizer):
    loader = MultiWorkerLoader(tsv_files[:1], featurizer, "no_such_layout", BATCH, num_workers=1)
    with pytest.raises(RuntimeError, match="(?s)loader worker failed.*ValueError.*unknown featurizer layout "
                                           "'no_such_layout'"):
        list(loader)
    assert _kmr_blocks(loader.worker_pids) == set()


def test_workers_import_no_torch(tsv_files, tmp_path):
    """A program whose main module imports torch (as the scoring CLI does)
    spawns workers that hold no torch: a worker raises if it finds torch in
    sys.modules, and the loader raises that error."""
    script = tmp_path / "main_with_torch.py"
    script.write_text(
        "import sys\n"
        "import torch  # noqa: F401\n"
        "from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch import VOCAB_PATH\n"
        "from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import Featurizer\n"
        "from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.multiworker import MultiWorkerLoader\n"
        "from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.synthetic import SYNTHETIC_LABELS\n"
        "from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.tokenization import FullTokenizer\n"
        "if __name__ == '__main__':\n"
        "    fz = Featurizer(FullTokenizer.google_style(VOCAB_PATH), SYNTHETIC_LABELS)\n"
        "    n = sum(int(b['valid'].sum()) for b in MultiWorkerLoader([sys.argv[1]], fz, 'lxmert', 8, num_workers=1))\n"
        "    print(n)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, str(script), str(tsv_files[1])], capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "14"


def test_data_package_imports_no_torch():
    code = (
        "import sys\n"
        "import kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data\n"
        "import kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.fast_pipeline\n"
        "import kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.multiworker\n"
        "import kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.native\n"
        "assert 'torch' not in sys.modules and 'jax' not in sys.modules\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
