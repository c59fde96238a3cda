"""The port's native parser (its own copy of ``preproc.cpp`` and its binding)
and its vectorised pipeline against the JAX package's and against the port's
per-example ``Featurizer``: arrays and batches bit for bit (both parsers run
the same C++ on the same bytes; the per-example path computes the box
geometry in numpy, which rounds to the same f32 values on these rows).
Also: where the library is built, two processes building it at once, and a
failed build raising rather than falling back to the Python path."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch import BUILD_DIR, PACKAGE_ROOT, VOCAB_PATH
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import Featurizer, iter_batches
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import native
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.fast_pipeline import (
    assemble_batches,
    native_batches_from_files,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.synthetic import (
    SYNTHETIC_LABELS,
    make_testb_tsv,
    make_tsv,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.tokenization import FullTokenizer

REPO = Path(__file__).resolve().parents[1]
LAYOUTS = ["imagebert_a", "imagebert_b", "imagebert_c", "lxmert"]


def _tsv_bytes(n, seed, bad_at=(2, 7)) -> bytes:
    lines = make_tsv(n, seed=seed)
    for i, at in enumerate(bad_at):
        lines.insert(at, f"12{i}\t800\t600\t0\t\t\t\tno boxes\t1" if i % 2 else "corrupt\tline")
    return ("\n".join(lines) + "\n").encode()


def _arrays_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        if k in ("queries", "n_errors"):
            assert got[k] == want[k], k
        else:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("n,threads", [(9, None), (40, 4)], ids=["one-chunk", "threaded-split"])
def test_parse_pairs_matches_jax(n, threads):
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.data.native import parse_pairs_native as jax_parse

    buf = _tsv_bytes(n, seed=n)
    if threads:
        assert len(buf) > 1 << 20 and len(native._split_at_lines(buf, threads)) == threads
    got = native.parse_pairs_native(buf, n_threads=threads)
    _arrays_equal(got, jax_parse(buf, n_threads=threads))
    assert len(got["product_id"]) == n and got["n_errors"] == 2
    assert native.count_rows(buf) == n + 2  # the header is no row; the two bad ones are


@pytest.mark.parametrize("layout", LAYOUTS)
def test_native_batches_match_featurizer_and_jax(layout, tmp_path):
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.data import Featurizer as JaxFeaturizer
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.data.fast_pipeline import (
        native_batches_from_files as jax_native_batches,
    )
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.tokenization import FullTokenizer as JaxTokenizer

    style = "hf_style" if layout == "lxmert" else "google_style"
    fz = Featurizer(getattr(FullTokenizer, style)(VOCAB_PATH), SYNTHETIC_LABELS, sen2forest=layout == "imagebert_c")
    jfz = JaxFeaturizer(getattr(JaxTokenizer, style)(VOCAB_PATH), SYNTHETIC_LABELS,
                        sen2forest=layout == "imagebert_c")
    lines = make_testb_tsv(45, seed=11, pairs_per_query=7)  # the trigger, shared products, a bad row
    p = tmp_path / "t.tsv"
    p.write_text("\n".join(lines) + "\n")

    slow = list(iter_batches(lines, fz.for_model(layout), 8))
    fast = list(native_batches_from_files([p], fz, layout, 8))
    jax_fast = list(jax_native_batches([p], jfz, layout, 8))
    assert len(slow) == len(fast) == len(jax_fast) == 6
    for s, f, j in zip(slow, fast, jax_fast):
        _arrays_equal(f, s)
        _arrays_equal(f, j)


def test_files_batch_as_one_stream(tmp_path):
    """Two files batch like their rows in one stream (one padded tail), and the
    stats count rows, errors and batches as the per-example path does."""
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import PipelineStats

    fz = Featurizer(FullTokenizer.google_style(VOCAB_PATH), SYNTHETIC_LABELS)
    parts = [_tsv_bytes(5, seed=1, bad_at=(3,)).decode(), _tsv_bytes(6, seed=2, bad_at=()).decode()]
    paths = []
    for i, text in enumerate(parts):
        paths.append(tmp_path / f"{i}.tsv")
        paths[-1].write_text(text)
    slow_stats, fast_stats = PipelineStats(), PipelineStats()
    slow = list(iter_batches("".join(parts).splitlines(keepends=True), fz.imagebert_a, 4, slow_stats))
    fast = list(native_batches_from_files(paths, fz, "imagebert_a", 4, stats=fast_stats))
    assert len(fast) == len(slow) == 3
    for s, f in zip(slow, fast):
        _arrays_equal(f, s)
    assert (fast_stats.parsed, fast_stats.errors, fast_stats.batches) == (11, 1, 3)
    assert (slow_stats.parsed, slow_stats.errors, slow_stats.batches) == (11, 1, 3)
    one = native.parse_pairs_native(paths[1].read_bytes())
    assert len(list(assemble_batches(one, fz, "imagebert_a", 4))) == 2


def test_library_lands_under_build():
    path = native.library_path()
    assert path.parent == BUILD_DIR / "native" and path.name.startswith("libpreproc-")
    native.get_lib()
    assert path.is_file()
    assert not list((PACKAGE_ROOT / "data" / "native").glob("*.so"))  # never next to its source


def test_two_processes_build_at_once(tmp_path):
    """Two processes that build into an empty directory at once both load the
    library; it is moved in whole (no temporary file is left)."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "assert native.count_rows(b'1\\t2\\n\\nproduct_id\\n3\\n') == 2\n"
        "print(native.library_path())\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err[-2000:] for _, err in outs]
    built = sorted((tmp_path / "native").iterdir())
    assert [b.name for b in built] == [Path(outs[0][0].strip()).name]
    assert outs[0][0] == outs[1][0]


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises NativeUnavailable; a scoring
    engine asked for the native loader raises it too, and never falls back."""
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import get_model
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringEngine
    from torch_parity import TINY

    broken = tmp_path / "preproc.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeUnavailable, match="cannot build"):
        native.build()
    assert not list((tmp_path / "build" / "native").glob("*"))

    spec = get_model("imagebert_a", overrides=TINY)
    engine = ScoringEngine(spec, spec.init_params(0), device="cpu")
    p = tmp_path / "t.tsv"
    p.write_text("\n".join(make_tsv(3, seed=1)) + "\n")
    fz = Featurizer(FullTokenizer.google_style(VOCAB_PATH), SYNTHETIC_LABELS)
    with pytest.raises(native.NativeUnavailable):
        engine.score_files([p], fz, 4)
    assert len(engine.score_files([p], fz, 4, use_native=False)) > 0  # the caller's choice
