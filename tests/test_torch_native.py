"""The port's native parser (its own copy of ``preproc.cpp`` and its binding)
and its vectorised pipeline against the JAX package's and against the port's
per-example ``Featurizer``: arrays and batches bit for bit (both parsers run
the same C++ on the same bytes; the per-example path computes the box
geometry in numpy, which rounds to the same f32 values on these rows).
The byte spans equal the JAX package's, and a scoring engine gives the same
scores through either loader. Also: where the library is built, two processes
building it at once, a failed build raising rather than falling back to the
Python path, and a data package that imports no torch."""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch import BUILD_DIR, PACKAGE_ROOT, VOCAB_PATH
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import Featurizer, PrefetchIterator, iter_batches
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import fast_pipeline, native
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


# byte spans of the streamed loader: the default (one span a file here), one line each (the header
# and the malformed row alone, and every batch boundary on a span boundary), and a few rows each
SPANS = {"whole-file": fast_pipeline.SPAN_BYTES, "a-span-a-line": 1, "few-rows-a-span": 200_000}


@pytest.mark.parametrize("spans", list(SPANS))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_native_batches_match_featurizer_and_jax(layout, spans, tmp_path, monkeypatch):
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.data import Featurizer as JaxFeaturizer
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.data.fast_pipeline import (
        native_batches_from_files as jax_native_batches,
    )
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.tokenization import FullTokenizer as JaxTokenizer
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import PipelineStats

    style = "hf_style" if layout == "lxmert" else "google_style"
    fz = Featurizer(getattr(FullTokenizer, style)(VOCAB_PATH), SYNTHETIC_LABELS, sen2forest=layout == "imagebert_c")
    jfz = JaxFeaturizer(getattr(JaxTokenizer, style)(VOCAB_PATH), SYNTHETIC_LABELS,
                        sen2forest=layout == "imagebert_c")
    lines = make_testb_tsv(45, seed=11, pairs_per_query=7)  # the trigger, shared products, a bad row
    p = tmp_path / "t.tsv"
    p.write_text("\n".join(lines) + ("" if spans == "a-span-a-line" else "\n"))  # and a last line with no newline

    slow_stats, fast_stats = PipelineStats(), PipelineStats()
    slow = list(iter_batches(lines, fz.for_model(layout), 8, slow_stats))
    monkeypatch.setattr(fast_pipeline, "SPAN_BYTES", SPANS[spans])
    fast = list(native_batches_from_files([p], fz, layout, 8, fast_stats))
    jax_fast = list(jax_native_batches([p], jfz, layout, 8))
    assert len(slow) == len(fast) == len(jax_fast) == 6
    for s, f, j in zip(slow, fast, jax_fast):
        _arrays_equal(f, s)
        _arrays_equal(f, j)
    assert (fast_stats.parsed, fast_stats.errors, fast_stats.batches) == (45, 1, 6)
    assert (slow_stats.parsed, slow_stats.errors, slow_stats.batches) == (45, 1, 6)


@pytest.mark.parametrize("spans", list(SPANS))
def test_files_batch_as_one_stream(spans, tmp_path, monkeypatch):
    """Two files batch like their rows in one stream (one padded tail), whatever
    their byte spans, and the stats count rows, errors and batches as the
    per-example path does."""
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import PipelineStats

    fz = Featurizer(FullTokenizer.google_style(VOCAB_PATH), SYNTHETIC_LABELS)
    parts = [_tsv_bytes(5, seed=1, bad_at=(3,)).decode(), _tsv_bytes(6, seed=2, bad_at=()).decode()]
    if spans == "a-span-a-line":
        parts[0] = parts[0].rstrip("\n")  # a first file whose last line has no newline
    paths = []
    for i, text in enumerate(parts):
        paths.append(tmp_path / f"{i}.tsv")
        paths[-1].write_text(text)
    slow_stats, fast_stats = PipelineStats(), PipelineStats()
    slow = list(iter_batches([ln for text in parts for ln in text.splitlines()], fz.imagebert_a, 4, slow_stats))
    monkeypatch.setattr(fast_pipeline, "SPAN_BYTES", SPANS[spans])
    fast = list(native_batches_from_files(paths, fz, "imagebert_a", 4, stats=fast_stats))
    assert len(fast) == len(slow) == 3
    for s, f in zip(slow, fast):
        _arrays_equal(f, s)
    assert (fast_stats.parsed, fast_stats.errors, fast_stats.batches) == (11, 1, 3)
    assert (slow_stats.parsed, slow_stats.errors, slow_stats.batches) == (11, 1, 3)
    one = native.parse_pairs_native(paths[1].read_bytes())
    assert len(list(assemble_batches(one, fz, "imagebert_a", 4))) == 2


def test_chunk_spans_match_jax(tmp_path):
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.data.multiworker import chunk_spans as jax_chunk_spans

    paths = []
    for i, n in enumerate((23, 14)):
        paths.append(tmp_path / f"part{i}.tsv")
        paths[-1].write_text("\n".join(make_testb_tsv(n, seed=40 + i, pairs_per_query=5)) + "\n")
    for chunk in (150_000, 1 << 20, 1 << 30):  # ~2-3 rows a span, then a span or one a file
        spans = fast_pipeline.chunk_spans(paths, chunk)
        assert spans == jax_chunk_spans(paths, chunk)
        assert spans[0][1] == 0 and sum(e - s for _, s, e in spans) == sum(p.stat().st_size for p in paths)
    assert len(fast_pipeline.chunk_spans(paths, 150_000)) > 10


@pytest.mark.parametrize("spans", list(SPANS))
def test_score_files_loaders_agree(spans, tmp_path, monkeypatch):
    """A scoring engine gives the same scores, pair for pair, through the native loader at each span size
    as through the per-example Python path, and counts the same pairs, rows and parse errors."""
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import get_model
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringEngine, ScoringStats
    from torch_parity import TINY

    p = tmp_path / "pairs.tsv"
    p.write_text("\n".join(make_testb_tsv(45, seed=12, pairs_per_query=7)) + "\n")  # one malformed row
    fz = Featurizer(FullTokenizer.google_style(VOCAB_PATH), SYNTHETIC_LABELS)
    spec = get_model("imagebert_a", overrides=TINY)
    engine = ScoringEngine(spec, spec.init_params(2), device="cpu")
    monkeypatch.setattr(fast_pipeline, "SPAN_BYTES", SPANS[spans])
    results, counts = {}, {}
    for name, use_native in (("native", True), ("python", False)):
        stats = ScoringStats()
        results[name] = engine.score_files([p], fz, 8, stats=stats, use_native=use_native)
        counts[name] = (stats.pairs, stats.pipeline.parsed, stats.pipeline.errors)
    assert counts["native"] == counts["python"] == (45, 45, 1)
    assert sum(len(row) for row in results["python"].values()) == 45
    assert results["native"] == results["python"]


@pytest.fixture
def spanned(tmp_path, monkeypatch):
    """A 40-row file cut into one-row byte spans (the header rides with the first), and the streamed
    loader's span parse and its hand-over to ``rebatch`` wrapped with counters: -> (path, featurizer,
    number of spans, the counts). ``counts["in_flight"]`` takes, at each parse, the spans started and not
    yet handed over; a parse of a buffer holding ``corrupt`` raises."""
    lines = make_tsv(40, seed=3)
    path = tmp_path / "many.tsv"
    path.write_text("\n".join(lines) + "\n")
    span_bytes = len(lines[0]) + 2
    n_spans = len(fast_pipeline.chunk_spans([path], span_bytes))
    monkeypatch.setattr(fast_pipeline, "SPAN_BYTES", span_bytes)
    assert n_spans == 40 > fast_pipeline.LOADER_THREADS + 1
    counts = {"parsed": 0, "handed": 0, "in_flight": []}
    lock = threading.Lock()
    parse, rebatch = fast_pipeline.parse_pairs_native, fast_pipeline.rebatch

    def counted_parse(buf, n_threads=None):
        with lock:
            counts["parsed"] += 1
            counts["in_flight"].append(counts["parsed"] - counts["handed"])
        if b"corrupt" in buf:
            raise ValueError("a corrupt span")
        return parse(buf, n_threads)

    def counted_rebatch(fulls, *args):
        def handed():
            for full in fulls:
                with lock:
                    counts["handed"] += 1
                yield full
        return rebatch(handed(), *args)

    monkeypatch.setattr(fast_pipeline, "parse_pairs_native", counted_parse)
    monkeypatch.setattr(fast_pipeline, "rebatch", counted_rebatch)
    fz = Featurizer(FullTokenizer.google_style(VOCAB_PATH), SYNTHETIC_LABELS)
    return path, fz, n_spans, counts


def _loader_threads(before=frozenset()) -> set[threading.Thread]:
    """The loader pools' threads alive now that were not in ``before``."""
    return {t for t in threading.enumerate() if t.name.startswith("kmr-loader")} - before


def test_the_stream_keeps_at_most_a_pool_of_spans_in_flight(spanned):
    """The first batch leaves after one span, with no more spans parsed than the pool has threads, and
    no more than that are ever in flight; every span is parsed once, and the rows come in file order."""
    path, fz, n_spans, counts = spanned
    threads = fast_pipeline.LOADER_THREADS
    before = _loader_threads()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # the interpreter passes between the threads as often as it can
    try:
        stream = native_batches_from_files([path], fz, "imagebert_a", 1)
        first = next(stream)
        time.sleep(0.2)  # a suspended stream starts no span, however long its consumer takes
        assert counts["parsed"] <= threads and len(_loader_threads(before)) <= threads
        rest = list(stream)
    finally:
        sys.setswitchinterval(interval)
    assert counts["parsed"] == counts["handed"] == n_spans
    assert max(counts["in_flight"]) <= threads
    want = native.parse_pairs_native(path.read_bytes())["product_id"]
    assert [int(b["product_id"][0]) for b in [first, *rest]] == want.tolist()
    assert not _loader_threads(before)


def test_a_span_error_is_raised_in_the_consumer(spanned):
    path, fz, _, counts = spanned
    text = path.read_text().splitlines()
    text[25] = "corrupt\t" + text[25]
    path.write_text("\n".join(text) + "\n")
    before = _loader_threads()
    stream = native_batches_from_files([path], fz, "imagebert_a", 4)
    with pytest.raises(ValueError, match="a corrupt span"):
        list(PrefetchIterator(stream))
    assert 25 <= counts["parsed"] <= 25 + fast_pipeline.LOADER_THREADS
    assert not _loader_threads(before)


def test_closing_the_stream_leaves_no_loader_thread(spanned):
    path, fz, n_spans, counts = spanned
    before = set(threading.enumerate())
    stream = native_batches_from_files([path], fz, "imagebert_a", 1)
    next(stream)
    assert _loader_threads(before)
    stream.close()
    assert set(threading.enumerate()) <= before
    assert counts["parsed"] <= fast_pipeline.LOADER_THREADS < n_spans  # the rest was never started


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


def test_data_package_imports_no_torch():
    code = (
        "import sys\n"
        "import kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data\n"
        "import kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.fast_pipeline\n"
        "import kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.native\n"
        "assert 'torch' not in sys.modules and 'jax' not in sys.modules\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
