"""The port's scoring CLI and engine: the same score file as the JAX
``scripts/score.py`` from the same npz params (f32 on the CPU), for
ImageBERT-A, -B and -C (qid\\tpid\\tscore rows), ImageBERT-C as a delta of
B's file (``--delta-from``), and LXMERT (a query-id,product-id,score CSV);
the device policy, and the rule that the port never imports JAX."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch import PACKAGE_ROOT
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import save_npz
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import score as port_cli
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.synthetic import (
    SYNTHETIC_LABELS,
    make_eval_tsv,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.tsv import SEN2FOREST_SRC
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import (
    ScoringEngine,
    default_attention_backend,
    resolve_device,
)
from torch_parity import JAX_PKG, TINY, TORCH_PKG, jax_imagebert_a_params, numpy_like

REPO = Path(__file__).resolve().parents[1]
N_ROWS = 37


def _read_scores(path):
    out = {}
    for line in Path(path).read_text().splitlines():
        q, p, s = line.split("\t")
        out[(q, p)] = float(s)
    return out


def _read_csv_scores(path):
    lines = Path(path).read_text().splitlines()
    assert lines[0] == "query-id,product-id,score"
    out = {}
    for line in lines[1:]:
        q, p, s = line.split(",")
        out[(q, p)] = float(s)
    return out


def _json_lines(stdout):
    return [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]


def test_score_cli_matches_jax_script(tmp_path, monkeypatch, capsys):
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import get_model as jax_get_model

    lines, answers = make_eval_tsv(N_ROWS, seed=7, planted=0.0)
    (tmp_path / "pairs.tsv").write_text("\n".join(lines) + "\n")
    (tmp_path / "labels.txt").write_text("".join(f"{k}\t{v}\n" for k, v in SYNTHETIC_LABELS.items()))
    (tmp_path / "answers.json").write_text(json.dumps(answers))
    cfg = jax_get_model("imagebert_a", overrides=TINY).config
    save_npz(tmp_path / "a.npz", jax_imagebert_a_params(cfg, seed=8))
    common = [
        "--model", "imagebert_a", "--tsv", str(tmp_path / "pairs.tsv"),
        "--labels", str(tmp_path / "labels.txt"), "--checkpoint", str(tmp_path / "a.npz"),
        "--batch-size", "16", "--precision", "f32", "--answers", str(tmp_path / "answers.json"),
        "--expect-pairs", str(N_ROWS),
    ]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_PLATFORM_NAME": "cpu",
           "KMR_CONFIG_OVERRIDES": json.dumps(TINY)}
    ref = subprocess.run(
        [sys.executable, "scripts/score.py", *common, "--out", str(tmp_path / "jax.tsv")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert ref.returncode == 0, ref.stderr[-3000:]

    monkeypatch.setenv("KMR_CONFIG_OVERRIDES", json.dumps(TINY))
    port_cli.main([*common, "--device", "cpu", "--out", str(tmp_path / "port.tsv")])
    port_out = _json_lines(capsys.readouterr().out)

    want, got = _read_scores(tmp_path / "jax.tsv"), _read_scores(tmp_path / "port.tsv")
    assert got.keys() == want.keys() and len(got) == N_ROWS
    keys = sorted(want)
    np.testing.assert_allclose([got[k] for k in keys], [want[k] for k in keys], atol=1e-4, rtol=0)
    ref_ndcg = _json_lines(ref.stdout)[0]["ndcg_at_5"]
    assert port_out[0]["ndcg_at_5"] == ref_ndcg
    assert port_out[1]["pairs"] == N_ROWS and port_out[1]["device"] == "cpu"


def test_score_cli_lxmert_matches_jax_script(tmp_path, monkeypatch, capsys):
    import jax

    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import get_model as jax_get_model
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import lxmert as jax_lxmert

    lines, answers = make_eval_tsv(N_ROWS, seed=9, planted=0.0)
    (tmp_path / "pairs.tsv").write_text("\n".join(lines) + "\n")
    (tmp_path / "labels.txt").write_text("".join(f"{k}\t{v}\n" for k, v in SYNTHETIC_LABELS.items()))
    (tmp_path / "answers.json").write_text(json.dumps(answers))
    depths = {"l_layers": 2, "x_layers": 2, "r_layers": 1}
    monkeypatch.setenv("KMR_CONFIG_OVERRIDES", json.dumps(TINY))
    lcfg = jax_get_model("lxmert", overrides=depths).config
    shapes = jax.eval_shape(lambda: jax_lxmert.init_params(jax.random.key(0), lcfg))
    save_npz(tmp_path / "l.npz", numpy_like(shapes, seed=10))
    common = [
        "--model", "lxmert", "--tsv", str(tmp_path / "pairs.tsv"),
        "--labels", str(tmp_path / "labels.txt"), "--checkpoint", str(tmp_path / "l.npz"),
        "--config-overrides", json.dumps(depths),
        "--batch-size", "16", "--precision", "f32", "--answers", str(tmp_path / "answers.json"),
        "--expect-pairs", str(N_ROWS),
    ]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_PLATFORM_NAME": "cpu"}
    ref = subprocess.run(
        [sys.executable, "scripts/score.py", *common, "--out", str(tmp_path / "jax.csv")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert ref.returncode == 0, ref.stderr[-3000:]

    port_cli.main([*common, "--device", "cpu", "--out", str(tmp_path / "port.csv")])
    port_out = _json_lines(capsys.readouterr().out)

    want, got = _read_csv_scores(tmp_path / "jax.csv"), _read_csv_scores(tmp_path / "port.csv")
    assert list(got) == list(want) and len(got) == N_ROWS
    keys = sorted(want)
    np.testing.assert_allclose([got[k] for k in keys], [want[k] for k in keys], atol=1e-4, rtol=0)
    assert port_out[0]["ndcg_at_5"] == _json_lines(ref.stdout)[0]["ndcg_at_5"]
    assert port_out[1]["pairs"] == N_ROWS and port_out[1]["device"] == "cpu"


def test_device_policy(monkeypatch):
    spec = get_model("imagebert_a", overrides=TINY)
    params = spec.init_params(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ScoringEngine(spec, params)
    engine = ScoringEngine(spec, params, device="cpu")
    assert engine.precision.compute_dtype == torch.float32 and engine.attention_backend == "xla"
    # f32 on CUDA runs the plain "xla" route by rule (the JAX engine's), bf16 the kernels
    cuda = torch.device("cuda")
    assert default_attention_backend(cuda, Precision.f32()) == "xla"
    assert default_attention_backend(cuda, Precision.bf16()) == "pallas_packed"
    assert default_attention_backend(torch.device("cpu"), Precision.bf16()) == "xla"
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    assert ScoringEngine(spec, params, device="cpu", attention_backend="pallas").attention_backend == "pallas"
    with pytest.raises(ValueError, match="unknown attention backend"):
        ScoringEngine(spec, params, device="cpu", attention_backend="triton")


def test_port_never_imports_jax():
    """Importing every module of the port (and chip_smoke.py) loads no jax and
    nothing of the JAX package; no source file names either."""
    modules = []
    for path in sorted(PACKAGE_ROOT.rglob("*.py")):
        parts = path.relative_to(PACKAGE_ROOT).with_suffix("").parts
        modules.append(".".join((TORCH_PKG, *parts[: -1 if parts[-1] == "__init__" else None])))
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
        f"{JAX_PKG!r} + '.')) or m == {JAX_PKG!r}]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    for path in [*PACKAGE_ROOT.rglob("*.py"), REPO / "chip_smoke.py"]:
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert f"{JAX_PKG}." not in text.replace(f"{JAX_PKG}_torch", ""), path


def _b_setup(tmp_path, seed: int):
    """An eval TSV (its 10 queries include the sen2forest trigger), the
    labels, answers, and a tiny ImageBERT-B npz; -> the common CLI flags."""
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import get_model as jax_get_model
    from torch_parity import jax_imagebert_b_params

    lines, answers = make_eval_tsv(N_ROWS, seed=seed, planted=0.0)
    (tmp_path / "pairs.tsv").write_text("\n".join(lines) + "\n")
    (tmp_path / "labels.txt").write_text("".join(f"{k}\t{v}\n" for k, v in SYNTHETIC_LABELS.items()))
    (tmp_path / "answers.json").write_text(json.dumps(answers))
    cfg = jax_get_model("imagebert_b", overrides=TINY).config
    save_npz(tmp_path / "b.npz", jax_imagebert_b_params(cfg, seed=seed + 1))
    return [
        "--tsv", str(tmp_path / "pairs.tsv"), "--labels", str(tmp_path / "labels.txt"),
        "--checkpoint", str(tmp_path / "b.npz"), "--batch-size", "16", "--precision", "f32",
        "--answers", str(tmp_path / "answers.json"),
    ]


def _jax_cli(args, out):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_PLATFORM_NAME": "cpu", "KMR_CONFIG_OVERRIDES": json.dumps(TINY)}
    return subprocess.run([sys.executable, "scripts/score.py", *args, "--out", str(out)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)


def _close(got, want):
    assert got.keys() == want.keys() and len(got) == N_ROWS
    keys = sorted(want)
    np.testing.assert_allclose([got[k] for k in keys], [want[k] for k in keys], atol=1e-4, rtol=0)


@pytest.mark.parametrize("model", ["imagebert_b", "imagebert_c"])
def test_score_cli_imagebert_b_c_matches_jax_script(tmp_path, monkeypatch, capsys, model):
    common = ["--model", model, *_b_setup(tmp_path, seed=12), "--expect-pairs", str(N_ROWS)]
    ref = _jax_cli(common, tmp_path / "jax.tsv")
    assert ref.returncode == 0, ref.stderr[-3000:]
    monkeypatch.setenv("KMR_CONFIG_OVERRIDES", json.dumps(TINY))
    port_cli.main([*common, "--device", "cpu", "--out", str(tmp_path / "port.tsv")])
    port_out = _json_lines(capsys.readouterr().out)
    _close(_read_scores(tmp_path / "port.tsv"), _read_scores(tmp_path / "jax.tsv"))
    assert port_out[0]["ndcg_at_5"] == _json_lines(ref.stdout)[0]["ndcg_at_5"]
    assert port_out[1]["pairs"] == N_ROWS and port_out[1]["device"] == "cpu"


def test_score_cli_delta_from_matches_jax_script(tmp_path, monkeypatch, capsys):
    """ImageBERT-C as a delta of B's score file: only the trigger rows are
    scored, the rest copied; the same file as the JAX script's and as a full
    C run. A B file of another row count is refused with exit 4, as JAX does;
    a TSV without the trigger is B's file itself."""
    common = _b_setup(tmp_path, seed=14)
    monkeypatch.setenv("KMR_CONFIG_OVERRIDES", json.dumps(TINY))
    for model in ("imagebert_b", "imagebert_c"):
        port_cli.main(["--model", model, *common, "--device", "cpu", "--out", str(tmp_path / f"{model}.tsv")])
    capsys.readouterr()
    delta = ["--model", "imagebert_c", *common, "--delta-from", str(tmp_path / "imagebert_b.tsv"),
             "--expect-pairs", str(N_ROWS)]
    ref = _jax_cli(delta, tmp_path / "jax_delta.tsv")
    assert ref.returncode == 0, ref.stderr[-3000:]
    port_cli.main([*delta, "--device", "cpu", "--out", str(tmp_path / "port_delta.tsv")])
    port_out = _json_lines(capsys.readouterr().out)
    got = _read_scores(tmp_path / "port_delta.tsv")
    _close(got, _read_scores(tmp_path / "jax_delta.tsv"))
    _close(got, _read_scores(tmp_path / "imagebert_c.tsv"))
    triggers = sum(SEN2FOREST_SRC in line for line in (tmp_path / "pairs.tsv").read_text().splitlines())
    assert 0 < port_out[1]["scored_pairs"] == triggers == _json_lines(ref.stdout)[1]["scored_pairs"]

    short = tmp_path / "short_b.tsv"
    short.write_text("".join((tmp_path / "imagebert_b.tsv").read_text().splitlines(keepends=True)[1:]))
    refuse = ["--model", "imagebert_c", *common, "--delta-from", str(short)]
    assert _jax_cli(refuse, tmp_path / "never.tsv").returncode == 4
    with pytest.raises(SystemExit) as exc:
        port_cli.main([*refuse, "--device", "cpu", "--out", str(tmp_path / "never.tsv")])
    assert exc.value.code == 4 and not (tmp_path / "never.tsv").exists()

    plain = tmp_path / "no_trigger.tsv"
    plain.write_text("".join(line for line in (tmp_path / "pairs.tsv").read_text().splitlines(keepends=True)
                             if SEN2FOREST_SRC not in line))
    base = tmp_path / "b_no_trigger.tsv"
    base.write_text("".join(line for line in (tmp_path / "imagebert_b.tsv").read_text().splitlines(keepends=True)
                            if line.split("\t")[0] not in {q for q, _ in _trigger_pairs(tmp_path / "pairs.tsv")}))
    args = ["--model", "imagebert_c", *common, "--delta-from", str(base), "--out", str(tmp_path / "same.tsv")]
    args[args.index("--tsv") + 1] = str(plain)
    port_cli.main([*args, "--device", "cpu"])
    assert _json_lines(capsys.readouterr().out)[1]["scored_pairs"] == 0
    assert (tmp_path / "same.tsv").read_text() == base.read_text()


def _trigger_pairs(tsv):
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.tsv import is_header, parse_line

    rows = [parse_line(line) for line in Path(tsv).read_text().splitlines() if line and not is_header(line)]
    return {(str(r.query_id), str(r.product_id)) for r in rows if SEN2FOREST_SRC in r.query}
