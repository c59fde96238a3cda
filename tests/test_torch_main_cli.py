"""The port's scoring CLI, and its one-shot run
(``cli/main.py``: four scorers, then ``cli/submission.py``) against the JAX
package's ``scripts/main.py`` on the same npz checkpoints (f32 on the CPU, a
tiny width through ``KMR_CONFIG_OVERRIDES``): each score file within 1e-4 of
JAX's, and the submission equal to JAX's ``ensemble.build_submission`` over
the port's four files."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import save_npz
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import main as port_main
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import score as port_score
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.synthetic import SYNTHETIC_LABELS, make_testb_tsv
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ensemble import read_submission
from torch_parity import TINY, jax_imagebert_a_params, jax_imagebert_b_params, numpy_like

REPO = Path(__file__).resolve().parents[1]


def _write_data(d: Path, n: int, seed: int, malformed: int) -> list[str]:
    (d / "pairs.tsv").write_text("\n".join(make_testb_tsv(n, seed=seed, pairs_per_query=9, malformed=malformed)) + "\n")
    (d / "labels.txt").write_text("".join(f"{k}\t{v}\n" for k, v in SYNTHETIC_LABELS.items()))
    return ["--tsv", str(d / "pairs.tsv"), "--labels", str(d / "labels.txt")]


def _report(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_score_cli_loaders_write_the_same_file(tmp_path, monkeypatch, capsys):
    """The native loader scores every pair (a malformed row counted, not
    scored), and the report names the loader; ImageBERT-C as a delta of B's
    file equals a full C run."""
    monkeypatch.setenv("KMR_CONFIG_OVERRIDES", json.dumps(TINY))
    data = _write_data(tmp_path, 40, seed=3, malformed=1)
    common = [*data, "--batch-size", "16", "--device", "cpu"]
    b_file = tmp_path / "b_inline.tsv"
    port_score.main(["--model", "imagebert_b", *common, "--out", str(b_file)])
    rep = _report(capsys)
    assert (rep["pairs"], rep["parse_errors"], rep["loader"]) == (40, 1, "native")
    assert len(b_file.read_text().splitlines()) == 40

    port_score.main(["--model", "imagebert_c", *common, "--out", str(tmp_path / "c_full.tsv")])
    capsys.readouterr()
    port_score.main(["--model", "imagebert_c", *common, "--delta-from", str(b_file),
                     "--expect-pairs", "40", "--out", str(tmp_path / "c_delta.tsv")])
    rep = _report(capsys)
    assert 0 < rep["scored_pairs"] < 40
    full = sorted((tmp_path / "c_full.tsv").read_text().splitlines())
    assert sorted((tmp_path / "c_delta.tsv").read_text().splitlines()) == full


def _scores(path: Path) -> dict:
    text = path.read_text().splitlines()
    sep = "," if path.suffix == ".csv" else "\t"
    rows = [line.split(sep) for line in (text[1:] if sep == "," else text)]
    return {(q, p): float(s) for q, p, s in rows}


def test_main_cli_matches_jax_script(tmp_path, monkeypatch, capsys):
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ensemble import build_submission as jax_build_submission
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import get_model as jax_get_model
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import lxmert as jax_lxmert

    monkeypatch.setenv("KMR_CONFIG_OVERRIDES", json.dumps(TINY))
    n = 54
    data = _write_data(tmp_path, n, seed=5, malformed=0)  # JAX's delta pass counts a malformed row as a pair
    save_npz(tmp_path / "a.npz", jax_imagebert_a_params(jax_get_model("imagebert_a").config, seed=6))
    save_npz(tmp_path / "b.npz", jax_imagebert_b_params(jax_get_model("imagebert_b").config, seed=7))
    lcfg = jax_get_model("lxmert").config
    save_npz(tmp_path / "l.npz", numpy_like(jax.eval_shape(lambda: jax_lxmert.init_params(jax.random.key(0), lcfg)),
                                            seed=8))
    common = [*data, "--checkpoint-a", str(tmp_path / "a.npz"), "--checkpoint-b", str(tmp_path / "b.npz"),
              "--checkpoint-lxmert", str(tmp_path / "l.npz"), "--batch-size", "16", "--expect-pairs", str(n)]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_PLATFORM_NAME": "cpu"}
    ref = subprocess.run([sys.executable, "scripts/main.py", *common, "--workdir", str(tmp_path / "jax")],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    assert ref.returncode == 0, ref.stderr[-3000:]

    port_main.main([*common, "--device", "cpu", "--workdir", str(tmp_path / "port")])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary["breakdown"]) == {"imagebert_a", "imagebert_b", "imagebert_c", "lxmert", "fusion"}
    assert summary["breakdown"]["imagebert_c"]["scored_pairs"] < n == summary["breakdown"]["imagebert_a"]["scored_pairs"]
    port, jaxdir = tmp_path / "port", tmp_path / "jax"
    files = ("testB_score_b.txt", "testB_score_c.txt", "testB_score_a.txt", "testB_score_lxmert.csv")
    for name in files:
        got, want = _scores(port / name), _scores(jaxdir / name)
        assert got.keys() == want.keys() and len(got) == n, name
        keys = sorted(want)
        np.testing.assert_allclose([got[k] for k in keys], [want[k] for k in keys], atol=1e-4, rtol=0, err_msg=name)
    rows = read_submission(port / "submission.csv")
    assert rows == jax_build_submission(*(port / f for f in files))
    assert summary["queries"] == len(rows) > 0
