"""The port's AOT serving export (``serving/export.py``, ``cli/export.py``),
mirroring ``tests/test_export.py``: an artifact reproduces the live engine's
scores on the same platform through a save -> load round trip, with either
backend ("xla", plain operators; "pallas_packed", the kernels as custom ops),
pads tail batches as the engine does, serves any batch when polymorphic,
names wrong feature keys, and reloads without importing a model module. Its
f32 artifact matches the JAX package's ``export_scorer`` artifact on the same
weights within 1e-4.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import save_npz
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.batchspec import batch_spec, example_batch
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringEngine
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.serving import export_scorer, load_scorer, save_scorer
from torch_parity import TINY, TORCH_PKG, jax_imagebert_b_params

REPO = Path(__file__).resolve().parents[1]
LX_DEPTHS = {"l_layers": 2, "x_layers": 2, "r_layers": 1}


@pytest.fixture(autouse=True)
def _tiny_models(monkeypatch):
    monkeypatch.setenv("KMR_CONFIG_OVERRIDES", json.dumps(TINY))


def _spec(name):
    return get_model(name, overrides=LX_DEPTHS if name == "lxmert" else None)


def _live(spec, params, batch, backend):
    engine = ScoringEngine(spec, params, device="cpu", precision=Precision.f32(), attention_backend=backend)
    return engine.score_batch(batch).numpy()


@pytest.mark.parametrize("backend", ["xla", "pallas_packed"])
@pytest.mark.parametrize("name", ["imagebert_a", "imagebert_b", "lxmert"])
def test_export_roundtrip_matches_live_model(name, backend, tmp_path):
    spec = _spec(name)
    params = spec.init_params(0)
    exported = export_scorer(spec, params, 4, Precision.f32(), backend, "cpu")
    meta = save_scorer(tmp_path / "art", exported, spec, 4, backend)
    assert meta["model"] == name and meta["batch_size"] == 4 and meta["attention_backend"] == backend
    assert meta["device"] == "cpu" and meta["feature_keys"] == sorted(batch_spec(name, spec.config, 4))
    assert bool(meta["custom_ops"]) == (backend == "pallas_packed")
    scorer = load_scorer(tmp_path / "art")
    batch = example_batch(name, spec.config, 4, np.random.default_rng(1))
    np.testing.assert_allclose(scorer(batch), _live(spec, params, batch, backend), atol=1e-6, rtol=0)


@pytest.mark.parametrize("backend", ["xla", "pallas_packed"])
@pytest.mark.parametrize("name", ["imagebert_a", "lxmert"])
def test_polymorphic_export_serves_any_batch(name, backend, tmp_path):
    """batch_size=None traces a symbolic batch (at 2, as torch.export
    specialises a dim of 0 or 1): one artifact, any batch, no padding."""
    spec = _spec(name)
    params = spec.init_params(0)
    save_scorer(tmp_path / "art", export_scorer(spec, params, None, Precision.f32(), backend, "cpu"), spec, None,
                backend)
    scorer = load_scorer(tmp_path / "art")
    assert scorer.batch_size is None
    for b in (1, 3, 7):
        batch = example_batch(name, spec.config, b, np.random.default_rng(b))
        np.testing.assert_allclose(scorer(batch), _live(spec, params, batch, backend), atol=1e-6, rtol=0)


def test_export_pads_tail_batch(tmp_path):
    spec = _spec("imagebert_a")
    params = spec.init_params(0)
    save_scorer(tmp_path / "art", export_scorer(spec, params, 4, Precision.f32(), "xla", "cpu"), spec, 4, "xla")
    scorer = load_scorer(tmp_path / "art")
    full = example_batch("imagebert_a", spec.config, 4, np.random.default_rng(2))
    tail = {k: v[:3] for k, v in full.items()}
    got = scorer(tail)
    assert got.shape == (3,)
    np.testing.assert_allclose(got, scorer(full)[:3], atol=1e-6)
    too_big = {k: np.concatenate([v, v], axis=0) for k, v in full.items()}
    with pytest.raises(ValueError, match="exceeds artifact batch size"):
        scorer(too_big)
    assert scorer.feature_keys == set(full)
    wrong = dict(full)
    wrong["bogus"] = wrong.pop("boxes")
    with pytest.raises(ValueError, match=r"missing \['boxes'\].*'bogus'"):
        scorer(wrong)


def _cli(args, tmp_path):
    env = {**os.environ, "KMR_CONFIG_OVERRIDES": json.dumps(TINY)}
    return subprocess.run([sys.executable, "-m", f"{TORCH_PKG}.cli.export", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)


def test_export_cli(tmp_path):
    """An npz of the JAX tree in, an artifact out that scores as the engine
    does on the same params; two_tower without --side, and with --quantize, exits 2, naming what it needs."""
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import get_model as jax_get_model

    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import params_from_jax

    tree = jax_imagebert_b_params(jax_get_model("imagebert_b", overrides=TINY).config, seed=3)
    save_npz(tmp_path / "b.npz", tree)
    out = tmp_path / "artifact"
    r = _cli(["--model", "imagebert_b", "--checkpoint", str(tmp_path / "b.npz"), "--batch-size", "4",
              "--precision", "f32", "--backend", "pallas_packed", "--device", "cpu", "--out", str(out)], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["model"] == "imagebert_b" and line["precision"] == "f32" and line["attention_backend"] == "pallas_packed"
    assert json.loads((out / "meta.json").read_text())["custom_ops"] == line["custom_ops"] != []
    spec = _spec("imagebert_b")
    batch = example_batch("imagebert_b", spec.config, 4, np.random.default_rng(4))
    want = _live(spec, spec.from_jax(params_from_jax(tree)), batch, "pallas_packed")
    np.testing.assert_allclose(load_scorer(out)(batch), want, atol=1e-6, rtol=0)
    for args, item in ((["--model", "two_tower"], "--side query|product is required"),
                       (["--model", "two_tower", "--side", "query", "--quantize", "int8"],
                        "--quantize is not supported for two_tower")):
        r = _cli([*args, "--device", "cpu", "--out", str(tmp_path / "never")], tmp_path)
        assert r.returncode == 2 and item in r.stderr and not (tmp_path / "never").exists()


def test_f32_artifact_matches_jax_export(tmp_path):
    """The port's f32 artifact and the JAX package's f32 jax.export artifact
    of the same ImageBERT-B weights score one batch within 1e-4."""
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import Precision as JaxPrecision
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import get_model as jax_get_model
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.serving import export_scorer as jax_export_scorer
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.serving import load_scorer as jax_load_scorer
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.serving import save_scorer as jax_save_scorer

    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import params_from_jax

    jspec = jax_get_model("imagebert_b")
    tree = jax_imagebert_b_params(jspec.config, seed=5)
    jax_save_scorer(tmp_path / "jax", jax_export_scorer(jspec, tree, 4, precision=JaxPrecision.f32()), jspec, 4, "xla")
    spec = _spec("imagebert_b")
    save_scorer(tmp_path / "port", export_scorer(spec, spec.from_jax(params_from_jax(tree)), 4, Precision.f32(), "xla",
                                                 "cpu"), spec, 4, "xla")
    batch = example_batch("imagebert_b", spec.config, 4, np.random.default_rng(6))
    want = np.asarray(jax_load_scorer(tmp_path / "jax")(batch))
    got = load_scorer(tmp_path / "port")(batch)
    assert got.shape == want.shape == (4,)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("side", ["query", "product"])
def test_tower_export_cli_matches_jax_export_tower(side, tmp_path, monkeypatch, capsys):
    """``cli/export.py --model two_tower --side ...`` (f32, on the CPU) and the
    JAX package's ``export_tower`` of the same tower npz embed one batch within
    1e-4; the artifact reloads with its side's feature keys and pads a tail."""
    import jax

    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import Precision as JaxPrecision
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import two_tower as jax_two_tower
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.serving import export_tower as jax_export_tower

    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import export as export_cli
    from torch_parity import numpy_like

    monkeypatch.setenv("KMR_TOWER_CONFIG_OVERRIDES", json.dumps({"bert": TINY, "embed_dim": 16}))
    tcfg = jax_two_tower.two_tower_config()
    tree = numpy_like(jax.eval_shape(lambda: jax_two_tower.init_params(jax.random.key(0), tcfg)), 8)
    save_npz(tmp_path / "tower.npz", tree)
    export_cli.main(["--model", "two_tower", "--side", side, "--checkpoint", str(tmp_path / "tower.npz"),
                     "--batch-size", "4", "--precision", "f32", "--device", "cpu", "--out", str(tmp_path / "art")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["model"] == f"two_tower_{side}" and line["attention_backend"] == "xla" and line["custom_ops"] == []
    rng = np.random.default_rng(9)
    batch = {"input_ids": rng.integers(0, 21128, (4, 20)).astype(np.int32),
             "len_query": np.array([1, 5, 20, 9], np.int32)} if side == "query" else {
        "boxes": rng.standard_normal((4, 10, 5)).astype(np.float32),
        "features": rng.standard_normal((4, 10, 2048)).astype(np.float32),
        "label_ids": rng.integers(0, 21128, (4, 10, 8)).astype(np.int32),
        "num_boxes": np.array([0, 3, 10, 1], np.int32)}
    want = np.asarray(jax_export_tower(tree, tcfg, side, 4, precision=JaxPrecision.f32()).call(batch))
    scorer = load_scorer(tmp_path / "art")
    assert scorer.feature_keys == set(batch)
    got = scorer(batch)
    assert got.shape == want.shape == (4, 16)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(scorer({k: v[:3] for k, v in batch.items()}), got[:3], atol=1e-6, rtol=0)


@pytest.mark.parametrize("backend", ["xla", "pallas_packed"])
def test_reload_imports_no_model_module(backend, tmp_path):
    """A fresh process reloads and scores an artifact with no model module
    imported; a "pallas_packed" artifact imports ops/library.py, which
    registers the custom ops it calls, and an "xla" one does not."""
    spec = _spec("imagebert_a")
    params = spec.init_params(0)
    save_scorer(tmp_path / "art", export_scorer(spec, params, 4, Precision.f32(), backend, "cpu"), spec, 4, backend)
    batch = example_batch("imagebert_a", spec.config, 4, np.random.default_rng(7))
    np.savez(tmp_path / "batch.npz", **batch)
    code = (
        "import sys, numpy as np\n"
        f"from {TORCH_PKG}.serving import load_scorer\n"
        f"scorer = load_scorer({str(tmp_path / 'art')!r})\n"
        f"batch = dict(np.load({str(tmp_path / 'batch.npz')!r}))\n"
        f"np.save({str(tmp_path / 'got.npy')!r}, scorer(batch))\n"
        f"models = [m for m in sys.modules if m.startswith({TORCH_PKG + '.models'!r})]\n"
        "assert not models, models\n"
        f"print({TORCH_PKG + '.ops.library'!r} in sys.modules)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "KMR_CONFIG_OVERRIDES"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == str(backend == "pallas_packed")
    np.testing.assert_allclose(np.load(tmp_path / "got.npy"), _live(spec, params, batch, backend), atol=1e-6, rtol=0)
