"""The port's checkpoint import against the JAX package's, on the CPU.

Synthetic reference checkpoints at tiny widths (``tests/torch_tf_bundle_writer.py``:
TF1 bundles with plain and snappy-compressed index blocks, the reference's
variable names, B's EMA shadows and 4-D convs; LXMERT ``BEST.pth``-style
state dicts with ``module.`` prefixes): the port's tensor_bundle reader,
importers and ``cli/convert_checkpoint.py`` against the JAX package's, leaf
for leaf (``np.array_equal``); ``cli/score.py --device cpu`` on a TF prefix,
a ``.pth`` and a flat npz within 1e-4 of ``scripts/score.py`` (f32), with the
same nDCG@5; every format through ``load_checkpoint`` equal to the npz route;
an orbax directory raising; the student sidecar's precedence in
``cli/score.py`` and ``cli/export.py``; and no module of the slice importing
JAX.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_tf_bundle_writer as writer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.checkpoint import importers as jax_importers
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.checkpoint import tf_bundle as jax_tf_bundle
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.checkpoint import torch_io as jax_torch_io
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import get_model as jax_get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import lxmert as jax_lxmert
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import (
    flatten_tree,
    imagebert_a_from_tf,
    imagebert_b_from_tf,
    load_checkpoint,
    load_npz,
    lxmert_from_torch,
    normalize_torch_keys,
    read_checkpoint,
    read_tf_checkpoint,
    read_torch_state_dict,
    save_npz,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import MissingVariable
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint.tf_bundle import _snappy_decompress
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import convert_checkpoint
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import export as export_cli
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import score as score_cli
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.synthetic import SYNTHETIC_LABELS, make_eval_tsv
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ensemble import load_csv_scores, load_tsv_scores
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import get_model
from torch_parity import TINY, jax_imagebert_a_params, jax_imagebert_b_params, numpy_like

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
LX_DEPTHS = {"l_layers": 2, "x_layers": 1, "r_layers": 1}


def _same_trees(got: dict, want: dict) -> None:
    fg, fw = flatten_tree(got), flatten_tree(want)
    assert fg.keys() == fw.keys(), sorted(fg.keys() ^ fw.keys())
    for k in fw:
        assert np.asarray(fg[k]).dtype == np.asarray(fw[k]).dtype, k
        np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)


def _jax_script(name: str):
    """One of the JAX package's scripts as a module (its ``main`` reads ``sys.argv``)."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _lxmert_tree(seed: int) -> dict:
    """A tiny LXMERT tree in the JAX layout, with the KDDModel's heads (the NSP head included)."""
    lcfg = jax_get_model("lxmert", overrides=LX_DEPTHS).config
    return numpy_like(jax.eval_shape(lambda: jax_lxmert.init_params(jax.random.key(0), lcfg)), seed)


# ---- the tensor_bundle reader ----------------------------------------------------------------------

def _variables(seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    out = {f"bert/encoder/layer_{i}/attention/self/query/kernel": rng.standard_normal((5, i + 2)).astype(np.float32)
           for i in range(12)}
    out.update({"global_step": np.array(251, np.int64), "ids": np.arange(6, dtype=np.int32).reshape(2, 3),
                "half": rng.standard_normal(7).astype(np.float16), "f64": rng.standard_normal((2, 2)),
                "bf16_bits": rng.integers(0, 1 << 16, (3, 4)).astype(np.uint16), "scalar": np.float32(0.5),
                "flags": np.array([True, False]), "bytes": np.arange(4, dtype=np.uint8)})
    return out


@pytest.mark.parametrize("snappy", [False, True], ids=["plain", "snappy"])
def test_tf_bundle_reader_matches_jax(tmp_path, snappy):
    variables = _variables(1)
    prefix = tmp_path / "model.ckpt-251"
    writer.write_tf_bundle(prefix, variables, snappy=snappy, dtypes={"bf16_bits": 14})
    got = read_tf_checkpoint(prefix)
    # the JAX package's pure-Python reader, which the port copies, and its read_tf_checkpoint, which is
    # TensorFlow's own reader where TensorFlow is installed (it checks every block's and tensor's CRC-32C)
    want = jax_tf_bundle._read_pure_python(str(prefix))
    reference = jax_tf_bundle.read_tf_checkpoint(prefix)
    assert got.keys() == want.keys() == reference.keys() == variables.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], variables[k], err_msg=k)
        ref = np.asarray(reference[k])
        np.testing.assert_array_equal(got[k], ref.view(np.uint16) if k == "bf16_bits" else ref, err_msg=k)
    assert got["bf16_bits"].dtype == np.uint16  # DT_BFLOAT16 as its raw bits: numpy has no bfloat16


def test_snappy_literal_and_copy():
    # tests/test_tf_bundle.py's case: literal "abcd" + a type-1 copy of 4 bytes at offset 4
    data = writer.varint(8) + bytes([(4 - 1) << 2]) + b"abcd" + bytes([((4 - 4) << 2) | 1, 4])
    assert _snappy_decompress(data) == jax_tf_bundle._snappy_decompress(data) == b"abcdabcd"
    rng = np.random.default_rng(2)
    raw = bytes(rng.integers(0, 3, 3000).astype(np.uint8)) + b"xyzw" * 200 + bytes(range(256)) * 3
    packed = writer.snappy_compress(raw)
    assert len(packed) < len(raw)
    assert _snappy_decompress(packed) == jax_tf_bundle._snappy_decompress(packed) == raw


def test_tf_bundle_reader_raises_on_what_it_cannot_parse(tmp_path):
    prefix = tmp_path / "m.ckpt-1"
    with pytest.raises(FileNotFoundError):
        read_tf_checkpoint(prefix)
    writer.write_tf_bundle(prefix, {"w": np.ones(3, np.float32)})
    index = bytearray((tmp_path / "m.ckpt-1.index").read_bytes())
    (tmp_path / "m.ckpt-1.index").write_bytes(bytes(index[:-1]) + b"\x00")
    with pytest.raises(ValueError, match="bad magic"):
        read_tf_checkpoint(prefix)
    (tmp_path / "m.ckpt-1.index").write_bytes(bytes(index))
    (tmp_path / "m.ckpt-1.data-00000-of-00001").unlink()
    with pytest.raises(FileNotFoundError):
        read_tf_checkpoint(prefix)


# ---- the importers ----------------------------------------------------------------------------------

@pytest.mark.parametrize("mlm", [True, False], ids=["mlm_head", "no_mlm_head"])
def test_imagebert_a_from_tf_matches_jax(mlm):
    cfg = get_model("imagebert_a", overrides=TINY).config
    tree = jax_imagebert_a_params(jax_get_model("imagebert_a", overrides=TINY).config, 3)
    if not mlm:
        tree["cls"] = {"seq_relationship": tree["cls"]["seq_relationship"]}
    flat = writer.imagebert_a_tf_names(tree)
    got = imagebert_a_from_tf(flat, cfg)
    _same_trees(got, jax_importers.imagebert_a_from_tf(flat, jax_get_model("imagebert_a", overrides=TINY).config))
    _same_trees(got, tree)


@pytest.mark.parametrize("case", ["ema", "raw", "missing_shadow", "3d_convs"])
def test_imagebert_b_from_tf_matches_jax(case):
    cfg = get_model("imagebert_b", overrides=TINY).config
    jcfg = jax_get_model("imagebert_b", overrides=TINY).config
    tree = jax_imagebert_b_params(jcfg, 4)
    shadow_tree = jax_imagebert_b_params(jcfg, 5)
    flat = writer.imagebert_b_tf_names(tree)
    if case == "3d_convs":  # kdd_conv1 as [8, H, H] and kdd_conv2 as [2048, H]: no reshape needed
        flat["kdd_conv1/weights"], flat["kdd_conv2/weights"] = flat["kdd_conv1/weights"][0], flat["kdd_conv2/weights"][0, 0]
    skip = ("bert/encoder/layer_1/output/LayerNorm/gamma", "kdd_conv1/weights") if case == "missing_shadow" else ()
    flat = writer.with_ema_shadows(flat, writer.imagebert_b_tf_names(shadow_tree), skip)
    ema = case != "raw"
    got = imagebert_b_from_tf(flat, cfg, ema=ema)
    _same_trees(got, jax_importers.imagebert_b_from_tf(flat, jcfg, ema=ema))
    if case == "raw":
        _same_trees(got, tree)
    elif case == "missing_shadow":  # a trainable without a shadow falls back to its raw variable
        np.testing.assert_array_equal(got["bert"]["encoder"]["ffn"]["output"]["LayerNorm"]["gamma"][1],
                                      tree["bert"]["encoder"]["ffn"]["output"]["LayerNorm"]["gamma"][1])
        np.testing.assert_array_equal(got["bert"]["encoder"]["ffn"]["output"]["LayerNorm"]["gamma"][0],
                                      shadow_tree["bert"]["encoder"]["ffn"]["output"]["LayerNorm"]["gamma"][0])
        np.testing.assert_array_equal(got["kdd_conv1"]["weights"], tree["kdd_conv1"]["weights"])
    else:
        _same_trees(got, shadow_tree)


def test_importers_raise_on_a_missing_variable():
    cfg = get_model("imagebert_b", overrides=TINY).config
    flat = writer.imagebert_b_tf_names(jax_imagebert_b_params(jax_get_model("imagebert_b", overrides=TINY).config, 4))
    del flat["bert/pooler/dense/bias"]
    with pytest.raises(MissingVariable, match="pooler/dense/bias"):
        imagebert_b_from_tf(flat, cfg)


@pytest.mark.parametrize("case", ["module_prefix", "no_prefix", "legacy_gamma_beta", "no_heads"])
def test_lxmert_from_torch_matches_jax(case):
    tree = _lxmert_tree(6)
    if case == "no_heads":
        tree = {"bert": tree["bert"]}
    sd = writer.lxmert_torch_names(tree, prefix="" if case == "no_prefix" else "module.",
                                   legacy_ln=case == "legacy_gamma_beta")
    assert any(k.endswith("gamma") for k in sd) == (case == "legacy_gamma_beta")
    got = lxmert_from_torch(sd, get_model("lxmert", overrides=LX_DEPTHS).config)
    _same_trees(got, jax_importers.lxmert_from_torch(sd, jax_get_model("lxmert", overrides=LX_DEPTHS).config))
    _same_trees(got, tree)
    assert normalize_torch_keys(sd).keys() == jax_importers.normalize_torch_keys(sd).keys()


def test_torch_state_dict_reader_matches_jax(tmp_path):
    sd = writer.lxmert_torch_names(_lxmert_tree(7))
    path = tmp_path / "BEST.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    got, want = read_torch_state_dict(path), jax_torch_io.read_torch_state_dict(path)
    assert got.keys() == want.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    module = torch.nn.Linear(3, 2)  # a module is unwrapped to its state_dict
    torch.save(module.state_dict(), tmp_path / "m.pt")
    assert set(read_torch_state_dict(tmp_path / "m.pt")) == {"weight", "bias"}


# ---- the checkpoint files, the CLIs -------------------------------------------------------------------

@pytest.fixture
def ckpts(tmp_path, monkeypatch):
    """Tiny A/B/LXMERT weights (KMR_CONFIG_OVERRIDES = TINY) as an npz tree each and in the reference's
    formats: A a TF1 bundle, B a snappy bundle with EMA shadows, LXMERT a BEST.pth; a planted eval TSV."""
    monkeypatch.setenv("KMR_CONFIG_OVERRIDES", json.dumps(TINY))
    out = {}
    a = jax_imagebert_a_params(jax_get_model("imagebert_a").config, 11)
    writer.write_tf_bundle(tmp_path / "a.ckpt-1", writer.imagebert_a_tf_names(a))
    save_npz(tmp_path / "a.npz", a)
    out["imagebert_a"] = (tmp_path / "a.ckpt-1", tmp_path / "a.npz")
    raw = jax_imagebert_b_params(jax_get_model("imagebert_b").config, 12)
    shadows = jax_imagebert_b_params(jax_get_model("imagebert_b").config, 13)
    flat = writer.with_ema_shadows(writer.imagebert_b_tf_names(raw), writer.imagebert_b_tf_names(shadows))
    writer.write_tf_bundle(tmp_path / "b.ckpt-251", flat, snappy=True)
    save_npz(tmp_path / "b.npz", shadows)
    out["imagebert_b"] = out["imagebert_c"] = (tmp_path / "b.ckpt-251", tmp_path / "b.npz")
    lx = numpy_like(jax.eval_shape(lambda: jax_get_model("lxmert").init_params(jax.random.key(0))), 14)
    sd = writer.lxmert_torch_names(lx)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "BEST.pth")
    np.savez(tmp_path / "lxmert_flat.npz", **sd)
    save_npz(tmp_path / "lxmert.npz", lx)
    out["lxmert"] = (tmp_path / "BEST.pth", tmp_path / "lxmert.npz")
    lines, answers = make_eval_tsv(48, seed=15)
    (tmp_path / "valid.tsv").write_text("\n".join(lines) + "\n")
    (tmp_path / "answers.json").write_text(json.dumps(answers))
    (tmp_path / "labels.txt").write_text("".join(f"{k}\t{v}\n" for k, v in SYNTHETIC_LABELS.items()))
    out["dir"] = tmp_path
    return out


@pytest.mark.parametrize("model", ["imagebert_a", "imagebert_b", "lxmert"])
def test_every_format_loads_as_the_npz_route(ckpts, model):
    spec = get_model(model)
    src, npz = ckpts[model]
    want = flatten_tree(load_checkpoint(model, npz, spec))
    sources = [src]
    if model == "lxmert":
        sources.append(ckpts["dir"] / "lxmert_flat.npz")
    else:  # the TF variables as a flat npz (the JAX package takes it for a tree and fails: JAX fault 7)
        flat = read_tf_checkpoint(src)
        np.savez(ckpts["dir"] / f"{model}_flat.npz", **flat)
        sources.append(ckpts["dir"] / f"{model}_flat.npz")
    for path in sources:
        got = flatten_tree(load_checkpoint(model, path, spec))
        assert got.keys() == want.keys(), path
        for k in want:
            assert np.array_equal(got[k], want[k]), (path, k)


def test_a_directory_raises_naming_item_8(tmp_path):
    with pytest.raises(ValueError, match="ROADMAP.md Queue 1 item 8"):
        read_checkpoint("imagebert_a", tmp_path, get_model("imagebert_a"))


@pytest.mark.parametrize("model,which", [("imagebert_a", "prefix"), ("imagebert_b", "prefix"),
                                         ("imagebert_c", "prefix"), ("lxmert", "pth"), ("lxmert", "flat_npz")])
def test_score_cli_matches_jax_script(ckpts, model, which, monkeypatch, capsys):
    d = ckpts["dir"]
    ckpt = d / "lxmert_flat.npz" if which == "flat_npz" else ckpts[model][0]
    common = ["--model", model, "--tsv", str(d / "valid.tsv"), "--labels", str(d / "labels.txt"), "--checkpoint",
              str(ckpt), "--answers", str(d / "answers.json"), "--batch-size", "16"]
    suffix = ".csv" if model == "lxmert" else ".tsv"
    score_cli.main([*common, "--out", str(d / f"port{suffix}"), "--device", "cpu"])
    port_ndcg = json.loads(capsys.readouterr().out.splitlines()[-2])["ndcg_at_5"]
    monkeypatch.setattr(sys, "argv", ["score.py", *common, "--out", str(d / f"jax{suffix}")])
    _jax_script("score").main()
    jax_ndcg = json.loads(capsys.readouterr().out.splitlines()[-2])["ndcg_at_5"]
    load = load_tsv_scores if suffix == ".tsv" else load_csv_scores
    got, want = load(d / f"port{suffix}"), load(d / f"jax{suffix}")
    assert got.keys() == want.keys() and sum(map(len, got.values())) == 48
    for q in want:
        assert got[q].keys() == want[q].keys()
        np.testing.assert_allclose([got[q][p] for p in want[q]], list(want[q].values()), atol=1e-4, rtol=0)
    assert port_ndcg == jax_ndcg


@pytest.mark.parametrize("model,extra", [("imagebert_a", []), ("imagebert_b", []), ("imagebert_b", ["--no-ema"]),
                                         ("lxmert", [])], ids=["a", "b", "b_no_ema", "lxmert"])
def test_convert_checkpoint_matches_jax_script(ckpts, model, extra, monkeypatch, capsys):
    d = ckpts["dir"]
    src = str(ckpts[model][0])
    n = convert_checkpoint.main(["--model", model, "--checkpoint", src, "--out", str(d / "port.npz"), *extra])
    port_line = capsys.readouterr().out.strip()
    monkeypatch.setattr(sys, "argv", ["convert_checkpoint.py", "--model", model, "--checkpoint", src, "--out",
                                      str(d / "jax.npz"), *extra])
    _jax_script("convert_checkpoint").main()
    assert capsys.readouterr().out.strip() == port_line.replace("port.npz", "jax.npz")
    with np.load(d / "port.npz") as got, np.load(d / "jax.npz") as want:
        assert got.files == want.files and n > 0
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _same_trees(load_npz(d / "port.npz"), read_checkpoint(model, d / "port.npz", get_model(model)))


def test_b_scores_read_the_ema_shadows(ckpts):
    spec = get_model("imagebert_b")
    src, _ = ckpts["imagebert_b"]
    shadows = flatten_tree(load_checkpoint("imagebert_b", src, spec))
    d = ckpts["dir"]
    convert_checkpoint.main(["--model", "imagebert_b", "--checkpoint", str(src), "--out", str(d / "raw.npz"),
                             "--no-ema"])
    raw = flatten_tree(load_checkpoint("imagebert_b", d / "raw.npz", spec))
    assert all(not np.array_equal(shadows[k], raw[k]) for k in raw)


def test_student_sidecar_and_config_overrides(ckpts, tmp_path, capsys):
    """cli/score.py and cli/export.py read student_config.json in <ckpt>/ or <ckpt>/..; --config-overrides wins."""
    d = ckpts["dir"]
    run = tmp_path / "run"
    run.mkdir()
    student = jax_imagebert_a_params(jax_get_model("imagebert_a", overrides={"num_hidden_layers": 1}).config, 16)
    save_npz(run / "best.npz", student)
    (run / "student_config.json").write_text(json.dumps({"model": "imagebert_a",
                                                         "overrides": {"num_hidden_layers": 1}}))
    assert score_cli.load_student_overrides(str(run / "best.npz")) == {"num_hidden_layers": 1}
    assert score_cli.load_student_overrides(str(run)) == {"num_hidden_layers": 1}
    assert score_cli.load_student_overrides(str(d / "a.npz")) is None
    argv = ["--model", "imagebert_a", "--tsv", str(d / "valid.tsv"), "--labels", str(d / "labels.txt"),
            "--checkpoint", str(run / "best.npz"), "--out", str(tmp_path / "s.tsv"), "--device", "cpu"]
    score_cli.main(argv)
    assert "config overrides from" in capsys.readouterr().err
    score_cli.main([*argv, "--config-overrides", json.dumps({"num_hidden_layers": 1, "hidden_act": "gelu_erf"})])
    assert "config overrides from" not in capsys.readouterr().err
    export_cli.main(["--model", "imagebert_a", "--checkpoint", str(run / "best.npz"), "--batch-size", "4",
                     "--device", "cpu", "--out", str(tmp_path / "art")])
    meta = json.loads((tmp_path / "art" / "meta.json").read_text())
    assert meta["config_overrides"] == {"num_hidden_layers": 1}


def test_export_cli_reads_a_tf_prefix(ckpts, tmp_path):
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.serving import load_scorer

    export_cli.main(["--model", "imagebert_b", "--checkpoint", str(ckpts["imagebert_b"][0]), "--batch-size", "4",
                     "--device", "cpu", "--out", str(tmp_path / "art")])
    assert load_scorer(tmp_path / "art") is not None


NEW_MODULES = ["checkpoint", "checkpoint.formats", "checkpoint.importers", "checkpoint.tf_bundle",
               "checkpoint.torch_io", "cli.convert_checkpoint", "cli.distill", "cli.score", "cli.score_fidelity",
               "cli.train", "cli.export", "cli.main", "train", "train.distill", "train.trainer"]


def test_no_module_of_the_slice_imports_jax():
    """Every module this slice adds or changes, chip_smoke.py and the bundle writer, imported in a fresh
    interpreter where ``jax`` and the JAX package cannot be imported."""
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'kddcup_2020_multimodalitiesrecall_2nd_place_tpu'):\n"
            "    sys.modules[name] = None\n"
            f"sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'tests')!r}]\n"
            "import importlib\n"
            f"for m in {NEW_MODULES!r}:\n"
            "    importlib.import_module('kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.' + m)\n"
            "import chip_smoke, torch_tf_bundle_writer\n"
            "assert 'torch' not in torch_tf_bundle_writer.__dict__\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]
