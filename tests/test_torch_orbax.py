"""The port's orbax reader (``checkpoint/zstd.py``, ``ocdbt.py``, ``zarr.py``,
``orbax_io.py``) against the JAX package's ``restore_pytree`` and
tensorstore, on the CPU.

* ``restore_pytree`` on trees the JAX package's ``save_pytree`` wrote (tiny
  A, B with ``am_kernel``, LXMERT 1/1/1, the two-tower; a tree of f32, i32,
  i64, bool, u32 and bf16 leaves, 0-d arrays, Python scalars, empty
  containers, a list, a tuple and a [4096, 1024] array; ``scripts/train.py
  --steps 2``'s ``state_2`` and ``step_2``): the same structure and every leaf
  bit-equal (bf16 compared widened to f32).
* The OCDBT store's ``list()``/``read()`` equal to tensorstore's on stores it
  wrote with forced interior nodes, every value inline, none inline,
  uncompressed nodes, 3 commits, a two-level version tree, and a merged
  ``ocdbt.process_0`` child; zarr arrays in a plain directory (chunked, edge
  chunks, an absent chunk, compressor null) equal to tensorstore's read.
* A flipped byte raises a CRC error; ``use_zarr3`` and an unknown compressor
  raise by name; the zstd binding round-trips, also in a process where
  TensorFlow's own zstd was loaded first.
* ``tests/torch_orbax_writer.py``'s trees read by JAX's ``restore_pytree``
  leaf-equal to what it was given (and by the port).
* The committed fixture ``tests/data/orbax_tiny_a/`` (the real orbax's
  output) equal to its ``save_npz`` twin, also in a fresh interpreter where
  jax, orbax, tensorstore and ml_dtypes cannot be imported.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import tensorstore as ts

import torch_orbax_writer as writer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.checkpoint import save_pytree
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.checkpoint.orbax_io import restore_pytree as jax_restore
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import get_model as jax_get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import two_tower as jax_two_tower
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import load_npz, restore_pytree, zstd
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint.ocdbt import FormatError, OcdbtStore
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint.zarr import DirectoryStore, read_array
from torch_parity import TINY, jax_imagebert_a_params, jax_imagebert_b_params, numpy_like

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "data" / "orbax_tiny_a"
TINY_ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_PLATFORM_NAME": "cpu", "KMR_CONFIG_OVERRIDES": json.dumps(TINY)}


def same_tree(want, got, path="") -> None:
    """``got`` (the port's) has ``want``'s (JAX's) structure, and each leaf its dtype, shape and bytes;
    a bfloat16 leaf of ``want`` is compared widened to float32."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (path, type(got))
        for k in want:
            same_tree(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), (path, type(want), type(got))
        for i, (w, g) in enumerate(zip(want, got)):
            same_tree(w, g, f"{path}/{i}")
    elif want is None or isinstance(want, (int, float)):
        assert type(got) is type(want) and got == want, (path, want, got)
    else:
        w = np.asarray(want)
        if w.dtype == ml_dtypes.bfloat16:
            w = w.astype(np.float32)
        assert isinstance(got, np.ndarray) and got.dtype == w.dtype and got.shape == w.shape, (path, w.dtype, got)
        assert got.tobytes() == w.tobytes(), path


# ---- trees the JAX package's save_pytree wrote ------------------------------------------------------------

def _jax_tree(name: str) -> dict:
    if name == "imagebert_a":
        return jax_imagebert_a_params(jax_get_model("imagebert_a", overrides=TINY).config, 1)
    if name == "imagebert_b":
        tree = jax_imagebert_b_params(jax_get_model("imagebert_b", overrides=TINY).config, 2)
        tree["cls"]["seq_relationship"]["am_kernel"] = np.random.default_rng(3).standard_normal(
            (TINY["hidden_size"], 2)).astype(np.float32)
        return tree
    if name == "lxmert":
        spec = jax_get_model("lxmert", overrides={**TINY, "l_layers": 1, "x_layers": 1, "r_layers": 1})
        return numpy_like(jax.eval_shape(lambda: spec.init_params(jax.random.key(0))), 4)
    if name == "two_tower":
        cfg = jax_two_tower.TwoTowerConfig(bert=jax_get_model("imagebert_a", overrides=TINY).config, embed_dim=16)
        return numpy_like(jax.eval_shape(lambda: jax_two_tower.init_params(jax.random.key(0), cfg)), 5)
    rng = np.random.default_rng(6)  # "mixed"
    return {"f32": rng.standard_normal((3, 5)).astype(np.float32), "i32": np.int32(-7),
            "i64": rng.integers(-2**40, 2**40, (4,)), "flags": np.array([[True, False], [False, True]]),
            "u32": np.arange(5, dtype=np.uint32), "f64": np.float64(0.25),
            "bf16": jnp.asarray(rng.standard_normal((6, 7)), jnp.bfloat16),
            "jax_f32": jnp.asarray(rng.standard_normal((2, 3)), jnp.float32), "step": 3, "lr": 0.5,
            "big": rng.standard_normal((4096, 1024)).astype(np.float32),
            "layers": [{"k": np.ones((2, 2), np.float32)}, {"k": np.arange(3, dtype=np.int32)}],
            "pair": (np.zeros(2, np.float32), np.float32(1.5)), "none": None, "empty": {}, "nothing": []}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """name -> a directory the JAX package wrote: save_pytree of each tree, and scripts/train.py's
    state_2/step_2 of a tiny B (Adam on the staircase, EMA, am_kernel)."""
    d = tmp_path_factory.mktemp("orbax")
    out = {}
    for name in ("imagebert_a", "imagebert_b", "lxmert", "two_tower", "mixed"):
        save_pytree(d / name, _jax_tree(name))
        out[name] = d / name
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.data.synthetic import (
        SYNTHETIC_LABELS, SYNTHETIC_QUERIES, make_tsv)
    (d / "train.tsv").write_text("\n".join(make_tsv(12, seed=21)) + "\n")
    (d / "labels.txt").write_text("".join(f"{k}\t{v}\n" for k, v in SYNTHETIC_LABELS.items()))
    (d / "query_labels.txt").write_text("".join(f"{300000 + i}\t{q}\tdress,others\n"
                                                for i, q in enumerate(SYNTHETIC_QUERIES)))
    r = subprocess.run([sys.executable, "scripts/train.py", "--model", "imagebert_b", "--train-tsv",
                        str(d / "train.tsv"), "--labels", str(d / "labels.txt"), "--query-labels",
                        str(d / "query_labels.txt"), "--steps", "2", "--batch-size", "8", "--out", str(d / "run"),
                        "--checkpoint-every", "2"], cwd=REPO, env=TINY_ENV, capture_output=True, text=True,
                       timeout=400)
    assert r.returncode == 0, r.stderr[-3000:]
    out["state_2"], out["step_2"] = d / "run" / "state_2", d / "run" / "step_2"
    return out


@pytest.mark.parametrize("name", ["imagebert_a", "imagebert_b", "lxmert", "two_tower", "mixed", "state_2",
                                  "step_2"])
def test_restore_pytree_matches_jax(saved, name):
    want = jax_restore(saved[name])
    got = restore_pytree(saved[name])
    same_tree(want, got)
    if name == "state_2":  # optax's NamedTuples come back as dicts of their fields, its chain as a list
        assert isinstance(got["opt_state"], list) and {"count", "mu", "nu"} <= got["opt_state"][0].keys()
        assert got["ema"]["shadow"]["kdd_conv1"]["weights"].shape[0] == 8 and int(got["step"]) == 2


# ---- the OCDBT store against tensorstore -----------------------------------------------------------------

def _kvs(n: int = 300) -> dict[str, bytes]:
    rng = np.random.default_rng(7)
    return {f"key{i:03d}/{'x' * (i % 7)}": rng.integers(0, 256, int(rng.integers(0, 300)), np.uint8).tobytes()
            for i in range(n)}


def _ts_store(root: Path, config: dict, kvs: dict, commits: int = 1, context=None):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": {"driver": "file", "path": str(root)}, "config": config},
                         context=context).result()
    items = list(kvs.items())
    per = -(-len(items) // commits)
    for c in range(commits):
        txn = ts.Transaction()
        for k, v in items[c * per:(c + 1) * per]:
            kv.with_transaction(txn).write(k, v).result()
        txn.commit_async().result()
    return kv


LAYOUTS = {
    "interior_nodes": ({"max_decoded_node_bytes": 200, "max_inline_value_bytes": 100, "compression": {"id": "zstd"}}, 1),
    "all_inline": ({"max_inline_value_bytes": 1000, "compression": {"id": "zstd"}}, 1),
    "no_inline": ({"max_inline_value_bytes": 0, "compression": {"id": "zstd"}}, 1),
    "uncompressed": ({"max_decoded_node_bytes": 300, "max_inline_value_bytes": 50}, 1),
    "three_commits": ({"max_decoded_node_bytes": 500, "compression": {"id": "zstd", "level": 5}}, 3),
    "version_tree": ({"version_tree_arity_log2": 1, "compression": {"id": "zstd"}}, 20),
}


@pytest.mark.parametrize("layout", [*LAYOUTS, "merged"])
def test_ocdbt_lists_and_reads_what_tensorstore_does(tmp_path, layout):
    kvs = _kvs()
    if layout == "merged":  # orbax's finalize: a child store under ocdbt.process_0 copied into the root
        ctx = ts.Context()
        config = {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 64}
        child = _ts_store(tmp_path / "ocdbt.process_0", config, kvs, context=ctx)
        parent = ts.KvStore.open({"driver": "ocdbt", "base": {"driver": "file", "path": str(tmp_path)},
                                  "config": config}, context=ctx).result()
        txn = ts.Transaction(atomic=True)
        child.experimental_copy_range_to(parent.with_transaction(txn)).result()
        txn.commit_async().result()
    else:
        config, commits = LAYOUTS[layout]
        _ts_store(tmp_path, config, kvs, commits)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": {"driver": "file", "path": str(tmp_path)}}).result()
    keys = kv.list().result()
    store = OcdbtStore(tmp_path)
    assert store.list() == sorted(k.decode() for k in keys) == sorted(kvs)
    for k in keys:
        assert store.read(k.decode()) == kv.read(k).result().value, k
    assert store.read("absent") is None
    if layout == "interior_nodes":
        assert store.version.root_height > 1
    if layout in ("three_commits", "version_tree"):
        assert store.version.generation > LAYOUTS[layout][1]  # the newest of several versions


def test_a_flipped_byte_raises_a_crc_error(tmp_path):
    _ts_store(tmp_path, {"max_decoded_node_bytes": 200, "compression": {"id": "zstd"}}, _kvs(40))
    root = OcdbtStore(tmp_path).version.root  # the root node: the data file holds values too, which carry no CRC
    node = tmp_path / root.file.path
    raw = bytearray(node.read_bytes())
    raw[root.offset + root.length // 2] ^= 0x10
    node.write_bytes(bytes(raw))
    with pytest.raises(FormatError, match="CRC-32C mismatch"):
        OcdbtStore(tmp_path)
    manifest = tmp_path / "manifest.ocdbt"
    raw = bytearray(manifest.read_bytes())
    raw[20] ^= 1
    manifest.write_bytes(bytes(raw))
    with pytest.raises(FormatError, match="CRC-32C mismatch"):
        OcdbtStore(tmp_path)


def _ts_zarr(root: Path, arr: np.ndarray, chunks, compressor) -> None:
    t = ts.open({"driver": "zarr", "kvstore": {"driver": "file", "path": str(root)},
                 "metadata": {"shape": list(arr.shape), "chunks": list(chunks), "dtype": arr.dtype.str,
                              "compressor": compressor}, "create": True}).result()
    t.write(arr).result()


@pytest.mark.parametrize("compressor", [None, {"id": "zstd", "level": 3}], ids=["raw", "zstd"])
def test_zarr_in_a_directory_matches_tensorstore(tmp_path, compressor):
    """The use_ocdbt: false layout: chunked arrays with edge chunks and one absent chunk."""
    rng = np.random.default_rng(8)
    arrays = {"w": (rng.standard_normal((37, 50)).astype(np.float32), (16, 20)),
              "i": (rng.integers(-9, 9, (5, 3, 4)).astype(np.int64), (2, 3, 3)),
              "s": (np.array(2.5, np.float64), ())}
    for name, (arr, chunks) in arrays.items():
        _ts_zarr(tmp_path / name, arr, chunks, compressor)
    (tmp_path / "w" / "1.1").unlink()  # an absent chunk reads as the fill value
    store = DirectoryStore(tmp_path)
    for name, (arr, _) in arrays.items():
        want = ts.open({"driver": "zarr", "kvstore": {"driver": "file", "path": str(tmp_path / name)}}).result()
        want = want.read().result()
        got = read_array(store, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert read_array(store, "w")[16:32, 20:40].max() == 0


def test_zarr3_and_an_unknown_compressor_raise_by_name(tmp_path):
    writer.write_orbax(tmp_path / "t", {"w": np.ones(3, np.float32)})
    meta = json.loads((tmp_path / "t" / "_METADATA").read_text())
    (tmp_path / "t" / "_METADATA").write_text(json.dumps({**meta, "use_zarr3": True}))
    with pytest.raises(ValueError, match="use_zarr3"):
        restore_pytree(tmp_path / "t")
    _ts_zarr(tmp_path / "b" / "w", np.ones((4, 4), np.float32), (4, 4), {"id": "blosc"})
    with pytest.raises(ValueError, match="compressor 'blosc'"):
        read_array(DirectoryStore(tmp_path / "b"), "w")
    with pytest.raises(ValueError, match="not an orbax checkpoint"):
        restore_pytree(tmp_path / "b")


def test_zstd_round_trip_and_limits():
    data = np.random.default_rng(9).standard_normal(50_000).astype(np.float32).tobytes() + bytes(10_000)
    frame = zstd.compress(data)
    assert zstd.decompress(frame, len(data)) == data
    out = np.empty(len(data), np.uint8)
    zstd.decompress_into(frame, out)
    assert out.tobytes() == data
    with pytest.raises(ValueError, match="more than its limit"):
        zstd.decompress(frame, len(data) - 1)
    with pytest.raises(ValueError, match="truncated"):
        zstd.decompress(frame[:-20], len(data))
    with pytest.raises(ValueError, match="too small"):
        zstd.decompress_into(frame, np.empty(len(data) - 1, np.uint8))
    assert zstd.version().count(".") == 2


def test_zstd_with_another_zstd_loaded_first():
    """TensorFlow, imported first, exports a zstd of its own; libzstd's calls into itself must still bind to
    its own symbols (RTLD_DEEPBIND), or the streamed decode fails ("Src size is incorrect")."""
    code = ("import tensorflow\n"
            f"import sys; sys.path.insert(0, {str(REPO)!r})\n"
            "import numpy as np\n"
            "from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import zstd\n"
            "data = np.random.default_rng(1).standard_normal(50_000).astype(np.float32).tobytes()\n"
            "frame = zstd.compress(data)\n"
            "out = np.empty(len(data), np.uint8)\n"
            "zstd.decompress_into(frame, out)\n"
            "assert zstd.decompress(frame, len(data)) == data == out.tobytes()\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-3000:]


# ---- the numpy-only writer, the committed fixture ----------------------------------------------------------

WRITER_CASES = {"one_leaf_node": {}, "interior_nodes": {"leaf_entries": 3, "fanout": 2},
                "no_inline_raw_nodes": {"max_inline_value_bytes": 0, "compress_nodes": False},
                "chunked": {"chunks": {"a.w": (64, 32), "l.0": (10, 5)}, "leaf_entries": 4}}


@pytest.mark.parametrize("case", list(WRITER_CASES))
def test_writer_output_read_by_jax(tmp_path, case):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((37, 5)).astype(np.float32)
    tree = {"a": {"w": rng.standard_normal((300, 70)).astype(np.float32), "i": np.int32(3),
                  "b": np.array([True, False])},
            "l": [x, np.arange(7, dtype=np.int64)], "h": writer.Bfloat16.from_float32(x),
            "u": np.arange(4, dtype=np.uint32), "s": 3, "f": 2.5, "n": None, "e": {}, "el": []}
    writer.write_orbax(tmp_path / "t", tree, **WRITER_CASES[case])
    want = jax_restore(tmp_path / "t")
    np.testing.assert_array_equal(np.asarray(want["h"]).astype(np.float32),
                                  x.astype(ml_dtypes.bfloat16).astype(np.float32))
    expect = {**tree, "h": x.astype(ml_dtypes.bfloat16).astype(np.float32)}
    same_tree(jax.tree.map(lambda v: np.asarray(v) if isinstance(v, np.generic) else v, expect,
                           is_leaf=lambda v: v is None), restore_pytree(tmp_path / "t"))
    same_tree(want, restore_pytree(tmp_path / "t"))


def test_committed_fixture_equals_its_npz_twin():
    got = restore_pytree(FIXTURE)
    same_tree(load_npz(FIXTURE.with_suffix(".npz")), got)
    same_tree(jax_restore(FIXTURE), got)
    assert json.loads((FIXTURE / "_METADATA").read_text())["tree_metadata"]  # jax.Array leaves, as scripts write
    assert any(e["value_metadata"]["value_type"] == "jax.Array"
               for e in json.loads((FIXTURE / "_METADATA").read_text())["tree_metadata"].values())


def test_checkpoint_package_reads_the_fixture_without_jax_orbax_tensorstore():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'orbax', 'orbax.checkpoint', 'tensorstore', 'ml_dtypes', 'zstandard',\n"
            "             'kddcup_2020_multimodalitiesrecall_2nd_place_tpu'):\n"
            "    sys.modules[name] = None\n"
            f"sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'tests')!r}]\n"
            "import numpy as np\n"
            "from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import load_npz, restore_pytree\n"
            "from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import flatten_tree\n"
            f"got = flatten_tree(restore_pytree({str(FIXTURE)!r}))\n"
            f"want = flatten_tree(load_npz({str(FIXTURE.with_suffix('.npz'))!r}))\n"
            "assert got.keys() == want.keys() and all(got[k].tobytes() == want[k].tobytes() for k in want)\n"
            "import torch_orbax_writer\n"
            "assert 'torch' not in torch_orbax_writer.__dict__\n"
            "print('ok', len(want))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.startswith("ok"), r.stderr[-3000:]


def test_a_state_directory_is_refused_as_a_param_tree(saved):
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import read_checkpoint
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import get_model

    with pytest.raises(ValueError, match="training state"):
        read_checkpoint("imagebert_b", saved["state_2"], get_model("imagebert_b", overrides=TINY))
    shutil.copytree(saved["step_2"], saved["step_2"].parent / "copy", dirs_exist_ok=True)
    same_tree(restore_pytree(saved["step_2"]), read_checkpoint("imagebert_b", saved["step_2"].parent / "copy",
                                                               get_model("imagebert_b", overrides=TINY)))
