"""Synthetic reference checkpoints, numpy only: a TF1 tensor_bundle writer and
the reference's variable names for a param tree in the JAX package's layout.

Neither TensorFlow nor the reference's checkpoints are available, so the
importers are held on checkpoints written here: the tests of the port
(``tests/test_torch_checkpoint.py``) and ``chip_smoke.py``'s import phase,
which runs where no JAX is installed, share this file. It imports neither
torch nor JAX.

* ``write_tf_bundle(prefix, variables, snappy=...)``: ``<prefix>.index`` (a
  LevelDB table of ``BundleEntryProto`` values, records split over several
  data blocks with restart points, each block plain or snappy-compressed and
  followed by its 5-byte trailer) and ``<prefix>.data-00000-of-00001``.
* ``imagebert_a_tf_names`` / ``imagebert_b_tf_names``: an ImageBERT-A or -B
  tree -> the flat TF variable dict of ``ImageBertKDD.ckpt`` /
  ``model_attention_kdd_am_word_match_finetune_valid.ckpt`` (B's convs in
  their 4-D TF layouts); ``with_ema_shadows`` adds ``/ExponentialMovingAverage``
  shadows.
* ``lxmert_torch_names``: an LXMERT tree -> a ``BEST.pth``-style state dict
  of numpy arrays (``module.`` DataParallel prefixes, torch's [out, in]
  weights), for the caller to ``torch.save``.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

MAGIC = b"\x57\xfb\x80\x8b\x24\x75\x47\xdb"
# numpy dtype -> tensorflow DataType enum (a bf16 tensor goes in as raw uint16 with dtype=14)
TF_DTYPE = {np.dtype(np.float32): 1, np.dtype(np.float64): 2, np.dtype(np.int32): 3, np.dtype(np.uint8): 4,
            np.dtype(np.int8): 6, np.dtype(np.int64): 9, np.dtype(np.bool_): 10, np.dtype(np.uint16): 14,
            np.dtype(np.float16): 19}


# ---- checksums, protobuf and LevelDB encoding ----------------------------------------------------

def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def masked_crc32c(data: bytes) -> int:
    """LevelDB's and tensor_bundle's checksum: CRC-32C (Castagnoli) of ``data``, masked."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C[(crc ^ b) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF

def varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _shape_proto(shape) -> bytes:
    out = bytearray()
    for d in shape:
        dim = varint((1 << 3) | 0) + varint(int(d))  # TensorShapeProto.Dim.size
        out += varint((2 << 3) | 2) + varint(len(dim)) + dim
    return bytes(out)


def bundle_header() -> bytes:
    """The BundleHeaderProto under the empty key: num_shards(1) = 1, little-endian, version(3) {producer: 1}."""
    version = varint((1 << 3) | 0) + varint(1)
    return varint((1 << 3) | 0) + varint(1) + varint((3 << 3) | 2) + varint(len(version)) + version


def bundle_entry(dtype: int, shape, offset: int, size: int, crc: int = 0, shard: int = 0) -> bytes:
    """A BundleEntryProto: dtype(1) shape(2) shard_id(3) offset(4) size(5) crc32c(6, fixed32)."""
    shape_p = _shape_proto(shape)
    out = bytearray()
    out += varint((1 << 3) | 0) + varint(dtype)
    out += varint((2 << 3) | 2) + varint(len(shape_p)) + shape_p
    if shard:
        out += varint((3 << 3) | 0) + varint(shard)
    if offset:
        out += varint((4 << 3) | 0) + varint(offset)
    out += varint((5 << 3) | 0) + varint(size)
    out += varint((6 << 3) | 5) + struct.pack("<I", crc)
    return bytes(out)


def _block(records: list[tuple[bytes, bytes]], restart_every: int = 4) -> bytes:
    """A LevelDB block: prefix-compressed records, a full key at every ``restart_every``-th, the restart
    offsets and their count."""
    body, restarts, prev = bytearray(), [], b""
    for i, (key, value) in enumerate(records):
        shared = 0
        if i % restart_every:
            while shared < min(len(key), len(prev)) and key[shared] == prev[shared]:
                shared += 1
        else:
            restarts.append(len(body))
        body += varint(shared) + varint(len(key) - shared) + varint(len(value)) + key[shared:] + value
        prev = key
    for r in restarts or [0]:
        body += struct.pack("<I", r)
    body += struct.pack("<I", len(restarts or [0]))
    return bytes(body)


def snappy_compress(data: bytes) -> bytes:
    """Raw snappy: greedy 4-byte matches through a hash table, emitted as copies with a 1-byte offset (type 1,
    length 4..11, offset < 2048) or a 2-byte one (type 2, length 1..64), the rest as literals."""
    out = bytearray(varint(len(data)))

    def literal(chunk: bytes) -> None:
        for s in range(0, len(chunk), 1 << 16):
            part = chunk[s:s + (1 << 16)]
            n = len(part) - 1
            if n < 60:
                out.append(n << 2)
            elif n < 256:
                out.extend(bytes([60 << 2, n]))
            else:
                out.extend(bytes([61 << 2]) + n.to_bytes(2, "little"))
            out.extend(part)

    table: dict[bytes, int] = {}
    pos = lit_start = 0
    while pos + 4 <= len(data):
        key = data[pos:pos + 4]
        cand = table.get(key)
        table[key] = pos
        if cand is None or pos - cand >= 1 << 16:
            pos += 1
            continue
        length = 4
        while pos + length < len(data) and length < 64 and data[cand + length] == data[pos + length]:
            length += 1
        literal(data[lit_start:pos])
        offset = pos - cand
        if length <= 11 and offset < 2048:
            out += bytes([((offset >> 8) << 5) | ((length - 4) << 2) | 1, offset & 0xFF])
        else:
            out += bytes([((length - 1) << 2) | 2]) + offset.to_bytes(2, "little")
        pos += length
        lit_start = pos
    literal(data[lit_start:])
    return bytes(out)


def _table(records: list[tuple[bytes, bytes]], snappy: bool, per_block: int) -> bytes:
    """A LevelDB table of sorted records: data blocks of ``per_block`` records, an index block of their
    handles (each keyed by its block's last key), an empty metaindex, the 48-byte footer. Each block is
    followed by a compression byte (0 plain, 1 snappy) and the masked CRC-32C of the block and that byte."""
    out = bytearray()

    def put(block: bytes) -> bytes:
        stored = (snappy_compress(block) if snappy else block) + (b"\x01" if snappy else b"\x00")
        handle = varint(len(out)) + varint(len(stored) - 1)
        out.extend(stored + struct.pack("<I", masked_crc32c(stored)))
        return handle

    index = []
    for i in range(0, len(records), per_block):
        chunk = records[i:i + per_block]
        index.append((chunk[-1][0], put(_block(chunk))))
    meta = put(_block([]))
    footer = meta + put(_block(index, restart_every=1))
    out += footer + b"\x00" * (40 - len(footer)) + MAGIC
    return bytes(out)


def write_tf_bundle(prefix, variables: dict[str, np.ndarray], snappy: bool = False, per_block: int = 7,
                    dtypes: dict[str, int] | None = None, tensor_crcs: bool = True) -> int:
    """Write ``variables`` as the TF1 bundle ``prefix`` -> bytes written. ``dtypes`` overrides a variable's
    DataType enum (14 for a bf16 tensor given as its raw uint16 bits). Each entry carries its tensor's masked
    CRC-32C, as TensorFlow's reader checks it; ``tensor_crcs=False`` writes zeros there (the CRC runs in
    Python at a few MB/s, too slow for a full-width model; the pure-Python readers do not check it)."""
    prefix = Path(prefix)
    entries = [(b"", bundle_header())]
    offset = 0
    with open(f"{prefix}.data-00000-of-00001", "wb") as f:
        for name in sorted(variables):
            a = np.ascontiguousarray(variables[name])
            dtype = (dtypes or {}).get(name, TF_DTYPE[a.dtype])
            raw = a.tobytes()
            f.write(raw)
            crc = masked_crc32c(raw) if tensor_crcs else 0
            entries.append((name.encode(), bundle_entry(dtype, a.shape, offset, a.nbytes, crc)))
            offset += a.nbytes
    index = _table(entries, snappy, per_block)
    Path(f"{prefix}.index").write_bytes(index)
    return offset + len(index)


# ---- the reference's variable names -------------------------------------------------------------

def _tf_encoder(enc: dict, flat: dict, prefix: str = "bert/encoder") -> None:
    att, ffn = enc["attention"], enc["ffn"]
    for i in range(att["query"]["kernel"].shape[0]):
        lp = f"{prefix}/layer_{i}"
        for nm in ("query", "key", "value"):
            for leaf in ("kernel", "bias"):
                flat[f"{lp}/attention/self/{nm}/{leaf}"] = att[nm][leaf][i]
        pairs = {"attention/output/dense": att["output"]["dense"], "intermediate/dense": ffn["intermediate"],
                 "output/dense": ffn["output"]["dense"]}
        for scope, p in pairs.items():
            flat[f"{lp}/{scope}/kernel"], flat[f"{lp}/{scope}/bias"] = p["kernel"][i], p["bias"][i]
        for scope, p in {"attention/output/LayerNorm": att["output"]["LayerNorm"],
                         "output/LayerNorm": ffn["output"]["LayerNorm"]}.items():
            flat[f"{lp}/{scope}/gamma"], flat[f"{lp}/{scope}/beta"] = p["gamma"][i], p["beta"][i]


def _tf_embeddings(emb: dict, flat: dict) -> None:
    for k in ("word_embeddings", "token_type_embeddings", "position_embeddings", "word_embeddings_labelembedding"):
        if k in emb:
            flat[f"bert/embeddings/{k}"] = emb[k]
    flat["bert/embeddings/LayerNorm/gamma"] = emb["LayerNorm"]["gamma"]
    flat["bert/embeddings/LayerNorm/beta"] = emb["LayerNorm"]["beta"]


def imagebert_a_tf_names(tree: dict) -> dict[str, np.ndarray]:
    """An ImageBERT-A tree -> ``ImageBertKDD.ckpt``'s variables (the MLM head ``cls/predictions`` where the tree
    has one)."""
    flat: dict[str, np.ndarray] = {}
    _tf_embeddings(tree["bert"]["embeddings"], flat)
    _tf_encoder(tree["bert"]["encoder"], flat)
    pooler = tree["bert"]["pooler"]["dense"]
    flat["bert/pooler/dense/kernel"], flat["bert/pooler/dense/bias"] = pooler["kernel"], pooler["bias"]
    flat["featureemb/fully_connected/weights"] = tree["featureemb"]["kernel"]
    flat["featureemb/fully_connected/biases"] = tree["featureemb"]["bias"]
    nsp = tree["cls"]["seq_relationship"]
    flat["cls/seq_relationship/output_weights"] = nsp["output_weights"]
    flat["cls/seq_relationship/output_bias"] = nsp["output_bias"]
    if "predictions" in tree["cls"]:
        mlm = tree["cls"]["predictions"]
        flat["cls/predictions/transform/dense/kernel"] = mlm["transform"]["dense"]["kernel"]
        flat["cls/predictions/transform/dense/bias"] = mlm["transform"]["dense"]["bias"]
        flat["cls/predictions/transform/LayerNorm/gamma"] = mlm["transform"]["LayerNorm"]["gamma"]
        flat["cls/predictions/transform/LayerNorm/beta"] = mlm["transform"]["LayerNorm"]["beta"]
        flat["cls/predictions/output_bias"] = mlm["output_bias"]
    return flat


def imagebert_b_tf_names(tree: dict) -> dict[str, np.ndarray]:
    """An ImageBERT-B/C tree -> the B checkpoint's raw variables, ``kdd_conv1`` as TF's [1, 8, H, H] and
    ``kdd_conv2`` as its [1, 1, 2048, H] 1x1 conv."""
    flat: dict[str, np.ndarray] = {}
    _tf_embeddings(tree["bert"]["embeddings"], flat)
    _tf_encoder(tree["bert"]["encoder"], flat)
    pooler = tree["bert"]["pooler"]["dense"]
    flat["bert/pooler/dense/kernel"], flat["bert/pooler/dense/bias"] = pooler["kernel"], pooler["bias"]
    flat["kdd_conv1/weights"] = np.asarray(tree["kdd_conv1"]["weights"])[None]
    flat["kdd_conv1/biases"] = tree["kdd_conv1"]["biases"]
    flat["kdd_dense1/weights"], flat["kdd_dense1/biases"] = tree["kdd_dense1"]["kernel"], tree["kdd_dense1"]["bias"]
    flat["kdd_conv2/weights"] = np.asarray(tree["kdd_conv2"]["kernel"])[None, None]
    flat["kdd_conv2/biases"] = tree["kdd_conv2"]["bias"]
    fe = tree["kdd_featureemb"]
    flat["kdd_featureemb/fully_connected/weights"], flat["kdd_featureemb/fully_connected/biases"] = fe["kernel"], fe["bias"]
    flat["cls/seq_relationship/am_kernel"] = tree["cls"]["seq_relationship"]["am_kernel"]
    return flat


def with_ema_shadows(flat: dict[str, np.ndarray], shadows: dict[str, np.ndarray],
                     skip: tuple[str, ...] = ()) -> dict[str, np.ndarray]:
    """``flat`` plus ``<name>/ExponentialMovingAverage`` = ``shadows[name]`` for every name but ``skip``
    (a trainable without a shadow: the importer falls back to its raw value)."""
    out = dict(flat)
    out.update({f"{k}/ExponentialMovingAverage": v for k, v in shadows.items() if k not in skip})
    return out


def _pt_linear(p: dict) -> dict:
    return {"weight": np.ascontiguousarray(np.asarray(p["kernel"]).T), "bias": p["bias"]}


def _pt_ln(p: dict, legacy: bool) -> dict:
    return {"gamma": p["gamma"], "beta": p["beta"]} if legacy else {"weight": p["gamma"], "bias": p["beta"]}


def lxmert_torch_names(tree: dict, prefix: str = "module.", legacy_ln: bool = False) -> dict[str, np.ndarray]:
    """An LXMERT tree (the JAX package's layout) -> a ``BEST.pth``-style state dict of numpy arrays: the
    KDDModel's ``lxrt_encoder.model.bert.*`` backbone, its ``logit_fc`` / ``logit_W`` / ``cls`` heads where the
    tree has them, each name behind ``prefix``; ``legacy_ln`` names LayerNorms gamma/beta (HF's old names)."""
    sd: dict[str, np.ndarray] = {}

    def put(base: str, node) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                put(f"{base}.{k}", v)
        else:
            sd[prefix + base] = np.ascontiguousarray(node)

    def att(p: dict, i: int, inner: str) -> dict:
        return {inner: {nm: _pt_linear({k: v[i] for k, v in p[nm].items()}) for nm in ("query", "key", "value")},
                "output": {"dense": _pt_linear({k: v[i] for k, v in p["output"]["dense"].items()}),
                           "LayerNorm": _pt_ln({k: v[i] for k, v in p["output"]["LayerNorm"].items()}, legacy_ln)}}

    def ffn(p: dict, i: int) -> tuple[dict, dict]:
        return ({"dense": _pt_linear({k: v[i] for k, v in p["intermediate"].items()})},
                {"dense": _pt_linear({k: v[i] for k, v in p["output"]["dense"].items()}),
                 "LayerNorm": _pt_ln({k: v[i] for k, v in p["output"]["LayerNorm"].items()}, legacy_ln)})

    pre = "lxrt_encoder.model.bert"
    emb = tree["bert"]["embeddings"]
    for k in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        put(f"{pre}.embeddings.{k}.weight", emb[k])
    put(f"{pre}.embeddings.LayerNorm", _pt_ln(emb["LayerNorm"], legacy_ln))
    enc = tree["bert"]["encoder"]
    for stack in ("layer", "r_layers"):
        layers = enc[stack]
        for i in range(layers["attention"]["query"]["kernel"].shape[0]):
            inter, out = ffn(layers["ffn"], i)
            put(f"{pre}.encoder.{stack}.{i}", {"attention": att(layers["attention"], i, "self"),
                                               "intermediate": inter, "output": out})
    xs = enc["x_layers"]
    for i in range(xs["visual_attention"]["query"]["kernel"].shape[0]):
        b = f"{pre}.encoder.x_layers.{i}"
        put(f"{b}.visual_attention", att(xs["visual_attention"], i, "att"))
        for side in ("lang", "visn"):
            put(f"{b}.{side}_self_att", att(xs[f"{side}_self_att"], i, "self"))
            inter, out = ffn(xs[f"{side}_ffn"], i)
            put(f"{b}.{side}_inter", inter)
            put(f"{b}.{side}_output", out)
    vf = enc["visn_fc"]
    for k in ("visn_fc", "box_fc", "label_fc"):
        put(f"{pre}.encoder.visn_fc.{k}", _pt_linear(vf[k]))
    for k in ("visn_layer_norm", "box_layer_norm", "label_layer_norm"):
        put(f"{pre}.encoder.visn_fc.{k}", _pt_ln(vf[k], legacy_ln))
    put(f"{pre}.encoder.visn_fc.label_conv.weight", np.asarray(vf["label_conv"]["weights"]).reshape(1, -1, 1, 1))
    put(f"{pre}.encoder.visn_fc.label_conv.bias", vf["label_conv"]["biases"])
    put(f"{pre}.pooler.dense", _pt_linear(tree["bert"]["pooler"]["dense"]))
    if "logit_fc" in tree:
        fc = tree["logit_fc"]
        put("logit_fc.0", _pt_linear(fc["fc1"]))
        put("logit_fc.2", _pt_ln(fc["LayerNorm"], legacy_ln))
        put("logit_fc.3", _pt_linear(fc["fc2"]))
    if "logit_W" in tree:
        put("logit_W", tree["logit_W"])
    if "seq_relationship" in tree.get("cls", {}):
        put("cls.seq_relationship", _pt_linear(tree["cls"]["seq_relationship"]))
        mlm = tree["cls"]["predictions"]
        put("cls.predictions.transform.dense", _pt_linear(mlm["transform"]["dense"]))
        put("cls.predictions.transform.LayerNorm", _pt_ln(mlm["transform"]["LayerNorm"], legacy_ln))
        put("cls.predictions.bias", mlm["output_bias"])
    return sd
