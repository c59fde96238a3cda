"""LXMERT as a cell of the port's benchmark (``lxmert.score_staged``), on the
CPU at a tiny size: the cell's entry through the harness's own check; the
plain reference (``portbench/reference/lxmert.py``) against the port's plain
path with key masks that cut keys in both streams, and what the reference
imports; and the yardstick's work count of the cross blocks, by hand."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringEngine
from portbench.reference.lxmert import lxmert_scores
from portbench.reference.tokenizer import Tokenizer
from portbench.tests.conftest import REPO, run_tiny, tiny_run
from portbench.yardstick import lxmert, packed, work

CELL = "lxmert.score_staged"
CONFIG = json.loads((REPO / "portbench" / "configs" / "lxmert.json").read_text())
# the widths and depths of the tiny runs: H=32, 2 heads, 2 L, 1 R and 1 x layers
TINY = {"hidden_size": 32, "num_attention_heads": 2, "intermediate_size": 64, "l_layers": 2, "r_layers": 1,
        "x_layers": 1}
TINY_TRAFFIC = {"batches": 3, "batch_size": 32, "sample_pairs": 40}


@pytest.mark.parametrize("backend", ["xla", "pallas_packed"])
def test_the_cells_entry_passes_the_harness_check(tmp_path, backend):
    run = tiny_run(CELL, tmp_path, bert=TINY, **TINY_TRAFFIC)
    run.config["attention_backend"] = backend  # pallas_packed: the blocks' route, each kernel's plain version
    out = run_tiny(run)
    assert out["correct"], out["checks"]
    assert [(name, limit) for name, _, limit in out["checks"]] == [("score_gap", run.limits["score_gap"])]
    assert out["checks"][0][1] <= 1e-5  # f32 on both sides: summation order only
    assert out["failed"] == 0 and out["attempted"] >= 32 and set(out["metrics"]) == {"score_pairs_per_s", "setup_s"}


def _inputs(seed: int) -> dict:
    """Eight pairs of the cell's batches, the first four cut to queries of 3 and 23 tokens and to 1 and 10
    boxes."""
    tok = Tokenizer()
    lut, _ = packed.label_lut(lambda text: list(tok.pieces(text)))
    traffic = {"batches": 1, "batch_size": 8, "pairs_per_query": 4, "min_boxes": 1, "max_boxes": 10}
    batch = {k: v.copy() for k, v in lxmert.make_batches(traffic, seed, tok.query_ids, lut)[0].items()}
    rng = np.random.default_rng(seed)
    for row, (q_len, boxes) in enumerate([(3, 1), (23, 10), (3, 10), (23, 1)]):
        batch["input_ids"][row] = np.where(np.arange(23) < q_len, rng.integers(106, 21128, size=23), 0)
        batch["input_mask"][row] = np.arange(23) < q_len
        keep = np.arange(10) < boxes
        for key in ("features", "boxes", "label_ids"):
            batch[key][row] *= keep.reshape(10, *[1] * (batch[key].ndim - 2)).astype(batch[key].dtype)
        batch["feats_mask"][row] = keep
    return batch


@pytest.mark.parametrize("seed", [2**31 + 17, 5])
def test_the_reference_matches_the_ports_plain_path(seed):
    cfg = lxmert.dims({**CONFIG, "bert": {**CONFIG["bert"], **TINY}})
    batch = _inputs(seed)
    assert {int(m.sum()) for m in batch["input_mask"]} >= {3, 23}
    assert {int(m.sum()) for m in batch["feats_mask"]} >= {1, 10}
    params = lxmert.make_weights(cfg, seed, torch.device("cpu"))
    spec = get_model("lxmert", overrides=cfg)
    engine = ScoringEngine(spec, params, device="cpu", precision=Precision.f32())
    assert engine.attention_backend == "xla"
    port = engine.score_batch(batch).numpy()
    inputs = {k: torch.from_numpy(batch[k]) for k in lxmert.INPUT_KEYS}
    inputs = {k: v.long() if v.dtype == torch.int32 else v for k, v in inputs.items()}
    ref = lxmert_scores(params, inputs, cfg).numpy()
    assert np.max(np.abs(port - ref)) <= 1e-5
    # the masks cut keys in both streams: scoring with either mask all ones moves the pairs cut to 3 tokens or
    # to 1 box by more than twice the tolerance (the tiny random model's scores all sit near 0.55)
    for key, rows in (("input_mask", [0, 2]), ("feats_mask", [0, 3])):
        unmasked = lxmert_scores(params, {**inputs, key: torch.ones_like(inputs[key])}, cfg).numpy()
        assert np.min(np.abs(unmasked[rows] - ref[rows])) > 2e-5, key
        assert np.all(unmasked[1] == ref[1])  # 23 tokens and 10 boxes: nothing cut


def test_the_reference_imports_neither_jax_nor_the_port():
    probe = ("import json, sys\nimport portbench.reference.lxmert\n"
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(REPO)})
    assert out.returncode == 0, out.stderr[-2000:]
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "kddcup_2020_multimodalitiesrecall_2nd_place_tpu",
                       "kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch"}


def test_the_cross_work_count_by_hand():
    c = {"hidden_size": 8, "num_attention_heads": 2}
    w = lxmert.cross_attention(3, 4, 5, c)  # 3 pairs, q from 4 rows, k and v from 5
    assert w["gemm"] == [(2 * 12 * 8 * 8, 2 * (12 * 8 + 64 + 12 * 8)),
                         (2 * 15 * 8 * 16, 2 * (15 * 8 + 128 + 15 * 16)),
                         (2 * 12 * 8 * 8, 2 * (12 * 8 + 64 + 12 * 8))]
    assert w["attention"] == [(4 * 3 * 4 * 5 * 8, 3 * (4 * 8 * 2 + 5 * 16 * 2 + 4 * 8 * 2 + 5 * 4))]
    # with Sq = Sk it is the self-attention core's count
    assert lxmert.cross_attention(3, 5, 5, c)["attention"] == [work.attention_forward(3, 2, 5, 8, masked=True)]

    full = lxmert.dims(CONFIG)
    h, i = 768, 3072

    def layer(s):
        return 2 * s * h * 3 * h + 2 * s * h * h + 2 * 2 * s * h * i + 4 * s * s * h

    cross = sum(2 * f * h * h + 2 * t * h * 2 * h + 2 * f * h * h + 4 * f * t * h for f, t in ((23, 10), (10, 23)))
    assert cross == pytest.approx(157.1e6, rel=1e-3)  # the dual block's bound in its docstring
    head = 2 * 10 * 2048 * h + 2 * 10 * 4 * h + 2 * 10 * h * h + 2 * h * h + 2 * h * 2 * h + 2 * 2 * h * 2
    w = lxmert.score([1], full)
    assert w["model_flops"] == 9 * layer(23) + 5 * layer(10) + 5 * (cross + layer(23) + layer(10)) + head
    assert w["model_flops"] == pytest.approx(6.83e9, rel=0.01)
    assert len(w["attention"]) == 9 + 5 + 5 * 4 and len(w["gemm"]) == 4 * (9 + 5 + 5 * 2) + 3 * 5 * 2 + 6
