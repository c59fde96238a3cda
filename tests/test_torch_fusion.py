"""The port's ensemble against the JAX package's ``ensemble/fusion.py`` and
``ensemble/vectorized.py``: the fusion, the product-dedup filter, the top-5
rows (ties kept in first-appearance order, < 5 survivors falling back to the
unfiltered ranking), single-model flows and the submission file, on tables
with products shared across queries, top-2 gaps on both sides of 0.92, ties
within 1e-5 and queries left with fewer than 5 survivors. The torch device
filter is held to JAX's on the CPU in f32 (on tables with no margin within
f32 rounding of the gap or the tie; merge within 1e-6, keep equal) and to
the dict path in f64, exactly."""

import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ensemble import fusion as jax_fusion
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ensemble import vectorized as jax_vectorized
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch import ensemble
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ensemble import fusion, vectorized

W = fusion.DEFAULT_WEIGHTS


def _tables(seed: int, edge: bool):
    """Four score tables (B, C, A, LXMERT) over 24 queries of 6-9 products from
    a pool that puts most products under 1-3 queries. Each shared product's
    merge scores are planted: its best query beats the rest by a gap drawn
    either side of 0.92 (with ``edge``, some within 1e-4 of it), and with
    ``edge`` some products tie their best score within 1e-5 elsewhere, and
    some pairs tie exactly inside a query. A table other than LXMERT's misses
    a few pairs (backfilled with LXMERT's score)."""
    rng = np.random.default_rng(seed)
    pool = [f"p{i}" for i in range(120)]
    tables = [{}, {}, {}, {}]
    merge_of: dict[tuple[str, str], float] = {}
    homes: dict[str, list[str]] = {}
    for q in range(24):
        qid = f"q{q}"
        for pid in rng.choice(pool, size=int(rng.integers(6, 10)), replace=False):
            homes.setdefault(str(pid), []).append(qid)
    for pid, qids in homes.items():
        best = rng.uniform(1.0, 2.0)
        gap = rng.choice([0.5, 0.91, 0.93, 1.5])
        if edge and rng.random() < 0.3:
            gap = 0.92 + rng.choice([-1, 1]) * rng.uniform(1e-6, 1e-4)
        for i, qid in enumerate(qids):
            m = best if i == 0 else best - gap - rng.uniform(0, 0.3) * (i > 1)
            if edge and i == 1 and rng.random() < 0.2:
                m = best - rng.uniform(0, 9e-6)  # a tie with the best within 1e-5
            merge_of[(qid, pid)] = m
    if edge:  # exact ties inside a query
        for qid in ("q0", "q5"):
            keys = [k for k in merge_of if k[0] == qid][:3]
            for k in keys:
                merge_of[k] = merge_of[keys[0]]
    for (qid, pid), m in merge_of.items():
        # B, C, A, L with 0.2 B + 0.2 C + 0.3 A + 0.3 L == m (up to rounding)
        b, c, a = rng.uniform(-0.2, 0.2, size=3) + m
        lx = (m - W[0] * b - W[1] * c - W[2] * a) / W[3]
        for t, s in zip(tables, (b, c, a, lx)):
            t.setdefault(qid, {})[pid] = float(s)
    for t in tables[:3]:  # pairs missing outside LXMERT's table
        for qid in ("q3", "q7"):
            t[qid].pop(next(iter(t[qid])))
    return tables


def _pairs(tables) -> int:
    return sum(len(r) for r in tables[3].values())


@pytest.mark.parametrize("edge", [False, True])
def test_dict_path_matches_jax(edge, tmp_path):
    tables = _tables(1, edge)
    got, want = fusion.fuse(*tables), jax_fusion.fuse(*tables)
    assert got.merge == want.merge and got.product_max == want.product_max
    assert got.product_scores == want.product_scores
    top1 = fusion.dedup_filter(got)
    assert top1 == jax_fusion.dedup_filter(want)
    kept = sum(len(r) for r in top1.values())
    assert 0 < kept < _pairs(tables)
    rows = fusion.top5_rows(top1, got.merge)
    assert rows == jax_fusion.top5_rows(top1, want.merge)
    assert list(rows) == list(jax_fusion.top5_rows(top1, want.merge))
    assert list(rows) != [] and set(rows) == set(top1) and all(len(r) == 5 for r in rows.values())
    short = [q for q in top1 if len(top1[q]) < 5]
    assert short and all(rows[q] == [p for p, _ in sorted(got.merge[q].items(), key=lambda kv: -kv[1])[:5]]
                         for q in short)

    fusion.write_submission(rows, tmp_path / "port.csv")
    jax_fusion.write_submission(rows, tmp_path / "jax.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert b"\r\n" in (tmp_path / "port.csv").read_bytes()
    assert fusion.read_submission(tmp_path / "port.csv") == jax_fusion.read_submission(tmp_path / "jax.csv") == rows


def test_single_model_flows_match_jax():
    table = _tables(2, True)[2]
    got, want = fusion.single_model_fusion(table), jax_fusion.single_model_fusion(table)
    assert (got.merge, got.product_max, got.product_scores) == (want.merge, want.product_max, want.product_scores)
    assert fusion.dedup_filter(got) == jax_fusion.dedup_filter(want)
    assert fusion.single_model_top5(table) == jax_fusion.single_model_top5(table)


def test_score_files_and_build_submission_match_jax(tmp_path):
    b, c, a, lx = _tables(3, True)
    paths = []
    for name, t in (("b", b), ("c", c), ("a", a)):
        paths.append(tmp_path / f"{name}.txt")
        paths[-1].write_text("".join(f"{q}\t{p}\t{s}\n" for q, r in t.items() for p, s in r.items()) + "short\n")
    paths.append(tmp_path / "l.csv")
    paths[-1].write_text("query-id,product-id,score\n" + "".join(f"{q},{p},{s}\n" for q, r in lx.items()
                                                                 for p, s in r.items()))
    assert fusion.load_tsv_scores(paths[0]) == jax_fusion.load_tsv_scores(paths[0]) == b
    assert fusion.load_csv_scores(paths[3]) == jax_fusion.load_csv_scores(paths[3]) == lx
    rows = ensemble.build_submission(*paths, out_path=tmp_path / "port.csv")
    assert rows == jax_fusion.build_submission(*paths, out_path=tmp_path / "jax.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


@pytest.mark.parametrize("seed", [4, 5])
def test_device_filter_matches_jax_in_f32(seed):
    import jax.numpy as jnp

    tables = _tables(seed, edge=False)
    qids, pids, qcodes, pcodes, n_products, scores = vectorized.tables_to_arrays(*tables)
    jq, jp, jqc, jpc, jn, jscores = jax_vectorized.tables_to_arrays(*tables)
    assert (qids == jq).all() and (pids == jp).all() and (qcodes == jqc).all() and (pcodes == jpc).all()
    assert n_products == jn and np.array_equal(scores, jscores)
    s32 = scores.astype(np.float32)
    merge, keep = vectorized.fusion_filter_device(torch.from_numpy(s32), torch.from_numpy(pcodes), n_products)
    jmerge, jkeep = jax_vectorized.fusion_filter_device(jnp.asarray(s32), jnp.asarray(pcodes), n_products)
    assert merge.dtype == torch.float32
    np.testing.assert_allclose(merge.numpy(), np.asarray(jmerge), atol=1e-6, rtol=0)
    assert np.array_equal(keep.numpy(), np.asarray(jkeep))
    assert 0 < int(keep.sum()) < len(keep)


@pytest.mark.parametrize("edge", [False, True])
def test_device_filter_equals_dict_path_in_f64(edge):
    tables = _tables(6, edge)
    fused = fusion.fuse(*tables)
    top1 = fusion.dedup_filter(fused)
    want = fusion.top5_rows(top1, fused.merge)
    got = vectorized.build_submission_vectorized(*tables, device="cpu")
    assert got == want  # the same rows; their order in the file may differ
    assert set(got) == set(top1)  # a query left with no survivor gets no row in either

    qids, pids, _, pcodes, n_products, scores = vectorized.tables_to_arrays(*tables)
    merge, keep = vectorized.fusion_filter_device(torch.from_numpy(scores), torch.from_numpy(pcodes), n_products)
    assert merge.dtype == torch.float64
    assert merge.tolist() == [fused.merge[q][p] for q, p in zip(qids, pids)]
    assert [(q, p) for q, p, k in zip(qids, pids, keep.tolist()) if k] == [
        (q, p) for q, r in top1.items() for p in r]
    assert 0 < int(keep.sum()) < len(keep)
