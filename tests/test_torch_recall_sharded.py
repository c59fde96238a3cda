"""``models/two_tower.py:recall_sharded`` of the port on 2 and 3 gloo ranks (``tests/torch_recall_worker.py``)
against the JAX package's ``recall_sharded`` on its 8-device virtual CPU mesh: the same indices, and scores
within 1e-6 (f32 on both sides, summation order only), on the cases of ``tests/test_two_tower.py`` (a catalog
of 999 rows, not divisible by the devices; a catalog of 13 rows whose every score is negative), a catalog of
tied rows and one smaller than k. And with one rank (no group) it equals ``top_k_products`` on the whole
catalog, ties and the (-inf, -1) slots included."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models.two_tower import recall_sharded as jax_recall_sharded
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.parallel import make_mesh as jax_make_mesh
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models.two_tower import recall_sharded, top_k_products

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 120


def _cases() -> dict[str, dict]:
    rng = np.random.default_rng(2)
    out = {"random": {"q": rng.standard_normal((5, 16)), "catalog": rng.standard_normal((999, 16)), "k": 5,
                      "chunk": 256}}
    rng = np.random.default_rng(4)
    out["negative"] = {"q": np.abs(rng.standard_normal((3, 16))), "catalog": -np.abs(rng.standard_normal((13, 16))),
                       "k": 5, "chunk": 8}
    rng = np.random.default_rng(6)
    base = rng.integers(-2, 3, (9, 8))  # small integers: exact f32 scores, many ties
    out["ties"] = {"q": rng.integers(-2, 3, (4, 8)), "catalog": base[rng.integers(0, 9, 37)], "k": 6, "chunk": 16}
    out["small"] = {"q": rng.standard_normal((2, 8)), "catalog": rng.standard_normal((3, 8)), "k": 5, "chunk": 4}
    for c in out.values():
        c["q"], c["catalog"] = c["q"].astype(np.float32), c["catalog"].astype(np.float32)
    return out


CASES = _cases()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world -> {case: (scores, indices)} of the port on that many gloo ranks."""
    d = tmp_path_factory.mktemp("recall")
    np.savez(d / "cases.npz", **{f"{n}/{k}": np.asarray(v) for n, c in CASES.items() for k, v in c.items()})
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_", "MASTER_", "RANK", "WORLD_"))}
    out = {}
    for world in (2, 3):
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_recall_worker.py"), str(r), str(world),
                                   str(port), str(d / "cases.npz"), str(d / f"out{world}.npz")],
                                  cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(world)]
        for p in procs:
            _, err = p.communicate(timeout=RANK_TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
        with np.load(d / f"out{world}.npz") as f:
            out[world] = {n: (f[f"{n}/scores"], f[f"{n}/indices"]) for n in CASES}
    return out


def _jax(case):
    c = CASES[case]
    s, i = jax_recall_sharded(jnp.asarray(c["q"]), jnp.asarray(c["catalog"]), jax_make_mesh(), k=c["k"],
                              chunk=c["chunk"])
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("world", [2, 3])
def test_ranks_match_jax_on_eight_devices(ranks, world, case):
    s, i = ranks[world][case]
    want_s, want_i = _jax(case)
    assert jax.device_count() == 8
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_allclose(s, want_s, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_one_rank_is_top_k_products(case):
    c = CASES[case]
    q, cat = torch.from_numpy(c["q"]), torch.from_numpy(c["catalog"])
    s, i = recall_sharded(q, cat, k=c["k"], chunk=c["chunk"])
    want_s, want_i = top_k_products(q, cat, k=c["k"], chunk=c["chunk"])
    assert torch.equal(i, want_i) and torch.equal(s, want_s)
    np.testing.assert_array_equal(i.numpy(), _jax(case)[1])


def test_negative_catalog_keeps_every_real_candidate(ranks):
    """The JAX case of ``tests/test_two_tower.py:91``: no pad row displaces a real, negative candidate."""
    c = CASES["negative"]
    for world in (2, 3):
        s, i = ranks[world]["negative"]
        assert (i >= 0).all()
        ref = c["q"] @ c["catalog"].T
        np.testing.assert_array_equal(np.sort(i, 1), np.sort(np.argsort(-ref, axis=1)[:, :5], 1))
