"""The gemm_bf16 launch shapes that chip_smoke.py times and tests/test_torch_cuda.py sweeps
(chip_smoke.py:gemm_sites) against the paths: per path they add up to the launches the paths'
counters are held to, and every one obeys the kernel's shape rules (csrc/gemm_bf16.cu: N a
multiple of the tile's width, K of a stage's depth)."""

import re

import pytest

from chip_smoke import (
    PER_BATCH,
    PER_STEP,
    PER_STEP_B,
    PER_STEP_LXMERT,
    PKG,
    REPO,
    TOWER_TRAIN,
    gemm_site_launches,
    gemm_sites,
    tower_pair_launches,
)

PATH_GEMMS = {"imagebert_a": PER_BATCH["imagebert_a"]["gemm"], "imagebert_b": PER_BATCH["imagebert_b"]["gemm"],
              "lxmert": PER_BATCH["lxmert"]["gemm"], "imagebert_a_train": PER_STEP["gemm"],
              "imagebert_b_train": PER_STEP_B["gemm"], "lxmert_train": PER_STEP_LXMERT["gemm"],
              "two_tower": tower_pair_launches()["gemm"], "two_tower_train": TOWER_TRAIN["gemm"]}


@pytest.mark.parametrize("path", sorted(PATH_GEMMS))
def test_gemm_sites_add_up_to_the_path_launches(path):
    assert gemm_site_launches()[path] == PATH_GEMMS[path]


def test_gemm_sites_obey_the_kernel_shape_rules():
    src = (REPO / PKG / "csrc" / "gemm_bf16.cu").read_text()
    bm, bn, bk = map(int, re.search(r"constexpr int BM = (\d+), BN = (\d+), BK = (\d+);", src).groups())
    assert (bm, bn, bk) == (128, 128, 64)
    sites = gemm_sites()
    assert len({(s[0], *s[2:7]) for s in sites}) == len(sites)  # one row per distinct launch of a path
    for path, site, m, n, k, epilogue, trans_b, launches in sites:
        assert m > 0 and n % bn == 0 and k % bk == 0 and launches > 0, (path, site, m, n, k)
