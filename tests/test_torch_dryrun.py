"""``cli/dryrun_multichip.py`` on the CPU: N gloo ranks through its tiny stages (the data-parallel ImageBERT-B
step, the sharded scoring step, ``recall_sharded`` against numpy, the sharded fusion against one process), its
last line as JAX's ``dryrun_multichip`` prints it; and its refusal without a card."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
MODULE = "kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli.dryrun_multichip"


@pytest.mark.parametrize("n", [2, 3])
def test_dryrun_prints_ok_on_cpu_ranks(n):
    p = subprocess.run([sys.executable, "-m", MODULE, str(n), "--device", "cpu", "--tiny-only"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    last = p.stdout.strip().splitlines()[-1]
    assert re.fullmatch(rf"dryrun_multichip\({n}\): ok, loss=\d+\.\d{{4}}, sharded fusion keep=\d+/{16 * n}", last), last


def test_dryrun_refuses_cuda_without_a_card(capsys):
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import dryrun_multichip

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip.main(["2"])
