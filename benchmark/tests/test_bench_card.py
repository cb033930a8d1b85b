"""Each cell once on the card, as the driver runs it, with a short window.
Skips without a CUDA card (decided in the fixture). On the card:

    python -m pytest --noconftest -p no:cacheprovider benchmark/tests/test_bench_card.py
"""

import json
import os
import subprocess
import sys

import pytest

import bench_helpers
from benchlib import manifest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in manifest.manifest()["workloads"]
                                      if w["chips"] == 1])
def test_cell_runs_correct_on_the_card(workload, card):
    env = {k: v for k, v in os.environ.items() if k != "HC_TORCH_DEVICE"}
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
         str(2**31 + 99), "--seconds", "3", "--trace", "0"],
        cwd=bench_helpers.ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line
