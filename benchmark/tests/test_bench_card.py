"""On the card: the control, the reference put in the program's place in
TF32, comes out not correct at the cells' own size (one seed each; the
limits' readings use three or more, `python3 -m benchmark.control`), and
one short run of a cell prints a result line.

    python3 -m pytest -p no:cacheprovider -m cuda benchmark/tests/test_bench_card.py
"""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import control, harness, spec


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["ffhq256-train", "ffhq256-fid5k"])
def test_control_is_not_correct(card, workload):
    got = control.readings(workload, 99, False, 0.0)
    assert not harness.judge(got["control"], spec.limits(workload)), got


@pytest.mark.cuda
def test_a_short_run_prints_its_result(card):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "ffhq256-train", "--seed", "98",
                          "--seconds", "1", "--trace", "1"], cwd=spec.REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["busy_s"] > 0
