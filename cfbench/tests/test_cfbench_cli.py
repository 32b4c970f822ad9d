"""``cfbench/run.py`` as a checker calls it: no result and a non-zero exit
without a card, or in a directory that holds only the benchmark; on a card
(skipped here without one) a short run of a cell prints a correct result
line."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from cfbench.tests.tiny import ROOT

ARGS = ["--workload", "ml1m.refit", "--seed", str(2 ** 31 + 9),
        "--seconds", "1", "--trace", "0"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")


def _run(root):
    return subprocess.run([sys.executable, str(root / "cfbench" / "run.py"),
                           *ARGS], cwd=root, capture_output=True, text=True,
                          timeout=600)


def test_benchmark_alone_prints_no_result(tmp_path):
    shutil.copytree(ROOT / "cfbench", tmp_path / "cfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_short_run_on_the_card(cuda):
    p = _run(ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
