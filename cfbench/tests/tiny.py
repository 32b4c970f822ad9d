"""A copy of the benchmark with its configurations cut to a size the CPU
tests run in a fraction of a second, and helpers to run a cell there."""

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"n_users": 300, "n_items": 200, "n_ratings": 9000,
        "min_user_ratings": 5}


def tiny_tree(tmp: Path) -> Path:
    """``tmp/cfbench`` (the harness, every configuration cut to TINY with
    k = 8) beside ``tmp/BENCHMARK.json``; returns the cfbench copy."""
    here = tmp / "cfbench"
    shutil.copytree(ROOT / "cfbench", here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in (here / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(TINY)
        cfg["engine"] = dict(cfg["engine"], k=8)
        path.write_text(json.dumps(cfg))
    for path in (here / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        if "new_ratings" in t:
            t["new_ratings"] = 40
        if "users" in t.get("check", {}):
            t["check"]["users"] = 64
        path.write_text(json.dumps(t))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return here


def bench(here: Path) -> dict:
    return json.loads((here.parent / "BENCHMARK.json").read_text())


def run(here: Path, cell: str, seed: int = 2 ** 31 + 11, seconds=0.3,
        trace=False):
    from cfbench import harness
    out, lines = harness.run(bench(here), cell, seed, seconds, trace,
                             "cpu", here=here)
    return out


def job(here: Path, cell: str, seed: int = 2 ** 31 + 11):
    """The cell's job object, not yet set up."""
    from cfbench import harness
    _, cfg, traffic = harness.load_cell(bench(here), cell, here)
    return harness.job_for(traffic, here)(cfg, traffic, seed, "cpu")
