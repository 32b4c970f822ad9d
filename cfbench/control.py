"""The control of a cell at its own size: the plain reference computed in
bf16 put in the program's place, read by the cell's own comparison, on
several seeds in one process.  It must read ``correct`` false on every
seed; the program's readings come from the cell's runs.

    python3 cfbench/control.py --workload <cell> --seeds 5 6 7

Prints one JSON line a seed with each compared number beside its limit.
The benchmark's runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT)]
    import torch
    from cfbench import harness
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    _, cfg, traffic = harness.load_cell(bench, args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        job = harness.job_for(traffic)(cfg, traffic, seed, "cuda")
        job.prepare()
        readings = job.control()
        correct = all(v <= lim for v, lim in readings.values())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": correct, "seconds":
                          time.perf_counter() - t,
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in readings.items()}}),
              flush=True)
        del job
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
