"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 cfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Exits non-zero and prints no result when
there is no CUDA card (or fewer than the cell asks for), when the port's
sources are not beside the benchmark, or when the process has loaded JAX
or the JAX package by the time the window closes.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (PORT / "__init__.py").exists():
        print(f"cfbench: the port's sources are not at {PORT}",
              file=sys.stderr)
        return 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"cfbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    marks = {"torch imported": time.perf_counter() - T0}
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cfbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    torch.zeros(1, device="cuda")
    marks["card ready"] = time.perf_counter() - T0
    from cfbench import harness
    out, lines = harness.run(bench, args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda", T0, marks=marks)
    bad = harness.forbidden_modules()
    if bad:
        print(f"cfbench: modules loaded in the run's process: {bad}",
              file=sys.stderr)
        return 4
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
