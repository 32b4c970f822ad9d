"""Markdown table of the dry run's records (``repro_torch.launch.dryrun``):
one row a cell of ``all_cells()`` plus ``cf_movielens``'s (skipped cells
left out), its
one-device plan (``--mesh none``) beside a device of the (16, 16) mesh.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh none
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    python3 tools/dryrun_table.py

For each cell: flops, matmul flops and bytes moved a device, argument and
peak GiB, collective bytes by type; whether the one-device plan's peak
fits 90 % of one H100's 80 GB, and if not a first cut, scaled linearly
from the counts (to be measured before use): the batch (rows, edges,
users) where what does not scale leaves room for the step, else the
depth, else the tables' rows.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GIB = 2 ** 30
CARD = 80e9 * 0.9          # bytes the one-device plan may use
COLL = (("all-reduce", "ar"), ("all-gather", "ag"),
        ("reduce-scatter", "rs"), ("all-to-all", "a2a"),
        ("send/recv", "p2p"))


def _load(path: Path):
    return json.loads(path.read_text()) if path.exists() else None


def _floor2(x: float) -> int:
    """``x`` rounded down to two significant digits."""
    if x < 1:
        return 0
    step = 10 ** max(int(math.log10(x)) - 1, 0)
    return int(x // step * step)


def _cut(rec, cell, arch):
    """A first cut of a one-device plan past ``CARD``, linear in the
    counts; None when it fits.  What does not scale with the cut stays:
    the arguments (weights, optimizer state, tables), except that a
    decode's cache scales with its batch (its weights: 6 bytes a
    parameter, the f32 master and the bf16 compute copy) and the CF
    ratings with the users."""
    peak, arg = rec["memory"]["peak_bytes"], rec["memory"]["argument_bytes"]
    if peak <= CARD:
        return None
    if arch.kind == "cf":
        fixed, key = 0, "users"
    elif arch.kind == "gnn":
        fixed, key = arg, "n_edges"
    elif cell.step == "decode":
        fixed, key = 6 * arch.config.param_count(), "batch"
    else:
        fixed = arg
        key = "n_candidates" if cell.step == "retrieval" else "batch"
    if fixed < CARD / 2:
        return f"{key} {cell.dims[key]} → " \
               f"{_floor2(cell.dims[key] * (CARD - fixed) / (peak - fixed))}"
    if arch.kind == "lm":
        layers = arch.config.n_layers
        n = int(layers * CARD / peak)
        return f"layers {layers} → {n}" if n else \
            f"layers {layers} → 1 and the batch"
    return f"table rows capped (arguments {arg / GIB:.1f} GiB)"


def rows(results: Path):
    from repro_torch.configs.registry import ASSIGNED, get_arch
    out = []
    for name in list(ASSIGNED) + ["cf_movielens"]:
        arch = get_arch(name)
        for cell in arch.shapes:
            one = _load(results / "none" / f"{name}__{cell.name}.json")
            pod = _load(results / "single_pod" / f"{name}__{cell.name}.json")
            if cell.skip:
                continue
            cut = _cut(one, cell, arch)
            coll = ", ".join(
                f"{short} {pod['collectives'][k]['bytes'] / 1e9:.3g}"
                for k, short in COLL if k in pod["collectives"])
            out.append(
                f"| {name} {cell.name} "
                f"| {one['flops_per_device'] / 1e12:.4g} "
                f"| {one['matmul_flops'] / 1e12:.4g} "
                f"| {one['bytes_accessed_per_device'] / 1e9:.4g} "
                f"| {one['memory']['argument_bytes'] / GIB:.2f} / "
                f"{one['memory']['peak_bytes'] / GIB:.2f} "
                f"| {'fits' if cut is None else cut} "
                f"| {pod['flops_per_device'] / 1e12:.4g} "
                f"| {pod['matmul_flops'] / 1e12:.4g} "
                f"| {pod['bytes_accessed_per_device'] / 1e9:.4g} "
                f"| {coll or '0'} "
                f"| {pod['memory']['argument_bytes'] / GIB:.2f} / "
                f"{pod['memory']['peak_bytes'] / GIB:.2f} |")
    return out


def main():
    import sys
    sys.path.insert(0, str(ROOT / "src"))
    print("| cell | 1 device: TFLOP | matmul TFLOP | GB moved | argument / "
          "peak GiB | one H100 (72 GB) | (16, 16) a device: TFLOP | matmul "
          "TFLOP | GB moved | collective GB | argument / peak GiB |")
    print("| --- " * 11 + "|")
    for line in rows(ROOT / "results" / "dryrun_torch"):
        print(line)


if __name__ == "__main__":
    main()
