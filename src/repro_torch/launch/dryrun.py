"""Per-cell dry run: one step of every (arch × shape × mesh) cell counted
on meta tensors (counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell on 512 fake XLA CPU devices.
The port builds the cell's model, optimizer state, batch and cache on
``torch.device("meta")`` (shapes and dtypes, no data) from the registry's
``input_specs``, makes the cell's mesh over a ``"fake"`` process group of
256 or 512 ranks (``torch.testing._internal.distributed.fake_pg``: every
collective returns at once and moves nothing) with this process as rank
0, and runs ``build_step``'s step once, eagerly, under
:class:`repro_torch.launch.op_cost.OpCounter`: what rank 0 executes is
what is counted.  Each hand kernel counts its own work (its module's
``work``), not its plain version's.

Per cell this records, to ``results/dryrun_torch/<mesh>/<arch>__<shape>
.json``, the reference's keys with the port's counts:

* ``memory`` — argument, output, temp (peak − argument) and peak bytes
  of a rank (the counterpart of ``compiled.memory_analysis()``);
* ``flops_per_device``, ``bytes_accessed_per_device``, ``matmul_flops``;
* ``collectives`` (count and bytes by type) and
  ``collective_bytes_total``;
* ``kernels`` — each hand kernel's calls, operations and bytes;
* ``trace_s`` — the host seconds the counted step took.

``--mesh none`` records the one-device plan instead
(``build_step(arch, cell, None)``, the plan ``chip_smoke.py`` drives; the
CF steps then take a one-rank fake group's mesh), and ``--mesh RxC`` a
(data R, model C) mesh over R·C fake ranks (the CF arch: one axis of R·C
ranks), for small checks.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3_2_1b --shape train_4k
  python -m repro_torch.launch.dryrun --all              # every cell
  python -m repro_torch.launch.dryrun --all --multipod   # (2, 16, 16)
  python -m repro_torch.launch.dryrun --all --mesh none  # one device
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

import torch

ROOT = Path(__file__).resolve().parents[3]
RESULTS = ROOT / "results" / "dryrun_torch"
META = torch.device("meta")

_RECSYS_CLASSES = {"dlrm": "DLRM", "fm": "FM", "xdeepfm": "XDeepFM",
                   "bert4rec": "BERT4Rec"}


# §Perf variants: config transformations (the reference's, on the fields
# the port's configs have)
def _apply_variant(arch, name: str):
    dc = dataclasses
    if not name:
        return arch
    cfg = arch.config

    def need(*fields):
        missing = [f for f in fields if not hasattr(cfg, f)]
        if missing:
            raise ValueError(f"variant {name!r}: {arch.name}'s config has "
                             f"no {missing}")

    if name == "gatherw":
        need("gather_weights_at_use")
        cfg = dc.replace(cfg, gather_weights_at_use=True)
    elif name.startswith("gatherw_ub"):
        need("gather_weights_at_use", "microbatch")
        cfg = dc.replace(cfg, gather_weights_at_use=True,
                         microbatch=int(name.split("ub")[1]))
    elif name.startswith("ub"):
        need("microbatch")
        cfg = dc.replace(cfg, microbatch=int(name[2:]))
    elif name.startswith("offl_ub"):
        need("gather_weights_at_use", "remat_policy", "microbatch")
        cfg = dc.replace(cfg, gather_weights_at_use=True,
                         remat_policy="offload_psum",
                         microbatch=int(name.split("ub")[1]))
    elif name == "replicated":        # CF: shared-memory engine
        need("engine")
        cfg = dc.replace(cfg, engine="sharded")
    elif name.startswith("cf"):       # cf1.0 etc: MoE capacity factor
        if getattr(cfg, "moe", None) is None:
            raise ValueError(f"variant {name!r}: {arch.name} has no MoE")
        cfg = dc.replace(cfg, moe=dc.replace(
            cfg.moe, capacity_factor=float(name[2:])))
    elif name.startswith("blk"):      # CF block size
        need("block_size")
        cfg = dc.replace(cfg, block_size=int(name[3:]))
    else:
        raise ValueError(f"unknown variant {name!r}")
    return dc.replace(arch, config=cfg)


# -- the fake group and the mesh ---------------------------------------------

def _fake_group(world: int) -> bool:
    """Make the default group a fake one of ``world`` ranks, this process
    rank 0; True if it was created here.  An existing group must be a fake
    one of that size."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import backends
    if dist.is_initialized():
        if backends(dist.get_backend()) != {"fake"} \
                or dist.get_world_size() != world:
            raise RuntimeError(
                f"a dry run needs a fake group of {world} ranks; this "
                f"process has a {dist.get_backend()!r} group of "
                f"{dist.get_world_size()}")
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore
    # meta named too: batched point-to-point ops look their backend up
    # by the tensors' device type
    dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(),
                            rank=0, world_size=world)
    return True


def mesh_shape(kind: str, mesh: str, multi_pod: bool):
    """(tag, shape, axes) of a cell's mesh: ``mesh`` is ``"production"``
    (the reference's (16, 16) or (2, 16, 16); the CF arch's flat ring),
    ``"none"`` or ``"RxC"``."""
    if mesh == "none":
        return "none", None, None
    if mesh == "production":
        if kind == "cf":
            n = 512 if multi_pod else 256
            return ("multi_pod" if multi_pod else "single_pod"), (n,), \
                ("data",)
        if multi_pod:
            return "multi_pod", (2, 16, 16), ("pod", "data", "model")
        return "single_pod", (16, 16), ("data", "model")
    r, c = (int(x) for x in mesh.split("x"))
    if kind == "cf":
        return mesh, (r * c,), ("data",)
    return mesh, (r, c), ("data", "model")


def _make_mesh(shape, axes):
    from repro_torch.launch.mesh import make_local_mesh
    return make_local_mesh(shape, axes, device=META)


# -- the cell's inputs on meta -----------------------------------------------

def _meta(spec_tree):
    """``TensorSpec`` leaves → empty meta tensors."""
    from repro_torch.configs.registry import TensorSpec
    if isinstance(spec_tree, TensorSpec):
        return torch.empty(spec_tree.shape, dtype=spec_tree.dtype,
                           device=META)
    if isinstance(spec_tree, dict):
        return {k: _meta(v) for k, v in spec_tree.items()}
    return spec_tree


def build_model(arch, cell):
    """The cell's model with its parameters on meta (the reference's
    shapes; no values)."""
    gen = torch.Generator().manual_seed(0)
    if arch.kind == "lm":
        from repro_torch.models import transformer as tx
        return tx.Transformer(arch.config, tx.init_params(arch.config, gen,
                                                          device=META))
    if arch.kind == "gnn":
        from repro_torch.models import egnn
        cfg = dataclasses.replace(arch.config, d_feat=cell.dims["d_feat"])
        return egnn.EGNN(cfg, egnn.init_params(cfg, gen, device=META))
    if arch.kind == "recsys":
        mod = importlib.import_module(f"repro_torch.models.{arch.model}")
        cls = getattr(mod, _RECSYS_CLASSES[arch.model])
        return cls(arch.config, mod.init_params(arch.config, gen,
                                                device=META))
    raise ValueError(arch.kind)


def step_args(arch, cell, plan, mesh):
    """The arguments of ``plan.fn`` for one call, on meta."""
    batch = _meta(plan.example_args)
    if arch.kind == "cf":
        if cell.step == "cf_fit":
            return (batch,)
        return ({"ratings": batch["ratings"]}, batch["scores"],
                batch["idx"])
    model = build_model(arch, cell)
    if mesh is not None:
        from repro_torch.launch.steps import place_model
        model = place_model(model, plan.in_shardings[0])
        if "cache" in batch:
            # as a meshed prefill hands it on: each rank its shards
            from repro_torch.models.transformer import place_cache
            batch["cache"] = place_cache(arch.config, batch["cache"], mesh)
    if plan.optimizer is not None:
        return model, plan.optimizer.init(model.tree()), batch
    return model, batch


# -- one cell ----------------------------------------------------------------

def estimate(arch, cell, mesh=None, *, variant: str = "",
             mesh_tag: str = "none") -> Dict[str, Any]:
    """Count one step of ``build_step(arch, cell, mesh)`` on meta inputs
    (``mesh``: a ``DeviceMesh`` over a fake group, or None); the record."""
    from repro_torch.launch import op_cost
    from repro_torch.launch.steps import build_step
    plan = build_step(arch, cell, mesh)
    args = step_args(arch, cell, plan, mesh)
    t0 = time.perf_counter()
    with op_cost.OpCounter(args) as counter:
        out = plan.fn(*args)
        counter.outputs(out)
    trace_s = time.perf_counter() - t0
    c = counter.cost.as_dict()
    return {
        "arch": arch.name,
        "shape": cell.name,
        "variant": variant or "baseline",
        "step": cell.step,
        "mesh": mesh_tag,
        "n_devices": 1 if mesh is None else mesh.size(),
        "trace_s": round(trace_s, 3),
        "flops_per_device": c["flops"],
        "bytes_accessed_per_device": c["bytes"],
        "matmul_flops": c["matmul_flops"],
        "memory": c["memory"],
        "collectives": c["collectives"],
        "collective_bytes_total": c["collective_bytes_total"],
        "kernels": c["kernels"],
        "ops": c["ops"],
    }


def run_cell(arch_name: str, shape_name: str, multi_pod: bool = False,
             variant: str = "", *, mesh: str = "production",
             smoke: bool = False, dims: Optional[Dict[str, int]] = None
             ) -> Dict[str, Any]:
    """The record of one cell (a skip record for a skipped cell).
    ``smoke``: the arch's smoke config; ``dims``: the cell's dims
    replaced (both for small checks).  A fake group of the mesh's size
    (one rank for ``"none"``) is made for the run and destroyed after
    it."""
    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    arch = _apply_variant(get_arch(arch_name), variant)
    if smoke:
        arch = dataclasses.replace(arch, config=arch.smoke_config())
    cell = arch.cell(shape_name)
    if dims:
        cell = dataclasses.replace(cell, dims={**cell.dims, **dims})
    if cell.skip:
        return {"arch": arch.name, "shape": cell.name, "skipped": cell.skip}
    tag, shape, axes = mesh_shape(arch.kind, mesh, multi_pod)
    own = _fake_group(math.prod(shape) if shape is not None else 1)
    try:
        m = _make_mesh(shape, axes) if shape is not None else None
        return estimate(arch, cell, m, variant=variant, mesh_tag=tag)
    finally:
        if own:
            dist.destroy_process_group()


def _cell_list():
    """Every (arch, shape, skipped) of ``ASSIGNED`` plus ``cf_movielens``,
    as the reference's ``dryrun.py:178``."""
    from repro_torch.configs.registry import ASSIGNED, get_arch
    cells = []
    for name in list(ASSIGNED) + ["cf_movielens"]:
        arch = get_arch(name)
        for c in arch.shapes:
            cells.append((name, c.name, bool(c.skip)))
    return cells


def run_all(cells, outdir: Path, *, mesh: str = "production",
            multi_pod: bool = False, force: bool = False,
            timeout: int = 3000) -> list:
    """Each cell of ``cells`` ((arch, shape, skipped) triples) in its own
    subprocess, records into ``outdir``: a cell whose record exists is
    skipped unless ``force``, a skipped cell gets a skip record.  Returns
    the failures."""
    from repro_torch.configs.registry import get_arch
    outdir.mkdir(parents=True, exist_ok=True)
    src = str(Path(__file__).resolve().parents[2])
    env = {**os.environ,
           "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    failures = []
    for arch_name, shape_name, skipped in cells:
        out = outdir / f"{arch_name}__{shape_name}.json"
        if out.exists() and not force:
            print(f"[skip-done] {arch_name}:{shape_name}", flush=True)
            continue
        if skipped:
            cell = get_arch(arch_name).cell(shape_name)
            out.write_text(json.dumps(
                {"arch": arch_name, "shape": shape_name,
                 "skipped": cell.skip}, indent=2))
            print(f"[skip-cell] {arch_name}:{shape_name}: {cell.skip}",
                  flush=True)
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch_name, "--shape", shape_name, "--mesh", mesh,
               "--out", str(out)]
        if multi_pod:
            cmd.append("--multipod")
        print(f"[run] {arch_name}:{shape_name} ({outdir.name})", flush=True)
        t0 = time.time()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=timeout, env=env)
        except subprocess.TimeoutExpired:
            failures.append((arch_name, shape_name, "timeout"))
            print(f"  TIMEOUT after {timeout}s", flush=True)
            continue
        if r.returncode != 0:
            failures.append((arch_name, shape_name, r.stderr[-2000:]))
            print(f"  FAILED ({time.time() - t0:.0f}s):\n{r.stderr[-2000:]}",
                  flush=True)
        else:
            print(f"  ok ({time.time() - t0:.0f}s)", flush=True)
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--variant", default="")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--mesh", default="production",
                    help="production (default), none, or RxC")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=3000)
    ap.add_argument("--out", help="one cell's record file")
    args = ap.parse_args(argv)

    if args.mesh == "production":
        tag = "multi_pod" if args.multipod else "single_pod"
    else:
        tag = args.mesh
    outdir = RESULTS / tag

    if not args.all:
        rec = run_cell(args.arch, args.shape, args.multipod, args.variant,
                       mesh=args.mesh)
        suffix = f"__{args.variant}" if args.variant else ""
        out = Path(args.out) if args.out else \
            outdir / f"{args.arch}__{args.shape}{suffix}.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rec, indent=2))
        print(json.dumps(rec, indent=2))
        return 0

    failures = run_all(_cell_list(), outdir, mesh=args.mesh,
                       multi_pod=args.multipod, force=args.force,
                       timeout=args.timeout)
    if failures:
        print(f"\n{len(failures)} failures:")
        for a, s, e in failures:
            lines = e.splitlines()
            print(f"  {a}:{s}: {lines[-1] if lines else e}")
        return 1
    print("\nALL CELLS PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
