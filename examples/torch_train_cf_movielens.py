"""End-to-end run on the PyTorch/CUDA port: the paper's full experiment
(the port of ``examples/train_cf_movielens.py``, the same CSV).

Reproduces §VI of the paper: fit user-based CF under all three similarity
measures on (synthetic) MovieLens-1M, sweep top-N, report MAE / Precision
/ Recall / F-Score, and compare the sequential engine with the sharded and
ring engines.  The mesh engines run on ``core.engine.default_mesh``: one
rank by default (a one-rank NCCL group on the card, gloo on the CPU), or
every rank of a ``torchrun`` launch (NCCL on the cards, gloo with
``--device cpu``), where rank 0 prints:

    PYTHONPATH=src python examples/torch_train_cf_movielens.py --engine ring
    PYTHONPATH=src torchrun --nproc-per-node 4 \\
        examples/torch_train_cf_movielens.py --engine sharded
    PYTHONPATH=src python examples/torch_train_cf_movielens.py --device cpu
"""

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.core import CFConfig, UserCF
from repro_torch.core.engine import default_mesh
from repro_torch.data import load_ml1m_synthetic
from repro_torch.device import resolve_device


def _join_launch(device: torch.device) -> torch.device:
    """Under ``torchrun`` (``WORLD_SIZE`` > 1) join its process group —
    NCCL with this rank's card, gloo on the CPU — and return the rank's
    device; otherwise ``device`` as it is."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://")
    return device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="sequential",
                    choices=["sequential", "sharded", "ring"])
    ap.add_argument("--users", type=int, default=2048)
    ap.add_argument("--items", type=int, default=1024)
    ap.add_argument("--topn", type=int, nargs="+", default=[10, 20, 40])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = _join_launch(resolve_device(args.device))
    mesh = default_mesh(dev) if args.engine != "sequential" else None
    n_dev = mesh.size() if mesh is not None else 1
    lead = not dist.is_initialized() or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    say(f"devices={n_dev} engine={args.engine}")

    train, test, _ = load_ml1m_synthetic(n_users=args.users,
                                         n_items=args.items)
    tr, te = torch.from_numpy(train).to(dev), torch.from_numpy(test).to(dev)

    rows = []
    say("measure,top_n,fit_s,mae,precision,recall,f1")
    for measure in ("jaccard", "cosine", "pcc"):
        for k in args.topn:
            cf = UserCF(CFConfig(measure=measure, top_k=k,
                                 engine=args.engine, block_size=256),
                        mesh=mesh, device=dev)
            cf.fit(tr)
            ev = cf.evaluate(tr, te)
            rows.append(f"{measure},{k},{cf.state.fit_seconds:.2f},"
                        f"{ev['mae']:.4f},{ev['precision']:.4f},"
                        f"{ev['recall']:.4f},{ev['f1']:.4f}")
            say(rows[-1])
    return rows


if __name__ == "__main__":
    main()
