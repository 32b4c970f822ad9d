"""Training launcher of the port (counterpart of ``repro.launch.train``):
any registered LM (dense, MoE or MLA), GNN or recsys arch through the
fault-tolerant loop, at world size 1, on the card unless ``--device cpu``
asks for the CPU.

    python -m repro_torch.launch.train --arch llama3_2_1b --smoke --steps 30
    python -m repro_torch.launch.train --arch egnn --smoke --steps 20
    python -m repro_torch.launch.train --arch bert4rec --smoke --steps 5 \\
        --device cpu [--ckpt-dir D] [--compression]

The batches are the reference's ``_loss_and_batch``: LM 4 × 64 tokens,
EGNN one fixed synthetic graph of 256 nodes and 1024 edges, BERT4Rec 16
sequences, the CTR models 32 rows, seeded by the step index.  Weights
come from a ``torch.Generator`` seeded with 0 (the reference's shapes
and scales, not its numbers).  It prints the training losses and, on
step 0's batch, the loss before and after training.  The CF arch trains
nothing (its fit is ``launch.serve``'s).
"""

from __future__ import annotations

import argparse
import importlib

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.data import batches as db
from repro_torch.data import graph as dg
from repro_torch.device import resolve_device
from repro_torch.models.common import count_params
from repro_torch.training.compression import init_compression
from repro_torch.training.optimizer import get_optimizer
from repro_torch.training.train_loop import (TrainLoopConfig,
                                             make_train_step, run)


def _on(batch, dev):
    return {key: torch.as_tensor(val, device=dev)
            for key, val in batch.items()}


def loss_and_batch(arch, cfg, seed_base: int, dev):
    """(loss_fn(params, batch), batches(step), params) for an LM, GNN or
    recsys arch (the reference's ``_loss_and_batch``)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    if arch.kind == "lm":
        from repro_torch.models import transformer as tx

        def loss_fn(p, b):
            return tx.loss_fn(cfg, p, b)

        def batches(i):
            return _on(db.lm_batch(4, 64, cfg.vocab, seed=seed_base + i),
                       dev)
        return loss_fn, batches, tx.init_params(cfg, gen)
    if arch.kind == "gnn":
        from repro_torch.models import egnn
        batch = _on(dg.synthetic_graph(dg.GraphSpec(
            n_nodes=256, n_edges=1024, d_feat=cfg.d_feat,
            n_classes=cfg.d_out)), dev)

        def loss_fn(p, b):
            return egnn.loss_fn(cfg, p, b)
        return loss_fn, (lambda i: batch), egnn.init_params(cfg, gen)
    if arch.kind == "recsys":
        model = importlib.import_module(f"repro_torch.models.{arch.model}")
        if arch.model == "bert4rec":
            def batches(i):
                return _on(db.bert4rec_batch(
                    16, cfg.seq_len, cfg.n_items, cfg.mask_token,
                    seed=seed_base + i), dev)
        else:
            def batches(i):
                return _on(db.recsys_batch(
                    32, cfg.field_sizes, n_dense=getattr(cfg, "n_dense", 0),
                    seed=seed_base + i), dev)

        def loss_fn(p, b):
            return model.loss_fn(cfg, p, b)
        return loss_fn, batches, model.init_params(cfg, gen)
    raise ValueError(f"{arch.name}: {arch.kind} trains nothing here; fit it "
                     f"with repro_torch.launch.serve")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compression", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    arch = get_arch(args.arch)
    cfg = arch.smoke_config() if args.smoke else arch.config
    loss_fn, batches, params = loss_and_batch(arch, cfg, 0, dev)
    print(f"arch={arch.name} kind={arch.kind} "
          f"params={count_params(params) / 1e6:.2f}M "
          f"optimizer={arch.optimizer} device={dev}")

    opt = get_optimizer(arch.optimizer)
    state = opt.init(params)
    if args.compression:
        state = {"opt": state, "ef": init_compression(params)}
    step = make_train_step(loss_fn, opt, compression=args.compression)
    with torch.no_grad():
        before = float(loss_fn(params, batches(0)))
    res = run(step, params, state, batches,
              TrainLoopConfig(total_steps=args.steps, checkpoint_every=20,
                              checkpoint_dir=args.ckpt_dir))
    with torch.no_grad():
        after = float(loss_fn(params, batches(0)))
    losses = res.losses
    print(f"steps={res.final_step} loss {losses[0] if losses else 'n/a'} → "
          f"{losses[-1] if losses else 'n/a'} restarts={res.restarts}")
    print(f"loss on step 0's batch: {before!r} → {after!r}")
    return res, before, after


if __name__ == "__main__":
    main()
