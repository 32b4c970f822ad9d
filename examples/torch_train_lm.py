"""Train a ~100M-param LM for a few hundred steps on the PyTorch/CUDA port
with the full stack: the fault-tolerant loop, async checkpointing and an
optional fault drill (the port of ``examples/train_lm.py``).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --steps 200 \\
        --inject-fault-at 120               # one restart from step 100

On the card the attention runs through the CUDA flash-attention kernel,
forward and backward, on its f32 route.  The weights are drawn from a
``torch.Generator`` seeded with 0: the reference's shapes and scales, not
its numbers.  ``build_config(**overrides)`` and ``main(argv,
checkpoint_every=..., **overrides)`` let a caller run a smaller model.
"""

import argparse

import numpy as np
import torch

from repro_torch.data import lm_batch
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import FaultInjector
from repro_torch.models import transformer as tx
from repro_torch.models.common import count_params
from repro_torch.training.optimizer import adamw
from repro_torch.training.train_loop import TrainLoopConfig, make_train_step, run


def build_config(**overrides) -> tx.TransformerConfig:
    """~100M params: 12 layers, d=768, llama-style; ``overrides`` replace
    any field."""
    fields = dict(
        name="lm-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
        head_dim=64, d_ff=2048, vocab=8192, tie_embeddings=True,
        remat=False, attn_chunk_q=128, attn_chunk_kv=128, xent_chunk=64,
        dtype=torch.float32)
    fields.update(overrides)
    return tx.TransformerConfig(**fields)


def main(argv=None, *, checkpoint_every: int = 50, **overrides):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_lm_ckpt")
    ap.add_argument("--inject-fault-at", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = build_config(**overrides)
    params = tx.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    print(f"model: {cfg.name}, {count_params(params) / 1e6:.1f}M params")

    opt = adamw(lr=3e-4, weight_decay=0.01)
    state = opt.init(params)
    step = make_train_step(lambda p, b: tx.loss_fn(cfg, p, b), opt)

    def batches(i):
        b = lm_batch(args.batch, args.seq, cfg.vocab, seed=i)
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    injector = FaultInjector(fail_at_steps=(args.inject_fault_at,)) \
        if args.inject_fault_at else None
    res = run(step, params, state, batches,
              TrainLoopConfig(total_steps=args.steps,
                              checkpoint_every=checkpoint_every,
                              checkpoint_dir=args.ckpt_dir, log_every=20),
              injector=injector,
              on_step=lambda s, l: print(f"step {s:4d} loss {l:.4f}")
              if s % 20 == 0 else None)
    first = np.mean(res.losses[:10])
    last = np.mean(res.losses[-10:])
    print(f"\ndone: {res.final_step} steps, loss {first:.3f} → {last:.3f}, "
          f"restarts={res.restarts}, stragglers={len(res.straggler_steps)}")
    assert last < first, "loss did not improve"
    return res


if __name__ == "__main__":
    main()
