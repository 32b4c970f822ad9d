"""Quickstart on the PyTorch/CUDA port: fit the paper's CF model and get
recommendations (the port of ``examples/quickstart.py``, the same printed
lines).

    PYTHONPATH=src python examples/torch_quickstart.py               # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain CPU

On the card every fit goes through the CUDA similarity kernel and every
prediction through the tile-predict kernel; on the CPU the plain versions
run.
"""

import argparse

import torch

from repro_torch.core import CFConfig, UserCF
from repro_torch.data import load_ml1m_synthetic
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # synthetic MovieLens-1M surrogate (offline container), 90/10 split
    train, test, spec = load_ml1m_synthetic(n_users=1024, n_items=768)
    tr, te = torch.from_numpy(train).to(dev), torch.from_numpy(test).to(dev)
    print(f"dataset: {spec.n_users} users × {spec.n_items} items, "
          f"{int((train > 0).sum())} train ratings")

    metrics = {}
    for measure in ("jaccard", "cosine", "pcc"):
        cf = UserCF(CFConfig(measure=measure, top_k=40, block_size=256),
                    device=dev)
        cf.fit(tr)
        ev = metrics[measure] = cf.evaluate(tr, te)
        print(f"{measure:8s} fit={cf.state.fit_seconds:5.2f}s "
              f"MAE={ev['mae']:.4f} P={ev['precision']:.3f} "
              f"R={ev['recall']:.3f} F1={ev['f1']:.3f}")

    # top-5 recommendations for the first few users (PCC model)
    cf = UserCF(CFConfig(measure="pcc", top_k=40, block_size=256),
                device=dev)
    cf.fit(tr)
    scores, items = cf.recommend(tr, n=5)
    scores, items = scores.cpu(), items.cpu()
    for u in range(3):
        pairs = ", ".join(f"item{int(i)}({float(s):.2f})"
                          for s, i in zip(scores[u], items[u]))
        print(f"user {u}: {pairs}")
    return {"metrics": metrics, "scores": scores[:3], "items": items[:3],
            "model": cf, "train": tr}


if __name__ == "__main__":
    main()
