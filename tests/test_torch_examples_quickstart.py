"""The port's quickstart (``examples/torch_quickstart.py``) on the CPU
against the reference's (``examples/quickstart.py``), both run as
subprocesses started together, the port's with ``--device cpu``: the
same dataset line, the same MAE / P / R / F1 as printed for jaccard,
cosine and pcc, and the same pcc top-5 ids of users 0-2, ties allowed
where the predictions at the cut are within 1e-5."""

import re

import torch
from _torch_parity import load_example
from _torch_parity import run_example_pair as run_pair


def _metric_lines(out):
    return {m.group(1): m.group(2) for m in re.finditer(
        r"^(jaccard|cosine|pcc)\s+fit=\s*\S+s (MAE=.*)$", out, re.M)}


def _top5(out):
    return {int(m.group(1)): [int(i) for i in re.findall(r"item(\d+)\(",
                                                          m.group(2))]
            for m in re.finditer(r"^user (\d+): (.*)$", out, re.M)}


def top5_agree(got, want, pred, seen, tol=1e-5):
    """Two top-5 lists of one user agree if they hold the same items, or
    differ only in items tied within ``tol`` of the cut (the 5th best
    prediction among the unseen items)."""
    if list(got) == list(want):
        return True
    scores = torch.where(seen, torch.tensor(float("-inf")), pred)
    cut = torch.sort(scores, descending=True).values[len(got) - 1]
    return all(abs(float(scores[i]) - float(cut)) <= tol
               for i in set(got) ^ set(want))


def test_quickstart_matches_reference():
    ref, port = run_pair("quickstart")
    print(ref, port, sep="\n")
    assert ref.splitlines()[0] == port.splitlines()[0]     # dataset line
    assert _metric_lines(port) == _metric_lines(ref)
    assert len(_metric_lines(ref)) == 3
    got, want = _top5(port), _top5(ref)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    if got != want:
        # ties at the cut: judge them on the port's own predictions
        run = load_example("torch_quickstart").main(["--device", "cpu"])
        pred = run["model"].predict(run["train"])
        for u in want:
            assert top5_agree(got[u], want[u], pred[u],
                              run["train"][u] > 0), (u, got[u], want[u])


def test_top5_ties_rule():
    """Items may differ from the reference's only where they tie at the
    cut among the unseen items."""
    pred = torch.tensor([5.0, 5.0, 5.0, 5.0, 5.0, 5.0 - 5e-6, 4.0, 5.0])
    seen = torch.tensor([False] * 7 + [True])
    assert top5_agree([0, 1, 2, 3, 4], [0, 1, 2, 3, 5], pred, seen)
    assert not top5_agree([0, 1, 2, 3, 4], [0, 1, 2, 3, 6], pred, seen)
    assert not top5_agree([0, 1, 2, 3, 4], [0, 1, 2, 3, 7], pred, seen)
