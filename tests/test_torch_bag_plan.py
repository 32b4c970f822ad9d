"""The embedding-bag kernel's launch plan (``repro_torch.kernels.
embedding_bag.plan``), chosen in Python and checked here on the CPU: the
word width a row is read in, the kernel (a warp's lanes on a bag's words
or on its slots) and the slots in flight a lane, at the recsys paths'
shapes and over a sweep of widths, bag lengths and alignments.  The
kernel itself runs on the card (``tests/test_torch_kernels_cuda.py``)."""

import re

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag import (DEPTH, ROUTES, SLOT_WORDS,
                                               Plan, embedding_bag, plan)


@pytest.mark.parametrize("what,dim,elem,bag_len,want", [
    # DLRM's fused f32 D = 128 table: the multi-hot launch and the L = 1
    # bags of serve_p99's lookups — the warp kernel, 16-byte words; an
    # L = 1 bag keeps one slot in flight (few registers, more warps)
    ("multi-hot DLRM", 128, 4, 100, Plan(16, DEPTH)),
    ("L = 1 DLRM", 128, 4, 1, Plan(16, 1)),
    # FM's factor table (D = 10, 40-byte rows: five 8-byte words) and
    # linear table (D = 1): narrow rows take the slot kernel, its lanes on
    # 32 slots of a bag at a time, at any bag length
    ("FM factors", 10, 4, 100, Plan(8, DEPTH, slots=True)),
    ("FM linear", 1, 4, 100, Plan(4, DEPTH, slots=True)),
    ("FM factors, L = 1", 10, 4, 1, Plan(8, 1, slots=True)),
    ("FM linear, L = 1", 1, 4, 1, Plan(4, 1, slots=True)),
    # a bf16 D = 128 row is 16 words of 16 bytes: more than the slot
    # kernel's 8, so the warp kernel (half its lanes idle)
    ("bf16 D = 128", 128, 2, 100, Plan(16, DEPTH)),
    # phase 14's D = 12 (48 bytes: three 16-byte words) and D = 300 (more
    # than 32 words: column chunks of 32 words a warp)
    ("D = 12 f32", 12, 4, 33, Plan(16, DEPTH, slots=True)),
    ("D = 300 f32", 300, 4, 40, Plan(16, DEPTH)),
    ("D = 300 bf16, L = 5", 300, 2, 5, Plan(8, DEPTH)),
])
def test_plan_at_path_shapes(what, dim, elem, bag_len, want):
    got = plan(dim, elem, bag_len)
    assert got == want, what
    assert got.route in ROUTES


def test_routes_follow_the_lanes():
    """The route names what a warp's lanes take: a bag's words ("warp")
    or its slots ("slots"); the constants are the kernel source's."""
    assert Plan(16, DEPTH).route == "warp"
    assert Plan(4, 1).route == "warp"
    assert Plan(8, DEPTH, slots=True).route == "slots"
    assert ROUTES == ("warp", "slots")
    src = (_build.CSRC / "embedding_bag.cu").read_text()
    for name, value in (("DEPTH", DEPTH), ("SLOT_WORDS", SLOT_WORDS)):
        assert re.search(rf"constexpr int {name} = {value};", src)


@pytest.mark.parametrize("elem,align", [(4, 16), (4, 8), (4, 4), (2, 16),
                                        (2, 8), (2, 4), (2, 2)])
@pytest.mark.parametrize("bag_len", [1, 3, 4, 5, 100])
def test_plan_invariants(elem, align, bag_len):
    """Over D = 1..300: the word is the widest of at most 16 bytes that
    divides the row and the alignment (never below an element); rows of
    at most SLOT_WORDS words take the slot kernel, wider ones the warp
    kernel; the depth is the least of 1, 4 and DEPTH that holds
    min(L, DEPTH) slots."""
    for dim in range(1, 301):
        p = plan(dim, elem, bag_len, align)
        row = dim * elem
        assert p.word_bytes >= elem and row % p.word_bytes == 0
        assert align % p.word_bytes == 0
        wider = 2 * p.word_bytes
        assert wider > 16 or row % wider or align % wider
        assert p.slots == (row // p.word_bytes <= SLOT_WORDS)
        assert p.route == ("slots" if p.slots else "warp")
        assert p.depth in (1, 4, DEPTH)
        assert p.depth >= min(bag_len, DEPTH)
        assert p.depth == 1 or p.depth // 4 < min(bag_len, DEPTH)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper runs the plain version: no launch, no route
    counted."""
    launches = embedding_bag.launches
    routes = dict(embedding_bag.routes)
    out = embedding_bag(torch.ones(4, 2), torch.tensor([[0, -1, 3]]),
                        combiner="mean")
    assert torch.equal(out, torch.ones(1, 2))
    assert embedding_bag.launches == launches
    assert embedding_bag.routes == routes
