"""The fused block backward's gradient reduction (``block_grad_reduce``) on the CPU.

On the card one launch of ``grad_reduce`` (``csrc/vit_block_bwd.cu``) sums
each fp32 partial over its chunks in chunk order, on a schedule the host
computes (``ops/vit_block.py::grad_reduce_plan``): each partial its own
blocks, 4 elements a thread or, for the long chains, one.  These tests hold
the schedule (every element of every partial summed by exactly one thread,
the kernel's block-to-partial lookup, its constants) and the order (an
in-order fp32 sum, the kernel's, against the plain version's ``torch.sum``)
without a card.
"""

import functools
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_training_comparison_tpu_torch.ops import vit_block as vb


def k6_partial_shapes(rows: int, dim: int, hidden: int) -> list[tuple[int, ...]]:
    """The partials of one block backward, in ``_bwd_chain``'s order: the
    four ``block_gemm_wgrad`` launches' weight and bias partials, one per
    ``WGRAD_CHUNK_ROWS`` rows, then the LayerNorms' four, one per
    ``LN_CHUNK_ROWS`` rows."""
    wc, lc = -(-rows // vb.WGRAD_CHUNK_ROWS), -(-rows // vb.LN_CHUNK_ROWS)
    return [(wc, 3 * dim, dim), (wc, 3 * dim), (wc, dim, dim), (wc, dim),
            (wc, hidden, dim), (wc, hidden), (wc, dim, hidden), (wc, dim), *[(lc, dim)] * 4]


def _flat(shapes):
    return [(s[0], math.prod(s[1:])) for s in shapes]


# (chunks, elements) of the partials of a launch: the vit_tiny p2 train
# shape (32768 rows, dim 192), the ragged K6 case (408 rows, dim 128: one
# wgrad chunk, four LayerNorm chunks), and odd ones: elements no multiple
# of 4, an empty partial, a partial of no chunks, a chain just past the
# long-chain threshold
PLAN_CASES = {
    "train_tiny": _flat(k6_partial_shapes(32768, 192, 768)),
    "ragged": _flat(k6_partial_shapes(408, 128, 512)),
    "odd": [(3, 257), (65, 4), (64, 1024), (1, 0), (0, 12), (200, 7), (2, 1)],
}


def _kernel_blocks(plan, blocks):
    """Block b's partial as ``grad_reduce`` finds it: the last entry of the
    plan whose first block is at or before b."""
    firsts = [first for _, _, first in plan]
    out = []
    for b in range(blocks):
        s = 0
        while s + 1 < len(plan) and b >= firsts[s + 1]:
            s += 1
        out.append(s)
    return out


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_grad_reduce_plan_sums_every_element_once(name):
    """Every element of every partial is summed by exactly one thread, as
    the kernel maps blocks and threads to elements: thread t of partial s's
    k-th block takes elements [vec (256 k + t), + vec) where they exist."""
    shapes = PLAN_CASES[name]
    plan, blocks = vb.grad_reduce_plan(shapes)
    seen = [np.zeros(size, dtype=np.int64) for _, size in shapes]
    owner = _kernel_blocks(plan, blocks)
    for b, s in enumerate(owner):
        i, vec, first = plan[s]
        size = shapes[i][1]
        t = (b - first) * vb.REDUCE_THREADS + np.arange(vb.REDUCE_THREADS)
        t = t[t < size // vec]
        for k in range(vec):
            np.add.at(seen[i], vec * t + k, 1)
    assert sorted(i for i, _, _ in plan) == list(range(len(shapes)))
    assert all((s == 1).all() for s in seen)


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_grad_reduce_plan_runs_long_chains_first_on_no_idle_block(name):
    """The partials of the most chunks launch first; a partial of more than
    ``REDUCE_LONG_CHAIN`` chunks, or of elements no multiple of 4, takes one
    element a thread, any other four (16-byte loads); no block is left
    without an element."""
    shapes = PLAN_CASES[name]
    plan, blocks = vb.grad_reduce_plan(shapes)
    chunks = [shapes[i][0] for i, _, _ in plan]
    assert chunks == sorted(chunks, reverse=True)
    ends = [first for _, _, first in plan[1:]] + [blocks]
    for (i, vec, first), end in zip(plan, ends):
        c, size = shapes[i]
        assert vec == (1 if c > vb.REDUCE_LONG_CHAIN or size % 4 else 4)
        assert end - first == -(-size // (vec * vb.REDUCE_THREADS))


def test_grad_reduce_plan_at_the_train_shape():
    """At the vit_tiny p2 train shape the four LayerNorm partials (256
    chunks of 192 elements) take one block each, first, one element a
    thread; the eight weight and bias partials (32 chunks) four elements a
    thread: 440 blocks in all, one wave on the card."""
    plan, blocks = vb.grad_reduce_plan(PLAN_CASES["train_tiny"])
    assert [(i, vec) for i, vec, _ in plan[:4]] == [(8, 1), (9, 1), (10, 1), (11, 1)]
    assert [first for _, _, first in plan[:5]] == [0, 1, 2, 3, 4]
    assert all(vec == 4 for _, vec, _ in plan[4:])
    assert blocks == 440


_CSRC = Path(vb.__file__).parent / "csrc"


@pytest.mark.parametrize("mirror, name", [
    (vb.REDUCE_THREADS, "kReduceThreads"),
    (16, "kMaxSegments"),
], ids=["threads a block", "partials a launch"])
def test_the_plans_constants_are_the_kernels(mirror, name):
    """The schedule holds only while its threads a block are the kernel's,
    and the wrapper's limit of 16 partials is the kernel's."""
    found = re.findall(rf"constexpr int {name} = (\d+);", (_CSRC / "vit_block_bwd.cu").read_text())
    assert found == [str(mirror)]


def in_order_sum(partials):
    """The kernel's order: each partial summed over its chunks from 0, one
    fp32 add at a time."""
    return [functools.reduce(torch.add, t.unbind(0), torch.zeros(t.shape[1:])) for t in partials]


@pytest.mark.parametrize("rows,dim", [(8192, 64), (408, 128)])
def test_the_in_order_sum_agrees_with_the_reference(rows, dim):
    """The sum in the kernel's order against ``block_grad_reduce_reference``
    (``torch.sum`` over the chunks, another order) on seeded partials of
    the chain's shapes: two fp32 sums of the same c terms in any two orders
    differ by at most 2 (c - 1) 2^-24 sum |term| (each is within (c - 1)
    2^-24 sum |term| of the exact sum), so they agree within that."""
    rng = np.random.default_rng(6)
    partials = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for s in k6_partial_shapes(rows, dim, 4 * dim)]
    for t, got, want in zip(partials, in_order_sum(partials), vb.block_grad_reduce_reference(partials)):
        bound = 2 * max(t.shape[0] - 1, 0) * 2.0**-24 * t.abs().sum(0)
        assert got.shape == want.shape == t.shape[1:]
        assert bool(((got - want).abs() <= bound).all())


def test_block_grad_reduce_on_the_cpu_is_the_reference():
    """A CPU tensor takes the plain version and launches nothing."""
    partials = [torch.randn(5, 3, 4), torch.randn(300, 7)]
    before = vb.block_grad_reduce.launches
    for got, want in zip(vb.block_grad_reduce(partials), vb.block_grad_reduce_reference(partials)):
        assert torch.equal(got, want)
    assert vb.block_grad_reduce.launches == before
