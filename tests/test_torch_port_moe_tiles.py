"""The bf16 grouped expert FFN kernels' schedules, in plain Python, on the CPU.

K7 (``moe_ffn_fwd_wgmma``) and K9 (``moe_ffn_dw_wgmma``) read the experts'
row boundaries ``starts`` on the card and find their own rows from them, so
the host sizes their grids from shapes alone.  ``ops/moe_gmm.py`` mirrors
both lookups (``expert_tiles``, ``dw_walks``); nothing on the card path
calls them, so the mirrors' constants are held against the CUDA sources'.
Hypothesis draws the routings: empty groups (some starting at n), groups
over capacity, groups under 64 rows and padding rows past ``starts[E]``.
"""

import math
import re
from pathlib import Path

import pytest

import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from distributed_training_comparison_tpu_torch.ops import moe_gmm


@st.composite
def routings(draw):
    """(starts, cap, n): E group counts, each 0, under 64 rows, or large
    enough to overflow ``cap``; trailing empty groups start at n unless
    padding rows follow."""
    ne = draw(st.integers(1, 12))
    counts = draw(st.lists(
        st.one_of(st.just(0), st.integers(1, 63), st.integers(64, 400)), min_size=ne, max_size=ne))
    if draw(st.booleans()):  # router collapse: the last groups empty, at n
        k = draw(st.integers(0, ne - 1))
        counts = counts[:k] + [0] * (ne - k)
    cap = draw(st.integers(1, 320))
    pad = draw(st.one_of(st.just(0), st.integers(1, 100)))
    n = sum(counts) + pad
    starts = torch.tensor([0, *torch.tensor(counts).cumsum(0).tolist()], dtype=torch.int32)
    return starts, cap, max(n, 1)


def _kept_rows(starts, cap, n):
    return [r for r, k in enumerate(moe_gmm.kept_mask(starts, cap, n).tolist()) if k]


@settings(max_examples=300, deadline=None)
@given(routings())
def test_expert_tiles_cover_each_kept_row_once_within_the_grid(routing):
    """Every kept row in exactly one tile, no dropped or padding row in any;
    each tile at most 64 rows of one expert's kept range, a unit's first
    tile never empty; the units within the grid the wrapper launches,
    ``ceil(n / 128) + E``, and the non-empty tiles within ``ceil(n / 64) +
    E``."""
    starts, cap, n = routing
    ne = len(starts) - 1
    tiles = moe_gmm.expert_tiles(starts, cap, n)
    ranges = moe_gmm.kept_ranges(starts, cap, n)
    rows = sorted(r for _, lo, hi in tiles for r in range(lo, hi))
    assert rows == _kept_rows(starts, cap, n)
    for i, (e, lo, hi) in enumerate(tiles):
        assert 0 <= hi - lo <= moe_gmm.TILE_ROWS
        assert ranges[e][0] <= lo <= hi <= ranges[e][1]
        assert i % 2 or hi > lo
    assert len(tiles) % 2 == 0
    assert len(tiles) // 2 <= math.ceil(n / moe_gmm.UNIT_ROWS) + ne
    assert sum(hi > lo for _, lo, hi in tiles) <= math.ceil(n / moe_gmm.TILE_ROWS) + ne


@settings(max_examples=300, deadline=None)
@given(routings(), st.sampled_from([64, 256, 768]))
def test_dw_walks_split_each_kept_range_in_order(routing, hidden):
    """K9's grid is E x hidden / 64 owners x ``K9_CLUSTER`` CTAs; an
    owner's CTAs walk consecutive 64-row-aligned pieces of its expert's kept
    range that together are the range, so every kept row reaches every
    hidden chunk's gradient once and no other row does."""
    starts, cap, n = routing
    ne = len(starts) - 1
    split = moe_gmm.K9_CLUSTER
    walks = moe_gmm.dw_walks(starts, cap, n, hidden)
    assert len(walks) == ne * (hidden // 64) * split
    for owner in range(ne * (hidden // 64)):
        part = walks[owner * split:(owner + 1) * split]
        e, c = part[0][:2]
        assert all(w[:2] == (e, c) for w in part) and (e, c) == divmod(owner, hidden // 64)
        lo, hi = moe_gmm.kept_ranges(starts, cap, n)[e]
        bounds = [w[2:] for w in part]
        assert bounds[0][0] == lo and bounds[-1][1] == hi
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert all((a - lo) % 64 == 0 or a == hi for a, _ in bounds)


_CSRC = Path(moe_gmm.__file__).parent / "csrc"


@pytest.mark.parametrize("mirror, source, name", [
    (moe_gmm.TILE_ROWS, "moe_gmm_hopper.cuh", "kRows"),
    (moe_gmm.UNIT_ROWS // moe_gmm.TILE_ROWS, "moe_gmm_hopper.cuh", "kConsumers"),
    (moe_gmm.HIDDEN_MULTIPLE[torch.bfloat16], "moe_gmm_hopper.cuh", "kChunk"),
    (moe_gmm.K9_CLUSTER, "moe_gmm_bwd.cu", "kDwCluster"),
], ids=["tile rows", "warpgroups a unit", "bf16 hidden chunk", "K9 cluster"])
def test_the_mirrors_constants_are_the_kernels(mirror, source, name):
    """The plain mirrors walk the rows as the kernels do only while their
    constants are the kernels' own: tile rows, warpgroups a K7 unit, the
    bf16 hidden chunk, and the CTAs each K9 owner's walk splits over."""
    found = re.findall(rf"constexpr int {name} = (\d+);", (_CSRC / source).read_text())
    assert len(found) == 1, (source, name, found)
    assert mirror == int(found[0])


def test_a_short_walk_leaves_a_cta_of_its_cluster_no_rows():
    """An expert keeping 64 rows or fewer is one step: one CTA of each of
    its owners' clusters walks it, the other none (and adds zeros); an
    empty expert gives every CTA no rows."""
    starts = torch.tensor([0, 37, 37, 200], dtype=torch.int32)
    walks = moe_gmm.dw_walks(starts, 128, 200, 64)
    assert moe_gmm.K9_CLUSTER == 2
    assert walks == [(0, 0, 0, 0), (0, 0, 0, 37), (1, 0, 37, 37), (1, 0, 37, 37),
                     (2, 0, 37, 101), (2, 0, 101, 165)]
