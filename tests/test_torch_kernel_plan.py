"""The kernels' launch plans, checked on the CPU.

``triton_update.plan_e`` and ``message_update.plan_t`` compute on the host
how the CUDA kernels are launched; the launchers take the plan as
arguments and check it. The kernels cannot run here, so these tests hold
the plans to what the kernels rely on, with numpy models of the kernels'
index arithmetic:

- an edge's split (variant, lanes per edge, source-state split, order of
  combination) depends on S alone, never on E: a graph's edges launched
  alone and inside a bucket's fold compute in the same order;
- the persistent grid's walk over tiles (and, for ``fused_update_t``, over
  chunks of destination states) covers every edge and state exactly once;
- shared memory and threads fit one block on Hopper;
- ``fused_update_e``'s bulk copies start and end on 16-byte boundaries,
  with the ragged head and tail of every tile covered by ordinary loads,
  and ``fused_update_t``'s async copies never read past the last edge.
"""

import numpy as np
import pytest

from repro_torch.kernels import message_update as MU
from repro_torch.kernels import triton_update as TT

STATES = (1, 2, 8, 9, 15, 16, 17, 31, 32, 33, 51, 64, 81, 127, 128)
STATES_T = STATES + (200,)
EDGES = (1, 3, 7, 384, 1_024, 441_088, 1_764_352, 3_996_032)
SMEM_MAX = 232_448


def walk(n_tiles, grid):
    """Tiles in the order the blocks take them: block b walks
    b, b + grid, ... (``for t = blockIdx.x; t < n_tiles; t += gridDim.x``);
    its count is ``ceil((n_tiles - b) / grid)``, as the kernels compute."""
    b = np.arange(grid, dtype=np.int64)
    mine = np.where(b < n_tiles, (n_tiles - b + grid - 1) // grid, 0)
    lt = np.arange(mine.sum()) - np.repeat(np.cumsum(mine) - mine, mine)
    return np.repeat(b, mine) + lt * grid


def edges_of(tiles, tile_edges, n_edges):
    """Every (tile, slot) edge whose slot is live."""
    e = (tiles[:, None] * tile_edges
         + np.arange(tile_edges, dtype=np.int64)[None]).reshape(-1)
    return e[e < n_edges]


def assert_exactly_once(idx, n):
    counts = np.bincount(idx, minlength=n)
    assert counts.shape == (n,) and (counts == 1).all()


@pytest.mark.parametrize("e", EDGES)
@pytest.mark.parametrize("s", STATES)
def test_plan_e(s, e):
    plan = TT.plan_e(e, s)
    # invariant 1: the per-edge split follows S only
    for other in EDGES:
        assert TT.plan_e(other, s).per_edge() == plan.per_edge()
    assert plan.variant == ("thread" if s <= 8 else "tile")
    assert plan.threads <= 1024 and plan.smem_bytes <= SMEM_MAX
    assert 1 <= plan.grid <= max(1, plan.n_tiles)
    if plan.variant == "thread":
        assert plan.threads == 256 and plan.grid == -(-e // 256)
        return
    # tile: every destination state has a lane, every lane group is one
    # warp segment or the whole block
    lanes, k = plan.lanes, plan.xi_split
    assert lanes & (lanes - 1) == 0 and lanes * 4 >= s
    assert plan.threads == plan.tile_edges * lanes * k <= 256
    assert lanes * k <= 32 or plan.tile_edges == 1
    assert (k, lanes) == ((1, 1 << (s - 1).bit_length()) if s <= 32
                          else (4, 32))
    owned = (np.arange(lanes)[:, None] + lanes * np.arange(4)[None])
    assert_exactly_once(owned[owned < s], s)
    part = -(-s // k)
    xi = np.concatenate([np.arange(j * part, min(s, (j + 1) * part))
                         for j in range(k)])
    assert_exactly_once(xi, s)
    # the persistent walk covers each edge once
    tiles = walk(plan.n_tiles, plan.grid)
    assert_exactly_once(tiles, plan.n_tiles)
    assert_exactly_once(edges_of(tiles, plan.tile_edges, e), e)
    # bulk copies: 16-byte aligned start and size, ragged ends by loads,
    # nothing read past the table, the shifted run fits its stage
    t = np.arange(plan.n_tiles, dtype=np.int64)
    live = np.minimum(plan.tile_edges, e - t * plan.tile_edges)
    f0, n = t * plan.tile_edges * s * s, live * s * s
    shift = f0 % 4
    head = np.minimum((4 - shift) % 4, n)
    body = (n - head) // 4 * 4
    tail = n - head - body
    assert ((f0 + head) % 4 == 0).all() and (body % 4 == 0).all()
    assert (head < 4).all() and (tail < 4).all() and (tail >= 0).all()
    assert (head + body + tail == n).all()
    assert int((f0 + n).max()) == e * s * s
    stage = (plan.tile_edges * s * s + 6) // 4 * 4
    assert ((shift + head) % 4 == 0).all() and (shift + n <= stage).all()
    assert (head + tail <= plan.threads).all()   # one load per thread
    smem = 16 + 4 * (2 * stage + 2 * plan.tile_edges * s
                     + (k * s if k > 1 else 0))
    assert plan.smem_bytes == smem


@pytest.mark.parametrize("e", EDGES)
@pytest.mark.parametrize("s", STATES_T)
def test_plan_t(s, e):
    plan = MU.plan_t(e, s)
    for other in EDGES:
        assert MU.plan_t(other, s).per_edge() == plan.per_edge()
        assert MU.plan_t(other, s).xj_chunk == plan.xj_chunk
    assert plan.variant == "staged" and plan.xi_split == 1
    c, eb = plan.xj_chunk, plan.tile_edges
    assert 1 <= c <= min(s, 32) and c & (c - 1) == 0
    assert plan.smem_bytes <= SMEM_MAX
    assert 32 <= plan.threads <= 512 and plan.threads % 32 == 0  # warps
    assert plan.threads % c == 0 and eb % (plan.threads // c) == 0
    assert eb % 8 == 0                   # a row load is >= one 32 B sector
    assert plan.smem_bytes == (4 * (2 * (s * c * (eb + 4) + 2 * s * eb)
                                    + 2 * s * (eb + 1)) + 2 * s * eb)
    assert 1 <= plan.grid <= plan.n_tiles == -(-e // eb)
    # chunks cover each destination state once, each edge once
    xj = (np.arange(-(-s // c))[:, None] * c + np.arange(c)[None]).ravel()
    assert_exactly_once(xj[xj < s], s)
    tiles = walk(plan.n_tiles, plan.grid)
    assert_exactly_once(tiles, plan.n_tiles)
    assert_exactly_once(edges_of(tiles, eb, e), e)
    # async copies: 16-byte pieces only where every row and tile start is
    # 16-byte aligned, and a tile's pieces end at its last live edge
    live = np.minimum(eb, e - np.arange(plan.n_tiles) * eb)
    assert plan.vec == (4 if e % 4 == 0 else 1)
    if plan.vec == 4:
        assert e % 4 == 0 and eb % 4 == 0 and (live % 4 == 0).all()


def test_plan_t_takes_any_state_count():
    """Above the staged variant's reach the one-thread-per-edge walk runs,
    so no S is refused."""
    for e in EDGES:
        top = MU.plan_t(e, MU.STAGED_MAX_STATES)
        assert top.variant == "staged" and top.smem_bytes <= SMEM_MAX
    plan = MU.plan_t(1000, MU.STAGED_MAX_STATES + 1)
    assert plan.variant == "walk" and plan.grid == -(-1000 // 256)
    with pytest.raises(ValueError):
        MU.plan_t(10, 0)
    with pytest.raises(ValueError):
        TT.plan_e(10, TT.MAX_STATES + 1)


def test_plans_grid_follows_sm_count():
    """The persistent grid is at most the card's resident blocks; fewer SMs
    give a smaller grid, never another per-edge split."""
    for plan_fn, s in ((TT.plan_e, 81), (TT.plan_e, 16), (MU.plan_t, 16),
                       (MU.plan_t, 81)):
        big, small = plan_fn(1_764_352, s), plan_fn(1_764_352, s, n_sms=8)
        assert small.grid < big.grid and small.per_edge() == big.per_edge()
        assert big.grid <= TT.N_SMS_H100 * TT.blocks_per_sm(
            big.threads, big.smem_bytes)
