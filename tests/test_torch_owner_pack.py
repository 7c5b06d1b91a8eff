"""K11 owner_pack's design, modelled in numpy at the kernel's own tile and
block sizes, against the plain version (``owner_pack_plain``, the
reference's one-hot cumsum) on the CPU.

``csrc/owner_pack.cu`` is one cooperative launch: blocks of 256 threads
(8 warps), block b owning ``tiles`` 256-point tiles; each warp's lanes of
one owner counted into the block's (owner, tile, warp) cell; one block scan
of the cells; the blocks' per-owner totals through scratch and one grid
barrier; each owner's prefix over the blocks; a point's rank = the block's
first rank + its cell's rank + the lanes below it of the same owner; the
rows below the cap written; each owner's rows [min(total, cap), cap) zeroed
by 16-byte stores over the flat floats and flags, with single stores at
the ragged ends. The model repeats each of those steps (the warp match,
the cell scan, the prefix over blocks, the zero-fill ranges and their
16-byte split on the outputs' 256-byte aligned allocations) and asserts
that every output entry is written exactly once: a row or a zero. The
kernel itself runs on the card (``tests/test_torch_kernels_gpu.py``).
"""

import numpy as np
import pytest
import torch

from ct_icp_torch.kernels import owner_pack as k11

THREADS, WARPS = k11.THREADS, k11.WARPS
MAX_TILES, MAX_CELLS = k11.MAX_TILES, k11.MAX_CELLS
# 132 SMs at 8 blocks of 256 threads each
RESIDENT = 132 * 8


def _zero_split(base, a, e, size):
    """The kernel's ``zero_range``: [a, e) of elements of ``size`` bytes at
    byte address ``base`` -> the entries it zeroes, single and in 16-byte
    stores, each store checked to lie on a 16-byte boundary."""
    if a >= e:
        return np.zeros(0, np.int64)
    per = 16 // size
    a16 = min(a + ((16 - (base + a * size) % 16) % 16) // size, e)
    e16 = a16 + (e - a16) // per * per
    stores = a16 + per * np.arange((e16 - a16) // per)
    assert ((base + stores * size) % 16 == 0).all()
    return np.concatenate([np.arange(a, a16), stores[:, None]
                           + np.arange(per)[None, :], np.arange(e16, e)],
                          axis=None)


def model_pack(world, valid, resolution, n, cap, resident=RESIDENT):
    """The kernel's steps in numpy -> (send, send_valid, dropped), every
    entry written exactly once."""
    m = world.shape[0]
    owner = np.where(valid.numpy(),
                     k11.owners(world, resolution, n).numpy(), -1)
    tiles, blocks = k11.layout(m, n, resident)
    own = np.full(blocks * tiles * THREADS, -1, np.int64)
    own[:m] = owner
    own = own.reshape(blocks, tiles, WARPS, 32)
    # the warp match: the lanes below each lane with its owner
    same = own[..., :, None] == own[..., None, :]
    lane_rank = np.tril(same, -1).sum(-1)
    # the cells [owner][tile][warp] of each block, one exclusive scan each
    cells = np.stack([(own == o).sum(-1) for o in range(n)], 1) \
        .reshape(blocks, n * tiles * WARPS)
    scan = np.cumsum(cells, 1) - cells
    tw = tiles * WARPS
    start = np.concatenate([scan[:, ::tw] if tw else
                            np.zeros((blocks, n), np.int64),
                            cells.sum(1, keepdims=True)], 1)
    block_cnt = (start[:, 1:] - start[:, :-1]).T          # [owner, block]
    before = np.cumsum(block_cnt, 1) - block_cnt
    total = block_cnt.sum(1)
    first = before.T - start[:, :-1]                       # [block, owner]

    # each valid point's rank, from its block, tile, warp and lane
    b, t, w, lane = np.nonzero(own >= 0)
    o = own[b, t, w, lane]
    r = first[b, o] + scan[b, o * tw + t * WARPS + w] + lane_rank[b, t, w,
                                                                  lane]
    i = ((b * tiles + t) * WARPS + w) * 32 + lane
    keep = r < cap
    o, r, i = o[keep], r[keep], i[keep]
    row = o * cap + r
    writes = np.zeros(n * cap * 13, np.int64)       # stores an output byte
    send = np.full((n * cap * 3,), np.nan, np.float32)
    send_valid = np.full((n * cap,), 7, np.uint8)
    send.reshape(-1, 3)[row] = world.numpy()[i]
    send_valid[row] = 1
    np.add.at(writes, (12 * row[:, None] + np.arange(12)).reshape(-1), 1)
    np.add.at(writes, 12 * n * cap + row, 1)
    # send and send_valid: allocations of their own, 256-byte aligned
    for q in range(n):
        r0, r1 = q * cap + min(total[q], cap), (q + 1) * cap
        f = _zero_split(0, 3 * r0, 3 * r1, 4)
        send[f] = 0.0
        np.add.at(writes, (4 * f[:, None] + np.arange(4)).reshape(-1), 1)
        f = _zero_split(0, r0, r1, 1)
        send_valid[f] = 0
        np.add.at(writes, 12 * n * cap + f, 1)
    send = send.reshape(n, cap, 3)
    send_valid = send_valid.reshape(n, cap)
    assert (writes == 1).all()
    dropped = int(np.maximum(total - cap, 0).sum())
    return send, send_valid, dropped


def _chunk(m, seed):
    """A street-like chunk (ground and two walls) with a tenth of its
    points invalid."""
    rng = np.random.default_rng(seed)
    g = np.stack([rng.uniform(-20, 20, m), rng.uniform(-10, 10, m),
                  rng.normal(scale=0.02, size=m)], -1)
    wall = np.stack([rng.uniform(-20, 20, m),
                     np.where(rng.uniform(size=m) < .5, -10.0, 10.0),
                     rng.uniform(0, 6, m)], -1)
    pick = rng.uniform(size=m) < 0.5
    pts = np.where(pick[:, None], g, wall).astype(np.float32)
    return torch.from_numpy(pts), torch.from_numpy(rng.uniform(size=m) < 0.9)


def _few(m, n):
    """The fewest resident blocks that the kernel's limits allow (16 tiles
    and 4,096 cells a block): each block then owns a run of tiles."""
    most = min(MAX_TILES, MAX_CELLS // (WARPS * n))
    return max(2, -(-(-(-m // THREADS)) // most))


@pytest.mark.parametrize("resident", ["card", "few"])
@pytest.mark.parametrize("n", [1, 2, 3, 64])
@pytest.mark.parametrize("m", [0, 1, 1023, 1025, 33333])
def test_owner_pack_model_matches_plain(m, n, resident):
    """The model equals the plain version bit for bit, at a cap that drops
    points and one that keeps them all; on the H100's resident blocks (one
    tile a block at these sizes) and on the fewest the kernel's limits
    allow (1,025 points: 3 tiles a block; 33,333: 15 at n = 1, 8 at
    n = 64)."""
    world, valid = _chunk(m, m + n)
    n_valid = int(valid.sum())
    res = RESIDENT if resident == "card" else _few(m, n)
    for cap in (max(n_valid // (2 * n), 1), n_valid + 1):
        send, send_valid, dropped = model_pack(world, valid, 0.8, n, cap,
                                               res)
        want = k11.owner_pack_plain(world, valid, 0.8, n, cap)
        np.testing.assert_array_equal(send, want.send.numpy())
        np.testing.assert_array_equal(send_valid, want.send_valid.numpy())
        assert dropped == int(want.dropped[0])
        if cap < n_valid // n:
            assert dropped > 0


@pytest.mark.parametrize("resident", [RESIDENT, 264, 1])
@pytest.mark.parametrize("n", [1, 2, 32, 33, 64])
def test_layout_limit(n, resident):
    """``layout`` at the most points one launch takes: the blocks cover the
    chunk within the kernel's limits; one point more raises a ValueError
    naming the limit."""
    most_tiles = min(MAX_TILES, MAX_CELLS // (n * WARPS))
    most = resident * most_tiles * THREADS
    for m in (1, THREADS * resident, most - 1, most):
        tiles, blocks = k11.layout(m, n, resident)
        assert 1 <= blocks <= resident and tiles <= most_tiles
        assert (blocks - 1) * tiles * THREADS < m <= blocks * tiles * THREADS
    assert k11.layout(0, n, resident) == (0, 1)
    with pytest.raises(ValueError, match=f"at most {most_tiles} .{most} "):
        k11.layout(most + 1, n, resident)


def test_owner_pack_cpu_is_plain():
    """On a CPU tensor the wrapper is the plain version; nothing is
    launched."""
    world, valid = _chunk(1000, 5)
    before = k11.launches
    got = k11.owner_pack(world, valid, 0.8, 3, 200)
    want = k11.owner_pack_plain(world, valid, 0.8, 3, 200)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert k11.launches == before
