"""Map levels built by hand for the rebase tests (no JAX; shared by
test_torch_rebase.py on the CPU and test_torch_kernels_gpu.py on the card).

``chain_level``: 20 occupied rows whose voxels after the shift all hash to
one home slot of a 64-slot table, so their claims probe one chain: a round
resolves one row (the smallest index), 16 rounds resolve 16 rows and the 4
largest indices are dropped. ``merge_level``: two rows whose first points
fall in one voxel after the shift (rows 5 and 9), so they resolve to one
slot and only the writer, the larger index, is kept. Both have tombstones,
empty slots and a live key with no points (not occupied).
"""

import numpy as np
import torch

from ct_icp_torch.mapping import voxel_map as vm

RES = 0.5
P = 4
C_LOG2 = 6
CHAIN = 20
SHIFT = (3.25, -2.5, 1.75)
MERGE_ROWS = (5, 9)


def _hash(c):
    c = c.astype(np.uint32)
    return (c[:, 0] * np.uint32(73856093) + c[:, 1] * np.uint32(19349669)
            + c[:, 2] * np.uint32(83492791))


def _level(coords_by_row, seed):
    """A level of 2^C_LOG2 slots: row r (a key of its own) holds P points
    whose first point lies at the centre of voxel coords_by_row[r] after
    the shift, the other points and the normals and flags random; slots 60
    and 61 are tombstones, slot 62 a live key with no points."""
    rng = np.random.default_rng(seed)
    c = 1 << C_LOG2
    keys = np.zeros(c, np.int64)
    count = np.zeros(c, np.int32)
    points = rng.uniform(-30, 30, (c, 3 * P)).astype(np.float32)
    for r, vox in coords_by_row.items():
        keys[r] = 1000 + r
        count[r] = rng.integers(1, P + 1)
        for a in range(3):      # positive voxels: trunc(x / RES) == vox
            points[r, a * P] = np.float32((vox[a] + 0.5) * RES + SHIFT[a])
    keys[[60, 61]] = 1
    keys[62] = 5000
    level = vm.make_level(C_LOG2, P, "cpu")
    level.keys.copy_(torch.from_numpy(keys.astype(np.int32)))
    level.count.copy_(torch.from_numpy(count))
    level.points.copy_(torch.from_numpy(points))
    level.normals.copy_(torch.from_numpy(
        rng.standard_normal((c, 3)).astype(np.float32)))
    level.nflags.copy_(torch.from_numpy(rng.integers(0, 4, c).astype(
        np.int32)))
    level.num_points.copy_(torch.tensor([int(count.sum())],
                                        dtype=torch.int32))
    return level


def chain_level():
    """(level, shift, chain rows in increasing order)."""
    grid = np.stack(np.meshgrid(*[np.arange(1, 40)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    home = _hash(grid) & np.uint32((1 << C_LOG2) - 1)
    same = grid[home == home[0]][:CHAIN]
    rows = sorted(np.random.default_rng(0).choice(60, CHAIN, replace=False))
    level = _level({int(r): same[i] for i, r in enumerate(rows)}, 1)
    return level, torch.tensor(SHIFT, dtype=torch.float32), \
        [int(r) for r in rows]


def merge_level():
    """(level, shift): rows 5 and 9 in one voxel after the shift, rows 20-29
    in voxels of their own."""
    coords = {r: np.array([1 + 3 * (r - 20), 2, 3]) for r in range(20, 30)}
    coords[MERGE_ROWS[0]] = coords[MERGE_ROWS[1]] = np.array([7, 7, 7])
    level = _level(coords, 2)
    # the second row's first point elsewhere in the same voxel
    r = MERGE_ROWS[1]
    level.points[r, 0] += 0.1
    level.points[r, P] -= 0.1
    return level, torch.tensor(SHIFT, dtype=torch.float32)
