"""Voxel-grid subsampling: the keypoint grid election and the exact
samplers.

Counterpart of ``ct_icp_tpu/ops/sampling.py``, with the JAX signatures:
  * ``voxel_subsample_indices``: one representative per voxel (the smallest
    scan index among the valid points whose voxel hashes to the same slot
    of a 2^table_log2 claim table), kernel K4 (kernels/grid_sample.py);
  * ``voxel_subsample_indices_exact``, ``voxel_sample_k_indices`` and
    ``adaptive_grid_sampling_indices``: up to k points a voxel grouped by
    the exact voxel key (and, ADAPTIVE, the range band), kernel K13
    (kernels/exact_sample.py); the same results as the reference's
    lexsorts, without a sort;
  * ``random_cap_indices``: the random keypoint cap, plain torch (one
    stable sort of the keypoint scores a frame), given the scores.
Each returns (indices int32[capacity] into the input, out_valid
bool[capacity], count 0-dim int32), packed in scan order; the kernels run
on the card, their plain versions on the CPU.
"""

import torch

from ct_icp_torch.kernels import exact_sample as k13
from ct_icp_torch.kernels import grid_sample as k4


def voxel_subsample_indices(points, valid, voxel_size: float, capacity: int,
                            table_log2: int = 22):
    """(indices int32[capacity] into ``points``, out_valid bool[capacity],
    count 0-dim int32 = min(representatives, capacity))."""
    return k4.grid_sample(points, valid, voxel_size, capacity, table_log2)


def voxel_subsample_indices_exact(points, valid, voxel_size: float,
                                  capacity: int):
    """One point a voxel, the earliest of each exact voxel key (no two
    voxels merge)."""
    return k13.exact_sample(points, valid, capacity, voxel_size=voxel_size)


def voxel_sample_k_indices(points, valid, voxel_size: float, capacity: int,
                           num_per_voxel: int):
    """Up to ``num_per_voxel`` points a voxel, each voxel's earliest."""
    return k13.exact_sample(points, valid, capacity, voxel_size=voxel_size,
                            k=num_per_voxel)


def adaptive_grid_sampling_indices(points, valid, options, capacity: int):
    """Distance-banded adaptive sampling (reference sampling.h:55-110): a
    point at range d takes the voxel size of the last band whose lower
    edge is < d; points below the first edge or at or past the last are
    dropped; up to ``options.num_points_per_voxel`` points a (band, voxel),
    then the first ``options.max_num_points`` (> 0) in scan order.
    ``options`` is AdaptiveGridSamplingOptions."""
    return k13.exact_sample(points, valid, capacity,
                            bands=options.distance_voxel_size,
                            k=max(options.num_points_per_voxel, 1),
                            max_keep=options.max_num_points)


def random_cap_indices(valid, scores, capacity: int, max_keep: int):
    """The random cap to ``max_keep`` points (reference odometry.cpp:549-552
    shuffles and resizes): the valid entries ranked by ``scores`` f32[N]
    (uniform in [0, 1); invalid entries rank last, at 2.0) with a stable
    sort, as ``jnp.argsort`` is. Returns (indices int32[:capacity],
    out_valid bool[capacity], count 0-dim int32 = min(valid, max_keep))."""
    s = torch.where(valid, scores, torch.full_like(scores, 2.0))
    order = torch.argsort(s, stable=True)
    count = torch.clamp_max(valid.sum(dtype=torch.int32), max_keep)
    idx = order[:capacity].to(torch.int32)
    out_valid = torch.arange(capacity, dtype=torch.int32,
                             device=valid.device) < count
    return idx, out_valid, count
