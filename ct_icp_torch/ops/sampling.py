"""Voxel-grid subsampling (the keypoint grid election).

Counterpart of ``ct_icp_tpu/ops/sampling.py::voxel_subsample_indices``: one
representative per voxel — the smallest scan index among the valid points
whose voxel hashes to the same slot of a 2^table_log2 claim table — packed
in scan order into a fixed-capacity index buffer. Kernel K4
(kernels/grid_sample.py) on the card, its plain version on the CPU.

The module only passes the call on to K4's wrapper. It is kept so that the
port mirrors ct_icp_tpu's module layout: the frame core calls
``ops.sampling.voxel_subsample_indices`` where the reference's does.
"""

from ct_icp_torch.kernels import grid_sample as k4


def voxel_subsample_indices(points, valid, voxel_size: float, capacity: int,
                            table_log2: int = 22):
    """(indices int32[capacity] into ``points``, out_valid bool[capacity],
    count 0-dim int32 = min(representatives, capacity))."""
    return k4.grid_sample(points, valid, voxel_size, capacity, table_log2)
