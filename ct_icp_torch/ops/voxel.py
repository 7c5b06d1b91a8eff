"""Voxel coordinate / hashing primitives (plain PyTorch).

Counterpart of ``ct_icp_tpu/ops/voxel.py`` plus ``voxel_key_u32`` of
``ct_icp_tpu/mapping/voxel_map.py``. The CUDA kernels (csrc/) compute the same
functions in ``uint32_t``; these versions must agree with them bit for bit.

uint32 in torch: the CPU build has no ``+`` or ``<`` on ``torch.uint32``, so
hashes are computed in int64 and masked to 32 bits. Table keys are stored as
int32 *bit patterns* of the uint32 key (the layout the kernels read as
``uint32_t``); compare them only for equality, never by order — a key at or
above 2^31 is negative as int32.
"""

import torch

from ct_icp_torch.kernels import compact_mask as k16
# the plain version, which the plain versions of K3, K4 and K13 call
from ct_icp_torch.kernels.compact_mask import compact_mask_plain  # noqa: F401

_MASK32 = 0xFFFFFFFF

# Primes of the reference voxel hash (types.h:615-618)
_KP1 = 73856093
_KP2 = 19349669
_KP3 = 83492791
# second (identity) hash, decoupled from the probe hash
_K2A = 2654435761
_K2B = 2246822519
_K2C = 3266489917


def div_exact(x, v):
    """``x / v`` as an IEEE float32 division on every device.

    A Python (CPU-scalar) divisor lets the CUDA division kernel multiply by
    the reciprocal instead, which is not the same float; a one-element tensor
    on ``x``'s device keeps it a true division, matching the kernels and the
    reference's truncation-toward-zero voxel boundaries."""
    return x / torch.full((1,), float(v), dtype=x.dtype, device=x.device)


def voxel_coords(points, voxel_size):
    """Points [..., 3] -> int32 voxel coords [..., 3], truncated toward zero."""
    return torch.trunc(div_exact(points, voxel_size)).to(torch.int32)


def _u32(coords):
    """int32 coords -> their uint32 two's-complement values, in int64."""
    return coords.to(torch.int64) & _MASK32


def _mul32(c, k: int):
    """(c * k) mod 2^32 for c in [0, 2^32) without int64 overflow: k splits
    into 16-bit halves so each partial product stays below 2^48."""
    k_hi, k_lo = k >> 16, k & 0xFFFF
    return (c * k_lo + (((c * k_hi) & 0xFFFF) << 16)) & _MASK32


def voxel_hash_u32(coords):
    """Voxel int coords [..., 3] -> uint32 probe hash (as int64 values)."""
    c = _u32(coords)
    return (_mul32(c[..., 0], _KP1) + _mul32(c[..., 1], _KP2)
            + _mul32(c[..., 2], _KP3)) & _MASK32


def voxel_key_u32(coords):
    """Identity key of a voxel (as int64 values in [2, 2^32)): a second
    32-bit hash, biased away from the EMPTY (0) / TOMB (1) sentinels."""
    c = _u32(coords)
    h = ((_mul32(c[..., 0], _K2A) ^ _mul32(c[..., 1], _K2B))
         + _mul32(c[..., 2], _K2C)) & _MASK32
    return torch.where(h < 2, h + 2, h)


def as_i32(u):
    """uint32 values held in int64 -> the int32 bit pattern."""
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


def compact_mask(mask, capacity: int):
    """Pack the True positions of ``mask`` [N] into the front of a buffer,
    in their original order (a stable prefix-sum compaction; kernel K16 on
    the card, :func:`compact_mask_plain` on the CPU).

    Returns (indices [capacity] int32, count int32 tensor, out_valid
    [capacity] bool). Slots beyond ``count`` hold 0 and must stay masked."""
    return k16.compact_mask(mask, capacity)
