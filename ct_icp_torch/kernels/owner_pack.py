"""K11 owner_pack: pack a chunk of world points by voxel owner.

Replaces ``ct_icp_tpu/parallel/sharded_map.py:152-166``, the packing stage
of ``make_partitioned_update_fn``: each point's owner
``owner_hash(voxel_coords(p, resolution)) % n``, its stable rank among the
valid points of the same owner in scan order, and the point written to
``send[owner, rank]`` where ``rank < cap`` (the others dropped and
counted). The send buffers then go through one ``all_to_all`` per level.

Kernel: ``csrc/owner_pack.cu``, two launches (per-block owner counts; a
prefix over the blocks, the in-block ranks by warp match, the writes and
the zero fill), no order-dependent atomics: the kernel equals
:func:`owner_pack_plain` bit for bit. Bound on the card: bytes (the chunk
read once, the send buffers written once).

A CPU tensor takes :func:`owner_pack_plain`; a CUDA tensor launches the
kernel or raises.
"""

from typing import NamedTuple

import torch

from ct_icp_torch.kernels import build
from ct_icp_torch.ops import voxel as vx

# launches of the CUDA kernels by owner_pack, two a call (one, the write,
# for an empty chunk); reset freely by callers
launches = 0

# the reference's owner-hash primes (sharded_map.py:36-38): a second hash,
# decoupled from the slot probe hash so shard load stays uniform
_OWNER_P1 = 2654435761
_OWNER_P2 = 40503
_OWNER_P3 = 2246822519


class Packed(NamedTuple):
    send: torch.Tensor        # f32 [n, cap, 3] (zeros past each owner's)
    send_valid: torch.Tensor  # uint8 [n, cap]
    dropped: torch.Tensor     # int32 [1] valid points past cap


def owner_hash(coords):
    """Voxel coords int32 [..., 3] -> the reference's uint32 owner hash
    ``(c0 * P1 ^ c1 * P2) + c2 * P3`` of the coords' uint32 bit patterns,
    as int64 values in [0, 2^32): take ``% n`` of these, never of an
    int32 pattern."""
    c = vx._u32(coords)
    return ((vx._mul32(c[..., 0], _OWNER_P1) ^ vx._mul32(c[..., 1], _OWNER_P2))
            + vx._mul32(c[..., 2], _OWNER_P3)) & vx._MASK32


def owners(world, resolution: float, n: int):
    """The owner rank int64 [m] of each point's voxel among ``n``."""
    return owner_hash(vx.voxel_coords(world, resolution)) % n


def owner_pack_plain(world, valid, resolution: float, n: int,
                     cap: int) -> Packed:
    """Plain PyTorch version of :func:`owner_pack`: the reference's one-hot
    cumsum and scatter."""
    dev = world.device
    owner = owners(world, resolution, n)
    onehot = (owner[:, None] == torch.arange(n, device=dev)[None, :]) \
        & valid[:, None]
    rank = torch.cumsum(onehot.to(torch.int64), 0) - 1
    pos = torch.gather(rank, 1, owner[:, None])[:, 0]
    ok = valid & (pos < cap)
    send = torch.zeros((n, cap, 3), dtype=world.dtype, device=dev)
    send_valid = torch.zeros((n, cap), dtype=torch.uint8, device=dev)
    send[owner[ok], pos[ok]] = world[ok]
    send_valid[owner[ok], pos[ok]] = 1
    dropped = (valid & ~ok).sum(dtype=torch.int32).reshape(1)
    return Packed(send, send_valid, dropped)


def owner_pack(world, valid, resolution: float, n: int, cap: int) -> Packed:
    """Pack ``world`` f32[m, 3] (where ``valid`` bool[m]) for ``n`` owners
    at ``cap`` points a pair: returns :class:`Packed`; nothing is read
    back. Two launches of ``csrc/owner_pack.cu`` on the card (the count
    and the write), each counted in ``launches``; an empty chunk launches
    the write alone."""
    if world.device.type == "cpu":
        return owner_pack_plain(world, valid, resolution, n, cap)
    global launches
    dev = world.device
    if dev.type != "cuda":
        raise ValueError(f"owner_pack: no kernel for {dev}")
    m = world.shape[0]
    build.check_tensor(world, torch.float32, (m, 3), "owner_pack", "world",
                       dev)
    build.check_tensor(valid, torch.bool, (m,), "owner_pack", "valid", dev)
    most = build.launcher("owner_pack", "k11_max_owners", ())()
    if not 1 <= n <= most or cap < 1:
        raise ValueError(f"owner_pack: n = {n} (1..{most}), cap = {cap}")
    blocks = build.launcher("owner_pack", "k11_blocks", (build.INT,))(m)
    counts = torch.empty((max(blocks, 1) * n,), dtype=torch.int32,
                         device=dev)
    send = torch.empty((n, cap, 3), dtype=torch.float32, device=dev)
    send_valid = torch.empty((n, cap), dtype=torch.uint8, device=dev)
    dropped = torch.empty((1,), dtype=torch.int32, device=dev)
    fn = build.launcher("owner_pack", "k11_owner_pack", _ARGTYPES)
    status = fn(build.ptr(world), build.ptr(valid), m, float(resolution), n,
                cap, build.ptr(counts), build.ptr(send), build.ptr(send_valid),
                build.ptr(dropped), build.stream_of(world))
    build.check_status(status, "owner_pack")
    launches += 2 if blocks else 1
    return Packed(send, send_valid, dropped)


_ARGTYPES = (build.PTR, build.PTR, build.INT, build.FLOAT, build.INT,
             build.INT) + (build.PTR,) * 5
