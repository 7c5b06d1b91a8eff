"""K11 owner_pack: pack a chunk of world points by voxel owner.

Replaces ``ct_icp_tpu/parallel/sharded_map.py:152-166``, the packing stage
of ``make_partitioned_update_fn``: each point's owner
``owner_hash(voxel_coords(p, resolution)) % n``, its stable rank among the
valid points of the same owner in scan order, and the point written to
``send[owner, rank]`` where ``rank < cap`` (the others dropped and
counted). The send buffers then go through one ``all_to_all`` per level.

Kernel: ``csrc/owner_pack.cu``, one cooperative launch a call: each
block's owners and their per-(owner, tile, warp) counts scanned in shared
memory, one grid barrier, each owner's prefix over the blocks, the writes
(ranks by warp match) and a 16-byte zero fill past each owner's rows. No
order-dependent atomic: the kernel equals :func:`owner_pack_plain` bit for
bit. The blocks' per-owner counts go to a scratch kept per device from
call to call (:func:`_scratch`). Bound on the card: bytes (the chunk read
once, the send buffers written once).

The one launch caps a call's size: :func:`layout` gives each of the
blocks resident together on the card a run of at most ``MAX_TILES``
256-point tiles and ``MAX_CELLS`` (owner, tile, warp) cells, so a call
takes at most ``resident * min(16, 512 // n) * 256`` points (``resident``
from ``k11_resident_blocks``), and raises a ValueError past that.

A CPU tensor takes :func:`owner_pack_plain`; a CUDA tensor launches the
kernel or raises.
"""

from typing import NamedTuple

import torch

from ct_icp_torch.kernels import build
from ct_icp_torch.ops import voxel as vx

# launches of the CUDA kernel by owner_pack, one a call (reset freely by
# callers)
launches = 0
# device -> the kernel's int32 scratch, grown to the largest call's need
_scratches = {}
# [the most owners a call takes, the blocks resident together, the
# launcher], read from the library once
_lib = []

# the kernel's tile, warps a tile and limits a block (csrc/owner_pack.cu)
THREADS = 256
WARPS = THREADS // 32
MAX_TILES = 16
MAX_CELLS = 4096

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


def layout(m: int, n: int, resident: int):
    """(tiles a block, blocks) of a call over ``m`` points for ``n`` owners
    on ``resident`` blocks resident together: the fewest tiles a block
    that the blocks cover, as few blocks as those tiles need. Raises a
    ValueError where the call would pass ``MAX_TILES`` tiles or
    ``MAX_CELLS`` cells a block."""
    n_tiles = -(-m // THREADS)
    if n_tiles == 0:
        return 0, 1
    tiles = -(-n_tiles // resident)
    if tiles > MAX_TILES or n * tiles * WARPS > MAX_CELLS:
        most = resident * min(MAX_TILES, MAX_CELLS // (n * WARPS)) * THREADS
        raise ValueError(
            f"owner_pack: m = {m} points for n = {n} owners needs {tiles} "
            f"tiles a block on {resident} resident blocks; one launch takes "
            f"at most {min(MAX_TILES, MAX_CELLS // (n * WARPS))} "
            f"({most} points)")
    return tiles, -(-n_tiles // tiles)


def owner_pack(world, valid, resolution: float, n: int, cap: int) -> Packed:
    """Pack ``world`` f32[m, 3] (where ``valid`` bool[m]) for ``n`` owners
    at ``cap`` points a pair: returns :class:`Packed`; nothing is read
    back. One launch of ``csrc/owner_pack.cu`` on the card, counted in
    ``launches``; a ValueError past :func:`layout`'s limit."""
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
    most, resident, fn = _library()
    if not 1 <= n <= most or cap < 1:
        raise ValueError(f"owner_pack: n = {n} (1..{most}), cap = {cap}")
    tiles, blocks = layout(m, n, resident)
    send = torch.empty((n, cap, 3), dtype=torch.float32, device=dev)
    send_valid = torch.empty((n, cap), dtype=torch.uint8, device=dev)
    dropped = torch.empty((1,), dtype=torch.int32, device=dev)
    status = fn(build.ptr(world), build.ptr(valid), m, float(resolution), n,
                cap, tiles, blocks, build.ptr(_scratch(dev, n * blocks)),
                build.ptr(send), build.ptr(send_valid), build.ptr(dropped),
                build.stream_of(world))
    build.check_status(status, "owner_pack")
    launches += 1
    return Packed(send, send_valid, dropped)


def resident_blocks() -> int:
    """The kernel's blocks resident together on the current CUDA device:
    the most one cooperative launch takes."""
    return _library()[1]


def _library():
    """[the most owners, the resident blocks, the launcher], once."""
    if not _lib:
        resident = build.launcher("owner_pack", "k11_resident_blocks", ())()
        if resident < 0:
            build.check_status(-resident, "owner_pack")
        _lib.extend((build.launcher("owner_pack", "k11_max_owners", ())(),
                     resident,
                     build.launcher("owner_pack", "k11_owner_pack",
                                    _ARGTYPES)))
    return _lib


def _scratch(dev, need: int):
    """The int32 scratch of ``dev`` (the blocks' per-owner counts, ``need``
    entries), kept from call to call and grown to the call's need: no call
    clears it (every launch writes the entries it reads)."""
    s = _scratches.get(dev)
    if s is None or s.shape[0] < need:
        s = _scratches[dev] = torch.empty((need,), dtype=torch.int32,
                                          device=dev)
    return s


_ARGTYPES = (build.PTR, build.PTR, build.INT, build.FLOAT, build.INT,
             build.INT, build.INT, build.INT) + (build.PTR,) * 5
