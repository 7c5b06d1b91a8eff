"""K14 scan_transform: the scan's wire unpack and the per-point
continuous-time transform.

Replaces three XLA elementwise programs of
``ct_icp_tpu/odometry/pipeline.py``: ``unpack_scan`` (:125, u16 [R, 4] wire
rows to xyz f32 [R, 3] at 1/128 m and alphas f32 [R] = code / 65535),
``transform_points`` (:66, world = slerp(qb, qe, a) * raw + lerp(tb, te, a)
a point) and ``distort_raw`` (:56, the same, then end^-1 * world). Two
entry points of one source: :func:`unpack` at the stream body and the
frame step, :func:`transform` wherever a sub-frame goes to the world (the
frame core, the staged path) or is bent by the initial poses
(CONSTANT_VELOCITY).

Kernel: ``csrc/scan_transform.cu`` — a thread a row; the slerp's setup
(dot, sign flip, branch, acos, sin, and the end pose's inverse for
``distort``) once a block from the poses on the device, then each thread
blends its own alpha, in the plain version's operation order
(round-to-nearest intrinsics, IEEE division and sqrt, libdevice's sinf and
acosf, the quaternion sums in torch's reduction order), on the grid
:func:`grid_blocks` sizes. Bound on the card:
bytes (unpack 8 B a row in, 16 B out; transform 16 B in, 12 B out).

A CPU tensor takes the plain versions; a CUDA tensor launches the kernel or
raises.
"""

import torch

from ct_icp_torch.core import se3 as s3
from ct_icp_torch.icp import residuals as res
from ct_icp_torch.kernels import build
from ct_icp_torch.ops.voxel import div_exact

THREADS = 256            # a row a thread, csrc/scan_transform.cu's block
SCAN_QUANT = 128.0       # 1/128 m per LSB of the wire format

# launches of the CUDA kernel by unpack and transform (reset freely by
# callers)
launches = 0


def unpack_plain(packed):
    """Plain PyTorch version of :func:`unpack`."""
    xyz = packed[:, 0:3].to(torch.float32) / SCAN_QUANT   # exact: 2^-7
    alphas = div_exact((packed[:, 3].to(torch.int32) & 0xFFFF).to(
        torch.float32), 65535.0)
    return xyz, alphas


def transform_plain(raw, alphas, qb, tb, qe, te, distort: bool = False):
    """Plain PyTorch version of :func:`transform` (the reference's
    ``transform_points``, or with ``distort`` its ``distort_raw``)."""
    world = res.interp_world_points(qb, tb, qe, te, raw, alphas)
    if not distort:
        return world
    qi, ti = s3.se3_inverse(qe, te)
    return s3.quat_rotate(qi.expand(world.shape[:-1] + (4,)), world) + ti


def grid_blocks(rows: int) -> int:
    """Blocks of a launch over ``rows`` rows (0: no launch)."""
    if rows < 0:
        raise ValueError(f"scan_transform: {rows} rows")
    return -(-rows // THREADS)


def unpack(packed):
    """The device side of ``pipeline.pack_scan_u16``: ``packed`` int16[R, 4]
    (the int16 view of the u16 rows) -> (xyz f32[R, 3], alphas f32[R]). One
    launch on the card; the outputs share one allocation."""
    if packed.device.type == "cpu":
        return unpack_plain(packed)
    global launches
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"scan_transform: no kernel for {dev}")
    rows = packed.shape[0]
    build.check_tensor(packed, torch.int16, (rows, 4), "scan_transform",
                       "packed", dev)
    buf = torch.empty((4 * rows,), dtype=torch.float32, device=dev)
    xyz, alphas = buf[:3 * rows].view(rows, 3), buf[3 * rows:]
    fn = build.launcher("scan_transform", "k14_unpack", _UNPACK_ARGTYPES)
    status = fn(build.ptr(packed), rows, grid_blocks(rows), build.ptr(xyz),
                build.ptr(alphas), build.stream_of(packed))
    build.check_status(status, "scan_transform")
    launches += 1
    return xyz, alphas


def transform(raw, alphas, qb, tb, qe, te, distort: bool = False):
    """World points of ``raw`` f32[N, 3] at their ``alphas`` f32[N] between
    the begin pose (qb f32[4], tb f32[3]) and the end pose (qe, te), all on
    one device: slerp of the rotation, lerp of the translation. With
    ``distort``, the result is then brought into the end pose's frame
    (end^-1 * world). One launch on the card; returns f32[N, 3]."""
    if raw.device.type == "cpu":
        return transform_plain(raw, alphas, qb, tb, qe, te, distort)
    global launches
    dev = raw.device
    if dev.type != "cuda":
        raise ValueError(f"scan_transform: no kernel for {dev}")
    n = raw.shape[0]
    for t, shape, name in ((raw, (n, 3), "raw"), (alphas, (n,), "alphas"),
                           (qb, (4,), "qb"), (tb, (3,), "tb"),
                           (qe, (4,), "qe"), (te, (3,), "te")):
        build.check_tensor(t, torch.float32, shape, "scan_transform", name,
                           dev)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    fn = build.launcher("scan_transform", "k14_transform",
                        _TRANSFORM_ARGTYPES)
    status = fn(build.ptr(raw), build.ptr(alphas), n, grid_blocks(n),
                build.ptr(qb), build.ptr(tb), build.ptr(qe), build.ptr(te),
                int(distort), build.ptr(out), build.stream_of(raw))
    build.check_status(status, "scan_transform")
    launches += 1
    return out


_UNPACK_ARGTYPES = (build.PTR, build.INT, build.INT, build.PTR, build.PTR,
                    build.PTR)
_TRANSFORM_ARGTYPES = ((build.PTR,) * 2 + (build.INT,) * 2 + (build.PTR,) * 4
                       + (build.INT,) + (build.PTR,) * 2)
