"""Batched closed-form eigendecomposition of symmetric 3x3 matrices (torch).

Counterpart of ``ct_icp_tpu/ops/eigen3.py``: eigenvalues by the
trigonometric closed form, eigenvectors by cross-product null-space
extraction. The CUDA kernels run the same steps in registers
(``csrc/eigh3.cuh``: K2's descriptor epilogue, K10's plane fit); this is
their plain version.
"""

import torch

_TWO_PI_3 = 2.0943951023931953  # 2*pi/3


def eigh3x3(a):
    """Eigendecomposition of symmetric 3x3 matrices.

    Args:
      a: [..., 3, 3] symmetric.

    Returns:
      (eigvals [..., 3] descending, eigvecs [..., 3, 3] with eigvecs[..., i, :]
      the unit eigenvector of eigvals[..., i]).
    """
    a = 0.5 * (a + a.transpose(-1, -2))
    q = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1) / 3.0
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    b = a - q[..., None, None] * eye
    p2 = torch.sum(b * b, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp_min(p2, 0.0))
    p_safe = torch.where(p > 1e-20, p, torch.ones_like(p))
    detb = (
        b[..., 0, 0] * (b[..., 1, 1] * b[..., 2, 2] - b[..., 1, 2] * b[..., 2, 1])
        - b[..., 0, 1] * (b[..., 1, 0] * b[..., 2, 2] - b[..., 1, 2] * b[..., 2, 0])
        + b[..., 0, 2] * (b[..., 1, 0] * b[..., 2, 1] - b[..., 1, 1] * b[..., 2, 0])
    )
    r = torch.clamp(detb / (2.0 * p_safe ** 3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l0 = q + 2.0 * p * torch.cos(phi)                 # largest
    l2 = q + 2.0 * p * torch.cos(phi + _TWO_PI_3)     # smallest
    l1 = 3.0 * q - l0 - l2
    vals = torch.stack([l0, l1, l2], dim=-1)

    isotropic = p <= 1e-12 * torch.clamp_min(torch.abs(q), 1.0)

    v0 = _eigvec(a, l0)
    v2 = _eigvec(a, l2)
    # enforce orthogonality (robust under close eigenvalues)
    v2 = v2 - torch.sum(v2 * v0, dim=-1, keepdim=True) * v0
    v2 = _normalize(v2)
    v1 = torch.linalg.cross(v2, v0, dim=-1)

    vecs = torch.stack([v0, v1, v2], dim=-2)
    vecs = torch.where(isotropic[..., None, None], eye, vecs)
    vals = torch.where(isotropic[..., None], q[..., None].expand(vals.shape),
                       vals)
    return vals, vecs


def _normalize(v):
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v / torch.where(n > 1e-20, n, torch.ones_like(n))


def _eigvec(a, lam):
    """Unit null vector of (a - lam I) via the largest row cross product."""
    m = a - lam[..., None, None] * torch.eye(3, dtype=a.dtype, device=a.device)
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1, dim=-1),
                         torch.linalg.cross(r0, r2, dim=-1),
                         torch.linalg.cross(r1, r2, dim=-1)], dim=-2)
    norms = torch.sum(cands * cands, dim=-1)
    best = torch.argmax(norms, dim=-1)
    pick = torch.gather(
        cands, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    # fully degenerate row space: any unit vector is an eigenvector
    ok = torch.sum(pick * pick, dim=-1, keepdim=True) > 1e-30
    fallback = torch.zeros_like(pick)
    fallback[..., 0] = 1.0
    return _normalize(torch.where(ok, pick, fallback))
