"""Geometry utilities: rigid alignment and robust center estimation.

Host copy of ``ct_icp_tpu/core/geometry.py`` (numpy only, nothing of the JAX
package imported).

Host-side float64 counterparts of the reference's SlamCore geometry helpers
(reference include/SlamCore/geometry.h, src/SlamCore/geometry.cxx).
"""

from typing import Tuple

import numpy as np

from ct_icp_torch.core import se3_np as s3n


def orthogonal_procrustes(reference_points: np.ndarray,
                          target_points: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Least-squares optimal rigid transform T such that T * reference ~
    target (reference OrthogonalProcrustes, src/SlamCore/geometry.cxx:7-46:
    SVD of the cross-covariance with a reflection fix).

    Args:
      reference_points, target_points: [N, 3] float arrays, N > 3.

    Returns:
      (quat [4] wxyz, tr [3]) with ``quat_rotate(quat, ref) + tr ≈ target``.
    """
    ref = np.asarray(reference_points, np.float64)
    tgt = np.asarray(target_points, np.float64)
    if ref.shape[0] <= 3:
        raise ValueError("orthogonal_procrustes needs more than 3 points")
    if ref.shape != tgt.shape:
        raise ValueError(f"size mismatch {ref.shape} vs {tgt.shape}")
    center_ref = ref.mean(axis=0)
    center_tgt = tgt.mean(axis=0)
    m = (tgt - center_tgt).T @ (ref - center_ref)
    u, _, vt = np.linalg.svd(m)
    r = u @ vt
    if np.linalg.det(r) < 0.0:
        d = np.diag([1.0, 1.0, -1.0])
        r = u @ d @ vt
    quat = s3n.quat_from_matrix(r)
    tr = center_tgt - r @ center_ref
    return quat, tr


def geometric_median(points: np.ndarray, max_num_iters: int = 100,
                     stop_criterion: float = 1e-4
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Weiszfeld's algorithm (reference GeometricMedian, geometry.h:25-88).

    Returns (mean, geometric_median) of the distribution; the iteration
    starts from the mean and stops when the estimate moves less than
    ``stop_criterion`` between iterations.
    """
    pts = np.asarray(points, np.float64)
    if pts.shape[0] == 0:
        raise ValueError("Need at least one point to compute a mean")
    mean = pts.mean(axis=0)
    best = mean.copy()
    for _ in range(max_num_iters):
        dist = np.linalg.norm(pts - best, axis=1)
        # the reference divides by the raw distance; guard exact hits
        w = 1.0 / np.maximum(dist, 1e-12)
        estimate = (pts * w[:, None]).sum(axis=0) / w.sum()
        diff = np.linalg.norm(best - estimate)
        best = estimate
        if diff < stop_criterion:
            break
    return mean, best
