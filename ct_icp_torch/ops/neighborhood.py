"""Neighborhood descriptors from accumulated moments (torch).

Counterpart of ``ct_icp_tpu/ops/neighborhood.py::description_from_moments``
(descriptor formulas of the reference ComputeNeighborhoodInfo,
neighborhood.h:285-316):
    linearity = (s0 - s1)/s0
    planarity = (s1 - s2)/s0
    a2D       = (sqrt(s1) - sqrt(s2))/sqrt(s0)
with s0 >= s1 >= s2 the absolute eigenvalues of the covariance. Moments are
relative to the query point, so float32 keeps its precision.
"""

from typing import NamedTuple

import torch

from ct_icp_torch.ops.eigen3 import eigh3x3


class NeighborhoodDescription(NamedTuple):
    barycenter: torch.Tensor   # [..., 3]
    covariance: torch.Tensor   # [..., 3, 3]
    normal: torch.Tensor       # [..., 3] smallest-eigenvalue direction
    line: torch.Tensor         # [..., 3] largest-eigenvalue direction
    linearity: torch.Tensor    # [...]
    planarity: torch.Tensor    # [...]
    a2D: torch.Tensor          # [...]
    eigvals: torch.Tensor      # [..., 3] descending


def description_from_moments(count, sum_rel, sum_outer, query):
    """Descriptor from accumulated moments.

    Args:
      count: [...] number of points.
      sum_rel: [..., 3] sum of (p - query).
      sum_outer: [..., 3, 3] sum of (p - query)(p - query)^T.
      query: [..., 3].
    """
    count_safe = torch.clamp_min(count.to(sum_rel.dtype), 1.0)
    mean_rel = sum_rel / count_safe[..., None]
    sec = sum_outer / count_safe[..., None, None]
    cov = sec - mean_rel[..., :, None] * mean_rel[..., None, :]
    barycenter = mean_rel + query

    vals, vecs = eigh3x3(cov)
    s = torch.abs(vals)
    s0 = torch.clamp_min(s[..., 0], 1e-20)
    linearity = (s[..., 0] - s[..., 1]) / s0
    planarity = (s[..., 1] - s[..., 2]) / s0
    a2d = (torch.sqrt(s[..., 1]) - torch.sqrt(s[..., 2])) / torch.sqrt(s0)
    return NeighborhoodDescription(
        barycenter=barycenter, covariance=cov, normal=vecs[..., 2, :],
        line=vecs[..., 0, :], linearity=linearity, planarity=planarity,
        a2D=a2d, eigvals=vals)
