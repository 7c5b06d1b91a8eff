"""Neighborhood descriptors (torch): from a masked neighbour list or from
accumulated moments.

Counterpart of ``ct_icp_tpu/ops/neighborhood.py::compute_description`` and
``::description_from_moments`` (descriptor formulas of the reference
ComputeNeighborhoodInfo, neighborhood.h:285-316):
    linearity = (s0 - s1)/s0
    planarity = (s1 - s2)/s0
    a2D       = (sqrt(s1) - sqrt(s2))/sqrt(s0)
with s0 >= s1 >= s2 the absolute eigenvalues of the covariance. Moments are
relative to the query point, so float32 keeps its precision.
"""

from typing import NamedTuple

import torch

from ct_icp_torch.ops.eigen3 import eigh3x3

# Classification of a neighborhood (reference neighborhood.h:268-282)
CLASS_NONE = 0
CLASS_PLANAR = 1
CLASS_LINEAR = 2
CLASS_VOLUMIC = 3


class NeighborhoodDescription(NamedTuple):
    barycenter: torch.Tensor   # [..., 3]
    covariance: torch.Tensor   # [..., 3, 3]
    normal: torch.Tensor       # [..., 3] smallest-eigenvalue direction
    line: torch.Tensor         # [..., 3] largest-eigenvalue direction
    linearity: torch.Tensor    # [...]
    planarity: torch.Tensor    # [...]
    a2D: torch.Tensor          # [...]
    eigvals: torch.Tensor      # [..., 3] descending


def compute_description(neighbors, neighbor_mask, query):
    """Masked descriptor of a neighbour list (the k-NN search's).

    Args:
      neighbors: [..., K, 3] neighbour positions (any finite value where
        masked).
      neighbor_mask: [..., K] bool.
      query: [..., 3], the local origin of the covariance.

    The reference's arithmetic order: the masked offsets, their mean, the
    six second moments summed over the neighbours, then
    ``sec / count - mean mean^T``."""
    w = neighbor_mask.to(neighbors.dtype)
    count_safe = torch.clamp_min(w.sum(-1), 1.0)
    rel = (neighbors - query[..., None, :]) * w[..., None]
    mean_rel = rel.sum(-2) / count_safe[..., None]
    x, y, z = rel[..., 0], rel[..., 1], rel[..., 2]
    sxx, sxy, sxz = (x * x).sum(-1), (x * y).sum(-1), (x * z).sum(-1)
    syy, syz, szz = (y * y).sum(-1), (y * z).sum(-1), (z * z).sum(-1)
    sec = torch.stack([torch.stack([sxx, sxy, sxz], -1),
                       torch.stack([sxy, syy, syz], -1),
                       torch.stack([sxz, syz, szz], -1)], -2) \
        / count_safe[..., None, None]
    cov = sec - mean_rel[..., :, None] * mean_rel[..., None, :]
    return _describe(cov, mean_rel + query)


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
    return _describe(cov, mean_rel + query)


def _describe(cov, barycenter):
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


def classify(desc, linearity_threshold, planarity_threshold, count):
    """PLANAR / LINEAR / VOLUMIC / NONE (reference neighborhood.h:268-282):
    planarity first, then linearity, then VOLUMIC where more than five
    points were found."""
    cls = torch.where(count > 5, CLASS_VOLUMIC, CLASS_NONE)
    cls = torch.where(desc.linearity > linearity_threshold, CLASS_LINEAR, cls)
    return torch.where(desc.planarity > planarity_threshold, CLASS_PLANAR,
                       cls)
