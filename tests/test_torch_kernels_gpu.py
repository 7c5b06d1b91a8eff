"""CUDA kernels K1-K3 against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc (the kernels build from ct_icp_torch/csrc at
first use); skips elsewhere. Run on a machine with the card (this file needs
no JAX, so skip the repo conftest that pins JAX to the CPU):

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -q

Tolerances are those of ct_icp_torch/kernels/checks.py.
"""

import numpy as np
import pytest
import torch

from ct_icp_torch.kernels import checks
from ct_icp_torch.mapping import voxel_map as vm

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _scene(rng, n):
    """Ground + two walls, like a street corridor."""
    g = np.stack([rng.uniform(-20, 20, n), rng.uniform(-10, 10, n),
                  rng.normal(scale=0.02, size=n)], -1)
    w = np.stack([rng.uniform(-20, 20, n), np.where(rng.uniform(size=n) < .5,
                                                    -10.0, 10.0),
                  rng.uniform(0, 6, n)], -1)
    return np.concatenate([g, w]).astype(np.float32)


def _warm_level(rng, dev, cap_log2=14, p=30, res=0.8):
    level = vm.make_level(cap_log2, p, dev)
    pts = torch.from_numpy(_scene(rng, 20000)).to(dev)
    ok = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
    vm.insert_points(level, pts, ok, res, 0.1, max_rounds=12)
    return level


@pytest.mark.parametrize("nv", [1, 2])
def test_candidate_gather_matches_plain(cuda, nv):
    rng = np.random.default_rng(0)
    level = _warm_level(rng, cuda)
    q = torch.from_numpy(_scene(rng, 600)).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=q.shape[0]) < 0.9).to(cuda)
    for thr in (1, 5):
        checks.check_candidate_gather(level, q, valid, 0.8, nv, thr)


@pytest.mark.parametrize("k_nearest", [40, 0, None])
def test_plane_moments_matches_plain(cuda, k_nearest):
    rng = np.random.default_rng(1)
    level = _warm_level(rng, cuda)
    q = torch.from_numpy(_scene(rng, 700)).to(cuda)
    valid = torch.ones(q.shape[0], dtype=torch.bool, device=cuda)
    rows, cnt = vm.gather_candidate_planes(level, q, valid, 0.8, 1)
    checks.check_plane_moments(rows, cnt, q, 0.75, k_nearest)
    cached = torch.full((q.shape[0],), 0.3, device=cuda)
    if k_nearest is not None:
        checks.check_plane_moments(rows, cnt, q + 0.02, 0.75, k_nearest,
                                   cached)


@pytest.mark.parametrize("max_rounds", [4, 12])
def test_map_insert_matches_plain(cuda, max_rounds):
    rng = np.random.default_rng(2)
    level = _warm_level(rng, cuda, cap_log2=12)   # ~loaded: long probe chains
    pts = torch.from_numpy(_scene(rng, 8000)).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=pts.shape[0]) < 0.95).to(cuda)
    out = checks.check_map_insert(level, pts, valid, 0.8, 0.1, max_rounds)
    assert out["inserted"] > 0
    vm.prune_level(level, torch.zeros(3, device=cuda), 8.0)
    out = checks.check_map_insert(level, pts + 0.05, valid, 0.8, 0.1,
                                  max_rounds)
    assert out["inserted"] > 0
