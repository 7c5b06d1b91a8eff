"""ct_icp_torch stands alone: it imports neither JAX nor ct_icp_tpu, and its
entry points default to the card.

The import check runs in a subprocess with both packages blocked in
``sys.modules``, because this test process has already imported JAX
(tests/conftest.py)."""

import ast
import dataclasses
import json
import pathlib
import subprocess
import sys

import pytest
import torch

import ct_icp_torch
from ct_icp_torch.config.options import (DistanceBasedStrategyOptions,
                                         default_driving_profile)
from ct_icp_torch.odometry.odometry import Odometry

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "ct_icp_torch"
_BLOCKED = ("jax", "ct_icp_tpu")


def _port_modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_module_imports_with_jax_blocked():
    mods = _port_modules() + ["chip_smoke"]
    code = (
        "import importlib, json, sys\n"
        f"for name in {_BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"mods = {mods!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "leaked = sorted(k for k in sys.modules\n"
        f"                if k.split('.')[0] in {_BLOCKED!r}\n"
        "                and sys.modules[k] is not None)\n"
        "print(json.dumps({'n': len(mods), 'leaked': leaked}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"n": len(mods), "leaked": []}
    assert len(mods) > 20


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f))
                                            & set(_BLOCKED))
           for f in files}
    assert {f: b for f, b in bad.items() if b} == {}
    assert len(files) > 20


def test_rank_helpers_import_with_jax_blocked(tmp_path):
    """The multi-rank tests' rank bodies (tests/torch_dist_cases.py) and the
    spawn helper (parallel/comm.py) import no JAX, and a spawned rank's
    process loads neither JAX nor the reference."""
    from ct_icp_torch.parallel import comm
    helper = ROOT / "tests" / "torch_dist_cases.py"
    assert not set(_imported_roots(helper)) & set(_BLOCKED)
    loaded = comm.spawn("torch_dist_cases:loaded_modules", 2, tmp_path)
    for mods in loaded:
        assert "torch" in mods and "ct_icp_torch" in mods
        assert not set(mods) & set(_BLOCKED), mods


def _search_profiles():
    """The driving profile with each search option this slice ports."""
    d = default_driving_profile()
    return [
        dataclasses.replace(d, ct_icp_options=dataclasses.replace(
            d.ct_icp_options, ball_neighborhood=False)),
        dataclasses.replace(d, ct_icp_options=dataclasses.replace(
            d.ct_icp_options, ball_neighborhood=False,
            num_closest_neighbors=2)),
        dataclasses.replace(
            d, distance_strategy=DistanceBasedStrategyOptions()),
        dataclasses.replace(d, host_subsample=False)]


def test_entry_points_default_to_the_card():
    assert ct_icp_torch.DEFAULT_DEVICE == "cuda"
    if torch.cuda.is_available():
        assert ct_icp_torch.resolve_device().type == "cuda"
        return
    # no card: asking for the default device raises, never falls back
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ct_icp_torch.resolve_device()
    with pytest.raises(RuntimeError):
        Odometry(default_driving_profile())
    assert Odometry(default_driving_profile(),
                    device="cpu").device.type == "cpu"
    # the searches and the device sub-sample of this slice too: the
    # options resolve to the card by default, and a kernel wrapper given a
    # tensor that is neither on the CPU nor on the card raises
    for opts in _search_profiles():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Odometry(opts)
        assert Odometry(opts, device="cpu").device.type == "cpu"
    from ct_icp_torch.kernels import knn_search as k12
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k12.knn_search(torch.zeros((8, 6), **meta),
                       torch.zeros((2, 1), dtype=torch.int32, **meta),
                       torch.zeros((2, 1), dtype=torch.int32, **meta),
                       torch.zeros((2, 3), **meta), 1.0, 1)
    # the scale-out entry points too
    from ct_icp_torch.parallel import sharded_map as sm
    from ct_icp_torch.parallel.distributed_odometry import \
        DistributedOdometry
    map_options = default_driving_profile().map_options
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sm.make_sharded_map(map_options)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DistributedOdometry(default_driving_profile())
    shard = sm.make_sharded_map(map_options, device="cpu")
    assert all(level.keys.device.type == "cpu" for level in shard.levels)


def test_the_card_path_needs_no_yaml():
    """The machine with the card is not promised PyYAML: chip_smoke.py and
    the modules it reaches (the long drive's scene reader among them)
    import and read a scene file with ``yaml`` blocked too."""
    code = (
        "import sys\n"
        "for name in ('yaml', 'jax', 'ct_icp_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import chip_smoke\n"
        "from ct_icp_torch.datasets import long_drive as ld\n"
        "from ct_icp_torch.tools import bench, exp_gather\n"
        "acq = ld.load_acquisition(ld.LONG_SEEDS[0])\n"
        "print(acq.num_frames(), len(acq.scene.primitives))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    frames, prims = map(int, out.stdout.split())
    assert frames >= 500 and prims > 1000
