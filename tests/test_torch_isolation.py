"""ct_icp_torch stands alone: it imports neither JAX nor ct_icp_tpu, nor
PyYAML and lz4 (the card's machine has neither), and its entry points
default to the card.

The import check runs in a subprocess with both packages blocked in
``sys.modules``, because this test process has already imported JAX
(tests/conftest.py)."""

import ast
import dataclasses
import importlib
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import ct_icp_torch
from ct_icp_torch.config.options import (DistanceBasedStrategyOptions,
                                         default_driving_profile)
from ct_icp_torch.odometry.odometry import Odometry

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "ct_icp_torch"
_BLOCKED = ("jax", "ct_icp_tpu")
_NOT_ON_THE_CARD = ("yaml", "lz4")


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
        f"for name in {_BLOCKED + _NOT_ON_THE_CARD!r}:\n"
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


def test_no_source_imports_yaml_or_lz4():
    """No module of the port and not chip_smoke.py imports PyYAML or lz4,
    at any depth of the code (a function's local import included)."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f))
                                            & set(_NOT_ON_THE_CARD))
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
    # the staged per-frame path (ADAPTIVE, NONE, the random cap) and the
    # registration entry point default to the card as well; K13's wrapper
    # raises on a device that is neither
    from ct_icp_torch.config.options import SamplingOption
    from ct_icp_torch.core.pose import TrajectoryFrame
    from ct_icp_torch.icp.registration import CTICPRegistration
    from ct_icp_torch.kernels import exact_sample as k13
    from ct_icp_torch.mapping import voxel_map as vm
    d = default_driving_profile()
    for opts in (dataclasses.replace(d, sampling=SamplingOption.ADAPTIVE),
                 dataclasses.replace(d, sampling=SamplingOption.NONE),
                 dataclasses.replace(d, max_num_keypoints=1000)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Odometry(opts)
        odo = Odometry(opts, device="cpu")
        assert odo.device.type == "cpu" and not odo._fused_available
    reg = CTICPRegistration(d.ct_icp_options, d.map_options,
                            num_keypoints=16)
    cpu_map = vm.make_map(d.map_options, "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        reg.register(cpu_map, np.zeros((4, 3)), np.linspace(0, 1, 4),
                     TrajectoryFrame())
    assert not reg.register(cpu_map, np.zeros((4, 3)), np.linspace(0, 1, 4),
                            TrajectoryFrame(), device="cpu").success
    with pytest.raises(ValueError, match="no kernel"):
        k13.exact_sample(torch.zeros((8, 3), **meta),
                         torch.zeros(8, dtype=torch.bool, **meta), 4,
                         voxel_size=0.5)
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
    the modules it reaches (the long drive's scene reader, the CLI and the
    regression harness among them) import and read a scene file, a
    regression baseline and a runner config with ``yaml`` blocked too."""
    code = (
        "import sys\n"
        "for name in ('yaml', 'jax', 'ct_icp_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import chip_smoke\n"
        "from ct_icp_torch.datasets import long_drive as ld\n"
        "from ct_icp_torch.tools import bench, exp_gather\n"
        "from ct_icp_torch import cli, regression\n"
        "from ct_icp_torch.config.yaml_config import load_runner_config\n"
        "acq = ld.load_acquisition(ld.LONG_SEEDS[0])\n"
        "cfg = regression.load_regression_config(\n"
        "    'configs/regression_synthetic.yaml')\n"
        "assert cfg.runs and cfg.odometry_options is not None\n"
        "assert load_runner_config('configs/driving_config.yaml')"
        ".dataset_options\n"
        "print(acq.num_frames(), len(acq.scene.primitives))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    frames, prims = map(int, out.stdout.split())
    assert frames >= 500 and prims > 1000


# ct_icp_tpu's public names that are XLA compile structure or TPU layout and
# so have no counterpart of the same name in the port: each mapped to the
# port's "module:attribute" that takes its place
JAX_ONLY = {
    "odometry/pipeline.py::make_frame_step_fn":
        "ct_icp_torch.odometry.pipeline:make_frame_step",
    "odometry/pipeline.py::make_multi_step_fn":
        "ct_icp_torch.odometry.pipeline:make_multi_step",
    "odometry/pipeline.py::make_streaming_step_fn":
        "ct_icp_torch.odometry.pipeline:make_stream_body",
    "odometry/pipeline.py::make_update_map_fn":
        "ct_icp_torch.odometry.pipeline:update_map",
    "odometry/pipeline.py::make_device_copy_fn":
        "ct_icp_torch.odometry.pipeline:snapshot",
    # the keypoint capacity ladder of XLA's static shapes: the port's
    # frame core slices the keypoint prefix at its length
    "odometry/pipeline.py::kp_ladder_rungs":
        "ct_icp_torch.odometry.pipeline:make_frame_core",
    "icp/solver.py::jitted_register_fn":
        "ct_icp_torch.icp.solver:build_register_fn",
    "icp/solver.py::build_staged_fns":
        "ct_icp_torch.icp.solver:build_register_fn",
    "icp/solver.py::make_dynamics": "ct_icp_torch.icp.solver:unpack_dynamics",
    "icp/solver.py::unpack_prior":
        "ct_icp_torch.icp.residuals:motion_prior_residuals",
    "icp/registration.py::staged_register_loop":
        "ct_icp_torch.icp.registration:CTICPRegistration.register_device",
    "icp/registration.py::StagedLoopResult":
        "ct_icp_torch.icp.solver:RegistrationResult",
    # the TPU probe window: K1 probes the keys directly
    "mapping/voxel_map.py::build_window":
        "ct_icp_torch.mapping.voxel_map:find_slots_with_count",
    # the XLA lexsort path of the exact samplers: K13
    "ops/voxel.py::lexsort_order":
        "ct_icp_torch.kernels.exact_sample:exact_sample",
    "ops/voxel.py::group_starts":
        "ct_icp_torch.kernels.exact_sample:exact_sample",
}


def _public_names(path):
    """The public top-level functions, classes, class methods and assigned
    names (constants, aliases) of a module."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            out.update(f"{node.name}.{sub.name}" for sub in node.body
                       if isinstance(sub, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out.update(n.id for t in targets for n in ast.walk(t)
                       if isinstance(n, ast.Name))
    return {n for n in out if not any(p.startswith("_")
                                      for p in n.split("."))}


def _resolve(module, dotted):
    obj = importlib.import_module(module)
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def test_every_reference_name_has_a_counterpart():
    """Every public module, function, class, method and constant of
    ct_icp_tpu/ has a counterpart of the same name in ct_icp_torch/, or is
    in JAX_ONLY with the port function that takes its place (which must
    exist, while the name itself must not: the list stays honest)."""
    ref_root = ROOT / "ct_icp_tpu"
    missing, seen = [], 0
    for path in sorted(ref_root.rglob("*.py")):
        rel = path.relative_to(ref_root)
        parts = ("ct_icp_torch",) + rel.with_suffix("").parts
        module = ".".join(parts[:-1] if parts[-1] == "__init__" else parts)
        for name in sorted(_public_names(path)) or [None]:
            seen += 1
            key = f"{rel.as_posix()}::{name}" if name else rel.as_posix()
            try:
                if name is None:
                    importlib.import_module(module)
                else:
                    _resolve(module, name)
            except (ImportError, AttributeError):
                missing.append(key)
    assert sorted(missing) == sorted(JAX_ONLY), \
        sorted(set(missing) ^ set(JAX_ONLY))
    for key, repl in JAX_ONLY.items():
        module, attr = repl.split(":")
        assert callable(_resolve(module, attr)), (key, repl)
    assert seen > 500


def test_online_node_and_binding_default_to_the_card():
    """The online node and the pyct_icp binding's Odometry run on the card
    by default: with no card they raise, never falling back; device="cpu"
    runs the plain path."""
    from ct_icp_torch.compat import pyct_icp
    from ct_icp_torch.online import OnlineOdometry, OnlineOdometryConfig
    cfg = OnlineOdometryConfig(odometry_options=default_driving_profile())
    opts = pyct_icp.OdometryOptions.DefaultDrivingProfile()
    if torch.cuda.is_available():
        assert OnlineOdometry(cfg).odometry.device.type == "cuda"
        assert pyct_icp.Odometry(opts)._odometry.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            OnlineOdometry(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pyct_icp.Odometry(opts)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pyct_icp.Odometry()
    node = OnlineOdometry(cfg, device="cpu")
    assert node.odometry.device.type == "cpu"
    odo = pyct_icp.Odometry(opts, device="cpu")
    assert odo._odometry.device.type == "cpu" and odo.MapSize() == 0
    odo.Reset(opts)
    assert odo._odometry.device.type == "cpu"
