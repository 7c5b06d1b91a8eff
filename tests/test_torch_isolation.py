"""ct_icp_torch stands alone: it imports neither JAX nor ct_icp_tpu, and its
entry points default to the card.

The import check runs in a subprocess with both packages blocked in
``sys.modules``, because this test process has already imported JAX
(tests/conftest.py)."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

import ct_icp_torch
from ct_icp_torch.config.options import default_driving_profile
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
