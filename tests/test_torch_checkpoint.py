"""The port's checkpoint (``ct_icp_torch/odometry/checkpoint.py``): a round
trip in the port continues bit for bit, frame by frame and streamed (the
streamed path's device state rebuilt from the trajectory with the device's
own float32 quaternions, recovered from their float64 normalization); a
checkpoint written by ct_icp_tpu loads into the port without importing the
JAX package, in the reference's layout: saved again by the port it gives
the reference's arrays and values bit for bit, and the port's continuation
stays within tests/test_torch_odometry.py's bounds (5 mm, 0.05 deg) of the
reference's own continuation (test_checkpoint_roundtrip's 1e-6 m and
1e-4 deg hold a package to itself; the two packages' float32 sums part by
more on every frame, from the same state); a sidecar whose pickles name
any class but the two pose classes and numpy's arrays is refused."""

import json
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ct_icp_torch.odometry import checkpoint as tck
from ct_icp_torch.odometry.odometry import Odometry as TOdometry
from tests.torch_runner_cases import end_gap, frames, options_pair

REPO = Path(__file__).resolve().parent.parent
ACROSS = (5e-3, 0.05)         # tests/test_torch_odometry.py:109-110


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """One torch thread: the plain kernels run many small ops, and the other
    test workers keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _same_trajectory(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for p, q in ((x.begin_pose, y.begin_pose), (x.end_pose, y.end_pose)):
            np.testing.assert_array_equal(p.quat, q.quat)
            np.testing.assert_array_equal(p.tr, q.tr)


def _register(odo, frs, first=0):
    for i, fr in enumerate(frs, start=first):
        assert odo.register_frame(fr["xyz"], fr["timestamps"],
                                  frame_id=i).success


def _stream(odo, frs, first=0, batch=2):
    preps = [odo.prepare_frame(fr["xyz"], fr["timestamps"], i, frame_id=i)
             for i, fr in enumerate(frs, start=first)]
    assert all(s.success for s in odo.stream_frames(iter(preps), batch=batch))


@pytest.mark.parametrize("mode", ["per_frame", "streamed"])
def test_port_round_trip_continues(tmp_path, mode):
    run = _register if mode == "per_frame" else _stream
    _, to = options_pair()
    frs = frames(23, 6)
    odo = TOdometry(to, device="cpu")
    run(odo, frs[:4])
    tck.save_checkpoint(odo, tmp_path / "state")
    run(odo, frs[4:], first=4)
    odo2 = TOdometry(to, device="cpu")
    tck.load_checkpoint(odo2, tmp_path / "state.npz")
    assert odo2.registered_frames == 4 and len(odo2.trajectory) == 4
    run(odo2, frs[4:], first=4)
    _same_trajectory(odo2.get_trajectory(), odo.get_trajectory())
    for a, b in zip(odo2.map_state, odo.map_state):
        for f in ("keys", "count", "points", "num_points"):
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          getattr(b, f).numpy())


def test_device_quaternions_recovered():
    """Float32 quaternions whose norm is within float32's epsilon of 1,
    normalized in float64 as the host does, come back bit for bit."""
    from ct_icp_torch.core import se3_np as s3n
    rng = np.random.default_rng(8)
    q = rng.normal(size=(200, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q32 = (q * (1 + rng.uniform(-1.2e-7, 1.2e-7, (200, 1)))).astype(np.float32)
    for c in q32:
        got = tck._device_quat(s3n.quat_normalize(c.astype(np.float64)))
        np.testing.assert_array_equal(got, c)


def test_reference_checkpoint_continues_in_the_port(tmp_path):
    from ct_icp_tpu.odometry.checkpoint import save_checkpoint
    from ct_icp_tpu.odometry.odometry import Odometry as JOdometry
    jo, to = options_pair()
    frs = frames(23, 6)
    j = JOdometry(jo)
    _register(j, frs[:4])
    save_checkpoint(j, tmp_path / "state")
    # the reference's own continuation (its test_checkpoint_roundtrip holds
    # a reload of these files to it within 1e-6 m, 1e-4 deg)
    _register(j, frs[4:], first=4)
    # the port's, from the same files, without the JAX package
    code = (
        "import sys, numpy as np\n"
        "from ct_icp_torch.convert import options_from_dict\n"
        "from ct_icp_torch.odometry.checkpoint import load_checkpoint\n"
        "from ct_icp_torch.odometry.odometry import Odometry\n"
        "import json\n"
        f"opts = options_from_dict(json.load(open({str(tmp_path / 'o.json')!r})))\n"
        "odo = Odometry(opts, device='cpu')\n"
        f"load_checkpoint(odo, {str(tmp_path / 'state')!r})\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('ct_icp_tpu', 'jax')], 'the JAX package was imported'\n"
        "assert type(odo.default_motion_model.previous_frame).__module__ "
        "== 'ct_icp_torch.core.pose'\n"
        "print(odo.registered_frames, len(odo.trajectory))\n")
    import dataclasses
    (tmp_path / "o.json").write_text(json.dumps(
        dataclasses.asdict(jo), default=lambda e: e.value))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["4", "4"]
    t = TOdometry(to, device="cpu")
    tck.load_checkpoint(t, tmp_path / "state.npz")
    # the restored state is the reference's, bit for bit
    _same_trajectory(t.trajectory, j.trajectory[:4])
    np.testing.assert_array_equal(
        t.map_state[0].keys.numpy().view(np.uint32),
        np.load(tmp_path / "state.npz")["level0_keys"])
    # saved again by the port: the reference's files, bit for bit
    tck.save_checkpoint(t, tmp_path / "again")
    with np.load(tmp_path / "state.npz") as a, \
            np.load(tmp_path / "again.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    ma = json.loads((tmp_path / "state.meta.json").read_text())
    mb = json.loads((tmp_path / "again.meta.json").read_text())
    assert ma.pop("rng") == mb.pop("rng")
    pa, pb = (tck._loads(m.pop("prev_frame")) for m in (ma, mb))
    assert ma == mb
    _same_trajectory([pa], [pb])
    _register(t, frs[4:], first=4)
    d_m, d_deg = end_gap(t.get_trajectory(), j.get_trajectory())
    assert d_m < ACROSS[0] and d_deg < ACROSS[1], (d_m, d_deg)


class _Evil:
    def __reduce__(self):
        return (print, ("unpickled",))


@pytest.mark.parametrize("field,payload", [
    ("prev_frame", _Evil()),
    ("prev_frame", {"a": __import__("collections").OrderedDict()}),
    ("rng", _Evil()),
])
def test_foreign_classes_refused(tmp_path, field, payload):
    _, to = options_pair()
    odo = TOdometry(to, device="cpu")
    tck.save_checkpoint(odo, tmp_path / "s")
    meta = tmp_path / "s.meta.json"
    side = json.loads(meta.read_text())
    side[field] = pickle.dumps(payload).hex()
    meta.write_text(json.dumps(side))
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        tck.load_checkpoint(TOdometry(to, device="cpu"), tmp_path / "s")
