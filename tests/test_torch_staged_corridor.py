"""The staged ADAPTIVE robust run of chip_smoke.py (the driving corridor,
seed 3, ``default_driving_profile()`` with ADAPTIVE keypoints and the
robust regimen) in ct_icp_torch (CPU, plain kernel versions) against
ct_icp_tpu, over its first two frames: the frames before the two
packages' float32 rounding parts them.

Frame by frame (``ct_icp_torch/tools/staged_record.py``) the sub-frame
(K4) and the elected keypoints (K13's plain version against the
reference's lexsort) are equal bit for bit, and so are frame 1's attempt,
robust level, ICP iterations, assessment and insert decision; frame 0's
map (every level's keys and points) is equal bit for bit. Frame 1's end pose is within POSE_BOUND_M and
POSE_BOUND_DEG of the reference's: its registration holds only ~75
residuals (of 3,536 keypoints, the others with fewer than 20 neighbours
in frame 0's map), with the corridor's along-track direction barely
observed, so its LM steps amplify float32 summation-order differences
(4.4e-5 m between the packages on the CPU, 4.2e-5 m between the port on
the card and on the CPU; PERF.md §7). At frame 2 an LM step's accept
test decides on a cost decrease of 5 float32 ulps, and the packages part
by 8-15 mm, as the reference's own fused program and its staged loop
pieces do on the same inputs (14.5 mm); from then on the robust
regimen's escalations follow the relative distance across its 1.0 m
threshold, which the corridor's cruise (10 m/s, 0.1 s frames) sits on.
``tests/torch_staged_reference.py`` records all 80 frames
(``--per-frame``, with the reference's own spread under one-ulp nudges)
and dumps a frame's solver (``--solver-dump``).
"""

import numpy as np
import pytest
import torch

from ct_icp_torch.odometry import odometry as todo
from ct_icp_torch.tools import staged_record as rec
from ct_icp_tpu.odometry import odometry as jodo
from torch_staged_reference import run_options

FRAMES = 2
POSE_BOUND_M = 2e-4
POSE_BOUND_DEG = 2e-3


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _angle_deg(q1, q2):
    d = abs(float(np.dot(q1, q2)) / (np.linalg.norm(q1) * np.linalg.norm(q2)))
    return float(np.degrees(2 * np.arccos(min(d, 1.0))))


def test_staged_robust_corridor_first_frames_match_reference():
    frames = rec.corridor_frames(FRAMES)
    jodo_ = jodo.Odometry(run_options("adaptive_robust"))
    todo_ = todo.Odometry(rec.run_options("adaptive_robust"), device="cpu")
    want = rec.record(jodo_, jodo, frames[:1])
    got = rec.record(todo_, todo, frames[:1])
    # frame 0's map, every level, bit for bit
    assert len(jodo_.map_state.levels) == len(todo_.map_state)
    for jl, tl in zip(jodo_.map_state.levels, todo_.map_state):
        np.testing.assert_array_equal(tl.keys.numpy(),
                                      np.asarray(jl.keys).view(np.int32))
        np.testing.assert_array_equal(tl.points.numpy(),
                                      np.asarray(jl.points))
    want += rec.record(jodo_, jodo, frames[1:], first=1)
    got += rec.record(todo_, todo, frames[1:], first=1)
    assert rec.first_divergence(want, got, pose_tol_m=POSE_BOUND_M) is None
    for a, b in zip(want, got):
        assert (a["sub_count"], a["sub_digest"]) == (b["sub_count"],
                                                     b["sub_digest"])
        assert [(x["keypoints"], x["kp_digest"]) for x in a["attempts"]] \
            == [(x["keypoints"], x["kp_digest"]) for x in b["attempts"]]
        assert rec._decisions(a) == rec._decisions(b)
        assert (a["number_of_attempts"], a["inserted"]) \
            == (b["number_of_attempts"], b["inserted"])
        for i in (0, 3):             # begin and end: quaternion, then tr
            pa, pb = np.array(a[("begin", "end")[i // 3]]), \
                np.array(b[("begin", "end")[i // 3]])
            assert np.linalg.norm(pa[4:] - pb[4:]) <= POSE_BOUND_M
            assert _angle_deg(pa[:4], pb[:4]) <= POSE_BOUND_DEG
    assert want[0]["map_size"] == got[0]["map_size"]
    # frame 1 is registered (one attempt at level 0, inserted) and moved
    assert [len(f["attempts"]) for f in got] == [0, 1]
    assert got[1]["inserted"] and got[1]["attempts"][0]["keypoints"] > 3000
    assert np.linalg.norm(np.array(got[1]["end"][4:])) > 0.05
