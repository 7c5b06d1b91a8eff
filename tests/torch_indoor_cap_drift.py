"""How far the port's indoor stream parts from ct_icp_tpu's, frame by
frame, at a given sub-sample cap: the eight frames and options of
``test_torch_indoor_stream.py`` (CPU, plain kernel versions), with
``max_subsampled_points`` set to CAP (8,192 cuts frames 0 and 3; the
test's 16,384 cuts nothing).

    PYTHONPATH=. python tests/torch_indoor_cap_drift.py [CAP]

Prints, per frame, whether both packages prepared the same scan (every
array of the prepared frame bit for bit), both outcomes (attempts, robust
level, points added, points inserted) and the end poses' distance in m and
degrees.
"""

import dataclasses
import sys

import numpy as np
import torch

from ct_icp_torch.convert import options_from_dict
from ct_icp_torch.odometry.odometry import Odometry as TOdometry
from ct_icp_tpu.odometry.odometry import Odometry as JOdometry
from test_torch_indoor import indoor_frames, indoor_options


def main(cap: int) -> None:
    torch.set_num_threads(4)
    jo = dataclasses.replace(indoor_options(), max_subsampled_points=cap)
    jodo = JOdometry(jo)
    todo = TOdometry(options_from_dict(dataclasses.asdict(jo)), device="cpu")
    frames = indoor_frames(8)
    jp = [jodo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i,
                             upload=False) for i, f in enumerate(frames)]
    tp = [todo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i)
          for i, f in enumerate(frames)]
    js = list(jodo.stream_frames(iter(jp), batch=4))
    ts = list(todo.stream_frames(iter(tp), batch=4))
    for i, (a, b, s, t, pa, pb) in enumerate(zip(
            jp, tp, js, ts, jodo.get_trajectory(), todo.get_trajectory())):
        same = all(np.array_equal(a[k], b[k]) for k in
                   ("xyz", "timestamps", "alphas", "scan_host")) and \
            (a["n"], a["kp_n"]) == (b["n"], b["kp_n"])

        def outcome(x):
            return (x.number_of_attempts, x.robust_level, x.points_added,
                    x.logged_values.get("map_inserted_points"))

        print(f"frame {i}: n={b['n']} cut={b['n'] == cap} same scan={same} "
              f"ref {outcome(s)} port {outcome(t)} "
              f"d={pa.end_pose.location_distance(pb.end_pose):.5f} m "
              f"{pa.end_pose.angular_distance(pb.end_pose):.5f} deg")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8192)
