"""The JAX package's online node on chip_smoke.py's "rosbag + online node"
phase, on the CPU: the number that chip_smoke.py holds the port's node to.

The driving corridor's first 40 frames (seed 3, the 80-frame drive of
chip_smoke.py's driving phase) are written as a rosbag 2.0 file by the
port's writer (``ct_icp_torch/tools/bag_writer.py``, stamps offset by
1.6e9 s), converted by ct_icp_tpu's ``bag_to_ply``, read back as a
PLY_DIRECTORY dataset and fed to ct_icp_tpu's
``OnlineOdometry(default_driving_profile(), expected_frame_period 0.1)``
with an ``EvaluationNode`` against the corridor's poses (each frame's end
pose in the frame of the first frame's begin pose, as
``corridor.seq_ape``): its mean APE is ONLINE_REF_APE_M (the port's node
is held within 1.5 times it and under 0.07 m).

    PYTHONPATH=. python tests/torch_online_reference.py

Measured (CPU, this script): 40 frames registered, 0 failures, 0
dropped, mean APE 0.028222758119049608 m (max 0.049291004037116205 m),
~1.6 min. The files go under ``build/online_reference/``. Prints one JSON line. Not
collected by pytest.
"""

import json
import os
import shutil
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("CT_FORCE_CPU", "1")

from ct_icp_torch.datasets import corridor as cor  # noqa: E402
from ct_icp_torch.tools import bag_writer  # noqa: E402

OUT = Path("build") / "online_reference"
CORRIDOR_FRAMES = 80          # the driving phase's drive
ONLINE_FRAMES = 40
CORRIDOR_SEED = 3
BAG_T0 = 1.6e9


def main():
    from ct_icp_tpu.config.options import default_driving_profile
    from ct_icp_tpu.convert import bag_to_ply
    from ct_icp_tpu.datasets.dataset import (Dataset, DatasetEnum,
                                             DatasetOptions)
    from ct_icp_tpu.online import (EvaluationNode, OnlineOdometry,
                                   OnlineOdometryConfig)
    shutil.rmtree(OUT, ignore_errors=True)
    scene = cor.build_scene()
    traj = cor.straight_trajectory(400, CORRIDOR_FRAMES * 0.1 + 0.5)
    frames = cor.render_corridor(scene, traj, ONLINE_FRAMES, CORRIDOR_SEED)
    bag = bag_writer.write_frames_bag(OUT / "corridor.bag", frames, BAG_T0)
    n = bag_to_ply(bag, OUT / "ply")
    seq = Dataset.load_dataset(DatasetOptions(
        dataset=DatasetEnum.PLY_DIRECTORY,
        root_path=str(OUT / "ply"))).sequences[0]
    first = frames[0]["begin_pose"]
    gt = [(first.inverse() * f["end_pose"]).matrix() for f in frames]
    node = OnlineOdometry(OnlineOdometryConfig(
        odometry_options=default_driving_profile(),
        expected_frame_period=0.1))
    evaluation = EvaluationNode(gt, period_sec=1e9)
    node.pose_output.subscribe(evaluation.on_pose)
    events = []
    node.monitor_output.subscribe(events.append)
    t0 = time.time()
    summaries = []
    while seq.has_next():
        fr = seq.next_frame()
        summaries.append(node.on_pointcloud(fr["xyz"], fr["timestamps"]))
    m = evaluation.compute_metrics()
    print(json.dumps({"online": dict(
        frames=n, registered=sum(s is not None for s in summaries),
        failures=sum(s is not None and not s.success for s in summaries),
        dropped=sum(e.get("event") == "frame_dropped" for e in events),
        mean_ape_m=m.mean_ape, max_ape_m=m.max_ape,
        seconds=time.time() - t0)}), flush=True)
    shutil.rmtree(OUT / "ply")        # ~100 MB of PLY frames
    return 0


if __name__ == "__main__":
    sys.exit(main())
