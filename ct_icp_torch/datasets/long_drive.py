"""The 500-frame synthetic urban drive (``configs/synthetic_long_drive.yaml``)
streamed end to end, as ``bench.py --long`` runs it in the reference.

The scene is a 5 x 3 grid of city blocks, the route ~380 m with two
90-degree corners and a slow-traffic section, 100,000 points a frame. The
drive is graded by KITTI segment RPE (%Tr, segments of 100-800 m): the gate
is a 3-seed mean <= 0.50 %Tr over seeds 7, 8 and 9 (the reference's
``LONG_TR_BOUND_PCT``, ``LONG_SEEDS``). The reference's frames/s floor is a
TPU figure and is not carried over.

It streams through ``streaming.stream_acquisition`` (KITTI segment
lengths).
"""

from __future__ import annotations

from pathlib import Path

from ct_icp_torch.config.yaml_config import synthetic_sequence_from_yaml

LONG_TR_BOUND_PCT = 0.50
LONG_SEEDS = (7, 8, 9)
LONG_CONFIG = "configs/synthetic_long_drive.yaml"
LONG_FRAMES = 500
LONG_BATCH = 16


def config_path() -> Path:
    return Path(__file__).resolve().parents[2] / LONG_CONFIG


def load_acquisition(seed: int):
    """The long drive's acquisition with scan-realization ``seed``."""
    return synthetic_sequence_from_yaml(str(config_path()), seed=seed)
