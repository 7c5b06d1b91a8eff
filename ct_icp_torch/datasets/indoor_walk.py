"""The handheld indoor walk (``configs/synthetic_indoor_walk.yaml``), as
``bench.py --indoor`` runs it in the reference: its acquisition and its
gate. It streams through ``streaming.stream_acquisition`` with
``driving=False`` (the INDOOR segment lengths).

Six rooms off a central corridor; the carrier walks at 0.8 m/s through
three of them with doorway turns capped at 50 deg/s (5 deg a frame),
2.5-degree handheld sway and a vertical bob, 60,000 points a frame. The
profile is ``default_robust_outdoor_low_inertia()`` (three map levels, its
2-degree robust thresholds escalate on every turn), batch 4. The walk is
graded by segment RPE over the INDOOR segment lengths (10-80 m): the gate
is a 3-seed mean <= 1.3 %Tr with a mean APE <= 0.10 m and no failure
(the reference's ``INDOOR_TR_BOUND_PCT``, ``INDOOR_APE_BOUND_M``,
``INDOOR_SEEDS``, ``bench.py:132-136``). The reference's frames/s floor is a
TPU figure and is not carried over.
"""

from __future__ import annotations

from pathlib import Path

from ct_icp_torch.config.yaml_config import synthetic_sequence_from_yaml

INDOOR_TR_BOUND_PCT = 1.3
INDOOR_APE_BOUND_M = 0.10
INDOOR_SEEDS = (7, 8, 9)
INDOOR_CONFIG = "configs/synthetic_indoor_walk.yaml"
INDOOR_FRAMES = 240
INDOOR_BATCH = 4


def config_path() -> Path:
    return Path(__file__).resolve().parents[2] / INDOOR_CONFIG


def load_acquisition(seed: int):
    """The indoor walk's acquisition with scan-realization ``seed``."""
    return synthetic_sequence_from_yaml(str(config_path()), seed=seed)

