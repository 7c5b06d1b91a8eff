#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ct_icp_torch) on one NVIDIA GPU.

Run from the repository root on a machine with the card:

    python3 chip_smoke.py

It needs one CUDA device and nvcc, and exits non-zero without a result line
when either is missing. Phases; any failure raises and exits non-zero:

  1. the card: nvidia-smi's name and power limit, torch's device name;
  2. build the CUDA kernels K1-K13 from ct_icp_torch/csrc with nvcc (one
     process per source, all started together); print the build time and
     ptxas's register / shared-memory / spill lines (and keep each entry's
     registers and spills for the kernels line);
  3. each kernel against its plain PyTorch version on the card
     (tolerances: ct_icp_torch/kernels/checks.py), then the kernel's and
     the plain version's time by CUDA events: at the driving profile's
     shapes (K1-K3, K5), and at the robust profile's (K1 with its
     48-of-125 voxel compaction, K2 fresh and with a cached radius, each
     with the work its bound counts: K1's distinct key windows probed and
     slots found, K2's distinct live map points and rows read, K3 at
     P = 40 and C = 2^19, K4 on a robust corridor frame's sub-sample at
     1.0 m with a 2^22 table and in the Pallas configuration: three calls
     in a row on its persistent table, then its device time with the L2
     flushed, back to back, and with its host side). K5 is held
     on the first LM call of real frames as the per-frame path gives it
     (frames before it registered, the call starting from the frame's
     motion-model initial pose): a driving and a robust startup frame and,
     in phase 6, a frame of the escalation scene's yaw jolt, whose rotation
     between begin and end takes quat_slerp's slerp branch. K5 is one
     launch per LM call: its times are the device time of the call and of a
     call of one step (each a CUDA graph of one launch), the steps the call
     ran and the time a step, and the call with its host path. K3 is one
     launch per insert: its device time (the profiler's kernel duration of
     one insert on a copy of the level; the graph of one insert between
     events, which holds the graph's submission, beside it) and its time
     with the host enqueue. torch.profiler's trace of one call of each, at
     the driving shapes, must show one device operation for K5 and K4, at
     most two for K3 and two (K7 and K6) for a rebuild_level of the driving
     map (where one of ten traces sees the device at all). Every profiler
     trace (K3, K9 and K10 times, the device operations) is taken in a
     process whose first trace is recent, on this process's tensors
     (tools/timing.py::fresh_process_traces): on some of the card's
     machines a process's traces hold no device activity from about 10 s
     after its first trace on. The stages
     that stay plain torch (ROADMAP B9-B11) are timed the same way, each
     with its bound;
  4. the driving path: Odometry(default_driving_profile(), device="cuda")
     over the 80-frame synthetic corridor, seed 3, stream_frames(batch=16):
     median per-batch frames/s, failures, mean APE (against the 0.07 m gate
     of the 3-seed benchmark; asserted <= 0.10 m on this seed), map points,
     host syncs per frame beside ICP iterations per frame;
  5. the robust path: Odometry(robust_driving_profile(), device="cuda")
     over bench.py's robust corridor (80 frames, 8 m/s, seed 3),
     stream_frames(batch=8) of frames prepared beforehand: median per-batch
     frames/s, failures (asserted 0), mean attempts, mean APE (asserted <=
     0.10 m; the 3-seed gate is 0.058 m), map points, the speculative
     commits, prefix commits and rollbacks;
  6. the escalation path: bench.py's run_escalation scene (48 frames, a
     yaw jolt over frames 18-24, a speed surge over 40-48,
     robust_num_attempts=3, batch 8), asserting the gate's own conditions
     and that K4 ran;
  7. the long drive: the 500 frames of configs/synthetic_long_drive.yaml
     (seed 7, 100,000 points a frame, read by the port's own YAML reader),
     rendered beforehand on a thread pool, prepared in a PrefetchIterator
     (3 workers, depth 32) and streamed through
     Odometry(default_driving_profile()).stream_frames(batch=16) with the
     rebase distance cut from 500 m to 100 m so that the map rebase (K7
     rebuild_claim + K6 row_gather) runs inside the drive: 0 failures, at
     least 2 rebases, segment RPE <= 0.50 %Tr on this seed, and K7 and K6
     launched once each per rebase and level (K6 moves the points, normals,
     counts and flags in one launch); median per-batch frames/s, %Tr, APE,
     map points, host syncs a frame, render and stream wall times (the
     stream's includes the copy of the first rebase's level that phase 11 is
     held on, and its host time);
  8. the backend gate (tools/bench.py --backend): the long drive's first
     320 frames (rendered in phase 7) through
     Odometry(default_driving_profile() with backend.enabled)
     .stream_frames(batch=16), the rebase at 500 m as in the gate: 0
     failures, at least one refinement, segment RPE <= 0.42 %Tr, K1-K3, K5
     and K8 launched, one K8 launch a refine (its two CT-BA steps of two
     block-Jacobi inner iterations run as one launch of four), no
     synchronizing CUDA call inside a
     refine's dispatch (torch's sync debug mode set to raise there; the
     deferred apply's event wait, one a refine, is outside it and counted
     beside the host syncs); then the same frames with the backend
     off, in this process: frames/s, host syncs a frame and %Tr of both,
     the refinements, the refine's host ms and its event waits; then the
     two halves of the first refine over a full window (8 keyframes) on
     its own inputs, the association (K1, K2 and the weighting) and the
     CT-BA work (one K8 launch), each on the device (a CUDA graph) and
     with its host side;
  9. K8 (the backend's launch of four block-Jacobi inner iterations, one
     iteration, a step of two, and the point + prior blocks of the coupled
     solver), K1 over all 27 voxels without compaction and K2 without the
     k-NN cap against their plain versions at that refine's shapes (8
     keyframes x 4,096 keypoints, the padded rows invalid), timed as in
     phase 3 (K8: a CUDA graph of 20 calls, and with its host side), K8
     launched twice to show it repeats bit for bit, the last of its
     several iterations' J^T r against the plain version in float64 from
     its own iterate before it, its launch of four
     iterations against four launches of one (identical), and the clock
     cycles of each of its phases (the -DK8_MARKS variant, built in
     phase 2); then the window beyond the card's residency: the largest
     window whose multi-iteration K8 launch fits at K = 4,096 and K = 64
     (the occupancy API), whether the reference test's F = 16 fits, and
     make_ct_ba_step's jacobi step of 2 inner iterations over one frame
     more than fits at K = 4,096 (counts set to 0 just before it, read
     just after: two chained K8 launches), against the CPU run of the same
     inputs (its first launch held by the K8 check, its second's J^T J
     against the plain version from the first iterate), timed; K8 with 2
     iterations in one launch at F = 300 raises before launching;
  10. the robust corridor of phase 5 again with a rebase distance of 20 m:
     the speculative streamer's deferred rebases ("rebase" statuses) run;
     0 failures, APE <= 0.10 m, at least 2 rebases, and the largest end-pose
     difference from phase 5's run;
  11. K6 and K7 against their plain versions: K7 (its table, its writers,
     num_points and the claim rounds it ran), K6's one launch over the
     points, normals, counts and flags and the whole rebuild_level (one K7
     and one K6 launch) bit-identical to the plain ones on the long drive's
     map (2^18 slots x 90 floats) and the robust run's (2^19 x 120), each
     as it stood at its first rebase, with that rebase's shift, timed with
     the L2 flushed, the points alone beside them; K6 on one table at the
     Pallas dma_gather_kernel's shapes (2^18 x 128 float32, N = 16,384 and
     110,592 random and sorted slots) beside index_select;
  12. the indoor walk: the 240 frames of configs/synthetic_indoor_walk.yaml
     (seed 7, 60,000 points a frame, rendered beforehand) through
     Odometry(default_robust_outdoor_low_inertia()).stream_frames(batch=4),
     the port's three-level map (0.2 m x 50 points at 2^20 slots, 0.5 m x
     40 at 2^19, 1.5 m x 40 at 2^17; searched on level 1, inserted into
     all three), escalating on the doorway turns: 0 failures, mean APE <=
     0.10 m, K1-K5 launched, K3 three times (once a level) for each insert
     and at least three times a frame; %Tr (INDOOR segments), frames/s,
     attempts and host syncs a frame, the device memory peak, then on the
     walk's map the checkpoint's clone of the three levels
     (pipeline.snapshot, once a speculative batch) and prune_level on each
     level, timed;
  13. K1-K5 against their plain versions at the indoor walk's shapes, and
     timed as in phase 3: K5 on the first LM call of walk frame 10 (600
     residuals at most, 10 LM steps, WeightingScheme.ALL); K1 and K2 on
     the searched level of the map frames 0-10 built, with frame 11's
     keypoints as queries; K3 inserting frame 11 into each of the three
     levels (P = 50 at 2^20 with min distance 0.03, P = 40 at 2^19 with
     0.1, P = 40 at 2^17 with 0.15); K4 on the walk's first escalated
     election as phase 12 met it (its sub-sample, voxel and capacity);
  14. the backend with replay (tools/bench.py --replay): the reference's
     replay test (tests/test_ct_ba.py:182-224) at the default profile's
     capacities (the three-level map at 2^20 / 2^19 / 2^17 slots, 2^17 scan
     points, 4,096 keypoints), the room (datasets/room.py, seed 47, 5 mm
     noise), 15 frames of 6,000 points through register_frame, backend off
     then on (window 6, period 3, 2 steps, replay): APE on < 0.8 x off, >= 2
     refinements, 0 failures, K9 launched once a replay (every level in one
     launch); then the same room at 60,000 points a frame for 60 frames, off
     then on: 0 failures, >= 2 refinements, APE on and off, the replays, the
     points each evicted and re-inserted and their host ms, and the device ms
     of the first replay's device half (a CUDA graph of its K9 and K3 launches
     on a restored copy of the map);
  15. the map export of that room's map: get_map_points on each level
     (one K10 launch each, over the level's occupied slots; finite points,
     as many as the level holds);
  16. K9 on the first replay's evict lists, every level in one launch (the
     replay's call) and each level alone, and K10 on each level's occupied
     slots of the room's map (the export's slot list), against their plain
     versions (K9 identical; K10's flags and refit slots identical, its
     normals within the tolerance of kernels/checks.py) and timed: K9 by
     the profiler's kernel duration of one eviction on a restored copy, a
     CUDA graph of 20 evictions of an already evicted copy, and an empty
     kernel of the same grid both ways (the floor of each method; the graph
     of one eviction between events, which holds the graph's submission,
     is kept beside them); K10 the same way (a call on a list, the lanes a
     queued slot its grid takes, kernels/level_normals.py::lanes) on the
     three levels and level 1's all-refit list; both also with their host
     side;
  17. K1 and K2 built from this tree give, on tools/exp_header_trees.py's
     inputs, the outputs the parent tree's build gave before their device
     code moved into csrc/probe.cuh and csrc/eigh3.cuh (SHA-256 digests);
  18. the robust corridor (80 frames, batch 8) and the escalation scene (48
     frames, 3 attempts, batch 8) through robust_driving_profile() with the
     CT-BA backend on: 0 failures, APE <= 0.10 m, >= 1 refinement, one
     callback for each committed frame in order; K4 launched in the
     escalation scene; the corridor once more with the backend off, timed
     the same way (frames prepared by prefetch workers in the timed loop),
     for the pair's frames/s;
  19. scale-out (parallel/distributed_odometry.py), (a): DistributedOdometry
     (default_driving_profile()) in a world-size-1 NCCL group on the
     driving phase's 80 frames, broadcast then partitioned insert (after a
     two-frame warm-up): frames/s, host syncs a frame, APE (within 1.5
     times the JAX package's on the same frames on the CPU), map points,
     0 dropped, K1-K5, K10 and (partitioned) K11 launched; both modes store
     the same points; the first 3 frames within 0.01 m and 0.5 deg of the
     port's CPU run (the plain versions);
  20. (b): two ranks sharing the card over gloo (parallel/comm.py::spawn):
     the first 10 frames in both modes, each end pose within 0.02 m and
     0.2 deg of (a)'s, or, on a frame where the reference's own 2-device
     mesh leaves its 1-device mesh by more (frames 1 and 2), within twice
     that gap (REF_2_DEVICE_GAPS, shard_bounds), the first frame's map (the
     union of the shards) the same points as (a)'s, partitioned the same
     points as broadcast, K11 launched on each rank; the CT-BA step at F =
     16 (8 frames a rank, K = 4,096), block-Jacobi (2 inner iterations, a
     K8 halo launch each) and PCG, against the one-device step on the card
     (tolerances at CT_BA_MESH_TOL; bit for bit where the slices and the
     window take one cluster size);
  21. (c): K11 at the shapes of (a)'s partitioned insert (frame 1's; and at
     two ranks'), bit for bit, one device operation a call, beside
     torch.sort of the chunk's owners (its library yardstick); K3's rank-0
     slots and the refit of the dirty list (K10's tolerance); K8's halo
     launch on rank 1's slice of (b)'s window, its J^T r within 10 times
     the float32 plain version's gap to the float64 one; each timed;
  22. the exact k-NN search: Odometry(default_driving_profile() with
     ball_neighborhood=False).stream_frames(batch=16) over the driving
     phase's 80 frames: frames/s and host syncs a frame beside the driving
     phase's, APE within 1.5 times the JAX package's on the same frames on
     the CPU (SEARCH_REF_APE_M, tests/torch_search_reference.py), 0
     failures; K1, K12, K3 and K5 launched, one K12 a K1, K2 and K4 not;
     then its first 10 frames with num_closest_neighbors=2 (held the same
     way): the residual rows a frame beside the keypoints, and K5 given
     two rows for each keypoint K12 searched;
  23. the distance strategy at the reference's defaults
     (DistanceBasedStrategyOptions(): 0.1-2.0 m, nv = 3, 343 voxels kept
     to 48): the same figures; K1 with the normal filter, K2 with a
     radius a keypoint, K10 on the inserts' dirty lists (one host sync a
     level a frame more), K12 not;
  24. the device sub-sample (host_subsample=False): the same figures; K4
     twice a frame (the raw scan at its rung, then the keypoints);
  25. K12, K1 with the filter, K2 with a radius a query and K4 at the
     scan's rung against their plain versions on the inputs of their first
     calls in 22-24 (K12 and K1 identical, K2 within kernels/checks.py's
     tolerance, K4 identical), timed as in phase 3; K12's device
     operations a call (one);
  26. the staged per-frame path: Odometry(default_driving_profile()
     with sampling=ADAPTIVE).register_frame frame by frame over the driving
     phase's 80 frames (the host side of each frame inside the timed span):
     frames/s, host syncs, ICP iterations and keypoints a frame, APE
     within 1.5 times the JAX package's on the same frames on the CPU
     (STAGED_REF_APE_M, tests/torch_staged_reference.py), 0 failures; K4
     once a frame on the raw scan, K13 once a frame after frame 0;
  27. the same on the robust regimen (80 frames; K13 once an attempt), and
     the random keypoint cap (max_num_keypoints=1000, GRID keypoints; 80
     frames; K4 twice a frame after frame 0, no K13);
  28. NONE keypoints and ADAPTIVE with 2 points a voxel and the 3,000-point
     cap, the first 10 frames each (both part from the corridor after
     about 10 frames, in the reference too);
  29. K13 against its plain version on the inputs of its first calls in 26
     and 28 (identical), one device operation a call, timed as K4 is in
     phase 3; and CTICPRegistration.register of one frame (26's last
     keypoints from its initial pose) with its host side;
  in 4-8, 10, 12, 14, 15, 18-20, 22-24 and 26-28 every kernel count and
  K5's device count of LM steps are set to 0 just before the path and read
  just after it (in 20, in each rank's process); each
  path must launch its kernels (4-8, 10, 12 and 22-24: K5 and the
  others), and the paths of 4-8, 10, 12 and 22-24 make fewer host syncs a
  frame than LM steps (one per ICP iteration and readback where no batch
  rolled back, and in 23 one a level for each insert); the driving path
  one K5 launch per ICP iteration;
  30. one JSON line of the kernels (K1-K5 with an "indoor" record, K3
     with "indoor level 1" and "indoor level 2" as well, K1 and K2 with a
     "backend" record, K8 with its "blocks" mode beside its "gn" one, K9
     and K10 on level 0 with "level 1" and "level 2" records, K3's
     rank-0 slots and K8's halo launch, K11 with a "2 ranks" record, K1
     with the normal filter, K2 with a radius a query, K4 at the scan's
     rung, K12, K13 with its "k=2, max_keep" record), the card's line, and
     the result line.
"""

import dataclasses
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ct_icp_torch import convert
from ct_icp_torch.config.options import (AdaptiveGridSamplingOptions,
                                         DistanceBasedStrategyOptions,
                                         SamplingOption,
                                         default_driving_profile,
                                         default_robust_outdoor_low_inertia,
                                         robust_driving_profile)
from ct_icp_torch.core import se3_np as s3n
from ct_icp_torch.datasets import corridor as cor
from ct_icp_torch.datasets import indoor_walk as iw
from ct_icp_torch.datasets import long_drive as ld
from ct_icp_torch.datasets import room
from ct_icp_torch.datasets.streaming import (CachedAcquisition,
                                             stream_acquisition)
from ct_icp_torch.kernels import build
from ct_icp_torch.kernels import candidate_gather as k1
from ct_icp_torch.kernels import checks
from ct_icp_torch.kernels import ct_ba_block as k8
from ct_icp_torch.kernels import evict_voxels as k9
from ct_icp_torch.kernels import exact_sample as k13
from ct_icp_torch.kernels import grid_sample as k4
from ct_icp_torch.kernels import knn_search as k12
from ct_icp_torch.kernels import level_normals as k10
from ct_icp_torch.kernels import lm_step as k5
from ct_icp_torch.kernels import map_insert as k3
from ct_icp_torch.kernels import owner_pack as k11
from ct_icp_torch.kernels import plane_moments as k2
from ct_icp_torch.kernels import rebuild as k7
from ct_icp_torch.kernels import row_gather as k6
from ct_icp_torch.mapping import voxel_map as vm
from ct_icp_torch.odometry import pipeline as pl
from ct_icp_torch.odometry.odometry import PRUNE_PERIOD, Odometry
from ct_icp_torch.ops import sampling as smp
from ct_icp_torch.ops import voxel as vx
from ct_icp_torch.parallel import ct_ba
from ct_icp_torch.tools import bench as gates
from ct_icp_torch.tools import exp_header_trees as eht
from ct_icp_torch.tools import scale_out
from ct_icp_torch.tools.exp_gather import k6_bytes, k6_fields_bytes
from ct_icp_torch.tools.exp_moments import k2_bytes, live_work
from ct_icp_torch.tools.timing import (HBM_BYTES_PER_S, bound,
                                       copy_into, end_fresh_process,
                                       fresh_process_traces, time_cold,
                                       time_graph, time_host,
                                       time_stateless)

NUM_FRAMES = 80
SEED = cor.APE_SEEDS[0]
BATCH = 16
ROBUST_BATCH = 8
ESC_FRAMES = 48
APE_SMOKE_BOUND_M = 0.10
K1_QUERIES = 1536
# the long drive: the timed seed of the 3-seed gate, its frames and batch,
# and a rebase distance that its ~240 m reach from the start crosses
LONG_SEED = ld.LONG_SEEDS[0]
LONG_REBASE_DISTANCE = 100.0
ROBUST_REBASE_DISTANCE = 20.0
# the indoor walk: the timed seed of its 3-seed gate
INDOOR_SEED = iw.INDOOR_SEEDS[0]
# the Pallas dma_gather_kernel's configuration (tools/exp_gather.py:141-143)
GATHER_C = 1 << 18
GATHER_W = 128
GATHER_NS = (16384, 110592)

# the frames whose first LM call K5 is held to: a driving and a robust
# startup frame, and a frame inside the escalation scene's yaw jolt (its
# begin and end poses apart: quat_slerp's slerp branch)
K5_DRIVING_FRAME = 10
K5_ROBUST_FRAME = 10
K5_JOLT_FRAME = cor.ESC_BURST[0] + 2
# the room of the replay gate at a real density: 60,000 points a frame, 60
# frames (datasets/room.py; the gate itself: 6,000 and 15)
ROOM_POINTS = 60000
ROOM_FRAMES = 60
# K1's and K2's outputs on tools/exp_header_trees.py's inputs as the parent
# tree's build (b3f8a7c, before their device code moved into
# csrc/probe.cuh and csrc/eigh3.cuh) gave them on an H100 80GB HBM3
DIGESTS_BEFORE_MOVE = {
    "k1 27": "29122a929326a66a9b842bb2a4c432a97e86f234fe79d3baeb15e25081d514d2",
    "k1 10 of 125":
        "7beb558d4c68073515454fa3e4a7b798ae87fb63366cc797908e02c4054e2257",
    "k2 fresh":
        "08443cb06c613ad3070b697818be036664d24c7ba1a3a3a103d527f88ffe745f",
    "k2 cached":
        "08443cb06c613ad3070b697818be036664d24c7ba1a3a3a103d527f88ffe745f",
    "k2 full":
        "aab09d10cae8cf47c4581cf319f952de55880ba7c4457168ec1edc562afdf288",
}
# the measurement variant of K8 whose clock marks phase 9 reads
K8_MARKS = ("K8_MARKS",)
# the indoor walk's frame whose first LM call K5 is held to; frames
# [0, K) build the three-level map K1-K3 are held on, frame K + 1 gives
# them their queries and inserted points
K5_INDOOR_FRAME = 10
# the scale-out phases: DistributedOdometry on the driving phase's frames
# in both insert modes; the JAX package's DistributedOdometry on the same
# 80 frames on the CPU (a 1-device mesh, tests/torch_scale_out_reference.py)
# reaches a mean APE of 0.10286 m in both modes, and the port's is held
# within 1.5 times that
SCALE_OUT_MODES = ("broadcast", "partitioned")
SCALE_OUT_STORE = Path(__file__).resolve().parent / "build" / "scale_out"
SCALE_OUT_REF_APE_M = 0.10286
SCALE_OUT_APE_BOUND_M = 1.5 * SCALE_OUT_REF_APE_M
# the first frames on the card against the port's CPU run (the plain
# versions: another summation order in K2 and the solver), within about
# three times what the first full run read (0.00283 m, 0.168 deg)
SCALE_OUT_CPU_FRAMES = 3
SCALE_OUT_CPU_TOL_M, SCALE_OUT_CPU_TOL_DEG = 0.01, 0.5
# two ranks against world size 1, frame by frame: the reference's own
# shard-invariance bounds (tests/test_distributed_odometry.py:79-80, on
# its own scene), except on a frame where the reference itself leaves
# them between its 2-device and its 1-device mesh on these frames (the
# same program summing its moments in another order); there twice the
# reference's own gap. Its gaps (m, deg), frame by frame, from
# tests/torch_scale_out_reference.py --modes "" --meshes 2,4 on the CPU:
# frames 1 and 2, startup frames, leave the bounds (1.519 and 0.296 deg)
RANK_FRAMES = 10
SHARD_TOL_M, SHARD_TOL_DEG = 0.02, 0.2
REF_2_DEVICE_GAPS = (
    (0.0, 0.0), (0.020904, 1.5194), (0.015096, 0.29553), (0.010752, 0.14568),
    (0.016087, 0.18165), (0.011689, 0.11367), (0.014859, 0.10165),
    (0.011695, 0.14730), (0.0062544, 0.10363), (0.014927, 0.10023))


def shard_bounds(frame):
    """The (m, deg) bound of frame ``frame``'s end pose, two ranks against
    one."""
    return tuple(tol if gap <= tol else 2 * gap for gap, tol in
                 zip(REF_2_DEVICE_GAPS[frame], (SHARD_TOL_M, SHARD_TOL_DEG)))


# the 2-rank CT-BA window (the reference test's F = 16, the backend's
# K = 4,096) and its steps; held to the one-device step: block-Jacobi
# within K8's check (1e-5 m, 1e-4 deg) and the cost within 1e-5 relative
# (bit for bit where the slices and the window take one cluster size), PCG
# within 1e-4 m, 1e-3 deg and 1e-4 (its dot products summed over the
# ranks, and K8's blocks at another cluster size)
CT_BA_MESH_F = 16
CT_BA_MESH_CONFIGS = [dict(num_inner_iters=2, solver="jacobi"),
                      dict(num_inner_iters=1, solver="pcg", num_cg_iters=8)]
CT_BA_MESH_TOL = {"jacobi": (1e-5, 1e-4, 1e-5), "pcg": (1e-4, 1e-3, 1e-4)}
# the search runs: the JAX package's Odometry on the driving phase's frames
# (seed 3, batch 16) on the CPU reaches these mean APEs (m) with 0
# failures (PYTHONPATH=. python tests/torch_search_reference.py); each port
# run is held within SEARCH_APE_FACTOR times its run's, with 0 failures
SEARCH_REF_APE_M = {"knn": 0.051491458347106965,
                    "knn_kc2": 0.026497539515010098,
                    "distance": 0.05295844087452732,
                    "devsub": 0.10121936668283638}
SEARCH_APE_FACTOR = 1.5
KC2_FRAMES = 10
# the staged per-frame path (a keypoint sampler other than GRID, the random
# keypoint cap): the JAX package's Odometry.register_frame on the driving
# phase's frames (seed 3) on the CPU reaches these mean APEs (m) with 0
# failures over each run's frames (PYTHONPATH=. python
# tests/torch_staged_reference.py); each port run, frame by frame on the
# card, is held within STAGED_APE_FACTOR times its run's, with 0 failures.
# NONE and ADAPTIVE with 2 points a voxel and the 3,000-point cap part from
# the corridor after about 10 frames, in the reference too: they run 10
STAGED_REF_APE_M = {"adaptive": 0.26866538844569254,
                    "adaptive_robust": 0.2738228102357611,
                    "cap": 0.12323726957673478,
                    "none": 0.17350385032078236,
                    "adaptive_k2_cap": 0.27366060736022424}
STAGED_FRAMES = {"adaptive": 80, "adaptive_robust": 80, "cap": 80,
                 "none": 10, "adaptive_k2_cap": 10}
STAGED_APE_FACTOR = 1.5

KERNELS = {
    "candidate_gather": dict(
        module=k1, source="ct_icp_torch/csrc/candidate_gather.cu",
        replaces="ct_icp_tpu/mapping/voxel_map.py:668"),
    "plane_moments": dict(
        module=k2, source="ct_icp_torch/csrc/plane_moments.cu",
        replaces="ct_icp_tpu/mapping/voxel_map.py:752"),
    "map_insert": dict(
        module=k3, source="ct_icp_torch/csrc/map_insert.cu",
        replaces="ct_icp_tpu/mapping/voxel_map.py:366"),
    "grid_sample": dict(
        module=k4, source="ct_icp_torch/csrc/grid_sample.cu",
        replaces="tools/pallas_kernels_experiment.py:35"),
    "lm_step": dict(
        module=k5, source="ct_icp_torch/csrc/lm_step.cu",
        replaces="ct_icp_tpu/icp/solver.py:452"),
    "row_gather": dict(
        module=k6, source="ct_icp_torch/csrc/row_gather.cu",
        replaces="tools/exp_gather.py:90"),
    "rebuild_claim": dict(
        module=k7, source="ct_icp_torch/csrc/rebuild_claim.cu",
        replaces="ct_icp_tpu/mapping/voxel_map.py:619"),
    "ct_ba_block": dict(
        module=k8, source="ct_icp_torch/csrc/ct_ba_block.cu",
        replaces="ct_icp_tpu/parallel/ct_ba.py:120"),
    "evict_voxels": dict(
        module=k9, source="ct_icp_torch/csrc/evict_voxels.cu",
        replaces="ct_icp_tpu/mapping/voxel_map.py:564"),
    "level_normals": dict(
        module=k10, source="ct_icp_torch/csrc/level_normals.cu",
        replaces="ct_icp_tpu/mapping/voxel_map.py:549"),
    "owner_pack": dict(
        module=k11, source="ct_icp_torch/csrc/owner_pack.cu",
        replaces="ct_icp_tpu/parallel/sharded_map.py:152"),
    "knn_search": dict(
        module=k12, source="ct_icp_torch/csrc/knn_search.cu",
        replaces="ct_icp_tpu/mapping/voxel_map.py:917"),
    "exact_sample": dict(
        module=k13, source="ct_icp_torch/csrc/exact_sample.cu",
        replaces="ct_icp_tpu/ops/sampling.py:89"),
}
# a kernel record's further times and work counts, copied to the kernels
# line where present
WORK_KEYS = ("host_ms", "warm_ms", "library_warm_ms", "step_ms",
             "ms_per_step", "steps_run", "step_bound_ms",
             "device_ops_per_call", "cached_ms", "group", "live",
             "points_read", "rows_read", "per_query_bytes", "key_windows",
             "slots_found", "claim_rounds", "rebuild_level_ms",
             "rebuild_level_plain_ms", "rows_live", "d_tr_m", "d_rot_deg",
             "left_out", "with_submission_ms", "graph20_ms", "floor_ms",
             "floor_graph20_ms", "iters", "cluster", "phase_cycles",
             "one_launch_equals_chain", "removed", "lanes", "dirty",
             "refit_ms", "jtr_float64")
# the kernels of the first three paths (the rebase runs on none of them)
K1_K5 = ["candidate_gather", "plane_moments", "map_insert", "grid_sample",
         "lm_step"]


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_mutating(setup, fn, reps=20):
    """Mean ms of ``fn(setup())`` between two events, ``setup()`` (a fresh
    copy of the state the call updates) outside the timed span."""
    for _ in range(2):
        fn(setup())
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        state = setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(state)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps, "events"


def ptxas_summary(log_text):
    """{entry function: {registers, spill_stores, spill_loads}} from
    ``nvcc -Xptxas -v``'s output."""
    out, entry = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[entry].update(spill_stores=int(m.group(1)),
                              spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry]["registers"] = int(m.group(1))
    return out


def phase_build():
    names = list(KERNELS)
    if sorted(names) != build.kernel_names():
        raise RuntimeError(f"kernel sources {build.kernel_names()} are not "
                           f"the kernels checked here {sorted(names)}")
    t0 = time.time()
    # K8's phase-mark variant (phase 9) builds beside the kernels
    marks = threading.Thread(target=build.build_all,
                             args=(["ct_ba_block"], K8_MARKS))
    marks.start()
    build.build_all(names)
    marks.join()
    build.launcher("ct_ba_block", "k8_read_marks", (build.PTR,), K8_MARKS)
    log(f"build: {len(names)} kernels in {time.time() - t0:.2f} s "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for name in names:
        info = build.build_info.get(name)
        if info is None:
            log(f"  {name}: library already built")
            continue
        log(f"  {name}: {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                log("   ", line.strip())
        KERNELS[name]["ptxas"] = ptxas_summary(info["ptxas"])
        log(f"  {name} registers / spills: "
            f"{json.dumps(KERNELS[name]['ptxas'])}")


def _level_copy(level):
    return vm.MapLevel(*(t.clone() for t in level))


def _warm_level(dev, res, prep):
    """A level of ``res``'s size holding frame ``prep``'s points, inserted
    by the kernel."""
    level = vm.make_level(res.capacity_log2, res.max_num_points, dev)
    pts = torch.as_tensor(prep["xyz"], dtype=torch.float32, device=dev)
    vm.insert_points(level, pts, torch.ones(pts.shape[0], dtype=torch.bool,
                                            device=dev),
                     res.resolution, res.min_distance_between_points, 12)
    torch.cuda.synchronize()
    return level


def _kernel_k1(dev, level, res, q, nv, thr, max_c, tag, query_valid=None,
               sensor=None):
    """K1 against its plain version and timed, at one shape (every query
    valid unless ``query_valid`` says otherwise; with the normal filter
    seen from ``sensor`` f32[3] when given). Returns its record and its
    (slots, cnt_ok)."""
    m = q.shape[0]
    qv = (torch.ones(m, dtype=torch.bool, device=dev) if query_valid is None
          else query_valid)
    err = checks.check_candidate_gather(level, q, qv, res.resolution, nv, thr,
                                        max_c, sensor)
    args = (level.keys, level.count, q, qv, res.resolution, nv, thr, max_c)
    filt = ({} if sensor is None else dict(
        normals=level.normals, nflags=level.nflags, sensor_location=sensor))
    ms, how = time_stateless(lambda: k1.candidate_gather(*args, **filt))
    plain_ms, _ = time_stateless(
        lambda: k1.candidate_gather_plain(*args, **filt))
    slots, cnt = k1.candidate_gather(*args, **filt)
    cand = (vx.voxel_coords(q, res.resolution)[:, None, :]
            + k1.neighbor_offsets(nv, dev)[None])
    found, _ = k1.find_slots_with_count(level.keys, level.count, cand)
    o_out = slots.shape[1]
    n_vox = torch.unique(vx.voxel_hash_u32(cand.reshape(-1, 3))).numel()
    n_found = torch.unique(found[found >= 0]).numel()
    # the queries (and their validity), every distinct probed voxel's key
    # window once, every distinct found slot's count once (with the
    # filter, its normal and flag too, and the sensor), 8 B written per
    # output pair
    n_bytes = (m * 13 + n_vox * 32 + n_found * (4 if sensor is None else 20)
               + m * o_out * 8)
    log(f"K1 candidate_gather {tag} M={m} O={cand.shape[1]}->{o_out}: "
        f"identical to plain; {ms:.4f} ms ({how}), plain {plain_ms:.4f} ms; "
        f"{n_vox} distinct key windows probed, {n_found} distinct slots "
        f"found, {n_bytes} bytes")
    return dict(max_abs_err=err["max_abs_err"], ms=ms, plain_ms=plain_ms,
                library_ms=None, bytes=n_bytes, ops=0.0, timing=how,
                key_windows=n_vox, slots_found=n_found,
                shape=f"M={m} O={cand.shape[1]}->{o_out} "
                      f"C={level.capacity}"), (slots, cnt)


def _kernel_k2(level, q, slots, cnt, radius, k_nearest, tag):
    m = q.shape[0]
    q2 = q + 0.02
    pts = level.points
    err_f = checks.check_plane_moments(pts, slots, cnt, q2, radius,
                                       k_nearest)
    fresh = k2.plane_moments_plain(pts, slots, cnt, q2, radius, k_nearest)
    err_c = checks.check_plane_moments(pts, slots, cnt, q, radius, k_nearest,
                                       fresh.r_eff2)
    ms, how = time_stateless(
        lambda: k2.plane_moments(pts, slots, cnt, q2, radius, k_nearest))
    plain_ms, _ = time_stateless(
        lambda: k2.plane_moments_plain(pts, slots, cnt, q2, radius,
                                       k_nearest))
    ms_c, _ = time_stateless(
        lambda: k2.plane_moments(pts, slots, cnt, q, radius, k_nearest,
                                 fresh.r_eff2))
    points_read, rows_read, live = live_work(pts, slots, cnt)
    in_r = float(fresh.count.sum())
    # exp_moments.k2_bytes: each distinct live map point once, the pairs,
    # queries and outputs; a fresh call: d2 twice (shell histogram + sums, 8
    # flops each) per live candidate of each query, 15 flops of sums per
    # in-radius one
    n_bytes = k2_bytes(pts, slots, cnt) + (m * 4 if torch.is_tensor(radius)
                                          else 0)
    per_query_bytes = live * 12 + cnt.numel() * 4 + m * 12 + m * 88
    err = max(err_f["max_abs_err"], err_c["max_abs_err"])
    log(f"K2 plane_moments {tag} M={m}: within tolerance (max abs err "
        f"{err:.3g}); fresh {ms:.4f} ms ({how}), cached-radius {ms_c:.4f} "
        f"ms, plain {plain_ms:.4f} ms; {live} live candidates "
        f"({live / m:.1f} a query), {points_read} distinct live map points "
        f"in {rows_read} rows ({rows_read * pts.shape[1] * 4 / 1e6:.2f} MB "
        f"of rows), {n_bytes} bytes (counted per query: {per_query_bytes})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bytes=n_bytes, ops=live * 16.0 + in_r * 15, timing=how,
                group=build.launcher("plane_moments", "k2_group", ())(),
                live=live, points_read=points_read, rows_read=rows_read,
                per_query_bytes=per_query_bytes,
                shape=f"M={m} O={slots.shape[1]} P={pts.shape[1] // 3} "
                      f"live={live}", cached_ms=ms_c)


def _kernel_k3(dev, level, res, prep, rounds, tag, count_ops=False):
    """K3 against its plain version, inserting ``prep["xyz"]`` into a copy
    of ``level`` at ``res``'s resolution and min distance, then timed."""
    pts = torch.as_tensor(prep["xyz"], dtype=torch.float32, device=dev)
    n = pts.shape[0]
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    md = res.min_distance_between_points
    out = checks.check_map_insert(level, pts, valid, res.resolution, md,
                                  rounds)
    lv = _level_copy(level)

    def reset():
        for dst, src in zip(lv, level):
            dst.copy_(src)

    def insert():
        vm.insert_points(lv, pts, valid, res.resolution, md, rounds)

    # the card's own time (the profiler's kernel duration, in a young
    # process, each traced call on the level restored); the graph of one
    # call between events also holds the graph's submission
    sub_ms, _ = time_graph(reset, insert)
    job = (vm.insert_points, (lv, pts, valid, res.resolution, md, rounds),
           (list(lv), list(level)))
    traced = _traced(f"K3 {tag}", [("ms",) + job]
                     + ([("ops",) + job] if count_ops else []))
    ms, how = traced[0]
    host_ms, _ = time_mutating(lambda: _level_copy(level), lambda lv2:
                               vm.insert_points(lv2, pts, valid,
                                                res.resolution, md, rounds))
    ops = (_require_ops("K3 map_insert", traced[1], 2) if count_ops
           else None)
    del lv
    plain_ms, _ = time_mutating(
        lambda: _level_copy(level), lambda lv: k3.map_insert_plain(
            *lv[:3], lv.num_points, pts, valid, res.resolution, md, rounds))
    # data-dependent work: the voxels the points land in, read once
    after = _level_copy(level)
    vm.insert_points(after, pts, valid, res.resolution, md, rounds)
    coords = vx.voxel_coords(pts, res.resolution)
    s, _ = k1.find_slots_with_count(after.keys, after.count, coords)
    s = s[s >= 0]
    ec = level.count[s].to(torch.float64)      # counts before the insert
    uniq = torch.unique(s)
    new_keys = int(((level.keys[uniq] == 0) | (level.keys[uniq] == 1)).sum())
    n_bytes = (n * 13 + uniq.numel() * 32
               + float(level.count[uniq].sum()) * 12 + uniq.numel() * 8
               + out["inserted"] * 12 + new_keys * 4)
    log(f"K3 map_insert {tag} N={n} max_rounds={rounds}: identical to plain "
        f"({out['inserted']} inserted); {ms:.4f} ms on the device ({how}), "
        f"{host_ms:.4f} ms with its host enqueue (events), plain "
        f"{plain_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bytes=n_bytes,
                ops=float(ec.sum()) * 8, timing=how, host_ms=host_ms,
                with_submission_ms=sub_ms, device_ops_per_call=ops,
                max_abs_err=out["max_abs_err"],
                shape=f"N={n} rounds={rounds} P={level.max_points} "
                      f"C={level.capacity}")


def _kernel_k4(dev, pts, valid, voxel, capacity, table_log2=22, *, tag):
    """K4 against its plain version (three calls in a row on its table),
    then timed: on the device with the L2 flushed before each call
    (``ms``), back to back in a CUDA graph (``warm_ms``, as the earlier
    five-launch design was timed) and with its host side (``host_ms``:
    events around the Python call)."""
    for _ in range(3):
        out = checks.check_grid_sample(pts, valid, voxel, capacity,
                                       table_log2)
    args = (pts, valid, voxel, capacity, table_log2)
    ms, how = time_cold(lambda: k4.grid_sample(*args))
    warm_ms, _ = time_stateless(lambda: k4.grid_sample(*args))
    host_ms, _ = time_host(lambda: k4.grid_sample(*args))
    plain_ms, _ = time_stateless(lambda: k4.grid_sample_plain(*args))
    n = pts.shape[0]
    # inputs read once (points, validity), outputs written once (indices,
    # validity, count); the claim table is this design's scratch
    n_bytes = n * 13 + capacity * 5 + 4
    table_ms = (1 << table_log2) * 4 / HBM_BYTES_PER_S * 1e3
    log(f"K4 grid_sample {tag} N={n} table 2^{table_log2} cap={capacity}: "
        f"identical to plain ({out['count']} kept); {ms:.4f} ms ({how}; "
        f"{warm_ms:.4f} ms back to back), {host_ms:.4f} ms with its host "
        f"side, plain {plain_ms:.4f} ms; the five-launch design's table "
        f"clear alone took >= {table_ms:.5f} ms")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                bytes=n_bytes, ops=n * 12.0, timing=how, warm_ms=warm_ms,
                host_ms=host_ms, table_clear_floor_ms=table_ms,
                shape=f"N={n} table=2^{table_log2} capacity={capacity} "
                      f"kept={out['count']}")


def _path_lm_call(odo, preps, k):
    """The inputs of K5's first LM call in frame ``k`` of the per-frame
    path: frames [0, k) go through ``register_frame_prepared``, then frame k,
    whose first call starts from its motion-model initial pose against the
    map those frames built. Returns (rows, prior, n_res, state at the call,
    the call's other arguments, its n_steps)."""
    for prep in preps[:k]:
        odo.register_frame_prepared(prep)
    calls = []
    loop = k5.lm_loop

    def record(rows, prior, n_res, state, n_steps, *args):
        if not calls:
            calls.append((rows.clone(), prior.clone(), n_res.clone(),
                          state.clone(), args, n_steps))
        loop(rows, prior, n_res, state, n_steps, *args)

    k5.lm_loop = record
    try:
        odo.register_frame_prepared(preps[k])
    finally:
        k5.lm_loop = loop
    return calls[0]


def _slerp_branch(state):
    """quat_slerp's branch for the pose in ``state`` (the same for every
    row at delta = 0): "nlerp" when |qb . qe| > 1 - 1e-7 in float32, as the
    kernel and core/math_impl.py test it; and the begin-to-end angle."""
    q = state[0:14].double().cpu().numpy().astype(np.float32)
    d = np.float32(0.0)
    for a, b in zip(q[0:4], q[7:11]):
        d = np.float32(d + np.float32(a * b))
    d = abs(d)
    branch = "nlerp" if d > np.float32(1.0 - 1e-7) else "slerp"
    return branch, float(np.degrees(2.0 * np.arccos(min(float(d), 1.0))))


def _row_residual_ops(branch: str):
    """(primal, tangents): float operations of one point-to-plane row's
    residual at delta = 0 and of its 12 forward-mode tangents with the
    primal shared (the formulas of csrc/dual.cuh), counted for the function,
    not for the kernels' design (which run the primal in each of their two
    6-tangent passes)."""
    slerp = branch == "slerp"
    # interpolated rotation: the slerp weights sin((1-a)th)/sin(th) and
    # sin(a th)/sin(th) (7) or the lerp weight (1), the blend (12), the
    # normalisation (13); rotate the raw point (30), lerp the translation
    # (13), the weighted point-to-plane residual (9)
    primal = (7 if slerp else 1) + 12 + 13 + 30 + 13 + 9
    # the tangent of one rotation column by the dual rules (a product or a
    # quotient 3, a sum 1, a square root 2, a sine 2): through the weights
    # (10, slerp only, with 2 cosines per row) and the blend (28 or 12), the
    # normalisation (29), the rotation (48) and the residual (6)
    rot_col = (10 + 28 if slerp else 12) + 29 + 48 + 6
    jac = 6 * rot_col + 6 * 2 + (2 if slerp else 0)  # 6 translation columns
    return primal, jac


def _lm_row_ops(branch: str) -> int:
    """Float operations one LM step needs per kept row: the residual once
    at delta = 0, its 12 tangents, the normal equations and the trial
    cost. The pose-level work (apply_delta and its tangents, the slerp's
    angle, the prior rows, the 12x12 solve: a few thousand operations a
    step) is not per row and is left out."""
    primal, jac = _row_residual_ops(branch)
    irls = 4 + 3                # the Cauchy weight and cost at delta = 0
    normal = 12 + 2 * 90        # J w, then the 78 + 12 products and sums
    trial = primal + 4          # the residual and its Cauchy cost at delta
    return primal + jac + irls + normal + trial


def _ct_ba_row_ops(branch: str) -> int:
    """Float operations K8 needs per live point row: the residual and its
    12 tangents (as K5's row), then the 78 + 12 products and sums of
    J^T J and J^T r and r^2. The 16 pose-level rows and the solve (a few
    thousand operations a frame) are left out."""
    primal, jac = _row_residual_ops(branch)
    return primal + jac + 2 * (78 + 12 + 1)


def _require_ops(kernel, traced, most):
    """The count of device operations one call made, from a fresh process's
    ("ops") trace (None where none of its traces saw the device); fails
    past ``most``."""
    ops, traces = traced
    if ops is None:
        log(f"{kernel}: the profiler saw no device operation in {traces} "
            f"traces (not measured)")
        return None
    log(f"{kernel}: device operations of one call: {ops}")
    if not 1 <= len(ops) <= most:
        raise RuntimeError(f"{kernel}: one call made {len(ops)} device "
                           f"operations, more than {most}")
    return len(ops)


def _traced(what, jobs):
    """``tools/timing.py::fresh_process_traces(jobs)``: the profiler's
    kernel durations ("ms": the median of five traced calls that saw the
    device) and device operations ("ops") of module functions on this
    process's tensors, traced in a process whose first trace is recent;
    fails where an "ms"
    job's traces saw no device operation."""
    out = fresh_process_traces(jobs)
    for job, res in zip(jobs, out):
        if job[0] == "ms" and res[0] is None:
            raise RuntimeError(f"{what}: the profiler saw no device "
                               f"operation ({res[1]})")
    return out


def _kernel_k5(dev, call, tag, count_ops=False):
    """K5 against its plain version on one LM call of the path: one step
    from the call's initial state, then the whole call (up to its n_steps,
    stopping at done). Times: the device time of the call and of a call of
    one step (each a CUDA graph of one launch), the call with its host path
    (events around the wrapper), the plain call's and the plain step's
    (events)."""
    rows, prior, n_res, state0, lm_args, steps = call
    branch, angle = _slerp_branch(state0)
    err = checks.check_lm_step(rows, prior, n_res, state0, lm_args[1],
                               lm_args[2], lm_args[3], loop_steps=steps)
    steps_run = err["loop"]["steps_run"]
    st = state0.clone()

    def reset():
        st.copy_(state0)

    def call_of(n):
        return lambda: k5.lm_loop(rows, prior, n_res, st, n, *lm_args)

    ms, how = time_graph(reset, call_of(steps))
    step_ms, _ = time_graph(reset, call_of(1))
    host_ms, _ = time_mutating(
        state0.clone, lambda s: k5.lm_loop(rows, prior, n_res, s, steps,
                                           *lm_args))
    plain_ms, _ = time_mutating(
        state0.clone, lambda s: k5.lm_loop_plain(rows, prior, n_res, s, steps,
                                                 *lm_args), reps=3)
    plain_step_ms, _ = time_mutating(
        state0.clone, lambda s: k5.lm_step_plain(rows, prior, n_res, s,
                                                 *lm_args))
    ops = (_require_ops("K5 lm_loop", _traced("K5", [(
        "ops", k5.lm_loop, (rows, prior, n_res, st, steps) + tuple(lm_args),
        ([st], [state0]))])[0], 1) if count_ops else None)
    k = rows.shape[0]
    n_ok = int(n_res)
    log(f"K5 lm_loop {tag} K={k} kept={n_ok} n_steps={steps} ran "
        f"{steps_run} (plain {err['loop']['plain_steps_run']}) {branch} "
        f"(begin-to-end {angle:.4f} deg): within tolerance "
        f"({json.dumps(err)}); the call {ms:.4f} ms on the device ({how}; "
        f"{ms / steps_run:.4f} ms a step), {host_ms:.4f} ms with its host "
        f"path, plain {plain_ms:.4f} ms; one step {step_ms:.4f} ms, plain "
        f"{plain_step_ms:.4f} ms")
    # the rows read once, the state read and written, the prior and n_res
    n_bytes = k * 4.0 * k5.ROW + 2 * 4 * k5.STATE_SIZE + 14 * 4 + 4
    return dict(max_abs_err=err["max_abs_err"], ms=ms, plain_ms=plain_ms,
                library_ms=None, bytes=n_bytes,
                ops=steps_run * n_ok * float(_lm_row_ops(branch)),
                timing=how, host_ms=host_ms, step_ms=step_ms,
                plain_step_ms=plain_step_ms, ms_per_step=ms / steps_run,
                steps_run=steps_run, loop_steps=steps,
                device_ops_per_call=ops,
                step_bound_ms=bound(n_bytes,
                                    n_ok * float(_lm_row_ops(branch)))[0],
                relative_errors=err["relative"], loop_check=err["loop"],
                branch=branch, begin_end_deg=angle,
                shape=f"K={k} kept={n_ok} {branch} (one call of "
                      f"{steps_run} steps)")


def _identity_pose(dev):
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    return q, torch.zeros(3, device=dev)


def phase_kernels_driving(dev, o, preps):
    """K1-K3 and K5 against their plain versions at driving shapes
    (options ``o``), then times. Returns {name: partial kernel record}."""
    preps_by_fid = {0: preps[0], 1: preps[1], len(preps) - 1: preps[-1]}
    res = o.map_options.resolutions[0]
    icp = o.ct_icp_options
    records = {}
    level = _warm_level(dev, res, preps_by_fid[0])
    log(f"driving map: C={level.capacity} P={level.max_points} "
        f"points={int(level.num_points[0])} from frame 0 "
        f"({preps_by_fid[0]['n']} points)")
    p1 = preps_by_fid[1]
    q = torch.as_tensor(p1["xyz"][:K1_QUERIES], dtype=torch.float32,
                        device=dev)
    records["candidate_gather"], (slots, cnt) = _kernel_k1(
        dev, level, res, q, 1, icp.threshold_voxel_occupancy, 0, "driving")
    records["plane_moments"] = _kernel_k2(
        level, q, slots, cnt, float(o.map_options.default_radius),
        icp.max_number_neighbors, "driving")
    del slots, cnt
    # K3: a startup frame (12 rounds) and a cruise frame (4 rounds)
    rec = _kernel_k3(dev, level, res, preps_by_fid[1], 12, "driving startup",
                     count_ops=True)
    rec["cruise"] = _kernel_k3(dev, level, res,
                               preps_by_fid[max(preps_by_fid)], 4,
                               "driving cruise")
    records["map_insert"] = rec
    # the rebase's device operations, counted here: one K7 and one K6
    # launch; and K4's, one launch: the election of frame 1's sub-sample at
    # 1.0 m
    shift = torch.tensor([3.3, -0.7, 0.1], device=dev)
    sub = torch.as_tensor(p1["xyz"], dtype=torch.float32, device=dev)
    ok = torch.ones(sub.shape[0], dtype=torch.bool, device=dev)
    rebuild_ops, k4_ops = _traced("driving device operations", [
        ("ops", vm.rebuild_level, (level, shift, res.resolution), None),
        ("ops", k4.grid_sample, (sub, ok, 1.0, 4096), None)])
    records["rebuild_level_device_ops"] = _require_ops(
        "rebuild_level", rebuild_ops, 2)
    records["grid_sample_device_ops"] = _require_ops(
        "K4 grid_sample", k4_ops, 1)
    del level
    # K5: the first LM call of a frame on the per-frame path
    records["lm_step"] = _kernel_k5(dev, _path_lm_call(
        Odometry(o, device=dev), preps, K5_DRIVING_FRAME),
        f"driving frame {K5_DRIVING_FRAME}", count_ops=True)
    torch.cuda.empty_cache()
    return records


def phase_kernels_robust(dev, odo, preps):
    """K1-K5 against their plain versions at the robust profile's shapes
    (0.5 m voxels, P = 40, C = 2^19, radius 0.8 with nv = 2 kept to 48
    voxels, k_nearest 20), then times. Returns {name: partial record}."""
    o = odo.options
    res = o.map_options.resolutions[0]
    icp = o.ct_icp_options
    statics = odo.registration.statics
    records = {}
    level = _warm_level(dev, res, preps[0])
    log(f"robust map: C={level.capacity} P={level.max_points} "
        f"points={int(level.num_points[0])} from frame 0 "
        f"({preps[0]['n']} points)")
    p1 = preps[1]
    q = torch.as_tensor(p1["xyz"][:p1["kp_n"]], dtype=torch.float32,
                        device=dev)
    records["candidate_gather"], (slots, cnt) = _kernel_k1(
        dev, level, res, q, statics.voxel_neighborhood, 1,
        statics.max_candidate_voxels, "robust")
    records["plane_moments"] = _kernel_k2(
        level, q, slots, cnt, float(o.map_options.default_radius),
        icp.max_number_neighbors, "robust")
    del slots, cnt
    records["map_insert"] = _kernel_k3(dev, level, res, preps[1], 12,
                                       "robust startup")
    records["map_insert"]["cruise"] = _kernel_k3(
        dev, level, res, preps[-1], 4, "robust cruise")
    # K4: the escalated election of a robust frame's uploaded sub-sample
    # (1.5 m / 1.5 = 1.0 m, 2^22 table, 4096 keypoints), then the Pallas
    # configuration (2^21 table, a valid prefix, N % 1024 == 0)
    prep = preps[-1]
    raw, _alphas = pl.unpack_scan(torch.from_numpy(
        prep["scan_host"].view(np.int16)).to(dev))
    sub = raw[:prep["n"]].contiguous()
    voxel = max(o.sample_voxel_size / 1.5, min(o.init_voxel_size,
                                               o.voxel_size))
    records["grid_sample"] = _kernel_k4(
        dev, sub, torch.ones(sub.shape[0], dtype=torch.bool, device=dev),
        voxel, o.max_keypoints, 22, tag="robust escalation")
    n_pad = (sub.shape[0] + 1023) // 1024 * 1024
    padded = torch.zeros((n_pad, 3), dtype=torch.float32, device=dev)
    padded[:sub.shape[0]] = sub
    records["grid_sample"]["pallas_config"] = _kernel_k4(
        dev, padded, torch.arange(n_pad, device=dev) < sub.shape[0], voxel,
        o.max_keypoints, 21, tag="Pallas configuration")
    del level
    # K5: the first LM call of a robust frame on the per-frame path, at its K
    records["lm_step"] = _kernel_k5(dev, _path_lm_call(
        Odometry(o, device=dev), preps, K5_ROBUST_FRAME),
        f"robust frame {K5_ROBUST_FRAME}")
    torch.cuda.empty_cache()
    return records


def phase_stages(dev, odo, preps_by_fid):
    """The driving path's device stages that stay plain torch (ROADMAP
    B9-B11), timed on the card at driving shapes, each with its bound.
    Returns {stage: record}."""
    res = odo.options.map_options.resolutions[0]
    level = _warm_level(dev, res, preps_by_fid[0])
    prep = preps_by_fid[max(preps_by_fid)]         # a cruise frame
    n = prep["n"]
    out = {}

    # B11: unpack_scan + transform_points of the frame's uploaded scan
    scan = torch.from_numpy(prep["scan_host"].view(np.int16)).to(dev)
    qb, tb = _identity_pose(dev)
    qe = torch.tensor([0.99995, 0.0, 0.0, 0.01], device=dev)
    te = torch.tensor([1.0, 0.02, 0.0], device=dev)

    def b11():
        raw, alphas = pl.unpack_scan(scan)
        return pl.transform_points(raw[:n], alphas[:n], qb, tb, qe, te)

    ms, how = time_stateless(b11)
    rows = scan.shape[0]
    out["B11 unpack_scan+transform_points"] = dict(
        ms=ms, timing=how, bytes=rows * (8 + 16) + n * (16 + 12),
        ops=n * 60.0, shape=f"R={rows} n={n}")

    # B9: compact_mask of an insert-size mask (the plain K3 version's use)
    mask = torch.from_numpy(np.random.default_rng(SEED).uniform(size=n)
                            < 0.3).to(dev)
    ms, how = time_stateless(lambda: vx.compact_mask(mask, n))
    out["B9 compact_mask"] = dict(ms=ms, timing=how, bytes=n * (1 + 4),
                                  ops=0.0, shape=f"N={n}")

    # B10: prune_level over all C slots (updates the level in place)
    loc = torch.tensor([5.0, 0.0, 0.0], device=dev)
    ms, how = time_mutating(lambda: _level_copy(level),
                            lambda lv: vm.prune_level(lv, loc, 10.0))
    c = level.capacity
    out["B10 prune_level"] = dict(ms=ms, timing=how, bytes=c * (24 + 12),
                                  ops=c * 9.0, shape=f"C={c}")
    for name, r in out.items():
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["ops"])
        log(f"{name} ({r['shape']}): {r['ms']:.4f} ms ({r['timing']}), "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    del level
    torch.cuda.empty_cache()
    return out


def _reset_counts():
    for spec in KERNELS.values():
        spec["module"].launches = 0
    k5.reset_steps()


def _read_steps(dev="cuda"):
    """The LM steps K5 ran since the last ``_reset_counts`` (a device read,
    made after the path)."""
    return int(k5.steps_counter(dev)[0])


def _read_counts():
    return {name: spec["module"].launches for name, spec in KERNELS.items()}


def _stream(odo, preps, batch):
    """Stream ``preps``; per-batch wall times (synchronized at each batch
    end) and the summaries."""
    torch.cuda.synchronize()
    batch_s, summaries = [], []
    t_batch = t0 = time.time()
    for i, summary in enumerate(odo.stream_frames(iter(preps), batch=batch)):
        summaries.append(summary)
        if (i + 1) % batch == 0 or i + 1 == len(preps):
            torch.cuda.synchronize()
            now = time.time()
            batch_s.append((now - t_batch, (i % batch) + 1))
            t_batch = now
    return summaries, batch_s, time.time() - t0


def _require_launches(path, launches, names):
    missing = [n for n in names if launches[n] <= 0]
    if missing:
        raise RuntimeError(f"the {path} path never launched {missing}")


def _require_syncs(path, out, committed_only, inserts_per_frame=0.0):
    """No host read per LM step: fewer host syncs a frame than LM steps
    (K5's device count of the steps it ran); where every frame's work was
    committed (no rollback), exactly one sync per ICP iteration and one per
    result readback, and ``inserts_per_frame`` more (a with_normals insert
    reads its dirty list's length: one a level a frame). (A rolled-back
    batch's ICP iterations are read but not counted in the frames'
    summaries.)"""
    syncs = out["host_syncs_per_frame"]
    steps = out["lm_steps"] / out["frames"]
    if not syncs < steps:
        raise RuntimeError(f"{path} path: {syncs} host syncs a frame for "
                           f"{steps} LM steps")
    if committed_only and not (syncs <= out["icp_iters_per_frame"]
                               + out["result_reads_per_frame"]
                               + inserts_per_frame + 1e-9):
        raise RuntimeError(f"{path} path: a host sync beyond one per ICP "
                           "iteration, one per result readback and "
                           f"{inserts_per_frame} a frame for the inserts")


def _path_stats(odo, frames, preps, summaries, batch_s, wall):
    outer = sum(s.icp_summary.num_iters for s in summaries)
    errs = cor.seq_ape(odo, frames)
    fps = [n / s for s, n in batch_s]
    nf = len(preps)
    return dict(
        frames=nf, failures=sum(not s.success for s in summaries),
        mean_attempts=float(np.mean([s.number_of_attempts
                                     for s in summaries])),
        mean_ape_m=float(np.mean(errs)), final_drift_m=float(errs[-1]),
        map_points=odo.map_size(),
        median_batch_fps=float(np.median(fps)), batch_fps=fps, wall_s=wall,
        icp_iters_per_frame=outer / nf,
        host_syncs_per_frame=odo.host_syncs / nf,
        result_reads_per_frame=odo.result_reads / nf,
        prunes_per_frame=sum(p["info"].registered_fid % PRUNE_PERIOD == 0
                             for p in preps) / nf), errs


def phase_driving(odo, frames, preps):
    """The driving path through the user's entry points: ``preps`` are
    ``odo.prepare_frame`` of ``frames``."""
    _reset_counts()
    summaries, batch_s, wall = _stream(odo, preps, BATCH)
    launches, lm_steps = _read_counts(), _read_steps()
    out, _ = _path_stats(odo, frames, preps, summaries, batch_s, wall)
    out.update(batch=BATCH, launches=launches, lm_steps=lm_steps)
    log("driving path: " + json.dumps(out))
    log(f"  mean APE {out['mean_ape_m']:.4f} m (smoke bound "
        f"{APE_SMOKE_BOUND_M} m; the 3-seed gate is {cor.APE_BOUND_M} m); "
        f"host syncs per frame {out['host_syncs_per_frame']:.3f} beside "
        f"{out['icp_iters_per_frame']:.3f} ICP iterations per frame and "
        f"{out['result_reads_per_frame']:.4f} result readbacks")
    if out["failures"]:
        raise RuntimeError(f"driving path: {out['failures']} failed frames")
    if not out["mean_ape_m"] <= APE_SMOKE_BOUND_M:
        raise RuntimeError(f"driving path: mean APE {out['mean_ape_m']} m > "
                           f"{APE_SMOKE_BOUND_M} m")
    _require_launches("driving", launches, ["candidate_gather",
                                            "plane_moments", "map_insert",
                                            "lm_step"])
    _require_syncs("driving", out, committed_only=True)
    icp_iters = round(out["icp_iters_per_frame"] * out["frames"])
    if launches["lm_step"] != icp_iters:
        raise RuntimeError(f"driving path: {launches['lm_step']} K5 launches "
                           f"for {icp_iters} LM calls")
    return out


def phase_robust(dev):
    """The robust path: bench.py's robust corridor through
    Odometry(robust_driving_profile()).stream_frames(batch=8)."""
    t0 = time.time()
    frames = cor.render_corridor(cor.build_scene(),
                                 cor.robust_corridor_trajectory(NUM_FRAMES),
                                 NUM_FRAMES, SEED)
    odo = Odometry(robust_driving_profile(), device=dev)
    preps = [odo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i)
             for i, f in enumerate(frames)]
    log(f"robust corridor: {len(frames)} frames rendered and prepared in "
        f"{time.time() - t0:.1f} s; points after dedup "
        f"{[p['n'] for p in preps[:2]]} ... {preps[-1]['n']}, keypoints "
        f"{[p['kp_n'] for p in preps[:2]]} ... {preps[-1]['kp_n']}")
    records = phase_kernels_robust(dev, odo, preps)
    odo = Odometry(robust_driving_profile(), device=dev)
    _reset_counts()
    summaries, batch_s, wall = _stream(odo, preps, ROBUST_BATCH)
    launches, lm_steps = _read_counts(), _read_steps()
    out, _ = _path_stats(odo, frames, preps, summaries, batch_s, wall)
    out.update(batch=ROBUST_BATCH, launches=launches, lm_steps=lm_steps,
               speculative_batches_committed={
                   str(k): v for k, v in
                   odo.speculative_batches_committed.items()},
               speculative_prefix_commits=odo.speculative_prefix_commits,
               speculative_rollbacks=odo.speculative_rollbacks,
               max_level=max(s.robust_level for s in summaries))
    log("robust path: " + json.dumps(out))
    log(f"  mean APE {out['mean_ape_m']:.4f} m (smoke bound "
        f"{APE_SMOKE_BOUND_M} m; the 3-seed gate is "
        f"{cor.ROBUST_APE_BOUND_M} m); failures {out['failures']}, mean "
        f"attempts {out['mean_attempts']:.3f}; host syncs per frame "
        f"{out['host_syncs_per_frame']:.3f} beside "
        f"{out['icp_iters_per_frame']:.3f} ICP iterations per frame")
    if out["failures"]:
        raise RuntimeError(f"robust path: {out['failures']} failed frames")
    if not out["mean_ape_m"] <= APE_SMOKE_BOUND_M:
        raise RuntimeError(f"robust path: mean APE {out['mean_ape_m']} m > "
                           f"{APE_SMOKE_BOUND_M} m")
    _require_launches("robust", launches, ["candidate_gather",
                                           "plane_moments", "map_insert",
                                           "lm_step"])
    _require_syncs("robust", out,
                   committed_only=odo.speculative_rollbacks == 0)
    return out, records, (odo, frames, preps)


def phase_escalation(dev):
    """bench.py's run_escalation scene: a yaw jolt over frames [18, 24)
    and a speed surge over [40, 48), robust_num_attempts=3, batch 8; the
    gate's own assertions (bench.py:685-698). Before it, K5 against its
    plain version on the first LM call of a jolt frame (the slerp branch).
    Returns (path record, K5 record)."""
    b0, b1 = cor.ESC_BURST
    s0, _s1 = cor.ESC_SURGE
    frames = cor.render_corridor(cor.build_scene(),
                                 cor.escalation_trajectory(ESC_FRAMES),
                                 ESC_FRAMES, SEED)
    opts = dataclasses.replace(robust_driving_profile(), robust_num_attempts=3)
    odo = Odometry(opts, device=dev)
    preps = [odo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i)
             for i, f in enumerate(frames)]
    jolt = _kernel_k5(dev, _path_lm_call(Odometry(opts, device=dev), preps,
                                         K5_JOLT_FRAME),
                      f"escalation jolt frame {K5_JOLT_FRAME}")
    if jolt["branch"] != "slerp":
        raise RuntimeError("the jolt frame's LM call is not on the slerp "
                           "branch")
    torch.cuda.empty_cache()
    _reset_counts()
    summaries, batch_s, wall = _stream(odo, preps, ROBUST_BATCH)
    launches, lm_steps = _read_counts(), _read_steps()
    out, errs = _path_stats(odo, frames, preps, summaries, batch_s, wall)
    attempts = [s.number_of_attempts for s in summaries]
    levels = [s.robust_level for s in summaries]
    post = errs[b1 + 4:s0 - 1]
    exhausted = [i for i, a in enumerate(attempts)
                 if a >= odo.options.robust_num_attempts]
    out.update(
        batch=ROBUST_BATCH, launches=launches, lm_steps=lm_steps,
        mean_burst_attempts=float(np.mean(attempts[b0:b1])),
        mean_burst_level=float(np.mean(levels[b0:b1])),
        post_burst_ape_m=float(np.mean(post)), exhausted_frames=exhausted,
        max_level=max(levels), max_attempts=max(attempts),
        speculative_batches_committed={
            str(k): v for k, v in odo.speculative_batches_committed.items()},
        speculative_prefix_commits=odo.speculative_prefix_commits,
        speculative_rollbacks=odo.speculative_rollbacks)
    log("escalation path: " + json.dumps(out))
    checks_ok = {
        "mean_burst_attempts >= 1.1":
            out["mean_burst_attempts"] >= cor.ESC_MIN_BURST_ATTEMPTS,
        "mean_burst_level >= 0.7":
            out["mean_burst_level"] >= cor.ESC_MIN_BURST_LEVEL,
        "post_burst_ape <= 0.15 m":
            out["post_burst_ape_m"] <= cor.ESC_POST_APE_BOUND_M,
        ">= 2 exhausted frames, all in the surge":
            len(exhausted) >= cor.ESC_MIN_EXHAUSTED_FRAMES
            and all(i >= s0 - 1 for i in exhausted),
        "max_level >= 2": out["max_level"] >= cor.ESC_MIN_GAP_LEVEL,
    }
    log(f"  escalation gate: {json.dumps(checks_ok)}")
    failed = [k for k, ok in checks_ok.items() if not ok]
    if failed:
        raise RuntimeError(f"escalation path: {failed}")
    _require_launches("escalation", launches, K1_K5)
    _require_syncs("escalation", out,
                   committed_only=odo.speculative_rollbacks == 0)
    return out, jolt


def _capture_first_rebase(odo, store):
    """Keep a device copy of level 0 and the shift of ``odo``'s first
    rebase (per-frame or streamed), as the rebase receives them: the inputs
    K7 and K6 are held on after the path. The copy is made inside the
    path's run, so its stream time includes it: ``capture_host_s`` is the
    host time it took (its device time is a few hundredths of a ms)."""
    for name in ("_rebase", "_stream_rebase"):
        inner = getattr(odo, name)

        def spy(*args, _inner=inner):
            if not store:
                t0 = time.perf_counter()
                store.update(level=_level_copy(args[0][0]),
                             shift=args[-1].clone(), frame=len(odo.trajectory))
                store["capture_host_s"] = time.perf_counter() - t0
            return _inner(*args)

        setattr(odo, name, spy)


def _require_rebase_launches(path, launches, rebases, levels):
    """K7 and K6 once each a level and rebase (K6 moves the points,
    normals, counts and flags in one launch)."""
    want = {"rebuild_claim": rebases * levels,
            "row_gather": rebases * levels}
    got = {k: launches[k] for k in want}
    if got != want:
        raise RuntimeError(f"{path} path: rebase launches {got}, expected "
                           f"{want} for {rebases} rebases")


def phase_long(dev):
    """The 500-frame urban drive (seed 7) through the user's entry points,
    with the rebase distance at 100 m. Returns (path record, the first
    rebase's capture, the acquisition with its rendered frames kept)."""
    acq = CachedAcquisition(ld.load_acquisition(LONG_SEED))
    odo = Odometry(default_driving_profile(), device=dev)
    odo.rebase_distance = LONG_REBASE_DISTANCE
    captured = {}
    _capture_first_rebase(odo, captured)
    _reset_counts()
    out = stream_acquisition(odo, acq, ld.LONG_FRAMES, ld.LONG_BATCH)
    launches, lm_steps = _read_counts(), _read_steps()
    out.update(launches=launches, lm_steps=lm_steps, seed=LONG_SEED,
               rebase_distance_m=LONG_REBASE_DISTANCE,
               first_rebase_frame=captured.get("frame"),
               first_rebase_capture_host_s=captured.get("capture_host_s"))
    log("long drive: " + json.dumps(out))
    log(f"  {out['frames']} frames, batch {out['batch']}: {out['tr_pct']:.4f}"
        f" %Tr (bound {ld.LONG_TR_BOUND_PCT} on this seed; the gate is the "
        f"mean of seeds {ld.LONG_SEEDS}), mean APE {out['mean_ape_m']:.4f} m,"
        f" {out['rebases']} rebases, median {out['median_batch_fps']:.2f} "
        f"frames/s, rendering {out['render_s']:.1f} s beforehand, streaming "
        f"{out['stream_s']:.1f} s (with the first rebase's level copy, "
        f"{out['first_rebase_capture_host_s']:.4f} s of host time)")
    if out["failures"]:
        raise RuntimeError(f"long drive: {out['failures']} failed frames")
    if not out["tr_pct"] <= ld.LONG_TR_BOUND_PCT:
        raise RuntimeError(f"long drive: {out['tr_pct']} %Tr > "
                           f"{ld.LONG_TR_BOUND_PCT}")
    if out["rebases"] < 2:
        raise RuntimeError(f"long drive: {out['rebases']} rebases < 2")
    _require_launches("long drive", launches, ["candidate_gather",
                                               "plane_moments", "map_insert",
                                               "lm_step", "row_gather",
                                               "rebuild_claim"])
    _require_rebase_launches("long drive", launches, out["rebases"],
                             len(odo.map_state))
    if not out["host_syncs_per_frame"] < out["lm_steps"] / out["frames"]:
        raise RuntimeError("long drive: a host sync per LM step")
    del odo
    torch.cuda.empty_cache()
    return out, captured, acq


def _capture_full_refine(backend, store):
    """Keep device copies of the inputs of the first refine over a full
    window (``backend.window`` keyframes; the first refine has fewer: the
    first frames are never refined), as the backend's ``assemble`` and the
    CT-BA steps receive them: the searched level, the keypoints, poses,
    radius and edge_alpha, and the assembled problem (the inputs K1, K2 and
    K8 are held on after the path). The copies are made inside the path's
    run: ``capture_host_s`` is their host time."""
    inner = backend.assemble

    def spy(levels, raw, alphas, valid, qb, tb, qe, te, radius, ea):
        problem = inner(levels, raw, alphas, valid, qb, tb, qe, te, radius,
                        ea)
        if not store and raw.shape[0] == backend.window:
            t0 = time.perf_counter()
            lvl = backend.odometry.registration.level_index
            store.update(
                level=_level_copy(levels[lvl]),
                args=tuple(x.clone() for x in (raw, alphas, valid, qb, tb,
                                               qe, te)),
                radius=radius, edge_alpha=ea.clone(),
                problem=ct_ba.CTBAProblem(*(x.clone() for x in problem)),
                frame=len(backend.odometry.trajectory))
            store["capture_host_s"] = time.perf_counter() - t0
        return problem

    backend.assemble = spy


def _refines_must_not_sync(backend):
    """Make every synchronizing CUDA call inside a refine's dispatch raise
    (``torch.cuda.set_sync_debug_mode("error")``): a refine reads nothing
    back. The deferred apply's event wait is its one host wait, outside."""
    refine, apply = backend._refine, backend._apply_pending

    def apply_outside():
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            apply()
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    def refine_checked():
        torch.cuda.set_sync_debug_mode("error")
        try:
            refine()
        finally:
            torch.cuda.set_sync_debug_mode(0)

    backend._apply_pending = apply_outside
    backend._refine = refine_checked


def phase_backend(dev, acq):
    """The backend gate (tools/bench.py --backend, the reference's
    run_backend): the long drive's first 320 frames (seed 7, rendered by
    phase 7) through Odometry(default_driving_profile() with the backend
    on).stream_frames(batch=16), the rebase at 500 m as in the gate, then
    the same frames with the backend off, in this process; every refine's
    dispatch runs with synchronizing CUDA calls made errors. Then the
    refine's
    two halves on the inputs of the first refine over a full window: the
    association (K1, K2 and the weighting) and the CT-BA work (its two
    steps of two inner iterations as one K8 launch of four), on the device
    (a CUDA graph of the call) and with the host side."""
    runs, capture = {}, {}
    for name, on in (("on", True), ("off", False)):
        odo = Odometry(gates.backend_profile(on), device=dev)
        if on:
            _capture_full_refine(odo.backend, capture)
            _refines_must_not_sync(odo.backend)
        _reset_counts()
        out = stream_acquisition(odo, acq, gates.BACKEND_FRAMES,
                                 gates.BACKEND_BATCH)
        out.update(launches=_read_counts(), lm_steps=_read_steps())
        if on:
            b = odo.backend
            out.update(refinements=b.refinements,
                       refine_dispatches=len(b.refine_ms),
                       refine_ms_median=float(np.median(b.refine_ms)),
                       refine_ms_max=float(np.max(b.refine_ms)),
                       event_waits=b.event_waits,
                       event_waits_per_frame=b.event_waits / out["frames"],
                       capture_host_s=capture.get("capture_host_s"))
        runs[name] = out
        del odo
        torch.cuda.empty_cache()
    on, off = runs["on"], runs["off"]
    launches = on["launches"]
    log("backend gate, backend on: " + json.dumps(on))
    log("backend gate, backend off: " + json.dumps(off))
    if not capture:
        raise RuntimeError("backend gate: no refine over a full window")
    # the refine's halves on a full window's inputs
    c = capture
    reg_o = gates.backend_profile(True)
    odo = Odometry(reg_o, device=dev)
    levels = [None] * len(odo.map_state)
    levels[odo.registration.level_index] = c["level"]
    assemble = odo.backend.assemble
    step = odo.backend.step
    state0 = ct_ba.CTBAState(*c["args"][3:7])

    def run_assemble():
        return assemble(levels, *c["args"], c["radius"], c["edge_alpha"])

    def run_steps():
        return step(state0, c["problem"])[0]

    halves = {}
    for name, fn in (("assemble", run_assemble), ("steps", run_steps)):
        dev_ms, how = time_stateless(fn)
        host_ms, _ = time_host(fn)
        halves[name] = dict(device_ms=dev_ms, timing=how, host_ms=host_ms)
    on["refine_halves"] = halves
    f, k = c["args"][0].shape[:2]
    log(f"  refine halves at F={f} K={k} (frame {c['frame']}): "
        f"{json.dumps(halves)}")
    log(f"  {on['frames']} frames, batch {on['batch']}: {on['tr_pct']:.4f} "
        f"%Tr (bound {gates.BACKEND_TR_BOUND_PCT}; backend off "
        f"{off['tr_pct']:.4f}), {on['refinements']} refinements, median "
        f"refine {on['refine_ms_median']:.3f} ms on the host; median "
        f"frames/s backend on {on['median_batch_fps']:.2f}, off "
        f"{off['median_batch_fps']:.2f}; host syncs a frame on "
        f"{on['host_syncs_per_frame']:.4f}, off "
        f"{off['host_syncs_per_frame']:.4f}, event waits a frame "
        f"{on['event_waits_per_frame']:.4f}; K8 launches "
        f"{launches['ct_ba_block']}")
    if on["failures"]:
        raise RuntimeError(f"backend gate: {on['failures']} failed frames")
    if not on["refinements"] > 0:
        raise RuntimeError("backend gate: no refinement")
    if not on["tr_pct"] <= gates.BACKEND_TR_BOUND_PCT:
        raise RuntimeError(f"backend gate: {on['tr_pct']} %Tr > "
                           f"{gates.BACKEND_TR_BOUND_PCT}")
    _require_launches("backend gate", launches,
                      ["candidate_gather", "plane_moments", "map_insert",
                       "lm_step", "ct_ba_block"])
    # two CT-BA steps of two inner iterations, folded into one step of
    # four: one K8 launch a refine
    if launches["ct_ba_block"] != on["refine_dispatches"]:
        raise RuntimeError(f"backend gate: {launches['ct_ba_block']} K8 "
                           f"launches for {on['refine_dispatches']} refines")
    if off["launches"]["ct_ba_block"]:
        raise RuntimeError("backend off: K8 launched")
    if not on["host_syncs_per_frame"] < on["lm_steps"] / on["frames"]:
        raise RuntimeError("backend gate: a host sync per LM step")
    if on["event_waits"] > on["refine_dispatches"]:
        raise RuntimeError("backend gate: more event waits than refines")
    del odo
    return runs, capture


def _kernel_k8(problem, poses, mode, tag, iters=1):
    """K8 against its plain version in ``mode`` (``iters`` inner iterations
    in one launch) on a window of the backend, then timed: a CUDA graph of
    20 calls, and with its host side (events around the wrapper); the plain
    version with its host side."""
    beta = gates.backend_profile(True).backend.continuity_beta
    damping = 1e-3
    err = checks.check_ct_ba_block(poses, problem, beta, damping, mode,
                                   iters=iters)

    def call():
        return k8.ct_ba_block(poses, problem, beta, damping, mode, iters)

    ms, how = time_stateless(call)
    host_ms, _ = time_host(call)
    plain_ms, _ = time_host(lambda: k8.ct_ba_block_plain(
        poses, problem, beta, damping, mode, iters), reps=5)
    f, k = problem.raw.shape[:2]
    live = int((problem.weights != 0).sum())
    # every row's weight read, the live rows' 40 other bytes, the poses,
    # priors, prior weights and edge alphas read once; the outputs
    n_bytes = (f * k * 4 + live * 40 + f * (14 + 14 + 2) * 4
               + f * ((14 if mode == "gn" else 0) + 1 + 144 + 12) * 4 + 4)
    branch, angle = _slerp_branch(torch.cat([poses[0], torch.zeros(
        k5.STATE_SIZE - 14, device=poses.device)]))
    ops = iters * live * float(_ct_ba_row_ops(branch))
    cluster = k8.cluster_size(f, k, poses.device, waits=False)
    log(f"K8 ct_ba_block {tag} mode={mode} x{iters} F={f} K={k} live={live} "
        f"({branch} on frame 0, {angle:.4f} deg; clusters of {cluster}): "
        f"within tolerance ({json.dumps(err)}); {ms:.4f} ms on the device "
        f"({how}), {host_ms:.4f} ms with its host side, plain "
        f"{plain_ms:.4f} ms")
    return dict(max_abs_err=err["max_abs_err"], ms=ms, plain_ms=plain_ms,
                library_ms=None, bytes=n_bytes, ops=ops, timing=how,
                host_ms=host_ms, rows_live=live, d_tr_m=err.get("d_tr_m"),
                d_rot_deg=err.get("d_rot_deg"), relative=err["relative"],
                jtr_float64=err.get("jtr_float64"), iters=iters,
                cluster=cluster,
                shape=f"F={f} K={k} live={live} mode={mode} iters={iters}")


def _k8_phase_cycles(problem, poses, iters):
    """The clock cycles of each phase of one launch of the -DK8_MARKS
    variant (built in phase 2; the main path never loads it) on the
    backend's window, for ranks 0 and 1 of frame 0."""
    beta = gates.backend_profile(True).backend.continuity_beta
    read = build.launcher("ct_ba_block", "k8_read_marks", (build.PTR,),
                          K8_MARKS)
    cyc = np.zeros(k8.MARK_SLOTS * len(k8.MARK_PHASES), np.int64)
    build.check_status(read(cyc.ctypes.data), "k8_read_marks")
    k8.launch(poses, problem, beta, 1e-3, "gn", iters, defines=K8_MARKS)
    torch.cuda.synchronize()
    build.check_status(read(cyc.ctypes.data), "k8_read_marks")
    out = [dict(zip(k8.MARK_PHASES, r))
           for r in cyc.reshape(k8.MARK_SLOTS, -1).tolist()]
    log(f"K8 phase cycles (gn x{iters}; rank 0, rank 1 of frame 0): "
        f"{json.dumps(out)}")
    return out


def phase_kernels_backend(dev, capture):
    """K8 (the backend's one launch of its 2 steps x 2 inner iterations,
    one iteration, a step of 2, and the blocks mode), K1 (all 27 voxels,
    no compaction) and K2 (no k-NN) against their plain versions at a full
    refine window's shapes, and timed; one launch of the backend's
    iterations against as many launches of one, bit for bit; K8's phase
    split."""
    c = capture
    problem = c["problem"]
    poses = ct_ba.pack_state(ct_ba.CTBAState(*c["args"][3:7]))
    iters = 2 * gates.backend_profile(True).backend.num_steps
    rec = _kernel_k8(problem, poses, "gn", "backend", iters)
    rec["one_launch_equals_chain"] = checks.check_ct_ba_iterations(
        poses, problem, gates.backend_profile(True).backend.continuity_beta,
        1e-3, iters)["max_abs_err"] == 0.0
    rec["phase_cycles"] = _k8_phase_cycles(problem, poses, iters)
    rec["others"] = {
        "gn x1": _kernel_k8(problem, poses, "gn", "backend"),
        "gn x2 (a step)": _kernel_k8(problem, poses, "gn", "backend", 2),
        "blocks": _kernel_k8(problem, poses, "blocks", "backend")}
    records = {"ct_ba_block": rec}
    o = gates.backend_profile(True)
    res = o.map_options.resolutions[0]
    world = ct_ba.interp_world_points(*c["args"][3:7], *c["args"][0:2])
    f, k = world.shape[:2]
    q = world.reshape(f * k, 3).contiguous()
    qv = c["args"][2].reshape(f * k)
    nv = Odometry(o, device=dev).registration.statics.voxel_neighborhood
    records["candidate_gather"], (slots, cnt) = _kernel_k1(
        dev, c["level"], res, q, nv, 1, 0, "backend", query_valid=qv)
    records["plane_moments"] = _kernel_k2(c["level"], q, slots, cnt,
                                          c["radius"], None, "backend")
    del slots, cnt
    torch.cuda.empty_cache()
    return records


def _synthetic_window(dev, f, k, edge_alpha=1.3, seed=0):
    """A CT-BA window shaped like the backend's (``tools/exp_ct_ba.py``'s):
    ``parallel/ct_ba.py::build_synthetic_problem`` with the backend's prior
    weight, the prior poses moved off the state and uniform row weights."""
    rng = np.random.default_rng(seed)
    state, p, _ = ct_ba.build_synthetic_problem(rng, f, k, noise=0.02)

    def moved(x, scale):
        return x + torch.from_numpy(rng.normal(
            scale=scale, size=tuple(x.shape)).astype(np.float32))

    p = p._replace(
        weights=torch.from_numpy(rng.uniform(0.0, 0.5, (f, k)).astype(
            np.float32)),
        prior_tr_begin=moved(p.prior_tr_begin, 0.01),
        prior_tr_end=moved(p.prior_tr_end, 0.01),
        prior_quat_begin=moved(p.prior_quat_begin, 0.003),
        prior_quat_end=moved(p.prior_quat_end, 0.003),
        prior_weight=torch.full((f,), 1.5),
        edge_alpha=torch.full((f,), float(edge_alpha)))
    return (ct_ba.CTBAState(*(x.to(dev) for x in state)),
            ct_ba.CTBAProblem(*(x.contiguous().to(dev) for x in p)))


def _state_gaps(a, b):
    """Largest position (m) and rotation (deg) gaps of two CT-BA states."""
    pa = ct_ba.pack_state(a).double().cpu().numpy()
    pb = ct_ba.pack_state(b).double().cpu().numpy()
    d_tr = float(max(np.abs(pa[:, 4:7] - pb[:, 4:7]).max(),
                     np.abs(pa[:, 11:14] - pb[:, 11:14]).max()))
    d_rot = max(max(s3n.angular_distance_deg(x[0:4], y[0:4]),
                    s3n.angular_distance_deg(x[7:11], y[7:11]))
                for x, y in zip(pa, pb))
    return d_tr, float(d_rot)


def phase_ct_ba_beyond(dev):
    """The CT-BA window beyond the card's residency: the largest window
    whose multi-iteration K8 launch fits at the backend's K = 4,096 and at
    K = 64 (the occupancy API, ``ct_ba_block.max_resident_frames``), and
    whether the reference test's F = 16 fits; make_ct_ba_step's jacobi
    step of two inner iterations over one frame more than fits at K =
    4,096 (counts set to 0 just before it, read just after): two chained
    K8 launches of one iteration, against the CPU run of the same inputs
    (poses within 1e-5 m and 1e-4 deg, the cost within rtol 1e-5), its
    first launch held by the K8 check (``kernels/checks.py``) and its
    second's J^T J against the plain version from the card's first
    iterate (within the check's 1e-4 of its largest entry) and its J^T r
    against that version in float64 (within 10 times the float32 plain
    version's gap to it: a nearly converged gradient's rounding), timed (a CUDA
    graph of 20 steps, and with its host side) beside the plain version on
    the card; and K8 with two iterations in one launch at F = 300, K = 64
    raises before launching."""
    k = 4096
    limits = {kk: k8.max_resident_frames(kk, dev) for kk in (k, 64)}
    f = limits[k] + 1
    beta = gates.backend_profile(True).backend.continuity_beta
    damping = 1e-3
    state, problem = _synthetic_window(dev, f, k)
    step = ct_ba.make_ct_ba_step(num_inner_iters=2, beta=beta)
    _reset_counts()
    got, cost = step(state, problem)
    torch.cuda.synchronize()
    out = {"launches": _read_counts(), "lm_steps": _read_steps(),
           "max_resident_frames": limits,
           "reference_f16_fits": k8.resident(16, k, dev), "frames": f}
    if out["launches"]["ct_ba_block"] != 2:
        raise RuntimeError(f"CT-BA step at F = {f}: "
                           f"{out['launches']['ct_ba_block']} K8 launches, "
                           f"not 2 chained")
    want, want_cost = step(ct_ba.CTBAState(*(x.cpu() for x in state)),
                           ct_ba.CTBAProblem(*(x.cpu() for x in problem)))
    d_tr, d_rot = _state_gaps(got, want)
    cost_rel = abs(float(cost) - float(want_cost)) / abs(float(want_cost))
    if not (d_tr <= 1e-5 and d_rot <= 1e-4 and cost_rel <= 1e-5):
        raise RuntimeError(f"CT-BA step at F = {f} against the CPU: poses "
                           f"{d_tr:.3g} m, {d_rot:.3g} deg, cost "
                           f"{cost_rel:.3g}")
    poses = ct_ba.pack_state(state)
    # the chain's first launch against the plain version (the K8 check,
    # from the window's poses), its second's J^T J from the first iterate
    err = checks.check_ct_ba_block(poses, problem, beta, damping, "gn")
    first = k8.ct_ba_block(poses, problem, beta, damping, "gn").poses
    second = k8.ct_ba_block(first, problem, beta, damping, "gn")
    plain_2 = k8.ct_ba_block_plain(first, problem, beta, damping, "gn")
    jtj_2 = checks._rel_err(second.jtj, plain_2.jtj)
    if not jtj_2 <= 1e-4:
        raise RuntimeError(f"CT-BA step at F = {f}: the second launch's "
                           f"J^T J {jtj_2:.3g} of its largest entry off")
    # the second launch's J^T r is a nearly converged window's gradient,
    # whose float32 sums round by 1e-4 of its largest entry: the kernel's
    # and the plain version's gaps to the plain version in float64 from
    # the same iterate, the kernel's held within 10 times the plain one's
    p64 = ct_ba.CTBAProblem(*(x.double() if x.is_floating_point() else x
                              for x in problem))
    jtr_64 = k8.ct_ba_block_plain(first.double(), p64, beta, damping,
                                  "gn").jtr
    jtr_2 = {"kernel_vs_plain": checks._rel_err(second.jtr, plain_2.jtr),
             "kernel_vs_float64": checks._rel_err(second.jtr.double(),
                                                  jtr_64),
             "plain_vs_float64": checks._rel_err(plain_2.jtr.double(),
                                                 jtr_64)}
    if not jtr_2["kernel_vs_float64"] <= max(
            10 * jtr_2["plain_vs_float64"], 1e-6):
        raise RuntimeError(f"CT-BA step at F = {f}: the second launch's "
                           f"J^T r off the float64 version {jtr_2}")
    ms, how = time_stateless(lambda: step(state, problem))
    host_ms, _ = time_host(lambda: step(state, problem))
    plain_ms, _ = time_host(lambda: k8.ct_ba_block_plain(
        poses, problem, beta, damping, "gn", 2), reps=3)
    big_state, big = _synthetic_window(dev, 300, 64)
    before = k8.launches
    try:
        k8.ct_ba_block(ct_ba.pack_state(big_state), big, beta, damping, "gn",
                       2)
    except ValueError as e:
        if "resident" not in str(e):
            raise
    else:
        raise RuntimeError("K8 with 2 iterations at F = 300 did not raise")
    if k8.launches != before:
        raise RuntimeError("K8 launched before raising at F = 300")
    live = int((problem.weights != 0).sum())
    branch, _ = _slerp_branch(torch.cat([poses[0], torch.zeros(
        k5.STATE_SIZE - 14, device=dev)]))
    rec = dict(max_abs_err=err["max_abs_err"], ms=ms, plain_ms=plain_ms,
               library_ms=None, timing=how, host_ms=host_ms, iters=2,
               bytes=f * k * 4 + live * 40 + f * (14 + 14 + 2) * 4
               + f * (14 + 1 + 144 + 12) * 4 + 4,
               ops=2 * live * float(_ct_ba_row_ops(branch)), rows_live=live,
               d_tr_m=d_tr, d_rot_deg=d_rot, relative=err["relative"],
               cluster=16, shape=f"F={f} K={k} live={live} mode=gn iters=2 "
                                 f"(two chained launches)")
    out.update(d_tr_m=d_tr, d_rot_deg=d_rot, cost_rel=cost_rel,
               check=err["relative"], second_jtj=jtj_2, second_jtr=jtr_2,
               f300_raises=True)
    log(f"CT-BA beyond residency: largest resident window {limits} "
        f"(K: frames), the reference's F = 16 at K = {k} "
        f"{'fits' if out['reference_f16_fits'] else 'does not fit'}; "
        f"the jacobi step of 2 at F = {f}: 2 chained K8 launches, poses "
        f"{d_tr:.3g} m / {d_rot:.3g} deg and cost {cost_rel:.3g} from the "
        f"CPU run; the first launch's J^T J {err['relative']['jtj']:.3g} "
        f"and J^T r {err['relative']['jtr']:.3g} of their largest entries "
        f"from the plain version, the second's J^T J {jtj_2:.3g} and J^T r "
        f"{json.dumps(jtr_2)}; "
        f"{ms:.4f} ms on the device ({how}), "
        f"{host_ms:.4f} with its host side, plain {plain_ms:.4f}; two "
        f"iterations in one launch at F = 300 raise before launching")
    return out, rec


def phase_robust_rebase(dev, robust_run, robust_out):
    """Phase 5's robust corridor again (the same prepared frames) with the
    rebase distance at 20 m: the speculative streamer defers its rebases
    until no batch is in flight."""
    ref_odo, frames, preps = robust_run
    odo = Odometry(robust_driving_profile(), device=dev)
    odo.rebase_distance = ROBUST_REBASE_DISTANCE
    captured = {}
    _capture_first_rebase(odo, captured)
    _reset_counts()
    summaries, batch_s, wall = _stream(odo, preps, ROBUST_BATCH)
    launches, lm_steps = _read_counts(), _read_steps()
    out, _ = _path_stats(odo, frames, preps, summaries, batch_s, wall)
    diff = max(a.end_pose.location_distance(b.end_pose) for a, b in
               zip(odo.get_trajectory(), ref_odo.get_trajectory()))
    out.update(batch=ROBUST_BATCH, launches=launches, lm_steps=lm_steps,
               rebases=odo.rebases,
               rebase_distance_m=ROBUST_REBASE_DISTANCE,
               max_end_pose_diff_from_robust_m=diff,
               first_rebase_capture_host_s=captured.get("capture_host_s"),
               robust_mean_ape_m=robust_out["mean_ape_m"],
               speculative_batches_committed={
                   str(k): v for k, v in
                   odo.speculative_batches_committed.items()},
               speculative_prefix_commits=odo.speculative_prefix_commits,
               speculative_rollbacks=odo.speculative_rollbacks)
    log("robust rebase path: " + json.dumps(out))
    log(f"  {odo.rebases} rebases; mean APE {out['mean_ape_m']:.4f} m "
        f"(without rebases {robust_out['mean_ape_m']:.4f} m); end poses at "
        f"most {diff:.4f} m from phase 5's")
    if out["failures"]:
        raise RuntimeError(f"robust rebase path: {out['failures']} failed "
                           "frames")
    if not out["mean_ape_m"] <= APE_SMOKE_BOUND_M:
        raise RuntimeError(f"robust rebase path: mean APE "
                           f"{out['mean_ape_m']} m > {APE_SMOKE_BOUND_M} m")
    if odo.rebases < 2:
        raise RuntimeError(f"robust rebase path: {odo.rebases} rebases < 2")
    _require_launches("robust rebase", launches, ["candidate_gather",
                                                  "plane_moments",
                                                  "map_insert", "lm_step",
                                                  "row_gather",
                                                  "rebuild_claim"])
    _require_rebase_launches("robust rebase", launches, odo.rebases,
                             len(odo.map_state))
    del odo
    torch.cuda.empty_cache()
    return out, captured


def phase_indoor(dev):
    """The handheld indoor walk (seed 7, its 240 frames, batch 4) through
    Odometry(default_robust_outdoor_low_inertia()).stream_frames: the
    port's three-level map, its speculative streamer escalating on every
    doorway turn (the device keypoint election, K4). Then, on the map the
    walk left, the costs that grow with three levels: the checkpoint's
    clone of the map (``pipeline.snapshot``, once a speculative batch) and
    the plain ``prune_level`` over each level."""
    acq = iw.load_acquisition(INDOOR_SEED)
    odo = Odometry(default_robust_outdoor_low_inertia(), device=dev)
    election = {}
    elect = smp.voxel_subsample_indices

    def spy(points, valid, *args, **kw):
        # a copy of the first escalated attempt's election inputs, for
        # K4's check at the walk's own shape after the path
        if not election:
            election.update(points=points.clone(), valid=valid.clone(),
                            args=args, kw=kw, frame=len(odo.trajectory))
        return elect(points, valid, *args, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    smp.voxel_subsample_indices = spy
    _reset_counts()
    try:
        out = stream_acquisition(odo, acq, iw.INDOOR_FRAMES, iw.INDOOR_BATCH,
                                 driving=False)
    finally:
        smp.voxel_subsample_indices = elect
    launches, lm_steps = _read_counts(), _read_steps()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    levels = odo.map_state
    map_gb = sum(t.numel() * t.element_size() for lv in levels
                 for t in lv) / 1e9
    out.update(launches=launches, lm_steps=lm_steps, seed=INDOOR_SEED,
               map_points_by_level=[int(lv.num_points[0]) for lv in levels],
               map_gb=map_gb, peak_device_memory_gb=peak_gb,
               speculative_batches_committed={
                   str(k): v for k, v in
                   odo.speculative_batches_committed.items()},
               speculative_prefix_commits=odo.speculative_prefix_commits,
               speculative_rollbacks=odo.speculative_rollbacks)
    # the checkpoint's clone of the three levels, and the plain prune of
    # each (the walk's frames lie within max_distance: it prunes nothing,
    # but reads every slot)
    out["snapshot_ms"] = time_host(
        lambda: pl.snapshot(levels, odo._odo_state), reps=5)[0]
    loc = torch.zeros(3, device=dev)
    out["prune_level_ms"] = [time_mutating(
        lambda lv=lv: _level_copy(lv),
        lambda lv2: vm.prune_level(lv2, loc, odo.options.max_distance))[0]
        for lv in levels]
    batch_ms = (iw.INDOOR_BATCH / out["median_batch_fps"] * 1e3
                if out["median_batch_fps"] else None)
    out["snapshot_share_of_batch"] = (out["snapshot_ms"] / batch_ms
                                      if batch_ms else None)
    log("indoor walk: " + json.dumps(out))
    log(f"  {out['frames']} frames, batch {out['batch']}: {out['tr_pct']:.4f}"
        f" %Tr (INDOOR segments; the gate is the mean of seeds "
        f"{iw.INDOOR_SEEDS} <= {iw.INDOOR_TR_BOUND_PCT}), mean APE "
        f"{out['mean_ape_m']:.4f} m, {out['mean_attempts']:.3f} attempts a "
        f"frame, {out['host_syncs_per_frame']:.3f} host syncs a frame, "
        f"median {out['median_batch_fps']:.2f} frames/s, K1-K5 launches "
        f"{[launches[k] for k in K1_K5]}; map {map_gb:.3f} GB in three "
        f"levels, device memory peak {peak_gb:.3f} GB; the checkpoint's "
        f"clone {out['snapshot_ms']:.4f} ms "
        f"({out['snapshot_share_of_batch']:.4f} of a median batch), "
        f"prune_level by level "
        f"{[round(x, 4) for x in out['prune_level_ms']]} ms")
    if out["failures"]:
        raise RuntimeError(f"indoor walk: {out['failures']} failed frames")
    if not out["mean_ape_m"] <= APE_SMOKE_BOUND_M:
        raise RuntimeError(f"indoor walk: mean APE {out['mean_ape_m']} m > "
                           f"{APE_SMOKE_BOUND_M} m")
    _require_launches("indoor walk", launches, K1_K5)
    # every insert goes to all three levels: three K3 launches at least a
    # registered frame (attempts, re-runs and deferred updates add more)
    if (launches["map_insert"] % len(levels)
            or launches["map_insert"] < len(levels) * out["frames"]):
        raise RuntimeError(f"indoor walk: {launches['map_insert']} K3 "
                           f"launches for {out['frames']} frames and "
                           f"{len(levels)} levels")
    if not out["host_syncs_per_frame"] < out["lm_steps"] / out["frames"]:
        raise RuntimeError("indoor walk: a host sync per LM step")
    if not election:
        raise RuntimeError("indoor walk: no escalated attempt elected "
                           "keypoints on the device")
    del odo, levels
    torch.cuda.empty_cache()
    return out, election


def phase_kernels_indoor(dev, election):
    """K1-K5 against their plain versions at the indoor walk's shapes:
    K5 on the first LM call of walk frame K5_INDOOR_FRAME (the low-inertia
    profile: 600 residuals at most, 10 LM steps, WeightingScheme.ALL), on
    the per-frame path; K1 and K2 on the searched level (1: 0.5 m, P = 40,
    C = 2^19) of the three-level map that frames [0, K] built, with frame
    K + 1's keypoints placed by frame K's end pose as queries; K3 on each of
    the three levels (0.2 m x 50 at 2^20, 0.5 m x 40 at 2^19, 1.5 m x 40 at
    2^17, each with its own min distance) inserting frame K + 1's points,
    so placed, with the round budget the path gives that frame; K4 on the
    walk's first escalated election (its sub-sample, its fs[1] voxel and
    keypoint capacity, captured by ``phase_indoor``). Returns {name:
    {tag: partial record}}."""
    o = default_robust_outdoor_low_inertia()
    acq = iw.load_acquisition(INDOOR_SEED)
    k = K5_INDOOR_FRAME
    odo = Odometry(o, device=dev)
    preps = []
    for i in range(k + 2):
        fr = acq.frame(i)
        preps.append(odo.prepare_frame(fr["xyz"], fr["timestamps"], i,
                                       frame_id=i))
    records = {"lm_step": {"indoor": _kernel_k5(
        dev, _path_lm_call(odo, preps, k), f"indoor frame {k}")}}
    levels = odo.map_state
    ress = o.map_options.resolutions
    statics = odo.registration.statics
    icp = o.ct_icp_options
    pose = odo.get_trajectory()[-1].end_pose
    nxt = preps[k + 1]
    world = torch.as_tensor(pose.apply(nxt["xyz"]), dtype=torch.float32,
                            device=dev)
    li = statics.level_index
    log(f"indoor map after frame {k}: level sizes "
        f"{[int(lv.num_points[0]) for lv in levels]}, searched level {li}; "
        f"frame {k + 1}: {nxt['n']} points, {nxt['kp_n']} keypoints")
    q = world[:nxt["kp_n"]].contiguous()
    cg, (slots, cnt) = _kernel_k1(
        dev, levels[li], ress[li], q, statics.voxel_neighborhood,
        icp.threshold_voxel_occupancy, statics.max_candidate_voxels,
        f"indoor level {li}")
    records["candidate_gather"] = {"indoor": cg}
    records["plane_moments"] = {"indoor": _kernel_k2(
        levels[li], q, slots, cnt, float(o.map_options.default_radius),
        icp.max_number_neighbors, f"indoor level {li}")}
    del slots, cnt
    rounds = (o.bootstrap_insert_rounds if k + 1 < o.bootstrap_frames
              else 4)
    records["map_insert"] = {
        "indoor" if i == 0 else f"indoor level {i}": _kernel_k3(
            dev, lv, res, {"xyz": world}, rounds, f"indoor level {i}")
        for i, (lv, res) in enumerate(zip(levels, ress))}
    del odo, levels, world, q
    torch.cuda.empty_cache()
    voxel, capacity, *rest = election["args"]
    records["grid_sample"] = {"indoor": _kernel_k4(
        dev, election["points"], election["valid"], voxel, capacity,
        *rest, **election["kw"], tag=f"indoor escalated election (frame "
        f"{election['frame']}, voxel {voxel} m)")}
    return records


def _kernel_k6(table, slots, sub, tag, library=True):
    """K6 against its plain version; times with the L2 flushed before each
    call (``ms``, as the rebase finds the map) and back to back in a CUDA
    graph (``warm_ms``: rows and output stay in L2 where they fit)."""
    checks.check_row_gather(table, slots, sub)
    ms, how = time_cold(lambda: k6.row_gather(table, slots, sub))
    warm_ms, _ = time_stateless(lambda: k6.row_gather(table, slots, sub))
    plain_ms, _ = time_cold(lambda: k6.row_gather_plain(table, slots, sub))
    lib_ms = lib_warm_ms = None
    if library:        # the same function: every slot valid, no sub
        idx = slots.long()
        lib_ms, _ = time_cold(lambda: table.index_select(0, idx))
        lib_warm_ms, _ = time_stateless(lambda: table.index_select(0, idx))
    n, w = slots.shape[0], table.shape[1]
    n_bytes = k6_bytes(table, slots, sub)
    n_rows = int(((slots >= 0) & (slots < table.shape[0])).sum())
    log(f"K6 row_gather {tag} N={n} W={w}: identical to plain; {ms:.4f} ms "
        f"({how}; {warm_ms:.4f} ms back to back), plain {plain_ms:.4f} ms, "
        f"index_select {'-' if lib_ms is None else f'{lib_ms:.4f} ms'} "
        f"({'-' if lib_warm_ms is None else f'{lib_warm_ms:.4f} ms'} back "
        f"to back); {n_bytes / ms / 1e6:.1f} GB/s")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bytes=float(n_bytes),
                ops=0.0 if sub is None else n_rows * w * 1.0,
                timing=how, warm_ms=warm_ms, library_warm_ms=lib_warm_ms,
                shape=f"C={table.shape[0]} W={w} N={n} {tag}")


def _rebase_fields(level):
    """K6's tables in the rebase: points, normals, counts, flags."""
    return (level.count[:, None], level.points, level.normals,
            level.nflags[:, None])


def _kernel_rebase(level, shift, res, tag):
    """K7 (table, writers, num_points), K6's one launch over the four
    fields, then the whole rebuild_level (K7 + K6), against the plain
    versions on a real level and shift; times of K7 (and the claim rounds it
    ran), of K6 (and of K6 on the points alone, the rebase's largest field)
    and of the whole rebuild."""
    out = checks.check_rebuild_level(level, shift, res)
    kargs = (level.keys, level.count, level.points, shift, res)
    ms, how = time_cold(lambda: k7.rebuild_claim(*kargs))
    warm_ms, _ = time_stateless(lambda: k7.rebuild_claim(*kargs))
    plain_ms, _ = time_cold(lambda: k7.rebuild_claim_plain(*kargs), reps=3)
    c = level.capacity
    # every key read and every table and writer slot written (12 B a
    # slot); the count of each row with a live key (4 B) and the first
    # point of each occupied row (12 B); num_points (4 B); ~25 operations
    # an occupied row (the shift, the voxel ids, the two hashes)
    live = (level.keys != k3.EMPTY) & (level.keys != k3.TOMB)
    n_live = int(live.sum())
    n_occ = int((live & (level.count > 0)).sum())
    rec7 = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                bytes=12.0 * c + 4.0 * n_live + 12.0 * n_occ + 4,
                ops=25.0 * n_occ, timing=how, warm_ms=warm_ms,
                claim_rounds=out["claim_rounds"],
                shape=f"C={c} P={level.max_points} live={n_live} "
                      f"occupied={n_occ} rows={out['rows']} {tag}")
    _table, src, _ = k7.rebuild_claim(*kargs)
    tables = _rebase_fields(level)
    subs = (None, shift, None, None)
    checks.check_row_gather_fields(tables, src, subs)
    ms6, how6 = time_cold(lambda: k6.row_gather_fields(tables, src, subs))
    warm6, _ = time_stateless(lambda: k6.row_gather_fields(tables, src, subs))
    plain6, _ = time_cold(
        lambda: k6.row_gather_fields_plain(tables, src, subs))
    n_rows = int(((src >= 0) & (src < c)).sum())
    w = level.points.shape[1]
    rec6 = dict(max_abs_err=0.0, ms=ms6, plain_ms=plain6, library_ms=None,
                bytes=float(k6_fields_bytes(tables, src, subs)),
                ops=float(n_rows * w), timing=how6, warm_ms=warm6,
                shape=f"C={c} W={w}+3+1+1 N={c} rows={n_rows} rebase "
                      f"fields {tag}")
    log(f"K6 row_gather_fields rebase {tag} N={c} W={w}+3+1+1 ({n_rows} "
        f"rows moved): identical to plain; {ms6:.4f} ms ({how6}; "
        f"{warm6:.4f} ms back to back), plain {plain6:.4f} ms; "
        f"{rec6['bytes'] / ms6 / 1e6:.1f} GB/s")
    points = _kernel_k6(level.points, src, shift, f"rebase points {tag}",
                        library=False)
    whole_ms, _ = time_cold(lambda: vm.rebuild_level(level, shift, res))
    whole_plain_ms, _ = time_cold(
        lambda: checks.plain_rebuild_level(level, shift, res), reps=3)
    log(f"K7 rebuild_claim {tag} C={c}: identical to plain ({out['rows']} "
        f"rows kept of {int((level.count > 0).sum())}, shift "
        f"{shift.tolist()}, {out['claim_rounds']} claim rounds run); "
        f"{ms:.4f} ms ({how}; {warm_ms:.4f} ms back to back), plain "
        f"{plain_ms:.4f} ms; the whole rebuild_level {whole_ms:.4f} ms, "
        f"plain {whole_plain_ms:.4f} ms")
    rec7.update(rebuild_level_ms=whole_ms,
                rebuild_level_plain_ms=whole_plain_ms)
    return rec7, rec6, points


def phase_kernels_rebase(dev, long_capture, robust_capture, long_res,
                         robust_res):
    """K7 and K6 on the long drive's and the robust run's maps at their
    first rebase, then K6 at the Pallas kernel's shapes."""
    records = {}
    records["rebuild_claim"], records["row_gather"], points = _kernel_rebase(
        long_capture["level"], long_capture["shift"], long_res, "long drive")
    del long_capture["level"]
    r7, r6, r_points = _kernel_rebase(robust_capture["level"],
                                      robust_capture["shift"], robust_res,
                                      "robust")
    del robust_capture["level"]
    records["rebuild_claim"]["others"] = {"robust": r7}
    records["row_gather"]["others"] = {
        "robust": r6, "points alone (long drive)": points,
        "points alone (robust)": r_points}
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED)
    table = torch.from_numpy(rng.standard_normal(
        (GATHER_C, GATHER_W)).astype(np.float32)).to(dev)
    for n in GATHER_NS:
        for order in ("random", "sorted"):
            s = rng.integers(0, GATHER_C, n)
            s = np.sort(s) if order == "sorted" else s
            slots = torch.from_numpy(s.astype(np.int32)).to(dev)
            records["row_gather"]["others"][f"exp_gather N={n} {order}"] = \
                _kernel_k6(table, slots, None, f"exp_gather {order}")
    del table
    torch.cuda.empty_cache()
    return records


def _capture_first_replay(odo, store):
    """Keep device copies of the first replay's inputs as its device half
    (``Odometry._replay_apply``) receives them: every level before the
    eviction, the uploaded coordinates and points and their row counts (K9
    and the replay's device time are held on them after the path). The
    copies are made inside the path's run: ``capture_host_s``."""
    inner = odo._replay_apply

    def spy(arrays, counts):
        if not store:
            t0 = time.perf_counter()
            store.update(levels=[_level_copy(lv) for lv in odo.map_state],
                         arrays=[a.clone() for a in arrays],
                         counts=list(counts), frame=len(odo.trajectory))
            store["capture_host_s"] = time.perf_counter() - t0
        return inner(arrays, counts)

    odo._replay_apply = spy


def _room_run(on, frames, points, capture=None):
    """The room (seed 47, 5 mm noise, ``points`` a frame) through
    register_frame for ``frames`` frames: the replay gate's options (the
    reference test's front end degraded, at the default profile's
    capacities), the backend ``on`` or off; counts reset just before and
    read just after. Returns (odo, record)."""
    acq = room.make_acquisition(seed=room.REPLAY_SEED, noise=room.REPLAY_NOISE,
                                num_frames=max(frames, 25),
                                points_per_frame=points)
    setup = None
    if capture is not None:
        def setup(odo):
            _capture_first_replay(odo, capture)
    _reset_counts()
    odo, out = gates.run_room(room.replay_options(on), acq, frames,
                              setup=setup)
    out.update(launches=_read_counts(), lm_steps=_read_steps())
    return odo, out


def phase_replay():
    """The backend with replay (tools/bench.py --replay): the reference's
    replay test (tests/test_ct_ba.py:182-224) at the default profile's
    capacities (the three-level map at 2^20 / 2^19 / 2^17 slots, 2^17 scan
    points, 4,096 keypoints), 15 frames of 6,000 points, backend off then on:
    APE on < 0.8 x off, >= 2 refinements, 0 failures, K9 launched once a
    replay (every level in one launch). Then the same room at 60,000 points a
    frame for 60 frames, off then on: 0 failures, >= 2 refinements; APE on and
    off, the replays, the points each evicted and re-inserted, their host ms,
    and the device ms of the first replay's device half (a CUDA graph of K9
    and the inserts on a restored copy of the map). Returns the records, the
    big room's odometry (for the export) and the first replay's inputs."""
    runs = {}
    for name, on in (("off", False), ("on", True)):
        _, runs[name] = _room_run(on, room.REPLAY_FRAMES,
                                  room.POINTS_PER_FRAME)
    on, off = runs["on"], runs["off"]
    bound = room.REPLAY_APE_FACTOR * off["mean_ape_m"]
    log("replay gate, backend on: " + json.dumps(on))
    log("replay gate, backend off: " + json.dumps(off))
    log(f"  {room.REPLAY_FRAMES} frames: APE on {on['mean_ape_m']:.5f} m, "
        f"off {off['mean_ape_m']:.5f} m (on must be < {bound:.5f}), "
        f"{on['refinements']} refinements, {on['replays']} replays")
    if on["failures"] or off["failures"]:
        raise RuntimeError("replay gate: failed frames")
    if not on["mean_ape_m"] < bound:
        raise RuntimeError(f"replay gate: APE on {on['mean_ape_m']} >= "
                           f"{room.REPLAY_APE_FACTOR} x off")
    if on["refinements"] < room.REPLAY_MIN_REFINEMENTS:
        raise RuntimeError("replay gate: fewer than 2 refinements")
    n_lv = len(room.replay_options(True).map_options.resolutions)
    _require_launches("replay gate", on["launches"],
                      ["evict_voxels", "map_insert", "ct_ba_block"])
    if on["launches"]["evict_voxels"] != on["replays"]:
        raise RuntimeError("replay gate: not one K9 launch a replay")
    if off["launches"]["evict_voxels"]:
        raise RuntimeError("backend off: K9 launched")

    big, capture = {}, {}
    odo = None
    for name, on_ in (("off", False), ("on", True)):
        odo, big[name] = _room_run(on_, ROOM_FRAMES, ROOM_POINTS,
                                   capture if on_ else None)
        if not on_:
            del odo
            torch.cuda.empty_cache()
    bon, boff = big["on"], big["off"]
    log("room 60,000 points x 60 frames, backend on: " + json.dumps(bon))
    log("room, backend off: " + json.dumps(boff))
    if bon["failures"] or boff["failures"]:
        raise RuntimeError("room: failed frames")
    if bon["refinements"] < room.REPLAY_MIN_REFINEMENTS:
        raise RuntimeError("room: fewer than 2 refinements")
    if not capture:
        raise RuntimeError("room: no replay")
    # the first replay's device half on a restored copy of the map
    saved = capture["levels"]
    work = [_level_copy(lv) for lv in saved]
    holder = odo.map_state
    odo.map_state = tuple(work)

    def reset():
        for lv, sv in zip(work, saved):
            for t, s in zip(lv, sv):
                t.copy_(s)

    try:
        dev_ms, how = time_graph(reset, lambda: odo._replay_apply(
            capture["arrays"], capture["counts"]))
    finally:
        odo.map_state = holder
    bon["first_replay_device_ms"] = dev_ms
    bon["first_replay_timing"] = how
    bon["first_replay_frames"] = len(capture["counts"]) - n_lv
    bon["capture_host_s"] = capture["capture_host_s"]
    log(f"  room: APE on {bon['mean_ape_m']:.5f} m, off "
        f"{boff['mean_ape_m']:.5f} m; {bon['refinements']} refinements, "
        f"{bon['replays']} replays, points evicted "
        f"{bon['replay_evicted']}, re-inserted {bon['replay_inserted']}; "
        f"replay host ms median "
        f"{float(np.median(bon['replay_host_ms'])):.2f}; the first "
        f"replay's device half {dev_ms:.4f} ms ({how}); frames/s on "
        f"{bon['frames_per_sec']:.2f}, off {boff['frames_per_sec']:.2f}")
    return {"gate_on": on, "gate_off": off, "room_on": bon,
            "room_off": boff}, odo, capture


def _k9_bytes(level, coords, n_valid, found, flags):
    """K9's bytes on one level: each valid flag read (``flags``: the
    single-level call's mask), each listed coordinate read with its 16-byte
    key window, each found slot's count read and count and flag written,
    num_points."""
    return (coords.shape[0] if flags else 0) + n_valid * (12 + 16) \
        + found * 12 + 8


def _k9_times(call, reset, job, blocks):
    """K9's own time on the card (the profiler's kernel duration of
    ``job``, (fn, args, restore), in a process whose first trace is
    recent, each traced call on
    the levels restored), a CUDA graph of 20 calls on an already evicted copy
    (eviction is idempotent: the same probes and stores, nothing removed),
    the graph of one call between events after a restore (which holds the
    graph's submission), and an empty kernel on the same grid the first two
    ways: the floor of each method."""
    (ms, how), (floor_ms, _) = _traced("K9", [
        ("ms",) + job, ("ms", k9.empty_launch, (blocks,), None)])
    sub_ms, _ = time_graph(reset, call)
    reset()
    g20, _ = time_stateless(call)
    floor_g20, _ = time_stateless(lambda: k9.empty_launch(blocks))
    return dict(ms=ms, timing=how, graph20_ms=g20, with_submission_ms=sub_ms,
                floor_ms=floor_ms, floor_graph20_ms=floor_g20)


def _restored(works, levels):
    """(dsts, srcs): the tensors an eviction updates in ``works`` and their
    values in ``levels``."""
    fields = ("count", "nflags", "num_points")
    return ([getattr(w, f) for w in works for f in fields],
            [getattr(lv, f) for lv in levels for f in fields])


def _restore(works, levels):
    def reset():
        copy_into(*_restored(works, levels))
    return reset


def _kernel_k9(levels, coords, counts):
    """K9 against its plain version on the first replay's evict lists, all
    levels in one launch (the replay's call), then timed (``_k9_times``),
    with its host side, and the plain version."""
    err = checks.check_evict_levels(levels, coords, counts)
    works = [_level_copy(lv) for lv in levels]
    reset = _restore(works, levels)

    def call():
        return vm.evict_levels(works, coords, counts)

    times = _k9_times(call, reset, (vm.evict_levels, (works, coords, counts),
                                    _restored(works, levels)),
                      k9.grid_blocks(counts))
    host_ms, _ = time_mutating(lambda: reset() or works, lambda _w: call())
    plains = [_level_copy(lv) for lv in levels]
    plain_ms, _ = time_host(lambda: k9.evict_levels_plain(
        [vm.MapLevel(lv.keys, lv.count.clone(), lv.points, lv.normals,
                     lv.nflags.clone(), lv.num_points.clone())
         for lv in plains], coords, counts), reps=5)
    n_bytes, shapes = 0, []
    for li, (lv, c, n) in enumerate(zip(levels, coords, counts)):
        after = _level_copy(lv)
        vm.evict_levels([after], [c], [n])
        found = int(((lv.count > 0) & (after.count == 0)).sum())
        n_bytes += _k9_bytes(lv, c, n, found, flags=False)
        shapes.append(f"C={lv.capacity} M={c.shape[0]} valid={n} "
                      f"emptied={found}")
    log(f"K9 evict_voxels, every level in one launch: {'; '.join(shapes)}, "
        f"removed {err['removed']}: identical; {times['ms']:.4f} ms on the "
        f"device ({times['timing']}), a graph of 20 on an evicted copy "
        f"{times['graph20_ms']:.4f} ms a call, one call with its graph's "
        f"submission {times['with_submission_ms']:.4f}; an empty kernel of "
        f"the grid {times['floor_ms']} ms (profiler), "
        f"{times['floor_graph20_ms']:.4f} (graph of 20); {host_ms:.4f} ms "
        f"with its host side, plain {plain_ms:.4f} ms")
    return dict(max_abs_err=0.0, plain_ms=plain_ms, library_ms=None,
                bytes=n_bytes, ops=0.0, host_ms=host_ms,
                removed=err["removed"], shape=" | ".join(shapes), **times)


def _kernel_k9_level(level, coords, valid, tag):
    """K9 on one level's evict list with its mask (the single-level call),
    against its plain version and timed as ``_kernel_k9``."""
    err = checks.check_evict_voxels(level, coords, valid)
    work = _level_copy(level)
    reset = _restore([work], [level])

    def call():
        return vm.evict_voxels(work, coords, valid)

    times = _k9_times(call, reset, (vm.evict_voxels, (work, coords, valid),
                                    _restored([work], [level])),
                      k9.grid_blocks([coords.shape[0]]))
    plain = _level_copy(level)
    plain_ms, _ = time_host(lambda: k9.evict_voxels_plain(
        plain.keys, plain.count.clone(), plain.nflags.clone(),
        plain.num_points.clone(), coords, valid), reps=5)
    m, n_valid = coords.shape[0], int(valid.sum())
    found = err["emptied"]
    log(f"K9 evict_voxels {tag}: M = {m} ({n_valid} valid, {found} slots "
        f"emptied, {err['removed']} points): identical; {times['ms']:.4f} ms "
        f"on the device ({times['timing']}), graph of 20 "
        f"{times['graph20_ms']:.4f}, floor {times['floor_ms']} / "
        f"{times['floor_graph20_ms']:.4f}; plain {plain_ms:.4f} ms")
    return dict(max_abs_err=0.0, plain_ms=plain_ms, library_ms=None,
                bytes=_k9_bytes(level, coords, n_valid, found, flags=True),
                ops=0.0, shape=f"C={level.capacity} M={m} valid={n_valid} "
                               f"emptied={found} removed={err['removed']}",
                **times)


def _kernel_k10(level, location, tag, slots=None):
    """K10 against its plain version on a list of a level's slots (its
    occupied slots, the export's list, by default), then timed: the
    profiler's kernel duration, a CUDA graph of 20 calls, an empty kernel
    of the same grid both ways, and with its host side; the plain
    version."""
    if slots is None:
        slots = vm.occupied_slots(level)
    err = checks.check_level_normals(level, location, slots)

    def call():
        return vm.refit_normals(level, location, slots)

    (ms, how), (floor_ms, _) = _traced(f"K10 {tag}", [
        ("ms", vm.refit_normals, (level, location, slots), None),
        ("ms", k10.empty_launch, (slots.shape[0],), None)])
    g20, _ = time_stateless(call)
    floor_g20, _ = time_stateless(lambda: k10.empty_launch(slots.shape[0]))
    host_ms, _ = time_host(call)
    plain_ms, _ = time_host(lambda: k10.level_normals_plain(
        level.keys, level.count, level.points, level.normals, level.nflags,
        location, slots), reps=5)
    p, s = level.max_points, slots.shape[0]
    listed = slots.long()
    refit = k10.refit_mask(level.keys[listed], level.count[listed])
    live = int(level.count[listed][refit].clamp_max(p).sum())
    n_refit = int(refit.sum())
    # each listed slot's index, key and count read and normal and flag
    # written, the normal and flag of each listed slot not refit read, each
    # refit slot's live points
    n_bytes = s * 28 + (s - n_refit) * 16 + live * 12
    # 3 differences and 9 products and sums a point, ~400 operations of
    # the eigensolve and orientation a slot
    ops = live * 21.0 + n_refit * 400.0
    lanes = k10.lanes(s)
    log(f"K10 level_normals {tag}: C = {level.capacity}, P = {p}, {s} "
        f"slots listed ({lanes} lanes a queued slot), {n_refit} refit "
        f"({live} points, "
        f"{err['left_out']} left out of the normal comparison): within "
        f"tolerance ({json.dumps(err)}); {ms:.4f} ms on the device ({how}), "
        f"a graph of 20 {g20:.4f} ms a call; an empty kernel of the grid "
        f"{floor_ms:.4f} / {floor_g20:.4f}; {host_ms:.4f} ms with its host "
        f"side, plain {plain_ms:.4f} ms")
    return dict(max_abs_err=err["max_abs_err"], ms=ms, plain_ms=plain_ms,
                library_ms=None, bytes=n_bytes, ops=ops, timing=how,
                graph20_ms=g20, floor_ms=floor_ms, floor_graph20_ms=floor_g20,
                host_ms=host_ms, left_out=err["left_out"], lanes=lanes,
                shape=f"C={level.capacity} P={p} listed={s} "
                      f"refit={n_refit} points={live}")


def phase_export(odo):
    """The map export of the 60,000-point room's map: get_map_points on
    each level, one K10 launch each (counts reset before, read after);
    finite points and normals, as many as the level holds, the refit
    normals of unit length."""
    out = {"levels": []}
    _reset_counts()
    t0 = time.perf_counter()
    for li, level in enumerate(odo.map_state):
        pn = odo.get_map_points(li)
        n = int(level.num_points[0])
        if pn.shape != (n, 6) or not np.isfinite(pn).all() or n == 0:
            raise RuntimeError(f"export level {li}: {pn.shape} for {n} points")
        norms = np.linalg.norm(pn[:, 3:6], axis=1)
        unit = float(np.mean(np.abs(norms - 1.0) < 1e-4))
        out["levels"].append({"points": n, "unit_normal_share": unit})
    out["host_s"] = time.perf_counter() - t0
    out["launches"] = _read_counts()
    out["lm_steps"] = _read_steps()
    log("export: " + json.dumps(out))
    if out["launches"]["level_normals"] != len(odo.map_state):
        raise RuntimeError("export: not one K10 launch a level")
    return out


def phase_kernels_replay(dev, odo, capture):
    """K9 on the first replay's evict lists (the map as that replay found
    it): every level in one launch, as the replay calls it, then each
    level alone with a mask; K10 on each level of the room's map; against
    their plain versions and timed."""
    counts, arrays = capture["counts"], capture["arrays"]
    n_lv = len(capture["levels"])
    records = {"evict_voxels": _kernel_k9(capture["levels"], arrays[:n_lv],
                                          counts[:n_lv])}
    records["evict_voxels"]["others"] = {}
    for li, level in enumerate(capture["levels"]):
        coords = arrays[li]
        valid = torch.arange(coords.shape[0], device=dev) < counts[li]
        records["evict_voxels"]["others"][f"level {li}"] = _kernel_k9_level(
            level, coords, valid, f"level {li}")
    loc = torch.as_tensor(odo.trajectory[-1].end_pose.tr - odo.origin,
                          dtype=torch.float32, device=dev)
    for li, level in enumerate(odo.map_state):
        rec = _kernel_k10(level, loc, f"level {li}")
        if li == 0:
            records["level_normals"] = rec
            rec["others"] = {}
        else:
            records["level_normals"]["others"][f"level {li}"] = rec
    # every refit slot of level 1 and nothing else: the dirty-slot refit's
    # shape
    level = odo.map_state[1]
    occ = vm.occupied_slots(level)
    refit = k10.refit_mask(level.keys[occ.long()], level.count[occ.long()])
    records["level_normals"]["others"]["all-refit (level 1)"] = _kernel_k10(
        level, loc, "all-refit (level 1)", occ[refit].contiguous())
    return records


def phase_header_move():
    """K1 and K2 built from this tree against their outputs before their
    device code moved into csrc/probe.cuh and csrc/eigh3.cuh: the digests
    of tools/exp_header_trees.py's inputs must equal those the build of
    the parent tree gave on the card."""
    res = eht.run_tree(Path(__file__).resolve().parent)
    same = {k: res["digest"][k] == v for k, v in DIGESTS_BEFORE_MOVE.items()}
    log("K1/K2 after the header moves: " + json.dumps(
        {"identical": same, "sass": {k: v for k, v in res.items()
                                     if "sass" in k}}))
    if not all(same.values()):
        raise RuntimeError(f"K1/K2 outputs changed by the header move: {same}")
    return same


def _backend_robust_run(name, opts, frames, batch):
    """``frames`` streamed through Odometry(opts) (a robust profile with the
    backend on) in batches of ``batch``: 0 failures, APE <= 0.10 m,
    refinements >= 1, one callback for each committed frame."""
    fired = []
    _reset_counts()
    odo, summaries, fps = gates._stream(opts, frames, batch, callbacks=fired)
    traj = odo.get_trajectory()
    out = dict(frames=len(frames), batch=batch,
               failures=sum(not s.success for s in summaries),
               mean_ape_m=float(np.mean(cor.seq_ape(odo, frames))),
               refinements=odo.backend.refinements,
               callbacks=len(fired),
               callbacks_in_order=fired == list(range(len(frames))),
               speculative_rollbacks=odo.speculative_rollbacks,
               mean_attempts=float(np.mean([s.number_of_attempts
                                            for s in summaries])),
               median_batch_fps=fps, host_syncs_per_frame=odo.host_syncs
               / len(frames), launches=_read_counts(), lm_steps=_read_steps())
    del traj, odo
    log(f"{name} with the backend: " + json.dumps(out))
    if out["failures"] or not out["mean_ape_m"] <= APE_SMOKE_BOUND_M:
        raise RuntimeError(f"{name} with the backend: {out['failures']} "
                           f"failures, APE {out['mean_ape_m']}")
    if out["refinements"] < 1 or not out["callbacks_in_order"]:
        raise RuntimeError(f"{name} with the backend: {out['refinements']} "
                           f"refinements, callbacks {out['callbacks']} for "
                           f"{len(frames)} frames")
    _require_launches(f"{name} with the backend", out["launches"],
                      ["candidate_gather", "plane_moments", "map_insert",
                       "lm_step", "ct_ba_block"])
    torch.cuda.empty_cache()
    return out


def phase_backend_robust():
    """The robust corridor (phase 5's frames, batch 8) and the escalation
    scene (phase 6's, 3 attempts, batch 8) with the CT-BA backend on. The
    corridor also streams with the backend off, timed the same way (frames
    prepared by prefetch workers inside the timed loop, as the gate
    ``tools/bench.py --backend-robust`` does; phase 5 prepares them before
    it), so that the backend's cost reads from a pair."""
    corridor = cor.render_corridor(cor.build_scene(),
                                   cor.robust_corridor_trajectory(NUM_FRAMES),
                                   NUM_FRAMES, SEED)
    robust = _backend_robust_run("robust corridor",
                                 gates.backend_robust_profile(), corridor,
                                 ROBUST_BATCH)
    odo, summaries, fps = gates._stream(gates.backend_robust_profile(False),
                                        corridor, ROBUST_BATCH)
    robust["backend_off_median_batch_fps"] = fps
    robust["backend_off_failures"] = sum(not s.success for s in summaries)
    log(f"robust corridor with the backend off, timed as with it on: "
        f"median {fps:.2f} frames/s against {robust['median_batch_fps']:.2f} "
        f"on")
    del odo
    esc = cor.render_corridor(cor.build_scene(),
                              cor.escalation_trajectory(ESC_FRAMES),
                              ESC_FRAMES, SEED)
    opts = dataclasses.replace(gates.backend_robust_profile(),
                               robust_num_attempts=3)
    escalation = _backend_robust_run("escalation scene", opts, esc,
                                     ROBUST_BATCH)
    _require_launches("escalation scene with the backend",
                      escalation["launches"], ["grid_sample"])
    return robust, escalation


# ------------------------------------------------------------ scale-out —

def _nccl_group():
    """A world-size-1 NCCL group joined through a FileStore (no network)."""
    import torch.distributed as dist
    SCALE_OUT_STORE.mkdir(parents=True, exist_ok=True)
    store = dist.FileStore(str(SCALE_OUT_STORE / f"nccl-{time.time_ns()}"),
                           1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    return dist.group.WORLD


def _end_gaps(a, b):
    """The position (m) and rotation (deg) gaps, frame by frame, of two
    [F, 7] end pose lists (tr, quat), as the reference's
    ``location_distance`` and ``angular_distance`` measure them."""
    return [(float(np.linalg.norm(x[0:3] - y[0:3])),
             float(s3n.angular_distance_deg(x[3:7], y[3:7])))
            for x, y in zip(a, b)]


def _same_points(a, b, what):
    for i, (x, y) in enumerate(zip(a, b)):
        if x.shape != y.shape or not np.array_equal(x, y):
            raise RuntimeError(f"{what}: level {i}'s points differ "
                               f"({x.shape[0]} and {y.shape[0]} points)")


def phase_scale_out(frames):
    """(a) DistributedOdometry(default_driving_profile()) on the card in a
    world-size-1 NCCL group, the driving phase's 80 frames, once a mode."""
    import torch.distributed as dist
    from ct_icp_torch.parallel.distributed_odometry import \
        DistributedOdometry
    group = _nccl_group()
    warm = DistributedOdometry(default_driving_profile(), group,
                               device="cuda")
    for fr in frames[:2]:
        warm.register_frame(fr["xyz"], fr["timestamps"])
    del warm
    runs, ends, first_maps = {}, {}, {}
    for mode in SCALE_OUT_MODES:
        odo = DistributedOdometry(default_driving_profile(), group,
                                  device="cuda", map_update=mode)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.time()
        for i, fr in enumerate(frames):
            odo.register_frame(fr["xyz"], fr["timestamps"])
            if i == 0:
                # the map after the first frame (no registration: the same
                # points as any shard count inserts), outside the timing
                torch.cuda.synchronize()
                t_snap = time.time()
                first_maps[mode] = scale_out.live_points(
                    convert.map_state_to_numpy(odo.map_state.levels))
                t0 += time.time() - t_snap
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches, lm_steps = _read_counts(), _read_steps()
        errs = scale_out.ape(odo.trajectory, frames)
        out = dict(frames=len(frames), fps=len(frames) / wall, wall_s=wall,
                   host_syncs_per_frame=odo.host_syncs / len(frames),
                   mean_ape_m=float(np.mean(errs)), final_drift_m=errs[-1],
                   map_points=odo.map_size(), dropped=odo.dropped_points,
                   launches=launches, lm_steps=lm_steps,
                   reference_cpu_ape_m=SCALE_OUT_REF_APE_M)
        log(f"scale-out {mode} (NCCL, world size 1): " + json.dumps(out))
        if out["dropped"]:
            raise RuntimeError(f"scale-out {mode}: {out['dropped']} dropped")
        if not out["mean_ape_m"] <= SCALE_OUT_APE_BOUND_M:
            raise RuntimeError(f"scale-out {mode}: mean APE "
                               f"{out['mean_ape_m']} m > "
                               f"{SCALE_OUT_APE_BOUND_M} m")
        _require_launches(f"scale-out {mode}", launches, [
            "candidate_gather", "plane_moments", "map_insert", "grid_sample",
            "lm_step", "level_normals"]
            + (["owner_pack"] if mode == "partitioned" else []))
        ends[mode] = np.array([np.concatenate([f.end_pose.tr,
                                               f.end_pose.quat])
                               for f in odo.trajectory])
        runs[mode] = out
        shard = convert.map_state_to_numpy(odo.map_state.levels)
        runs[mode]["_points"] = scale_out.live_points(shard)
        del odo, shard
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    # both modes store the same map (reference tests/test_sharded_map.py:
    # 103-143)
    _same_points(runs["partitioned"].pop("_points"),
                 runs["broadcast"].pop("_points"),
                 "scale-out world size 1, partitioned vs broadcast")
    # the first frames against the port's own CPU run (the plain versions)
    cpu = DistributedOdometry(default_driving_profile(), device="cpu")
    for fr in frames[:SCALE_OUT_CPU_FRAMES]:
        cpu.register_frame(fr["xyz"], fr["timestamps"])
    cpu_end = np.array([np.concatenate([f.end_pose.tr, f.end_pose.quat])
                        for f in cpu.trajectory])
    gaps = _end_gaps(ends["broadcast"][:SCALE_OUT_CPU_FRAMES], cpu_end)
    d_tr, d_rot = (max(g[i] for g in gaps) for i in (0, 1))
    log(f"scale-out: the first {SCALE_OUT_CPU_FRAMES} frames on the card "
        f"and on the CPU (plain versions) {d_tr:.3g} m, {d_rot:.3g} deg "
        f"apart (bound {SCALE_OUT_CPU_TOL_M} m, {SCALE_OUT_CPU_TOL_DEG} deg)")
    if not (d_tr <= SCALE_OUT_CPU_TOL_M and d_rot <= SCALE_OUT_CPU_TOL_DEG):
        raise RuntimeError("scale-out: the card's first frames leave the "
                           "CPU run's")
    runs["broadcast"]["cpu_gap"] = [d_tr, d_rot]
    return runs, ends, first_maps


def phase_scale_out_ranks(frames, ends, first_maps):
    """(b) two ranks sharing the card over gloo (comm.spawn): the first
    RANK_FRAMES frames in both modes, and the CT-BA step at F = 16 (8
    frames a rank, K = 4,096), block-Jacobi and PCG, against the one-device
    step on the card."""
    from ct_icp_torch.parallel import comm
    state, problem = _synthetic_window(torch.device("cpu"), CT_BA_MESH_F,
                                       4096)
    state_np = convert.ct_ba_to_numpy(state)
    problem_np = convert.ct_ba_to_numpy(problem)
    t0 = time.time()
    ranks = comm.spawn("ct_icp_torch.tools.scale_out:rank_scale_out", 2,
                       SCALE_OUT_STORE,
                       args=(frames[:RANK_FRAMES], SCALE_OUT_MODES,
                             state_np, problem_np, CT_BA_MESH_CONFIGS))
    wall = time.time() - t0
    out = {"ranks": 2, "frames": RANK_FRAMES, "wall_s": wall}
    for mode in SCALE_OUT_MODES:
        got = [r["odometry"][mode] for r in ranks]
        if not np.array_equal(got[0]["end"], got[1]["end"]):
            raise RuntimeError(f"2 ranks {mode}: the ranks' poses differ")
        gaps = _end_gaps(got[0]["end"], ends[mode][:RANK_FRAMES])
        launches = {k: sum(r["launches"].get(k, 0) for r in got)
                    for k in KERNELS}
        out[mode] = dict(d_tr_m=max(g[0] for g in gaps),
                         d_rot_deg=max(g[1] for g in gaps),
                         gaps_by_frame=gaps,
                         bounds_by_frame=[shard_bounds(f)
                                          for f in range(len(gaps))],
                         dropped=sum(r["dropped"] for r in got),
                         launches=launches,
                         fps=RANK_FRAMES / max(r["seconds"] for r in got))
        log(f"2 ranks {mode} (gloo on one card): " + json.dumps(out[mode]))
        for f, (gap, tol) in enumerate(zip(gaps, out[mode][
                "bounds_by_frame"])):
            if not (gap[0] <= tol[0] and gap[1] <= tol[1]):
                raise RuntimeError(
                    f"2 ranks {mode}: frame {f} {gap[0]} m, {gap[1]} deg "
                    f"from world size 1 (bound {tol[0]} m, {tol[1]} deg)")
        if out[mode]["dropped"]:
            raise RuntimeError(f"2 ranks {mode}: points dropped")
        _same_points(scale_out.merge_points([r["first_map"] for r in got]),
                     first_maps[mode],
                     f"2 ranks {mode}: the first frame's map")
        if mode == "partitioned" and not all(
                r["launches"]["owner_pack"] > 0 for r in got):
            raise RuntimeError("2 ranks: a rank never launched owner_pack")
    _same_points(scale_out.union_points(
        [r["odometry"]["partitioned"]["levels"] for r in ranks]),
        scale_out.union_points(
        [r["odometry"]["broadcast"]["levels"] for r in ranks]),
        "2 ranks: partitioned vs broadcast")
    # the CT-BA step on the window's slices against one device
    st, pr = convert.ct_ba_from_numpy(state_np, problem_np, device="cuda")
    for i, cfg in enumerate(CT_BA_MESH_CONFIGS):
        one, cost = ct_ba.make_ct_ba_step(**cfg)(st, pr)
        got = {f: np.concatenate([r["ct_ba"][i]["state"][f] for r in ranks])
               for f in ct_ba.CTBAState._fields}
        got = ct_ba.CTBAState(*(torch.from_numpy(got[f])
                                for f in ct_ba.CTBAState._fields))
        one = ct_ba.CTBAState(*(x.cpu() for x in one))
        d_tr, d_rot = _state_gaps(got, one)
        rel = abs(ranks[0]["ct_ba"][i]["cost"] - float(cost)) / max(
            abs(float(cost)), 1e-30)
        tol_m, tol_deg, tol_cost = CT_BA_MESH_TOL[cfg["solver"]]
        k8_launches = sum(r["ct_ba"][i]["launches"]["ct_ba_block"]
                          for r in ranks)
        clusters = (k8.cluster_size(CT_BA_MESH_F, 4096, torch.device(
            "cuda", 0), False), k8.cluster_size(
            CT_BA_MESH_F // 2, 4096, torch.device("cuda", 0), False))
        rec = dict(d_tr_m=d_tr, d_rot_deg=d_rot, cost_rel=rel,
                   k8_launches=k8_launches, clusters=clusters,
                   bit_for_bit=all(torch.equal(a, b)
                                   for a, b in zip(got, one)))
        out[f"ct_ba {cfg['solver']}"] = rec
        log(f"2 ranks CT-BA {cfg['solver']} F={CT_BA_MESH_F} against one "
            f"device: " + json.dumps(rec))
        if cfg["solver"] == "jacobi" and clusters[0] == clusters[1] \
                and not rec["bit_for_bit"]:
            raise RuntimeError("2 ranks CT-BA jacobi: not bit for bit at the "
                               "same cluster size")
        if not (d_tr <= tol_m and d_rot <= tol_deg and rel <= tol_cost):
            raise RuntimeError(f"2 ranks CT-BA {cfg['solver']}: {rec}")
        if k8_launches <= 0:
            raise RuntimeError("2 ranks CT-BA: K8 never launched")
    out["lm_steps"] = sum(r["odometry"][m]["lm_steps"] for r in ranks
                          for m in SCALE_OUT_MODES)
    out["launches"] = {k: out["broadcast"]["launches"][k]
                       + out["partitioned"]["launches"][k]
                       + sum(r["ct_ba"][i]["launches"].get(k, 0)
                             for r in ranks
                             for i in range(len(CT_BA_MESH_CONFIGS)))
                       for k in KERNELS}
    return out, (state, problem)


def phase_kernels_scale_out(dev, frames, window):
    """(c) K11, K3's rank-0 slots with the refit of the dirty list, and K8's
    halo launch against their plain versions, timed as phase 3 times
    kernels: K11 and K3 at the inputs of the partitioned insert of frame 1
    at world size 1 (the shapes of every partitioned insert there; frame
    1's map is warm) and K11 also at two ranks' shapes; K8 on rank 1's
    slice of (b)'s window."""
    from ct_icp_torch.parallel import sharded_map as shm
    from ct_icp_torch.parallel.distributed_odometry import \
        DistributedOdometry
    seen = {}
    pack, insert = k11.owner_pack, vm.insert_points

    def spy_pack(world, valid, res, n, cap):
        seen.setdefault("k11", []).append((world.clone(), valid.clone(), res,
                                           n, cap))
        return pack(world, valid, res, n, cap)

    def spy_insert(level, pts, valid, res, md, rounds, begin_tr=None,
                   max_dirty=None):
        seen.setdefault("k3", []).append(
            (_level_copy(level), pts.clone(), valid.clone(), res, md, rounds,
             begin_tr.clone(), max_dirty))
        return insert(level, pts, valid, res, md, rounds, begin_tr, max_dirty)

    k11.owner_pack, vm.insert_points = spy_pack, spy_insert
    try:
        odo = DistributedOdometry(default_driving_profile(), device=dev,
                                  map_update="partitioned")
        for fr in frames[:2]:
            odo.register_frame(fr["xyz"], fr["timestamps"])
    finally:
        k11.owner_pack, vm.insert_points = pack, insert
    del odo
    records = {}
    world, valid, res, n, cap = seen["k11"][1]
    records["owner_pack"] = _kernel_k11(world, valid, res, n, cap,
                                        "world size 1", count_ops=True)
    m2 = (world.shape[0] + 1) // 2
    records["owner_pack"]["others"] = {"2 ranks": _kernel_k11(
        world[:m2].contiguous(), valid[:m2].contiguous(), res, 2,
        shm.pair_capacity(m2, 2, 2.0), "2 ranks")}
    records["map_insert"] = _kernel_k3_rank0(*seen["k3"][1])
    state, problem = window
    poses = ct_ba.pack_state(state).to(dev)
    p = ct_ba.CTBAProblem(*(x.to(dev) for x in problem))
    half = CT_BA_MESH_F // 2
    sl = ct_ba.CTBAProblem(*(x[half:].contiguous() for x in p))
    halo = torch.zeros((2, 16), device=dev)
    halo[0, :14], halo[0, 14], halo[0, 15] = \
        poses[half - 1], p.edge_alpha[half - 1], 1.0
    records["ct_ba_block"] = _kernel_k8_halo(poses[half:].contiguous(), sl,
                                             halo)
    return records


def _kernel_k11(world, valid, res, n, cap, tag, count_ops=False):
    """K11 against its plain version (bit for bit, two calls), then timed:
    a CUDA graph of 20 calls, and with its host side; the plain version
    between events; the yardstick ``torch.sort(owner, stable=True)`` on
    the chunk's prebuilt owners (the grouping alone, no scatter; never
    called by the port), a CUDA graph of 20; with ``count_ops``, the
    device operations of one call (one)."""
    out = checks.check_owner_pack(world, valid, res, n, cap)
    args = (world, valid, res, n, cap)
    ms, how = time_stateless(lambda: k11.owner_pack(*args))
    host_ms, _ = time_host(lambda: k11.owner_pack(*args))
    plain_ms, _ = time_host(lambda: k11.owner_pack_plain(*args), reps=10)
    m = world.shape[0]
    owner = torch.where(valid, k11.owners(world, res, n),
                        torch.full((m,), n, device=world.device)
                        ).to(torch.int32)
    library_ms, _ = time_stateless(lambda: torch.sort(owner, stable=True))
    ops = None
    if count_ops:
        ops = _require_ops(f"K11 owner_pack {tag}", _traced("K11", [(
            "ops", k11.owner_pack, args, None)])[0], 1)
    # the chunk read once (points, flags), the send buffers and the
    # dropped count written once
    n_bytes = m * 13 + n * cap * 13 + 4
    log(f"K11 owner_pack {tag} m={m} n={n} cap={cap}: identical to plain "
        f"({out['sent']} sent, {out['dropped']} dropped); {ms:.4f} ms "
        f"({how}), {host_ms:.4f} ms with its host side, plain "
        f"{plain_ms:.4f} ms, torch.sort of the owners {library_ms:.4f} ms")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bytes=n_bytes, ops=m * 12.0,
                timing=how, host_ms=host_ms, device_ops_per_call=ops,
                shape=f"m={m} n={n} cap={cap} sent={out['sent']}")


def _kernel_k3_rank0(level, pts, valid, res, md, rounds, begin_tr,
                     max_dirty):
    """K3 with its rank-0 slots, and the with_normals insert's refit of the
    dirty list (K10), against the plain versions, then timed: K3's launch
    with the slots on a restored copy (events), the plain version the
    same way, and K10 on the dirty list (a CUDA graph of 20)."""
    out = checks.check_insert_with_normals(level, pts, valid, res, md,
                                           rounds, begin_tr, max_dirty)
    ms, how = time_mutating(lambda: _level_copy(level), lambda lv:
                            k3.map_insert(*lv[:3], lv.num_points, pts, valid,
                                          res, md, rounds, rank0=True))
    plain_ms, _ = time_mutating(lambda: _level_copy(level), lambda lv:
                                k3.map_insert_plain(*lv[:3], lv.num_points,
                                                    pts, valid, res, md,
                                                    rounds, rank0=True),
                                reps=5)
    after = _level_copy(level)
    _, r0 = k3.map_insert(*after[:3], after.num_points, pts, valid, res, md,
                          rounds, rank0=True)
    dirty = r0[torch.nonzero(r0 >= 0)[:, 0]][:max_dirty]
    refit_ms, _ = time_stateless(lambda: vm.refit_normals(after, begin_tr,
                                                          dirty))
    n = pts.shape[0]
    # the points and flags read, the rank-0 slots written, the voxels'
    # rows the inserted points land in written (12 B a point) and the
    # slots' counts
    n_bytes = n * 13 + n * 4 + out["inserted"] * 16
    log(f"K3 map_insert with rank-0 slots N={n}: identical to plain "
        f"({out['inserted']} inserted, {out['dirty']} dirty, "
        f"{out['refit']} refit by K10 within its tolerance, "
        f"{out['left_out']} left out); {ms:.4f} ms (restored copy, "
        f"{how}), plain {plain_ms:.4f} ms; K10 on the dirty list "
        f"{refit_ms:.4f} ms")
    return dict(max_abs_err=out["max_abs_err"], ms=ms, plain_ms=plain_ms,
                library_ms=None, bytes=n_bytes, ops=0.0, timing=how,
                dirty=out["dirty"], refit_ms=refit_ms,
                shape=f"N={n} rounds={rounds} P={level.max_points} "
                      f"C={level.capacity} dirty={out['dirty']}")


def _kernel_k8_halo(poses, problem, halo):
    """K8's single-iteration launch with a halo (rank 1's slice of the
    2-rank window) against its plain version, its J^T r against the
    float64 plain version, then timed as ``_kernel_k8`` times."""
    beta, damping = 1.0, 1e-3
    err = checks.check_ct_ba_halo(poses, problem, halo, beta, damping)

    def call():
        return k8.ct_ba_block(poses, problem, beta, damping, "gn", 1, halo)

    ms, how = time_stateless(call)
    host_ms, _ = time_host(call)
    plain_ms, _ = time_host(lambda: k8.ct_ba_block_plain(
        poses, problem, beta, damping, "gn", 1, halo), reps=5)
    f, k = problem.raw.shape[:2]
    live = int((problem.weights != 0).sum())
    n_bytes = (f * k * 4 + live * 40 + f * (14 + 14 + 2) * 4 + 2 * 16 * 4
               + f * (14 + 1 + 144 + 12) * 4 + 4)
    branch, _ = _slerp_branch(torch.cat([poses[0], torch.zeros(
        k5.STATE_SIZE - 14, device=poses.device)]))
    ops = live * float(_ct_ba_row_ops(branch))
    log(f"K8 ct_ba_block halo launch F={f} K={k}: within tolerance "
        f"({json.dumps(err)}); {ms:.4f} ms ({how}), {host_ms:.4f} ms with "
        f"its host side, plain {plain_ms:.4f} ms")
    return dict(max_abs_err=err["max_abs_err"], ms=ms, plain_ms=plain_ms,
                library_ms=None, bytes=n_bytes, ops=ops, timing=how,
                host_ms=host_ms, jtr_float64=err["jtr_float64"],
                d_tr_m=err.get("d_tr_m"), d_rot_deg=err.get("d_rot_deg"),
                shape=f"F={f} K={k} live={live} halo")


class _FirstCall:
    """Between ``start()`` and ``stop()`` (inside a path's run), device
    copies of the arguments of the first call of ``module.name`` (a kernel
    wrapper) for which ``when(*args, **kw)`` holds, kept in ``args`` /
    ``kw`` (about 100 MB where a level's points are among them)."""

    def __init__(self, module, name, when=None):
        self.module, self.name, self.when = module, name, when
        self.inner = getattr(module, name)
        self.args, self.kw = None, None

    def start(self):
        def copy(x):
            return x.clone() if torch.is_tensor(x) else x

        def spy(*args, **kw):
            if self.args is None and (self.when is None
                                      or self.when(*args, **kw)):
                self.args = tuple(copy(a) for a in args)
                self.kw = {k: copy(v) for k, v in kw.items()}
            return self.inner(*args, **kw)

        setattr(self.module, self.name, spy)

    def stop(self):
        setattr(self.module, self.name, self.inner)
        if self.args is None:
            raise RuntimeError(f"{self.name}: the path never made the call "
                               "to be checked")


def _search_options(name):
    """default_driving_profile() with run ``name``'s option
    (tests/torch_search_reference.py::run_options, in the port)."""
    d = default_driving_profile()
    icp = d.ct_icp_options
    if name == "knn":
        return dataclasses.replace(d, ct_icp_options=dataclasses.replace(
            icp, ball_neighborhood=False))
    if name == "knn_kc2":
        return dataclasses.replace(d, ct_icp_options=dataclasses.replace(
            icp, ball_neighborhood=False, num_closest_neighbors=2))
    if name == "distance":
        return dataclasses.replace(
            d, distance_strategy=DistanceBasedStrategyOptions())
    return dataclasses.replace(d, host_subsample=False)


def _search_run(dev, name, frames, driving, spies=()):
    """Run ``name`` over ``frames`` through Odometry(...).stream_frames
    (batch 16), the counts set to 0 just before and read just after, with
    ``spies`` (``_FirstCall``s) in place; held to 0 failures and an APE
    within SEARCH_APE_FACTOR times the JAX package's on the CPU. Returns
    the path's stats and the odometry."""
    odo = Odometry(_search_options(name), device=dev)
    preps = [odo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i)
             for i, f in enumerate(frames)]
    for spy in spies:
        spy.start()
    _reset_counts()
    summaries, batch_s, wall = _stream(odo, preps, BATCH)
    launches, lm_steps = _read_counts(), _read_steps()
    for spy in spies:
        spy.stop()
    out, _ = _path_stats(odo, frames, preps, summaries, batch_s, wall)
    bound_m = SEARCH_APE_FACTOR * SEARCH_REF_APE_M[name]
    out.update(batch=BATCH, launches=launches, lm_steps=lm_steps,
               reference_cpu_ape_m=SEARCH_REF_APE_M[name],
               ape_bound_m=bound_m,
               residuals_per_frame=float(np.mean(
                   [s.number_of_residuals for s in summaries])),
               keypoints_per_frame=float(np.mean(
                   [s.sample_size for s in summaries])),
               driving_fps=driving["median_batch_fps"],
               driving_host_syncs_per_frame=driving["host_syncs_per_frame"])
    log(f"{name} path: " + json.dumps(out))
    log(f"  {name}: {out['median_batch_fps']:.2f} frames/s (driving "
        f"{driving['median_batch_fps']:.2f}), host syncs a frame "
        f"{out['host_syncs_per_frame']:.4f} (driving "
        f"{driving['host_syncs_per_frame']:.4f}), mean APE "
        f"{out['mean_ape_m']:.5f} m (JAX package on the CPU "
        f"{SEARCH_REF_APE_M[name]:.5f} m, bound {bound_m:.5f}), failures "
        f"{out['failures']}; launches K1 {launches['candidate_gather']}, "
        f"K2 {launches['plane_moments']}, K3 {launches['map_insert']}, K4 "
        f"{launches['grid_sample']}, K5 {launches['lm_step']}, K10 "
        f"{launches['level_normals']}, K12 {launches['knn_search']}")
    if out["failures"]:
        raise RuntimeError(f"{name} path: {out['failures']} failed frames")
    if not out["mean_ape_m"] <= bound_m:
        raise RuntimeError(f"{name} path: mean APE {out['mean_ape_m']} m > "
                           f"{bound_m} m")
    return out, odo


def phase_knn(dev, frames, driving):
    """The exact k-NN search (ball_neighborhood=False): the 80-frame run,
    K12 and no K2; then its first 10 frames with num_closest_neighbors=2,
    whose LM problems take two rows a keypoint. Returns the run's stats
    and K12's first call."""
    first = _FirstCall(k12, "knn_search")
    out, _ = _search_run(dev, "knn", frames, driving, [first])
    launches = out["launches"]
    _require_launches("knn", launches, ["candidate_gather", "knn_search",
                                        "map_insert", "lm_step"])
    if launches["plane_moments"] or launches["grid_sample"]:
        raise RuntimeError("knn path: K2 or K4 launched")
    if launches["knn_search"] != launches["candidate_gather"]:
        raise RuntimeError("knn path: not one K12 launch a K1 launch")
    _require_syncs("knn", out, committed_only=True)

    # kc = 2: the rows K5 takes against the queries K12 searched
    rows, queries = [], []
    lm_inner, knn_inner = k5.lm_loop, k12.knn_search

    def lm_spy(r, *args, **kw):
        rows.append(r.shape[0])
        return lm_inner(r, *args, **kw)

    def knn_spy(points, slots, cnt_ok, q, *args, **kw):
        queries.append(q.shape[0])
        return knn_inner(points, slots, cnt_ok, q, *args, **kw)

    k5.lm_loop, k12.knn_search = lm_spy, knn_spy
    try:
        kc2, _ = _search_run(dev, "knn_kc2", frames[:KC2_FRAMES], driving)
    finally:
        k5.lm_loop, k12.knn_search = lm_inner, knn_inner
    kc2.update(rows_per_lm_call=float(np.mean(rows)),
               keypoints_per_search=float(np.mean(queries)))
    log(f"  knn_kc2: residual rows a frame {kc2['residuals_per_frame']:.1f} "
        f"(the residual cap: {default_driving_profile().ct_icp_options.max_num_residuals}), "
        f"keypoints a frame {kc2['keypoints_per_frame']:.1f}; K5 took "
        f"{kc2['rows_per_lm_call']:.1f} rows a call for "
        f"{kc2['keypoints_per_search']:.1f} keypoints a search")
    if not (sum(rows) == 2 * sum(queries) and sum(rows) > sum(queries) > 0):
        raise RuntimeError(f"knn_kc2: K5 took {sum(rows)} rows for "
                           f"{sum(queries)} searched keypoints")
    _require_launches("knn_kc2", kc2["launches"], ["knn_search", "lm_step"])
    out["kc2"] = kc2
    return out, first


def phase_distance(dev, frames, driving):
    """The distance strategy at the reference's defaults: a radius a
    keypoint (K2 with a radius array), the normal filter (K1), and inserts
    that keep the voxel normals (K3's rank-0 slots, K10 on the dirty
    list). Returns the run's stats and K1's and K2's first calls."""
    k1_first = _FirstCall(k1, "candidate_gather")
    k2_first = _FirstCall(k2, "plane_moments",
                          lambda *a, **kw: torch.is_tensor(a[4]))
    out, odo = _search_run(dev, "distance", frames, driving,
                           [k1_first, k2_first])
    launches = out["launches"]
    _require_launches("distance", launches, [
        "candidate_gather", "plane_moments", "map_insert", "lm_step",
        "level_normals"])
    if launches["knn_search"]:
        raise RuntimeError("distance path: K12 launched")
    if k1_first.kw.get("sensor_location") is None:
        raise RuntimeError("distance path: K1 ran without the filter")
    n_levels = len(odo.map_state)
    _require_syncs("distance", out, committed_only=True,
                   inserts_per_frame=n_levels)
    flagged = int((odo.map_state[0].nflags == 2).sum())
    out.update(k10_launches=launches["level_normals"],
               voxels_with_normals=flagged)
    log(f"  distance: K10 launched {launches['level_normals']} times on "
        f"the dirty lists; {flagged} voxels keep a normal")
    if flagged <= 0:
        raise RuntimeError("distance path: no voxel kept its normal")
    return out, k1_first, k2_first


def phase_devsub(dev, frames, driving):
    """The device sub-sample (host_subsample=False): the raw scans packed
    at their rungs, K4 twice a frame (the scan, then the keypoints).
    Returns the run's stats and K4's first call at the scan's rung."""
    sub_cap = default_driving_profile().max_subsampled_points
    first = _FirstCall(k4, "grid_sample",
                       lambda points, valid, voxel, capacity, *a, **kw:
                       capacity == sub_cap)
    out, _ = _search_run(dev, "devsub", frames, driving, [first])
    launches = out["launches"]
    _require_launches("devsub", launches, ["candidate_gather",
                                           "plane_moments", "map_insert",
                                           "grid_sample", "lm_step"])
    if launches["grid_sample"] != 2 * out["frames"]:
        raise RuntimeError(f"devsub path: {launches['grid_sample']} K4 "
                           f"launches for {out['frames']} frames")
    _require_syncs("devsub", out, committed_only=True)
    out["scan_rung"] = int(first.args[0].shape[0])
    return out, first


def phase_kernels_search(dev, knn_first, k1_first, k2_first, k4_first):
    """K12, K1 with the normal filter, K2 with a radius a query and K4 at
    the scan's rung against their plain versions on the inputs of their
    first calls in phases 22-24, then timed. Returns {name: record}."""
    records = {}
    points, slots, cnt, q, radius, k = knn_first.args
    err = checks.check_knn_search(points, slots, cnt, q, radius, k)
    job = ("ops", k12.knn_search, (points, slots, cnt, q, radius, k), None)
    ops = _require_ops("K12 knn_search", _traced("K12", [job])[0], 1)
    ms, how = time_stateless(
        lambda: k12.knn_search(points, slots, cnt, q, radius, k))
    plain_ms, _ = time_stateless(
        lambda: k12.knn_search_plain(points, slots, cnt, q, radius, k))
    m = q.shape[0]
    points_read, rows_read, live = live_work(points, slots, cnt)
    # each distinct live candidate point once, the (slot, cnt_ok) pairs,
    # the queries (and radii), 17 B a neighbour out; d2 is 8 operations a
    # live candidate of each query
    n_bytes = (points_read * 12 + slots.numel() * 8 + m * 12
               + (m * 4 if torch.is_tensor(radius) else 0) + m * k * 17)
    records["knn_search"] = dict(
        max_abs_err=err["max_abs_err"], ms=ms, plain_ms=plain_ms,
        library_ms=None, bytes=n_bytes, ops=live * 8.0, timing=how,
        device_ops_per_call=ops, live=live, points_read=points_read,
        rows_read=rows_read,
        shape=f"M={m} O={slots.shape[1]} P={points.shape[1] // 3} k={k} "
              f"live={live} found={err['found']}")
    log(f"K12 knn_search knn frame 1 M={m} O={slots.shape[1]} k={k}: "
        f"identical to plain ({err['found']} neighbours); {ms:.4f} ms "
        f"({how}), plain {plain_ms:.4f} ms; {live} live candidates "
        f"({live / m:.1f} a query), {points_read} distinct live points, "
        f"{n_bytes} bytes")

    keys, count, qk, qv, res_v, nv, thr, max_c = k1_first.args
    kw = k1_first.kw
    level = vm.MapLevel(keys=keys, count=count, points=None,
                        normals=kw["normals"], nflags=kw["nflags"],
                        num_points=None)
    res = dataclasses.replace(
        default_driving_profile().map_options.resolutions[0],
        resolution=res_v)
    records["candidate_gather"], _ = _kernel_k1(
        dev, level, res, qk, nv, thr, max_c, "normal filter (distance)",
        query_valid=qv, sensor=kw["sensor_location"])

    pts, slots2, cnt2, q2, radius2, k_nearest, _cached = k2_first.args
    records["plane_moments"] = _kernel_k2(
        vm.MapLevel(keys=None, count=None, points=pts, normals=None,
                    nflags=None, num_points=None),
        q2, slots2, cnt2, radius2, k_nearest, "radius a query (distance)")

    scan, valid, voxel, capacity = k4_first.args[:4]
    records["grid_sample"] = _kernel_k4(dev, scan, valid, voxel, capacity,
                                        *k4_first.args[4:],
                                        tag="device sub-sample")
    del knn_first.args, k1_first.args, k2_first.args, k4_first.args
    torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------- the staged path —
def _staged_options(name):
    """default_driving_profile() with staged run ``name``'s options
    (tests/torch_staged_reference.py::run_options, in the port)."""
    d = default_driving_profile()
    adaptive = SamplingOption.ADAPTIVE
    if name == "adaptive":
        return dataclasses.replace(d, sampling=adaptive)
    if name == "adaptive_robust":
        return dataclasses.replace(d, sampling=adaptive,
                                   robust_registration=True)
    if name == "cap":
        return dataclasses.replace(d, max_num_keypoints=1000)
    if name == "none":
        return dataclasses.replace(d, sampling=SamplingOption.NONE)
    return dataclasses.replace(
        d, sampling=adaptive,
        adaptive_options=AdaptiveGridSamplingOptions(
            num_points_per_voxel=2, max_num_points=3000))


def _staged_run(dev, name, frames, driving, spies=()):
    """Run ``name`` over its first STAGED_FRAMES[name] frames through
    Odometry(...).register_frame, frame by frame (the host side of every
    frame inside the timed span), the counts set to 0 just before and read
    just after, with ``spies`` (``_FirstCall``s) in place; held to 0
    failures and an APE within STAGED_APE_FACTOR times the JAX package's
    on the CPU. Returns the run's stats, the odometry and its last
    frame's summary."""
    n = STAGED_FRAMES[name]
    odo = Odometry(_staged_options(name), device=dev)
    for spy in spies:
        spy.start()
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    summaries = [odo.register_frame(f["xyz"], f["timestamps"], frame_id=i)
                 for i, f in enumerate(frames[:n])]
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, lm_steps = _read_counts(), _read_steps()
    for spy in spies:
        spy.stop()
    errs = cor.seq_ape(odo, frames[:n])
    bound_m = STAGED_APE_FACTOR * STAGED_REF_APE_M[name]
    out = dict(
        frames=n, failures=sum(not s.success for s in summaries),
        attempts=sum(s.number_of_attempts for s in summaries),
        mean_attempts=float(np.mean([s.number_of_attempts
                                     for s in summaries])),
        mean_ape_m=float(np.mean(errs)), max_ape_m=float(np.max(errs)),
        final_drift_m=float(errs[-1]), map_points=odo.map_size(),
        frames_per_s=n / wall, wall_s=wall,
        icp_iters_per_frame=sum(s.icp_summary.num_iters
                                for s in summaries) / n,
        host_syncs_per_frame=odo.host_syncs / n,
        result_reads_per_frame=odo.result_reads / n,
        keypoints_per_frame=float(np.mean([s.sample_size
                                           for s in summaries[1:]])),
        launches=launches, lm_steps=lm_steps,
        reference_cpu_ape_m=STAGED_REF_APE_M[name], ape_bound_m=bound_m,
        driving_fps=driving["median_batch_fps"],
        driving_host_syncs_per_frame=driving["host_syncs_per_frame"])
    log(f"staged {name} path: " + json.dumps(out))
    log(f"  staged {name}: {out['frames_per_s']:.2f} frames/s frame by "
        f"frame (driving, streamed at batch {BATCH}: "
        f"{driving['median_batch_fps']:.2f}), host syncs a frame "
        f"{out['host_syncs_per_frame']:.3f} beside "
        f"{out['icp_iters_per_frame']:.3f} ICP iterations, keypoints a "
        f"frame {out['keypoints_per_frame']:.1f}, attempts a frame "
        f"{out['mean_attempts']:.3f}, mean APE {out['mean_ape_m']:.5f} m "
        f"(JAX package on the CPU {STAGED_REF_APE_M[name]:.4f} m, bound "
        f"{bound_m:.5f}), failures {out['failures']}; launches K4 "
        f"{launches['grid_sample']}, K13 {launches['exact_sample']}, K5 "
        f"{launches['lm_step']}")
    if out["failures"]:
        raise RuntimeError(f"staged {name} path: {out['failures']} failed "
                           "frames")
    if not out["mean_ape_m"] <= bound_m:
        raise RuntimeError(f"staged {name} path: mean APE "
                           f"{out['mean_ape_m']} m > {bound_m} m")
    _require_launches(f"staged {name}", launches,
                      ["candidate_gather", "plane_moments", "map_insert",
                       "grid_sample", "lm_step"])
    return out, odo, summaries[-1]


def _require_count(path, launches, name, want):
    if launches[name] != want:
        raise RuntimeError(f"staged {path} path: {launches[name]} {name} "
                           f"launches, not {want}")


def phase_staged_adaptive(dev, frames, driving):
    """ADAPTIVE keypoints, 80 frames: K4 once a frame on the raw scan, K13
    once a frame after frame 0. Returns the run's stats, K13's first call,
    the odometry and its last frame's summary."""
    first = _FirstCall(k13, "exact_sample")
    out, odo, last = _staged_run(dev, "adaptive", frames, driving, [first])
    n = out["frames"]
    _require_count("adaptive", out["launches"], "grid_sample", n)
    _require_count("adaptive", out["launches"], "exact_sample", n - 1)
    return out, first, (odo, last)


def phase_staged_robust_and_cap(dev, frames, driving):
    """ADAPTIVE on the robust regimen (K13 once an attempt), then the
    random cap on GRID keypoints (K4 twice a frame after frame 0, no K13);
    80 frames each."""
    robust, _, _ = _staged_run(dev, "adaptive_robust", frames, driving)
    _require_count("adaptive_robust", robust["launches"], "grid_sample",
                   robust["frames"])
    _require_count("adaptive_robust", robust["launches"], "exact_sample",
                   robust["attempts"])
    cap, _, _ = _staged_run(dev, "cap", frames, driving)
    _require_count("cap", cap["launches"], "grid_sample",
                   2 * cap["frames"] - 1)
    _require_count("cap", cap["launches"], "exact_sample", 0)
    return robust, cap


def phase_staged_short(dev, frames, driving):
    """NONE (no sampler kernel) and ADAPTIVE with 2 points a voxel and
    the 3,000-point cap (K13 with k = 2 and max_keep), 10 frames each.
    Returns their stats and K13's first call of the second."""
    none, _, _ = _staged_run(dev, "none", frames, driving)
    _require_count("none", none["launches"], "exact_sample", 0)
    first = _FirstCall(k13, "exact_sample")
    k2cap, _, _ = _staged_run(dev, "adaptive_k2_cap", frames, driving,
                              [first])
    _require_count("adaptive_k2_cap", k2cap["launches"], "exact_sample",
                   k2cap["frames"] - 1)
    return none, k2cap, first


def _kernel_k13(points, valid, capacity, kw, tag):
    """K13 against its plain version (three calls in a row on its table,
    bit for bit), then timed: on the device with the L2 flushed before
    each call (``ms``), back to back in a CUDA graph (``warm_ms``) and with
    its host side (``host_ms``); the plain version back to back; the
    device operations of one call (one)."""
    for _ in range(3):
        out = checks.check_exact_sample(points, valid, capacity, **kw)
    call = (points, valid, capacity)
    ms, how = time_cold(lambda: k13.exact_sample(*call, **kw))
    warm_ms, _ = time_stateless(lambda: k13.exact_sample(*call, **kw))
    host_ms, _ = time_host(lambda: k13.exact_sample(*call, **kw))
    plain_ms, _ = time_stateless(
        lambda: k13.exact_sample_plain(*call, **kw))
    positional = call + (kw.get("voxel_size"), kw.get("bands"),
                         kw.get("k", 1), kw.get("max_keep", 0))
    ops = _require_ops(f"K13 exact_sample {tag}", _traced("K13", [(
        "ops", k13.exact_sample, positional, None)])[0], 1)
    n = points.shape[0]
    n_valid = int(valid.sum())
    # inputs read once (points, validity), outputs written once (indices,
    # validity, count); the table and the scratch are this design's
    n_bytes = n * 13 + capacity * 5 + 4
    log(f"K13 exact_sample {tag} N={n} ({n_valid} valid) cap={capacity} "
        f"{kw.get('k', 1)} a voxel: identical to plain ({out['count']} "
        f"kept); {ms:.4f} ms ({how}; {warm_ms:.4f} ms back to back), "
        f"{host_ms:.4f} ms with its host side, plain {plain_ms:.4f} ms")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                bytes=n_bytes, ops=0.0, timing=how, warm_ms=warm_ms,
                host_ms=host_ms, device_ops_per_call=ops,
                shape=f"N={n} valid={n_valid} capacity={capacity} "
                      f"k={kw.get('k', 1)} max_keep={kw.get('max_keep', 0)} "
                      f"kept={out['count']}")


def _with_kw(first):
    """A ``_FirstCall`` of exact_sample as (points, valid, capacity,
    keyword arguments)."""
    points, valid, capacity = first.args[:3]
    names = ("voxel_size", "bands", "k", "max_keep")
    kw = dict(zip(names, first.args[3:]))
    kw.update(first.kw)
    return points, valid, capacity, {k: v for k, v in kw.items()
                                     if v is not None}


def _register_ms(dev, odo, last, reps=10):
    """The whole CTICPRegistration.register of one frame with its host side
    (alphas, upload, the solver with its host syncs, the readback): the
    ADAPTIVE run's last keypoints (``last``, its last frame's summary),
    from that frame's initial pose, against its map; mean of ``reps``
    calls after one more."""
    frame = odo.trajectory[-1]
    raw, alphas, valid = last.keypoints
    keep = valid.cpu().numpy()
    kp = raw.cpu().numpy()[keep].astype(np.float64)
    a = alphas.cpu().numpy()[keep].astype(np.float64)
    t_b, t_e = frame.begin_pose.timestamp, frame.end_pose.timestamp
    ts = t_b + a * (t_e - t_b)
    init = last.initial_frame
    times = []
    for i in range(reps + 1):
        f = init.copy()
        torch.cuda.synchronize()
        t0 = time.time()
        summary = odo.registration.register(odo.map_state, kp, ts, f,
                                            origin=odo.origin, device=dev)
        torch.cuda.synchronize()
        if i:
            times.append((time.time() - t0) * 1e3)
    log(f"CTICPRegistration.register of one frame ({kp.shape[0]} "
        f"keypoints, {summary.num_iters} ICP iterations, "
        f"{summary.num_residuals_used} residuals, success "
        f"{summary.success}): {np.mean(times):.3f} ms with its host side "
        f"(min {np.min(times):.3f})")
    return dict(ms=float(np.mean(times)), min_ms=float(np.min(times)),
                keypoints=int(kp.shape[0]), icp_iters=summary.num_iters,
                success=summary.success)


def phase_kernels_staged(dev, adaptive_first, k2cap_first, adaptive_run):
    """K13 against its plain version on the inputs of its first calls in
    phases 26 (ADAPTIVE) and 28 (2 a voxel, the cap), timed; and the whole
    registration of one frame with its host side."""
    points, valid, capacity, kw = _with_kw(adaptive_first)
    rec = _kernel_k13(points, valid, capacity, kw, "adaptive frame 1")
    points, valid, capacity, kw = _with_kw(k2cap_first)
    rec["others"] = {"k=2, max_keep (adaptive_k2_cap)": _kernel_k13(
        points, valid, capacity, kw, "k=2 cap frame 1")}
    del adaptive_first.args, k2cap_first.args
    register = _register_ms(dev, *adaptive_run)
    torch.cuda.empty_cache()
    return rec, register


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.time()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    phase_build()

    t0 = time.time()
    scene = cor.build_scene()
    traj = cor.straight_trajectory(400, NUM_FRAMES * 0.1 + 0.5)
    frames = cor.render_corridor(scene, traj, NUM_FRAMES, SEED)
    odo = Odometry(default_driving_profile(), device=dev)
    preps = [odo.prepare_frame(f["xyz"], f["timestamps"], i, frame_id=i)
             for i, f in enumerate(frames)]
    log(f"corridor: {len(frames)} frames rendered and prepared in "
        f"{time.time() - t0:.1f} s; points after dedup "
        f"{[p['n'] for p in preps[:2]]} ... {preps[-1]['n']}, keypoints "
        f"{[p['kp_n'] for p in preps[:2]]} ... {preps[-1]['kp_n']}")
    driving_records = phase_kernels_driving(dev, odo.options, preps)
    stages = phase_stages(dev, odo, {0: preps[0], len(preps) - 1: preps[-1]})
    driving = phase_driving(odo, frames, preps)
    for name, per_frame in (("B11 unpack_scan+transform_points", 1.0),
                            ("B9 compact_mask", 0.0),
                            ("B10 prune_level", driving["prunes_per_frame"])):
        stages[name]["calls_per_frame"] = per_frame
    robust, robust_records, robust_run = phase_robust(dev)
    escalation, jolt_k5 = phase_escalation(dev)
    long_drive, long_capture, long_acq = phase_long(dev)
    backend_runs, refine_capture = phase_backend(dev, long_acq)
    del long_acq
    backend_records = phase_kernels_backend(dev, refine_capture)
    del refine_capture
    ct_ba_beyond, beyond_record = phase_ct_ba_beyond(dev)
    backend_records["ct_ba_block"]["others"][
        "jacobi step x2 beyond residency"] = beyond_record
    robust_rebase, robust_capture = phase_robust_rebase(dev, robust_run,
                                                        robust)
    del robust_run
    rebase_records = phase_kernels_rebase(
        dev, long_capture, robust_capture,
        default_driving_profile().map_options.resolutions[0].resolution,
        robust_driving_profile().map_options.resolutions[0].resolution)
    indoor, election = phase_indoor(dev)
    indoor_records = phase_kernels_indoor(dev, election)
    del election
    replay_runs, room_odo, replay_capture = phase_replay()
    export = phase_export(room_odo)
    replay_records = phase_kernels_replay(dev, room_odo, replay_capture)
    del room_odo, replay_capture
    torch.cuda.empty_cache()
    header_move = phase_header_move()
    robust_backend, escalation_backend = phase_backend_robust()
    scale_runs, scale_ends, first_maps = phase_scale_out(frames)
    ranks_run, mesh_window = phase_scale_out_ranks(frames, scale_ends,
                                                   first_maps)
    del first_maps
    scale_records = phase_kernels_scale_out(dev, frames, mesh_window)
    knn, knn_first = phase_knn(dev, frames, driving)
    distance, k1_first, k2_first = phase_distance(dev, frames, driving)
    devsub, k4_first = phase_devsub(dev, frames, driving)
    search_records = phase_kernels_search(dev, knn_first, k1_first,
                                          k2_first, k4_first)
    staged_adaptive, adaptive_first, adaptive_run = phase_staged_adaptive(
        dev, frames, driving)
    staged_robust, staged_cap = phase_staged_robust_and_cap(dev, frames,
                                                            driving)
    staged_none, staged_k2cap, k2cap_first = phase_staged_short(
        dev, frames, driving)
    staged_record, register_timing = phase_kernels_staged(
        dev, adaptive_first, k2cap_first, adaptive_run)
    del adaptive_run

    paths = {"driving": driving, "robust": robust, "escalation": escalation,
             "long_drive": long_drive, "robust_rebase": robust_rebase,
             "indoor": indoor, "backend": backend_runs["on"],
             "backend_off": backend_runs["off"],
             "replay_gate": replay_runs["gate_on"],
             "replay_gate_off": replay_runs["gate_off"],
             "room": replay_runs["room_on"],
             "room_off": replay_runs["room_off"], "export": export,
             "ct_ba_beyond_residency": ct_ba_beyond,
             "robust_backend": robust_backend,
             "escalation_backend": escalation_backend,
             "scale_out_broadcast": scale_runs["broadcast"],
             "scale_out_partitioned": scale_runs["partitioned"],
             "scale_out_2_ranks": ranks_run, "knn": knn,
             "knn_kc2": knn["kc2"], "distance": distance, "devsub": devsub,
             "staged_adaptive": staged_adaptive,
             "staged_adaptive_robust": staged_robust,
             "staged_cap": staged_cap, "staged_none": staged_none,
             "staged_adaptive_k2_cap": staged_k2cap}
    primary = {**robust_records, **rebase_records,
               "ct_ba_block": backend_records["ct_ba_block"],
               **replay_records, "owner_pack": scale_records["owner_pack"],
               "knn_search": search_records["knn_search"],
               "exact_sample": staged_record}
    search_others = {
        "candidate_gather": {
            "normal filter (distance)": search_records["candidate_gather"]},
        "plane_moments": {
            "radius a query (distance)": search_records["plane_moments"]},
        "grid_sample": {
            "scan rung (device sub-sample)": search_records["grid_sample"]}}
    kernels = []
    for name, spec in KERNELS.items():
        # K1-K5: the robust shapes (every kernel runs there), the driving
        # shapes, K5's jolt frame and the indoor walk's shapes beside them;
        # K6, K7: the long drive's
        # rebase, the robust run's, and K6 on the points alone and at
        # exp_gather's shapes beside it;
        # the largest error over every shape checked
        r = primary[name]
        b_ms, b_by = bound(r["bytes"], r["ops"])
        others = dict(r.get("others", {}))
        if name in driving_records:
            others["driving"] = driving_records[name]
        if name == "lm_step":
            others["jolt"] = jolt_k5
        others.update(indoor_records.get(name, {}))
        others.update(search_others.get(name, {}))
        if name in ("candidate_gather", "plane_moments"):
            others["backend"] = backend_records[name]
        if name == "map_insert":
            others["rank-0 slots (scale-out)"] = scale_records["map_insert"]
        if name == "ct_ba_block":
            others["halo (2 ranks)"] = scale_records["ct_ba_block"]
        rec = dict(
            name=name, route="cuda", source=spec["source"],
            replaces=spec["replaces"],
            launches=sum(p["launches"][name] for p in paths.values()),
            launches_by_path={k: p["launches"][name]
                              for k, p in paths.items()},
            max_abs_err=max([r["max_abs_err"]] + [
                o["max_abs_err"] for o in others.values() if o]),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=b_ms, bound_by=b_by,
            library_ms=r["library_ms"], timing=r["timing"], shape=r["shape"])
        for key in WORK_KEYS + ("plain_step_ms", "loop_steps"):
            if r.get(key) is not None:
                rec[key] = r[key]
        if name == "lm_step":
            rec["steps_by_path"] = {k: p["lm_steps"]
                                    for k, p in paths.items()}
        if name in ("lm_step", "map_insert"):
            rec["device_ops_per_call"] = \
                driving_records[name]["device_ops_per_call"]
        if name == "rebuild_claim":
            rec["rebuild_level_device_ops"] = \
                driving_records["rebuild_level_device_ops"]
        if name == "grid_sample":
            rec["device_ops_per_call"] = \
                driving_records["grid_sample_device_ops"]
        rec["ptxas"] = spec.get("ptxas")
        for key, o in others.items():
            if o is None:
                continue
            ob_ms, ob_by = bound(o["bytes"], o["ops"])
            rec[key] = dict(
                ms=o["ms"], plain_ms=o["plain_ms"], bound_ms=ob_ms,
                bound_by=ob_by, library_ms=o["library_ms"],
                max_abs_err=o["max_abs_err"], shape=o["shape"])
            for extra in WORK_KEYS:
                if o.get(extra) is not None:
                    rec[key][extra] = o[extra]
        kernels.append(rec)
    extras = {
        "map_insert cruise (robust)": robust_records["map_insert"]["cruise"],
        "map_insert cruise (driving)":
            driving_records["map_insert"]["cruise"],
        "plane_moments cached radius ms (robust, driving)": [
            robust_records["plane_moments"]["cached_ms"],
            driving_records["plane_moments"]["cached_ms"]],
        "grid_sample Pallas configuration":
            robust_records["grid_sample"]["pallas_config"],
        "grid_sample table clear floor ms":
            robust_records["grid_sample"]["table_clear_floor_ms"],
        "backend refine halves": backend_runs["on"]["refine_halves"],
        "room replay device ms (first replay)":
            replay_runs["room_on"]["first_replay_device_ms"],
        "K1/K2 identical after the header moves": header_move,
        "CTICPRegistration.register of one frame (staged adaptive)":
            register_timing,
        "lm_step calls (robust, driving, jolt)": [
            {k: r[k] for k in ("ms", "plain_ms", "loop_steps", "steps_run",
                               "step_ms", "plain_step_ms",
                               "relative_errors", "loop_check", "branch",
                               "begin_end_deg")}
            for r in (robust_records["lm_step"], driving_records["lm_step"],
                      jolt_k5)],
    }
    log("extras: " + json.dumps(extras))
    log("stages: " + json.dumps(stages))
    log(f"total wall time {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        end_fresh_process()
    sys.exit(code)
