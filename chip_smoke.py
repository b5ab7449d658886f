#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  build    compile every source of the port, one process per source, all
           started together: the CUDA kernels with nvcc (sm_90a: the
           trilinear lookup K1-K3, the decoder stage K4-K6, the render
           integrator K7-K8, the group Adam step K9 and the frustum mask
           K10), the host mesh kernels with g++;
  capture  a 2-frame run of the slice's own workload (Replica-scale room,
           first mapping 60 iterations) that records the backward kernels'
           arguments on the main path: one tracking iteration's lookups
           (K3 over the middle, fine and color grids), one color-stage
           mapping iteration's (K2 over the same three grids) and one
           coarse-mapping iteration's (K2 over the coarse grid); and the
           decoder stage's arguments as they reach K5: tracking (color
           stage, 9.6k points, dp), mapping's middle, fine and color
           stages (48k points; the color stage trains the color decoder,
           so K6 runs) and the coarse mapper (48k points); and K7-K10's
           arguments: the integrator's forward and cotangents of a
           tracking iteration (200 rays x 48 samples), a color-stage
           mapping iteration (1000 x 48) and a coarse one (1000 x 32), the
           tracker's and the color stage's first Adam step (every leaf,
           gradient, moment and frustum mask) and the first frustum-mask
           call (the room's middle, fine and color grids, a 680x1200
           depth frame);
  ba_capture  the same for bundle adjustment (BA): a 7-frame run of the
           room with BA, a keyframe and a mapping event every frame (BA
           engages at frame 5), records the BA cases' arguments: K3 and K5
           of the middle, fine and color stages (48k points over 1, 2 and
           3 grids, the points' gradient), K8 of the color stage (rays_d
           requires a gradient; occupancy mode computes none), K9's
           color-stage step (the camera leaf at BA_cam_lr) and middle-stage
           step (at lr 0); the kernels phase times them as rows of their
           own (``*_ba``, ``ba_cases`` in the kernels line), each under its
           gate and bound, early in the process where the card's profiler
           records every kernel of a window; and the first BA call's
           arguments, for ba_sharded's ray-DP check;
  imap_ba_room  the iMAP* room with BA (replica_imap_cfg(ba=True): a
           mapping event and a keyframe every 2nd frame, so BA engages at
           frame 10 (3 calls) and 11 (the refinement's 5); 12 frames, first
           mapping 300, 60 mapping iterations an event (config 300), no
           mesh): every frame tracked, BA in exactly the calls the rule
           gives, each write-back checked, K7 twice and K8 and K9 once per
           iteration and nothing else; ms per mapping iteration with and
           without BA in the same run and the MLP's float32 peak share of
           each; it records K8's first BA call (5000 rays x 44 samples,
           density mode, the rays_d gradient feeding the camera leaf) for
           the kernels phase;
  kernels  BA on the parallel paths first: K3 with slab windows on the
           BA cases (48k points over 1, 2 and 3 grids) cut into 2 and 4
           slabs, each slab against its plain version, the slabs' sum in
           device order against dense K3 within 1e-4 of its largest entry,
           the slab owning the most points timed against its own bytes
           (``window_cases`` of K3 in the kernels line); K9 on the captured
           BA color-stage step with every grid leaf cut into 4 slabs beside
           the camera leaf; K8 on the iMAP* BA call; then
           K7 integrate_fwd and K8 integrate_bwd on the captured
           tracking, color-stage and coarse calls, on the render chunk's
           call (100k rays x 48 samples; seeded cotangents for K8) and on
           iMAP*'s density-mode calls drawn at its shapes (5000 rays x 44
           samples, K7 and K8; 5000 x 32, the importance pass's K7) against
           their plain versions (K7 within 1e-5, K8 within 1e-4 of the
           plain output's largest entry; both, and the plain version, also
           against the plain version in float64, a diagnostic), each row
           with integrate_geometry's launch (lanes per ray, samples a lane
           holds, tiles, CTAs), K9 group_adam on the captured
           tracker and color-stage steps against the plain step from the
           same state (within 2 float32 epsilons of each value's terms;
           library_ms torch._fused_adam_ on the same leaves, a yardstick
           only), K10's one launch on the captured frustum call (the
           largest lookups, its own output, within 1e-5 of the depth
           range, at most 1e-4 of the nodes' masks differing: nodes within
           rounding of a test's boundary; fine's and color's masks one
           tensor); each row with its registers and local bytes
           (none allowed) and its bound; then
           K4 decoder_fwd, K5 decoder_bwd and K6 decoder_wgrad_sum on each
           captured decoder-stage call against their plain versions (the
           output within 1e-3, the feature and weight gradients within
           1e-3 of the plain gradient's largest entry, dp within 1e-2, a
           point's gradient at a relu kink excepted for at most 0.1 % of
           the points, K6 within sqrt(rows) x eps), timed as below with
           library_ms the device
           time of the plain cuBLAS bmm chain (its autograd backward for
           K5, torch.sum for K6), and on each K4, K5 and K6 row the launch
           geometry: CTAs, threads per CTA, resident warps per SM,
           registers per thread, local (spill) bytes and shared bytes
           (cudaFuncGetAttributes and the occupancy API, through
           decoder_stage.cu's decoder_kernel_info; K4 must use no local
           memory), and K5's relu-kink points; then K1 trilinear_fwd, K2 trilinear_bwd_dgrid and K3
           trilinear_bwd_dp against their plain PyTorch versions on random
           ray points at the main path's shapes (fine grid 74x56x43x32 at
           48k mapping / 9.6k tracking points, coarse grid 11x8x7x32 at
           48k) and on the three captured cases, each kernel one launch
           over a case's grids; time each per call with
           CUDA events around 20 calls (``ms``: the host's issue rate
           included) and with torch.profiler (``device_ms``: the kernel's
           own device time per call, each call after the L2 was evicted),
           beside its plain version and torch.nn.functional.grid_sample
           (library yardstick only; the port never calls it); fail if a
           kernel's device_ms is below its bound_ms; each K1 row (here and
           in the sharded and pretrain phases) with its launch geometry:
           CTAs, the rounds of resident CTAs they take, items and the most
           a thread walks, registers, local bytes and resident CTAs per
           SM (interp.k1_geometry; trilinear.cu's trilinear_fwd_info), K1
           failing if it uses local memory; K1 and K4 also on the
           two new paths' calls, recorded from the port's own calls with
           the captured state: a mesh chunk (the first 500k points of the
           256^3 lattice over the room, 'fine' stage: middle and fine
           grids and decoders) and a render chunk (100k rays x 48 samples
           of a full frame, 'color' stage: three grids and decoders; K4's
           plain version in slices of 1M points); check the whole decoder
           stack on the card against the CPU on a small input;
  slice    the strict loop (track every frame, map + coarse-map every 5th)
           at full width on the Replica-scale synthetic room, 12 frames of
           680x1200, with every kernel's launches counted over the run
           (K1 once per iteration and once per mesher chunk, K3 once per
           tracking iteration, K2 once per mapping iteration; K4 once per
           K1, K5 once per iteration, K6 once per iteration and decoder
           that trains: the color decoder's color-stage iterations; K7, K8
           and K9 once per iteration, K10 once per frustum-selecting
           main-mapper call); it writes
           the final checkpoint, final_mesh.ply and final_mesh_eval_rec.ply
           at resolution 256, and each mesh must have faces;
  resume   a fresh system on the slice's config resumes from its final
           checkpoint: every grid, decoder tensor and pose equal to the
           slice's final state bit for bit, the start index n_frames;
  vis      one 680x1200 residual panel of the slice's final state
           (render_img: nine 100k-ray chunks, one K1, one K4 and one K7
           launch each);
  profile  ``nice_slam_torch.run --profile`` on three box frames: the
           trace under <output>/torch_trace/ holds K1 and K4 events;
  quality  the 30-frame tracked box run (0.25 rad orbit, mapping iters 60,
           first 400, coarse off) for five pixel seeds: the median ATE
           against the 9.5 cm gate, every draw against 20 cm; each draw's
           final mesh (resolution 128), the family median of each mesh's
           median | max(|x|,|y|,|z|) - 2 | over its vertices (the walls are
           at +-2 m) against 0.15 m;
  ba       bundle adjustment (BA), the NICE default: the Replica-scale room
           with BA for 30 frames (replica_ba_cfg; BA needs five keyframes,
           so it engages at frames 25 and 29, the last in the final
           refinement's 5 calls): every frame tracked; BA in exactly the
           calls len(keyframes) > 4 gives and in no coarse call; K3 once
           per tracking and BA mapping iteration, the other kernels the
           slice's rule; each BA call writes back every valid window
           keyframe but the oldest, leaves the others (the oldest too) bit
           for bit and ends its frame at the refined pose; fps, tracking
           ms/frame, mapping ms/event and ATE beside the slice's.  Then
           the 30-frame box with BA for the
           quality seeds under the quality phase's gates, beside its
           BA-off median, and one loose BA draw (seed 42, a keyframe per
           mapping event): every frame tracked, lag <= every + every // 2,
           ATE <= 20 cm, BA engaged, the write-backs checked as in the
           room;
  ba_sharded  BA over sharded grids and under ray DP: (b) the BA room
           with its grids over [cuda:0] x 4 (NICE_SLAM_TORCH_SPATIAL=1):
           every frame tracked, BA at frames 25 and 29 x 5, K1-K10 exact per
           (kernel, device, stream) (K3 once per slab in every tracking and
           BA mapping iteration), the halo planes of every published state
           bitwise equal, each write-back checked pose by pose, fps, ms and
           ATE beside the dense BA room's ((c), the box with BA over 2
           slabs, is ``--ba_families``, below); (d) the
           first BA call of ba_capture with its rays over [cuda:0] x 2: each
           of its 60 iterations' loss and camera gradient from the one-device
           run's state on the same pixels, within 1e-4 (relative; of the
           gradient's largest entry), and the call cut to middle 2, fine 2,
           color 3 run on one device and under ray DP: the refined window
           poses within 1e-5 (the losses reported); the split
           asserted, PyTorch's AccumulateGrad warnings counted per call; (b)
           and (d) again over cuda:0 and cuda:1 where two cards are visible;
  threaded the loose and then the free schedule on the slice's workload
           (the same 12 frames at full width, coarse mapper on): after a
           warm-up on the main thread the tracker, the mapper and the
           coarse mapper run as threads, each on its own CUDA stream.  Each
           run must track frames 1-11 with finite poses, map frame 11,
           write the final checkpoint and a final mesh with faces, and
           launch K1-K10 with exact counts (K3 = tracking iterations, K2 =
           mapping + coarse-mapping iterations, K1 = both + mesher chunks,
           K4 = K1, K5, K7, K8 and K9 = all iterations, K6 = training
           decoder-iterations, K10 = frustum-selecting mapping calls)
           on the streams they belong to: per stream, K3 = the tracker
           thread's tracking iterations, K2 = each mapper thread's mapping
           iterations, the warm-up's on the default stream; a stream that
           is missing fails the run.  The loose run's largest lag (idx -
           mapping_idx as a frame's tracking starts) must be at most every
           + every // 2.  Reports fps, tracking ms per frame, mapping and
           coarse-mapping ms per event, events, the lag and peak device
           memory beside the slice's strict numbers;
  threaded_quality  the quality phase's box run under loose for pixel
           seeds 42, 0, 1: every draw's ATE at most 20 cm, the median at
           most max(3 x the quality phase's median, 12 cm), the JAX
           package's rule for loose against strict
           (tests/test_sync_hardening.py:109-110);
  imap_slice  the iMAP* model (one 256-wide, 4-block MLP, no grids) through
           the strict loop at the Replica iMAP widths on the synthetic room
           at 680x1200: tracking 50 it x 5000 px, mapping 300 it x 5000 px
           over a 5-frame 'global' window every 5th frame, 32 + 12
           importance samples per ray and a 32-sample free-space
           regulariser, BA off, the final colour refinement on; cut for
           time to 12 frames, a first mapping of 300 iterations (config
           1500) and a keyframe every 5th frame (config 50).  It asserts
           the mapping iteration count of the schedule (300 at frame 0, 3
           calls of 100 at frames 5 and 10, 5 of 300 at frame 11: 2400),
           finite losses falling over the first call, no K1-K3 launch, an
           ATE below that of a camera frozen at frame 0, the final
           checkpoint and a resolution-256 final mesh with faces and
           vertex colours rendered along the normals; it reports the
           initial and final MLP's share of positive density along frame
           0's rays (at 0 the ReLU passes no depth gradient), fps, ms
           per tracking and mapping iteration, peak device memory,
           meshing_s and the MLP's floating-point work per iteration beside
           its time at the card's float32 peak (``mlp_f32_peak_share``);
  imap_resume  a fresh iMAP* system resumes from that checkpoint: every
           decoder tensor, the poses and the keyframes equal bit for bit;
           one 680x1200 panel of the resumed state, timed;
  imap_quality  the JAX package's ``selfcheck --imap`` run (30-frame box,
           0.25 rad orbit, mapping iters 60, first 400) for pixel seeds 42,
           0 and 1: every draw's ATE against 5 cm and against the ATE of a
           camera frozen at frame 0 (0.73 cm on this orbit, which the 5 cm
           gate alone would pass); the seed-42 draw's depth L1 (2D metric,
           200 views) against 3 cm; each draw's box-mesh wall distance
           reported, not gated;
  imap_ba  the iMAP* BA room's (imap_ba_room) ms per mapping iteration
           and MLP share beside imap_slice's (the box with BA is
           ``--ba_families``, below);
  readers  first makes cv2, PIL, matplotlib, jax and nice_slam_tpu
           unimportable for the rest of the run (failing if any was
           imported before); the port's export_synthetic writes the
           Replica, ScanNet, TUM, CoFusion and Azure layouts at Replica's
           camera (680x1200, 5 frames each) and the port's readers read
           them back: PNG depth equal to the generator's
           quantised depth, EXR depth exact, poses within 1e-5, JPEG colour
           at >= 30 dB PSNR, PNG colour exact (TUM read with
           freiburg1_desk's distortion, so undistort runs); the OpenCV
           fixtures of tests/data/imageio decode to OpenCV's pixels, and
           undistort at freiburg1_desk's camera gives OpenCV's; then
           ``nice_slam_torch.run`` runs the strict loop for ten frames from
           a 120x160 Replica-layout export (K1-K10 launched, ATE within
           20 cm, the checkpoint's selected_keyframes recorded); reports the
           read ms per 680x1200 frame;
  sharded  multi-device NICE-SLAM on this card, D logical devices on
           cuda:0 (and, where the machine shows two or more cards, the
           kernels' cases and the loop again over cuda:0 and cuda:1): K1,
           K2 and K3 with slab windows on the fine_map, map_color and
           track cases cut into 2 and 4 slabs, each slab's launch against
           its plain version, the slabs' K1 summed against dense K1 bit for
           bit, their K2 through fold_halo_grads and unshard_grid_grad
           within K2's gate, their K3 summed within 1e-4, and the slab
           owning the most points timed against its own bound; the
           slice's 12-frame loop with the grids sharded over [cuda:0] x 4
           (NICE_SLAM_TORCH_SPATIAL=1): every frame tracked, K1-K3
           launches exactly 4 x the slice's and K4-K10 the slice's, the
           halo planes bitwise equal, both
           meshes with faces, the dense final checkpoint restored by an
           unsharded system bit for bit, per_device_bytes within 1 % of
           13,110,272 B, fps and ms beside the slice's; the 30-frame box
           run sharded over 2 slabs for seeds 42, 0, 1 (the quality
           phase's gates); a Replica-room mapping call with its rays over
           [cuda:0] x 2 against the one-device call on the same pixels
           (losses within 1e-4 relative) and a resolution-256 lattice
           chunk split over 2 replicas (1e-5); a coarse call pinned to an
           explicit device against the unpinned one, and the strict loop
           entering the coarse call while the main call's queued work
           (a ~0.5 s spin and an event after it) is still pending;
  threaded_sharded  the loose and free schedules over several devices,
           the slice's 12 frames each: (a) loose with the grids sharded
           over [cuda:0] x 4, beside the sharded phase's strict loop on the
           same list; (b) free with ray DP over [cuda:0] x 2 and the coarse
           mapper pinned to the last device, beside a strict run on the
           same list.  Each run: every frame tracked with finite poses,
           the last mapped; K1-K10 launches exactly as the run's recorded
           calls give them per (kernel, device, stream) (a thread's on its
           own stream of each card, K1-K3 once per slab or replica, K4-K8
           once per replica, on the points' card when sharded, K9 once per
           step on each card the trained leaves lie on, K10 on the first;
           the
           warm-up's on the default streams); each thread with a stream of
           its own on every card; loose lag <= 7; the halo planes bitwise
           equal (a); the dense final checkpoint restored by a fresh
           one-device system bit for bit; the final meshes with faces;
           fps, ms per frame and event and each card's peak memory
           reported.  Then the loose box family over 2 slabs against
           threaded_quality's gates.  Where two or more cards are visible,
           (a) again over cuda:0 and cuda:1 and (b) over every card, each
           beside strict over the same list; with one card a line says
           that they did not run;
  gt_tour  the port's ``selfcheck --gt_camera --frames 150 --orbit_radians
           6.283`` (resolution 128, iters 60, first 400, 200 depth-L1 views,
           pretrained decoders) against tests/test_quality_gates.py:42-45:
           accuracy and completion <= 1.5 cm, depth L1 <= 0.5 cm,
           completion ratio >= 98 %; K3 never launched, K1 and K2 launched;
  imap_tour  the same with ``--imap`` against :46-47: accuracy <= 10 cm,
           depth L1 <= 6 cm; no K1-K3 launch;
  pretrain the port's decoder pretrainer at the recipe's full width
           (coarse, middle and fine decoders 32 wide; grids 6^3, 19^3 and
           38^3 x 32 over +-3 m; 4096 points x 300 Adam steps per stage),
           cut in depth to 2 scenes (the recipe: 40): every loss finite and
           each stage's mean over its last 50 steps below its first 50's;
           K1, K2 and K9 once per step (1800 each), K3, K7, K8 and K10
           never; K1 and K2 held
           against their plain versions on the first coarse-stage and
           fine-stage step's arguments (rows of the kernels line); the
           export loaded back by the port's loader equal bit for bit to the
           trained decoders, with the keys and shapes of pretrained/*.pt;
           reports steps per second;
  envelope the port's track_envelope at the box's full width (120x160, 20
           frames, first mapping 400, coarse off) at 1.0 and 2.5 deg per
           frame, default and coarse-to-fine (5 iterations at 5x): every
           row finite, the 1.0 deg rows <= 20 cm, and the JAX gate's rule
           (tests/test_quality_gates.py:148-154): the largest motion cf
           tracks below 10 cm >= default's; K3 = tracking iterations, K2 =
           mapping iterations, K7-K9 = both, K10 = mapping calls;
  landscape the port's loss_landscape on gt_tour's final checkpoint at
           frames 30, 90 and 149, offsets -4..4 cm, 2000 pixels: finite
           losses shaped as the JAX tool's, one K1, K4 and K7 launch per
           evaluation and nothing else; reports each DOF's 'biased' flag;
  viewer   ``nice_slam_torch.visualizer`` on the slice's output with
           --save_rendering: vis.mp4 (Motion-JPEG) holds one frame per
           frame 0..N, each read by the port's JPEG decoder; then
           --frontend web on 127.0.0.1 at a free port, in its own process
           with the same modules unimportable, serves the page, the last
           frame's mesh and the run's poses; the process is stopped.

The strict box families (quality, ba's, sharded's, imap_quality) and
the two tours run each draw in a child process of this script
(``--draw``), a family's draws at once: the box runs are host-bound, so
the card has room for several, and the iMAP* draws' GPU work overlaps
them.  Their host-clock fields (fps, meshing_s, seconds, a tour's
timings) are read beside their siblings, so each record holds them under
``contended`` with the number of draws that ran at once.  The loose
families (threaded_quality's, threaded_sharded's) run one draw after
another in this process: their result depends on how the threads race.

Then the card's name and power limit, the kernels line and, last,
{"ok": true, "device": {...}}.  Any failure exits non-zero without it.

    python3 chip_smoke.py --tracked_tour

builds, then runs only the 750-frame tracked tour with BA (QUALITY.json's
tracked_tour knobs: the box, hash texture, 2000 tracking pixels, a full
orbit) for the quality seeds, each draw a process of its own and all at
once, and holds the medians to its gates: ATE <= 40 cm, completion ratio
>= 25 %, depth L1 <= 3 cm.  It is left out of the default run for time
(368 s for the five draws on an H100 80GB HBM3 at 700 W).

    python3 chip_smoke.py --ba_families

builds, then runs only the BA box families, left out of the default run
for time: (c) the 30-frame box with BA with its grids over [cuda:0] x 2
(NICE_SLAM_TORCH_SPATIAL=1) for seeds 42, 0, 1 under the strict family's
gates (median ATE <= 9.5 cm, every draw <= 20 cm, median wall distance
<= 0.15 m); (e) iMAP*'s box with BA (BA calls at frames 25 x 3 and
29 x 5) for seeds 42, 0, 1, run at once with the same draws without BA:
every BA draw's ATE within 5 cm and below a frozen camera's, beside its
BA-off draw's, each write-back checked.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
L2_FLUSH_BYTES = 256 << 20  # read before each profiled call: 5x the 50 MB L2
SLICE_ITERS_FIRST = 300     # the Replica config's 1500, cut for time
CAPTURE_ITERS_FIRST = 60    # enough for the middle, fine and color stages
ATE_GATE_CM = 9.5          # the quality family's median
ATE_DIVERGED_CM = 20.0     # any one draw: only a diverged run goes past it
JAX_MEDIAN_GATE_CM = 6.5   # the JAX family's median gate, reported only
QUALITY_SEEDS = (42, 0, 1, 2, 3)  # the config's default pixel seed, then 0-3
BOX_MESH_GATE_M = 0.15     # family median of the box meshes' wall distance
THREADED_SEEDS = (42, 0, 1)  # the loose box family
LOOSE_ATE_FLOOR_CM = 12.0  # tests/test_sync_hardening.py:109-110
IMAP_FRAMES = 12           # the iMAP slice, cut for time
IMAP_ITERS_FIRST = 300     # the Replica iMAP config's 1500, cut for time
IMAP_ATE_GATE_CM = 5.0     # every draw (tests/test_quality_gates.py imap_tracked*)
IMAP_QUALITY_SEEDS = (42, 0, 1)  # the JAX family imap_tracked, _s0, _s1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Per-call time between CUDA events around ``reps`` back-to-back
    calls: at small sizes this is the host's issue rate, not the kernel."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# profiling windows retried because they did not record every kernel of the
# name, and for each (``lost``) the kernel, its records and the iterations
# (the L2 flushes, in order) that no record of it followed
PROFILER_RETRIES = {"windows": 0, "lost": []}
PROFILER_WINDOWS = 20  # windows tried per measurement before the run fails


def lost_window(prof, match: str, records: int) -> dict:
    """Which iterations of a window lost their ``match`` records: the CUDA
    events in device order, each ``flush.sum()`` reduction opening an
    iteration."""
    import torch

    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    followed = []
    for e in events:
        if match in e.name:
            if followed:
                followed[-1] = True
        elif "reduce_kernel" in e.name:
            followed.append(False)
    return {"kernel": match, "records": records, "flushes": len(followed),
            "events": len(events),
            "iterations_without": [i for i, f in enumerate(followed) if not f]}


def device_time_ms(fn, match: str, reps: int = 20, warmup: int = 3,
                   per_call: int = 1) -> float:
    """Per-call device time of the kernels whose name contains ``match``,
    from torch.profiler's CUDA activity over ``reps`` calls of ``fn``, each
    of which launches ``per_call`` such kernels.  Each call follows a read
    of L2_FLUSH_BYTES that evicts the L2, so the kernel finds its inputs in
    HBM, as the bound (bytes over the HBM rate) assumes and as a mapping
    iteration finds them (its Adam step alone sweeps the grids and their
    moments, ~145 MB).  A window now and then records no kernel at all
    (seen on an H100), and one that records only some of them reads as a
    time below the bound; so a window is kept only if it holds exactly
    ``reps * per_call`` kernels of the name, each of positive duration,
    and is tried up to PROFILER_WINDOWS times, then the run fails.  The
    card's profiler drops whole iterations' records (the flush's with the
    kernel's) in stretches of windows: five in a row lost two iterations
    each once, and one run lost 20 windows in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    flush.zero_()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.sum()
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name]
        if len(us) == reps * per_call and min(us) > 0:
            return sum(us) / 1e3 / reps
        PROFILER_RETRIES["windows"] += 1
        PROFILER_RETRIES["lost"].append(lost_window(prof, match, len(us)))
    raise RuntimeError(f"torch.profiler recorded {len(us)} {match} kernels, not "
                       f"{reps * per_call}, in each of {PROFILER_WINDOWS} windows: "
                       f"{PROFILER_RETRIES['lost'][-5:]}")


def ray_points(n_rays: int, gen, device):
    """Lookup points shaped like the renderer's: 48 sorted samples along
    each of ``n_rays`` rays from inside the box, some past its faces."""
    import torch

    o = (torch.rand((n_rays, 1, 3), generator=gen) - 0.5)
    d = torch.nn.functional.normalize(torch.randn((n_rays, 1, 3), generator=gen),
                                      dim=-1)
    t = torch.sort(torch.rand((n_rays, 48, 1), generator=gen) * 1.8, dim=1).values
    return (o + d * t).reshape(-1, 3).contiguous().to(device)


def phase_build():
    from nice_slam_torch.ops import kernels

    t0 = time.perf_counter()
    names = kernels.sources()
    libs = kernels.build(names)
    for name in names:
        kernels.library(name)
    ptxas = [ln.strip() for log in kernels.build_logs.values()
             for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "ok": True, "sources": names,
          "seconds": time.perf_counter() - t0, "libraries": list(libs.values()),
          "ptxas": ptxas})


def phase_capture(dev):
    """Cases of the main path: (points, grids, cotangents) as the slice's
    backward passes hand them to K2 and K3, and the decoder stage's
    arguments as they reach K5 (DEC_CASES)."""
    from nice_slam_torch.ops import decoder_stage as DS
    from nice_slam_torch.ops import interp
    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.tools.workloads import replica_synthetic_cfg

    t0 = time.perf_counter()
    cfg = replica_synthetic_cfg(os.path.join(HERE, "output", "chip_smoke", "capture"),
                                n_frames=2, iters_first=CAPTURE_ITERS_FIRST)
    meshing = cfg.pop("meshing")  # the slice phase meshes; new_path_lookups reads it
    slam = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None), dev)
    coarse_shape = tuple(slam.state.grids["grid_coarse"].shape)
    seen = {}
    dgrid_multi = interp.trilinear_bwd_dgrid_multi
    dp_multi = interp.trilinear_bwd_dp_multi

    def keep(p, gs):
        return {"p": p.detach().clone(), "gs": [g.detach().clone() for g in gs]}

    def rec_dgrid(p, gs, shapes):
        if len(gs) == 3:
            seen["map_color"] = keep(p, gs)
        elif len(gs) == 1 and tuple(shapes[0]) == coarse_shape:
            seen["map_coarse"] = keep(p, gs)
        return dgrid_multi(p, gs, shapes)

    def rec_dp(grids, p, gs):
        if k7_k10["state"]["label"] == "track":  # BA is off: no other K3 call
            seen["track"] = dict(keep(p, gs), grids=[g.detach().clone() for g in grids])
        return dp_multi(grids, p, gs)

    dec_bwd = DS.decoder_bwd
    dec_seen = {}

    def rec_dec(*args):
        label = dec_case_of(k7_k10["state"]["label"], args[5])
        if label in DEC_CASES and label not in dec_seen:
            dec_seen[label] = dec_bwd_case(*args)
        return dec_bwd(*args)

    interp.trilinear_bwd_dgrid_multi = rec_dgrid
    interp.trilinear_bwd_dp_multi = rec_dp
    DS.decoder_bwd = rec_dec
    k7_k10, restore = k7_k10_captures()
    try:
        slam.run()
    finally:
        interp.trilinear_bwd_dgrid_multi = dgrid_multi
        interp.trilinear_bwd_dp_multi = dp_multi
        DS.decoder_bwd = dec_bwd
        restore()
    missing = [k for k in DEC_CASES if k not in dec_seen]
    missing += [f"K7/K8 {k}" for k in K78_CASES[:3]
                if "g_depth" not in k7_k10["integrate"].get(k, {})]
    missing += [f"K9 {k}" for k in K9_CASES if k not in k7_k10["adam"]]
    missing += ["K10"] if k7_k10["frustum"] is None else []
    if missing:
        raise AssertionError(f"no main-path call captured for {missing}")
    g = slam.state.grids
    # the color stage looks up middle, fine, color in that order
    seen["map_color"]["grids"] = [g["grid_middle"], g["grid_fine"], g["grid_color"]]
    seen["map_coarse"]["grids"] = [g["grid_coarse"]]
    cases = {k: seen[k] for k in ("track", "map_color", "map_coarse")}
    lookups = new_path_lookups(slam, dict(cfg, meshing=meshing))
    emit({"phase": "capture", "ok": True, "seconds": time.perf_counter() - t0,
          "cases": {k: {"n": v["p"].shape[0], "grids": [list(x.shape) for x in v["grids"]]}
                    for k, v in {**cases, **lookups}.items()},
          "decoder_cases": {k: {"n": v["p"].shape[0], "decoders": len(v["decs"]),
                                "need_p": v["need_p"], "need_w": v["need_w"]}
                            for k, v in dec_seen.items()}})
    slam.cfg = dict(cfg, meshing=meshing)
    cases["decoder"] = dec_seen
    k7_k10["integrate"]["render_color"] = lookups["render_color"].pop("integrate")
    cases["k7_k10"] = k7_k10
    return cases, lookups, slam


def new_path_lookups(slam, cfg):
    """K1's and K4's inputs on the mesher's and the renderer's paths,
    recorded from the port's own calls on the captured state: the first
    lattice chunk of a resolution-256 mesh ('fine' stage) and the first
    ray chunk of a full-frame render ('color' stage); K4's under "dec"."""
    import torch

    from nice_slam_torch.ops import decoder_stage as DS
    from nice_slam_torch.ops import interp
    from nice_slam_torch.ops.render import get_rays, render_batch_ray
    from nice_slam_torch.utils.mesher import Mesher, chunked_eval

    from nice_slam_torch.ops import integrator as I

    seen = {}
    fwd = interp.trilinear_fwd_multi
    dec_fwd = DS.decoder_fwd
    int_fwd = I.integrate_fwd

    def rec(grids, p):
        seen.setdefault("lookup", {"p": p.detach().clone(),
                                   "grids": [g.detach() for g in grids]})
        return fwd(grids, p)

    def rec_dec(p, feats, weights, decs):
        seen["lookup"].setdefault("dec", {
            "p": p.detach().clone(), "feats": [f.detach().clone() for f in feats],
            "weights": [w.detach().clone() for w in weights], "decs": decs})
        return dec_fwd(p, feats, weights, decs)

    def rec_int(raw, z, rays_d, occupancy=False):
        if "lookup" in seen:
            seen["lookup"].setdefault("integrate", {
                "raw": raw.detach().clone(), "z": z.detach().clone(),
                "rays_d": rays_d.detach().clone(), "occ": bool(occupancy)})
        return int_fwd(raw, z, rays_d, occupancy)

    mesher = Mesher(cfg, slam.cam, slam.spec, slam.rcfg)
    lattice, _ = mesher.get_grid_uniform(cfg["meshing"]["resolution"])
    _, color, depth, _ = slam.frame_reader[0]
    c2w = slam.estimate_c2w_list[0]
    rays_o, rays_d = get_rays(slam.H, slam.W, slam.cam["fx"], slam.cam["fy"],
                              slam.cam["cx"], slam.cam["cy"], c2w)
    n = slam.rcfg.ray_batch_size
    gt = torch.as_tensor(depth, device=c2w.device).reshape(-1)[:n]
    out = {}
    interp.trilinear_fwd_multi = rec
    DS.decoder_fwd = rec_dec
    I.integrate_fwd = rec_int
    try:
        chunked_eval(slam.spec, slam.state, lattice[:mesher.points_batch_size],
                     "fine", mesher.points_batch_size)
        out["mesh_fine"] = seen.pop("lookup")
        with torch.no_grad():
            render_batch_ray(slam.spec, slam.state, rays_o[:n], rays_d[:n], "color",
                             gt_depth=gt, rcfg=slam.rcfg)
        out["render_color"] = seen.pop("lookup")
    finally:
        interp.trilinear_fwd_multi = fwd
        DS.decoder_fwd = dec_fwd
        I.integrate_fwd = int_fwd
    for label, c in out.items():
        if "dec" not in c:
            raise AssertionError(f"no K4 call recorded on the {label} path")
    if "integrate" not in out["render_color"]:
        raise AssertionError("no K7 call recorded on the render path")
    return out


def dgrid_f64(p, g, shape):
    """K2's plain version with the kernel's float32 weights and products,
    summed in float64 (exact to float32 rounding), and the same sum of
    |w_k g| (the scale of K2's tolerance).  Built here from the plain
    version's helpers."""
    import torch

    from nice_slam_torch.ops import interp

    i0, i1, frac, _ = interp._corners(shape, p)
    weights, _ = interp._corner_weights(frac)
    out = torch.zeros((2, shape[0] * shape[1] * shape[2], shape[3]),
                      dtype=torch.float64, device=p.device)
    for r, w in zip(interp._corner_rows(shape, i0, i1), weights):
        c = (w[:, None] * g).double()
        out[0].index_add_(0, r, c)
        out[1].index_add_(0, r, c.abs())
    return out[0].reshape(shape), out[1].reshape(shape)


def k1_row(label, grids, p, bytes_, timed, held, lib_fwd):
    """K1 over the grids of one case, one launch: error against its plain
    version at 1e-5, and its times.  ``bytes_``: the points, the touched
    grid rows and the features, each once."""
    from nice_slam_torch.ops import interp

    n = p.shape[0]
    before = interp.launch_counts["trilinear_fwd"]
    feats = interp.trilinear_fwd_multi(grids, p)
    if interp.launch_counts["trilinear_fwd"] != before + 1:
        raise AssertionError(f"K1 {label}: the lookup of {len(grids)} grids took "
                             f"{interp.launch_counts['trilinear_fwd'] - before} launches")
    ref = interp.trilinear_fwd_multi_plain(grids, p)
    err = max(float((f - r).abs().max()) for f, r in zip(feats, ref))
    del feats, ref
    return dict(held("trilinear_fwd", err, 1e-5),
                bytes=bytes_, flops=n * grids[0].shape[3] * 21 * len(grids),
                geometry=k1_launch_geometry(label, n, grids, p.device),
                **timed(lambda: interp.trilinear_fwd_multi(grids, p),
                        lambda: interp.trilinear_fwd_multi_plain(grids, p),
                        lib_fwd, "grid_sampler_3d", "trilinear_fwd"))


def k1_launch_geometry(label, n, grids, dev):
    """K1's launch on a case (``interp.k1_geometry``: CTAs, the rounds of
    resident CTAs they take, items, the most a thread walks and the
    CTA's chunk of them, 0 for a grid stride) and the
    kernel's registers, local (spill) bytes and resident CTAs per SM
    (trilinear.cu's trilinear_fwd_info); fails if K1 uses local memory."""
    import torch

    from nice_slam_torch.ops import interp

    C = grids[0].shape[3]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    info = interp.k1_kernel_info(C, dev)
    if info["local_bytes"]:
        raise AssertionError(f"K1 {label}: {info['local_bytes']} bytes of local memory")
    geom = interp.k1_launch_geometry(n, len(grids), C, dev)
    return {"ctas": geom.ctas, "threads": geom.threads, "rounds": geom.rounds,
            "items": geom.items, "per_thread": geom.per_thread, "chunk": geom.chunk, "sms": sms,
            "registers": info["registers"], "local_bytes": info["local_bytes"],
            "ctas_per_sm": info["ctas_per_sm"],
            **resident(info, geom.ctas, geom.threads // 32, sms)}


def case_tools(label, grids, p):
    """Per-case helpers shared by the kernels' rows: the bytes a lookup
    must move, grid_sample's layout of it, and the timing and tolerance
    wrappers."""
    import torch
    import torch.nn.functional as F

    from nice_slam_torch.ops import interp

    n = p.shape[0]
    pts_b = n * 3 * 4
    gather_b = feat_b = 0
    lib = []
    for grid in grids:
        C = grid.shape[3]
        i0, i1, _, _ = interp._corners(grid.shape, p)
        touched = torch.unique(torch.cat(interp._corner_rows(grid.shape, i0, i1))).numel()
        del i0, i1
        gather_b += touched * C * 4
        feat_b += n * C * 4
        lib.append(grid.permute(3, 2, 1, 0)[None].contiguous())
    lib_pts = p[None, :, None, None, :]
    base = dict(case=label, n=n, grids=len(grids))

    def lib_fwd():
        for x in lib:
            F.grid_sample(x, lib_pts, mode="bilinear", padding_mode="border",
                          align_corners=True)

    def timed(fn, plain, lib_fn, lib_match, kernel):
        # one kernel launch per call; grid_sample launches one per grid
        return dict(ms=cuda_time_ms(fn), device_ms=device_time_ms(fn, kernel),
                    plain_ms=cuda_time_ms(plain, 5),
                    library_ms=cuda_time_ms(lib_fn),
                    library_device_ms=device_time_ms(lib_fn, lib_match,
                                                     per_call=len(grids)))

    def held(kernel, err, tol):
        if not err <= tol:
            raise AssertionError(f"{kernel} {label}: max abs err {err} > {tol}")
        return dict(base, kernel=kernel, max_abs_err=err, tol=tol)

    return pts_b, gather_b, feat_b, lib, lib_pts, lib_fwd, timed, held


def lib_bwd(lib, lib_pts, gs, mask):
    """grid_sample's backward over each grid of a case (``mask``: which of
    the grid and point gradients it computes), cotangents in its
    [1, C, N, 1, 1] layout."""
    import torch

    lib_g = [g.t().reshape(1, g.shape[1], g.shape[0], 1, 1).contiguous() for g in gs]

    def run():
        for x, g in zip(lib, lib_g):
            torch.ops.aten.grid_sampler_3d_backward(g, x, lib_pts, 0, 1, True, mask)
    return run


def k2_row(label, grids, p, gs):
    """K2 over the grids of one case, one launch: held against its plain
    version summed in float64 (``dgrid_f64``): a main-path coarse cell
    takes ~10^4 contributions, and a float32 sum of that many in any order
    (the plain version's index_add_ also sums with atomics) is off by
    tens of ulps of the cell's sum of |w_k g| on its own.  The tolerance
    is 32 ulps of the largest such sum.  Bytes: the points, the
    cotangents, and the touched grid rows read and written in the zeroed
    gradient (its wrapper fills it with a separate kernel that device_ms
    leaves out)."""
    import torch

    from nice_slam_torch.ops import interp

    eps = torch.finfo(torch.float32).eps
    shapes = [tuple(g.shape) for g in grids]
    n, C = p.shape[0], shapes[0][3]
    pts_b, gather_b, feat_b, lib, lib_pts, _, timed, held = case_tools(label, grids, p)
    dgs = interp.trilinear_bwd_dgrid_multi(p, gs, shapes)
    held_k2 = []  # (err, tol) per grid; the row keeps the grid nearest its limit
    for dg, g, s in zip(dgs, gs, shapes):
        ref, scale = dgrid_f64(p, g, s)
        held_k2.append((float((dg.double() - ref).abs().max()),
                        32 * eps * float(scale.max())))
    del dgs
    err, tol = max(held_k2, key=lambda et: et[0] - et[1])
    return dict(held("trilinear_bwd_dgrid", err, tol),
                bytes=pts_b + feat_b + 2 * gather_b, flops=n * 8 * C * 2 * len(grids),
                **timed(lambda: interp.trilinear_bwd_dgrid_multi(p, gs, shapes),
                        lambda: [interp.trilinear_bwd_dgrid_plain(p, g, s)
                                 for g, s in zip(gs, shapes)],
                        lib_bwd(lib, lib_pts, gs, [True, False]), "grid_sampler_3d",
                        "trilinear_bwd_dgrid"))


def kernel_rows(label, grids, p, gs):
    """K1, K2 and K3 over the grids of one case (one lookup Function of a
    decoder stage): error against the plain versions (raises above its
    tolerance), ms, device_ms, plain_ms, grid_sample's ms and device_ms,
    and the bytes and flops of the bound.  Bytes count what each kernel
    itself must move, each once: the points, the cotangents or features,
    the grid rows the points touch (K1, K3 read them; K2 reads and writes
    them) and dp."""
    pts_b, gather_b, feat_b, _, _, lib_fwd, timed, held = case_tools(label, grids, p)
    return [k1_row(label, grids, p, gather_b + pts_b + feat_b, timed, held, lib_fwd),
            k2_row(label, grids, p, gs), k3_row(label, grids, p, gs)]


def k3_row(label, grids, p, gs):
    """K3 over the grids of one case, one launch: error against its plain
    version (1e-4 of the plain gradient's largest entry) and its times.
    Bytes: the touched grid rows, the points and the cotangents read, dp
    written."""
    from nice_slam_torch.ops import interp

    n, C = p.shape[0], grids[0].shape[3]
    pts_b, gather_b, feat_b, lib, lib_pts, _, timed, held = case_tools(label, grids, p)
    before = interp.launch_counts["trilinear_bwd_dp"]
    dp = interp.trilinear_bwd_dp_multi(grids, p, gs)
    if interp.launch_counts["trilinear_bwd_dp"] != before + 1:
        raise AssertionError(f"K3 {label}: the point gradient over {len(grids)} grids "
                             "was not one launch")
    ref = sum(interp.trilinear_bwd_dp_plain(gr, p, g) for gr, g in zip(grids, gs))
    err = float((dp - ref).abs().max())
    return dict(held("trilinear_bwd_dp", err, 1e-4 * float(ref.abs().max())),
                bytes=gather_b + pts_b + feat_b + pts_b,
                flops=n * 8 * C * 2 * len(grids),
                **timed(lambda: interp.trilinear_bwd_dp_multi(grids, p, gs),
                        lambda: sum(interp.trilinear_bwd_dp_plain(gr, p, g)
                                    for gr, g in zip(grids, gs)),
                        lib_bwd(lib, lib_pts, gs, [False, True]), "grid_sampler_3d",
                        "trilinear_bwd_dp"))


def with_bounds(rows):
    """Each row's bound_ms (the larger of its bytes over the HBM rate and
    its float32 operations over the card's float32 rate) and bound_by;
    fails if a row's device_ms is below its bound."""
    for r in rows:
        t_bytes = 1e3 * r["bytes"] / HBM_BYTES_PER_S
        t_ops = 1e3 * r["flops"] / F32_FLOPS_PER_S
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    under = [(r["case"], r["kernel"], r["device_ms"], r["bound_ms"])
             for r in rows if r["device_ms"] < r["bound_ms"]]
    if under:
        raise AssertionError(f"device_ms below bound_ms (a wrong bound or timing): {under}")
    return rows


# ---------------------------------------------------------------------------
# The decoder stage: K4 decoder_fwd, K5 decoder_bwd, K6 decoder_wgrad_sum
# ---------------------------------------------------------------------------

DEC_CASES = ("track", "map_middle", "map_fine", "map_color", "map_coarse")
DEC_OUT_ATOL = 1e-3   # K4's (N, 4) output against its plain version (read <= 1e-5)
DEC_GRAD_RTOL = 1e-3  # K5's feature and weight gradients, of the plain one's max abs
DEC_DP_RTOL = 1e-2    # K5's point gradient (its factor B ~ 25-75 enters twice)
DEC_KINK_SHARE = 1e-3  # of the points, those whose gradient may jump at a relu kink
DEC_PLAIN_CHUNK = 1_000_000  # points per plain-chain call (a render chunk's whole
                             # activations, ~70 GB at 4.8M points, would not fit)


K7_K10 = ("integrate_fwd", "integrate_bwd", "group_adam", "frustum_mask")


def counters():
    """The modules that count the launches of K1-K3, K4-K6, K7-K8, K9 and
    K10."""
    from nice_slam_torch.ops import decoder_stage as DS
    from nice_slam_torch.ops import frustum as Fm
    from nice_slam_torch.ops import integrator as I
    from nice_slam_torch.ops import interp
    from nice_slam_torch.slam import optim as O

    return interp, DS, I, O, Fm


def reset_counts() -> None:
    """Zero the launch counts of K1-K10."""
    for mod in counters():
        mod.reset_launch_counts()


def all_counts() -> dict:
    """The launches of K1-K10 since the last ``reset_counts``."""
    return {k: v for mod in counters() for k, v in mod.launch_counts.items()}


def all_by_device() -> dict:
    """The launches of K1-K10 per (kernel, device index, stream)."""
    return {k: v for mod in counters() for k, v in mod.launches_by_device.items()}


def all_by_stream() -> dict:
    """The launches of K1-K10 per (kernel, stream)."""
    return {k: v for mod in counters() for k, v in mod.launches_by_stream.items()}


def k7_k10_want(iters: int, frustum_calls: int, adam=None) -> dict:
    """K7-K10's launches of a run on one card: one K7, one K8 and one K9
    per tracking or mapping iteration (``adam``: K9's count, where it
    differs), and K10 once per main-mapper call that selects features by
    the frustum."""
    return {"integrate_fwd": iters, "integrate_bwd": iters,
            "group_adam": iters if adam is None else adam,
            "frustum_mask": frustum_calls}


def frustum_per_call(mcfg, spec) -> int:
    """K10's launches in a mapping call: one where the main mapper of a
    NICE scene selects features by the frustum."""
    return int(bool(mcfg.frustum_feature_selection) and not mcfg.coarse_mapper
               and spec.nice)


def k6_per_call(mcfg, plan) -> int:
    """K6 launches of a mapping call: one per iteration and decoder that
    trains (the fine decoder in the fine and color stages unless
    fix_fine, the color decoder in the color stage unless fix_color)."""
    if mcfg.coarse_mapper or not mcfg.nice:
        return 0
    per = {"middle": 0, "fine": int(not mcfg.fix_fine),
           "color": int(not mcfg.fix_fine) + int(not mcfg.fix_color)}
    return sum(per[stage] * n for stage, n in plan)


@contextlib.contextmanager
def recorded_core(sink):
    """Append each optimize_map_core call to ``sink`` as (thread, coarse,
    iterations, rays, K6 launches per device it runs on, K10 launches,
    BA)."""
    import inspect
    import threading

    from nice_slam_torch.slam import mapper as mapper_mod

    inner = mapper_mod.optimize_map_core
    sig = inspect.signature(inner)

    def core(*a, **k):
        b = sig.bind(*a, **k).arguments
        res = inner(*a, **k)
        sink.append((threading.current_thread().name, b["mcfg"].coarse_mapper,
                     int(res[2].shape[0]), b["colors"].shape[0] * b["pixs_per_image"],
                     k6_per_call(b["mcfg"], b["stage_plan"]),
                     frustum_per_call(b["mcfg"], b["spec"]), bool(b["BA"])))
        return res

    mapper_mod.optimize_map_core = core
    try:
        yield
    finally:
        mapper_mod.optimize_map_core = inner


def device_total_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Per-call device time of every kernel ``fn`` launches (torch.profiler),
    for a yardstick made of many kernels: the plain decoder chain.  Every
    call launches the same kernels, so a window is kept only if its count
    of kernels is a positive multiple of ``reps``; the card's profiler now
    and then records none (once for the first K9 yardstick of a run on an
    H100 80GB HBM3, 700 W), so a window is tried up to PROFILER_WINDOWS
    times, as in ``device_time_ms``, then the run fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if us and len(us) % reps == 0:
            return sum(us) / 1e3 / reps
        PROFILER_RETRIES["windows"] += 1
        PROFILER_RETRIES["lost"].append({"kernel": "yardstick", "records": len(us)})
    raise RuntimeError(f"torch.profiler recorded {len(us)} kernels of the yardstick, not a "
                       f"positive multiple of {reps} calls, in each of {PROFILER_WINDOWS} "
                       "windows")


def dec_case_of(label, need_p):
    """The main-path row a decoder-stage backward belongs to: the label of
    the loss that made it (``k7_k10_captures``: ``track`` or
    ``map_<stage>``, ``_ba`` under bundle adjustment, where a mapping
    stage needs the points' gradient), or None outside a loss."""
    if label is not None and label.startswith("map_") and need_p \
            and not label.endswith("_ba"):
        raise AssertionError(f"a {label} backward needs the points' gradient, "
                             "but its call trains no window pose")
    return label


def dec_bwd_case(p, feats, weights, decs, g, need_p, need_f, need_w) -> dict:
    """A copy of one decoder_bwd call's arguments, as ``decoder_rows``
    takes them."""
    return {"p": p.detach().clone(), "feats": [f.detach().clone() for f in feats],
            "weights": [w.detach().clone() for w in weights], "decs": decs,
            "g": g.detach().clone(), "need_p": bool(need_p),
            "need_f": tuple(bool(x) for x in need_f),
            "need_w": tuple(bool(x) for x in need_w)}


def dec_work(c, decs, need_p, need_f, need_w):
    """Multiply-adds per point of K4 and of K5 at the true widths (the
    93-wide embedding, 125 after the skip, 32- or 64-wide features; no
    padding): K5 recomputes the forward, walks the blocks back (dh through
    every hidden input, the lead's gradient where the points or B need
    it, the primary feature's through fc_c), and forms every weight's
    gradient once for the decoders that train."""
    from nice_slam_torch.ops import decoder_stage as DS

    H = DS.HIDDEN
    fwd = bwd = 0
    for i, d in enumerate(decs):
        L, f = DS.lead_width(d, c), DS.fw(d, c)
        emb = 3 * DS.EMBED if d.emb else 0
        one = L * H + 3 * H * H + (L + H) * H + 5 * f * H + H * d.out + emb
        fwd += one
        lead = (need_p or need_w[i]) if d.emb else need_f[d.feat]
        feat = d.fc and need_f[d.feat]
        if need_w[i] or lead or feat:
            bwd += (one + H * d.out + 4 * H * H + (2 * L * H + emb if lead else 0)
                    + (5 * c * H if feat else 0) + (one if need_w[i] else 0))
    return fwd, bwd


def held_per_point(what, got, ref, rtol):
    """A per-point gradient (N, k) against the plain one: every point within
    rtol x the plain gradient's largest entry, but for at most
    DEC_KINK_SHARE of the points, and the whole within rtol in L2.  A
    pre-activation within rounding of relu's kink can take the other
    branch in one of two float32 evaluations and move its point's gradient
    by that unit's whole term (at random weights and 48k points about a
    dozen units do); the weight gradients, sums over the points, feel such
    a point only as a 1/N share."""
    tol = rtol * float(ref.abs().max())
    e = (got - ref).abs().amax(dim=1)
    kinks = int((e > tol).sum())
    l2 = float((got - ref).norm() / ref.norm())
    return {"what": what, "err": float(e.max()), "tol": tol, "kinks": kinks, "l2": l2,
            "ok": kinks <= max(1, int(DEC_KINK_SHARE * e.numel())) and l2 <= rtol}


def dec_fwd_plain_chunked(p, feats, weights, decs):
    """K4's plain version over the points in DEC_PLAIN_CHUNK slices (each
    point's output depends on that point alone)."""
    import torch

    from nice_slam_torch.ops import decoder_stage as DS

    n = p.shape[0]
    if n <= DEC_PLAIN_CHUNK:
        return DS.decoder_fwd_plain(p, feats, weights, decs)
    return torch.cat([DS.decoder_fwd_plain(p[i:i + DEC_PLAIN_CHUNK],
                                           [f[i:i + DEC_PLAIN_CHUNK] for f in feats],
                                           weights, decs)
                      for i in range(0, n, DEC_PLAIN_CHUNK)])


def decoder_fwd_row(label, c):
    """K4 on one captured decoder-stage call against its plain version:
    the output within DEC_OUT_ATOL, one launch, no local memory; ms, device_ms,
    plain_ms, library_ms (the device time of every kernel of the plain
    cuBLAS bmm chain), the bound's bytes (points, features, outputs and each
    weight once) and flops, and the launch geometry."""
    from nice_slam_torch.ops import decoder_stage as DS

    p, feats, weights, decs = c["p"], c["feats"], c["weights"], c["decs"]
    n, C = p.shape[0], feats[0].shape[1]
    fwd_mac, _ = dec_work(C, decs, False, [False] * len(feats), [False] * len(decs))

    def fwd():
        return DS.decoder_fwd(p, feats, weights, decs)

    def fwd_plain():
        return dec_fwd_plain_chunked(p, feats, weights, decs)

    before = DS.launch_counts["decoder_fwd"]
    err = float((fwd() - fwd_plain()).abs().max())
    if DS.launch_counts["decoder_fwd"] != before + 1:
        raise AssertionError(f"K4 {label}: not one launch")
    if not err <= DEC_OUT_ATOL:
        raise AssertionError(f"K4 {label}: max abs err {err} > {DEC_OUT_ATOL}")
    geometry = fwd_launch_geometry(n, decs, C, p.device)
    if geometry["local_bytes"]:
        raise AssertionError(f"K4 uses local memory: {geometry}")
    return dict(case=label, n=n, decoders=len(decs), kernel="decoder_fwd", max_abs_err=err,
                tol=DEC_OUT_ATOL,
                bytes=n * 12 + sum(f.numel() for f in feats) * 4 + n * 16
                + sum(w.numel() for w in weights) * 4, flops=2 * fwd_mac * n,
                ms=cuda_time_ms(fwd), device_ms=device_time_ms(fwd, "decoder_fwd_kernel"),
                plain_ms=cuda_time_ms(fwd_plain, 5), library_ms=device_total_ms(fwd_plain),
                geometry=geometry)


def decoder_rows(label, c):
    """K4, K5 and (where a decoder trains) K6 on one captured decoder-stage
    call, each against its plain version: the output within DEC_OUT_ATOL,
    the feature and weight gradients within DEC_GRAD_RTOL of the plain
    gradient's largest entry, dp within DEC_DP_RTOL, K6's sum within
    sqrt(rows) x eps of the largest sum of |partials| (a float32 sum's
    rounding as a random walk; the worst case, rows x eps, read 170x
    loose); ms (CUDA events, host issue included; K5's
    with its K6 launches and allocations), device_ms (the kernel's own),
    plain_ms, and library_ms: the device time of every kernel of the
    cuBLAS bmm chain (the plain forward; for K5 autograd's backward of it;
    for K6 torch.sum).  Bytes: the points, the features, the cotangent,
    the outputs and each weight once (K5: and its partials written; K6:
    the partials read and the sum written)."""
    import torch

    from nice_slam_torch.ops import decoder_stage as DS

    p, feats, weights, decs, g = c["p"], c["feats"], c["weights"], c["decs"], c["g"]
    need_p, need_f, need_w = c["need_p"], c["need_f"], c["need_w"]
    n, C = p.shape[0], feats[0].shape[1]
    base = dict(case=label, n=n, decoders=len(decs))
    _, bwd_mac = dec_work(C, decs, need_p, need_f, need_w)
    w_b = sum(w.numel() for w in weights) * 4
    f_b = sum(f.numel() for f in feats) * 4
    rows = [decoder_fwd_row(label, c)]

    def bwd():
        return DS.decoder_bwd(p, feats, weights, decs, g, need_p, need_f, need_w)

    def bwd_plain():
        return DS.decoder_bwd_plain(p, feats, weights, decs, g, need_p, need_f, need_w)

    parts, inner_sum = [], DS.decoder_wgrad_sum
    DS.decoder_wgrad_sum = lambda part: (parts.append(part), inner_sum(part))[1]
    try:
        got = bwd()
    finally:
        DS.decoder_wgrad_sum = inner_sum
    exp = bwd_plain()
    held = []
    if need_p:
        held.append(held_per_point("dp", got[0], exp[0], DEC_DP_RTOL))
    for i, (a, b) in enumerate(zip(got[1], exp[1])):
        if (a is None) != (b is None):
            raise AssertionError(f"K5 {label}: feature {i} gradient presence differs")
        if a is not None:
            held.append(held_per_point(f"dfeat{i}", a, b, DEC_GRAD_RTOL))
    for i, (a, b) in enumerate(zip(got[2], exp[2])):
        if (a is None) != (b is None):
            raise AssertionError(f"K5 {label}: decoder {i} weight gradient presence differs")
        if a is not None:
            ref = DS.unpack(b, decs[i], C)
            for name, x in DS.unpack(a, decs[i], C).items():
                err = float((x - ref[name]).abs().max())
                tol = DEC_GRAD_RTOL * float(ref[name].abs().max())
                held.append({"what": f"dec{i}.{name}", "err": err, "tol": tol,
                             "kinks": 0, "ok": err <= tol})
    bad = [h for h in held if not h["ok"]]
    if bad:
        raise AssertionError(f"K5 {label}: above tolerance: {bad}")
    worst = max(held, key=lambda h: h["err"] / h["tol"] if h["tol"] else 0.0)
    what, err, tol = worst["what"], worst["err"], worst["tol"]
    leaves = [p.detach().requires_grad_(need_p)]
    leaves += [f.detach().requires_grad_(bool(nf)) for f, nf in zip(feats, need_f)]
    leaves += [w.detach().requires_grad_(bool(nw)) for w, nw in zip(weights, need_w)]
    graph = DS.decoder_fwd_plain(leaves[0], leaves[1:1 + len(feats)],
                                 leaves[1 + len(feats):], decs)
    wanted = [x for x in leaves if x.requires_grad]
    out_b = sum(x.numel() for x in got[1] if x is not None) * 4 + (n * 12 if need_p else 0)
    rows.append(dict(base, kernel="decoder_bwd", max_abs_err=err, tol=tol, nearest=what,
                     kink_points=sum(h["kinks"] for h in held),
                     held={h["what"]: {k: v for k, v in h.items() if k != "what"}
                           for h in held},
                     bytes=n * 28 + f_b + out_b + w_b + sum(x.numel() * 4 for x in parts),
                     flops=2 * bwd_mac * n, ms=cuda_time_ms(bwd),
                     device_ms=device_time_ms(bwd, "decoder_bwd_kernel"),
                     plain_ms=cuda_time_ms(bwd_plain, 5),
                     library_ms=device_total_ms(lambda: torch.autograd.grad(
                         graph, wanted, g, retain_graph=True))))
    del graph, wanted
    rows[-1]["geometry"] = bwd_launch_geometry(n, decs, C, need_w, p.device)
    for part in parts:
        eps = torch.finfo(torch.float32).eps
        s = DS.decoder_wgrad_sum(part)
        err = float((s.double() - part.double().sum(0)).abs().max())
        tol = part.shape[0] ** 0.5 * eps * float(part.abs().double().sum(0).max())
        if not err <= tol:
            raise AssertionError(f"K6 {label}: max abs err {err} > {tol}")
        rows.append(dict(base, kernel="decoder_wgrad_sum", max_abs_err=err, tol=tol,
                         rows=part.shape[0], cols=part.shape[1],
                         bytes=(part.numel() + part.shape[1]) * 4, flops=part.numel(),
                         ms=cuda_time_ms(lambda: DS.decoder_wgrad_sum(part)),
                         device_ms=device_time_ms(lambda: DS.decoder_wgrad_sum(part),
                                                  "wgrad_sum_kernel"),
                         plain_ms=cuda_time_ms(lambda: DS.decoder_wgrad_sum_plain(part), 5),
                         library_ms=device_total_ms(lambda: part.sum(0)),
                         geometry=wgrad_sum_geometry(part.shape[1], p.device)))
    return rows


def resident(info, ctas, warps, sms):
    """Resident warps per SM of a launch: the CTAs an SM holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) or the CTAs it gets,
    whichever is fewer; on average and on the SM that gets the fewest."""
    return {"resident_warps_per_sm": min(info["ctas_per_sm"], ctas / sms) * warps,
            "min_resident_warps_per_sm": min(info["ctas_per_sm"], ctas // sms) * warps}


def fwd_launch_geometry(n, decs, c, dev):
    """K4's launch on a call: persistent CTAs, threads, tiles, and the
    kernel's registers, local (spill) bytes and shared bytes per CTA
    (decoder_stage.cu's decoder_kernel_info)."""
    import torch

    from nice_slam_torch.ops import decoder_stage as DS

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    geom = DS.fwd_geometry(n, sms)
    smem = DS.fwd_smem(decs, c, geom.warps, dev)
    info = DS.kernel_info("decoder_fwd", smem, dev, geom.threads)
    return {"ctas": geom.grid, "threads": geom.threads, "tile_points": geom.tile,
            "tiles": geom.tiles, "sms": sms, "registers": info["registers"],
            "local_bytes": info["local_bytes"],
            "shared_bytes": smem + info["static_shared_bytes"],
            "ctas_per_sm": info["ctas_per_sm"],
            **resident(info, geom.grid, geom.warps, sms)}


def bwd_launch_geometry(n, decs, c, need_w, dev):
    """K5's launch on a case: CTAs, threads, tiles, partial rows, and the
    kernel's registers, local (spill) bytes and shared bytes per CTA read
    with cudaFuncGetAttributes (decoder_stage.cu's decoder_kernel_info)."""
    import torch

    from nice_slam_torch.ops import decoder_stage as DS

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    geom = DS.bwd_geometry(n, sms, any(need_w), len(decs))
    smem = DS.bwd_smem(decs, c, need_w, dev)
    info = DS.kernel_info("decoder_bwd_train" if any(need_w) else "decoder_bwd", smem, dev)
    return {"ctas": geom.ctas, "grid": list(geom.grid), "threads": geom.threads,
            "tile_points": geom.tile,
            "tiles": geom.tiles, "partial_rows": geom.rows, "sms": sms,
            "registers": info["registers"], "local_bytes": info["local_bytes"],
            "shared_bytes": smem + info["static_shared_bytes"],
            "ctas_per_sm": info["ctas_per_sm"],
            **resident(info, geom.ctas, geom.threads // 32, sms)}


def wgrad_sum_geometry(cols, dev):
    """K6's launch: a CTA of 8 row groups x 32 columns per 32 columns."""
    import torch

    from nice_slam_torch.ops import decoder_stage as DS

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    info = DS.kernel_info("decoder_wgrad_sum", 0, dev)
    ctas = -(-cols // 32)
    return {"ctas": ctas, "threads": info["threads"], "sms": sms,
            "registers": info["registers"], "local_bytes": info["local_bytes"],
            "shared_bytes": info["static_shared_bytes"], "ctas_per_sm": info["ctas_per_sm"],
            **resident(info, ctas, info["threads"] // 32, sms)}


# ---------------------------------------------------------------------------
# K7 integrate_fwd, K8 integrate_bwd, K9 group_adam, K10 frustum_mask
# ---------------------------------------------------------------------------

K78_CASES = ("track", "map_color", "map_coarse", "render_color")
# iMAP*'s integrator calls, drawn at its shapes (density mode, 5000 rays):
# (rays, samples, kernels) of an iteration (32 + 12 samples, K7 and K8) and
# of the importance pass (32 samples, K7 alone, no graph)
K78_IMAP_CASES = {"imap": (5000, 44, ("integrate_fwd", "integrate_bwd")),
                  "imap_importance": (5000, 32, ("integrate_fwd",))}
K9_CASES = ("track", "map_color")
K7_RTOL = 1e-5   # K7's outputs, of the plain output's largest entry
K8_RTOL = 1e-4   # K8's gradients, of the plain gradient's largest entry
K9_EPS = 2.0     # K9 against the plain step, in float32 epsilons of each value's terms
K10_SHARE = 1e-4  # of the nodes, those whose mask may differ (within rounding of a test)


def k7_k10_captures(k78_cases=None, k9_cases=None):
    """Record K7-K10's arguments on the capture run: the integrator's
    forward and its cotangents per case (the label of the loss that
    called it: ``track``, or ``map_<stage>``, with ``_ba`` where the call
    trains the window poses) for the labels ``k78_cases`` (K78_CASES),
    the first Adam step of each label of ``k9_cases`` (K9_CASES: the
    tracker's and the color stage's; clones of every leaf, gradient,
    moment and mask), and the first frustum-mask call.  ``rec["state"]``
    holds the label of the loss running now.  Returns the record and a
    function that undoes the hooks."""
    import inspect

    import torch

    from nice_slam_torch.ops import integrator as I
    from nice_slam_torch.slam import mapper as M
    from nice_slam_torch.slam import optim as O
    from nice_slam_torch.slam import tracker as T

    k78_cases = K78_CASES if k78_cases is None else k78_cases
    k9_cases = K9_CASES if k9_cases is None else k9_cases
    state = {"label": None, "pending": None}
    rec = {"integrate": {}, "adam": {}, "frustum": None, "state": state}
    saved = {(I, "integrate_fwd"): I.integrate_fwd, (I, "integrate_bwd"): I.integrate_bwd,
             (O, "group_adam"): O.group_adam, (M, "frustum_masks"): M.frustum_masks,
             (T, "tracking_loss_sampled"): T.tracking_loss_sampled,
             (M, "mapping_loss"): M.mapping_loss}
    map_sig = inspect.signature(M.mapping_loss)

    def clone(t):
        return t.detach().clone() if isinstance(t, torch.Tensor) else t

    def track_loss(*a, **k):
        state["label"] = "track"
        return saved[(T, "tracking_loss_sampled")](*a, **k)

    def map_loss(*a, **k):
        b = map_sig.bind(*a, **k).arguments
        # a BA call trains the window poses: its cases have labels of their own
        state["label"] = "map_" + b["stage"] + ("_ba" if "cams" in b["groups"] else "")
        return saved[(M, "mapping_loss")](*a, **k)

    def fwd(raw, z, rays_d, occupancy=False):
        label = state["label"]
        if label in k78_cases and label not in rec["integrate"]:
            rec["integrate"][label] = {"raw": clone(raw), "z": clone(z),
                                       "rays_d": clone(rays_d), "occ": bool(occupancy),
                                       "rays_d_requires_grad": bool(rays_d.requires_grad)}
            state["pending"] = label
        return saved[(I, "integrate_fwd")](raw, z, rays_d, occupancy)

    def bwd(raw, z, rays_d, depth, g_depth, g_var, g_rgb, occupancy=False, need_rays=True):
        if state["pending"] is not None:
            rec["integrate"][state["pending"]].update(
                depth=clone(depth), g_depth=clone(g_depth), g_var=clone(g_var),
                g_rgb=clone(g_rgb), need_rays=bool(need_rays))
            state["pending"] = None
        return saved[(I, "integrate_bwd")](raw, z, rays_d, depth, g_depth, g_var, g_rgb,
                                          occupancy, need_rays)

    def adam(leaves):
        label = state["label"]
        if label in k9_cases and label not in rec["adam"]:
            rec["adam"][label] = [tuple(clone(x) for x in leaf) for leaf in leaves]
        return saved[(O, "group_adam")](leaves)

    def masks(*a):
        # the camera, depth, bound, shapes and intrinsics; a dense call's
        # rows are each grid's nx, the default
        dense = len(a) < 11 or a[10] is None or list(a[10]) == [s[0] for s in a[3]]
        if rec["frustum"] is None and dense:
            rec["frustum"] = tuple(clone(x) for x in a[:10])
        return saved[(M, "frustum_masks")](*a)

    for (mod, name), fn in zip(saved, (fwd, bwd, adam, masks, track_loss, map_loss)):
        setattr(mod, name, fn)

    def restore():
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    return rec, restore


def rel_err(got, ref) -> float:
    """|got - ref| of the largest entry of |ref| (0 where ref is all 0)."""
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) / scale if scale else float((got - ref).abs().max())


def integrator_inputs(n, s, dev, seed=0):
    """Density-mode rays as tests/test_torch_cuda.py draws them: relu at
    exactly 0 on a quarter of the rays, alpha saturated (density 40) on
    the second half of another quarter's samples."""
    import torch

    g = torch.Generator().manual_seed(seed)
    raw = torch.randn((n, s, 4), generator=g)
    raw[..., 3] = raw[..., 3].abs() * 3.0
    raw[: n // 4, ::3, 3] = 0.0
    raw[n // 4: n // 2, s // 2:, 3] = 40.0
    z = torch.sort(0.1 + 3.9 * torch.rand((n, s), generator=g), dim=-1).values
    rays_d = torch.randn((n, 3), generator=g)
    return {"raw": raw.to(dev), "z": z.to(dev), "rays_d": rays_d.to(dev), "occ": False}


def integrator_launch_geometry(n, s, occ, kernel, dev):
    """K7's or K8's launch on a call: integrate_geometry's lanes per ray,
    samples a lane holds, tiles, rays per CTA and CTAs, and the instance's
    registers, local (spill) bytes and resident CTAs per SM."""
    import torch

    from nice_slam_torch.ops import integrator as I

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    geom = I.launch_geometry(n, s, dev)
    info = I.integrate_kernel_info(kernel == "integrate_bwd", occ, dev, geom.lanes)
    return {**geom._asdict(), "sms": sms, **info,
            **resident(info, geom.ctas, geom.threads // 32, sms)}


def k7_k8_rows(label, c, dev, kernels=("integrate_fwd", "integrate_bwd")):
    """K7 and K8 on one captured (or drawn) integrator call: errors against
    the plain versions (gated), and as a diagnostic both the kernel's and
    the plain version's against the plain version in float64; times, bound
    and launch geometry.  A call without a backward (the render chunk, a
    drawn call) gets seeded cotangents for K8."""
    import torch

    from nice_slam_torch.ops import integrator as I

    raw, z, rays_d, occ = c["raw"], c["z"], c["rays_d"], c["occ"]
    n, s = z.shape
    if "g_depth" not in c:
        gen = torch.Generator(device=dev).manual_seed(7)
        c = dict(c, depth=I.integrate_fwd_plain(raw, z, rays_d, occ)[0],
                 g_depth=torch.randn(n, generator=gen, device=dev),
                 g_var=torch.randn(n, generator=gen, device=dev),
                 g_rgb=torch.randn((n, 3), generator=gen, device=dev), need_rays=True)
    got = I.integrate_fwd(raw, z, rays_d, occ)
    ref = I.integrate_fwd_plain(raw, z, rays_d, occ)
    err7 = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    rel7 = max(rel_err(a, b) for a, b in zip(got, ref))
    cot = (c["depth"], c["g_depth"], c["g_var"], c["g_rgb"])
    need = c["need_rays"] and not occ
    g8 = I.integrate_bwd(raw, z, rays_d, *cot, occ, need)
    r8 = I.integrate_bwd_plain(raw, z, rays_d, *cot, occ)
    err8 = float((g8[0] - r8[0]).abs().max())
    rel8 = rel_err(g8[0], r8[0])
    if need:
        err8 = max(err8, float((g8[1] - r8[1]).abs().max()))
        rel8 = max(rel8, rel_err(g8[1], r8[1]))
    if not (rel7 <= K7_RTOL and rel8 <= K8_RTOL and torch.isfinite(g8[0]).all()):
        raise AssertionError(f"K7/K8 {label}: errors {rel7}, {rel8} of the plain "
                             f"outputs' largest entries > {K7_RTOL}, {K8_RTOL}")
    # the diagnostic: which of the kernel and the float32 plain version
    # carries the error, against the plain version in float64
    d64 = [t.double() for t in (raw, z, rays_d)]
    ref64 = I.integrate_fwd_plain(*d64, occ)
    r8_64 = I.integrate_bwd_plain(*d64, *(t.double() for t in cot), occ)
    f64 = {"integrate_fwd": (max(rel_err(a.double(), b) for a, b in zip(got, ref64)),
                             max(rel_err(a.double(), b) for a, b in zip(ref, ref64))),
           "integrate_bwd": tuple(
               max([rel_err(x[0].double(), r8_64[0])]
                   + ([rel_err(x[1].double(), r8_64[1])] if need else []))
               for x in (g8, r8))}
    rays_b = n * 12 if not occ else 0
    samples_b = n * s * 20  # raw and z
    rows = []
    for kernel, err, rel, tol, bytes_, fn, plain in (
            ("integrate_fwd", err7, rel7, K7_RTOL, samples_b + rays_b + n * 20 + n * s * 4,
             lambda: I.integrate_fwd(raw, z, rays_d, occ),
             lambda: I.integrate_fwd_plain(raw, z, rays_d, occ)),
            ("integrate_bwd", err8, rel8, K8_RTOL,
             samples_b + rays_b + n * 24 + n * s * 16 + (n * 12 if need else 0),
             lambda: I.integrate_bwd(raw, z, rays_d, *cot, occ, need),
             lambda: I.integrate_bwd_plain(raw, z, rays_d, *cot, occ))):
        if kernel not in kernels:
            continue
        geometry = integrator_launch_geometry(n, s, occ, kernel, dev)
        if geometry["local_bytes"]:
            raise AssertionError(f"{kernel}: {geometry['local_bytes']} bytes of local memory")
        rows.append(dict(case=label, kernel=kernel, n=n, samples=s, occupancy=occ,
                         rays_d_grad=bool(need) if kernel == "integrate_bwd" else None,
                         **({"rays_d_requires_grad": c["rays_d_requires_grad"]}
                            if "rays_d_requires_grad" in c else {}),
                         max_abs_err=err, rel_err=rel, tol=tol,
                         rel_err_f64=f64[kernel][0], plain_rel_err_f64=f64[kernel][1],
                         bytes=bytes_, flops=n * s * (20 if kernel == "integrate_fwd" else 40),
                         ms=cuda_time_ms(fn), device_ms=device_time_ms(fn, kernel + "_kernel"),
                         plain_ms=cuda_time_ms(plain, 5), library_ms=None,
                         library_device_ms=None, geometry=geometry))
    return rows


def k9_row(label, leaves, dev):
    """K9 on one captured Adam step: against the plain step from the same
    state (m and v within K9_EPS epsilons of their two terms' magnitudes,
    p of |p| + lr (|u| + the update's sensitivity to m's rounding), as in
    tests/test_torch_cuda.py), times, bound, and torch._fused_adam_ on
    the same leaves as the library yardstick (one lr for all, no masks)."""
    import torch

    from nice_slam_torch.slam import optim as O

    def fresh():
        return [(p.clone(), g, m.clone(), v.clone(), k, b1, b2, lr)
                for p, g, m, v, k, b1, b2, lr in leaves]

    mine, plain = fresh(), fresh()
    O.group_adam(mine)
    O.group_adam_plain(plain)
    eps = torch.finfo(torch.float32).eps
    worst = err = 0.0
    differ = total = 0
    for (p0, g, m0, v0, k, b1, b2, lr), a, b in zip(leaves, mine, plain):
        g = torch.zeros_like(p0) if g is None else (g if k is None else g * k)
        sm = (0.9 * m0).abs() + (0.1 * g).abs()
        sv = (0.999 * v0).abs() + (0.001 * g * g).abs()
        denom = torch.sqrt(b[3] / b2) + 1e-8
        u = (b[2] / b1) / denom
        lr_t = lr.abs() if isinstance(lr, torch.Tensor) else abs(lr)
        sp = p0.abs() + lr_t * (u.abs() + sm / (b1 * denom))
        for x, y, scale in ((a[0], b[0], sp), (a[2], b[2], sm), (a[3], b[3], sv)):
            err = max(err, float((x - y).abs().max()))
            worst = max(worst, float(((x - y).abs() / (scale * eps).clamp_min(1e-38)).max()))
            differ += int((x != y).sum())
            total += x.numel()
    if not worst <= K9_EPS:
        raise AssertionError(f"K9 {label}: {worst} epsilons from the plain step > {K9_EPS}")
    n = sum(p.numel() for p, *_ in leaves)
    bytes_ = sum(p.numel() * (24 + (4 if g is not None else 0))
                 + (k.numel() * 4 if k is not None else 0)
                 for p, g, m, v, k, *_ in leaves)
    timed = fresh()
    lib = fresh()
    lib_p = [x[0] for x in lib]
    lib_g = [torch.zeros_like(x[0]) if x[1] is None else x[1] for x in lib]
    lib_m, lib_v = [x[2] for x in lib], [x[3] for x in lib]
    steps = [torch.tensor(1.0, device=dev) for _ in lib]

    def lib_fn():
        torch._fused_adam_(lib_p, lib_g, lib_m, lib_v, [], steps, lr=1e-3, beta1=0.9,
                           beta2=0.999, weight_decay=0.0, eps=1e-8, amsgrad=False,
                           maximize=False)

    info = O.group_adam_kernel_info(dev)
    if info["local_bytes"]:
        raise AssertionError(f"group_adam: {info['local_bytes']} bytes of local memory")
    return [dict(case=label, kernel="group_adam", n=n, leaves=len(leaves),
                 masked_leaves=sum(x[4] is not None for x in leaves), max_abs_err=err,
                 eps_of_terms=worst, values_differing=differ, values=total, tol=K9_EPS,
                 bytes=bytes_, flops=n * 16,
                 ms=cuda_time_ms(lambda: O.group_adam(timed)),
                 device_ms=device_time_ms(lambda: O.group_adam(timed), "group_adam_kernel"),
                 plain_ms=cuda_time_ms(lambda: O.group_adam_plain(timed), 5),
                 library_ms=cuda_time_ms(lib_fn), library_device_ms=device_total_ms(lib_fn),
                 geometry={"ctas": sum(-(-p.numel() // 4096) for p, *_ in leaves), **info})]


def k10_rows(args, dev):
    """K10 on the captured frustum call (the Replica room's middle, fine
    and color grids and a 680x1200 depth frame): one launch over the
    distinct grids (fine's and color's masks one tensor), each grid's
    largest lookup (the kernel's own output) against the plain version's,
    each mask equal but for at most K10_SHARE of the nodes (a node within
    rounding of a test's boundary; tests/test_torch_cuda.py checks that
    they are), times and bound: the depth image read once and each
    distinct mask written once."""
    import torch

    from nice_slam_torch.ops import frustum as Fm
    from nice_slam_torch.ops.geometry import invert, linspace
    from nice_slam_torch.ops.interp import bilinear_sample_2d

    c2w, depth, bound, shapes, H, W, fx, fy, cx, cy = args
    got = Fm.frustum_masks(*args)
    if any((a is b) != (sa == sb) for a, sa in zip(got, shapes) for b, sb in zip(got, shapes)):
        raise AssertionError("K10: grids of one shape did not get one mask tensor")
    tops = Fm.frustum_depth_max(*args).cpu()
    nodes = sum(a * b * c for a, b, c in shapes)
    distinct = sorted(set(map(tuple, shapes)))
    items = sum(a * b * c for a, b, c in distinct)
    differ = 0
    max_err = 0.0
    w2c = invert(c2w)
    for shape, m, top in zip(shapes, got, tops):
        ref = Fm.frustum_mask_plain(*args[:3], shape, *args[4:])
        differ += int(((m[..., 0] > 0) != ref).sum())
        # the largest lookup, as the plain version takes it
        axes = [linspace(bound[a, 0], bound[a, 1], n) for a, n in enumerate(shape)]
        pts = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)
        cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
        zc = cam[:, 2] + 1e-5
        look = bilinear_sample_2d(depth, (fx * (-cam[:, 0]) + cx * cam[:, 2]) / zc,
                                  (fy * cam[:, 1] + cy * cam[:, 2]) / zc)
        max_err = max(max_err, abs(float(look.max()) - float(top)))
    if differ > K10_SHARE * nodes or max_err > 1e-5 * float(depth.max()):
        raise AssertionError(f"K10: {differ} of {nodes} nodes differ from the plain "
                             f"masks, largest lookups off by {max_err}")
    fn = lambda: Fm.frustum_masks(*args)  # noqa: E731
    info = Fm.frustum_kernel_info(dev)
    if info["local_bytes"]:
        raise AssertionError(f"frustum_mask: {info['local_bytes']} bytes of local memory")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    geo = Fm.frustum_geometry([a * b * c for a, b, c in distinct], sms, info["ctas_per_sm"])
    return [dict(case="room", kernel="frustum_mask", n=nodes, grids=len(shapes),
                 distinct_grids=len(distinct), items=items,
                 shapes=[list(s) for s in shapes], H=H, W=W, max_abs_err=max_err,
                 nodes_differing=differ, tol=K10_SHARE, bytes=H * W * 4 + 4 * items,
                 flops=items * 60, ms=cuda_time_ms(fn),
                 device_ms=device_time_ms(fn, "frustum_mask_kernel"),
                 plain_ms=cuda_time_ms(lambda: [Fm.frustum_mask_plain(*args[:3], s, *args[4:])
                                                for s in shapes], 5),
                 library_ms=None, library_device_ms=None,
                 geometry={"ctas": geo.ctas, "per_thread": geo.per_thread, **info,
                           **resident(info, geo.ctas, info["threads"] // 32, sms)})]


def k7_k10_all_rows(cap, dev):
    """Every K7-K10 row of the kernels phase."""
    rows = []
    for label in K78_CASES:
        rows += k7_k8_rows(label, cap["integrate"][label], dev)
    for label, (n, s, kernels) in K78_IMAP_CASES.items():
        rows += k7_k8_rows(label, integrator_inputs(n, s, dev), dev, kernels)
    for label in K9_CASES:
        rows += k9_row(label, cap["adam"][label], dev)
    rows += k10_rows(cap["frustum"], dev)
    return rows


RANDOM_CASES = (("fine_map", (74, 56, 43, 32), 1000),
                ("fine_track", (74, 56, 43, 32), 200),
                ("coarse_map", (11, 8, 7, 32), 1000))


def phase_kernels(dev, cases, lookups, imap_k8):
    """Every kernel's rows on the captured and drawn cases; the BA cases'
    (``ba_kernel_rows``), K3 with slab windows and K9 with the camera leaf
    beside slab leaves at BA's shapes (``ba_slab_rows``) and K8 on the
    iMAP* BA room's captured call (``imap_k8``).  Returns (rows, the BA
    window checks, the BA window rows)."""
    import torch

    gen = torch.Generator().manual_seed(0)
    rows = []
    dec_cases = cases.pop("decoder")
    ba_cases = cases.pop("ba")
    rows += k7_k10_all_rows(cases.pop("k7_k10"), dev)
    rows += ba_kernel_rows(ba_cases, dev)
    ba_checks, ba_window, k9_slabs = ba_slab_rows(ba_cases, rows, dev)
    rows += k9_slabs
    rows += k7_k8_rows("imap_map_ba", imap_k8, dev, kernels=("integrate_bwd",))
    del ba_cases
    for label in DEC_CASES:
        rows += decoder_rows(label, dec_cases[label])
    for label, shape, n_rays in RANDOM_CASES:
        grid = torch.randn(shape, generator=gen).to(dev)
        p = ray_points(n_rays, gen, dev)
        g = torch.randn((p.shape[0], shape[3]), generator=gen).to(dev)
        cases[label] = {"grids": [grid], "p": p, "gs": [g]}
        rows += kernel_rows(label, [grid], p, [g])
    for label, c in cases.items():
        if label not in dict((r[0], r) for r in RANDOM_CASES):
            rows += kernel_rows(label, c["grids"], c["p"], c["gs"])
    for label, c in lookups.items():  # K1 and K4 only: these paths take no gradient
        pts_b, gather_b, feat_b, _, _, lib_fwd, timed, held = case_tools(
            label, c["grids"], c["p"])
        rows.append(k1_row(label, c["grids"], c["p"], gather_b + pts_b + feat_b,
                           timed, held, lib_fwd))
        rows.append(decoder_fwd_row(label, c["dec"]))
    torch.cuda.synchronize()
    with_bounds(rows)
    emit({"phase": "kernels", "ok": True, "rows": rows,
          "ba_window_checks": ba_checks, "ba_window_rows": ba_window,
          "profiler_retries": PROFILER_RETRIES["windows"],
          "profiler_lost": PROFILER_RETRIES["lost"],
          "stack_max_abs_err": stack_check(dev)})
    return rows, ba_checks, ba_window


def stack_check(dev) -> float:
    """The whole decoder stack (grids, batched decoders, sentinel) on the
    card against the same port on the CPU, small input; atol 0.05 on raw
    logits (the Fourier embedding's sin at O(100) rad)."""
    import torch

    from nice_slam_torch.config import load_config
    from nice_slam_torch.convert import scene_from_jax, scene_to_numpy
    from nice_slam_torch.models.pretrain import load_pretrain
    from nice_slam_torch.models.scene import build_scene, eval_points

    cfg = load_config(os.path.join(HERE, "configs", "Synthetic", "box.yaml"),
                      os.path.join(HERE, "configs", "nice_slam.yaml"))
    for k in ("coarse", "middle_fine"):
        cfg["pretrained_decoders"][k] = os.path.join(HERE, cfg["pretrained_decoders"][k])
    spec, state = build_scene(cfg, device="cpu")
    state = load_pretrain(cfg, spec, state, verbose=False)
    gen = torch.Generator().manual_seed(1)
    state = state._replace(grids={k: 0.3 * torch.randn(v.shape, generator=gen)
                                  for k, v in state.grids.items()})
    on_dev = scene_from_jax(scene_to_numpy(state), dev)
    p = torch.rand((2000, 3), generator=gen) * 5.2 - 2.6
    worst = 0.0
    for stage in ("coarse", "middle", "fine", "color"):
        a = eval_points(spec, state, p, stage)
        b = eval_points(spec, on_dev, p.to(dev), stage).cpu()
        worst = max(worst, float((a - b).abs().max()))
    if not worst <= 0.05:
        raise AssertionError(f"decoder stack cuda vs cpu: {worst} > 0.05")
    return worst


def count_iterations(mapper, sink, key) -> None:
    """Add each optimize_map call's iteration count to ``sink[key]``, or,
    where ``key`` is a function, to ``sink[key()]``."""
    inner = mapper.optimize_map

    def counted(*a, **k):
        out = inner(*a, **k)
        name = key() if callable(key) else key
        sink[name] = sink.get(name, 0) + int(out[2].shape[0])
        return out

    mapper.optimize_map = counted


def mesh_stats(path):
    """(vertices, faces) of a PLY, which must exist and have faces."""
    from nice_slam_torch.utils.meshlib import read_ply

    if not os.path.exists(path):
        raise AssertionError(f"no mesh at {path}")
    verts, faces, _ = read_ply(path)
    if len(faces) == 0:
        raise AssertionError(f"mesh {path} has no faces")
    return verts, faces


def loop_launch_checks(slam, counts, calls, out, track_iters, map_iters, k3_want):
    """The launch rule of a strict loop on one card (the slice's, and the
    BA room's), checked on its counts: one lookup Function per decoder
    stage, so one K1 per iteration, one K3 per iteration whose points need
    a gradient (``k3_want``: tracking, and mapping under BA), one K2 per
    mapping iteration; meshing adds K1 only; K4 once per K1, K5 once per
    iteration, K6 once per iteration and decoder that trains; K7, K8 and
    K9 once per iteration, K10 once per frustum-selecting main-mapper call.
    Also checks the final meshes and checkpoint.  Returns (meshes, mesher
    K1 launches, K6 launches, frustum calls)."""
    import math

    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    # the meshes: final_mesh.ply (copied to its frame's name) and the
    # eval_rec variant; each is one K1 per lattice chunk and one per
    # vertex-colour chunk of points_batch_size points
    mesh_dir = os.path.join(out, "mesh")
    chunk = slam.rcfg.points_batch_size
    lattice = slam.mesher.resolution ** 3
    meshes, mesh_chunks = [], 0
    for name in ("final_mesh.ply", "final_mesh_eval_rec.ply"):
        verts, faces = mesh_stats(os.path.join(mesh_dir, name))
        rec = next(m for m in slam.meshes if m["path"].endswith(name))
        mesh_chunks += math.ceil(lattice / chunk) + math.ceil(len(verts) / chunk)
        meshes.append({"mesh": name, "vertices": len(verts), "faces": len(faces),
                       "seconds": rec["seconds"],
                       "steps_s": {k: v for k, v in rec.items() if k.endswith("_s")}})
    ckpt = os.path.join(out, "ckpts", f"{slam.n_img - 1:05d}.tar")
    if not os.path.exists(ckpt):
        raise AssertionError(f"no final checkpoint at {ckpt}")
    if counts["trilinear_fwd"] != track_iters + map_iters + mesh_chunks:
        raise AssertionError(f"K1 launched {counts['trilinear_fwd']} times for "
                             f"{track_iters} tracking + {map_iters} mapping iterations "
                             f"+ {mesh_chunks} mesher chunks")
    if counts["trilinear_bwd_dp"] != k3_want:
        raise AssertionError(f"K3 launched {counts['trilinear_bwd_dp']} times for "
                             f"{k3_want} iterations whose points need a gradient "
                             f"({track_iters} tracking)")
    if counts["trilinear_bwd_dgrid"] != map_iters:
        raise AssertionError(f"K2 launched {counts['trilinear_bwd_dgrid']} times "
                             f"for {map_iters} mapping iterations")
    k6 = sum(c[4] for c in calls)
    if (counts["decoder_fwd"], counts["decoder_bwd"], counts["decoder_wgrad_sum"]) != \
            (counts["trilinear_fwd"], track_iters + map_iters, k6):
        raise AssertionError(f"K4-K6 launched {counts} for {counts['trilinear_fwd']} "
                             f"lookups, {track_iters + map_iters} iterations and {k6} "
                             "training decoder-iterations")
    frustum = sum(c[5] for c in calls)
    want = k7_k10_want(track_iters + map_iters, frustum)
    if {k: counts[k] for k in K7_K10} != want:
        raise AssertionError(f"K7-K10 launched {counts}, expected {want} for "
                             f"{track_iters + map_iters} iterations and {frustum} "
                             "frustum-selecting mapping calls")
    return meshes, mesh_chunks, k6, frustum


def phase_slice(dev):
    import torch

    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.tools.eval_ate import ate_rmse
    from nice_slam_torch.tools.workloads import replica_synthetic_cfg

    out = os.path.join(HERE, "output", "chip_smoke", "slice")
    shutil.rmtree(out, ignore_errors=True)  # the resume phase reads its last checkpoint
    cfg = replica_synthetic_cfg(out, n_frames=12, iters_first=SLICE_ITERS_FIRST)
    slam = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None), dev)
    for i in range(slam.n_img):  # frame synthesis is not part of the timing
        slam.frame_reader[i]
    iters = {"mapping": 0, "coarse_mapping": 0}
    count_iterations(slam.mapper, iters, "mapping")
    count_iterations(slam.coarse_mapper, iters, "coarse_mapping")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    calls = []
    with recorded_core(calls):
        slam.run()
    counts = all_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    est = slam.estimate_c2w_list.cpu().numpy()
    if not torch.isfinite(slam.estimate_c2w_list).all():
        raise AssertionError("non-finite poses in the slice run")
    t = slam.timings
    track_iters = t["tracked_frames"] * slam.tcfg.iters
    map_iters = iters["mapping"] + iters["coarse_mapping"]
    # BA off: mapping never needs the points' gradient
    meshes, mesh_chunks, k6, frustum = loop_launch_checks(
        slam, counts, calls, out, track_iters, map_iters, track_iters)
    ckpt = os.path.join(out, "ckpts", f"{slam.n_img - 1:05d}.tar")
    grids = {k: list(v.shape) for k, v in slam.state.grids.items()}
    record = {"phase": "slice", "ok": True, "frames": slam.n_img,
          "H": slam.H, "W": slam.W, "grids": grids,
          "iters_first": SLICE_ITERS_FIRST,
          "tracking_ms_per_frame": t.get("tracking_ms_per_frame"),
          "mapping_ms_per_event": t.get("mapping_ms_per_event"),
          "coarse_mapping_ms_per_event": t.get("coarse_mapping_ms_per_event"),
          "mapping_ms_per_iter": 1e3 * t["mapping_s"] / iters["mapping"],
          "coarse_mapping_ms_per_iter":
              1e3 * t["coarse_mapping_s"] / iters["coarse_mapping"],
          "tracking_ms_per_iter":
              t["tracking_ms_per_frame"] / slam.tcfg.iters,
          "mapping_iters": iters, "tracking_iters": track_iters,
          "fps": t.get("fps"), "total_s": t.get("total_s"),
          "meshing_s": t["meshing_s"],
          "fps_without_meshing": t["frames"] / (t["total_s"] - t["meshing_s"]),
          "meshes": meshes, "mesher_k1_launches": mesh_chunks,
          "resolution": slam.mesher.resolution, "checkpoint": ckpt,
          "mapping_events": t["mapping_events"],
          "coarse_mapping_events": t["coarse_mapping_events"],
          "tracked_frames": t["tracked_frames"],
          "ate_cm": 100 * ate_rmse(est, slam.gt_c2w_list),
          "launches": counts,
          "launches_per_tracking_iter": counts["trilinear_bwd_dp"] / track_iters,
          "k1_launches_per_iter": (counts["trilinear_fwd"] - mesh_chunks)
          / (track_iters + map_iters),
          "k2_launches_per_mapping_iter": counts["trilinear_bwd_dgrid"] / map_iters,
          "k6_launches": k6, "frustum_calls": frustum, "peak_mem_gib": peak_gib}
    emit(record)
    return counts, slam, cfg, record


def phase_resume(dev, done, cfg):
    """A fresh system on the slice's config resumes from the slice's final
    checkpoint: the restored state and poses equal the slice's bit for
    bit, and the run would start past the last frame."""
    import torch

    from nice_slam_torch.slam.slam import NiceSLAM

    t0 = time.perf_counter()
    slam = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None), dev)
    start = slam.resume()
    if start != done.n_img:
        raise AssertionError(f"resume starts at {start}, not {done.n_img}")
    diff = []
    for name, g in done.state.grids.items():
        if not torch.equal(slam.state.grids[name], g):
            diff.append(name)
    flat_a, flat_b = leaves(done.state.decoders), leaves(slam.state.decoders)
    if len(flat_a) != len(flat_b) or not all(torch.equal(a, b) for a, b in zip(flat_a, flat_b)):
        diff.append("decoders")
    if not torch.equal(slam.estimate_c2w_list, done.estimate_c2w_list):
        diff.append("estimate_c2w_list")
    if slam.keyframes.frame_ids != done.keyframes.frame_ids:
        diff.append("keyframes")
    if diff:
        raise AssertionError(f"resumed state differs from the slice's: {diff}")
    emit({"phase": "resume", "ok": True, "start": start,
          "grids": sorted(done.state.grids), "decoder_tensors": len(flat_a),
          "keyframes": slam.keyframes.frame_ids,
          "seconds": time.perf_counter() - t0})


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def phase_vis(dev, done):
    """One full-frame residual panel of the slice's final state at its last
    frame: render_img in ray_batch_size chunks, one K1 launch each."""
    import math

    import torch

    from nice_slam_torch.utils.visualizer import Visualizer

    out = os.path.join(HERE, "output", "chip_smoke", "vis")
    vis = Visualizer(1, 1, out, done.spec, done.rcfg, done.cam)
    idx = done.n_img - 1
    _, color, depth, _ = done.frame_reader[idx]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    path = vis.vis(idx, 0, depth, color, done.estimate_c2w_list[idx], done.state)
    seconds = time.perf_counter() - t0
    counts = all_counts()
    chunks = math.ceil(done.H * done.W / done.rcfg.ray_batch_size)
    if path is None or not os.path.exists(path):
        raise AssertionError(f"no panel written (got {path})")
    want = {"trilinear_fwd": chunks, "decoder_fwd": chunks, "integrate_fwd": chunks}
    if counts != {k: want.get(k, 0) for k in counts}:
        raise AssertionError(f"the panel launched {counts}, not {chunks} K1, K4 and K7 "
                             "only")
    emit({"phase": "vis", "ok": True, "path": path, "H": done.H, "W": done.W,
          "ray_chunks": chunks, "seconds": seconds, "launches": counts})


def phase_profile(dev):
    """``nice_slam_torch.run --profile`` on three frames of the box scene
    at 120x160: the torch.profiler trace it writes under
    <output>/torch_trace/ holds K1's and K4's kernels."""
    import glob

    from nice_slam_torch.run import main as run_main

    out = os.path.join(HERE, "output", "chip_smoke", "profile")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    yaml = os.path.join(out, "box.yaml")
    with open(yaml, "w") as f:
        f.write(f"""inherit_from: {HERE}/configs/Synthetic/box.yaml
verbose: false
meshing: null
mapping: {{iters_first: 30, iters: 10, mesh_freq: 1000000, ckpt_freq: 1000000}}
data: {{n_frames: 3, output: {out}/run}}
""")
    t0 = time.perf_counter()
    cwd = os.getcwd()
    os.chdir(HERE)  # box.yaml names its pretrained decoders from the root
    try:
        run_main([yaml, "--profile", "--device", str(dev)])
    finally:
        os.chdir(cwd)
    traces = glob.glob(os.path.join(out, "run", "torch_trace", "*.json"))
    if len(traces) != 1:
        raise AssertionError(f"--profile wrote {traces}, not one trace")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {k: sum(k in name for name in kernels)
             for k in ("trilinear_fwd", "decoder_fwd_kernel")}
    if not all(found.values()):
        raise AssertionError(f"the trace's kernels lack K1 or K4: {found}")
    emit({"phase": "profile", "ok": True, "trace": traces[0],
          "trace_bytes": os.path.getsize(traces[0]), "events": len(events),
          "kernel_events": found, "seconds": time.perf_counter() - t0})


DRAW_TIMEOUT_S = 900  # a family's draws run at once (one alone: 10-30 s on an H100)
# a draw's host-clock fields, read beside its siblings (``draws_at_once``)
CONTENDED_KEYS = ("fps", "meshing_s", "metric_2d_s", "timings", "seconds")


def draws_at_once(kind, runs, timeout=DRAW_TIMEOUT_S):
    """The records of one draw of ``kind`` (``DRAWS``) per keyword
    arguments of ``runs``, in order, each in a process of its own
    (``--draw KIND --draw_args JSON``), all at once: the box runs are
    host-bound, so the card has room for several, and the iMAP* draws are
    GPU-bound.  Each record's host-clock fields (CONTENDED_KEYS) are moved
    under ``contended``, beside the number of draws that ran at once: they
    are not single-run numbers.  A draw that fails fails the run, and no
    draw is left running.  This process first hands the card's memory that
    its allocator keeps cached back to the driver: the draws run beside it
    (one run OOMed with ~79 GiB held on the card)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    try:
        for kw in runs:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--draw", kind,
                 "--draw_args", json.dumps(kw)], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=env, cwd=HERE))
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    records = []
    for kw, p, (stdout, stderr) in zip(runs, procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"{kind} draw {kw} exited {p.returncode}: {stderr[-3000:]}")
        rec = json.loads(stdout.strip().splitlines()[-1])
        rec["contended"] = {"draws_at_once": len(runs),
                            **{k: rec.pop(k) for k in CONTENDED_KEYS if k in rec}}
        records.append(rec)
    return records


def box_runs(label, ba=False, seeds=QUALITY_SEEDS, devices=None, sync="strict"):
    """The keyword arguments of a box family's draws (``box_draw``), one
    per seed."""
    devs = None if devices is None else [str(d) for d in devices]
    if sync == "strict":
        return [dict(label=label, seed=seed, ba=ba, devices=devs) for seed in seeds]
    return [dict(label=label, seed=seed, devices=devs, sync=sync, mesh=False)
            for seed in seeds]


def imap_box_runs(label, ba=False):
    """The keyword arguments of an iMAP* box family's draws
    (``imap_box_draw``; IMAP_QUALITY_SEEDS, the first scored where BA is
    off)."""
    return [dict(label=label, seed=seed, ba=ba) if ba else
            dict(label=label, seed=seed, scored=seed == IMAP_QUALITY_SEEDS[0])
            for seed in IMAP_QUALITY_SEEDS]


def box_draw(dev, label, seed, ba=False, devices=None, sync="strict", mesh=True):
    """One 30-frame tracked box run (``box_quality_cfg``, BA on where
    ``ba``, under ``sync``) with pixel seed ``seed`` in this process; with
    ``devices`` the grids sharded over them (NICE_SLAM_TORCH_SPATIAL=1).
    Returns its ATE, its BA calls and, with ``mesh``, its final mesh's wall
    distance."""
    import torch

    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.tools.eval_ate import ate_rmse
    from nice_slam_torch.tools.workloads import box_quality_cfg

    out = os.path.join(HERE, "output", "chip_smoke", f"{label}_s{seed}")
    cfg = box_quality_cfg(out, ba=ba)
    cfg.update(seed=seed, sync_method=sync)
    ns = argparse.Namespace(nice=True, output=None)
    if devices is None:
        slam = NiceSLAM(cfg, ns, dev)
    else:
        devices = [torch.device(d) for d in devices]
        with knobs(True):
            slam = NiceSLAM(cfg, ns, devices=devices)
        if slam.spatial_devices != devices:
            raise AssertionError(f"{label}: sharding not engaged over {devices}")
    ba_calls = []
    inner = slam.mapper.optimize_map

    def mapped(*a, **k):
        ba_calls.append(bool(a[7] if len(a) > 7 else k["BA"]))
        return inner(*a, **k)

    slam.mapper.optimize_map = mapped
    slam.run()
    t = slam.timings
    draw = {"seed": seed, "fps": t.get("fps"), "mapping_events": t["mapping_events"],
            "ate_rmse_cm": 100 * ate_rmse(slam.estimate_c2w_list.cpu().numpy(),
                                          slam.gt_c2w_list), "ba_calls": sum(ba_calls)}
    if mesh:
        verts, _ = mesh_stats(os.path.join(out, "mesh", "final_mesh.ply"))
        draw.update(mesh_wall_m=box_wall_distance(verts), vertices=len(verts),
                    meshing_s=t["meshing_s"])
    return draw


def box_family(dev, label, ba=False, seeds=QUALITY_SEEDS, devices=None):
    """The 30-frame tracked box run (``box_draw``, BA on where ``ba``) for
    each of ``seeds`` (``cfg["seed"]`` feeds the tracker's pixel draws),
    the draws run at once (``draws_at_once``; the strict schedule's result
    does not depend on the host's speed), each draw's ATE, final mesh and
    BA calls; with
    ``devices`` the grids sharded over them.  Returns the record of the
    draws, the family's medians, and whether the strict family's gates
    hold (median ATE <= ATE_GATE_CM, every draw <= ATE_DIVERGED_CM, median
    wall distance <= BOX_MESH_GATE_M)."""
    import numpy as np

    draws = draws_at_once("box", box_runs(label, ba, seeds, devices))
    ates = [d["ate_rmse_cm"] for d in draws]
    median = float(np.median(ates))
    walls = [d["mesh_wall_m"] for d in draws]
    wall_median = float(np.median(walls))
    ok = (median <= ATE_GATE_CM and max(ates) <= ATE_DIVERGED_CM
          and wall_median <= BOX_MESH_GATE_M)
    record = {"frames": 30, "devices": None if devices is None else [str(d) for d in devices],
              "draws": draws, "median_ate_cm": median,
              "gate_cm": ATE_GATE_CM, "draw_gate_cm": ATE_DIVERGED_CM,
              "within_jax_median_gate": median <= JAX_MEDIAN_GATE_CM,
              "median_mesh_wall_m": wall_median, "mesh_gate_m": BOX_MESH_GATE_M}
    return record, ok


def strict_family_failure(label, rec) -> AssertionError:
    ates = [d["ate_rmse_cm"] for d in rec["draws"]]
    walls = [d["mesh_wall_m"] for d in rec["draws"]]
    seeds = [d["seed"] for d in rec["draws"]]
    return AssertionError(f"{label}: tracked ATE over seeds {seeds}: {ates} cm; "
                          f"median {rec['median_ate_cm']:.3f} (gate {ATE_GATE_CM}), worst "
                          f"draw gate {ATE_DIVERGED_CM}; box mesh wall distance {walls} m, "
                          f"median {rec['median_mesh_wall_m']:.4f} (gate {BOX_MESH_GATE_M})")


def phase_quality(dev):
    """The 30-frame tracked box run over a family of pixel seeds
    (``box_family``).  One draw is too
    noisy to gate: K2 sums with atomics in a run-dependent order and 30
    frames of tracking amplify the last ulps (single draws spread
    1.84-12.67 cm on one H100 and exceeded 9.5 cm about once in 15).  So
    the median of the family
    is gated at ATE_GATE_CM and every draw at ATE_DIVERGED_CM, which only a
    diverged run exceeds."""
    t0 = time.perf_counter()
    rec, ok = box_family(dev, "quality")
    emit({"phase": "quality", "ok": ok, **rec, "seconds": time.perf_counter() - t0})
    if not ok:
        raise strict_family_failure("quality", rec)
    return rec["median_ate_cm"]


def box_wall_distance(verts) -> float:
    """The median over a box mesh's vertices of | max(|x|,|y|,|z|) - 2 |:
    how far the surface lies from the box room's walls at +-2 m."""
    import numpy as np

    return float(np.median(np.abs(np.abs(verts).max(axis=1) - 2.0)))


BA_FRAMES = 30               # the BA room: five keyframes (0-20) first at frame 25
BA_EVENTS = [25] + [29] * 5  # its BA calls: frame 25, and the last frame's refinement
BA_K3_CASES = ("map_middle_ba", "map_fine_ba", "map_color_ba")  # 1, 2 and 3 grids
BA_K9_CASES = ("map_color_ba", "map_middle_ba")  # the camera leaf at BA_cam_lr, at lr 0
BA_LOOSE_SEED = 42


@contextlib.contextmanager
def ba_recorder(slam):
    """Record each optimize_map call of ``slam``'s mappers: frame, coarse,
    BA, keyframes in the store, the overlap window's positions and their
    validity (``prepare_window``'s), the keyframe poses before and after
    the call, the poses written back (position, pose) and the refined
    current pose; and each main mapping event's wall (``map_one`` ends in a
    synchronize).  A window is the overlap selection's (``prepare_window``)
    or the host's 'global' one (``select_keyframes`` and the last
    keyframe).  Yields the record."""
    import torch

    from nice_slam_torch.slam import mapper as M

    rec = {"calls": [], "events": []}
    windows = []
    inner_window, inner_select = M.prepare_window, M.select_keyframes

    def prepare_window(*a, **k):
        out = inner_window(*a, **k)
        windows.append((out[6].clone(), out[5][:-1].clone()))  # read after the run
        return out

    def select_keyframes(rng, mcfg, n_keyframes):
        # a host-selected window ('global'): the selected positions and the
        # last keyframe, every slot valid
        out = inner_select(rng, mcfg, n_keyframes)
        pos = out + ([n_keyframes - 1] if n_keyframes > 0 else [])
        windows.append((torch.tensor(pos, dtype=torch.int64),
                        torch.ones(len(pos), dtype=torch.bool)))
        return out

    def watch(mapper, coarse):
        inner = mapper.optimize_map

        def wrapped(state, iters, lr_factor, color, depth, keyframes, cur_c2w, BA, **k):
            n_kf = len(keyframes)
            arrays = keyframes.arrays
            before = arrays.est_c2w[:n_kf].clone()
            seen, writes = len(windows), []
            if BA:
                set_inner = keyframes.set_est_c2w
                keyframes.set_est_c2w = lambda pos, c2w: (
                    writes.append((int(pos), c2w.clone())), set_inner(pos, c2w))[1]
            try:
                out = inner(state, iters, lr_factor, color, depth, keyframes, cur_c2w, BA,
                            **k)
            finally:
                if BA:
                    del keyframes.set_est_c2w
            rec["calls"].append({
                "idx": k.get("idx"), "coarse": coarse, "BA": bool(BA), "n_kf": n_kf,
                "iters": int(out[2].shape[0]),
                "window": windows[-1] if len(windows) > seen else None,
                "before": before, "after": keyframes.arrays.est_c2w[:n_kf].clone(),
                "writes": writes, "cur": None if out[1] is None else out[1].clone()})
            return out

        mapper.optimize_map = wrapped

    inner_map = slam.map_one

    def map_one(idx, *a, **k):
        t0 = time.perf_counter()
        n = len(rec["calls"])
        out = inner_map(idx, *a, **k)
        calls = rec["calls"][n:]
        rec["events"].append({"idx": idx, "coarse": bool(k.get("coarse", False)),
                              "ba": any(c["BA"] for c in calls),
                              "ms": 1e3 * (time.perf_counter() - t0)})
        return out

    watch(slam.mapper, False)
    if slam.coarse_mapper is not None:
        watch(slam.coarse_mapper, True)
    slam.map_one = map_one
    M.prepare_window, M.select_keyframes = prepare_window, select_keyframes
    try:
        yield rec
    finally:
        M.prepare_window, M.select_keyframes = inner_window, inner_select


def check_ba_calls(rec, final_poses, tag):
    """BA's rule on the recorded calls (``ba_recorder``): BA in exactly the
    main-mapper calls made with more than four keyframes in the store and
    in no coarse call; each BA call writes back every valid window keyframe
    but the oldest, once, leaves every other keyframe's pose (the
    oldest's included) equal bit for bit, and returns a refined current
    pose, which is the pose the run ends with for that frame.  Returns the
    frames of the BA calls."""
    import torch

    calls = rec["calls"]
    bad = [(c["idx"], c["n_kf"], c["BA"]) for c in calls
           if c["BA"] != (not c["coarse"] and c["n_kf"] > 4)]
    if bad:
        raise AssertionError(f"{tag}: BA engaged against the rule len(keyframes) > 4 "
                             f"(frame, keyframes, BA): {bad}")
    last = {}
    for c in calls:
        if not c["BA"]:
            if c["writes"] or not torch.equal(c["before"], c["after"]):
                raise AssertionError(f"{tag}: a call without BA at frame {c['idx']} "
                                     "changed a keyframe pose")
            continue
        window = None
        if c["window"] is not None:
            positions, valid = (x.tolist() for x in c["window"])
            window = sorted(p for p, v in zip(positions, valid) if v)
        if not window or window[-1] != c["n_kf"] - 1:
            raise AssertionError(f"{tag}: frame {c['idx']}: window {window} lacks the "
                                 f"last keyframe {c['n_kf'] - 1}")
        written = sorted(pos for pos, _ in c["writes"])
        if written != window[1:]:
            raise AssertionError(f"{tag}: frame {c['idx']}: wrote back {written}, not the "
                                 f"window {window} but its oldest")
        want = c["before"].clone()
        for pos, pose in c["writes"]:
            want[pos] = pose
        if not torch.equal(c["after"], want):
            raise AssertionError(f"{tag}: frame {c['idx']}: the store's poses after the "
                                 "call are not those before it with the written ones")
        if c["cur"] is None:
            raise AssertionError(f"{tag}: frame {c['idx']}: no refined current pose")
        last[c["idx"]] = c["cur"]
    for idx, pose in last.items():
        if not torch.equal(final_poses[idx], pose):
            raise AssertionError(f"{tag}: frame {idx} does not end at its refined pose")
    return [c["idx"] for c in calls if c["BA"]]


def ba_capture(dev):
    """The BA cases' kernel arguments, as a BA mapping call hands them to
    the kernels: K3 and K5 of each stage, K8 of the color stage, K9's
    color-stage and lr-0 camera steps (the first of each).  From a
    7-frame run of the BA room with a keyframe and a mapping event every
    frame, so BA engages at frame 5 in a call with all three stages (frame
    6, the last, is the color-only refinement); the shapes are the room's
    (1000 rays x 48 samples a mapping iteration).  Also the first BA
    call's arguments (``first_call``: its scene state, window, poses and
    configs), which the ray-DP check runs again.  Run early in the
    process: the card's profiler records fewer of a window's kernels the
    later it runs (PERF.md §7), and the kernels phase times these cases."""
    import inspect

    from nice_slam_torch.ops import decoder_stage as DS
    from nice_slam_torch.ops import interp
    from nice_slam_torch.slam import mapper as M
    from nice_slam_torch.slam.optim import tree_map
    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.tools.workloads import replica_ba_cfg

    t0 = time.perf_counter()
    cfg = replica_ba_cfg(os.path.join(HERE, "output", "chip_smoke", "ba_capture"),
                         n_frames=7, iters_first=CAPTURE_ITERS_FIRST)
    cfg.pop("meshing")
    cfg["mapping"].update(every_frame=1, keyframe_every=1)
    slam = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None), dev)
    cap, restore = k7_k10_captures(("map_color_ba",), BA_K9_CASES)
    label = cap["state"]
    k3_seen, dec_seen = {}, {}
    dp_multi, dec_bwd = interp.trilinear_bwd_dp_multi, DS.decoder_bwd

    def rec_dp(grids, p, gs):
        if label["label"] in BA_K3_CASES and label["label"] not in k3_seen:
            k3_seen[label["label"]] = {"grids": [g.detach().clone() for g in grids],
                                       "p": p.detach().clone(),
                                       "gs": [g.detach().clone() for g in gs]}
        return dp_multi(grids, p, gs)

    def rec_dec(*args):
        case = dec_case_of(label["label"], args[5])
        if case in BA_K3_CASES and case not in dec_seen:
            dec_seen[case] = dec_bwd_case(*args)
        return dec_bwd(*args)

    first_call = {}
    core = M.optimize_map_core
    core_sig = inspect.signature(core)

    def rec_core(*a, **k):
        b = core_sig.bind(*a, **k).arguments
        if b["BA"] and not first_call:
            first_call.update({k: v for k, v in b.items() if k not in ("state", "gen")},
                              state=b["state"]._replace(
                                  grids=tree_map(lambda t: t.clone(), b["state"].grids),
                                  decoders=tree_map(lambda t: t.clone(),
                                                    b["state"].decoders)))
        return core(*a, **k)

    interp.trilinear_bwd_dp_multi, DS.decoder_bwd = rec_dp, rec_dec
    M.optimize_map_core = rec_core
    try:
        slam.run()
    finally:
        interp.trilinear_bwd_dp_multi, DS.decoder_bwd = dp_multi, dec_bwd
        M.optimize_map_core = core
        restore()
    missing = [f"K3/K5 {k}" for k in BA_K3_CASES if k not in k3_seen or k not in dec_seen]
    missing += [f"K8 {k}" for k in ("map_color_ba",)
                if "g_depth" not in cap["integrate"].get(k, {})]
    missing += [f"K9 {k}" for k in BA_K9_CASES if k not in cap["adam"]]
    if not first_call:
        missing.append("the first BA call")
    if missing:
        raise AssertionError(f"BA capture: no BA call captured for {missing}")
    emit({"phase": "ba_capture", "ok": True, "seconds": time.perf_counter() - t0,
          "cases": {k: {"n": v["p"].shape[0], "grids": len(v["grids"])}
                    for k, v in k3_seen.items()},
          "decoder_cases": {k: {"decoders": len(v["decs"]), "need_p": v["need_p"],
                                "need_w": v["need_w"]} for k, v in dec_seen.items()}})
    return {"k3": k3_seen, "decoder": dec_seen, "k7_k10": cap, "first_call": first_call}


def ba_room(dev):
    """The BA room run (``replica_ba_cfg``, 30 frames) with its launches
    and BA's calls recorded and checked; returns the record and the
    counts."""
    import torch

    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.tools.eval_ate import ate_rmse
    from nice_slam_torch.tools.workloads import replica_ba_cfg

    out = os.path.join(HERE, "output", "chip_smoke", "ba_room")
    shutil.rmtree(out, ignore_errors=True)
    cfg = replica_ba_cfg(out, n_frames=BA_FRAMES, iters_first=SLICE_ITERS_FIRST)
    slam = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None), dev)
    for i in range(slam.n_img):  # frame synthesis is not part of the timing
        slam.frame_reader[i]
    iters = {"mapping": 0, "coarse_mapping": 0}
    count_iterations(slam.mapper, iters, "mapping")
    count_iterations(slam.coarse_mapper, iters, "coarse_mapping")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    calls = []
    with recorded_core(calls), ba_recorder(slam) as ba:
        slam.run()
    counts = all_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    n, t = slam.n_img, slam.timings
    if not torch.isfinite(slam.estimate_c2w_list).all() or t["tracked_frames"] != n - 1:
        raise AssertionError(f"BA room: tracked {t['tracked_frames']} of {n - 1} frames, "
                             "or a pose is not finite")
    ba_frames = check_ba_calls(ba, slam.estimate_c2w_list, "BA room")
    if ba_frames != BA_EVENTS:
        raise AssertionError(f"BA room: BA calls at frames {ba_frames}, not {BA_EVENTS}")
    track_iters = t["tracked_frames"] * slam.tcfg.iters
    map_iters = iters["mapping"] + iters["coarse_mapping"]
    ba_iters = sum(c["iters"] for c in ba["calls"] if c["BA"])
    # K3 once per iteration whose points need a gradient: every tracking
    # iteration and every BA mapping iteration, each stage's
    meshes, mesh_chunks, k6, frustum = loop_launch_checks(
        slam, counts, calls, out, track_iters, map_iters, track_iters + ba_iters)
    events = [e for e in ba["events"] if not e["coarse"]]
    regular = [e for e in events if 0 < e["idx"] < n - 1]  # not the first, not the refinement
    est = slam.estimate_c2w_list.cpu().numpy()
    return {
        "frames": n, "H": slam.H, "W": slam.W, "iters_first": SLICE_ITERS_FIRST,
        "grids": {k: list(v.shape) for k, v in slam.state.grids.items()},
        "fps": t.get("fps"), "total_s": t["total_s"], "meshing_s": t["meshing_s"],
        "tracking_ms_per_frame": t.get("tracking_ms_per_frame"),
        "mapping_ms_per_event": t.get("mapping_ms_per_event"),
        "coarse_mapping_ms_per_event": t.get("coarse_mapping_ms_per_event"),
        "mapping_ms_per_event_ba": [e["ms"] for e in regular if e["ba"]],
        "mapping_ms_per_event_without_ba": [e["ms"] for e in regular if not e["ba"]],
        "refinement_ms": [e["ms"] for e in events if e["idx"] == n - 1],
        "ate_cm": 100 * ate_rmse(est, slam.gt_c2w_list),
        "ba_calls": ba_frames, "ba_iterations": ba_iters, "tracking_iters": track_iters,
        "mapping_iters": iters, "launches": counts, "k6_launches": k6,
        "frustum_calls": frustum, "mesher_k1_launches": mesh_chunks, "meshes": meshes,
        "peak_mem_gib": peak_gib,
        "write_backs": sum(len(c["writes"]) for c in ba["calls"])}, counts


def ba_kernel_rows(cases, dev):
    """The BA cases' kernel rows: K3 over the middle stage's one grid, the
    fine stage's two and the color stage's three (48k points); K4, K5 and
    K6 on each stage's decoder call with the points' gradient; K8 on the
    color stage's integrator call; K9 on the color stage's step (the
    camera leaf at BA_cam_lr) and the middle stage's (at lr 0); each
    against its plain version under its gate, with its bound."""
    rows = []
    for label in BA_K3_CASES:
        c = cases["k3"][label]
        rows.append(k3_row(label, c["grids"], c["p"], c["gs"]))
    for label in BA_K3_CASES:
        rows += decoder_rows(label, cases["decoder"][label])
    cap = cases["k7_k10"]
    rows += k7_k8_rows("map_color_ba", cap["integrate"]["map_color_ba"], dev,
                       kernels=("integrate_bwd",))
    for label in BA_K9_CASES:
        leaves = cap["adam"][label]
        cams = [x for x in leaves if tuple(x[0].shape[1:]) == (7,)]
        if len(cams) != 1:
            raise AssertionError(f"K9 {label}: {len(cams)} camera leaves in the step")
        row = k9_row(label, leaves, dev)[0]
        lr = cams[0][7]
        row["camera_lr"] = float(lr)
        row["camera_rows"] = int(cams[0][0].shape[0])
        rows.append(row)
    return rows


def ba_loose_draw(dev):
    """The box run with BA under loose (seed BA_LOOSE_SEED, a keyframe per
    mapping event): every frame tracked, the last mapped, the loose lag,
    the ATE, BA's rule and
    write-backs (``check_ba_calls``: every pose the mapper refines is the
    one the run ends with, though the tracker writes the pose list
    concurrently)."""
    import threading

    import torch

    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.tools.eval_ate import ate_rmse
    from nice_slam_torch.tools.workloads import box_quality_cfg

    out = os.path.join(HERE, "output", "chip_smoke", "ba_loose")
    shutil.rmtree(out, ignore_errors=True)
    cfg = box_quality_cfg(out, ba=True)
    cfg.update(seed=BA_LOOSE_SEED, sync_method="loose")
    # a keyframe at every mapping event: the loose mapper maps the latest
    # tracked frame, so with the box's keyframe every 5th frame it keeps one
    # only when a mapped frame falls on a multiple of 5, and BA (five
    # keyframes) did not engage in 30 frames on an H100 (3 keyframes)
    cfg["mapping"]["keyframe_every"] = 1
    slam = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None), dev)
    lags, threads = [], set()
    inner_track = slam.track_one

    def tracked(idx, *a, **k):
        lags.append(idx - slam.mapping_idx)
        return inner_track(idx, *a, **k)

    slam.track_one = tracked
    inner_set = slam._set_pose

    def set_pose(idx, c2w):
        threads.add(threading.current_thread().name)
        return inner_set(idx, c2w)

    slam._set_pose = set_pose
    with ba_recorder(slam) as ba:
        slam.run()
    n, t = slam.n_img, slam.timings
    if t["tracked_frames"] != n - 1 or slam.mapping_idx != n - 1 or \
            not torch.isfinite(slam.estimate_c2w_list).all():
        raise AssertionError(f"loose BA: tracked {t['tracked_frames']} frames, "
                             f"mapping_idx {slam.mapping_idx}; expected {n - 1} each")
    ba_frames = check_ba_calls(ba, slam.estimate_c2w_list, "loose BA")
    every = slam.mcfg.every_frame
    ate = 100 * ate_rmse(slam.estimate_c2w_list.cpu().numpy(), slam.gt_c2w_list)
    record = {"seed": BA_LOOSE_SEED, "frames": n, "fps": t.get("fps"),
              "mapping_events": t["mapping_events"], "ba_calls": ba_frames,
              "write_backs": sum(len(c["writes"]) for c in ba["calls"]),
              "max_lag": max(lags), "lag_gate": every + every // 2, "ate_rmse_cm": ate,
              "draw_gate_cm": ATE_DIVERGED_CM, "pose_writers": sorted(threads)}
    failed = []
    if not ba_frames:
        failed.append("BA never engaged")
    if max(lags) > every + every // 2:
        failed.append(f"lag {max(lags)} > {every + every // 2}")
    if not ate <= ATE_DIVERGED_CM:
        failed.append(f"ATE {ate:.3f} cm > {ATE_DIVERGED_CM}")
    return record, failed


def phase_ba(dev, strict, strict_median_cm):
    """Bundle adjustment, the NICE default, on the card: the BA room (its
    launches, BA's calls and write-backs), the BA box family under the
    strict family's gates beside the BA-off family's median, and one
    loose BA draw (the BA cases' kernel rows come from ``ba_capture``, in
    the kernels phase).  Returns the BA room's launch counts and record."""
    t0 = time.perf_counter()
    room, counts = ba_room(dev)
    t1 = time.perf_counter()
    family, family_ok = box_family(dev, "ba_quality", ba=True)
    t2 = time.perf_counter()
    loose, loose_failed = ba_loose_draw(dev)
    t3 = time.perf_counter()
    keys = ("fps", "tracking_ms_per_frame", "mapping_ms_per_event",
            "coarse_mapping_ms_per_event", "ate_cm", "frames")
    emit({"phase": "ba", "ok": family_ok and not loose_failed, "room": room,
          "slice_without_ba": {k: strict.get(k) for k in keys},
          "box_family": family, "box_family_without_ba_median_cm": strict_median_cm,
          "loose": loose, "loose_failed": loose_failed,
          "seconds": {"room": t1 - t0, "box_family": t2 - t1, "loose": t3 - t2,
                      "total": t3 - t0}})
    if not family_ok:
        raise strict_family_failure("BA box family", family)
    if loose_failed:
        raise AssertionError(f"loose BA draw failed: {loose_failed}")
    return counts, room


# ---------------------------------------------------------------------------
# BA on the parallel paths (grids over slabs, rays over replicas) and on iMAP*
# ---------------------------------------------------------------------------

BA_SLAB_DS = (2, 4)          # (a): the BA cases' K3 cut into 2 and 4 slabs
BA_SHARD_D = 4               # (b): the BA room with its grids over [cuda:0] x 4
BA_BOX_D = 2                 # (c): the BA box family over 2 slabs
BA_BOX_SEEDS = (42, 0, 1)
BA_DP_D = 2                  # (d): the first BA call with its rays over [cuda:0] x 2
# (d) holds the losses iteration by iteration from one state: two runs of a
# call drift apart, because Adam's first step of a group moves an entry by
# its lr whatever its gradient's size, so rounding flips the steps of
# entries whose gradient is ~0 (on the CPU, where every kernel is
# deterministic, a 100-ray call's losses one device against ray DP read
# 1e-7 until the color stage's first step and 4.6e-3 two steps later), and
# K2's atomics add run-to-run noise on the card (over 20 iterations: 2.5e-4
# relative in the losses and 4.1e-5 in the poses in one of three runs on an
# H100 80GB HBM3, 700 W).  The poses are held after the call cut to the
# plan their tolerance was set for (tests/test_torch_cuda.py::
# test_ba_mapping_call_on_cuda_matches_cpu)
BA_DP_PLAN = (("middle", 2), ("fine", 2), ("color", 3))
BA_DP_POSE_ATOL = 1e-5       # the refined window poses, one device against ray DP
IMAP_BA_ITERS = 60           # the iMAP* BA room's mapping iterations an event (config 300)
IMAP_BA_EVENTS = [10] * 3 + [11] * 5  # its BA calls: keyframes 0-8, then the refinement


def ba_slab_rows(ba_cases, dense_rows, dev):
    """(a) K3 with slab windows at BA's mapping shapes: the middle, fine
    and color stages' captured 48k points over 1, 2 and 3 grids, cut into
    2 and 4 slabs on this card (``window_case``: each slab against its
    plain version, the slabs' sum in device order against dense K3 within
    1e-4 of its largest entry, the slab owning the most points timed and
    bounded by its own bytes).  And K9 with the camera leaf beside slab
    leaves: the color stage's captured BA step with each grid leaf (value,
    gradient, moments, frustum mask) cut into BA_SHARD_D slabs as
    ``shard_grid`` cuts it, the layout of the sharded room's step.
    Returns (checks, the window rows, the K9 row)."""
    from nice_slam_torch.parallel import grid_sharding as gs

    checks, rows = [], []
    for label in BA_K3_CASES:
        for D in BA_SLAB_DS:
            ck, rw = window_case(label, ba_cases["k3"][label], D, [dev] * D, dense_rows,
                                 True, kernels=("trilinear_bwd_dp",))
            checks.append(ck)
            rows += rw
    devices = [dev] * BA_SHARD_D

    def cut(t):
        return [None] * BA_SHARD_D if t is None else gs.shard_grid(t, devices).slabs

    leaves = []
    for p, g, m, v, mask, bc1, bc2, lr in ba_cases["k7_k10"]["adam"]["map_color_ba"]:
        if p.dim() != 4:  # a decoder's or the camera's leaf
            leaves.append((p, g, m, v, mask, bc1, bc2, lr))
            continue
        leaves += [(*x, bc1, bc2, lr) for x in zip(*(cut(t) for t in (p, g, m, v, mask)))]
    row = k9_row("map_color_slabs_ba", leaves, dev)[0]
    row.update(D=BA_SHARD_D, camera_leaves=sum(p.dim() == 2 and p.shape[1] == 7
                                               for p, *_ in leaves))
    return checks, with_bounds(rows), with_bounds([row])


def imap_ba_capture():
    """Hooks recording K8's first call in an iMAP* BA mapping iteration
    (the loss trains ``cams``; the integrator call the backward follows, not
    the importance pass), with its forward's inputs and its cotangents, as
    ``k7_k8_rows`` takes them.  Returns the record and a function that
    undoes the hooks."""
    import inspect

    import torch

    from nice_slam_torch.ops import integrator as I
    from nice_slam_torch.slam import mapper as M

    rec, state = {}, {"ba": False, "pending": None}
    fwd, bwd, loss = I.integrate_fwd, I.integrate_bwd, M.mapping_loss
    sig = inspect.signature(loss)

    def map_loss(*a, **k):
        state["ba"] = "cams" in sig.bind(*a, **k).arguments["groups"]
        try:
            return loss(*a, **k)
        finally:
            state["ba"] = False

    def rec_fwd(raw, z, rays_d, occupancy=False):
        # the importance pass integrates first and takes no backward: the
        # call a backward follows is the last one before it
        if state["ba"] and not rec and rays_d.requires_grad:
            state["pending"] = dict(raw=raw.detach().clone(), z=z.detach().clone(),
                                    rays_d=rays_d.detach().clone(), occ=bool(occupancy),
                                    rays_d_requires_grad=True)
        return fwd(raw, z, rays_d, occupancy)

    def rec_bwd(raw, z, rays_d, depth, g_depth, g_var, g_rgb, occupancy=False,
                need_rays=True):
        if state["pending"] is not None and not rec:
            rec.update(state["pending"], depth=depth.detach().clone(),
                       g_depth=g_depth.detach().clone(), g_var=g_var.detach().clone(),
                       g_rgb=g_rgb.detach().clone(), need_rays=bool(need_rays))
            state["pending"] = None
        return bwd(raw, z, rays_d, depth, g_depth, g_var, g_rgb, occupancy, need_rays)

    I.integrate_fwd, I.integrate_bwd, M.mapping_loss = rec_fwd, rec_bwd, map_loss

    def restore():
        I.integrate_fwd, I.integrate_bwd, M.mapping_loss = fwd, bwd, loss
    return rec, restore


def imap_ms_per_iter(events, calls, ba):
    """ms per mapping iteration over the main mapping events (each ends in
    a synchronize) with or without BA, the first event (iters_first)
    left out."""
    ms = sum(e["ms"] for e in events[1:] if e["ba"] == ba)
    iters = sum(c["iters"] for c in calls if c["BA"] == ba and c["idx"] != events[0]["idx"])
    return ms / iters if iters else None


def phase_imap_ba_room(dev):
    """(e) The iMAP* room with BA (``replica_imap_cfg(ba=True)``: a mapping
    event and a keyframe every 2nd frame, so BA engages at frame 10 (3
    calls) and frame 11 (the refinement's 5); cut as imap_slice is, and
    mapping IMAP_BA_ITERS iterations an event (config 300)).  Every frame
    tracked; BA in exactly the calls the rule gives, every write-back
    checked (``check_ba_calls``); K7-K9 launches exact and no other
    kernel.  Reports ms per mapping iteration with and without BA in the
    same run and the MLP's float32 peak share of each; records K8's first
    BA density call for the kernels phase.  Run before the kernels phase,
    which times that call.  Returns (record, the K8 case)."""
    import torch

    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.tools.eval_ate import ate_rmse
    from nice_slam_torch.tools.profile_step import (
        F32_FLOPS_PER_S as PEAK,
        imap_iteration_flops,
    )
    from nice_slam_torch.tools.workloads import replica_imap_cfg

    t0 = time.perf_counter()
    out = os.path.join(HERE, "output", "chip_smoke", "imap_ba_room")
    shutil.rmtree(out, ignore_errors=True)
    cfg = replica_imap_cfg(out, n_frames=IMAP_FRAMES, iters_first=IMAP_ITERS_FIRST, ba=True)
    cfg["mapping"]["iters"] = IMAP_BA_ITERS
    cfg["meshing"] = None
    slam = NiceSLAM(cfg, argparse.Namespace(nice=False, output=None), dev)
    for i in range(slam.n_img):  # frame synthesis is not part of the timing
        slam.frame_reader[i]
    cap, restore = imap_ba_capture()
    torch.cuda.synchronize()
    reset_counts()
    try:
        with ba_recorder(slam) as ba:
            slam.run()
    finally:
        restore()
    counts = all_counts()
    n, t, tc, r = slam.n_img, slam.timings, slam.tcfg, slam.rcfg
    if not torch.isfinite(slam.estimate_c2w_list).all() or t["tracked_frames"] != n - 1:
        raise AssertionError(f"iMAP BA room: tracked {t['tracked_frames']} of {n - 1} "
                             "frames, or a pose is not finite")
    ba_frames = check_ba_calls(ba, slam.estimate_c2w_list, "iMAP BA room")
    if ba_frames != IMAP_BA_EVENTS:
        raise AssertionError(f"iMAP BA room: BA calls at frames {ba_frames}, "
                             f"not {IMAP_BA_EVENTS}")
    track_iters = t["tracked_frames"] * tc.iters
    map_iters = sum(c["iters"] for c in ba["calls"])
    iters = track_iters + map_iters
    # the importance pass is a second K7 each iteration; no grid, no
    # decoder stage, no frustum
    want = {k: 0 for k in counts}
    want.update(integrate_fwd=2 * iters, integrate_bwd=iters, group_adam=iters)
    if counts != want:
        raise AssertionError(f"iMAP BA room launches {counts}, expected {want}")
    if "g_depth" not in cap:
        raise AssertionError("iMAP BA room: K8's BA call was not captured")
    map_flops = imap_iteration_flops(cfg["mapping"]["pixels"], r.N_samples,
                                     r.N_importance, r.N_samples, True)
    ms = {name: imap_ms_per_iter(ba["events"], ba["calls"], flag)
          for name, flag in (("ba", True), ("without_ba", False))}
    rec = {"frames": n, "H": slam.H, "W": slam.W,
           "cuts": {"frames": IMAP_FRAMES, "iters_first": [IMAP_ITERS_FIRST, 1500],
                    "iters": [IMAP_BA_ITERS, 300], "every_frame": [2, 5],
                    "keyframe_every": [2, 50], "meshing": "off"},
           "ba_calls": ba_frames, "ba_iterations": sum(c["iters"] for c in ba["calls"]
                                                       if c["BA"]),
           "write_backs": sum(len(c["writes"]) for c in ba["calls"]),
           "mapping_iters": map_iters, "tracking_iters": track_iters,
           "fps": t.get("fps"), "tracking_ms_per_frame": t.get("tracking_ms_per_frame"),
           "mapping_ms_per_event": t.get("mapping_ms_per_event"),
           "mapping_ms_per_iter": ms,
           "mlp_bound_ms_per_iter": 1e3 * map_flops / PEAK,
           "mlp_f32_peak_share": {k: None if v is None else map_flops / (v / 1e3) / PEAK
                                  for k, v in ms.items()},
           "ate_cm": 100 * ate_rmse(slam.estimate_c2w_list.cpu().numpy(), slam.gt_c2w_list),
           "frozen_ate_cm": frozen_ate_cm(slam.gt_c2w_list), "launches": counts,
           "k8_case": {"n": int(cap["z"].shape[0]), "samples": int(cap["z"].shape[1]),
                       "need_rays": cap["need_rays"]}}
    emit({"phase": "imap_ba_room", "ok": True, **rec, "seconds": time.perf_counter() - t0})
    return rec, cap


def halo_recorder(slam):
    """Clones of every sharded grid's halo planes (slab d's last x-plane,
    slab d+1's first) in each state a mapper publishes, on the device,
    compared after the run; a list of (grid, planes) per publish."""
    from nice_slam_torch.parallel import grid_sharding as gs

    halos = []
    inner = slam._publish

    def publish(new_state, coarse):
        halos.append([(k, lo[-1].clone(), hi[0].clone())
                      for k, sg in new_state.grids.items() if isinstance(sg, gs.ShardedGrid)
                      for lo, hi in zip(sg.slabs[:-1], sg.slabs[1:])])
        return inner(new_state, coarse)

    slam._publish = publish
    return halos


def ba_sharded_room(dev, devices, dense, out_name):
    """(b) The BA room (``replica_ba_cfg``, BA_FRAMES frames) with its grids
    sharded over ``devices`` (NICE_SLAM_TORCH_SPATIAL=1): every frame
    tracked; BA in exactly the calls the rule gives (frames 25 and 29 x
    5); K1-K10 launched exactly as the run's recorded calls give them per
    (kernel, device, stream) (``check_launches``: K3 once per slab in
    every tracking and BA mapping iteration); the halo planes of every
    published state bitwise equal; each write-back checked pose by pose
    and the oldest window pose unmoved (``check_ba_calls``); fps, ms and
    ATE beside the dense BA room's (``dense``)."""
    import torch

    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.tools.eval_ate import ate_rmse
    from nice_slam_torch.tools.workloads import replica_ba_cfg

    tag = f"BA room over {[str(d) for d in devices]}"
    out = os.path.join(HERE, "output", "chip_smoke", out_name)
    shutil.rmtree(out, ignore_errors=True)
    cfg = replica_ba_cfg(out, n_frames=BA_FRAMES, iters_first=SLICE_ITERS_FIRST)
    with knobs(True):
        slam = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None), devices=devices)
    D = len(devices)
    if slam.spatial_devices != list(devices) or slam.mapper.devices is not None:
        raise AssertionError(f"{tag}: sharding not engaged")
    for i in range(slam.n_img):
        slam.frame_reader[i]
    tracks, calls, meshes = [], [], []
    inner_track, inner_mesh = slam.track_one, slam._mesh

    def tracked(idx, *a, **k):
        tracks.append(("MainThread", idx - slam.mapping_idx))
        return inner_track(idx, *a, **k)

    def meshed(path, *a, **k):
        meshes.append(("MainThread", path))
        return inner_mesh(path, *a, **k)

    slam.track_one, slam._mesh = tracked, meshed
    halos = halo_recorder(slam)
    cards = sorted(set(devices), key=str)
    for c in cards:
        torch.cuda.synchronize(c)
        torch.cuda.reset_peak_memory_stats(c)
    reset_counts()
    with recorded_core(calls), ba_recorder(slam) as ba:
        slam.run()
    counts = all_counts()
    peak = {str(c): torch.cuda.max_memory_allocated(c) / 2 ** 30 for c in cards}
    n, t = slam.n_img, slam.timings
    if not torch.isfinite(slam.estimate_c2w_list).all() or t["tracked_frames"] != n - 1:
        raise AssertionError(f"{tag}: tracked {t['tracked_frames']} of {n - 1} frames, "
                             "or a pose is not finite")
    ba_frames = check_ba_calls(ba, slam.estimate_c2w_list, tag)
    if ba_frames != BA_EVENTS:
        raise AssertionError(f"{tag}: BA calls at frames {ba_frames}, not {BA_EVENTS}")
    mesh_faces = check_launches(slam, devices, True, tracks, calls, meshes, tag)
    track_iters = t["tracked_frames"] * slam.tcfg.iters
    ba_iters = sum(c[2] for c in calls if c[6])
    if counts["trilinear_bwd_dp"] != D * (track_iters + ba_iters):
        raise AssertionError(f"{tag}: K3 {counts['trilinear_bwd_dp']} != {D} x "
                             f"({track_iters} + {ba_iters})")
    diverged = [(i, k) for i, planes in enumerate(halos) for k, lo, hi in planes
                if not torch.equal(lo.to(hi.device), hi)]
    if diverged or not halos:
        raise AssertionError(f"{tag}: halo planes differ after (call, grid) {diverged}")
    events = [e for e in ba["events"] if not e["coarse"]]
    regular = [e for e in events if 0 < e["idx"] < n - 1]
    meshing = t["meshing_s"]
    keys = ("fps", "fps_without_meshing", "tracking_ms_per_frame", "mapping_ms_per_event",
            "coarse_mapping_ms_per_event", "mapping_ms_per_event_ba",
            "mapping_ms_per_event_without_ba", "refinement_ms", "ate_cm", "launches")
    rec = {"devices": [str(d) for d in devices], "D": D, "frames": n,
           "fps": t.get("fps"), "total_s": t["total_s"], "meshing_s": meshing,
           "fps_without_meshing": t["frames"] / (t["total_s"] - meshing),
           "tracking_ms_per_frame": t.get("tracking_ms_per_frame"),
           "mapping_ms_per_event": t.get("mapping_ms_per_event"),
           "coarse_mapping_ms_per_event": t.get("coarse_mapping_ms_per_event"),
           "mapping_ms_per_event_ba": [e["ms"] for e in regular if e["ba"]],
           "mapping_ms_per_event_without_ba": [e["ms"] for e in regular if not e["ba"]],
           "refinement_ms": [e["ms"] for e in events if e["idx"] == n - 1],
           "ate_cm": 100 * ate_rmse(slam.estimate_c2w_list.cpu().numpy(), slam.gt_c2w_list),
           "ba_calls": ba_frames, "ba_iterations": ba_iters, "tracking_iters": track_iters,
           "write_backs": sum(len(c["writes"]) for c in ba["calls"]),
           "halo_checks": sum(len(x) for x in halos), "halo_bitwise": True,
           "meshes": mesh_faces, "peak_mem_gib": peak, "launches": counts,
           "launches_by_device_stream": {f"{k}@cuda:{i}/{s}": v for (k, i, s), v
                                         in sorted(all_by_device().items())},
           "dense": {k: dense.get(k) for k in keys if k in dense}}
    rec["dense"]["fps_without_meshing"] = dense["frames"] / (dense["total_s"]
                                                             - dense["meshing_s"])
    return rec, counts


def ba_ray_dp(dev, call, devices):
    """(d) Ray DP with BA on the room's first BA mapping call (``ba_capture``'s).
    (1) The whole call on one device, each iteration's loss and camera
    gradient also computed with its rays over ``devices`` from the same
    state and pixels: per iteration the losses within DP_LOSS_RTOL
    relative, the camera gradients within DP_LOSS_RTOL of the largest
    entry.  (2) The call cut to BA_DP_PLAN, on one device and with its rays
    over ``devices``, on the same host-drawn pixels: the refined window
    poses within BA_DP_POSE_ATOL (its losses reported: they part after a
    group's first Adam step, see BA_DP_PLAN).
    ``over_blocks`` must run for every ray-DP loss (the split asserted).
    Counts PyTorch's AccumulateGrad stream-mismatch warnings per call."""
    import inspect
    import warnings

    import numpy as np
    import torch

    from nice_slam_torch.slam import mapper as M

    c = call
    to = devices[0]
    state = c["state"]
    args = [c[k].to(to) for k in ("colors", "depths", "fixed_c2w", "cam_tensors",
                                  "opt_cam_mask", "frame_valid")]
    F, n = args[0].shape[0], c["pixs_per_image"]
    H, W = args[0].shape[1:3]
    inner_blocks, inner_loss = M.over_blocks, M.mapping_loss
    loss_sig = inspect.signature(inner_loss)
    blocks, forced = [], []

    def over_blocks(ds, *a):
        blocks.append(len(ds))
        return inner_blocks(ds, *a)

    def forced_loss(*a, **k):
        # the iteration's loss on one device, and again with its rays over
        # the devices, from the same state and pixels
        b = loss_sig.bind(*a, **k)
        b.apply_defaults()
        one = inner_loss(**b.arguments)
        dp = inner_loss(**dict(b.arguments, devices=devices))
        cams = b.arguments["groups"]["cams"]
        g_one, = torch.autograd.grad(one, [cams], retain_graph=True)
        g_dp, = torch.autograd.grad(dp, [cams])
        forced.append(torch.stack([(dp.detach() - one.detach()).abs() / one.detach().abs(),
                                   (g_dp - g_one).abs().max(), g_one.abs().max()]))
        return one

    def run(plan, pix, devs, loss_fn):
        M.over_blocks, M.mapping_loss = over_blocks, loss_fn
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                _, cams, losses = M.optimize_map_core(
                    c["spec"], state, *args, c["lr_factor"], c["mcfg"], c["rcfg"], plan,
                    True, n, pix_idx=pix, devices=devs)
                torch.cuda.synchronize()
        finally:
            M.over_blocks, M.mapping_loss = inner_blocks, inner_loss
        warned = [str(w.message) for w in caught if "AccumulateGrad" in str(w.message)]
        return losses.cpu().numpy(), cams.cpu(), warned

    gen = torch.Generator().manual_seed(9)
    iters = sum(k for _, k in c["stage_plan"])
    short = sum(k for _, k in BA_DP_PLAN)
    pix = torch.randint(0, H * W, (max(iters, short), F, n), generator=gen).to(to)
    _, _, warned_forced = run(c["stage_plan"], pix, None, forced_loss)
    per_iter = torch.stack(forced).cpu().numpy()
    n_forced = len(blocks)
    out = {name: run(BA_DP_PLAN, pix, devs, inner_loss)
           for name, devs in (("one", None), ("dp", devices))}
    want_blocks = [len(devices)] * (iters + short)
    if blocks != want_blocks or n_forced != iters:
        raise AssertionError(f"ray DP with BA over {devices}: over_blocks ran {blocks}, "
                             f"not {want_blocks}: the split of {F} x {n} rays did not "
                             "happen for every ray-DP loss")
    rel = float(np.max(np.abs(out["dp"][0] - out["one"][0]) / np.abs(out["one"][0])))
    pose = float((out["dp"][1] - out["one"][1]).abs().max())
    moved = float((out["one"][1] - c["cam_tensors"].cpu()).abs().max())
    forced_rel = float(per_iter[:, 0].max())
    forced_g = float((per_iter[:, 1] / per_iter[:, 2]).max())
    rec = {"devices": [str(d) for d in devices], "rays_per_iter": F * n,
           "call": {"plan": c["stage_plan"], "iters": iters,
                    "loss_max_rel_diff": forced_rel,
                    "cam_grad_max_rel_diff": forced_g,
                    "cam_grad_equal_bitwise": bool((per_iter[:, 1] == 0).all())},
           "short": {"plan": BA_DP_PLAN, "loss_max_rel_diff": rel,
                     "pose_max_abs_diff": pose, "poses_moved": moved},
           "loss_rtol": DP_LOSS_RTOL, "pose_atol": BA_DP_POSE_ATOL,
           "split_blocks": len(devices), "over_blocks_calls": len(blocks),
           "accumulate_grad_warnings_per_call": {
               "call_one_and_dp": len(warned_forced), "short_one": len(out["one"][2]),
               "short_dp": len(out["dp"][2])},
           "accumulate_grad_warning": (warned_forced + out["dp"][2] + [None])[0]}
    if not (forced_rel <= DP_LOSS_RTOL and forced_g <= DP_LOSS_RTOL
            and pose <= BA_DP_POSE_ATOL and moved > 0):
        raise AssertionError(f"ray DP with BA over {devices}: {rec}")
    return rec


def phase_ba_sharded(dev, dense_room, first_call):
    """BA over sharded grids and under ray DP: (b) the BA room over
    [cuda:0] x BA_SHARD_D slabs (and over cuda:0, cuda:1 where two cards
    are visible), (d) the first BA call with its rays over [cuda:0] x
    BA_DP_D (and two cards where visible) against one device; (c) is
    ``phase_ba_families``.  Returns the (b) run's launch counts."""
    import torch

    t0 = time.perf_counter()
    room, counts = ba_sharded_room(dev, [dev] * BA_SHARD_D, dense_room, "ba_sharded")
    t1 = time.perf_counter()
    dp = ba_ray_dp(dev, first_call, [dev] * BA_DP_D)
    t2 = time.perf_counter()
    cards = None
    if torch.cuda.device_count() >= 2:
        pair = [torch.device("cuda", 0), torch.device("cuda", 1)]
        cards = {"room": ba_sharded_room(dev, pair, dense_room, "ba_sharded_cards")[0],
                 "ray_dp": ba_ray_dp(dev, first_call, pair)}
    emit({"phase": "ba_sharded", "ok": True, "device_count": torch.cuda.device_count(),
          "room": room, "ray_dp": dp, "over_distinct_cards": cards,
          "distinct_cards": cards is not None,
          "seconds": {"room": t1 - t0, "ray_dp": t2 - t1,
                      "distinct_cards": time.perf_counter() - t2,
                      "total": time.perf_counter() - t0}})
    return counts


def phase_imap_ba(room, imap_slice):
    """(e) iMAP* with BA on the room: the iMAP* BA room's record
    (``phase_imap_ba_room``) beside the imap_slice's BA-off ms per mapping
    iteration and MLP share (``imap_slice``); the box draws are
    ``phase_ba_families``."""
    emit({"phase": "imap_ba", "ok": True, "room": {k: room[k] for k in (
              "ba_calls", "mapping_ms_per_iter", "mlp_f32_peak_share", "fps", "ate_cm")},
          "imap_slice_without_ba": {
              "mapping_ms_per_iter": imap_slice["mapping_ms_per_iter"],
              "mlp_f32_peak_share": imap_slice["mlp_f32_peak_share"]["mapping"],
              "fps": imap_slice["fps"], "ate_cm": imap_slice["ate_cm"]}})


def phase_ba_families(dev):
    """The BA box families (``python3 chip_smoke.py --ba_families``; left
    out of the default run for time): (c) the box with BA over BA_BOX_D
    slabs for BA_BOX_SEEDS under the strict family's gates
    (``box_family``); (e) the iMAP* box with BA (``imap_box_draw(ba=True)``:
    BA calls at frames 25 and 29, each write-back checked) for
    IMAP_QUALITY_SEEDS, run at once with the same draws without BA, each BA
    draw's ATE within IMAP_ATE_GATE_CM and below a frozen camera's
    (imap_quality's gates, copied), beside its BA-off draw's."""
    import numpy as np

    t0 = time.perf_counter()
    box, box_ok = box_family(dev, "ba_sharded_box", ba=True, seeds=BA_BOX_SEEDS,
                             devices=[dev] * BA_BOX_D)
    emit({"phase": "ba_sharded_box", "ok": box_ok, **box,
          "seconds": time.perf_counter() - t0})
    if not box_ok:
        raise strict_family_failure("BA box family over slabs", box)
    t1 = time.perf_counter()
    n = len(IMAP_QUALITY_SEEDS)
    both = draws_at_once("imap_box", imap_box_runs("imap_ba", ba=True)
                         + [dict(label="imap_ba_off", seed=s) for s in IMAP_QUALITY_SEEDS])
    draws, without_ba = both[:n], both[n:]
    for d, off in zip(draws, without_ba):
        d["without_ba_ate_cm"] = off["ate_rmse_cm"]
    ok = all(d["ate_rmse_cm"] <= IMAP_ATE_GATE_CM and d["ate_rmse_cm"] < d["frozen_ate_cm"]
             and d["ba_calls"] for d in draws)
    emit({"phase": "imap_ba_box", "ok": ok, "frames": 30, "draws": draws,
          "median_ate_cm": float(np.median([d["ate_rmse_cm"] for d in draws])),
          "median_ate_cm_without_ba": float(np.median([d["ate_rmse_cm"]
                                                       for d in without_ba])),
          "gate_cm": IMAP_ATE_GATE_CM, "seconds": time.perf_counter() - t1})
    if not ok:
        raise AssertionError(f"iMAP BA box: ATE {[d['ate_rmse_cm'] for d in draws]} cm; "
                             f"every draw must be <= {IMAP_ATE_GATE_CM}, beat a frozen "
                             f"camera ({[d['frozen_ate_cm'] for d in draws]} cm) and run BA")


def threaded_run(dev, sync):
    """One threaded run of the slice's workload; checks its frames, outputs
    and every kernel's launches per stream, and returns its record."""
    import math
    import threading

    import torch

    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.tools.eval_ate import ate_rmse
    from nice_slam_torch.tools.workloads import replica_synthetic_cfg

    out = os.path.join(HERE, "output", "chip_smoke", f"threaded_{sync}")
    shutil.rmtree(out, ignore_errors=True)
    cfg = replica_synthetic_cfg(out, n_frames=12, iters_first=SLICE_ITERS_FIRST)
    cfg["sync_method"] = sync
    slam = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None), dev)
    for i in range(slam.n_img):  # frame synthesis is not part of the timing
        slam.frame_reader[i]
    map_iters, coarse_iters = {}, {}

    def thread() -> str:  # the warm-up runs on MainThread
        return threading.current_thread().name

    count_iterations(slam.mapper, map_iters, thread)
    count_iterations(slam.coarse_mapper, coarse_iters, thread)
    track_iters = {}
    lags = []
    inner_track = slam.track_one

    def tracked(idx, *a, **k):
        lags.append(idx - slam.mapping_idx)
        track_iters[thread()] = track_iters.get(thread(), 0) + slam.tcfg.iters
        return inner_track(idx, *a, **k)

    slam.track_one = tracked
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    calls = []
    with recorded_core(calls):
        slam.run()
    counts = all_counts()
    by = all_by_stream()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    n, t = slam.n_img, slam.timings
    if not torch.isfinite(slam.estimate_c2w_list).all():
        raise AssertionError(f"{sync}: non-finite poses")
    if t["tracked_frames"] != n - 1 or slam.mapping_idx != n - 1:
        raise AssertionError(f"{sync}: tracked {t['tracked_frames']} frames, "
                             f"mapping_idx {slam.mapping_idx}; expected {n - 1} each")
    ckpt = os.path.join(out, "ckpts", f"{n - 1:05d}.tar")
    if not os.path.exists(ckpt):
        raise AssertionError(f"{sync}: no final checkpoint at {ckpt}")
    chunk = slam.rcfg.points_batch_size
    lattice = slam.mesher.resolution ** 3
    mesh_chunks = 0
    for name in ("final_mesh.ply", "final_mesh_eval_rec.ply"):
        verts, _ = mesh_stats(os.path.join(out, "mesh", name))
        mesh_chunks += math.ceil(lattice / chunk) + math.ceil(len(verts) / chunk)

    # the streams: the warm-up's on the default stream, then one per thread
    expected = {"tracker", "mapper", "coarse_mapper"}
    if set(slam.streams) != expected:
        raise AssertionError(f"{sync}: thread streams {sorted(slam.streams)}, "
                             f"expected {sorted(expected)}")
    ids = {"MainThread": torch.cuda.default_stream(dev).cuda_stream,
           **{k: v[dev].cuda_stream for k, v in slam.streams.items()}}
    if len(set(ids.values())) != 4:
        raise AssertionError(f"{sync}: the threads do not have streams of "
                             f"their own: {ids}")
    k1, k2, k3 = "trilinear_fwd", "trilinear_bwd_dgrid", "trilinear_bwd_dp"
    all_track = sum(track_iters.values())
    all_map = sum(map_iters.values()) + sum(coarse_iters.values())
    if counts[k3] != all_track or counts[k2] != all_map or \
            counts[k1] != all_track + all_map + mesh_chunks:
        raise AssertionError(f"{sync}: launches {counts} for {all_track} tracking "
                             f"+ {all_map} mapping iterations + {mesh_chunks} "
                             "mesher chunks")
    k4, k5, k6 = "decoder_fwd", "decoder_bwd", "decoder_wgrad_sum"
    want = {}  # (kernel, thread) -> launches
    for thread, sid in ids.items():
        tr = track_iters.get(thread, 0)
        mp = map_iters.get(thread, 0) + coarse_iters.get(thread, 0)
        want[(k3, thread)] = tr
        want[(k2, thread)] = mp
        want[(k5, thread)] = tr + mp
        want[(k6, thread)] = sum(c[4] for c in calls if c[0] == thread)
        if thread != "mapper":  # the mapper's stream also runs the meshes
            want[(k1, thread)] = tr + mp
        want[(k4, thread)] = by.get((k1, sid), 0)  # one K4 per lookup Function
        fr = sum(c[5] for c in calls if c[0] == thread)
        for k, v in k7_k10_want(tr + mp, fr).items():
            want[(k, thread)] = v
    got = {(k, thread): by.get((k, sid), 0) for thread, sid in ids.items()
           for k in (k1, k2, k3, k4, k5, k6, *K7_K10)}
    bad = {key: (got[key], v) for key, v in want.items() if got[key] != v}
    stray = {key: v for key, v in by.items() if key[1] not in ids.values()}
    if bad or stray or got[(k1, "mapper")] <= 0:
        raise AssertionError(f"{sync}: launches per stream (got, expected) {bad}; "
                             f"on unknown streams {stray}")
    for thread in expected:
        if got[(k1, thread)] <= 0:
            raise AssertionError(f"{sync}: no K1 launch on the {thread}'s stream")
    every = slam.mcfg.every_frame
    worst = max(lags)
    if sync == "loose" and worst > every + every // 2:
        raise AssertionError(f"loose: lag {worst} frames > {every + every // 2}")
    est = slam.estimate_c2w_list.cpu().numpy()
    return {"sync": sync, "fps": t.get("fps"), "total_s": t["total_s"],
            "meshing_s": t["meshing_s"],
            "fps_without_meshing": t["frames"] / (t["total_s"] - t["meshing_s"]),
            "tracking_ms_per_frame": t.get("tracking_ms_per_frame"),
            "mapping_ms_per_event": t.get("mapping_ms_per_event"),
            "coarse_mapping_ms_per_event": t.get("coarse_mapping_ms_per_event"),
            "tracked_frames": t["tracked_frames"],
            "mapping_events": t["mapping_events"],
            "coarse_mapping_events": t["coarse_mapping_events"],
            "max_lag": worst, "lags": lags, "peak_mem_gib": peak_gib,
            "ate_cm": 100 * ate_rmse(est, slam.gt_c2w_list),
            "iters": {"tracking": track_iters, "mapping": map_iters,
                      "coarse_mapping": coarse_iters},
            "launches": counts,
            "launches_by_thread": {f"{k}@{th}": v for (k, th), v in got.items()},
            "mesher_k1_launches": mesh_chunks, "checkpoint": ckpt}


def phase_threaded(dev, strict):
    """The loose and free schedules on the slice's workload, beside the
    slice phase's strict numbers (``strict``, its record)."""
    t0 = time.perf_counter()
    runs = [threaded_run(dev, sync) for sync in ("loose", "free")]
    keys = ("fps", "total_s", "meshing_s", "fps_without_meshing",
            "tracking_ms_per_frame", "mapping_ms_per_event",
            "coarse_mapping_ms_per_event", "tracked_frames", "mapping_events",
            "coarse_mapping_events", "peak_mem_gib", "ate_cm")
    emit({"phase": "threaded", "ok": True, "runs": runs,
          "strict": {k: strict.get(k) for k in keys},
          "seconds": time.perf_counter() - t0})


def loose_box_family(dev, strict_median_cm, label, devices=None):
    """The quality phase's box run under loose for THREADED_SEEDS, on one
    card or with the grids sharded over ``devices``, the draws one after
    another in this process (``box_draw``): the loose schedule's result
    depends on how the tracker and mapper threads race, so no other draw
    runs beside them.  Every draw against ATE_DIVERGED_CM, the median
    against max(3 x the strict family's median, LOOSE_ATE_FLOOR_CM).
    Returns the record and whether both gates held."""
    import numpy as np

    draws = [box_draw(dev, **kw) for kw in box_runs(label, seeds=THREADED_SEEDS,
                                                    devices=devices, sync="loose")]
    ates = [d["ate_rmse_cm"] for d in draws]
    median = float(np.median(ates))
    gate = max(3 * strict_median_cm, LOOSE_ATE_FLOOR_CM)
    ok = median <= gate and max(ates) <= ATE_DIVERGED_CM
    return {"frames": 30, "draws": draws, "median_ate_cm": median, "gate_cm": gate,
            "strict_median_cm": strict_median_cm,
            "draw_gate_cm": ATE_DIVERGED_CM}, ok


def box_family_failure(rec) -> AssertionError:
    ates = [d["ate_rmse_cm"] for d in rec["draws"]]
    return AssertionError(f"loose ATE over seeds {THREADED_SEEDS}: {ates} cm; median "
                          f"{rec['median_ate_cm']:.3f} (gate {rec['gate_cm']:.3f}), "
                          f"worst draw gate {ATE_DIVERGED_CM}")


def phase_threaded_quality(dev, strict_median_cm):
    """The loose box family on one card (``loose_box_family``)."""
    t0 = time.perf_counter()
    rec, ok = loose_box_family(dev, strict_median_cm, "threaded_quality")
    emit({"phase": "threaded_quality", "ok": ok, **rec,
          "seconds": time.perf_counter() - t0})
    if not ok:
        raise box_family_failure(rec)


def record_calls(mapper, sink) -> None:
    """Append each optimize_map call's losses (on the host) to ``sink``."""
    inner = mapper.optimize_map

    def recorded(*a, **k):
        out = inner(*a, **k)
        sink.append(out[2].cpu().numpy())
        return out

    mapper.optimize_map = recorded


def imap_schedule_iters(cfg, n_frames: int) -> int:
    """Mapping iterations the strict schedule gives the iMAP* model
    (nice_slam_tpu/slam/slam.py:_map_one): iters_first at frame 0; at
    every every_frame-th frame 3 calls of iters // 3; at the last frame,
    with colour refinement, 5 calls of 5 * iters // 5."""
    m = cfg["mapping"]
    total = m["iters_first"]
    for idx in range(1, n_frames):
        if idx == n_frames - 1:
            total += 5 * (5 * m["iters"] // 5) if m["color_refine"] else 3 * (m["iters"] // 3)
        elif idx % m["every_frame"] == 0:
            total += 3 * (m["iters"] // 3)
    return total


def alive_share(slam) -> float:
    """Share of the in-bound points along frame 0's rays (every 8th pixel
    of every 8th row, 32 depths up to its largest depth) whose density is
    positive under the current MLP: at 0 the ReLU passes no depth
    gradient and the map never trains."""
    import torch

    from nice_slam_torch.models.scene import eval_points
    from nice_slam_torch.ops.render import get_rays

    _, _, depth, c2w = slam.frame_reader[0]
    rays_o, rays_d = get_rays(slam.H, slam.W, slam.cam["fx"], slam.cam["fy"],
                              slam.cam["cx"], slam.cam["cy"],
                              torch.as_tensor(c2w, device=slam.device))
    keep = torch.arange(slam.H * slam.W, device=slam.device)
    keep = keep[(keep // slam.W % 8 == 0) & (keep % 8 == 0)]
    z = torch.linspace(0.0, float(depth.max()), 33, device=slam.device)[1:]
    pts = rays_o[keep, None] + rays_d[keep, None] * z[None, :, None]
    with torch.no_grad():
        density = eval_points(slam.spec, slam.state, pts.reshape(-1, 3))[:, 3]
    inside = density != 100.0
    return float((density[inside] > 0).float().mean())


def frozen_ate_cm(gt) -> float:
    """ATE of a trajectory that never leaves frame 0's pose: what a tracker
    that never moves the camera scores on this orbit."""
    import numpy as np

    from nice_slam_torch.tools.eval_ate import ate_rmse

    return 100 * ate_rmse(np.repeat(gt[:1], len(gt), axis=0), gt)


def phase_imap_slice(dev, card):
    import numpy as np
    import torch

    from nice_slam_torch.ops import interp
    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.tools.eval_ate import ate_rmse
    from nice_slam_torch.tools.profile_step import (
        F32_FLOPS_PER_S as PEAK,
        imap_iteration_flops,
    )
    from nice_slam_torch.tools.workloads import replica_imap_cfg
    from nice_slam_torch.utils.meshlib import read_ply

    out = os.path.join(HERE, "output", "chip_smoke", "imap_slice")
    shutil.rmtree(out, ignore_errors=True)  # imap_resume reads its last checkpoint
    cfg = replica_imap_cfg(out, n_frames=IMAP_FRAMES, iters_first=IMAP_ITERS_FIRST)
    slam = NiceSLAM(cfg, argparse.Namespace(nice=False, output=None), dev)
    for i in range(slam.n_img):  # frame synthesis is not part of the timing
        slam.frame_reader[i]
    calls = []
    record_calls(slam.mapper, calls)
    init_alive = alive_share(slam)
    interp.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    slam.run()
    counts = dict(interp.launch_counts)
    peak = torch.cuda.max_memory_allocated()

    t, tc, r = slam.timings, slam.tcfg, slam.rcfg
    map_iters = sum(len(c) for c in calls)
    want = imap_schedule_iters(cfg, slam.n_img)
    if map_iters != want or want != 2400:
        raise AssertionError(f"{map_iters} mapping iterations in {len(calls)} calls; "
                             f"the schedule gives {want} (2400 for 12 frames)")
    if not all(np.isfinite(c).all() for c in calls):
        raise AssertionError("non-finite mapping losses in the iMAP slice")
    first = calls[0]
    if not first[-10:].mean() < first[:10].mean():
        raise AssertionError(f"the first mapping call's loss did not fall: "
                             f"{first[:10].mean()} -> {first[-10:].mean()}")
    if not torch.isfinite(slam.estimate_c2w_list).all():
        raise AssertionError("non-finite poses in the iMAP slice")
    if any(counts.values()):
        raise AssertionError(f"the iMAP path launched trilinear kernels: {counts}")
    ate = 100 * ate_rmse(slam.estimate_c2w_list.cpu().numpy(), slam.gt_c2w_list)
    frozen = frozen_ate_cm(slam.gt_c2w_list)
    if not ate < frozen:
        raise AssertionError(f"iMAP tracking did not beat a frozen camera: ATE {ate} cm, "
                             f"frozen {frozen} cm (initial density alive share {init_alive})")
    ckpt = os.path.join(out, "ckpts", f"{slam.n_img - 1:05d}.tar")
    if not os.path.exists(ckpt):
        raise AssertionError(f"no final checkpoint at {ckpt}")
    mesh = os.path.join(out, "mesh", "final_mesh.ply")
    verts, faces = mesh_stats(mesh)
    colors = read_ply(mesh)[2]
    if colors is None or len(colors) != len(verts) or len(np.unique(colors, axis=0)) < 2:
        raise AssertionError(f"the iMAP mesh has no rendered vertex colours: {colors}")
    rec = next(m for m in slam.meshes if m["path"].endswith("final_mesh.ply"))
    track_flops = imap_iteration_flops(tc.pixels, r.N_samples, r.N_importance, 0, False)
    track_flops_wgrad = imap_iteration_flops(tc.pixels, r.N_samples, r.N_importance,
                                             0, True)
    map_flops = imap_iteration_flops(cfg["mapping"]["pixels"], r.N_samples,
                                     r.N_importance, r.N_samples, True)
    track_ms_iter = t["tracking_ms_per_frame"] / tc.iters
    map_ms_iter = 1e3 * t["mapping_s"] / map_iters
    rec = {"frames": slam.n_img,
          "H": slam.H, "W": slam.W, "hidden": slam.spec.decoder.hidden_size,
          "n_blocks": slam.spec.decoder.n_blocks,
          "samples": [r.N_samples, r.N_importance], "regulariser_samples": r.N_samples,
          "tracking": [tc.iters, tc.pixels],
          "mapping": [cfg["mapping"]["iters"], cfg["mapping"]["pixels"]],
          "cuts": {"frames": IMAP_FRAMES, "iters_first": [IMAP_ITERS_FIRST, 1500],
                   "keyframe_every": [5, 50], "eval_rec_mesh": "off"},
          "mapping_iters": map_iters, "mapping_calls": [len(c) for c in calls],
          "first_call_loss": [float(first[:10].mean()), float(first[-10:].mean())],
          "fps": t.get("fps"), "total_s": t.get("total_s"),
          "fps_without_meshing": t["frames"] / (t["total_s"] - t["meshing_s"]),
          "tracking_ms_per_frame": t.get("tracking_ms_per_frame"),
          "tracking_ms_per_iter": track_ms_iter, "mapping_ms_per_iter": map_ms_iter,
          "mapping_ms_per_event": t.get("mapping_ms_per_event"),
          "peak_memory_gib": peak / 2 ** 30, "meshing_s": t["meshing_s"],
          "mesh": {"vertices": len(verts), "faces": len(faces),
                   "seconds": rec["seconds"], "color_chunks": rec["color_chunks"],
                   "steps_s": {k: v for k, v in rec.items() if k.endswith("_s")}},
          "mlp_tflop_per_iter": {"tracking": track_flops / 1e12,
                                 "tracking_with_weight_grads": track_flops_wgrad / 1e12,
                                 "mapping": map_flops / 1e12},
          "mlp_bound_ms_per_iter": {"tracking": 1e3 * track_flops / PEAK,
                                    "mapping": 1e3 * map_flops / PEAK},
          "mlp_f32_peak_share": {"tracking": track_flops / (track_ms_iter / 1e3) / PEAK,
                                 "mapping": map_flops / (map_ms_iter / 1e3) / PEAK},
          "ate_cm": ate, "frozen_ate_cm": frozen, "init_alive_share": init_alive,
          "final_alive_share": alive_share(slam),
          "launches": counts, "checkpoint": ckpt}
    emit({"phase": "imap_slice", "ok": True, "card": card, **rec})
    return slam, cfg, rec


def phase_imap_resume(dev, done, cfg):
    """A fresh iMAP* system resumes from the slice's final checkpoint: the
    decoders, poses and keyframes equal the slice's bit for bit; then one
    full-frame panel of the resumed state."""
    import torch

    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.utils.visualizer import Visualizer

    t0 = time.perf_counter()
    slam = NiceSLAM(cfg, argparse.Namespace(nice=False, output=None), dev)
    start = slam.resume()
    if start != done.n_img:
        raise AssertionError(f"resume starts at {start}, not {done.n_img}")
    diff = []
    flat_a, flat_b = leaves(done.state.decoders), leaves(slam.state.decoders)
    if len(flat_a) != len(flat_b) or not all(torch.equal(a, b) for a, b in zip(flat_a, flat_b)):
        diff.append("decoders")
    if slam.state.grids or done.state.grids:
        diff.append("grids")
    if not torch.equal(slam.estimate_c2w_list, done.estimate_c2w_list):
        diff.append("estimate_c2w_list")
    if slam.keyframes.frame_ids != done.keyframes.frame_ids:
        diff.append("keyframes")
    if diff:
        raise AssertionError(f"resumed iMAP state differs from the slice's: {diff}")
    resume_s = time.perf_counter() - t0
    out = os.path.join(HERE, "output", "chip_smoke", "imap_vis")
    vis = Visualizer(1, 1, out, slam.spec, slam.rcfg, slam.cam)
    idx = done.n_img - 1
    _, color, depth, _ = slam.frame_reader[idx]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = vis.vis(idx, 0, depth, color, slam.estimate_c2w_list[idx], slam.state)
    panel_s = time.perf_counter() - t0
    if path is None or not os.path.exists(path):
        raise AssertionError(f"no iMAP panel written (got {path})")
    emit({"phase": "imap_resume", "ok": True, "start": start,
          "decoder_tensors": len(flat_a), "keyframes": slam.keyframes.frame_ids,
          "resume_s": resume_s, "panel": path, "H": slam.H, "W": slam.W,
          "panel_s": panel_s})


def imap_box_draw(dev, label, seed, ba=False, scored=False):
    """One draw of the JAX package's selfcheck --imap run
    (``box_imap_quality_cfg``, BA on where ``ba``) with pixel seed
    ``seed`` in this process: its ATE beside a frozen camera's, the MLP's
    share of positive density before and after; without BA its final
    mesh's wall distance, and where ``scored`` its eval_rec mesh's depth L1
    (2D metric, DEPTH_L1_IMGS views, seed 0, as the selfcheck scores it);
    with BA the frames of its BA calls, each write-back checked
    (``check_ba_calls``)."""
    import numpy as np
    import torch

    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.tools.eval_ate import ate_rmse
    from nice_slam_torch.tools.eval_recon import calc_2d_metric
    from nice_slam_torch.tools.selfcheck import gt_room_mesh
    from nice_slam_torch.tools.workloads import box_imap_quality_cfg

    out = os.path.join(HERE, "output", "chip_smoke", f"{label}_s{seed}")
    cfg = box_imap_quality_cfg(out, ba=ba)
    cfg["seed"] = seed
    if ba:
        cfg["meshing"] = None
    else:
        cfg["meshing"]["eval_rec"] = scored
    slam = NiceSLAM(cfg, argparse.Namespace(nice=False, output=None), dev)
    init_alive = alive_share(slam)
    with ba_recorder(slam) as rec:
        slam.run()
    if slam.timings["tracked_frames"] != slam.n_img - 1 or \
            not torch.isfinite(slam.estimate_c2w_list).all():
        raise AssertionError(f"{label} seed {seed}: a frame untracked or a pose not finite")
    draw = {"seed": seed, "fps": slam.timings.get("fps"), "ate_rmse_cm":
            100 * ate_rmse(slam.estimate_c2w_list.cpu().numpy(), slam.gt_c2w_list),
            "frozen_ate_cm": frozen_ate_cm(slam.gt_c2w_list),
            "init_alive_share": init_alive, "final_alive_share": alive_share(slam),
            "ba_calls": check_ba_calls(rec, slam.estimate_c2w_list, f"{label} seed {seed}")
            if ba else []}
    if not ba:
        verts, _ = mesh_stats(os.path.join(out, "mesh", "final_mesh.ply"))
        draw.update(mesh_wall_m=box_wall_distance(verts), vertices=len(verts),
                    meshing_s=slam.timings["meshing_s"])
    if scored:
        t1 = time.perf_counter()
        gt = gt_room_mesh(np.asarray(slam.frame_reader.room),
                          os.path.join(out, "gt_room.ply"), list(slam.gt_c2w_list),
                          slam.cam, sdf=slam.frame_reader.scene_sdf)
        d1 = calc_2d_metric(os.path.join(out, "mesh", "final_mesh_eval_rec.ply"), gt,
                            n_imgs=DEPTH_L1_IMGS, seed=0)["depth_l1_cm"]
        draw.update(depth_l1_cm=d1, metric_2d_s=time.perf_counter() - t1)
    return draw


def phase_imap_quality(dev):
    """The JAX package's selfcheck --imap run for seeds 42, 0, 1, the draws
    run at once (``imap_box_draw``): every draw's ATE against
    IMAP_ATE_GATE_CM, as tests/test_quality_gates.py gates imap_tracked,
    _s0 and _s1.  The seed-42 draw (imap_tracked itself) also writes its
    eval_rec mesh and gets the 2D metric, its depth L1 against
    IMAP_TRACKED_DEPTH_L1_CM.  The wall distance of each draw's final
    mesh is reported only: short iMAP* sweeps carry frustum shells."""
    import numpy as np

    t0 = time.perf_counter()
    draws = draws_at_once("imap_box", imap_box_runs("imap_quality"))
    ates = [d["ate_rmse_cm"] for d in draws]
    depth_l1 = draws[0]["depth_l1_cm"]
    # a frozen camera scores 0.73 cm on this short orbit, under the 5 cm
    # gate, so each draw must also beat it
    ok = all(d["ate_rmse_cm"] <= IMAP_ATE_GATE_CM and d["ate_rmse_cm"] < d["frozen_ate_cm"]
             for d in draws) and depth_l1 <= IMAP_TRACKED_DEPTH_L1_CM
    emit({"phase": "imap_quality", "ok": ok, "frames": 30, "draws": draws,
          "median_ate_cm": float(np.median(ates)), "gate_cm": IMAP_ATE_GATE_CM,
          "depth_l1_gate_cm": IMAP_TRACKED_DEPTH_L1_CM,
          "median_mesh_wall_m": float(np.median([d["mesh_wall_m"] for d in draws])),
          "seconds": time.perf_counter() - t0})
    if not ok:
        raise AssertionError(f"iMAP tracked ATE over seeds {IMAP_QUALITY_SEEDS}: {ates} cm; "
                             f"every draw must be <= {IMAP_ATE_GATE_CM} and beat a frozen "
                             f"camera ({[d['frozen_ate_cm'] for d in draws]} cm); seed "
                             f"{IMAP_QUALITY_SEEDS[0]} depth L1 {depth_l1} cm (gate "
                             f"{IMAP_TRACKED_DEPTH_L1_CM})")


READERS_FRAMES = 5            # frames per layout of the readers' export
REPLICA_CAM = {"H": 680, "W": 1200, "fx": 600.0, "fy": 600.0, "cx": 599.5, "cy": 339.5}
READERS_PSNR_DB = 30.0        # JPEG colour against the generator's render
POSE_TOL = 1e-5
READERS_LOOP_FRAMES = 10      # the strict loop from a Replica-layout export
TOUR_FRAMES = 150             # the tours the JAX quality gates were set for
TOUR_ORBIT = 6.283
# tests/test_quality_gates.py:42-45 (gt_tour) and :46-47 (imap); ratio is a floor
GT_TOUR_GATES = {"accuracy_cm": 1.5, "completion_cm": 1.5, "depth_l1_cm": 0.5}
GT_TOUR_RATIO_PCT = 98.0
IMAP_TOUR_GATES = {"accuracy_cm": 10.0, "depth_l1_cm": 6.0}
IMAP_TRACKED_DEPTH_L1_CM = 3.0  # tests/test_quality_gates.py:72-73 (imap_tracked)
DEPTH_L1_IMGS = 200           # the JAX selfcheck's default
NOT_IMPORTED = ("cv2", "PIL", "matplotlib", "jax", "nice_slam_tpu")


def psnr_db(a, b) -> float:
    import numpy as np

    return float(10 * np.log10(1.0 / np.mean((np.asarray(a, np.float64) - b) ** 2)))


def check_layout(name, ds, gen, cfg):
    """One exported layout read back against the generator: depth bit for
    bit (PNG: quantised to its step; EXR: exact), poses within POSE_TOL
    (TUM: relative to the first pose; CoFusion has identity poses), colour
    at READERS_PSNR_DB (JPEG) or exactly the generator's 8-bit colour
    (PNG; TUM's undistorted by the same map).  Returns the worst PSNR and
    pose error (PSNR None for a PNG layout)."""
    import numpy as np

    from nice_slam_torch.utils import imageio

    pds = cfg["cam"]["png_depth_scale"]
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    g0_inv = np.linalg.inv(gen.poses[0].astype(np.float64))
    worst_psnr, worst_pose = None, 0.0
    for i in range(len(gen)):
        _, color, depth, pose = ds[i]
        _, gcolor, gdepth, gpose = gen[i]
        if name == "cofusion":
            want_depth = gdepth
        else:
            want_depth = np.round(gdepth * pds).astype(np.uint16).astype(np.float32) / pds
        if not np.array_equal(depth, want_depth.astype(np.float32)):
            raise AssertionError(f"{name} frame {i}: depth differs from the generator's "
                                 f"(max {np.abs(depth - want_depth).max()})")
        if name == "tumrgbd":  # relative to the first pose: flip(inv(g0 flip) gk flip)
            want_pose = flip @ g0_inv @ gpose.astype(np.float64)
        elif name == "cofusion":
            want_pose = np.eye(4)
        else:
            want_pose = gpose
        err = float(np.abs(pose - want_pose).max())
        worst_pose = max(worst_pose, err)
        if err > POSE_TOL:
            raise AssertionError(f"{name} frame {i}: pose off by {err}")
        u8 = (np.clip(gcolor, 0, 1) * 255).astype(np.uint8)
        if name in ("tumrgbd", "cofusion"):
            if name == "tumrgbd":
                u8 = imageio.remap(u8, ds._undistort_maps)
            if not np.array_equal(color, u8.astype(np.float32) / 255.0):
                raise AssertionError(f"{name} frame {i}: PNG colour is not the generator's")
        else:
            p = psnr_db(color, gcolor)
            worst_psnr = p if worst_psnr is None else min(worst_psnr, p)
            if not p >= READERS_PSNR_DB:
                raise AssertionError(f"{name} frame {i}: colour at {p:.2f} dB PSNR, "
                                     f"below {READERS_PSNR_DB}")
    return worst_psnr, worst_pose


def phase_readers(dev):
    """The port's exporter writes the five real layouts at Replica's
    camera; its readers read them back with no imaging library importable
    and are held to the generator; the OpenCV-written fixtures of
    tests/data/imageio decode to OpenCV's pixels; then the strict loop runs
    ten frames from a Replica-layout export through the CLI's entry point
    (``nice_slam_torch.run.main``), launching K1-K10."""
    import hashlib

    import numpy as np
    import torch
    import yaml

    from nice_slam_torch import run as cli
    from nice_slam_torch.tools import export_synthetic as tex
    from nice_slam_torch.tools.eval_ate import ate_rmse
    from nice_slam_torch.tools.workloads import box_quality_cfg
    from nice_slam_torch.utils import datasets, imageio

    # this machine may have OpenCV or PIL installed: from here on their
    # import raises, so the readers and the tours run as without them
    for mod in NOT_IMPORTED:
        if sys.modules.get(mod) is not None:
            raise AssertionError(f"{mod} was imported by the port")
        sys.modules[mod] = None
    t0 = time.perf_counter()
    out = os.path.join(HERE, "output", "chip_smoke", "readers")
    shutil.rmtree(out, ignore_errors=True)
    with open(os.path.join(HERE, "configs", "TUM_RGBD", "freiburg1_desk.yaml")) as f:
        tum_distortion = yaml.safe_load(f)["cam"]["distortion"]
    export_cfg = tex._default_cfg(READERS_FRAMES, REPLICA_CAM["H"], REPLICA_CAM["W"])
    export_cfg["cam"].update(REPLICA_CAM)
    gen = datasets.Synthetic(export_cfg)
    layouts = {"replica": "replica", "scannet": "scannet", "tumrgbd": "tum",
               "cofusion": "cofusion", "azure": "azure"}
    report, export_s = {}, {}
    for name, fmt in layouts.items():
        folder = os.path.join(out, name)
        t1 = time.perf_counter()
        tex.EXPORTERS[fmt](folder, export_cfg)
        export_s[name] = time.perf_counter() - t1
        cfg = {"dataset": name, "cam": dict(export_cfg["cam"]),
               "data": {"input_folder": folder}}
        if name == "cofusion":
            cfg["cam"]["png_depth_scale"] = 1.0
        if name == "tumrgbd":
            cfg["cam"]["distortion"] = tum_distortion
        ds = datasets.get_dataset(cfg, None, 1.0)
        if len(ds) != READERS_FRAMES:
            raise AssertionError(f"{name}: read {len(ds)} frames, wrote {READERS_FRAMES}")
        worst_psnr, worst_pose = check_layout(name, ds, gen, cfg)
        report[name] = {"reader": type(ds).__name__, "worst_psnr_db": worst_psnr,
                        "worst_pose_err": worst_pose, "export_s": export_s[name]}
    # the reader's cost per 680x1200 frame: JPEG colour + 16-bit PNG depth
    replica = datasets.get_dataset({"dataset": "replica", "cam": dict(export_cfg["cam"]),
                                    "data": {"input_folder": os.path.join(out, "replica")}})
    read_ms = []
    for i in range(len(replica)):
        t1 = time.perf_counter()
        replica[i]
        read_ms.append(1e3 * (time.perf_counter() - t1))
    # OpenCV's pixels of the fixtures, decoded here; the undistort entry is
    # OpenCV's undistort of a fixture's crop at freiburg1_desk's camera
    data = os.path.join(HERE, "tests", "data", "imageio")
    with open(os.path.join(data, "manifest.json")) as f:
        manifest = json.load(f)
    for fname, entry in sorted(manifest.items()):
        if entry["read"] == "undistort":
            H, W = entry["shape"][:2]
            src = imageio.imread_color(os.path.join(data, entry["source"]))[:H, :W]
            img = imageio.undistort(src, np.array(entry["K"]), entry["dist"])
        elif entry["read"] == "color":
            img = imageio.imread_color(os.path.join(data, fname))
        else:
            img = imageio.imread_unchanged(os.path.join(data, fname))
        digest = hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
        if list(img.shape) != entry["shape"] or digest != entry["sha256"]:
            raise AssertionError(f"fixture {fname}: decoded pixels differ from OpenCV's")

    # ten frames of the strict loop from a Replica layout at the box camera
    loop_dir = os.path.join(out, "box_replica")
    box_cfg = tex._default_cfg(READERS_LOOP_FRAMES, 120, 160)
    box_cfg["data"]["orbit_radians"] = 0.25 * READERS_LOOP_FRAMES / 30.0
    tex.export_replica(loop_dir, box_cfg)
    run_out = os.path.join(out, "box_replica_run")
    cfg = box_quality_cfg(run_out)
    cfg["dataset"] = "replica"
    cfg["cam"]["png_depth_scale"] = box_cfg["cam"]["png_depth_scale"]
    cfg["mapping"]["save_selected_keyframes_info"] = True
    cfg_path = os.path.join(out, "box_replica.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    reset_counts()
    slam = cli.main([cfg_path, "--input_folder", loop_dir])
    counts = all_counts()
    if type(slam.frame_reader).__name__ != "Replica" or slam.n_img != READERS_LOOP_FRAMES:
        raise AssertionError(f"the loop read {slam.n_img} frames through "
                             f"{type(slam.frame_reader).__name__}, not Replica")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the readers' loop: {missing}")
    ate = 100 * ate_rmse(slam.estimate_c2w_list.cpu().numpy(), slam.gt_c2w_list)
    if not ate <= ATE_DIVERGED_CM:
        raise AssertionError(f"the readers' loop diverged: ATE {ate} cm")
    ckpt = torch.load(os.path.join(run_out, "ckpts", f"{slam.n_img - 1:05d}.tar"),
                      map_location="cpu", weights_only=False)
    sel = ckpt["selected_keyframes"]
    mapped = sorted({*range(0, slam.n_img, slam.mcfg.every_frame), slam.n_img - 1})
    if not sel or sorted(sel) != mapped:
        raise AssertionError(f"checkpoint selected_keyframes: {sel and sorted(sel)}")
    emit({"phase": "readers", "ok": True, "H": REPLICA_CAM["H"], "W": REPLICA_CAM["W"],
          "frames_per_layout": READERS_FRAMES, "layouts": report,
          "read_ms_per_frame": read_ms, "read_ms_mean": float(np.mean(read_ms)),
          "fixtures": sorted(manifest), "loop_frames": slam.n_img,
          "loop_fps": slam.timings.get("fps"), "loop_ate_cm": ate,
          "loop_launches": counts, "selected_keyframes": sorted(sel),
          "seconds": time.perf_counter() - t0})


def tour_run(dev, label, flags):
    """One run of the port's ``selfcheck`` with ``flags`` in this process,
    its output under output/chip_smoke/``label``: its summary with the
    timings apart, K1-K10's launches and its seconds."""
    from nice_slam_torch.tools import selfcheck

    out = os.path.join(HERE, "output", "chip_smoke", label)
    shutil.rmtree(out, ignore_errors=True)
    flags = list(flags) + ["--out", out, "--device", str(dev)]
    reset_counts()
    t0 = time.perf_counter()
    summary = selfcheck.run(selfcheck.parser().parse_args(flags))
    return {"flags": flags, "summary": {k: v for k, v in summary.items() if k != "timings"},
            "timings": summary["timings"], "launches": all_counts(),
            "seconds": time.perf_counter() - t0}


def phase_tours(dev):
    """The port's ``selfcheck --gt_camera`` tours (150 frames, a full
    orbit, mapped from ground-truth cameras; its other flags at their
    defaults), NICE and ``--imap`` (as QUALITY.json's 'imap' row was
    recorded), the two at once (``tour_run``), each held to the JAX
    quality gates; K1-K3 launches counted over each whole run."""
    flags = ["--frames", str(TOUR_FRAMES), "--orbit_radians", str(TOUR_ORBIT),
             "--depth_l1_imgs", str(DEPTH_L1_IMGS), "--gt_camera"]
    failed_any = []
    for name, r in zip(("gt_tour", "imap_tour"), draws_at_once(
            "tour", [dict(label="gt_tour", flags=flags),
                     dict(label="imap_tour", flags=flags + ["--imap"])])):
        imap = name == "imap_tour"
        s, counts = r["summary"], {k: r["launches"][k] for k in K1_K3}
        t = r["contended"]["timings"]
        gates = IMAP_TOUR_GATES if imap else GT_TOUR_GATES
        failed = [k for k, bound in gates.items()
                  if s[k] is None or not s[k] <= bound]
        if not imap and not s["completion_ratio_pct"] >= GT_TOUR_RATIO_PCT:
            failed.append("completion_ratio_pct")
        if imap:
            if any(counts.values()):
                failed.append(f"launches {counts} (the iMAP* path launches none)")
        elif counts["trilinear_bwd_dp"] != 0 or counts["trilinear_fwd"] <= 0 \
                or counts["trilinear_bwd_dgrid"] <= 0:
            failed.append(f"launches {counts} (no tracking: K3 0, K1 and K2 > 0)")
        emit({"phase": name, "ok": not failed, "flags": r["flags"], "summary": s,
              "gates": gates,
              **({} if imap else {"completion_ratio_floor_pct": GT_TOUR_RATIO_PCT}),
              "launches": counts,
              "contended": {"draws_at_once": r["contended"]["draws_at_once"],
                            "slam_s": t["total_s"] - t["meshing_s"],
                            "mesh_s": t["meshing_s"], "gt_mesh_s": t["gt_mesh_s"],
                            "metric_3d_s": t["eval_3d_s"], "metric_2d_s": t["eval_2d_s"],
                            "fps": t.get("fps"), "seconds": r["contended"]["seconds"]}})
        failed_any += [f"{name}: {f}" for f in failed]
    if failed_any:
        raise AssertionError(f"the tours failed their gates: {failed_any}")


# QUALITY.json's tracked_tour record (tests/test_quality_gates.py:59-61): the
# box with BA, the hash texture and 2000 tracking pixels over a full orbit
TRACKED_TOUR_FLAGS = ["--ba", "--texture", "hash", "--track_pixels", "2000", "--frames",
                      "750", "--orbit_radians", "6.283"]
TRACKED_TOUR_GATES = {"ate_rmse_cm": 40.0, "depth_l1_cm": 3.0}
TRACKED_TOUR_RATIO_PCT = 25.0
TRACKED_TOUR_SEEDS = QUALITY_SEEDS  # a family, as the box's: one draw is too noisy
TRACKED_TOUR_TIMEOUT_S = 1500       # per draw; one alone took 283 s (H100 80GB HBM3, 700 W)


def phase_tracked_tour(dev):
    """The tracked tour (``python3 chip_smoke.py --tracked_tour``): a draw
    (``tour_run`` with TRACKED_TOUR_FLAGS) for each of TRACKED_TOUR_SEEDS,
    all at once (the tour is host-bound: four at once took 1.6x one alone
    on an H100 80GB HBM3 at 700 W), held
    to the tracked_tour record's gates, copied unchanged, on the family's
    medians: ATE <= 40 cm, depth L1 <= 3 cm, completion ratio >= 25 %.
    One draw is not gated: the runs are nondeterministic (K2 sums with
    atomics) and four single draws on one H100 read ATE 21.8-44.8 cm and
    completion ratio 19.7-45.3 %.  Every draw must track every frame and
    launch K3 (tracking, and every BA mapping iteration)."""
    import numpy as np

    t0 = time.perf_counter()
    draws = draws_at_once("tour", [dict(label=f"tracked_tour_s{seed}",
                                        flags=TRACKED_TOUR_FLAGS + ["--seed", str(seed)])
                                   for seed in TRACKED_TOUR_SEEDS],
                          timeout=TRACKED_TOUR_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    failed = []
    for seed, d in zip(TRACKED_TOUR_SEEDS, draws):
        d["seed"] = seed
        tracked = d["contended"]["timings"]["tracked_frames"]
        if tracked != d["summary"]["frames"] - 1 or d["launches"]["trilinear_bwd_dp"] <= 0:
            failed.append(f"draw {seed}: tracked {tracked} frames, launches {d['launches']}")
    medians = {k: float(np.median([d["summary"][k] for d in draws]))
               for k in ("ate_rmse_cm", "depth_l1_cm", "completion_ratio_pct",
                         "accuracy_cm", "completion_cm")}
    failed += [k for k, bound in TRACKED_TOUR_GATES.items() if not medians[k] <= bound]
    if not medians["completion_ratio_pct"] >= TRACKED_TOUR_RATIO_PCT:
        failed.append("completion_ratio_pct")
    emit({"phase": "tracked_tour", "ok": not failed, "flags": TRACKED_TOUR_FLAGS,
          "seeds": list(TRACKED_TOUR_SEEDS), "medians": medians, "gates": TRACKED_TOUR_GATES,
          "completion_ratio_floor_pct": TRACKED_TOUR_RATIO_PCT,
          "jax_record_tpu_v5e": {"ate_rmse_cm": 27.109, "completion_ratio_pct": 40.2,
                                 "depth_l1_cm": 1.579},
          "draws": [{"seed": d["seed"], "launches": d["launches"], **d["summary"],
                     "contended": d["contended"]} for d in draws],
          "seconds": seconds})
    if failed:
        raise AssertionError(f"tracked_tour failed its gates: {failed}")


PRETRAIN_SCENES = 2            # the recipe's 40 scenes, cut for time
PRETRAIN_STEPS = 300           # per stage: the recipe's
PRETRAIN_SAMPLES = 4096        # per step: the recipe's
PRETRAIN_WINDOW = 50           # the first and the last steps a stage's loss is averaged over
ENVELOPE_FRAMES = 20           # tools/track_envelope.py's default
ENVELOPE_DEGS = "1.0,2.5"      # per-frame orbit motion of the two sweep points
ENVELOPE_CF = ("5", "5.0")     # --cf_iters, --cf_mult: the tool's defaults
ENVELOPE_OK_CM = 10.0          # tests/test_quality_gates.py:148-154: max_ok's bound
LANDSCAPE_FRAMES = ("30", "90", "149")
LANDSCAPE_DELTAS_CM = ("-4", "-2", "-1", "0", "1", "2", "4")  # the tool's default
LANDSCAPE_PIXELS = "2000"


def pretrain_captures():
    """Record the first K1 and K2 arguments of the pretrainer's coarse and
    fine stages (told apart by the grid shapes) while the wrappers run."""
    from nice_slam_torch.ops import interp
    from nice_slam_torch.tools import pretrain_decoders as P

    seen = {}
    fwd, dgrid = interp.trilinear_fwd_multi, interp.trilinear_bwd_dgrid_multi
    coarse = (*P.GRID_SHAPES["grid_coarse"], 32)
    fine = (*P.GRID_SHAPES["grid_fine"], 32)

    def stage_of(shape):
        return {coarse: "pretrain_coarse", fine: "pretrain_fine"}.get(tuple(shape))

    def rec_fwd(grids, p):
        name = stage_of(grids[0].shape)
        if name and "fwd_" + name not in seen:
            seen["fwd_" + name] = {"p": p.detach().clone(),
                                   "grids": [g.detach().clone() for g in grids]}
        return fwd(grids, p)

    def rec_dgrid(p, gs, shapes):
        name = stage_of(shapes[0])
        if name and "dgrid_" + name not in seen:
            seen["dgrid_" + name] = {"p": p.detach().clone(),
                                     "gs": [g.detach().clone() for g in gs]}
        return dgrid(p, gs, shapes)

    def restore():
        interp.trilinear_fwd_multi, interp.trilinear_bwd_dgrid_multi = fwd, dgrid

    interp.trilinear_fwd_multi, interp.trilinear_bwd_dgrid_multi = rec_fwd, rec_dgrid
    return seen, restore


def phase_pretrain(dev):
    """The decoder pretrainer at the recipe's full width (coarse, middle and
    fine decoders 32 wide, grids 6^3 / 19^3 / 38^3 x 32 over +-3 m, 4096
    points x 300 Adam steps per stage), cut in depth to PRETRAIN_SCENES
    scenes: every loss finite and each stage's mean over its last
    PRETRAIN_WINDOW steps below its mean over its first; one K1 and one K2
    launch per step, no K3; K1 and K2 held against their plain versions on
    the first coarse-stage and fine-stage step's arguments (the fine
    stage's K1 reads the fine and middle grids, its K2 writes the fine
    grid's gradient only); the export loaded back through the port's
    loader equal to the trained decoders bit for bit, with the key set
    and shapes of the repo's pretrained/*.pt."""
    import numpy as np
    import torch

    from nice_slam_torch.config import load_config
    from nice_slam_torch.models.pretrain import load_pretrain
    from nice_slam_torch.models.scene import build_scene
    from nice_slam_torch.tools import pretrain_decoders as P

    out = os.path.join(HERE, "output", "chip_smoke", "pretrain")
    shutil.rmtree(out, ignore_errors=True)
    seen, restore = pretrain_captures()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    try:
        dec, losses = P.pretrain(PRETRAIN_SCENES, PRETRAIN_STEPS, PRETRAIN_SAMPLES,
                                 seed=0, device=dev, verbose=False)
        torch.cuda.synchronize()
    finally:
        restore()
    seconds = time.perf_counter() - t0
    counts = all_counts()
    steps = PRETRAIN_SCENES * len(P.STAGES) * PRETRAIN_STEPS
    failed = []
    # every step trains its decoder: one K4, one K5, one K6 and one K9; it
    # renders nothing (no K7, K8) and selects no frustum (no K10)
    want = {**dict.fromkeys(counts, steps), "trilinear_bwd_dp": 0,
            **k7_k10_want(0, 0, adam=steps)}
    if counts != want:
        failed.append(f"launches {counts}, not {want}")
    if not np.isfinite(losses).all():
        failed.append("non-finite losses")
    first = losses[..., :PRETRAIN_WINDOW].mean(axis=-1)
    last = losses[..., -PRETRAIN_WINDOW:].mean(axis=-1)
    if not (last < first).all():
        failed.append(f"a stage's loss did not fall: first {first.tolist()}, "
                      f"last {last.tolist()}")

    P.export_torch(dec, out)
    cfg = load_config(os.path.join(HERE, "configs", "Synthetic", "box.yaml"),
                      os.path.join(HERE, "configs", "nice_slam.yaml"))
    cfg["coarse"] = True
    cfg["pretrained_decoders"] = {"coarse": os.path.join(out, "coarse.pt"),
                                  "middle_fine": os.path.join(out, "middle_fine.pt")}
    spec, state = build_scene(cfg, device=dev)
    state = load_pretrain(cfg, spec, state, verbose=False)
    for name in P.STAGES:
        got, want = leaves(state.decoders[name]), leaves(dec[name])
        if len(got) != len(want) or not all(torch.equal(a, b) for a, b in zip(got, want)):
            failed.append(f"the exported {name} decoder does not load back bit for bit")
    for fname in ("coarse.pt", "middle_fine.pt"):
        shapes = [{k: tuple(v.shape) for k, v in torch.load(
            path, map_location="cpu", weights_only=False)["model"].items()}
            for path in (os.path.join(out, fname),
                         os.path.join(HERE, "pretrained", fname))]
        if shapes[0] != shapes[1]:
            failed.append(f"{fname}: keys or shapes differ from the repo's")

    rows = []
    for name in ("pretrain_coarse", "pretrain_fine"):
        f, d = seen["fwd_" + name], seen["dgrid_" + name]
        pts_b, gather_b, feat_b, _, _, lib_fwd, timed, held = case_tools(
            name, f["grids"], f["p"])
        rows.append(k1_row(name, f["grids"], f["p"], gather_b + pts_b + feat_b,
                           timed, held, lib_fwd))
        rows.append(k2_row(name, f["grids"][:1], d["p"], d["gs"]))
    with_bounds(rows)
    emit({"phase": "pretrain", "ok": not failed, "scenes": PRETRAIN_SCENES,
          "recipe_scenes": 40, "steps_per_stage": PRETRAIN_STEPS,
          "samples": PRETRAIN_SAMPLES, "grids": P.GRID_SHAPES, "steps": steps,
          "seconds": seconds, "steps_per_s": steps / seconds,
          "loss_first_mean": first.tolist(), "loss_last_mean": last.tolist(),
          "final_losses": losses[:, :, -1].tolist(), "launches": counts,
          "rows": rows, "failed": failed})
    if failed:
        raise AssertionError(f"pretrain failed: {failed}")
    return rows, counts


def phase_envelope(dev):
    """The port's track_envelope at the box's full width (120x160, 20
    frames, first mapping 400 iterations, coarse off) at 1.0 and 2.5 deg
    per frame, each with the default tracking budget and with the
    coarse-to-fine schedule (5 iterations at 5x): every row finite, the
    1.0 deg rows within ATE_DIVERGED_CM, and the JAX quality gate's rule
    (tests/test_quality_gates.py:148-154): the largest motion the cf mode
    tracks below 10 cm is at least the default mode's.  K3 launches once
    per tracking iteration and K2 once per mapping iteration; K1 once per
    both, plus the final meshes' chunks; K7, K8 and K9 once per both, and
    K10 once per mapping call."""
    import math

    from nice_slam_torch.slam import mapper as M
    from nice_slam_torch.tools import track_envelope as E

    out = os.path.join(HERE, "output", "chip_smoke", "envelope")
    shutil.rmtree(out, ignore_errors=True)
    iters = {"mapping": 0}
    inner = M.Mapper.optimize_map

    def counted(self, *a, **k):
        res = inner(self, *a, **k)
        iters["mapping"] += int(res[2].shape[0])
        return res

    reset_counts()
    M.Mapper.optimize_map = counted
    t0 = time.perf_counter()
    calls = []
    try:
        with recorded_core(calls):
            rows = E.main(["--frames", str(ENVELOPE_FRAMES), "--deg", ENVELOPE_DEGS,
                           "--cf_iters", ENVELOPE_CF[0], "--cf_mult", ENVELOPE_CF[1],
                           "--out", out, "--device", "cuda:0"])
    finally:
        M.Mapper.optimize_map = inner
    seconds = time.perf_counter() - t0
    counts = all_counts()
    cfg = E.base_cfg()
    track_iters = len(rows) * (ENVELOPE_FRAMES - 1) * cfg["tracking"]["iters"]
    by = {}
    for r in rows:
        by.setdefault(r["mode"], {})[r["deg_per_frame"]] = r["ate_rmse_cm"]

    def max_ok(curve):
        ok = [d for d, a in curve.items() if a < ENVELOPE_OK_CM]
        return max(ok) if ok else 0.0

    failed = []
    if not all(math.isfinite(r["ate_rmse_cm"]) for r in rows):
        failed.append("non-finite ATE")
    slow = [r for r in rows if r["deg_per_frame"] == 1.0]
    if len(slow) != 2 or not all(r["ate_rmse_cm"] <= ATE_DIVERGED_CM for r in slow):
        failed.append(f"1.0 deg/frame rows above {ATE_DIVERGED_CM} cm: {slow}")
    if not max_ok(by["cf"]) >= max_ok(by["default"]):
        failed.append(f"cf tracks below {ENVELOPE_OK_CM} cm up to {max_ok(by['cf'])} "
                      f"deg/frame, default up to {max_ok(by['default'])}")
    if counts["trilinear_bwd_dp"] != track_iters or \
            counts["trilinear_bwd_dgrid"] != iters["mapping"] or \
            counts["trilinear_fwd"] <= track_iters + iters["mapping"] or \
            counts["decoder_fwd"] != counts["trilinear_fwd"] or \
            counts["decoder_bwd"] != track_iters + iters["mapping"] or \
            {k: counts[k] for k in K7_K10} != k7_k10_want(
                track_iters + iters["mapping"], sum(c[5] for c in calls)):
        failed.append(f"launches {counts} for {track_iters} tracking and "
                      f"{iters['mapping']} mapping iterations in {len(calls)} calls")
    emit({"phase": "envelope", "ok": not failed, "frames": ENVELOPE_FRAMES,
          "H": cfg["cam"]["H"], "W": cfg["cam"]["W"],
          "iters_first": cfg["mapping"]["iters_first"], "cf": ENVELOPE_CF, "rows": rows,
          "max_ok_deg": {m: max_ok(c) for m, c in by.items()},
          "tracking_iters": track_iters, "mapping_iters": iters["mapping"],
          "launches": counts, "seconds": seconds, "failed": failed})
    if failed:
        raise AssertionError(f"envelope failed: {failed}")
    return counts


def phase_landscape(dev):
    """The port's loss_landscape on the gt_tour phase's final checkpoint:
    frames 30, 90 and 149 of the 150-frame orbit, offsets -4..4 cm (and
    2.5x that in yaw radians), 2000 pixels drawn once per frame.  The
    losses finite, the rows shaped as the JAX tool's, one K1 launch per
    evaluation and no K2 or K3."""
    import math

    from nice_slam_torch.tools import loss_landscape as L

    tour = os.path.join(HERE, "output", "chip_smoke", "gt_tour")
    record = os.path.join(HERE, "output", "chip_smoke", "landscape.json")
    reset_counts()
    t0 = time.perf_counter()
    book = L.main(["--out", tour, "--frames", *LANDSCAPE_FRAMES,
                   "--deltas_cm", *LANDSCAPE_DELTAS_CM, "--pixels", LANDSCAPE_PIXELS,
                   "--n_frames", str(TOUR_FRAMES), "--orbit_radians", str(TOUR_ORBIT),
                   "--record", record, "--device", "cuda:0"])
    seconds = time.perf_counter() - t0
    counts = all_counts()
    evals = len(LANDSCAPE_FRAMES) * 3 * len(LANDSCAPE_DELTAS_CM)
    failed = []
    if sorted(book) != sorted(LANDSCAPE_FRAMES):
        failed.append(f"frames {sorted(book)}")
    for frame, rows in book.items():
        if sorted(rows) != ["lateral-x", "vertical-y", "yaw"]:
            failed.append(f"frame {frame}: DOFs {sorted(rows)}")
        for dof, r in rows.items():
            if len(r["losses"]) != len(LANDSCAPE_DELTAS_CM) or \
                    not all(math.isfinite(v) for v in r["losses"]):
                failed.append(f"frame {frame} {dof}: losses {r['losses']}")
    want = {"trilinear_fwd": evals, "decoder_fwd": evals, "integrate_fwd": evals}
    if counts != {k: want.get(k, 0) for k in counts}:
        failed.append(f"launches {counts}, not {evals} K1, K4 and K7 only")
    emit({"phase": "landscape", "ok": not failed, "checkpoint_of": "gt_tour",
          "frames": list(LANDSCAPE_FRAMES), "deltas_cm": list(LANDSCAPE_DELTAS_CM),
          "pixels": int(LANDSCAPE_PIXELS), "evaluations": evals,
          "biased": {f: {d: r["biased"] for d, r in rows.items()} for f, rows in book.items()},
          "argmin_cm": {f: {d: 100 * r["argmin_delta"] for d, r in rows.items()}
                        for f, rows in book.items()},
          "base": {f: {d: r["base"] for d, r in rows.items()} for f, rows in book.items()},
          "book": book, "launches": counts, "seconds": seconds, "failed": failed})
    if failed:
        raise AssertionError(f"landscape failed: {failed}")
    return counts


VIEWER_WEB_TIMEOUT_S = 300


def phase_viewer(dev):
    """``python -m nice_slam_torch.visualizer`` on the slice phase's output:
    offline with --save_rendering, vis.mp4 must hold one frame per frame
    0..N of the checkpoint, each a JPEG the port's decoder reads at the
    replay's size; then --frontend web on 127.0.0.1 at a free port, in its
    own process with the same modules unimportable, must serve the page,
    the mesh of the run's last frame and the run's poses; the process is
    stopped after."""
    import socket
    import urllib.request

    import numpy as np
    import torch
    import yaml

    from nice_slam_torch import visualizer
    from nice_slam_torch.tools.webviz import mesh_blob
    from nice_slam_torch.tools.workloads import replica_synthetic_cfg
    from nice_slam_torch.utils.imageio import decode_jpeg
    from nice_slam_torch.utils.meshlib import read_ply
    from nice_slam_torch.utils.mjpeg_mp4 import read_mp4_jpegs

    run = os.path.join(HERE, "output", "chip_smoke", "slice")
    cfg_path = os.path.join(HERE, "output", "chip_smoke", "viewer.yaml")
    cfg = replica_synthetic_cfg(run, n_frames=12, iters_first=SLICE_ITERS_FIRST)
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    ckpt = sorted(os.listdir(os.path.join(run, "ckpts")))[-1]
    ckpt = torch.load(os.path.join(run, "ckpts", ckpt), map_location="cpu",
                      weights_only=False)
    n = int(ckpt["idx"]) + 1
    t0 = time.perf_counter()
    fe = visualizer.main([cfg_path, "--save_rendering", "--frontend", "offline"])
    offline_s = time.perf_counter() - t0
    jpegs = read_mp4_jpegs(os.path.join(run, "vis.mp4"))
    failed = []
    if len(jpegs) != n or len(fe.frames) != n:
        failed.append(f"vis.mp4 holds {len(jpegs)} frames, not {n}")
    shapes = {decode_jpeg(j).shape for j in jpegs}
    if shapes != {(fe.H, fe.W, 3)}:
        failed.append(f"decoded frame shapes {shapes}")

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = ("import sys\n"
            f"for m in {NOT_IMPORTED!r}:\n    sys.modules[m] = None\n"
            "from nice_slam_torch.visualizer import main\n"
            f"main([{cfg_path!r}, '--frontend', 'web', '--port', '{port}'])\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=HERE,
                            env=dict(os.environ, PYTHONPATH=HERE),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    t1 = time.perf_counter()
    state, page, blob = None, b"", b""
    try:
        base = f"http://127.0.0.1:{port}"
        while time.perf_counter() - t1 < VIEWER_WEB_TIMEOUT_S and proc.poll() is None:
            try:
                with urllib.request.urlopen(base + "/state", timeout=30) as r:
                    state = json.loads(r.read())
                if state["done"]:
                    break
            except OSError:
                pass
            time.sleep(0.2)
        if state is not None and state["done"]:
            with urllib.request.urlopen(base + "/", timeout=30) as r:
                page = r.read()
            with urllib.request.urlopen(base + "/mesh.bin", timeout=120) as r:
                blob = r.read()
    finally:
        proc.terminate()
        try:
            log = proc.communicate(timeout=60)[0].decode(errors="replace")
        except subprocess.TimeoutExpired:
            proc.kill()
            log = proc.communicate()[0].decode(errors="replace")
    web_s = time.perf_counter() - t1
    if state is None or not state["done"]:
        failed.append(f"the web viewer never finished its replay: {log[-2000:]}")
    else:
        est = np.asarray(ckpt["estimate_c2w_list"], np.float32)[:n, :3, 3] / cfg["scale"]
        gt = np.asarray(ckpt["gt_c2w_list"], np.float32)[:n, :3, 3] / cfg["scale"]
        if not (np.allclose(state["est"], est, atol=1e-6)
                and np.allclose(state["gt"], gt, atol=1e-6)):
            failed.append("the web viewer's poses are not the run's")
        if b"webgl" not in page:
            failed.append("the web viewer's page lacks its WebGL viewer")
        last_mesh = os.path.join(run, "mesh", f"{n - 1:05d}_mesh.ply")
        if blob != mesh_blob(*read_ply(last_mesh)):
            failed.append(f"/mesh.bin is not {last_mesh}")
    emit({"phase": "viewer", "ok": not failed, "run": "slice", "frames": n,
          "render_hw": [fe.H, fe.W], "offline_s": offline_s,
          "seconds_per_frame": offline_s / n, "video_bytes": sum(map(len, jpegs)),
          "web_port": port, "web_s": web_s, "mesh_bytes": len(blob),
          "failed": failed})
    if failed:
        raise AssertionError(f"viewer failed: {failed}")


SHARD_DS = (2, 4)             # slabs per grid in the window kernels' cases
SHARD_CASES = ("fine_map", "map_color", "track")  # kernels-phase cases cut into slabs
SHARD_LOOP_D = 4              # the sharded 12-frame loop
SHARD_BOX_D = 2               # the sharded box family
SHARD_BOX_SEEDS = (42, 0, 1)
PER_DEVICE_BYTES_D4 = 13_110_272  # fine, color 20 of 74 planes, middle 10 of 37, coarse 4 of 11
DP_REPLICAS = 2
DP_ITERS = 20                 # the ray-parallel mapping call: the Replica stage plan of 20
# per-iteration losses of a call repeated with other atomics orders: the
# card-against-CPU mapping test's rtol
# (tests/test_torch_cuda.py::test_imap_mapping_iterations_on_cuda_match_cpu)
DP_LOSS_RTOL = 1e-4
LATTICE_DP_ATOL = 1e-5
# the pinned coarse call against the unpinned one: K2's atomics order makes
# their losses drift apart with the iterations (7.9e-5 relative after 30
# on an H100), so the comparison stops at 10
PIN_ITERS = 10


def slab_f64(p, g, shape, window):
    """``dgrid_f64`` for a slab: K2's plain version with the slab window,
    summed in float64, and the same sum of |w_k g|."""
    import torch

    from nice_slam_torch.ops import interp

    i0, i1, frac, _, own = interp._slab_corners(shape, window, p)
    weights, _ = interp._corner_weights(frac)
    if own is not None:
        g = g * own[:, None]
    out = torch.zeros((2, shape[0] * shape[1] * shape[2], shape[3]),
                      dtype=torch.float64, device=p.device)
    for r, w in zip(interp._corner_rows(shape, i0, i1), weights):
        c = (w[:, None] * g).double()
        out[0].index_add_(0, r, c)
        out[1].index_add_(0, r, c.abs())
    return out[0].reshape(shape), out[1].reshape(shape)


def slab_bytes(slabs, windows, p):
    """Per grid of one slab launch: the points it owns and the slab rows
    those points touch."""
    import torch

    from nice_slam_torch.ops import interp

    owned, touched = [], []
    for s, w in zip(slabs, windows):
        i0, i1, _, _, own = interp._slab_corners(s.shape, w, p)
        keep = torch.ones(p.shape[0], dtype=torch.bool, device=p.device) if own is None else own
        rows = torch.cat([r[keep] for r in interp._corner_rows(s.shape, i0, i1)])
        owned.append(int(keep.sum()))
        touched.append(int(torch.unique(rows).numel()))
    return owned, touched


K1_K3 = ("trilinear_fwd", "trilinear_bwd_dgrid", "trilinear_bwd_dp")


def window_case(label, c, D, devices, dense_rows, timed_slab, kernels=K1_K3):
    """K1, K2 and K3 (those of ``kernels``) with slab windows over one
    case's grids, each cut into D slabs on ``devices``: every slab's
    launch against its plain version (K1 1e-5, K2 32 ulps of its float64
    sum, K3 1e-4 of max |dp|); the slabs' K1 summed against dense K1 bit
    for bit, their K2 reassembled by unshard_grid_grad against the dense
    float64 sum within K2's gate (and, after fold_halo_grads, both copies
    of each shared plane equal), their K3 summed in device order on the
    points' device (as the sharded lookup's backward sums them) against
    dense K3 within 1e-4.  With ``timed_slab`` the launches of the slab
    owning the most points are timed and bounded by that slab's own
    bytes.  Returns (checks, rows)."""
    import torch

    from nice_slam_torch.ops import interp
    from nice_slam_torch.parallel import grid_sharding as gs

    eps, tiny = torch.finfo(torch.float32).eps, torch.finfo(torch.float32).tiny
    grids, p, cots = c["grids"], c["p"], c["gs"]
    n, C = p.shape[0], grids[0].shape[3]
    sharded = [gs.shard_grid(g, devices) for g in grids]
    feats = dps = None
    slab_grads = [[] for _ in grids]
    worst = {k: 0.0 for k in kernels}
    owned_by_slab = []
    for d, dev_d in enumerate(devices):
        slabs = [sg.slabs[d] for sg in sharded]
        ws = [sg.window(d) for sg in sharded]
        pd, cd = p.to(dev_d), [g.to(dev_d) for g in cots]
        shapes = [tuple(s.shape) for s in slabs]
        owned_by_slab.append(slab_bytes(slabs, ws, pd)[0][0])
        if "trilinear_fwd" in kernels:
            f = interp.trilinear_fwd_multi(slabs, pd, ws)
            err = max(float((a - b).abs().max())
                      for a, b in zip(f, interp.trilinear_fwd_multi_plain(slabs, pd, ws)))
            if not err <= 1e-5:
                raise AssertionError(f"K1 {label} D={D} slab {d}: {err} > 1e-5")
            worst["trilinear_fwd"] = max(worst["trilinear_fwd"], err)
            f = [x.to(p.device) for x in f]
            feats = f if feats is None else [a + b for a, b in zip(feats, f)]
        if "trilinear_bwd_dp" in kernels:
            dp = interp.trilinear_bwd_dp_multi(slabs, pd, cd, ws)
            ref = interp.trilinear_bwd_dp_multi_plain(slabs, pd, cd, ws)
            err = float((dp - ref).abs().max())
            if not err <= 1e-4 * float(ref.abs().max()):
                raise AssertionError(f"K3 {label} D={D} slab {d}: {err}")
            worst["trilinear_bwd_dp"] = max(worst["trilinear_bwd_dp"], err)
            dps = dp.to(p.device) if dps is None else dps + dp.to(p.device)
        if "trilinear_bwd_dgrid" not in kernels:
            continue
        dg = interp.trilinear_bwd_dgrid_multi(pd, cd, shapes, ws)
        for g, cot, s, w in zip(dg, cd, shapes, ws):
            ref, scale = slab_f64(pd, cot, s, w)
            err = float((g.double() - ref).abs().max())
            # float atomics flush subnormal results to zero (PTX
            # atom.add.f32), so a slab whose few owned points add only
            # subnormal values reads 0 there: the gate's floor is the
            # smallest normal float
            if not err <= max(32 * eps * float(scale.max()), tiny):
                raise AssertionError(f"K2 {label} D={D} slab {d} {s}: {err}")
            worst["trilinear_bwd_dgrid"] = max(worst["trilinear_bwd_dgrid"], err)
        for i, g in enumerate(dg):
            slab_grads[i].append(g)
    checks = {"case": label, "D": D, "devices": [str(x) for x in devices],
              "planes": [sg.planes for sg in sharded], "max_abs_err": worst,
              "owned_by_slab": owned_by_slab}
    if "trilinear_fwd" in kernels:
        dense_f = interp.trilinear_fwd_multi(grids, p)
        if not all(torch.equal(a, b) for a, b in zip(feats, dense_f)):
            raise AssertionError(f"K1 {label} D={D}: the slabs' sum differs from dense K1")
        checks["k1_sum_bitwise"] = True
    if "trilinear_bwd_dgrid" in kernels:
        k2_sum_err = 0.0
        for sg, grads, cot, g in zip(sharded, slab_grads, cots, grids):
            dense = gs.unshard_grid_grad(grads, tuple(g.shape), sg.planes)
            ref, scale = dgrid_f64(p, cot, tuple(g.shape))
            err = float((dense.to(p.device).double() - ref).abs().max())
            if not err <= 32 * eps * float(scale.max()):
                raise AssertionError(f"K2 {label} D={D}: unshard_grid_grad {err}")
            k2_sum_err = max(k2_sum_err, err)
            folded = gs.fold_halo_grads(grads)
            if not all(torch.equal(lo[-1].to(hi.device), hi[0])
                       for lo, hi in zip(folded[:-1], folded[1:])):
                raise AssertionError(f"K2 {label} D={D}: folded halo copies differ")
        checks["k2_unshard_err"] = k2_sum_err
    if "trilinear_bwd_dp" in kernels:
        dense_dp = interp.trilinear_bwd_dp_multi(grids, p, cots)
        k3_sum_err = float((dps - dense_dp).abs().max())
        if not k3_sum_err <= 1e-4 * float(dense_dp.abs().max()):
            raise AssertionError(f"K3 {label} D={D}: the slabs' sum is off by {k3_sum_err}")
        checks.update(k3_sum_err=k3_sum_err, k3_gate=1e-4 * float(dense_dp.abs().max()))
    rows = []
    if timed_slab:
        d = max(range(D), key=lambda i: owned_by_slab[i])
        slabs = [sg.slabs[d] for sg in sharded]
        ws = [sg.window(d) for sg in sharded]
        owned, touched = slab_bytes(slabs, ws, p)
        shapes = [tuple(s.shape) for s in slabs]
        lib = {r["kernel"]: r for r in dense_rows if r["case"] == label}
        base = dict(case=f"{label}_D{D}", window_of=label, D=D, slab=d, n=n,
                    grids=len(grids), owned=owned, touched_rows=touched)
        pts_b = n * 3 * 4
        row_b = sum(touched) * C * 4
        own_b = sum(owned) * C * 4
        specs = [
            ("trilinear_fwd", lambda: interp.trilinear_fwd_multi(slabs, p, ws),
             lambda: interp.trilinear_fwd_multi_plain(slabs, p, ws),
             pts_b + row_b + n * C * 4 * len(grids), sum(owned) * C * 21),
            ("trilinear_bwd_dgrid", lambda: interp.trilinear_bwd_dgrid_multi(p, cots, shapes, ws),
             lambda: interp.trilinear_bwd_dgrid_multi_plain(p, cots, shapes, ws),
             pts_b + own_b + 2 * row_b, sum(owned) * 8 * C * 2),
            ("trilinear_bwd_dp", lambda: interp.trilinear_bwd_dp_multi(slabs, p, cots, ws),
             lambda: interp.trilinear_bwd_dp_multi_plain(slabs, p, cots, ws),
             pts_b + row_b + own_b + pts_b, sum(owned) * 8 * C * 2)]
        for kernel, fn, plain, bytes_, flops in specs:
            if kernel not in kernels:
                continue
            geometry = ({"geometry": k1_launch_geometry(base["case"], n, slabs, p.device)}
                        if kernel == "trilinear_fwd" else {})
            rows.append(dict(base, kernel=kernel, max_abs_err=worst[kernel],
                             bytes=bytes_, flops=flops, **geometry, ms=cuda_time_ms(fn),
                             device_ms=device_time_ms(fn, kernel),
                             plain_ms=cuda_time_ms(plain, 5),
                             # grid_sample over the whole dense lookup: the
                             # yardstick of the D launches together
                             library_ms=lib[kernel]["library_ms"],
                             library_device_ms=lib[kernel]["library_device_ms"]))
    return checks, rows


def sharded_loop(dev, devices, strict, out_name):
    """The slice's 12-frame strict loop with the grids spatially sharded
    over ``devices`` (NICE_SLAM_TORCH_SPATIAL=1): every frame tracked with
    finite poses, exact launch counts at one launch per slab per stage
    call, the final meshes with faces, the halo planes bitwise equal at
    the end, the final checkpoint dense and restored by an unsharded
    system equal to the sharded state bit for bit."""
    import math

    import torch

    from nice_slam_torch.parallel import grid_sharding as gs
    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.tools.eval_ate import ate_rmse
    from nice_slam_torch.tools.workloads import replica_synthetic_cfg

    out = os.path.join(HERE, "output", "chip_smoke", out_name)
    shutil.rmtree(out, ignore_errors=True)
    cfg = replica_synthetic_cfg(out, n_frames=12, iters_first=SLICE_ITERS_FIRST)
    D = len(devices)
    os.environ["NICE_SLAM_TORCH_SPATIAL"] = "1"
    try:
        slam = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None), devices=devices)
    finally:
        del os.environ["NICE_SLAM_TORCH_SPATIAL"]
    if slam.spatial_devices != list(devices) or slam.mapper.devices is not None:
        raise AssertionError(f"sharding not engaged over {devices}")
    sharded0 = {k: v for k, v in slam.state.grids.items()}
    per_dev = gs.per_device_bytes(sharded0)
    dense_b = sum(math.prod(g.shape) * 4 for g in sharded0.values())
    for i in range(slam.n_img):
        slam.frame_reader[i]
    iters = {"mapping": 0, "coarse_mapping": 0}
    count_iterations(slam.mapper, iters, "mapping")
    count_iterations(slam.coarse_mapper, iters, "coarse_mapping")
    for d in set(devices):
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    reset_counts()
    calls = []
    with recorded_core(calls):
        slam.run()
    counts = all_counts()
    peak = {str(d): torch.cuda.max_memory_allocated(d) / 2 ** 30
            for d in sorted(set(devices), key=str)}
    if not torch.isfinite(slam.estimate_c2w_list).all() or \
            slam.timings["tracked_frames"] != slam.n_img - 1:
        raise AssertionError("sharded loop: a frame untracked or a pose not finite")
    t = slam.timings
    track_iters = t["tracked_frames"] * slam.tcfg.iters
    map_iters = iters["mapping"] + iters["coarse_mapping"]
    chunk = slam.rcfg.points_batch_size
    lattice = slam.mesher.resolution ** 3
    mesh_chunks = 0
    for name in ("final_mesh.ply", "final_mesh_eval_rec.ply"):
        verts, _ = mesh_stats(os.path.join(out, "mesh", name))
        mesh_chunks += math.ceil(lattice / chunk) + math.ceil(len(verts) / chunk)
    # K1-K3 once per slab; the decoder stage once per call, on the points'
    # device
    want = {"trilinear_fwd": D * (track_iters + map_iters + mesh_chunks),
            "trilinear_bwd_dp": D * track_iters, "trilinear_bwd_dgrid": D * map_iters,
            "decoder_fwd": track_iters + map_iters + mesh_chunks,
            "decoder_bwd": track_iters + map_iters,
            "decoder_wgrad_sum": sum(c[4] for c in calls),
            # the integrator on the points' device; a mapping step's K9 once
            # per card its slabs lie on, the tracker's on the pose's card
            **k7_k10_want(track_iters + map_iters, sum(c[5] for c in calls),
                          adam=track_iters + map_iters * len(set(devices)))}
    if counts != want:
        raise AssertionError(f"sharded loop launches {counts}, expected {want} "
                             f"(D = {D} per stage call)")
    for k, sg in slam.state.grids.items():
        if not isinstance(sg, gs.ShardedGrid) or sg.D != D:
            raise AssertionError(f"{k} lost its sharded representation")
        for lo, hi in zip(sg.slabs[:-1], sg.slabs[1:]):
            if not torch.equal(lo[-1].to(hi.device), hi[0]):
                raise AssertionError(f"{k}: halo planes diverged")
    # the dense checkpoint, restored by an unsharded system
    fresh = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None), dev)
    if fresh.spatial_devices is not None or fresh.resume() != slam.n_img:
        raise AssertionError("the unsharded system did not resume at the end")
    diff = [k for k, sg in slam.state.grids.items()
            if not torch.equal(gs.unshard_grid(sg).to(fresh.device), fresh.state.grids[k])]
    if not all(torch.equal(a.to(fresh.device), b) for a, b in
               zip(leaves(slam.state.decoders), leaves(fresh.state.decoders))):
        diff.append("decoders")
    if not torch.equal(fresh.estimate_c2w_list, slam.estimate_c2w_list.to(fresh.device)):
        diff.append("estimate_c2w_list")
    if diff:
        raise AssertionError(f"checkpoint of the sharded loop restored differently: {diff}")
    return {"devices": [str(x) for x in devices], "D": D, "frames": slam.n_img,
            "planes": {k: v.planes for k, v in slam.state.grids.items()},
            "per_device_bytes": per_dev, "dense_bytes": dense_b,
            "per_device_share": per_dev / dense_b,
            "fps": t.get("fps"), "tracking_ms_per_frame": t.get("tracking_ms_per_frame"),
            "mapping_ms_per_event": t.get("mapping_ms_per_event"),
            "coarse_mapping_ms_per_event": t.get("coarse_mapping_ms_per_event"),
            "mapping_ms_per_iter": 1e3 * t["mapping_s"] / iters["mapping"],
            "meshing_s": t["meshing_s"], "total_s": t.get("total_s"),
            "ate_cm": 100 * ate_rmse(slam.estimate_c2w_list.cpu().numpy(), slam.gt_c2w_list),
            "launches": counts, "mesher_k1_launches": D * mesh_chunks,
            "peak_mem_gib": peak,
            "strict": {k: strict[k] for k in ("fps", "tracking_ms_per_frame",
                                              "mapping_ms_per_event", "mapping_ms_per_iter",
                                              "meshing_s")},
            "resumed_bitwise": True, "halo_bitwise": True}


def data_parallel_checks(dev, cap):
    """One mapping call of the Replica room from the captured state with
    its rays split over DP_REPLICAS replicas, against the one-device call
    on the same host-drawn pixels (per-iteration losses within
    DP_LOSS_RTOL); one resolution-256 lattice chunk split over the
    replicas against the one-device chunk (LATTICE_DP_ATOL)."""
    import numpy as np
    import torch

    from nice_slam_torch.ops import interp
    from nice_slam_torch.ops.geometry import tensor_from_pose
    from nice_slam_torch.slam.mapper import optimize_map_core, stage_plan_for
    from nice_slam_torch.utils.mesher import Mesher, _eval_chunk

    slam = cap
    frames = [slam.frame_reader[i] for i in (0, 1)]
    colors = torch.tensor(np.stack([f[1] for f in frames]), device=dev)
    depths = torch.tensor(np.stack([f[2] for f in frames]), device=dev)
    c2w = torch.tensor(np.stack([f[3] for f in frames]), device=dev)
    F = 2
    n = slam.mcfg.pixels // F
    gen = torch.Generator().manual_seed(9)
    pix = torch.randint(0, slam.H * slam.W, (DP_ITERS, F, n), generator=gen).to(dev)
    plan = stage_plan_for(slam.mcfg, DP_ITERS)
    devices = [dev] * DP_REPLICAS
    out = {}
    for name, devs in (("dp", devices), ("one", None)):
        interp.reset_launch_counts()
        _, _, losses = optimize_map_core(
            slam.spec, slam.state, colors, depths, c2w, tensor_from_pose(c2w),
            torch.zeros(F, device=dev), torch.ones(F, dtype=torch.bool, device=dev), 1.0,
            slam.mcfg, slam.rcfg, plan, False, n, pix_idx=pix, devices=devs)
        out[name] = (losses.cpu().numpy(), dict(interp.launch_counts))
    rel = float(np.max(np.abs(out["dp"][0] - out["one"][0]) / np.abs(out["one"][0])))
    if not rel <= DP_LOSS_RTOL:
        raise AssertionError(f"ray-parallel mapping losses off by {rel} (rtol {DP_LOSS_RTOL})")
    if out["dp"][1]["trilinear_fwd"] != DP_REPLICAS * DP_ITERS:
        raise AssertionError(f"ray-parallel K1 launches {out['dp'][1]}")
    mesher = Mesher(slam.cfg, slam.cam, slam.spec, slam.rcfg)
    lattice, _ = mesher.get_grid_uniform(slam.cfg["meshing"]["resolution"])
    pts = torch.from_numpy(lattice[:mesher.points_batch_size]).to(dev)
    with torch.no_grad():
        one = _eval_chunk(slam.spec, slam.state, pts, "fine", None)
        split = _eval_chunk(slam.spec, slam.state, pts, "fine", devices)
    lat_err = float((one - split).abs().max())
    if not lat_err <= LATTICE_DP_ATOL:
        raise AssertionError(f"lattice data parallelism off by {lat_err}")
    return {"replicas": DP_REPLICAS, "iters": DP_ITERS, "rays_per_iter": F * n,
            "loss_max_rel_diff": rel, "loss_rtol": DP_LOSS_RTOL,
            "loss_rtol_from": "tests/test_torch_cuda.py::"
                              "test_imap_mapping_iterations_on_cuda_match_cpu",
            "dp_launches": out["dp"][1], "one_launches": out["one"][1],
            "lattice_points": int(pts.shape[0]), "lattice_max_abs_diff": lat_err,
            "lattice_atol": LATTICE_DP_ATOL}


def coarse_pin_checks(dev, cap):
    """A coarse call pinned to an explicit device against the unpinned call
    (losses within DP_LOSS_RTOL; the coarse grid's entries within the
    step budget), and the strict loop's no-host-sync rule: after the main
    mapper's call the spy queues a ~0.5 s spin and an event; the event is
    still pending when the coarse call is entered."""
    import numpy as np
    import torch

    from nice_slam_torch.slam.keyframes import KeyframeStore
    from nice_slam_torch.slam.mapper import Mapper
    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.tools.workloads import box_quality_cfg

    slam = cap
    _, c0, d0, p0 = slam.frame_reader[0]
    _, color, depth, c2w = slam.frame_reader[1]
    res = {}
    for name in ("default", "pinned"):
        m = Mapper(slam.spec, slam.coarse_mapper.mcfg, slam.rcfg, dev, seed=7)
        if name == "pinned":
            m.pin(torch.device("cuda", torch.cuda.device_count() - 1))
        store = KeyframeStore(4, slam.H, slam.W, dev)
        store.add(0, c0, d0, p0, p0)
        new_state, _, losses = m.optimize_map(
            slam.state, PIN_ITERS, 1.0, torch.tensor(color, device=dev),
            torch.tensor(depth, device=dev), store, torch.tensor(c2w, device=dev), False)
        res[name] = (losses.cpu().numpy(), new_state.grids["grid_coarse"].to(dev))
    rel = float(np.max(np.abs(res["pinned"][0] - res["default"][0])
                       / np.abs(res["default"][0])))
    lr = max(x[1] for x in slam.coarse_mapper.mcfg.stage_lr)
    grid_diff = float((res["pinned"][1] - res["default"][1]).abs().max())
    if not (rel <= DP_LOSS_RTOL and grid_diff <= 2 * PIN_ITERS * lr):
        raise AssertionError(f"pinned coarse call: losses off by {rel}, grid by {grid_diff}")

    out = os.path.join(HERE, "output", "chip_smoke", "coarse_pin")
    cfg = box_quality_cfg(out)
    big = 10 ** 6
    cfg.update(coarse=True, meshing=None)
    cfg["data"]["n_frames"] = 7
    cfg["tracking"].update(gt_camera=True, vis_freq=big, vis_inside_freq=big)
    cfg["mapping"].update(iters_first=30, iters=10, color_refine=False, ckpt_freq=big,
                          mesh_freq=big, vis_freq=big, vis_inside_freq=big)
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    box = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None), devices=[dev, last])
    if box.coarse_mapper.device != last:
        raise AssertionError("the coarse mapper was not pinned to the last device")
    events, pending = [], []
    main, coarse = box.mapper.optimize_map, box.coarse_mapper.optimize_map

    def spy_main(*a, **k):
        o = main(*a, **k)
        torch.cuda._sleep(1_000_000_000)
        ev = torch.cuda.Event()
        ev.record()
        events.append(ev)
        return o

    def spy_coarse(*a, **k):
        pending.append(not events[-1].query())
        return coarse(*a, **k)

    box.mapper.optimize_map = spy_main
    box.coarse_mapper.optimize_map = spy_coarse
    box.run()
    if pending != [True, True]:
        raise AssertionError(f"main mapper's event done at the coarse call: {pending}")
    return {"pinned_loss_max_rel_diff": rel, "pinned_grid_max_abs_diff": grid_diff,
            "pin_device": str(last), "coarse_entered_with_main_pending": pending}


def phase_sharded(dev, cases, dense_rows, cap, strict):
    """Multi-device NiceSLAM on this machine's cards: D logical devices on
    one card, and over distinct cards where there are two or more."""
    import torch

    t0 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    checks, rows = [], []
    for label in SHARD_CASES:
        for D in SHARD_DS:
            ck, rw = window_case(label, cases[label], D, [dev] * D, dense_rows, True)
            checks.append(ck)
            rows += rw
    with_bounds(rows)
    t_kernels = time.perf_counter() - t0
    loop = sharded_loop(dev, [dev] * SHARD_LOOP_D, strict, "sharded")
    if abs(loop["per_device_bytes"] - PER_DEVICE_BYTES_D4) > 0.01 * PER_DEVICE_BYTES_D4:
        raise AssertionError(f"per_device_bytes {loop['per_device_bytes']} at D = 4, "
                             f"not within 1 % of {PER_DEVICE_BYTES_D4}")
    t_loop = time.perf_counter() - t0 - t_kernels
    box, box_ok = box_family(dev, "sharded_box", seeds=SHARD_BOX_SEEDS,
                             devices=[dev] * SHARD_BOX_D)
    if not box_ok:
        raise strict_family_failure("sharded box family", box)
    dp = data_parallel_checks(dev, cap)
    pin = coarse_pin_checks(dev, cap)
    distinct = None
    if n_cards >= 2:  # the same kernels' cases and the loop over two cards
        cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
        distinct = {"window_cases": [window_case(label, cases[label], 2, cards,
                                                 dense_rows, False)[0]
                                     for label in SHARD_CASES],
                    "loop": sharded_loop(dev, cards, loop, "sharded_cards")}
    emit({"phase": "sharded", "ok": True, "device_count": n_cards,
          "devices_used": {"window_cases": [f"{dev} x {D}" for D in SHARD_DS],
                           "loop": f"{dev} x {SHARD_LOOP_D}", "box": f"{dev} x {SHARD_BOX_D}",
                           "ray_dp": f"{dev} x {DP_REPLICAS}",
                           "coarse_pin": pin["pin_device"]},
          "distinct_cards": distinct is not None,
          "window_checks": checks, "rows": rows, "loop": loop, "box": box,
          "data_parallel": dp, "coarse_pin": pin, "over_distinct_cards": distinct,
          "kernels_s": t_kernels, "loop_s": t_loop,
          "seconds": time.perf_counter() - t0})
    return rows, loop["launches"], loop


TS_SHARDED_D = 4   # threaded_sharded (a): loose with the grids over [cuda:0] x 4
TS_DP_D = 2        # (b): free with ray DP over [cuda:0] x 2, the coarse mapper pinned
TS_BOX_D = 2       # the loose box family with the grids over [cuda:0] x 2


@contextlib.contextmanager
def knobs(spatial: bool):
    """The multi-device knobs for a system built inside: the grids sharded
    (``spatial``) or ray DP with the coarse mapper pinned to the last
    device; the environment is restored on exit."""
    env = {"NICE_SLAM_TORCH_SPATIAL": "1" if spatial else "0",
           "NICE_SLAM_TORCH_COARSE_DEVICE": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def chunk_sizes(n: int, chunk: int):
    return [min(chunk, n - i) for i in range(0, n, chunk)]


def expected_launches(slam, devices, sharded, tracks, calls, meshes):
    """The K1-K10 launches a run's recorded calls make, per (kernel, device
    index, thread): ``tracks`` (thread, lag) per tracked frame, ``calls``
    (thread, coarse, iterations, rays, K6 launches, K10 launches, BA) per
    mapping call, ``meshes`` (thread, path) per mesh written.  Returns them
    and each mesh's faces."""
    import collections

    D = len(devices)
    k1, k2, k3 = "trilinear_fwd", "trilinear_bwd_dgrid", "trilinear_bwd_dp"
    k4, k5, k6 = "decoder_fwd", "decoder_bwd", "decoder_wgrad_sum"
    k7, k8, k9 = "integrate_fwd", "integrate_bwd", "group_adam"
    k10 = ("frustum_mask",)
    cards = list({d.index: d for d in devices}.values())
    want = collections.Counter()

    def add(kernels, th, devs, times):
        for d in devs:
            for k in kernels:
                want[(k, d.index, th)] += times

    # K1-K3 run once per slab (sharded) or replica (K3 in a mapping
    # iteration only under BA, where the points need a gradient); the decoder stage and
    # the integrator once per replica, on the points' device when the grids
    # are sharded; K9 once per step on each card the trained leaves lie on
    # (the slabs' cards; the first, where a replicated scene trains; the
    # last for the pinned coarse mapper); K10 once per main-mapper call
    first = [devices[0]]
    for th, _ in tracks:
        add((k1, k3), th, devices if sharded else first, slam.tcfg.iters)
        add((k4, k5, k7, k8, k9), th, first, slam.tcfg.iters)
    for th, coarse, iters, rays, k6_calls, frustum, ba in calls:
        if sharded or (not coarse and rays % D == 0):
            devs = devices
        else:
            devs = [devices[-1]] if coarse else first
        add((k1, k2, k3) if ba else (k1, k2), th, devs, iters)
        add((k4, k5, k7, k8), th, first if sharded else devs, iters)
        add((k6,), th, first if sharded else devs, k6_calls)
        add((k9,), th, cards if sharded else [devices[-1]] if coarse else first, iters)
        add(k10, th, first, frustum)
    lattice = slam.mesher.resolution ** 3
    chunk = min(slam.rcfg.points_batch_size, lattice)
    faces = {}
    for th, path in meshes:
        verts, f = mesh_stats(path)
        faces[os.path.basename(path)] = len(f)
        for size in chunk_sizes(lattice, chunk) + chunk_sizes(len(verts), chunk):
            devs = devices if sharded or size % D == 0 else first
            add((k1,), th, devs, 1)
            add((k4,), th, first if sharded else devs, 1)
    if "final_mesh.ply" not in faces:
        raise AssertionError("no final mesh")
    return want, faces


def check_launches(slam, devices, sharded, tracks, calls, meshes, tag):
    """The launches per (kernel, device, stream) against
    ``expected_launches``: a thread's launches on its own stream of each
    card, the calling thread's on the card's default stream, and nothing
    else.  Returns each mesh's faces."""
    import torch

    want, faces = expected_launches(slam, devices, sharded, tracks, calls, meshes)

    def sid(th, idx):
        c = torch.device("cuda", idx)
        if th == "MainThread":
            return torch.cuda.default_stream(c).cuda_stream
        return slam.streams[th][c].cuda_stream

    by = all_by_device()
    want_by = {(k, idx, sid(th, idx)): v for (k, idx, th), v in want.items() if v}
    if by != want_by:
        diff = {key: (by.get(key, 0), want_by.get(key, 0))
                for key in set(by) | set(want_by) if by.get(key, 0) != want_by.get(key, 0)}
        raise AssertionError(f"{tag}: launches per (kernel, device, stream) "
                             f"(got, expected): {diff}")
    return faces


def check_streams(slam, cards, tag):
    """Each thread of a threaded run has a stream of its own on every card."""
    import torch

    expected = {"tracker", "mapper", "coarse_mapper"}
    if set(slam.streams) != expected:
        raise AssertionError(f"{tag}: thread streams {sorted(slam.streams)}")
    for c in cards:
        sids = {torch.cuda.default_stream(c).cuda_stream}
        for name in expected:
            if set(slam.streams[name]) != set(cards):
                raise AssertionError(f"{tag}: {name} streams on "
                                     f"{sorted(map(str, slam.streams[name]))}")
            sids.add(slam.streams[name][c].cuda_stream)
        if len(sids) != 4:
            raise AssertionError(f"{tag}: the threads share a stream on {c}")


def devices_run(devices, sync, mode, out_name):
    """The slice's 12 frames under ``sync`` over ``devices``, with the grids
    sharded (``mode`` 'sharded': K1-K3 once per slab, K4-K6 once per call
    on the first device) or with ray data
    parallelism and the coarse mapper pinned to the last device ('ray_dp':
    a main mapping iteration on every device when its rays divide evenly,
    a mesher chunk likewise, a coarse iteration on the pinned device, a
    tracking iteration on the first).  Every frame tracked with finite
    poses and the last one mapped; K1-K10 launched exactly as the run's own
    calls, recorded per thread, give per (kernel, device, stream): a
    thread's launches on its stream of that card, the warm-up's (and the
    strict loop's) on the card's default stream; each thread with a
    stream of its own on every card; the loose lag at most every + every
    // 2; the halo planes bitwise equal (sharded); the dense final
    checkpoint restored by a fresh one-device system bit for bit; the
    final meshes with faces.  Returns the record, with each card's peak
    memory."""
    import collections
    import threading

    import torch

    from nice_slam_torch.parallel import grid_sharding as gs
    from nice_slam_torch.slam.slam import NiceSLAM
    from nice_slam_torch.tools.eval_ate import ate_rmse
    from nice_slam_torch.tools.workloads import replica_synthetic_cfg

    sharded = mode == "sharded"
    tag = f"{sync} {mode} over {[str(d) for d in devices]}"
    out = os.path.join(HERE, "output", "chip_smoke", out_name)
    shutil.rmtree(out, ignore_errors=True)
    cfg = replica_synthetic_cfg(out, n_frames=12, iters_first=SLICE_ITERS_FIRST)
    cfg["sync_method"] = sync
    with knobs(sharded):
        slam = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None), devices=devices)
    D = len(devices)
    if sharded:
        engaged = slam.spatial_devices == list(devices) and slam.mapper.devices is None
    else:
        engaged = (slam.spatial_devices is None and slam.mapper.devices == list(devices)
                   and slam.coarse_mapper.device == devices[-1])
    if not engaged:
        raise AssertionError(f"{tag}: the mode did not engage")
    for i in range(slam.n_img):  # frame synthesis is not part of the timing
        slam.frame_reader[i]

    def thread() -> str:
        return threading.current_thread().name

    tracks, calls, meshes = [], [], []
    inner_track, inner_mesh = slam.track_one, slam._mesh

    def tracked(idx, *a, **k):
        tracks.append((thread(), idx - slam.mapping_idx))
        return inner_track(idx, *a, **k)

    def meshed(path, *a, **k):
        meshes.append((thread(), path))
        return inner_mesh(path, *a, **k)

    slam.track_one, slam._mesh = tracked, meshed
    cards = sorted(set(devices), key=str)
    for c in cards:
        torch.cuda.synchronize(c)
        torch.cuda.reset_peak_memory_stats(c)
    reset_counts()
    with recorded_core(calls):
        slam.run()
    counts = all_counts()
    peak = {str(c): torch.cuda.max_memory_allocated(c) / 2 ** 30 for c in cards}

    n, t = slam.n_img, slam.timings
    if not torch.isfinite(slam.estimate_c2w_list).all():
        raise AssertionError(f"{tag}: non-finite poses")
    if t["tracked_frames"] != n - 1 or slam.mapping_idx != n - 1:
        raise AssertionError(f"{tag}: tracked {t['tracked_frames']} frames, mapping_idx "
                             f"{slam.mapping_idx}; expected {n - 1} each")

    mesh_faces = check_launches(slam, devices, sharded, tracks, calls, meshes, tag)
    if sync != "strict":
        check_streams(slam, cards, tag)
    every = slam.mcfg.every_frame
    worst = max(lag for _, lag in tracks)
    if sync == "loose" and worst > every + every // 2:
        raise AssertionError(f"{tag}: lag {worst} frames > {every + every // 2}")
    if sharded:
        for k, sg in slam.state.grids.items():
            if not isinstance(sg, gs.ShardedGrid) or sg.D != D:
                raise AssertionError(f"{tag}: {k} lost its sharded representation")
            for lo, hi in zip(sg.slabs[:-1], sg.slabs[1:]):
                if not torch.equal(lo[-1].to(hi.device), hi[0]):
                    raise AssertionError(f"{tag}: {k}: halo planes diverged")

    # the dense checkpoint, restored by a fresh one-device system
    with knobs(False):
        fresh = NiceSLAM(cfg, argparse.Namespace(nice=True, output=None), devices[0])
    if fresh.spatial_devices is not None or fresh.resume() != n:
        raise AssertionError(f"{tag}: the fresh system did not resume at the end")
    diff = [k for k, g in slam.state.grids.items()
            if not torch.equal((gs.unshard_grid(g) if sharded else g).to(fresh.device),
                               fresh.state.grids[k])]
    if not all(torch.equal(a.to(fresh.device), b) for a, b in
               zip(leaves(slam.state.decoders), leaves(fresh.state.decoders))):
        diff.append("decoders")
    if not torch.equal(fresh.estimate_c2w_list, slam.estimate_c2w_list.to(fresh.device)):
        diff.append("estimate_c2w_list")
    if diff:
        raise AssertionError(f"{tag}: the checkpoint restored differently: {diff}")
    iters = collections.Counter()
    for th, coarse, it, *_ in calls:
        iters[f"{'coarse_' if coarse else ''}mapping@{th}"] += it
    for th, _ in tracks:
        iters[f"tracking@{th}"] += slam.tcfg.iters
    est = slam.estimate_c2w_list.cpu().numpy()
    return {"sync": sync, "mode": mode, "devices": [str(d) for d in devices],
            "fps": t.get("fps"), "total_s": t["total_s"], "meshing_s": t["meshing_s"],
            "fps_without_meshing": t["frames"] / (t["total_s"] - t["meshing_s"]),
            "tracking_ms_per_frame": t.get("tracking_ms_per_frame"),
            "mapping_ms_per_event": t.get("mapping_ms_per_event"),
            "coarse_mapping_ms_per_event": t.get("coarse_mapping_ms_per_event"),
            "tracked_frames": t["tracked_frames"], "mapping_events": t["mapping_events"],
            "coarse_mapping_events": t["coarse_mapping_events"],
            "max_lag": worst, "peak_mem_gib": peak,
            "ate_cm": 100 * ate_rmse(est, slam.gt_c2w_list),
            "iters": dict(iters), "launches": counts,
            "launches_by_device_stream": {f"{k}@cuda:{i}/{s}": v for (k, i, s), v
                                          in sorted(all_by_device().items())},
            "streams": {name: {str(c): s.cuda_stream for c, s in st.items()}
                        for name, st in slam.streams.items()},
            "meshes": mesh_faces, "resumed_bitwise": True, "halo_bitwise": sharded}


SCHEDULE_KEYS = ("fps", "tracking_ms_per_frame", "mapping_ms_per_event",
                 "coarse_mapping_ms_per_event", "mapping_events", "coarse_mapping_events",
                 "peak_mem_gib")


def phase_threaded_sharded(dev, sharded_loop_rec, strict_median_cm):
    """The loose and free schedules over several devices: (a) loose with
    the grids sharded over [cuda:0] x TS_SHARDED_D, beside the sharded
    phase's strict loop on the same list; (b) free with ray DP over
    [cuda:0] x TS_DP_D and the coarse mapper pinned to the last device,
    beside a strict run on the same list (``devices_run`` checks each);
    the loose box family with the grids over TS_BOX_D slabs, held to
    threaded_quality's gates.  Where the machine shows two or more cards,
    (a) again over cuda:0 and cuda:1 and (b) over every card, each beside
    strict over the same list; with one card a line says so.  Each run is
    the slice's 12 frames."""
    import torch

    t0 = time.perf_counter()
    a = devices_run([dev] * TS_SHARDED_D, "loose", "sharded", "ts_loose_sharded")
    b = devices_run([dev] * TS_DP_D, "free", "ray_dp", "ts_free_dp")
    b_strict = devices_run([dev] * TS_DP_D, "strict", "ray_dp", "ts_strict_dp")
    t_runs = time.perf_counter() - t0
    box, box_ok = loose_box_family(dev, strict_median_cm, "ts_box",
                                   devices=[dev] * TS_BOX_D)
    n_cards = torch.cuda.device_count()
    distinct = None
    if n_cards >= 2:
        cards = [torch.device("cuda", i) for i in range(n_cards)]
        distinct = {
            "loose_sharded": devices_run(cards[:2], "loose", "sharded", "ts_loose_cards"),
            "strict_sharded": devices_run(cards[:2], "strict", "sharded", "ts_strict_cards"),
            "free_dp": devices_run(cards, "free", "ray_dp", "ts_free_cards"),
            "strict_dp": devices_run(cards, "strict", "ray_dp", "ts_strict_dp_cards")}
    else:
        print(f"threaded_sharded: the distinct-card runs did not run: "
              f"torch.cuda.device_count() is {n_cards}, they need two cards", flush=True)
    emit({"phase": "threaded_sharded", "ok": box_ok, "device_count": n_cards,
          "loose_sharded": a,
          "strict_sharded": {k: sharded_loop_rec.get(k) for k in SCHEDULE_KEYS},
          "free_dp": b, "strict_dp": {k: b_strict[k] for k in SCHEDULE_KEYS},
          "box": {**box, "devices": f"{dev} x {TS_BOX_D}", "sharded": True},
          "distinct_cards": distinct is not None, "over_distinct_cards": distinct,
          "runs_s": t_runs, "seconds": time.perf_counter() - t0})
    if not box_ok:
        raise box_family_failure(box)
    return {k: a["launches"][k] + b["launches"][k] for k in a["launches"]}


# kernel -> (TPU-side code it replaces: the Pallas kernel first where there
# is one, then the JAX device code; the case its line reports: each kernel
# at a captured main-path launch; its source)
TRILINEAR_CU = "nice_slam_torch/csrc/trilinear.cu"
DECODER_CU = "nice_slam_torch/csrc/decoder_stage.cu"
DECODERS_PY = "nice_slam_tpu/models/decoders.py"
INTEGRATOR_CU = "nice_slam_torch/csrc/integrator.cu"
ADAM_CU = "nice_slam_torch/csrc/adam.cu"
FRUSTUM_CU = "nice_slam_torch/csrc/frustum.cu"
FRUSTUM_JAX = ("nice_slam_tpu/slam/mapper.py:328 frustum_mask, "
               "nice_slam_tpu/ops/interp.py:335 bilinear_sample_2d")
KERNEL_META = {
    "trilinear_fwd": ("nice_slam_tpu/ops/interp.py:141, "
                      "nice_slam_tpu/parallel/grid_sharding.py:108", "map_color", TRILINEAR_CU),
    "trilinear_bwd_dgrid": ("scripts/exp_scatter.py:177, nice_slam_tpu/ops/interp.py:186, "
                            "nice_slam_tpu/parallel/grid_sharding.py:108", "map_color",
                            TRILINEAR_CU),
    "trilinear_bwd_dp": ("nice_slam_tpu/ops/interp.py:321, "
                         "nice_slam_tpu/parallel/grid_sharding.py:108", "track", TRILINEAR_CU),
    "decoder_fwd": (f"{DECODERS_PY}:371 apply_nice_stage_batched, :250 apply_mlp, "
                    ":298 apply_mlp_no_xyz", "map_color", DECODER_CU),
    "decoder_bwd": (f"{DECODERS_PY}:371 apply_nice_stage_batched, :250 apply_mlp, "
                    ":298 apply_mlp_no_xyz (their autodiff)", "map_color", DECODER_CU),
    "decoder_wgrad_sum": (f"{DECODERS_PY}:371 apply_nice_stage_batched (the weight "
                          "gradient's sum over points in its autodiff)", "map_color",
                          DECODER_CU),
    "integrate_fwd": ("nice_slam_tpu/ops/geometry.py:259 raw2outputs_nerf_color",
                      "map_color", INTEGRATOR_CU),
    "integrate_bwd": ("nice_slam_tpu/ops/geometry.py:259 raw2outputs_nerf_color (its "
                      "autodiff)", "map_color", INTEGRATOR_CU),
    "group_adam": ("nice_slam_tpu/slam/optim.py:49 group_adam_update, "
                   "nice_slam_tpu/slam/mapper.py:648-650 (the frustum mask multiply)",
                   "map_color", ADAM_CU),
    "frustum_mask": (FRUSTUM_JAX, "room", FRUSTUM_CU),
}
# K1 on the mesher's and renderer's paths; K1 and K2 on the pretrainer's
NEW_PATH_CASES = ("mesh_fine", "render_color", "pretrain_coarse", "pretrain_fine")


# the child processes' runs (``--draw KIND``, ``draws_at_once``)
DRAWS = {"box": box_draw, "imap_box": imap_box_draw, "tour": tour_run}


def device_line(torch) -> dict:
    return {"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tracked_tour", action="store_true",
                        help="build, then run only the tracked tour (QUALITY.json's "
                             "tracked_tour gates), which the smoke leaves out for time")
    parser.add_argument("--ba_families", action="store_true",
                        help="build, then run only the BA box families (the box with BA "
                             "over 2 slabs, iMAP*'s box with BA), which the smoke leaves "
                             "out for time")
    parser.add_argument("--draw", choices=sorted(DRAWS), default=None,
                        help="one draw of a box family or a tour, its record as the last "
                             "line (the processes draws_at_once starts; --draw_args its "
                             "keyword arguments as JSON)")
    parser.add_argument("--draw_args", default="{}", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    dev = torch.device("cuda", 0)  # one card; the sharded phase adds logical devices
    if args.draw is not None:
        emit(DRAWS[args.draw](dev, **json.loads(args.draw_args)))
        return 0
    card = smi()
    t0 = time.perf_counter()
    if args.tracked_tour or args.ba_families:
        try:
            phase_build()
            if args.tracked_tour:
                phase_tracked_tour(dev)
            if args.ba_families:
                phase_ba_families(dev)
        except Exception:  # a failure fails the command, with its traceback
            traceback.print_exc()
            return 1
        emit({"phase": "total", "seconds": time.perf_counter() - t0})
        print(card, flush=True)
        emit(device_line(torch))
        return 0
    try:
        phase_build()
        cases, lookups, cap = phase_capture(dev)
        cases["ba"] = ba_capture(dev)
        first_ba_call = cases["ba"].pop("first_call")
        imap_ba_room, imap_k8 = phase_imap_ba_room(dev)
        imap_ba_counts = imap_ba_room["launches"]
        rows, _, ba_window_rows = phase_kernels(dev, cases, lookups, imap_k8)
        del imap_k8
        counts, done, cfg, strict = phase_slice(dev)
        phase_resume(dev, done, cfg)
        phase_vis(dev, done)
        del done
        phase_profile(dev)
        strict_median = phase_quality(dev)
        ba_counts, ba_room_rec = phase_ba(dev, strict, strict_median)
        ba_sharded_counts = phase_ba_sharded(dev, ba_room_rec, first_ba_call)
        del first_ba_call
        phase_threaded(dev, strict)
        phase_threaded_quality(dev, strict_median)
        done, cfg, imap_slice = phase_imap_slice(dev, card)
        phase_imap_resume(dev, done, cfg)
        del done
        phase_imap_quality(dev)
        phase_imap_ba(imap_ba_room, imap_slice)
        phase_readers(dev)
        window_rows, sharded_counts, sharded_loop_rec = phase_sharded(
            dev, cases, rows, cap, strict)
        del cap
        window_rows += ba_window_rows
        ts_counts = phase_threaded_sharded(dev, sharded_loop_rec, strict_median)
        phase_tours(dev)
        pretrain_rows, pretrain_counts = phase_pretrain(dev)
        rows += pretrain_rows
        phase_counts = {"slice": counts, "ba": ba_counts, "ba_sharded": ba_sharded_counts,
                        "imap_ba": imap_ba_counts, "pretrain": pretrain_counts,
                        "sharded": sharded_counts, "threaded_sharded": ts_counts,
                        "envelope": phase_envelope(dev),
                        "landscape": phase_landscape(dev)}
        phase_viewer(dev)
    except Exception:  # any phase failure fails the run, with its traceback
        traceback.print_exc()
        return 1
    kernels = []
    for name, (replaces, case, source) in KERNEL_META.items():
        r = next(r for r in rows if r["kernel"] == name and r["case"] == case)
        other = {x["case"]: {k: x[k] for k in ("n", "grids", "decoders", "ms", "device_ms",
                                               "plain_ms", "bound_ms", "bound_by",
                                               "library_ms", "max_abs_err", "geometry")
                             if k in x}
                 for x in rows if x["kernel"] == name and x["case"] in NEW_PATH_CASES}
        windows = {x["case"]: {k: x[k] for k in ("n", "D", "slab", "owned", "grids", "ms",
                                                 "device_ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms", "max_abs_err",
                                                 "geometry") if k in x}
                   for x in window_rows if x["kernel"] == name}
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "case": case, "launches": counts[name],
            "max_abs_err": max(x["max_abs_err"] for x in rows + window_rows
                               if x["kernel"] == name),
            "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **({"geometry": r["geometry"]} if "geometry" in r else {}),
            **({"new_paths": other} if other else {}),
            **({"window_cases": windows} if windows else {}),
            **({"main_path_cases": {x["case"]: {k: x[k] for k in (
                "n", "samples", "leaves", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_device_ms", "max_abs_err", "rel_err",
                "rel_err_f64", "plain_rel_err_f64", "eps_of_terms", "values_differing",
                "nodes_differing", "kink_points", "rows", "geometry") if k in x}
                for x in rows if x["kernel"] == name
                and x["case"] in DEC_CASES + K78_CASES + tuple(K78_IMAP_CASES) + ("room",)}}
               if name.startswith("decoder") or name in K7_K10 else {}),
            **({"ba_cases": {x["case"]: {k: x[k] for k in (
                "n", "grids", "decoders", "samples", "leaves", "camera_lr", "rays_d_grad",
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_device_ms", "max_abs_err", "eps_of_terms", "kink_points",
                "geometry") if k in x}
                for x in rows if x["kernel"] == name and x["case"].endswith("_ba")}}
               if any(x["kernel"] == name and x["case"].endswith("_ba") for x in rows)
               else {}),
            "launches_by_phase": {k: v[name] for k, v in phase_counts.items()}})
    emit({"phase": "total", "seconds": time.perf_counter() - t0})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit(device_line(torch))
    return 0


if __name__ == "__main__":
    sys.exit(main())
