#!/usr/bin/env python3
"""Smoke test of hotrack_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Drives the port's four main paths on `cuda`, two of them with several
sequences through one loop, the shipped HO3D and DexYCB configs on trees in
those datasets' layouts (with online shape refinement), online serving, and
the library modules no entry calls. Two run HandTrackNet at the
shipped width (512 points, 384-d features, pointnet2_camera_shallow1.yml)
with seeded random weights: sequence tracking through the `python -m
hotrack_tpu_torch.test` entry (the 100-frame synthetic SimGrasp sequence of
bench.py's hand_tracking stage, batch 1), and training through the `python
-m hotrack_tpu_torch.train` entry (one epoch of
handtracknet_train_SimGrasp.yml on a generated set, batch 32). The third is
object tracking through the same test entry (objopt_test_SimGrasp_synth.yml,
`track: obj_opt`) at its full operating point: a 201^3 volume at 2 mm
distilled with the full budget (4000 Adam steps of batch 8192) into the
21-128-128-128-1 MLP, 2048 particles x 10 iterations a frame on 1024 points,
100 frames. The fourth is the full hand pipeline through the same test entry
(handopt_test_SimGrasp_synth.yml, `track: hand_IKNet`, at HandTrackNet's 512
points): HandTrackNet -> MANO shape optimiser on frame 0 (20 iterations x
5120 particles) -> IKNet -> per-frame MANO pose optimiser (5 iterations x
5120 particles x 778 vertices) against a 151^3 volume at 3 mm distilled with
the full budget, and the silhouette. The batched paths: the same test entry
with `--eval_batch_seqs 4` on four 20-frame sequences (a fit a sequence),
and `track_obj_sequences_batched` at 4 x 2048 x 1024 x 10 on four 10-frame
sequences. Phases, each of which raises on failure:

  1. device: require CUDA, print the card's name and power limit, pin fp32
     (no TF32 in matmuls or convolutions);
  2. build: compile every kernel source of csrc/, one nvcc each, started
     together, and print the compiler's resource reports;
  3. kernels: each kernel against its plain PyTorch version on the card at
     every shape the paths below give it (FPS index-exact, with a bound of its
     steps' latency that is independent of the design, at both of its layout
     boundaries and above the shared copy's limit, where the cloud stays in
     device memory; the row gather bitwise;
     its scatter-add adjoint against a float64 oracle, bitwise the plain version
     in float32 on the CPU and bitwise equal on a second launch; the SDF MLP
     (3xTF32 through wgmma) within TC_SDF_ATOL a value of its plain version
     and of the 3xTF32 emulation, with its compiler report, its share of the
     3xTF32 bound and its TFLOP/s beside the matmul chain's time; the fused
     object energy within stated float32 bounds; both bitwise equal on a
     second launch; the mask
     lookup exact; the fused hand energy (the SDF MLP's wgmma core) with an
     exact hit and its sdf within TC_SDF_ATOL of its plain version and of the
     emulation, sdf bitwise the SDF MLP kernel on the object-frame points and
     hit bitwise the mask lookup at the pixels, timed beside the SDF MLP
     kernel at the same points, its compiler report free of spills and
     serialised wgmmas; the fused skinning + energy within stated bounds, its
     flipped pixels counted; each of the three bitwise equal on a second
     launch), timed in turns with the plain version and, where one PyTorch
     call computes the same function, that call; the four batched kernels
     with a model, mask, shape and object pose a sequence that differ, each
     sequence within the unbatched kernel's bounds of the batched plain
     version and bitwise an unbatched launch on its own inputs, a second
     batched launch bitwise the first; then the host microseconds a call of
     index_points at the tracking path's shapes, on the kernel and as one
     torch.gather, in turns;
  4. tracking path: launch counters reset, one tracked sequence on the card
     after a warm-up one, counters read; the same entry on the CPU (plain
     versions) must pick the same frame-0 FPS indices and keypoints within
     PRED_KP_BOUND_M of the card's;
  5. train path: counters reset, one epoch of `train_main` on the card,
     counters read; finite losses; then one forward + backward of the same
     weights on the same prepared batch: on the card with the
     kernels, on the card with their plain versions (same loss bitwise,
     every gradient within STEP_GRAD_BOUND; a second step with the kernels
     bitwise the same), and on the CPU (in float64 with the plain versions
     on both devices: the same picks, loss and gradients); then the
     checkpoint that training wrote is tracked by the test entry on the card;
  6. object path: counters reset, the 100-frame sequence tracked on the card
     through `test_main` (fused energy kernel: 10 launches a frame), counters
     read; finite metrics, a pose error below the jittered initialisation's,
     the fit's near-surface RMSE; then, with the same distilled weights,
     a shorter sequence on the composed route (the SDF MLP kernel) and on the
     volume route, and a few frames on the CPU (plain versions); composed
     route and CPU are held against the card's fused route closed loop (to
     the tracker's accuracy) and open loop (every frame again from the same
     pose: energies to float32 rounding, poses within a step of the search);
  7. hand optimiser: `optimize_hand_pose` at its full operating point (5120
     particles x 778 vertices x 5 iterations, a seeded 480 x 640 mask) from a
     perturbed ground-truth pose: the keypoint error falls; the routes skin,
     fused, separate and volume agree on the energies of iteration 0 within
     stated bounds and launch what they imply; with 512 particles the card is
     held against the CPU (plain versions) open loop;
  8. hand path: counters reset, a sequence tracked on the card through
     `test_main` (skin route: 5 launches of the fused skinning kernel a
     frame), counters read; finite metrics and betas; then
     `track_hand_sequence` on the same nets with seeded 480 x 640 masks;
     shorter runs on the fused, separate and volume routes and in shape modes
     2 and 3, with the same fit;
  9. batched hand path: counters reset, four sequences through `test_main
     --eval_batch_seqs 4` (5 launches of the batched skinning kernel a frame,
     none of the unbatched one), counters read; the unbatched runner on the
     same sequences and fits (the same inputs; frame 0 of every sequence
     within HAND_KP_BOUND_M); `track_hand_sequences_batched` with seeded
     480 x 640 masks a sequence on the skin, fused, separate and volume
     routes;
 10. batched object path: the unbatched runner on four sequences with a fit
     each, then `track_obj_sequences_batched` on the fused (#4b) and
     composed (#3b) routes, held against it closed loop (the tracker's
     accuracy) and open loop (every frame again from the batched run's pose:
     the batched optimiser bitwise, the unbatched one to float32 rounding);
 11. real-data layouts: HO3D and DexYCB trees written by data/real_trees.py
     (480 x 640 depth z-buffered from the synthetic generator's hand and an
     object, HO3D's two-channel depth PNGs and 240 x 320 seg PNGs, meta
     pickles, calibration, splits; the shipped 8 x 512 DeepSDF decoder,
     seeded, shaped into that object and saved in the reference layout, with
     its gt and reconstruction meshes at REAL_MESH_RES^3; the HO3D tree is
     written before phase 3, which holds FPS at the reconstruction's vertex
     count); the native library bitwise its numpy version on the decode and
     within NATIVE_RTOL on the back-projection, on this machine's host;
     objopt_test_HO3D through `test_main` (2048 x 1024 x 10 on the fused
     kernel: launches, a translation error below the jittered
     initialisation's and a rotation error within REAL_ROT_BOUND_DEG on every
     frame, two frames against the CPU open loop; both chamfer distances,
     FPS's global-memory kernel at the mesh's shape) writes the pose pickles
     that handopt_test_HO3D reads (5 launches of #7 a frame against the seg
     masks; the poses read back bitwise); handtracknet_test_HO3D under
     `--profile` (the trace must name the FPS and gather kernels),
     handiknet_test_HO3D and handtracknet_test_DexYCB;
 12. online shape update: objopt_test_HO3D with `--opt/updateobjshape True`,
     SHAPE_FRAMES frames (one latent update and one re-bake of the volume):
     the latent moved, the refined mesh written and read back, every frame's
     translation error below the jittered initialisation's; ms/frame and the
     seconds of the update, the re-bake and the mesh export;
 13. serving: `HandTracker` (IKNet, the frame-0 shape optimiser, the pose
     optimiser on the skin route, seeded 480 x 640 masks) and `ObjTracker`
     (fused route) stepped frame by frame bitwise the offline trackers,
     `serve` at depths 1 and 2 and `serve_combined` bitwise the steps, with
     the ms/frame of each;
 14. library code no entry calls: PointNet2Encoder and a point-transformer
     down / up stack, eval mode, on the card (FPS and gather launches
     required) against the CPU within LIBRARY_ATOL;
 15. the shapes the kernels' wrappers were given on those paths, noted while
     they ran, must be exactly the shapes phase 3 checked;
 16. neither JAX nor the JAX package (hotrack_tpu) may have been imported.

The line before the last is a JSON object describing the kernels; the last
is {"ok": true, "device": {...}}. Exits non-zero, with no result line, when
CUDA is missing or any phase fails.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CONFIG = "handtracknet_test_SimGrasp.yml"
NUM_FRAMES = 100        # bench.py hand_tracking: 2 instances x 100 frames,
POINTS_PER_PART = 900   # 900 points per part; the last instance is the test set
# The delta head's output layer of the random net is scaled by this, so its
# per-frame corrections are millimetres, as a trained tracker's are. At the
# raw init they move the keypoints by decimetres per frame, and the closed
# tracking loop amplifies float32 rounding frame after frame, so that no
# card-vs-CPU bound over 100 frames would mean anything (PERF.md, Findings).
HEAD_SCALE = 0.01
# card vs CPU keypoints, any frame: the two runs differ only by float32
# summation order (cuBLAS vs the CPU's matmuls) and pick the same FPS
# indices; 1e-4 m is 1/100 of the 1 cm keypoint jitter
PRED_KP_BOUND_M = 1e-4

TRAIN_CONFIG = "handtracknet_train_SimGrasp.yml"
TRAIN_FRAMES = 70       # 2 training instances x 70 frames = 4 batches of 32 and a
BATCH = 32              # tail of 12; the third instance is the test split
# One train step, dropout off, compared three ways (phase 5).
# Kernels against their plain versions on the card: the forward is bitwise
# the same, the gradients differ by the order of float32 sums in the row
# gather's adjoint; the bound is 20 times what the card showed (5.6e-6).
STEP_GRAD_BOUND = 1e-4  # |dg|_inf <= bound * (|g|_inf + STEP_GRAD_FLOOR)
STEP_GRAD_FLOOR = 1e-5
# Card against CPU in float64, plain versions (the kernels take float32 and
# bfloat16): the same function on both devices, every index pick included;
# the card showed 1.9e-14 on the loss and 1.4e-10 on the worst gradient.
F64_LOSS_RTOL = 1e-10
F64_GRAD_BOUND = 1e-8
# In float32 the two devices are not comparable gradient by gradient: the
# hand-frame coordinates come out of a matmul and differ in the last bits
# between cuBLAS and the CPU, so a neighbour whose distance to a centre lies
# within rounding of the ball's radius falls inside on one device and outside
# on the other, and train-mode BatchNorm couples the whole batch to that
# cloud (PERF.md, Findings). The float32 kernels are held against their plain
# versions on the card instead.
# biases whose gradient is mathematically zero, so that what is computed is
# cancellation residue (1e-7 .. 1e-3 beside a largest gradient of 50, and
# different on every run of the plain versions): those that feed straight
# into a BatchNorm, and the bias of sa3's last BatchNorm, which shifts the
# global feature of every cloud alike (its ReLU is open at the max-pool's
# pick) ahead of fp3's BatchNorm over the batch
DEAD_BIAS = (r"(conv_blocks\.\d+\.\d+|mlp_convs\.\d+|bhand\.conv1|r1\.linear"
             r"|bhand\.sa3\.mlp_bns\.2)\.bias$")

OBJ_CONFIG = "objopt_test_SimGrasp_synth.yml"
OBJ_NUM_POINTS = 1024         # the optimiser's operating point (the config ships 256)
OBJ_POINTS_PER_PART = 1200    # >= OBJ_NUM_POINTS valid object points in every frame
OBJ_PARTICLES, OBJ_ITERATIONS = 2048, 10
OBJ_SHORT_FRAMES = 20         # composed and volume routes, against the fused one
OBJ_CPU_FRAMES = 2            # card against CPU
MLP_WIDTHS = (21, 128, 128, 128)   # 3 frequencies, hidden 128, depth 3
# Kernel against plain version on the card, one sdf value (|sdf| <= 0.05
# after the clamp, activations of order 1). Every MLP kernel runs it on the
# tensor cores in 3xTF32 (#3, #3b, #6 through wgmma, csrc/sdf_mlp_wgmma.cuh;
# #4, #4b, #7, #7b through mma.sync, csrc/sdf_mlp_tc.cuh), which rounds
# otherwise than float32 FMA: the tensor cores
# truncate their float32 sums, so one sdf value lay up to 1.64e-7 from the
# plain version's (#4 on 4096 single points) and 1.68e-7 (#7 on 398,336
# vertices built bitwise alike), and 1.53e-7 from the exact-sum 3xTF32
# emulation (ops/tf32.py), on the card (a float32 FMA kernel: 4.1e-08 from
# the plain version); #3 sums a layer's big and small products in two
# chains and showed 1.34e-7 at depth 8 (one chain: 3.4e-7). TC_SDF_ATOL holds
# one such value; for #7 against the emulation it is the tight hold, where
# the plain version's vertices carry their own rounding (SKIN_SDF_ATOL).
TC_SDF_ATOL = 2.5e-7
# a sum of N |sdf| values, relative to the sum's size (the card showed
# 2.2e-07 for the float32 FMA kernel, 1.64e-06 for the 3xTF32 one at the
# object path's shape, whose truncated sums come out low), plus ENERGY_ATOL a
# point for sums near 0 (one value of the 3xTF32 kernel: TC_SDF_ATOL; it was
# 1e-8 for the FMA one)
ENERGY_RTOL, ENERGY_ATOL = 2e-6, TC_SDF_ATOL
# Fused against composed route on the card, and card against CPU, are
# compared twice. Open loop: every frame again from the main run's previous
# pose, so both start alike. The 2048 energies of iteration 0 then differ by
# float32 rounding alone (the composed route transforms the cloud by a matmul,
# the kernel in its own fixed order; the CPU's sinf and cosf are not the
# card's). An energy is 500 x the mean of 1024 |sdf| values, and near the
# optimum those are about 1 mm, so the roundings, which do not shrink with
# the sdf, are held absolutely: OPEN_SDF_ATOL_M on the mean |sdf|, two fifths
# of what one value may differ by (TC_SDF_ATOL; a mean averages errors of either
# sign). The card showed 1.6e-08 m between the routes and 2.9e-08 m against
# the CPU, beside a smallest mean of about 1e-3 m. The pose after the
# frame's 10 iterations is not continuous in the energies: a candidate
# within rounding of "no better than now" enters or leaves the
# weighted mean, with a weight near 0, but the mean's quaternion head is
# normalised, so where few candidates are better the step turns by up to a
# candidate's own perturbation (the search size never falls below 1e-3, which
# is 0.11 degrees a unit of the bank). So: OPEN_TIGHT_* for at least
# OPEN_TIGHT_SHARE of the frames (the card showed 20 of 20 between the routes
# and 4 and 3 of 4 against the CPU, whose energies lie further off; of the 4
# CPU frames at least one), OPEN_* (a few such steps) for every frame.
OPEN_SDF_ATOL_M = 1e-7
OPEN_TIGHT_ROT_DEG, OPEN_TIGHT_TRANS_M, OPEN_TIGHT_SHARE = 2e-3, 2e-6, 0.5
OPEN_ROT_BOUND_DEG, OPEN_TRANS_BOUND_M = 0.5, 2e-4
# Closed loop: each frame starts from the run's own last pose, and nothing
# pulls two runs together along directions in which the energy is flat, so
# they are held only to the tracker's own accuracy on this sequence (0.5 deg
# and 0.2 mm against the ground truth; the card showed gaps up to 0.96 deg
# and 0.33 mm between the routes).
RUN_ROT_BOUND_DEG, RUN_TRANS_BOUND_M = 3.0, 1.5e-3

HAND_CONFIG = "handopt_test_SimGrasp_synth.yml"
HAND_NUM_POINTS = 512         # HandTrackNet's shipped width (the config ships 128)
HAND_PARTICLES, HAND_ITERATIONS, HAND_VERTS, HAND_POSE_DIMS = 5120, 5, 778, 135
HAND_FRAMES = 40              # the main run, and the run with masks
HAND_SHORT_FRAMES = 10        # the fused, separate and volume routes
HAND_MODE_FRAMES = 25         # shape modes 2 and 3 re-optimise on frames 10 and 20
HAND_CPU_PARTICLES = 512      # card against CPU, open loop
HAND_HW = (480, 640)
HAND_INTRINSICS = {"fx": 600.0, "fy": 600.0, "cx": 320.0, "cy": 240.0}
HAND_WEIGHTS = {"penetrate_sum_loss": 1.0, "sil_loss": 0.1, "attraction_loss": 0.05,
                "vis_regu_loss": 10.0, "invis_regu_loss": 0.0, "temporal_smooth": 1.0}
# Kernel #7 against its plain version on the card: the kernel sums a vertex in
# ascending order with FMA, the plain version by library products, so the
# vertices differ by float32 rounding (1e-7 m); through a seeded random net's
# steep features that moves an sdf by up to SKIN_SDF_ATOL (the card showed
# under a tenth of it), and a pixel may flip where the plain version's pixel
# coordinate lies within PIXEL_MARGIN of an integer (a vertex difference of
# 1e-7 m is 1.3e-4 pixels at 600 / 0.45 m): hit is held equal everywhere else,
# and the share of flips is printed and bounded.
SKIN_SDF_ATOL = 2e-5
PIXEL_MARGIN = 2e-3
FLIP_SHARE_BOUND = 1e-3
# Energies of iteration 0 across the pose optimiser's routes, from the same
# start. One flipped pixel moves a candidate's energy by HAND_FLIP = sil_loss
# / 778. Between fused and separate the pixels are the same and the sdf can
# differ by the object frame's rounding (a matrix product on the separate
# route, ordered sums in #6) through the same MLP: HAND_E_ATOL. The skin
# route's vertices differ from mano_forward's by rounding, so a candidate may
# carry a few flips (on a random mask about one candidate in ten has one):
# each candidate within
# HAND_E_ATOL + HAND_MAX_FLIPS x HAND_FLIP, and at most HAND_FLIPPED_SHARE of
# them beyond HAND_E_ATOL. The volume route asks another SDF (the nearest
# voxel of a 3 mm grid, off by up to a voxel's half diagonal of 2.6 mm, where
# the others ask a fit with 0.5 mm RMSE), so it is held at HAND_VOLUME_ATOL.
# Card against CPU the sinf / cosf differ too: HAND_CPU_E_ATOL.
HAND_FLIP = HAND_WEIGHTS["sil_loss"] / HAND_VERTS
HAND_E_ATOL, HAND_CPU_E_ATOL, HAND_VOLUME_ATOL = 5e-6, 2e-5, 5e-3
HAND_MAX_FLIPS, HAND_FLIPPED_SHARE = 4, 0.3
# the final keypoints of two correct runs from the same start whose candidates
# better than particle 0 are the same at every iteration (float32 rounding
# through the weighted means); where a candidate within rounding of particle 0,
# or a flipped pixel away from it, enters the set on one side only, the runs
# take another step of the search from that iteration on (ROADMAP queue 3) and
# are held to the tracker's accuracy, as the tests hold keypoints across packages
HAND_KP_BOUND_M, HAND_STEP_BOUND_M = 2e-3, 1e-2
# frame 0 where the frame-0 shape optimiser took another step of its search
# (betas apart): the step is in beta, whose search starts at a scale of 5
# (opt/hand_shape.INITIAL_SCALE), and a sequence whose betas parted by 4.6
# showed 27.3 mm at frame 0 (measured on one H100 with a generator a sequence;
# with one generator for all sequences they parted by under 10 mm);
# 27.3 x 5 / 4.6 = 29.7 mm
HAND_SHAPE_STEP_BOUND_M = 3e-2

# Several sequences through one loop (`eval_batch_seqs`, the batched kernels
# #3b, #4b, #5b, #7b): chunks of HAND_SEQS / OBJ_SEQS sequences of one length
# on generated sets whose test split holds that many. The fits of these paths
# are extra fits, distilled with BATCH_FIT_STEPS Adam steps (the unbatched
# paths distil with the full 4000), one a sequence, so that they differ.
HAND_SEQS, HAND_BATCH_FRAMES, HAND_BATCH_SHORT = 4, 20, 5
OBJ_SEQS, OBJ_BATCH_FRAMES = 4, 10
BATCH_FIT_STEPS = 500

# The real-data layouts (phase 11): the shipped HO3D and DexYCB configs on
# trees written by data/real_trees.py. objopt_test_HO3D tracks as many frames
# as the object path's shorter runs, the hand configs and DexYCB as many as
# the hand path's, so that the kernels see shapes phase 3 holds already; the
# decoder is the shipped 8 x 512 DeepSDF one, seeded.
REAL_OBJ_CONFIG, REAL_HAND_CONFIG = "objopt_test_HO3D.yml", "handopt_test_HO3D.yml"
REAL_OBJ_FRAMES, REAL_HAND_FRAMES = OBJ_SHORT_FRAMES, HAND_SHORT_FRAMES
DECODER_SEED = 0
# The decoder's object is a random field's closed level set: a blob (80 x 61 x
# 56 mm for this seed) whose rotation the cloud pins down less than a box's.
# Held: every frame's translation error below the jittered initialisation's,
# and every frame's rotation error within the 10deg10cm criterion's 10 deg (a
# debugging run on the card tracked 45.5 mm of initial offset down to 2.8-4.0 mm
# and 1.4-5.6 deg, from 0.3 deg of initial rotation jitter).
REAL_ROT_BOUND_DEG = 10.0
# Card against CPU open loop on this fit: a mean of 1024 |sdf| values, each
# within TC_SDF_ATOL of the plain version's (the tensor cores' truncated sums
# all err low, so the mean may keep the whole of it). The card showed 1.03e-7
# to 1.14e-7 m on the decoder's fit, over OPEN_SDF_ATOL_M, which holds the
# box's fit (2.9e-8 there) and stays as it is.
REAL_OPEN_SDF_ATOL_M = TC_SDF_ATOL
# The tree's gt and reconstruction meshes: marching tetrahedra of the
# decoder's field over [-1, 1]^3 at this resolution, so that the
# reconstruction has more vertices than FPS's shared-memory kernels take
# (csrc/fps.cu kMaxPoints) and the object runner's chamfer evaluation runs
# FPS's global-memory path on the card.
REAL_MESH_RES = 96
CHAMFER_SAMPLES = 2048
CHAMFER_KEYS = ("mean/raw_obj_chamfer(mm)", "mean/pred_obj_chamfer(mm)")
# the native library's float32 back-projection against the float64 numpy
# version: two roundings (a product and a quotient) a coordinate
NATIVE_RTOL = 2 * float(np.finfo(np.float32).eps)
# online shape update (`--opt/updateobjshape True`): one update and one
# re-bake in 10 frames (track_obj_with_shape_update's update_every)
SHAPE_FRAMES = 10
# the library modules no entry calls, card against CPU in eval mode: float32
# products and sums in two devices' orders on activations of order 1, the
# same FPS, ball-query and kNN picks (printed)
LIBRARY_ATOL = 1e-4
# online serving (phase 13): frames of each tracker
SERVE_FRAMES = HAND_SHORT_FRAMES

# the card's published peaks (NVIDIA H100 SXM data sheet): the bounds below
# are the least time the card could take, whatever its power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12   # dense, on the tensor cores

KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "fps": ("hotrack_tpu_torch/csrc/fps.cu", "hotrack_tpu/ops/pallas/fps.py:35"),
    "gather_rows": ("hotrack_tpu_torch/csrc/gather_rows.cu",
                    "hotrack_tpu/ops/pallas/gather_mm.py:93"),
    "scatter_rows_add": ("hotrack_tpu_torch/csrc/gather_rows.cu",
                         "hotrack_tpu/ops/pallas/gather_mm.py:103"),
    "sdf_mlp": ("hotrack_tpu_torch/csrc/sdf_mlp.cu",
                "hotrack_tpu/ops/pallas/sdf_mlp.py:43"),
    "obj_sdf_energy": ("hotrack_tpu_torch/csrc/obj_energy.cu",
                       "hotrack_tpu/ops/pallas/obj_energy.py:51"),
    "packed_mask_lookup": ("hotrack_tpu_torch/csrc/mask_lookup.cu",
                           "hotrack_tpu/ops/pallas/mask_lookup.py:50"),
    "hand_energy": ("hotrack_tpu_torch/csrc/hand_energy.cu",
                    "hotrack_tpu/ops/pallas/hand_energy.py:225"),
    "hand_energy_skin": ("hotrack_tpu_torch/csrc/hand_energy_skin.cu",
                         "hotrack_tpu/ops/pallas/hand_energy_skin.py:62"),
    "sdf_mlp_batched": ("hotrack_tpu_torch/csrc/sdf_mlp.cu",
                        "hotrack_tpu/ops/pallas/sdf_mlp.py:183"),
    "obj_sdf_energy_batched": ("hotrack_tpu_torch/csrc/obj_energy.cu",
                               "hotrack_tpu/ops/pallas/obj_energy.py:171"),
    "packed_mask_lookup_batched": ("hotrack_tpu_torch/csrc/mask_lookup.cu",
                                   "hotrack_tpu/ops/pallas/mask_lookup.py:105"),
    "hand_energy_skin_batched": ("hotrack_tpu_torch/csrc/hand_energy_skin.cu",
                                 "hotrack_tpu/ops/pallas/hand_energy_skin.py:197"),
}
# launches per call of the model: index_points runs 15 times in a HandTrackNet
# forward (sa1 2, sa2 3, fp2 1, fp1 1, q1 4, q2 4), 7 of them on feature
# sources, whose backward is the scatter-add; FPS runs in sa1 and sa2.
# prepare_batch samples (FPS) and gathers the hand and the object cloud.
GATHERS_PER_FORWARD, SCATTERS_PER_BACKWARD, FPS_PER_FORWARD, PER_PREPARE = 15, 7, 2, 2

# The batch sizes the paths give the kernels. The model runs on one frame
# when tracking (on one frame of each of HAND_SEQS sequences on the batched
# hand path), on full batches and on the ragged tails of the train and the
# test split when training; prepare_batch also takes a whole sequence at once
# when tracking (the tracking path's and the train path's test sequence).
TAILS = (2 * TRAIN_FRAMES % BATCH, TRAIN_FRAMES % BATCH)
MODEL_BATCHES = (1, BATCH, *TAILS, HAND_SEQS)
BACKWARD_BATCHES = (BATCH, TAILS[0])
PREPARE_BATCHES = (NUM_FRAMES, TRAIN_FRAMES, BATCH, *TAILS, HAND_FRAMES, HAND_SHORT_FRAMES,
                   HAND_MODE_FRAMES, HAND_BATCH_FRAMES)
RAW_POINTS = 2560       # points of a raw hand or object cloud, padding included
# the object path prepares whole sequences at 1024 points from 5 x 1024 raw ones
OBJ_PREPARE_BATCHES = (NUM_FRAMES, OBJ_SHORT_FRAMES, OBJ_CPU_FRAMES, OBJ_BATCH_FRAMES)
OBJ_RAW_POINTS = 5 * OBJ_NUM_POINTS
# (name, N, C, S) of the index_points calls of one HandTrackNet forward; the
# sources of C = 3 are coordinates (no gradient), the others features
FORWARD_GATHERS = [
    ("sa1 centres", 512, 3, 256), ("sa1 group xyz", 512, 3, 8192),
    ("sa2 centres", 256, 3, 128), ("sa2 group xyz", 256, 3, 4096),
    ("sa2 group feats", 256, 64, 4096), ("fp2", 128, 256, 768),
    ("fp1", 256, 128, 1536), ("q xyz k=16", 512, 3, 336),
    ("q xyz k=64", 512, 3, 1344), ("q feats k=16", 512, 384, 336),
    ("q feats k=64", 512, 384, 1344),
]
# (name, B, N, C, S) of every gather the paths launch; its adjoint runs for
# the feature sources in the train step's backward
GATHER_SHAPES = [(name, b, n, c, s) for b in MODEL_BATCHES
                 for name, n, c, s in FORWARD_GATHERS] \
    + [("prepare_batch", b, RAW_POINTS, 3, 512) for b in PREPARE_BATCHES] \
    + [("prepare_batch obj", b, OBJ_RAW_POINTS, 3, OBJ_NUM_POINTS)
       for b in OBJ_PREPARE_BATCHES]
SCATTER_SHAPES = [(name, b, n, c, s) for b in BACKWARD_BATCHES
                  for name, n, c, s in FORWARD_GATHERS if c != 3]
# (name, B, N, npoint, masked) of every FPS the paths launch
FPS_SHAPES = [("prepare_batch", b, RAW_POINTS, 512, True) for b in PREPARE_BATCHES] \
    + [("prepare_batch obj", b, OBJ_RAW_POINTS, OBJ_NUM_POINTS, True)
       for b in OBJ_PREPARE_BATCHES] \
    + [(name, b, n, npoint, False) for b in MODEL_BATCHES
       for name, n, npoint in (("sa1", 512, 256), ("sa2", 256, 128))]
# the library check (phase 13): PointNet2Encoder at the tracking path's shapes
# (its sa1 and sa2 are HandTrackNet's, batch 1) and a point-transformer
# stack on 512 points: a down block to 128 centres and an up block back, 16
# neighbours, 64 channels (residual blocks of 16)
PT_POINTS, PT_NPOINT, PT_NSAMPLE, PT_DIM = 512, 128, 16, 64
PT_MID = PT_DIM // 4
FPS_SHAPES += [("point transformer", 1, PT_POINTS, PT_NPOINT, False)]
GATHER_SHAPES += [
    ("pt down centres", 1, PT_POINTS, 3, PT_NPOINT),
    ("pt down group xyz", 1, PT_POINTS, 3, PT_NPOINT * PT_NSAMPLE),
    ("pt down k/v", 1, PT_NPOINT, PT_MID, PT_NPOINT * PT_NSAMPLE),
    ("pt up 3-nn", 1, PT_NPOINT, PT_DIM, PT_POINTS * 3),
    ("pt up k/v", 1, PT_POINTS, PT_MID, PT_POINTS * PT_NSAMPLE)]
TIMED_FPS_BATCHES = (NUM_FRAMES, 1, BATCH)
TIMED_SHAPES = ("q feats k=64", "sa2 group feats")  # the two largest outputs, at BATCH
# what the object path gives the two SDF kernels: the composed route's
# (P, 3, N) transformed cloud, channels-first; the fused route's (P, N)
# and the hand path's separate route: the (P, 778, 3) object-frame vertices,
# channels-last
SDF_MLP_SHAPES = [((OBJ_PARTICLES, 3, OBJ_NUM_POINTS), True),
                  ((HAND_PARTICLES, HAND_VERTS, 3), False)]
OBJ_ENERGY_SHAPES = [(OBJ_PARTICLES, OBJ_NUM_POINTS)]
# what the hand paths give the three hand kernels: a synthetic sequence ships
# no masks (1 x 1), the optimiser phase and the run with masks use 480 x 640
NO_MASK_HW = (1, 1)
MASK_LOOKUP_SHAPES = [((HAND_PARTICLES, HAND_VERTS), hw) for hw in (NO_MASK_HW, HAND_HW)]
HAND_ENERGY_SHAPES = [((HAND_PARTICLES, HAND_VERTS, 3), hw) for hw in (NO_MASK_HW, HAND_HW)]
HAND_SKIN_SHAPES = [(HAND_PARTICLES, HAND_POSE_DIMS, HAND_VERTS, NO_MASK_HW),
                    (HAND_PARTICLES, HAND_POSE_DIMS, HAND_VERTS, HAND_HW),
                    (HAND_CPU_PARTICLES, HAND_POSE_DIMS, HAND_VERTS, HAND_HW)]
# what the batched paths give the batched kernels: the object path's
# composed route (#3b) and fused route (#4b); the batched hand path's fused
# and separate routes (#3b, #5b), the volume route (#5b) and the skin route
# (#7b) through the entry (the synthetic set's 1 x 1 masks) and with seeded
# 480 x 640 masks
SDF_MLP_BATCHED_SHAPES = [((OBJ_SEQS, OBJ_PARTICLES, 3, OBJ_NUM_POINTS), True),
                          ((HAND_SEQS, HAND_PARTICLES, 3, HAND_VERTS), True),
                          ((HAND_SEQS, HAND_PARTICLES, HAND_VERTS, 3), False)]
OBJ_ENERGY_BATCHED_SHAPES = [(OBJ_SEQS, OBJ_PARTICLES, OBJ_NUM_POINTS)]
MASK_LOOKUP_BATCHED_SHAPES = [((HAND_SEQS, HAND_PARTICLES, HAND_VERTS), HAND_HW)]
HAND_SKIN_BATCHED_SHAPES = [(HAND_SEQS, HAND_PARTICLES, HAND_POSE_DIMS, HAND_VERTS, hw)
                            for hw in (NO_MASK_HW, HAND_HW)]


def _seen_shape(name: str, args: tuple) -> tuple:
    if name == "sdf_mlp_batched":
        points, _, channels_first = args
        return (tuple(points.shape), channels_first)
    if name == "obj_sdf_energy_batched":
        pcld_cf, rts, _ = args
        return (*rts.shape[:2], pcld_cf.shape[-1])
    if name == "packed_mask_lookup_batched":
        _, iy, _, hw = args
        return (tuple(iy.shape), tuple(hw))
    if name == "hand_energy_skin_batched":
        pose_map, *_, hw, _ = args
        return (*pose_map.shape, args[3].shape[-1], tuple(hw))
    if name == "fps":
        xyz, npoint, *mask = args
        return (*xyz.shape[:2], npoint, bool(mask) and mask[0] is not None)
    if name == "gather_rows":
        points, flat_idx = args
        return (*points.shape, flat_idx.shape[1])
    if name == "sdf_mlp":
        points, _, channels_first = args
        return (tuple(points.shape), channels_first)
    if name == "obj_sdf_energy":
        pcld_cf, rts, _ = args
        return (rts.shape[0], pcld_cf.shape[1])
    if name == "packed_mask_lookup":
        _, iy, _, hw = args
        return (tuple(iy.shape), tuple(hw))
    if name == "hand_energy":
        points, _, _, hw, _ = args
        return (tuple(points.shape), tuple(hw))
    if name == "hand_energy_skin":
        pose_map, *_, hw, _ = args
        return (*pose_map.shape, args[3].shape[2], tuple(hw))
    dout, flat_idx, n = args
    return (dout.shape[0], n, dout.shape[2], flat_idx.shape[1])


@contextlib.contextmanager
def noting_shapes(seen: dict):
    """While a path runs, note into `seen` (kernel name -> set) the shapes each
    kernel's wrapper is given: (B, N, npoint, masked) for FPS, (B, N, C, S)
    for the row gather and its adjoint, and so on (`_seen_shape`). The
    wrappers themselves run as they are."""
    from hotrack_tpu_torch.ops import kernels
    real = {name: getattr(kernels, name + "_cuda") for name in KERNELS}

    def noting(name):
        def wrapper(*args, **kwargs):
            seen[name].add(_seen_shape(name, (*args, *kwargs.values())))
            return real[name](*args, **kwargs)
        return wrapper

    for name in real:
        setattr(kernels, name + "_cuda", noting(name))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(kernels, name + "_cuda", fn)


def check_seen_shapes(seen: dict) -> None:
    """The kernels phase must have held each kernel at every shape the paths
    gave it, and at no shape that was assumed rather than seen."""
    checked = {"fps": {sh[1:] for sh in FPS_SHAPES},
               "gather_rows": {sh[1:] for sh in GATHER_SHAPES},
               "scatter_rows_add": {sh[1:] for sh in SCATTER_SHAPES},
               "sdf_mlp": set(SDF_MLP_SHAPES), "obj_sdf_energy": set(OBJ_ENERGY_SHAPES),
               "packed_mask_lookup": set(MASK_LOOKUP_SHAPES),
               "hand_energy": set(HAND_ENERGY_SHAPES),
               "hand_energy_skin": set(HAND_SKIN_SHAPES),
               "sdf_mlp_batched": set(SDF_MLP_BATCHED_SHAPES),
               "obj_sdf_energy_batched": set(OBJ_ENERGY_BATCHED_SHAPES),
               "packed_mask_lookup_batched": set(MASK_LOOKUP_BATCHED_SHAPES),
               "hand_energy_skin_batched": set(HAND_SKIN_BATCHED_SHAPES)}
    for name in KERNELS:
        print(f"[shapes] {name}: the paths gave it {len(seen[name])} shapes: "
              f"{sorted(seen[name])}", flush=True)
        if seen[name] != checked[name]:
            raise AssertionError(
                f"[shapes] {name}: seen on the paths but not checked "
                f"{sorted(seen[name] - checked[name])}; checked but not seen "
                f"{sorted(checked[name] - seen[name])}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke test runs only on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    return card


def phase_build():
    from hotrack_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    libs = kernels.build_all()
    # load each library and launch each kernel once
    kernels.fps_cuda(torch.zeros((1, 4, 3), device="cuda"), 2)
    rows = kernels.gather_rows_cuda(torch.zeros((1, 4, 3), device="cuda"),
                                    torch.zeros((1, 2), dtype=torch.int32, device="cuda"))
    kernels.scatter_rows_add_cuda(rows, torch.zeros((1, 2), dtype=torch.int32,
                                                    device="cuda"), 4)
    from hotrack_tpu_torch.ops.obj_energy import fused_obj_sdf_energy
    from hotrack_tpu_torch.ops.sdf_mlp import fused_sdf_mlp
    tiny = _random_sdf(np.random.RandomState(0), (9, 8))
    fused_sdf_mlp(tiny, torch.zeros((5, 3), device="cuda"))
    fused_obj_sdf_energy(tiny, torch.zeros((3, 5), device="cuda"),
                         torch.eye(3, device="cuda")[None], torch.zeros((1, 3), device="cuda"))
    from hotrack_tpu_torch.ops.hand_energy import fused_hand_energy, hand_frame
    from hotrack_tpu_torch.ops.hand_energy_skin import SkinConsts, fused_hand_energy_skin
    from hotrack_tpu_torch.ops.mask_lookup import pack_mask, packed_mask_lookup
    bits = pack_mask(torch.zeros((2, 3), dtype=torch.bool, device="cuda"))
    zero = torch.zeros((4,), dtype=torch.int32, device="cuda")
    packed_mask_lookup(bits, zero, zero, (2, 3))
    frame = hand_frame(torch.eye(3, device="cuda"), torch.zeros(3, device="cuda"), 1.0, 1.0,
                       0.0, 0.0)
    fused_hand_energy(tiny, bits, frame, torch.ones((1, 5, 3), device="cuda"), (2, 3))
    f32 = dict(device="cuda", dtype=torch.float32)
    fused_hand_energy_skin(tiny, bits, frame, torch.zeros((1, 4), **f32),
                           torch.zeros((12, 16), **f32), torch.ones((1, 3), **f32),
                           SkinConsts(torch.zeros((3, 4, 5), **f32), torch.zeros((3, 5), **f32),
                                      torch.zeros((16, 5), **f32)), (2, 3))
    # and the batched forms, two sequences
    from hotrack_tpu_torch.ops.sdf_mlp import pack_distilled_batched
    two = pack_distilled_batched([tiny, tiny])
    kernels.sdf_mlp_batched_cuda(torch.zeros((2, 5, 3), **f32), two, False)
    kernels.obj_sdf_energy_batched_cuda(torch.zeros((2, 3, 5), **f32),
                                        torch.zeros((2, 1, 12), **f32), two)
    kernels.packed_mask_lookup_batched_cuda(torch.stack([bits, bits]), zero.reshape(2, 2),
                                            zero.reshape(2, 2), (2, 3))
    kernels.hand_energy_skin_batched_cuda(
        torch.zeros((2, 1, 4), **f32), torch.zeros((2, 12, 16), **f32),
        torch.ones((2, 1, 3), **f32), torch.zeros((3, 4, 5), **f32), torch.zeros((2, 3, 5), **f32),
        torch.zeros((16, 5), **f32), torch.stack([frame, frame]), torch.stack([bits, bits]),
        (2, 3), two)
    torch.cuda.synchronize()
    print(f"[build] {sorted(libs)}: {time.perf_counter() - t0:.3f} s", flush=True)
    for name, lib in libs.items():
        with open(str(lib) + ".log") as f:
            report = [ln for ln in f.read().splitlines()
                      if "registers" in ln or "spill" in ln or "error" in ln.lower()]
        print(f"[build] {name} -> {lib}\n" + "\n".join(report), flush=True)


def _grid_cloud(rng, b, n):
    base = rng.randint(0, 6, size=(b, n // 4, 3)).astype(np.float32)
    return np.ascontiguousarray(np.repeat(base, 4, axis=1)[:, rng.permutation(n)])


def _time_ms(fn, reps: int) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _in_turns(kernel, plain, library, reps=50, slow_reps=3) -> dict:
    """Times on one card, in turns: plain, kernel, library, library, kernel,
    plain (each one warmed by the comparison that came before)."""
    lib = [] if library is None else [library]
    order = [plain, kernel, *lib, *lib, kernel, plain]
    t = [_time_ms(fn, slow_reps if fn is plain else reps) for fn in order]
    out = {"ms": (t[1] + t[-2]) / 2, "plain_ms": (t[0] + t[-1]) / 2,
           "library_ms": None if library is None else (t[2] + t[3]) / 2}
    return out


def _bound(n_bytes: float, n_ops: float, mlp_ops: float = 0.0,
           tensor_cores: bool = False) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once) over
    the HBM rate and its operations over the peak for their type. n_ops are
    float32 operations; mlp_ops the SDF MLP's, which cost those operations in
    float32 FMA or three tensor-core passes of them at the TF32 peak in 3xTF32
    (float32-class results): an MLP kernel reports both (bound_fp32_ms,
    bound_3xtf32_ms), and bound_ms is the one of its own arithmetic
    (tensor_cores: 3xTF32)."""
    by_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    fp32 = 1e3 * (n_ops + mlp_ops) / FP32_FLOPS
    tc3 = 1e3 * (3.0 * mlp_ops / TF32_FLOPS + n_ops / FP32_FLOPS)
    by_ops = tc3 if tensor_cores else fp32
    out = {"bound_ms": max(by_bytes, by_ops),
           "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
    if mlp_ops:
        out.update(bound_fp32_ms=max(by_bytes, fp32), bound_3xtf32_ms=max(by_bytes, tc3))
    return out


def _sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True, timeout=60)
    return 1e6 * float(out.stdout.strip().splitlines()[0])


# Latencies for the FPS bound, in SM cycles, measured by scripts/warp_latency.py
# (the least of 7 launches of 4096 dependent rounds) on an NVIDIA H100 80GB
# HBM3 at 700 W: a dependent float32 add or multiply (half a round of
# __fadd_rn after __fmul_rn: 8.63), an add then a min, a round of a butterfly
# argmax of (value, index) with ties to the lower index (two shuffles, a
# compare, two selects), one redux.sync, and a round between 2 warps through
# shared memory (a store, a barrier, a load: the least of 2-16 warps)
FP32_CYCLES = 8.63 / 2
ADD_MIN_CYCLES = 10.44
SHUFFLE_ROUND_CYCLES, REDUX_CYCLES, SHARED_ROUND_CYCLES = 41.74, 44.26, 46.57
LANES_PER_SM = 128        # float32 operations an SM issues a cycle (4 schedulers x 32)
WARP_MAX_POINTS = 32 * 63  # 4 registers a point within a lane's 255


def _fps_latency_bound_ms(n: int, npoint: int, clock_hz: float) -> float:
    """The least time of FPS's npoint - 1 dependent steps on one cloud, whatever
    the kernel's design: a step cannot be shorter than
      3 * FP32_CYCLES + ADD_MIN_CYCLES
                            one point's distance and minimum (sub, mul, add, add,
                            min: 5 dependent float32 operations)
    plus a reduction of the N candidates to the first maximal index, the
    cheaper of one warp's
      5 * SHUFFLE_ROUND_CYCLES   five butterfly rounds of (value, index)
      2 * REDUX_CYCLES           two redux.sync: the largest value, then the
                                 lowest index of the lanes that hold it
    plus the cheaper of
      10 * ceil(N / 32)     one warp holds the cloud (N <= WARP_MAX_POINTS): the
                            issue slots of N points' 10 operations on one of
                            the SM's schedulers
      SHARED_ROUND_CYCLES + 10 * N / LANES_PER_SM
                            several warps on one SM: a shared-memory round, and
                            the issue slots on all four schedulers."""
    one_warp = 10 * -(-n // 32) if n <= WARP_MAX_POINTS else math.inf
    warps = SHARED_ROUND_CYCLES + 10 * n / LANES_PER_SM
    reduction = min(5 * SHUFFLE_ROUND_CYCLES, 2 * REDUX_CYCLES)
    cycles = 3 * FP32_CYCLES + ADD_MIN_CYCLES + reduction + min(one_warp, warps)
    return 1e3 * (npoint - 1) * cycles / clock_hz


def _fps_shared_design_bound_ms(n: int, npoint: int, clock_hz: float) -> float:
    """The bound of the earlier csrc/fps.cu design (one block a cloud of 256 or
    512 threads, the cloud in shared memory, two reductions and a barrier a
    step), printed beside the design-independent bound for comparison with
    earlier records. With 30 cycles for a shared-memory load or a barrier, 25 for a
    warp shuffle and 4 for a dependent float32 operation, a step is at least:
      30              the picked point's coordinates from shared memory
      30 + 6 * 4      a point's loads, then sub, mul, add, add, min, compare
      14 * p * w      scheduler slots of the pass: 14 operations a point, p points
                      a thread, w warps on each of the SM's 4 schedulers
      5 * (25 + 8)    the warp's shuffle reduction of (value, index)
      30              the barrier
      30 + 5 * 33     every warp reads the slots and reduces them."""
    threads = 256 if n <= 1024 else 512
    cycles = 30 + 54 + 14 * -(-n // threads) * (threads // 128) + 165 + 30 + 195
    return 1e3 * (npoint - 1) * cycles / clock_hz


def _headline(timed: list) -> dict:
    """The timed case with the most work: the one whose numbers stand for the
    kernel in the result line (all of them are under "cases")."""
    return max(timed, key=lambda case: case["bound_ms"])


def _fmt(case: dict) -> str:
    lib = "none" if case["library_ms"] is None else f"{case['library_ms']:.4f} ms"
    line = (f"kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, library "
            f"{lib}, bound {case['bound_ms']:.5f} ms ({case['bound_by']})")
    if "bound_3xtf32_ms" in case:
        line += (f" [float32 {case['bound_fp32_ms']:.5f}, 3xTF32 {case['bound_3xtf32_ms']:.5f};"
                 f" {case['bound_ms'] / case['ms']:.3f} of the bound]")
    return line


def _fps_shared_max() -> int:
    """The largest cloud of FPS's shared-memory kernels: csrc/fps.cu's
    kMaxPoints, read from the source that defines it."""
    from hotrack_tpu_torch.ops import kernels
    src = (kernels.CSRC_DIR / "fps.cu").read_text()
    return int(re.search(r"constexpr int kMaxPoints = (\d+);", src).group(1))


def phase_kernels_fps() -> dict:
    """FPS kernel vs plain version on the card. Tolerance: index-exact.
    No single PyTorch call computes FPS, so there is no library time."""
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.ops.pointops import _farthest_point_sample_torch as plain
    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    shared_max = _fps_shared_max()
    lib = kernels._load("fps", kernels._bind_fps)
    if lib.hotrack_fps_scratch(1, shared_max) or \
            lib.hotrack_fps_scratch(1, shared_max + 1) != shared_max + 1:
        raise AssertionError(f"[kernels] the built FPS library's global-memory path does "
                             f"not start above kMaxPoints = {shared_max}")

    def cloud(b, n):
        return torch.from_numpy((rng.randn(b, n, 3) * 0.05).astype(np.float32)).to(dev)

    clock_hz = _sm_clock_hz()
    cases = [  # (name, xyz, npoint, mask, timed): the paths' shapes, then two more
        (f"{name} ({b},{n},3)->{npoint}" + " masked" * masked, cloud(b, n), npoint,
         torch.from_numpy(rng.rand(b, n) < 0.7).to(dev) if masked else None,
         b in TIMED_FPS_BATCHES)
        for name, b, n, npoint, masked in FPS_SHAPES]
    cases += [
        ("tie-heavy grid (1,512,3)->256",
         torch.from_numpy(_grid_cloud(rng, 1, 512)).to(dev), 256, None, False),
        ("tie-heavy grid (4,2560,3)->512",
         torch.from_numpy(_grid_cloud(rng, 4, 2560)).to(dev), 512, None, False),
        ("masked, point 0 invalid (4,2560,3)->512", cloud(4, 2560), 512,
         torch.from_numpy(np.concatenate([np.zeros((4, 1), bool),
                                          rng.rand(4, 2559) < 0.5], 1)).to(dev), False),
    ]
    # the two kernels' boundary: one warp a cloud up to 1024 points, a block above
    cases += [(f"boundary ({b},{n},3)->256" + " masked" * masked, cloud(b, n), 256,
               torch.from_numpy(rng.rand(b, n) < 0.7).to(dev) if masked else None, False)
              for n in (1024, 1025) for b, masked in ((4, False), (4, True))]
    # the shared copy's limit: the block kernel up to kMaxPoints points, the
    # global-memory kernel above (timed, as the chamfer mesh's shape in the list)
    cases += [(f"boundary ({b},{n},3)->256" + " masked" * masked, cloud(b, n), 256,
               torch.from_numpy(rng.rand(b, n) < 0.7).to(dev) if masked else None, True)
              for n in (shared_max, shared_max + 1) for b, masked in ((4, False), (4, True))]
    cases.append(("tie-heavy grid (2,16384,3)->512",
                  torch.from_numpy(_grid_cloud(rng, 2, 16384)).to(dev), 512, None, True))
    max_err, timed = 0, []
    for name, xyz, npoint, mask, is_timed in cases:
        got = kernels.fps_cuda(xyz, npoint, mask)
        want = plain(xyz, npoint, mask)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"[kernels] fps {name}: {int((got != want).sum())} "
                                 f"indices differ from the plain version")
        line = f"[kernels] fps {name}: index-exact"
        if is_timed:
            b, n, _ = xyz.shape
            case = _in_turns(lambda: kernels.fps_cuda(xyz, npoint, mask),
                             lambda: plain(xyz, npoint, mask), None)
            # each of the npoint - 1 steps: 3 subtractions, 3 products, 2 sums,
            # a minimum and a comparison for every point
            case.update(_bound(b * n * (12 + (mask is not None)) + b * npoint * 4,
                               10.0 * b * n * (npoint - 1)))
            case["latency_bound_ms"] = _fps_latency_bound_ms(n, npoint, clock_hz)
            case["shared_design_bound_ms"] = _fps_shared_design_bound_ms(n, npoint, clock_hz)
            case["shape"] = name
            timed.append(case)
            line += (f"; {_fmt(case)}; latency bound {case['latency_bound_ms']:.4f} ms "
                     f"({case['latency_bound_ms'] / case['ms']:.3f} of it; the shared-memory design's "
                     f"bound {case['shared_design_bound_ms']:.4f} ms) at {clock_hz / 1e6:.0f} MHz")
        print(line, flush=True)
    return {"max_abs_err": max_err, **timed[0], "cases": timed}


def _rows_case(rng, b, n, c, s, dtype=torch.float32, hi=None):
    src = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(dtype).cuda()
    idx = torch.from_numpy(rng.randint(0, hi or n, (b, s))).cuda()
    return src, idx


def phase_kernels_gather() -> dict:
    """Row gather vs plain version: bitwise. Library call: torch.gather."""
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.ops.pointops import _gather_rows_torch as plain
    rng = np.random.RandomState(1)
    timed = []
    cases = [(*shape, torch.float32) for shape in GATHER_SHAPES]
    cases.append(("q feats k=64 bf16", BATCH, 512, 384, 1344, torch.bfloat16))
    cases.append(("odd bf16 row, int32 index", 3, 100, 5, 77, torch.bfloat16))
    for name, b, n, c, s, dtype in cases:
        src, idx = _rows_case(rng, b, n, c, s, dtype)
        if "int32" in name:
            idx = idx.int()
        got = kernels.gather_rows_cuda(src, idx)
        want = plain(src, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"[kernels] gather_rows {name}: differs from the plain "
                                 f"version in {int((got != want).sum())} elements")
        line = f"[kernels] gather_rows {name} ({b},{n},{c})x({b},{s}) {dtype}: bitwise"
        if name in TIMED_SHAPES and b == BATCH:
            expanded = idx[..., None].expand(-1, -1, c)
            case = _in_turns(lambda: kernels.gather_rows_cuda(src, idx),
                             lambda: plain(src, idx),
                             lambda: torch.gather(src, 1, expanded))
            case.update(_bound(src.numel() * 4 + idx.numel() * 8 + got.numel() * 4, 0))
            case["shape"] = f"{name} ({b},{n},{c})x({b},{s})"
            timed.append(case)
            line += "; " + _fmt(case)
        print(line, flush=True)
    # an index outside [0, N): a zero row, nothing read outside the tensor
    src, idx = _rows_case(rng, 2, 10, 8, 4)
    idx[0, 1], idx[1, 2] = -1, 10
    got = kernels.gather_rows_cuda(src, idx)
    torch.cuda.synchronize()
    if float(got[0, 1].abs().sum()) != 0 or float(got[1, 2].abs().sum()) != 0 \
            or not torch.equal(got[0, 0], src[0, idx[0, 0]]):
        raise AssertionError("[kernels] gather_rows: out-of-range index is not a zero row")
    print("[kernels] gather_rows out-of-range index: zero row", flush=True)
    # a bf16 view that starts 2 bytes off a 4-byte boundary, rows of 4 and 16 bytes
    for c in (2, 8):
        store, idx = _rows_case(rng, 1, 1, 1 + 3 * 20 * c, 9, torch.bfloat16, hi=20)
        src = store.reshape(-1)[1:].view(3, 20, c)
        idx = idx.reshape(3, 3)
        got = kernels.gather_rows_cuda(src, idx)
        torch.cuda.synchronize()
        if src.data_ptr() % 4 != 2 or not torch.equal(got, plain(src, idx)):
            raise AssertionError(f"[kernels] gather_rows: bf16 view at an odd offset, C={c}")
    print("[kernels] gather_rows bf16 view at an odd storage offset: bitwise", flush=True)
    return {"max_abs_err": 0.0, **_headline(timed), "cases": timed}


def phase_kernels_scatter() -> dict:
    """Scatter-add adjoint vs the plain version accumulated in float64 (on
    the card index_add_ uses atomics in no fixed order; in float64 that
    cannot show). Tolerances: index sets like the path's (a row collects
    S / N terms) at rtol 1e-6, atol 1e-5; duplicate-heavy sets (7 distinct
    rows, so hundreds of float32 terms per row) within the bound of a
    sequential float32 sum, (terms * sum|x| + |result|) * 2^-24; a second
    launch bitwise equal to the first; and bitwise the plain version in
    float32 on the CPU, which adds in the kernel's order. Library call: one
    index_add_ over the flattened rows, which is not deterministic."""
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.ops.pointops import _scatter_rows_add_torch as plain
    rng = np.random.RandomState(2)
    max_err, timed = 0.0, []
    for name, b, n, c, s in SCATTER_SHAPES:
        for kind, hi in (("path-like", None), ("7 distinct rows", 7), ("single row", 1)):
            dout, idx = _rows_case(rng, b, s, c, s, hi=hi or n)
            got = kernels.scatter_rows_add_cuda(dout, idx, n)
            again = kernels.scatter_rows_add_cuda(dout, idx, n)
            want = plain(dout.double(), idx, n, torch.float64)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"[kernels] scatter_rows_add {name} {kind}: two "
                                     f"launches differ")
            err = (got.double() - want).abs()
            if hi is None:
                ok = bool((err <= 1e-6 * want.abs() + 1e-5).all())
            else:
                terms = plain(torch.ones_like(dout[..., :1]).double(), idx, n, torch.float64)
                ok = bool((err <= (terms * plain(dout.abs().double(), idx, n, torch.float64)
                                   + want.abs()) * 2.0 ** -24).all())
                ok = ok and bool((got[:, hi:] == 0).all())  # unselected rows exactly 0
            if not ok:
                raise AssertionError(f"[kernels] scatter_rows_add {name} {kind}: max error "
                                     f"{float(err.max()):.3e} is outside the bound")
            # the kernel and the plain version in float32 on the CPU both add in
            # ascending s, one term after another: bitwise
            if not torch.equal(got.cpu(), plain(dout.cpu(), idx.cpu(), n)):
                raise AssertionError(f"[kernels] scatter_rows_add {name} {kind}: differs from "
                                     f"the plain version in float32 on the CPU")
            max_err = max(max_err, float(err.max()))
            line = (f"[kernels] scatter_rows_add {name} ({b},{s},{c})->({b},{n},{c}) {kind}: "
                    f"max error {float(err.max()):.3e}, relaunch bitwise equal, bitwise the "
                    f"CPU float32 plain version")
            if name in TIMED_SHAPES and b == BATCH and hi is None:
                flat = (idx + torch.arange(b, device=idx.device)[:, None] * n).reshape(-1)
                rows = dout.reshape(b * s, c)
                case = _in_turns(
                    lambda: kernels.scatter_rows_add_cuda(dout, idx, n),
                    lambda: plain(dout, idx, n),
                    lambda: torch.zeros((b * n, c), device=dout.device).index_add_(0, flat, rows))
                case.update(_bound(dout.numel() * 4 + idx.numel() * 8 + got.numel() * 4,
                                   float(dout.numel())))
                case["shape"] = f"{name} ({b},{s},{c})->({b},{n},{c})"
                timed.append(case)
                line += "; " + _fmt(case)
            print(line, flush=True)
    # bf16: float32 accumulation, one rounding at the end, also where the
    # positions take more than one of the kernel's chunks (sa2's S = 4096)
    for b, n, c, s, hi in ((4, 50, 64, 300, 40), (BATCH, 256, 64, 4096, None)):
        dout, idx = _rows_case(rng, b, s, c, s, torch.bfloat16, hi=hi or n)
        got = kernels.scatter_rows_add_cuda(dout, idx, n)
        again = kernels.scatter_rows_add_cuda(dout, idx, n)
        want = plain(dout.double(), idx, n, torch.float64)
        torch.cuda.synchronize()
        tag = f"[kernels] scatter_rows_add bf16 ({b},{s},{c})->({b},{n},{c})"
        if not bool(((got.double() - want).abs() <= 2.0 ** -8 * want.abs() + 1e-4).all()):
            raise AssertionError(f"{tag} is outside one bf16 rounding")
        if not torch.equal(got, again):
            raise AssertionError(f"{tag}: two launches differ")
        if not torch.equal(got.cpu(), plain(dout.cpu(), idx.cpu(), n)):
            raise AssertionError(f"{tag} differs from the plain version on the CPU")
        print(f"{tag}: within one rounding of the float64 sum, relaunch bitwise equal, bitwise "
              f"the CPU plain version", flush=True)
    # indices outside [0, n) are skipped; a dout view 4 bytes off a 16-byte
    # boundary takes the kernel's 4-byte units
    store = torch.from_numpy(rng.randn(1 + 2 * 300 * 8).astype(np.float32)).cuda()
    dout = store[1:].view(2, 300, 8)
    idx = torch.from_numpy(rng.randint(-3, 23, (2, 300))).cuda()
    got = kernels.scatter_rows_add_cuda(dout, idx, 20)
    keep = ((idx >= 0) & (idx < 20)).cpu()
    want = plain(dout.cpu() * keep[..., None], idx.cpu().clamp(0, 19), 20)
    torch.cuda.synchronize()
    if not torch.equal(got.cpu(), want):
        raise AssertionError("[kernels] scatter_rows_add: out-of-range indices or a misaligned "
                             "view differ from the CPU plain version")
    print("[kernels] scatter_rows_add out-of-range indices, misaligned view (2,300,8)->(2,20,8): "
          "bitwise the CPU plain version", flush=True)
    # torch.sort(stable=True) decides kNN / 3-NN ties by index: confirm on the card
    d = torch.from_numpy(np.repeat(rng.rand(4, 8, 16).astype(np.float32), 4, -1)).cuda()
    if not torch.equal(torch.sort(d, dim=-1, stable=True).indices.cpu(),
                       torch.sort(d.cpu(), dim=-1, stable=True).indices):
        raise AssertionError("[kernels] torch.sort(stable=True) is not stable on the card")
    return {"max_abs_err": max_err, **_headline(timed), "cases": timed}


def _index_points_library(points, idx):
    """index_points as one torch.gather: the yardstick, used nowhere in the port."""
    b, _, c = points.shape
    flat = idx.reshape(b, -1).long()
    return torch.gather(points, 1, flat[..., None].expand(-1, -1, c)).reshape(*idx.shape, c)


def phase_index_points_host(turns: int = 4, rounds: int = 100) -> dict:
    """What one index_points call costs the host on the tracking path: the 11
    shapes of a HandTrackNet forward at batch 1 (FORWARD_GATHERS), under
    inference mode as the trackers run them, on the kernel and as one
    torch.gather, in turns (kernel, gather, gather, kernel, ...), `rounds`
    passes over the 11 a turn, launched without waiting for the card."""
    from hotrack_tpu_torch.ops.pointops import index_points
    rng = np.random.RandomState(5)
    calls = [(torch.from_numpy(rng.randn(1, n, c).astype(np.float32)).cuda(),
              torch.from_numpy(rng.randint(0, n, (1, s))).cuda())
             for _, n, c, s in FORWARD_GATHERS]
    us = {"kernel": [], "torch.gather": []}
    with torch.inference_mode():
        for turn in range(turns):
            order = ("kernel", "torch.gather") if turn % 2 == 0 else ("torch.gather", "kernel")
            for which in order:
                fn = index_points if which == "kernel" else _index_points_library
                for pts, idx in calls:
                    fn(pts, idx)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(rounds):
                    for pts, idx in calls:
                        fn(pts, idx)
                us[which].append(1e6 * (time.perf_counter() - t0) / (rounds * len(calls)))
                torch.cuda.synchronize()
    out = {"kernel_us": us["kernel"], "gather_us": us["torch.gather"],
           "ratio": float(np.median(us["kernel"]) / np.median(us["torch.gather"]))}
    print(f"[host] index_points us a call, inference mode, tracking shapes (batch 1), in "
          f"turns: kernel {[round(x, 2) for x in out['kernel_us']]}, torch.gather "
          f"{[round(x, 2) for x in out['gather_us']]}; kernel / gather {out['ratio']:.3f}",
          flush=True)
    return out


def _random_sdf(rng, widths, clamp=0.05, freqs=None, device="cuda"):
    """A seeded DistilledSDF of the given layer widths (features first), with
    He-scaled weights and an output layer sized so that about a quarter of
    the values reach the clamp: the clamp is exercised and does not hide the
    arithmetic."""
    from hotrack_tpu_torch.sdf.distill import DistilledSDF
    n_freqs = (widths[0] - 3) // 6
    dims = [*widths, 1]
    ws = [rng.randn(dims[i], dims[i + 1]).astype(np.float32) * np.sqrt(2.0 / dims[i])
          for i in range(len(dims) - 1)]
    ws[-1] *= 0.05
    bs = [rng.randn(dims[i + 1]).astype(np.float32) * 0.02 for i in range(len(dims) - 1)]
    if freqs is None:
        freqs = np.pi * 2.0 ** np.arange(n_freqs)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return DistilledSDF(tuple(t(w) for w in ws), tuple(t(b) for b in bs), t(freqs),
                        t(5.0), t(clamp))


def _mlp_ops(widths, points: int) -> float:
    """float32 operations of the MLP on `points` points: a multiply and an
    add for every weight."""
    dims = [*widths, 1]
    return 2.0 * points * sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))


def _matmul_chain(model, feats, chunk=1 << 18):
    """The yardstick beside the SDF kernels: the layers alone as library
    matrix products (addmm + relu) on features that are already in device
    memory, a chunk of points at a time. No features, no transform, no
    reduction: less than the function, and used nowhere in the port."""
    last = len(model.weights) - 1
    for lo in range(0, feats.shape[0], chunk):
        h = feats[lo:lo + chunk]
        for i, (w, b) in enumerate(zip(model.weights, model.biases)):
            h = torch.addmm(b, h, w)
            if i < last:
                h = torch.relu_(h)


def _ptxas_report(name: str) -> list:
    """The compiler's resource lines for csrc/<name>.cu's kernels: registers,
    shared memory, spills, and any wgmma serialisation it reported."""
    from hotrack_tpu_torch.ops import kernels
    with open(str(kernels.build(name)) + ".log") as f:
        return [ln.strip() for ln in f.read().splitlines()
                if any(k in ln for k in ("registers", "spill", "wgmma", "rror"))]


def _sdf_checks(tag: str, got, again, want, emu, scale: float = 1.0) -> float:
    """A 3xTF32 SDF kernel's values against the plain version and the 3xTF32
    emulation, each within TC_SDF_ATOL a value (times `scale` where the clamp
    lets values grow past 0.05), and a second launch bitwise the first.
    Returns the larger error."""
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"[kernels] {tag}: shape {tuple(got.shape)} or non-finite values")
    if not torch.equal(got, again):
        raise AssertionError(f"[kernels] {tag}: two launches differ")
    err, emu_err = float((got - want).abs().max()), float((got - emu).abs().max())
    if max(err, emu_err) > TC_SDF_ATOL * scale:
        raise AssertionError(f"[kernels] {tag}: max error {err:.3e}, against the 3xTF32 "
                             f"emulation {emu_err:.3e} > {TC_SDF_ATOL * scale:.3e}")
    return max(err, emu_err)


def _sdf_timed(case: dict, widths, m: int) -> str:
    """The timed case's bound (3xTF32: the kernel's arithmetic) and rate."""
    ops = _mlp_ops(widths, m)
    case["tflops"] = ops / case["ms"] / 1e9
    line = f"; {_fmt(case)}; {case['tflops']:.1f} TFLOP/s of float32-class MLP"
    if "matmul_chain_ms" in case:
        line += f"; matmul chain {case['matmul_chain_ms']:.4f} ms"
    return line


def _chain_feats(model, pts_cf, m: int):
    """Ready features for the matmul-chain yardstick: the first 2^18 points'
    repeated up to m."""
    from hotrack_tpu_torch.ops.sdf_mlp import fourier_features
    feats = fourier_features(pts_cf.transpose(-1, -2).reshape(-1, 3)[:1 << 18],
                             model.freqs, model.scale)
    return feats.repeat(-(-m // feats.shape[0]), 1)[:m].contiguous()


def phase_kernels_sdf_mlp() -> dict:
    """SDF MLP kernel vs plain version and vs its 3xTF32 emulation on the
    card, |diff| <= TC_SDF_ATOL a value (with the clamp at 0.05 and, so that
    no value hides behind it, at 1e3 with the bound scaled to the values), a
    second launch bitwise the first. No single PyTorch call computes the
    function: library_ms is null, and the matmul chain's time is printed as a
    yardstick."""
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.ops.sdf_mlp import (_sdf_mlp_torch, fused_sdf_mlp, fused_sdf_mlp_cf,
                                               pack_distilled)
    from hotrack_tpu_torch.ops.tf32 import raw_sdf_mlp_3xtf32
    print("[kernels] sdf_mlp ptxas: " + " | ".join(_ptxas_report("sdf_mlp")), flush=True)
    rng = np.random.RandomState(3)
    cases = [((f"object path, composed route {shape}" if cf else
               f"hand path, separate route {shape}"), MLP_WIDTHS, shape, cf, None, True)
             for shape, cf in SDF_MLP_SHAPES]
    cases += [
        ("config's 256 points (2048,3,256)", MLP_WIDTHS, (OBJ_PARTICLES, 3, 256), True, None, True),
        ("channels-last, ragged round (37,3)", MLP_WIDTHS, (37, 3), False, None, False),
        ("channels-last batch (4,300,3)", MLP_WIDTHS, (4, 300, 3), False, None, False),
        *[(f"about a round ({m},3)", MLP_WIDTHS, (m, 3), False, None, False)
          for m in (63, 64, 65, 127, 129)],
        ("6 frequencies, depth 4 (3,3,1000)", (39, 128, 128, 128, 128), (3, 3, 1000), True,
         None, False),
        ("depth 8 at width 128 (2,3,700)", (21,) + (128,) * 8, (2, 3, 700), True, None, False),
        ("non-geometric frequencies, narrow (5,3,129)", (15, 32, 48), (5, 3, 129), True,
         [1.0, 2.5], False),
        ("depth 1 (2,3,64)", (9, 128), (2, 3, 64), True, None, False),
    ]
    max_err, timed = 0.0, []
    for name, widths, shape, cf, freqs, is_timed in cases:
        for clamp in (0.05, 1e3):
            model = _random_sdf(rng, widths, clamp, freqs)
            pts = torch.from_numpy((rng.randn(*shape) * 0.08).astype(np.float32)).cuda()
            pts_cf = pts if cf else pts.transpose(-1, -2)
            fn = fused_sdf_mlp_cf if cf else fused_sdf_mlp
            got, again = fn(model, pts), fn(model, pts)
            want = _sdf_mlp_torch(model, pts_cf)
            emu = _sdf_mlp_torch(model, pts_cf, mlp=raw_sdf_mlp_3xtf32)
            torch.cuda.synchronize()
            scale = max(1.0, float(want.abs().max()) / 0.05)
            err = _sdf_checks(f"sdf_mlp {name} clamp {clamp}", got, again, want, emu, scale)
            line = (f"[kernels] sdf_mlp {name} clamp {clamp}: max error {err:.3e} against the "
                    f"plain version and the 3xTF32 emulation (bound {TC_SDF_ATOL * scale:.1e}, "
                    f"largest |value| {float(want.abs().max()):.3f}")
            if clamp == 0.05:
                max_err = max(max_err, err)
                line += f", {100 * float((want.abs() >= clamp).float().mean()):.0f}% at the clamp"
            line += "); relaunch bitwise equal"
            if is_timed and clamp == 0.05:
                packed = pack_distilled(model)
                m = pts.numel() // 3
                feats = _chain_feats(model, pts_cf, m)
                case = _in_turns(lambda: kernels.sdf_mlp_cuda(pts, packed, cf),
                                 lambda: _sdf_mlp_torch(model, pts_cf), None, reps=10)
                case["matmul_chain_ms"] = _time_ms(lambda: _matmul_chain(model, feats), 3)
                del feats
                case.update(_bound(16.0 * m + 4 * packed.wg.numel(), 0.0, _mlp_ops(widths, m),
                                   tensor_cores=True))
                case["shape"] = name
                timed.append(case)
                line += _sdf_timed(case, widths, m)
            print(line, flush=True)
    return {"max_abs_err": max_err, **_headline(timed), "cases": timed}


def phase_kernels_obj_energy() -> dict:
    """Fused object energy kernel vs plain version and vs its 3xTF32
    emulation (ops/tf32.py) on the card: every sum within ENERGY_RTOL of its
    size (+ ENERGY_ATOL a point) of both, and a second launch bitwise equal
    to the first. No single PyTorch call computes the function: library_ms
    is null."""
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.ops.obj_energy import (_obj_sdf_energy_torch,
                                                  fused_obj_sdf_energy, obj_rts)
    from hotrack_tpu_torch.ops.sdf_mlp import fourier_features, pack_distilled
    from hotrack_tpu_torch.ops.tf32 import raw_sdf_mlp_3xtf32
    from hotrack_tpu_torch.pose.rotations import normalize_quat, unit_quaternion_to_matrix
    rng = np.random.RandomState(4)
    cases = [(f"object path ({p},{n})", MLP_WIDTHS, p, n, None, True)
             for p, n in OBJ_ENERGY_SHAPES]
    cases += [
        ("config's 256 points (2048,256)", MLP_WIDTHS, OBJ_PARTICLES, 256, None, True),
        ("odd P and N (2047,1000)", MLP_WIDTHS, 2047, 1000, None, False),
        ("small, ragged tile (10,200)", MLP_WIDTHS, 10, 200, None, False),
        ("one candidate, one point (1,1)", MLP_WIDTHS, 1, 1, None, False),
        ("one point each (4096,1)", MLP_WIDTHS, 4096, 1, None, False),
        ("non-geometric frequencies, narrow (33,129)", (15, 32, 48), 33, 129, [1.0, 2.5],
         False),
        ("6 frequencies, depth 4: layers staged (7,129)", (39, 128, 128, 128, 128), 7, 129,
         None, False),
        ("depth 1 (5,100)", (9, 128), 5, 100, None, False),
    ]
    max_err, timed = 0.0, []
    for name, widths, p, n, freqs, is_timed in cases:
        model = _random_sdf(rng, widths, 0.05, freqs)
        pcld_cf = torch.from_numpy((rng.randn(3, n) * 0.06).astype(np.float32)).cuda()
        quat = normalize_quat(torch.from_numpy(rng.randn(p, 4).astype(np.float32)).cuda())
        rot = unit_quaternion_to_matrix(quat)
        trans = torch.from_numpy((rng.randn(p, 3) * 0.03).astype(np.float32)).cuda()
        got = fused_obj_sdf_energy(model, pcld_cf, rot, trans)
        again = fused_obj_sdf_energy(model, pcld_cf, rot, trans)
        rts = obj_rts(rot, trans).contiguous()
        want = _obj_sdf_energy_torch(model, pcld_cf, rts)
        emu = _obj_sdf_energy_torch(model, pcld_cf, rts, 1 << 16, raw_sdf_mlp_3xtf32)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"[kernels] obj_sdf_energy {name}: two launches differ")
        if got.shape != (p,) or not torch.isfinite(got).all():
            raise AssertionError(f"[kernels] obj_sdf_energy {name}: shape {tuple(got.shape)}")
        err, emu_err = (got - want).abs(), (got - emu).abs()
        rel = float((err / want.abs().clamp(min=1e-12)).max())
        emu_rel = float((emu_err / emu.abs().clamp(min=1e-12)).max())
        max_err = max(max_err, float(err.max()))
        if not bool((err <= ENERGY_RTOL * want.abs() + ENERGY_ATOL * n).all()
                    and (emu_err <= ENERGY_RTOL * emu.abs() + ENERGY_ATOL * n).all()):
            raise AssertionError(f"[kernels] obj_sdf_energy {name}: max error "
                                 f"{float(err.max()):.3e} (relative {rel:.3e}), against the "
                                 f"3xTF32 emulation {float(emu_err.max()):.3e} ({emu_rel:.3e})")
        line = (f"[kernels] obj_sdf_energy {name}: max error {float(err.max()):.3e} of sums "
                f"near {float(want.mean()):.3f} (relative {rel:.3e}, bound {ENERGY_RTOL}); "
                f"against the 3xTF32 emulation {float(emu_err.max()):.3e} (relative "
                f"{emu_rel:.3e}); relaunch bitwise equal")
        if is_timed:
            packed = pack_distilled(model)
            m = p * n
            feats = fourier_features(torch.from_numpy(
                (rng.randn(1 << 18, 3) * 0.08).astype(np.float32)).cuda(),
                model.freqs, model.scale)
            feats = feats.repeat(-(-m // feats.shape[0]), 1)[:m].contiguous()
            case = _in_turns(lambda: kernels.obj_sdf_energy_cuda(pcld_cf, rts, packed),
                             lambda: _obj_sdf_energy_torch(model, pcld_cf, rts), None, reps=10)
            case["matmul_chain_ms"] = _time_ms(lambda: _matmul_chain(model, feats), 3)
            del feats
            ops = _mlp_ops(widths, m)
            case.update(_bound(12.0 * n + 48.0 * p + 4.0 * p + 4 * packed.tc.numel(), 0.0, ops,
                               tensor_cores=True))
            case["shape"] = name
            timed.append(case)
            line += (f"; {_fmt(case)}; matmul chain {case['matmul_chain_ms']:.4f} ms; "
                     f"{ops / case['ms'] / 1e9:.1f} TFLOP/s of float32-class MLP")
        print(line, flush=True)
    return {"max_abs_err": max_err, **_headline(timed), "cases": timed}


def _write_checkpoint(cfg) -> str:
    from hotrack_tpu_torch.train.run_hand_track import build_handnet
    from hotrack_tpu_torch.utils.convert import save_reference_checkpoint
    net = build_handnet(cfg, "cpu")
    with torch.no_grad():
        net.final_mlp[2].weight.mul_(HEAD_SCALE)
        net.final_mlp[2].bias.mul_(HEAD_SCALE)
    return save_reference_checkpoint(
        net, os.path.join(cfg["experiment_dir"], "ckpt", "model_0001.pt"))


def _require_launches(tag: str, launches: dict, want: dict) -> None:
    for name, least in want.items():
        if launches[name] < least:
            raise AssertionError(f"[{tag}] kernel {name} launched {launches[name]} "
                                 f"times on this path, expected >= {least}")


def phase_tracking_path(card: str, seen: dict) -> dict:
    from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.train.cli import load_config, test_main

    root = tempfile.mkdtemp(prefix="hotrack_smoke_")
    os.environ["HOTRACK_DATA_ROOT"] = root
    try:
        t0 = time.perf_counter()
        generate_simgrasp_dataset(root, num_instances=2, num_frames=NUM_FRAMES,
                                  points_per_part=POINTS_PER_PART)
        argv = ["--config", CONFIG, "--device", "cuda"]
        ckpt = _write_checkpoint(load_config(argv))
        print(f"[track] data + checkpoint {time.perf_counter() - t0:.1f} s: {ckpt}",
              flush=True)

        test_main(argv)  # warm-up sequence
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        with noting_shapes(seen):
            avg, stats = test_main(argv)
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
        peak = torch.cuda.max_memory_allocated()

        seq = stats["sequences"][0]
        pred = seq["pred_kp"]
        if pred.shape != (NUM_FRAMES, 21, 3) or not np.isfinite(pred).all():
            raise AssertionError(f"[track] pred_kp shape {pred.shape}, finite "
                                 f"{bool(np.isfinite(pred).all())}")
        if not all(math.isfinite(v) for v in avg.values()):
            raise AssertionError(f"[track] non-finite metrics {avg}")
        _require_launches("track", launches, {
            "fps": PER_PREPARE + FPS_PER_FORWARD * NUM_FRAMES,
            "gather_rows": PER_PREPARE + GATHERS_PER_FORWARD * NUM_FRAMES})
        ms_frame = 1000.0 * stats["net_seconds"] / stats["n_frames"]
        prep_ms = 1000.0 * stats["data_seconds"]
        print(f"[track] cuda: {stats['n_frames']} frames, tracking {ms_frame:.3f} "
              f"ms/frame (data preparation excluded: {prep_ms:.1f} ms for the "
              f"sequence), peak memory {peak / 2**20:.1f} MiB, launches {launches}, "
              f"metrics {avg} | {card}", flush=True)

        cpu_avg, cpu_stats = test_main(["--config", CONFIG, "--device", "cpu"])
        cpu_seq = cpu_stats["sequences"][0]
        for key in ("hand_idx0", "obj_idx0"):
            if not np.array_equal(cpu_seq[key], seq[key]):
                raise AssertionError(f"[track] frame-0 FPS indices ({key}) differ "
                                     f"between cuda and cpu")
        diff = np.abs(cpu_seq["pred_kp"] - pred).reshape(NUM_FRAMES, -1).max(1)
        print(f"[track] cpu vs cuda: frame-0 FPS indices identical; max |pred_kp| "
              f"diff {diff.max():.3e} m (frame 0 {diff[0]:.3e}, frame "
              f"{NUM_FRAMES - 1} {diff[-1]:.3e}; bound {PRED_KP_BOUND_M} m); "
              f"cpu MPJPE {cpu_avg['hand_pred_kp_diff']:.6f} vs cuda "
              f"{avg['hand_pred_kp_diff']:.6f} m", flush=True)
        if not diff.max() <= PRED_KP_BOUND_M:
            raise AssertionError(f"[track] cuda vs cpu pred_kp differ by "
                                 f"{diff.max():.3e} m > {PRED_KP_BOUND_M} m")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _to_device(tree, device, dtype=torch.float32):
    """The batch on `device`, its floating-point tensors as `dtype`."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device, dtype) for k, v in tree.items()}
    return tree.to(device, dtype if tree.is_floating_point() else None)


def _plain_index_points(points, idx):
    """index_points on the plain row gather, whose backward is PyTorch's own."""
    from hotrack_tpu_torch.ops.pointops import _gather_rows_torch
    b, _, c = points.shape
    return _gather_rows_torch(points, idx.reshape(b, -1)).reshape(*idx.shape, c)


def _step_gradients(cfg, batch, device: str, plain: bool = False,
                    dtype: torch.dtype = torch.float32) -> dict:
    """Forward + backward of the seeded initial weights on `batch`, dropout
    off. With plain=True the model's FPS and index_points are the kernels'
    plain PyTorch versions (on a CUDA tensor: no kernel runs). Records the
    indices index_points was given and the FPS indices."""
    from hotrack_tpu_torch.nn import pointnet2
    from hotrack_tpu_torch.ops import pointops
    from hotrack_tpu_torch.train.trainer import Trainer, summarize_losses

    trainer = Trainer(cfg, device)  # seeded: the same weights every time
    trainer.model.to(dtype)
    for m in trainer.model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    trainer.model.train()
    fps_idx, group_idx = [], []
    fps = pointops._farthest_point_sample_torch if plain else pointops.farthest_point_sample
    gather = _plain_index_points if plain else pointops.index_points

    def recording_fps(xyz, npoint, valid_mask=None):
        fps_idx.append(fps(xyz, npoint, valid_mask).cpu())
        return fps_idx[-1].to(xyz.device)

    def recording_gather(points, idx):
        group_idx.append(idx.cpu().long())
        return gather(points, idx)

    pointnet2.farthest_point_sample, pointnet2.index_points = recording_fps, recording_gather
    try:
        total, _ = summarize_losses(
            trainer._losses(_to_device(batch, device, dtype)), trainer.loss_weights)
        total.backward()
    finally:
        pointnet2.farthest_point_sample = pointops.farthest_point_sample
        pointnet2.index_points = pointops.index_points
    return {"loss": float(total.detach()), "picks": fps_idx + group_idx,
            "grads": {k: None if p.grad is None else p.grad.detach().cpu()
                      for k, p in trainer.model.named_parameters()}}


def _picks_differ(a: dict, b: dict) -> int:
    """How many index picks (FPS, neighbourhoods, 3-NN) differ between two steps."""
    return sum(int((x != y).sum()) for x, y in zip(a["picks"], b["picks"], strict=True))


def _worst_gradient(got: dict, want: dict):
    """(largest |dg|_inf / (|g|_inf + floor) over the live parameters, its
    name, cosine of the two whole gradients)."""
    worst, dot, n2a, n2b = (0.0, ""), 0.0, 0.0, 0.0
    for k, g in want.items():
        if (g is None) != (got[k] is None):
            raise AssertionError(f"[train] {k} has a gradient in one run only")
        if g is None:
            continue
        if not torch.isfinite(got[k]).all():
            raise AssertionError(f"[train] non-finite gradient of {k}")
        dot += float((got[k].double() * g.double()).sum())
        n2a += float(got[k].double().pow(2).sum())
        n2b += float(g.double().pow(2).sum())
        if not re.search(DEAD_BIAS, k):
            err = float((got[k] - g).abs().max())
            worst = max(worst, (err / (float(g.abs().max()) + STEP_GRAD_FLOOR), k))
    return worst[0], worst[1], dot / math.sqrt(n2a * n2b)


def _one_step_checks(cfg) -> None:
    """One train step (forward + backward, dropout off) of the same initial
    weights on the same prepared batch (prepared once on the CPU, copied):
    on the card with the kernels, on the card with their plain versions, and
    in float64 on the card and on the CPU."""
    from hotrack_tpu_torch.data import get_dataloader
    from hotrack_tpu_torch.train.cli import prepare
    from hotrack_tpu_torch.train.trainer import Trainer

    raw, _ = next(iter(get_dataloader(cfg, "train")))
    batch = prepare(Trainer(cfg, "cpu"), raw, torch.Generator().manual_seed(0), cfg)
    card = _step_gradients(cfg, batch, "cuda")
    card_again = _step_gradients(cfg, batch, "cuda")
    card_plain = _step_gradients(cfg, batch, "cuda", plain=True)

    frozen = sorted(k for k, g in card["grads"].items() if g is None)
    if not frozen or not all(k.startswith(("transt.s12.", "transt.c12.")) for k in frozen):
        raise AssertionError(f"[train] unexpected parameters without gradient: {frozen}")

    # the scatter-add sums in a fixed order, so a second step on the card
    # gives bitwise the same gradients (the plain versions' atomics do not)
    moved = sorted(k for k, g in card["grads"].items()
                   if g is not None and not torch.equal(g, card_again["grads"][k]))
    if moved or card["loss"] != card_again["loss"]:
        raise AssertionError(f"[train] two steps on the card differ bitwise in {moved}")
    print(f"[train] two steps on the card with the kernels: all "
          f"{len(card['grads']) - len(frozen)} gradients bitwise equal", flush=True)

    # kernels vs their plain versions inside the step, on the card: the same
    # FPS indices and bitwise the same gathers give bitwise the same forward;
    # the gradients differ only by the order of float32 sums in the gather's
    # adjoint (the kernel's fixed order against index_add_'s atomics)
    worst, where, cos = _worst_gradient(card["grads"], card_plain["grads"])
    print(f"[train] one step on the card, kernels vs plain versions: total_loss "
          f"{card['loss']:.7f} vs {card_plain['loss']:.7f}; worst gradient {worst:.2e} "
          f"of its max at {where} (bound {STEP_GRAD_BOUND}); cosine {cos:.8f}", flush=True)
    if card["loss"] != card_plain["loss"] or worst > STEP_GRAD_BOUND \
            or _picks_differ(card, card_plain):
        raise AssertionError("[train] the step with the kernels differs from the step "
                             "with their plain versions")

    # card vs CPU in float64, plain versions: the same function on both
    card64 = _step_gradients(cfg, batch, "cuda", plain=True, dtype=torch.float64)
    cpu64 = _step_gradients(cfg, batch, "cpu", dtype=torch.float64)
    worst, where, _ = _worst_gradient(card64["grads"], cpu64["grads"])
    rel = abs(card64["loss"] - cpu64["loss"]) / abs(cpu64["loss"])
    flips = _picks_differ(card64, cpu64)
    print(f"[train] one step in float64, plain versions, card vs cpu: {flips} index "
          f"picks differ; total_loss {card64['loss']:.12f} vs {cpu64['loss']:.12f} "
          f"(relative {rel:.2e}, bound {F64_LOSS_RTOL}); worst gradient {worst:.2e} of "
          f"its max at {where} (bound {F64_GRAD_BOUND})", flush=True)
    if flips or rel > F64_LOSS_RTOL or worst > F64_GRAD_BOUND:
        raise AssertionError("[train] card vs cpu in float64 differ")


def phase_train_path(card: str, seen: dict) -> dict:
    from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.train.cli import load_config, test_main, train_main

    root = tempfile.mkdtemp(prefix="hotrack_smoke_train_")
    os.environ["HOTRACK_DATA_ROOT"] = root
    try:
        t0 = time.perf_counter()
        generate_simgrasp_dataset(root, num_instances=3, num_frames=TRAIN_FRAMES,
                                  points_per_part=POINTS_PER_PART)
        print(f"[train] data {time.perf_counter() - t0:.1f} s", flush=True)
        argv = ["--config", TRAIN_CONFIG, "--device", "cuda", "--epochs", "1"]

        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        with noting_shapes(seen):
            trainer = train_main(argv)
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
        peak = torch.cuda.max_memory_allocated()

        cfg, hist = trainer.cfg, trainer.history[0]
        steps = len(hist["step_seconds"])
        n_test = -(-TRAIN_FRAMES // BATCH)
        if (cfg["num_points"], cfg["batch_size"], cfg["network"]["backbone_out_dim"]) \
                != (512, BATCH, 384) or steps != -(-2 * TRAIN_FRAMES // BATCH):
            raise AssertionError(f"[train] not the full-width config: {steps} steps")
        for split in ("train", "test"):
            bad = {k: v for k, v in hist[split].items() if not math.isfinite(v)}
            if bad:
                raise AssertionError(f"[train] non-finite {split} losses {bad}")
        _require_launches("train", launches, {
            "fps": (steps + n_test) * (PER_PREPARE + FPS_PER_FORWARD),
            "gather_rows": (steps + n_test) * (PER_PREPARE + GATHERS_PER_FORWARD),
            "scatter_rows_add": steps * SCATTERS_PER_BACKWARD})
        full = np.array(hist["step_seconds"][1:-1])  # not the first, not the ragged tail
        prep = np.array(hist["data_seconds"][1:-1])
        ms_step = 1000.0 * float(np.median(full))
        print(f"[train] cuda: {steps} steps of batch {BATCH} (tail "
              f"{2 * TRAIN_FRAMES % BATCH}) + {n_test} test batches; step "
              f"{ms_step:.3f} ms (median of steps 2-{steps - 1}; first step "
              f"{1000 * hist['step_seconds'][0]:.1f} ms), {BATCH / ms_step * 1e3:.1f} "
              f"samples/s, batch preparation {1000 * float(np.median(prep)):.3f} ms, "
              f"peak memory {peak / 2**20:.1f} MiB, launches {launches}, train "
              f"total_loss {hist['train']['total_loss']:.5f}, test MPJPE "
              f"{hist['test']['hand_pred_kp_diff']:.5f} m | {card}", flush=True)

        _one_step_checks(load_config(argv, "train"))

        # the test entry tracks with the checkpoint that training wrote
        with noting_shapes(seen):
            avg, stats = test_main(["--config", CONFIG, "--device", "cuda",
                                    "--experiment_dir",
                                    os.path.basename(cfg["experiment_dir"]),
                                    "--resume_epoch", "1"])
        pred = stats["sequences"][0]["pred_kp"]
        if pred.shape != (TRAIN_FRAMES, 21, 3) or not np.isfinite(pred).all():
            raise AssertionError(f"[train] tracking with the trained checkpoint: "
                                 f"pred_kp {pred.shape}")
        print(f"[train] test entry tracked {stats['n_frames']} frames with "
              f"{cfg['experiment_dir']}/ckpt/model_0001.pt: MPJPE "
              f"{avg['hand_pred_kp_diff']:.5f} m", flush=True)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _pose_gap(a: dict, b: dict):
    """Per frame: the angle between two runs' rotations (degrees) and the
    distance between their translations (m)."""
    # the angle of Ra Rb^T from its skew part: exact for small angles, where
    # the trace's arccos loses everything below 0.03 degrees in float32
    m = np.einsum("tij,tkj->tik", a["rotation"].astype(np.float64),
                  b["rotation"].astype(np.float64))
    skew = 0.5 * np.stack([m[:, 2, 1] - m[:, 1, 2], m[:, 0, 2] - m[:, 2, 0],
                           m[:, 1, 0] - m[:, 0, 1]], axis=1)
    cos = (np.trace(m, axis1=1, axis2=2) - 1.0) / 2.0
    angle = np.degrees(np.arctan2(np.linalg.norm(skew, axis=1), cos))
    return angle, np.linalg.norm(
        (a["translation"].astype(np.float64) - b["translation"])[:, :, 0], axis=1)


def _hold_closed_loop(tag: str, rot: np.ndarray, trans: np.ndarray) -> None:
    """Two closed-loop runs, held to the tracker's own accuracy."""
    print(f"[object] {tag}, closed loop: rotation gap per frame "
          f"{np.array2string(rot, precision=5)} deg, translation gap "
          f"{np.array2string(1e3 * trans, precision=5)} mm; bounds {RUN_ROT_BOUND_DEG} deg / "
          f"{1e3 * RUN_TRANS_BOUND_M} mm", flush=True)
    if rot.max() > RUN_ROT_BOUND_DEG or trans.max() > RUN_TRANS_BOUND_M:
        raise AssertionError(f"[object] {tag}: the closed-loop poses differ beyond the bound")


def _open_loop(seq: dict, bank: np.ndarray, fit, frames: int, device: str, energy: str):
    """Every one of the first `frames` frames of the card's fused run `seq`
    again, from that run's own previous pose, on `device` by route `energy`.
    Returns the frames' iteration-0 energies (frames, P) and poses."""
    from hotrack_tpu_torch.opt import optimize_obj_pose
    from hotrack_tpu_torch.ops.sdf_mlp import pack_distilled
    from hotrack_tpu_torch.sdf.distill import distilled_to
    model = distilled_to(fit, device)
    packed = pack_distilled(model) if device == "cuda" else None
    particles = torch.from_numpy(bank).to(device)
    energies, rots, transs = [], [], []
    for f in range(frames):
        r0 = seq["init_rotation"] if f == 0 else seq["rotation"][f - 1]
        t0 = seq["init_translation"] if f == 0 else seq["translation"][f - 1]
        trace = []
        r, t, _ = optimize_obj_pose(
            None, particles, torch.from_numpy(seq["obj_points"][f]).to(device),
            torch.from_numpy(r0).to(device), torch.from_numpy(t0).to(device),
            distilled=model, obj_energy=energy, packed=packed, trace=trace)
        energies.append(trace[0][0].cpu().numpy())
        rots.append(r.cpu().numpy()), transs.append(t.cpu().numpy())
    return np.stack(energies), {"rotation": np.stack(rots), "translation": np.stack(transs)}


def _hold_open_loop(tag: str, seq: dict, bank, fit, frames: int, device: str,
                    energy: str, tight_share: float = OPEN_TIGHT_SHARE,
                    sdf_atol: float = OPEN_SDF_ATOL_M) -> None:
    """The card's fused route against (`device`, `energy`), frame by frame
    from the same start; the mean |sdf| within `sdf_atol`."""
    e_ref, p_ref = _open_loop(seq, bank, fit, frames, "cuda", "fused")
    # the reference is the main run once more: bitwise, as no sum on its way
    # depends on the launch
    if not (np.array_equal(p_ref["rotation"], seq["rotation"][:frames])
            and np.array_equal(p_ref["translation"], seq["translation"][:frames])):
        raise AssertionError(f"[object] {tag}: the fused route run again from the same "
                             f"poses does not give the same poses bitwise")
    e_got, p_got = _open_loop(seq, bank, fit, frames, device, energy)
    e_gap = np.abs(e_got - e_ref).max(axis=1) / 500.0  # of the mean |sdf|, metres
    rot, trans = _pose_gap(p_ref, p_got)
    tight = (rot <= OPEN_TIGHT_ROT_DEG) & (trans <= OPEN_TIGHT_TRANS_M)
    print(f"[object] {tag}, open loop over {frames} frames (the fused route again: bitwise "
          f"the same poses): the candidates' mean |sdf| of iteration 0 (smallest "
          f"{e_ref.min() / 500.0:.3e} m) differs by at most {e_gap.max():.3e} m (bound "
          f"{sdf_atol} m); pose gap after the frame: rotation "
          f"{np.array2string(rot, precision=2)} deg, translation "
          f"{np.array2string(1e3 * trans, precision=2)} mm; {int(tight.sum())} of {frames} "
          f"frames within {OPEN_TIGHT_ROT_DEG} deg / {1e3 * OPEN_TIGHT_TRANS_M} mm (at least "
          f"{tight_share:.0%} must be), all within {OPEN_ROT_BOUND_DEG} deg / "
          f"{1e3 * OPEN_TRANS_BOUND_M} mm", flush=True)
    if e_gap.max() > sdf_atol or tight.mean() < tight_share \
            or rot.max() > OPEN_ROT_BOUND_DEG or trans.max() > OPEN_TRANS_BOUND_M:
        raise AssertionError(f"[object] {tag}: open-loop energies or poses differ beyond "
                             f"the bound")


def _fit_rmse(model, device) -> tuple:
    """RMSE of the distilled fit against the trilinear interpolant of the
    201^3 analytic box volume it was fitted to, on seeded uniform points of
    the cube: over the near-surface band |sdf| < 0.02 m, and over all."""
    from hotrack_tpu_torch.sdf.assets import synthetic_box_sdf_setup
    from hotrack_tpu_torch.sdf.distill import distilled_to, eval_distilled_sdf
    from hotrack_tpu_torch.sdf.volume import trilinear_sdf
    from hotrack_tpu_torch.train.run_obj_track import VOLUME_SIZE, VOXEL_SCALE
    volume = synthetic_box_sdf_setup(VOLUME_SIZE, VOXEL_SCALE, device=device)
    pts = torch.from_numpy(np.random.RandomState(5).uniform(
        -0.12, 0.12, (400000, 3)).astype(np.float32)).to(device)
    want = trilinear_sdf(volume, pts, VOXEL_SCALE, VOLUME_SIZE,
                         bbox_min=-(VOLUME_SIZE // 2) * VOXEL_SCALE)
    got = eval_distilled_sdf(distilled_to(model, device), pts)
    near = want.abs() < 0.02
    sq = (got - want) ** 2
    return float(sq[near].mean().sqrt()), float(sq.mean().sqrt()), int(near.sum())


def _test_split_of(base: str, sequences: int) -> None:
    """Rewrite a generated set's split: the first `sequences` instances are
    the test split (one sequence each), the last the training split."""
    from hotrack_tpu_torch.data.simgrasp import split_dataset
    split_dataset(os.path.join(base, "splits", "bottle_sim", "seq"),
                  os.path.join(base, "preproc", "bottle_sim", "seq"),
                  [f"{i:05d}" for i in range(sequences)])


def _obj_dataset(frames: int, sequences: int = 1) -> str:
    from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset
    root = tempfile.mkdtemp(prefix=f"hotrack_smoke_obj{frames}_")
    base = generate_simgrasp_dataset(root, num_instances=sequences + 1, num_frames=frames,
                                     points_per_part=OBJ_POINTS_PER_PART)
    if sequences > 1:
        _test_split_of(base, sequences)
    return root


def _obj_run(root: str, seen: dict, device: str, distilled=None, extra=()):
    """One run of the object path on the data under `root`: through
    `test_main` when it distils itself, through `run_obj_tracking` with the
    weights carried over otherwise. Returns (sequence stats with the run's
    particle bank under 'particles', launches, ms/frame of tracking)."""
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.train.cli import load_config, test_main
    from hotrack_tpu_torch.train.run_obj_track import run_obj_tracking
    os.environ["HOTRACK_DATA_ROOT"] = root
    argv = ["--config", OBJ_CONFIG, "--device", device, "--num_points",
            str(OBJ_NUM_POINTS), *extra]
    kernels.reset_launch_counts()
    with noting_shapes(seen):
        if distilled is None:
            avg, stats = test_main(argv)
        else:
            avg, stats = run_obj_tracking(load_config(argv), distilled=[distilled])
    if device == "cuda":
        torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    seq = dict(stats["sequences"][0], particles=stats["particles"])
    frames = stats["n_frames"]
    if seq["rotation"].shape != (frames, 3, 3) or seq["translation"].shape != (frames, 3, 1) \
            or not (np.isfinite(seq["rotation"]).all() and np.isfinite(seq["translation"]).all()
                    and np.isfinite(seq["sdf_energy"]).all()):
        raise AssertionError(f"[object] {extra} on {device}: poses {seq['rotation'].shape}")
    if not all(math.isfinite(v) for v in avg.values()):
        raise AssertionError(f"[object] {extra} on {device}: non-finite metrics {avg}")
    return seq, launches, 1000.0 * stats["net_seconds"] / frames


def phase_object_path(card: str, seen: dict) -> dict:
    from hotrack_tpu_torch.pose.metrics import rot_diff_degree
    roots = {n: _obj_dataset(n) for n in (NUM_FRAMES, OBJ_SHORT_FRAMES, OBJ_CPU_FRAMES)}
    try:
        # the main run: 100 frames, distilled here, fused energy kernel
        torch.cuda.reset_peak_memory_stats()
        full, launches, ms_frame = _obj_run(roots[NUM_FRAMES], seen, "cuda",
                                            extra=("--sdf_query", "distilled"))
        peak = torch.cuda.max_memory_allocated()
        _require_launches("object", launches, {
            "obj_sdf_energy": OBJ_ITERATIONS * NUM_FRAMES, "fps": PER_PREPARE,
            "gather_rows": PER_PREPARE})
        if launches["obj_sdf_energy"] != OBJ_ITERATIONS * NUM_FRAMES or launches["sdf_mlp"]:
            raise AssertionError(f"[object] fused route launched {launches}")
        gt0 = torch.from_numpy(full["gt_rotation"][0])
        init_r = float(rot_diff_degree(gt0, torch.from_numpy(full["init_rotation"]), 1))
        init_t = float(np.linalg.norm(full["init_translation"] - full["gt_translation"][0]))
        rmse_near, rmse_all, n_near = _fit_rmse(full["distilled"], "cuda")
        print(f"[object] cuda, fused: {NUM_FRAMES} frames of {OBJ_PARTICLES} particles x "
              f"{OBJ_NUM_POINTS} points x {OBJ_ITERATIONS} iterations, tracking "
              f"{ms_frame:.3f} ms/frame; set-up {full['setup_seconds']:.2f} s of which "
              f"distillation (4000 steps of 8192) {full['distill_seconds']:.2f} s; fit RMSE "
              f"{1e3 * rmse_near:.4f} mm near the surface ({n_near} points with |sdf| < 20 mm), "
              f"{1e3 * rmse_all:.4f} mm over the cube; peak memory {peak / 2**20:.1f} MiB; "
              f"launches {launches}; jittered init {init_r:.3f} deg / {1e3 * init_t:.2f} mm -> "
              f"frame 0 {full['rdiff'][0]:.3f} deg / {1e3 * full['tdiff'][0]:.2f} mm, mean "
              f"{full['rdiff'].mean():.3f} deg / {1e3 * full['tdiff'].mean():.2f} mm, last "
              f"{full['rdiff'][-1]:.3f} deg / {1e3 * full['tdiff'][-1]:.2f} mm | {card}",
              flush=True)
        if not (full["tdiff"].mean() < init_t and full["tdiff"].max() < init_t
                and full["rdiff"].mean() < max(init_r, 1.0)):
            raise AssertionError("[object] the pose error did not fall from the jittered "
                                 "initialisation")

        # shorter runs with the same fit: fused, composed (kernel #3), volume
        fit = full["distilled"]
        short, l_fused, ms_fused = _obj_run(roots[OBJ_SHORT_FRAMES], seen, "cuda", fit,
                                            ("--sdf_query", "distilled"))
        comp, l_comp, ms_comp = _obj_run(roots[OBJ_SHORT_FRAMES], seen, "cuda", fit,
                                         ("--sdf_query", "distilled", "--obj_energy",
                                          "composed"))
        if l_comp["sdf_mlp"] != OBJ_ITERATIONS * OBJ_SHORT_FRAMES or l_comp["obj_sdf_energy"]:
            raise AssertionError(f"[object] composed route launched {l_comp}")
        d_rot, d_trans = _pose_gap(short, comp)
        print(f"[object] cuda, {OBJ_SHORT_FRAMES} frames: fused {ms_fused:.3f} ms/frame, "
              f"composed {ms_comp:.3f} ms/frame ({l_comp['sdf_mlp']} sdf_mlp launches)",
              flush=True)
        _hold_closed_loop("fused vs composed route on the card", d_rot, d_trans)
        _hold_open_loop("fused vs composed route on the card", short, short["particles"], fit,
                        OBJ_SHORT_FRAMES, "cuda", "composed")
        vol, l_vol, ms_vol = _obj_run(roots[OBJ_SHORT_FRAMES], seen, "cuda",
                                      extra=("--sdf_query", "volume"))
        if l_vol["sdf_mlp"] or l_vol["obj_sdf_energy"]:
            raise AssertionError(f"[object] volume route launched {l_vol}")
        v_rot, v_trans = _pose_gap(short, vol)
        print(f"[object] cuda, {OBJ_SHORT_FRAMES} frames, volume route (trilinear lookup, no "
              f"distillation): {ms_vol:.3f} ms/frame against the fused route's "
              f"{ms_fused:.3f}; errors against the ground truth: volume "
              f"{vol['rdiff'].mean():.3f} deg / {1e3 * vol['tdiff'].mean():.3f} mm, distilled "
              f"{short['rdiff'].mean():.3f} deg / {1e3 * short['tdiff'].mean():.3f} mm; pose "
              f"gap between them up to {v_rot.max():.3f} deg / {1e3 * v_trans.max():.3f} mm",
              flush=True)

        # card against CPU, same fit, a few frames
        few, _, ms_few = _obj_run(roots[OBJ_CPU_FRAMES], seen, "cuda", fit,
                                  ("--sdf_query", "distilled"))
        t0 = time.perf_counter()
        cpu, l_cpu, _ = _obj_run(roots[OBJ_CPU_FRAMES], seen, "cpu", fit,
                                 ("--sdf_query", "distilled"))
        if any(l_cpu.values()):
            raise AssertionError(f"[object] the CPU run launched kernels: {l_cpu}")
        c_rot, c_trans = _pose_gap(few, cpu)
        print(f"[object] cpu vs cuda, {OBJ_CPU_FRAMES} frames (cpu run "
              f"{time.perf_counter() - t0:.1f} s, card {ms_few:.3f} ms/frame); final "
              f"energies cuda {np.array2string(few['sdf_energy'], precision=7)} cpu "
              f"{np.array2string(cpu['sdf_energy'], precision=7)}", flush=True)
        _hold_closed_loop("card vs CPU (plain versions), same fit", c_rot, c_trans)
        _hold_open_loop("card vs CPU (plain versions), same fit", few, few["particles"], fit,
                        OBJ_CPU_FRAMES, "cpu", "fused", tight_share=1.0 / OBJ_CPU_FRAMES)
        return {"object": launches, "object_composed": l_comp}, fit
    finally:
        for root in roots.values():
            shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------------------
# the hand kernels and the hand paths

def _hand_ops(widths, points: int) -> float:
    """float32 operations of the per-vertex energy on `points` vertices: the
    MLP, the object-frame transform (9 products, 9 sums, 3 scalings) and the
    projection (2 quotients, 2 products, 2 sums)."""
    return _mlp_ops(widths, points) + 27.0 * points


def _seeded_mask(rng, hw):
    return torch.from_numpy(rng.rand(*hw) > 0.5).cuda()


def _seeded_frame(rng, hw):
    """A seeded object pose about the hand and intrinsics scaled to the image."""
    from hotrack_tpu_torch.ops.hand_energy import hand_frame
    from hotrack_tpu_torch.pose.rotations import normalize_quat, unit_quaternion_to_matrix
    quat = normalize_quat(torch.from_numpy(rng.randn(4).astype(np.float32)).cuda())
    trans = torch.tensor([0.01, -0.02, 0.45], device="cuda")
    h, w = hw
    return hand_frame(unit_quaternion_to_matrix(quat), trans, 600.0 * w / 640.0,
                      590.0 * h / 480.0, w / 2.0, h / 2.0)


def _camera_points(rng, shape):
    """Camera-frame vertices with z > 0.3 m, spread so that their pixels clip
    on all four edges of the image."""
    pts = rng.randn(*shape, 3).astype(np.float32) * np.float32(0.08)
    pts[..., :2] *= np.float32(4.0)
    pts[..., 2] = np.abs(pts[..., 2]) + np.float32(0.3)
    return torch.from_numpy(pts).cuda()


def phase_kernels_mask_lookup() -> dict:
    """Mask lookup kernel vs its plain version and vs `mask[iy, ix]`: exact.
    Library call: that indexing, on a float mask and int64 indices made
    beforehand."""
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.ops.mask_lookup import (_packed_mask_lookup_torch, pack_mask,
                                                   packed_mask_lookup)
    rng = np.random.RandomState(6)
    cases = [(f"hand path {shape} on {hw}", shape, hw, 0, hw == HAND_HW)
             for shape, hw in MASK_LOOKUP_SHAPES]
    cases += [("width no multiple of 8 (64,778) on (37,53)", (64, HAND_VERTS), (37, 53), 0, False),
              ("off a 16-byte boundary (1001,) on (480,640)", (1001,), HAND_HW, 1, False),
              ("one query (1,) on (5,8)", (1,), (5, 8), 0, False)]
    timed = []
    for name, shape, hw, offset, is_timed in cases:
        mask = _seeded_mask(rng, hw)
        packed = pack_mask(mask)
        n = int(np.prod(shape))
        iy = torch.from_numpy(rng.randint(0, hw[0], n + offset).astype(np.int32)).cuda()
        ix = torch.from_numpy(rng.randint(0, hw[1], n + offset).astype(np.int32)).cuda()
        iy, ix = iy[offset:].reshape(shape), ix[offset:].reshape(shape)
        got = packed_mask_lookup(packed, iy, ix, hw)
        again = packed_mask_lookup(packed, iy, ix, hw)
        mask_f, iy_l, ix_l = mask.float(), iy.long(), ix.long()
        torch.cuda.synchronize()
        if not (torch.equal(got, again) and torch.equal(got, mask_f[iy_l, ix_l])
                and torch.equal(got, _packed_mask_lookup_torch(packed, iy, ix))):
            raise AssertionError(f"[kernels] packed_mask_lookup {name}: not exact")
        line = (f"[kernels] packed_mask_lookup {name}: exact against the plain version and "
                f"mask[iy, ix] ({float(got.mean()):.3f} set), relaunch bitwise equal")
        if is_timed:
            case = _in_turns(lambda: kernels.packed_mask_lookup_cuda(packed, iy, ix, hw),
                             lambda: _packed_mask_lookup_torch(packed, iy, ix),
                             lambda: mask_f[iy_l, ix_l], slow_reps=10)
            case.update(_bound(12.0 * n + packed.numel(), 0))
            case["shape"] = name
            timed.append(case)
            line += "; " + _fmt(case)
        print(line, flush=True)
    return {"max_abs_err": 0.0, **_headline(timed), "cases": timed}


def _chain_ms(model, m: int) -> float:
    """The matmul-chain yardstick on `m` points' ready features."""
    from hotrack_tpu_torch.ops.sdf_mlp import fourier_features
    feats = fourier_features(torch.from_numpy(
        (np.random.RandomState(9).randn(1 << 18, 3) * 0.08).astype(np.float32)).cuda(),
        model.freqs, model.scale)
    feats = feats.repeat(-(-m // feats.shape[0]), 1)[:m].contiguous()
    return _time_ms(lambda: _matmul_chain(model, feats), 3)


def _ptxas_clean(name: str) -> list:
    """The compiler's report for csrc/<name>.cu, which must show no spill and
    no wgmma serialised (C7520 / C7513) and no setmaxnreg ignored (C7508)."""
    report = _ptxas_report(name)
    bad = [ln for ln in report if any(code in ln for code in ("C7520", "C7513", "C7508"))
           or any(int(n) for n in re.findall(r"(\d+) bytes spill", ln))]
    if bad:
        raise AssertionError(f"[kernels] {name} ptxas: {bad}")
    return report


def phase_kernels_hand_energy() -> dict:
    """Fused hand energy kernel (#6, the MLP of #3 through wgmma) vs plain
    version on the card: hit exact, sdf within TC_SDF_ATOL a value of the
    plain version and of the 3xTF32 emulation, sdf bitwise #3 on
    object_frame(points, frame) and hit bitwise #5 at pixel_coords(points,
    frame, hw), a second launch bitwise the first; the compiler's report
    clean. Timed in turns with the plain version and with #3 at the same
    shape. No single PyTorch call computes the function: library_ms is null,
    and the matmul chain's time is printed as a yardstick."""
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.ops.hand_energy import (_hand_energy_torch, fused_hand_energy,
                                                   object_frame, pixel_coords)
    from hotrack_tpu_torch.ops.mask_lookup import pack_mask, packed_mask_lookup
    from hotrack_tpu_torch.ops.sdf_mlp import fused_sdf_mlp_cf, pack_distilled
    from hotrack_tpu_torch.ops.tf32 import raw_sdf_mlp_3xtf32
    ptxas = _ptxas_clean("hand_energy")
    print("[kernels] hand_energy ptxas: " + " | ".join(ptxas), flush=True)
    rng = np.random.RandomState(7)
    cases = [(f"hand path {shape} on {hw}", MLP_WIDTHS, shape[:-1], hw, None, hw == HAND_HW)
             for shape, hw in HAND_ENERGY_SHAPES]
    cases += [
        ("odd P, small N (37,10) on (37,53)", MLP_WIDTHS, (37, 10), (37, 53), None, False),
        ("one vertex (1,1) on (1,1)", MLP_WIDTHS, (1, 1), NO_MASK_HW, None, False),
        *[(f"about a round (1,{n}) on (37,53)", MLP_WIDTHS, (1, n), (37, 53), None, False)
          for n in (127, 129)],
        ("6 frequencies, depth 4 (33,778) on (480,640)", (39, 128, 128, 128, 128),
         (33, HAND_VERTS), HAND_HW, None, False),
        ("non-geometric frequencies, narrow (5,129) on (480,640)", (15, 32, 48), (5, 129),
         HAND_HW, [1.0, 2.5], False),
    ]
    max_err, timed = 0.0, []
    for name, widths, shape, hw, freqs, is_timed in cases:
        model = _random_sdf(rng, widths, 0.05, freqs)
        packed = pack_distilled(model)
        packed_mask = pack_mask(_seeded_mask(rng, hw))
        frame = _seeded_frame(rng, hw)
        pts = _camera_points(rng, shape)
        sdf, hit = fused_hand_energy(model, packed_mask, frame, pts, hw, packed)
        sdf2, hit2 = fused_hand_energy(model, packed_mask, frame, pts, hw, packed)
        want_sdf, want_hit = _hand_energy_torch(model, packed_mask, frame, pts, hw)
        emu_sdf, _ = _hand_energy_torch(model, packed_mask, frame, pts, hw,
                                        mlp=raw_sdf_mlp_3xtf32)
        iy, ix = pixel_coords(pts, frame, hw)
        sdf3 = fused_sdf_mlp_cf(model, object_frame(pts, frame), packed)
        hit5 = packed_mask_lookup(packed_mask, iy, ix, hw)
        torch.cuda.synchronize()
        err = _sdf_checks(f"hand_energy {name}", sdf, sdf2, want_sdf, emu_sdf)
        max_err = max(max_err, err)
        if hit.shape != sdf.shape or not torch.equal(hit, hit2):
            raise AssertionError(f"[kernels] hand_energy {name}: hit {tuple(hit.shape)}, "
                                 f"relaunch equal {torch.equal(hit, hit2)}")
        wrong = int((hit != want_hit).sum())
        if wrong or not (torch.equal(sdf, sdf3) and torch.equal(hit, hit5)):
            raise AssertionError(f"[kernels] hand_energy {name}: {wrong} hits differ from the "
                                 f"plain version; sdf bitwise #3 on the object frame "
                                 f"{torch.equal(sdf, sdf3)}, hit bitwise #5 at the pixels "
                                 f"{torch.equal(hit, hit5)}")
        edges = [int((iy == 0).sum()), int((iy == hw[0] - 1).sum()), int((ix == 0).sum()),
                 int((ix == hw[1] - 1).sum())]
        if shape[-1] == HAND_VERTS and hw == HAND_HW and min(edges) == 0:
            raise AssertionError(f"[kernels] hand_energy {name}: no pixel clips on an edge")
        line = (f"[kernels] hand_energy {name}: hit exact ({float(hit.mean()):.3f} set; pixels "
                f"clipped at top/bottom/left/right {edges}), sdf max error {err:.3e} against "
                f"the plain version and the 3xTF32 emulation (bound {TC_SDF_ATOL}); sdf bitwise "
                f"#3 on the object frame, hit bitwise #5 at the pixels; relaunch bitwise equal")
        if is_timed:
            m = pts.numel() // 3
            obj_cl = object_frame(pts, frame).transpose(-1, -2).contiguous()
            # in turns: plain, #6, #3, #3, #6, plain (#3 on the same points'
            # object frame, channels-last as the separate route gives it)
            fns = [lambda: _hand_energy_torch(model, packed_mask, frame, pts, hw),
                   lambda: kernels.hand_energy_cuda(pts, frame, packed_mask, hw, packed),
                   lambda: kernels.sdf_mlp_cuda(obj_cl, packed, False)]
            t = [_time_ms(fn, 3 if i in (0, 5) else 10) for i, fn in enumerate(fns + fns[::-1])]
            case = {"ms": (t[1] + t[4]) / 2, "plain_ms": (t[0] + t[5]) / 2, "library_ms": None,
                    "sdf_mlp_ms": (t[2] + t[3]) / 2,
                    "matmul_chain_ms": _chain_ms(model, m)}
            del obj_cl
            case.update(_bound(20.0 * m + 4 * packed.wg.numel() + packed_mask.numel(),
                               27.0 * m, _mlp_ops(widths, m), tensor_cores=True))
            case["tflops"] = _hand_ops(widths, m) / case["ms"] / 1e9
            case["shape"] = name
            timed.append(case)
            line += (f"; {_fmt(case)}; {case['tflops']:.1f} TFLOP/s; #3 at the same points "
                     f"{case['sdf_mlp_ms']:.4f} ms ({case['ms'] / case['sdf_mlp_ms']:.3f}x); "
                     f"matmul chain {case['matmul_chain_ms']:.4f} ms")
        print(line, flush=True)
    return {"max_abs_err": max_err, **_headline(timed), "cases": timed}


def _skin_candidates(rng, p: int, n_verts: int = HAND_VERTS):
    """Seeded MANO candidates about 0.45 m in front of the camera on the
    synthetic rig (cut to its first n_verts vertices for a small N)."""
    from hotrack_tpu_torch.mano.layer import shape_hand
    from hotrack_tpu_torch.mano.model import synthetic_mano_model
    mano = synthetic_mano_model().to("cuda")
    if n_verts != HAND_VERTS:
        mano = mano._replace(
            v_template=mano.v_template[:n_verts], shapedirs=mano.shapedirs[:n_verts],
            posedirs=mano.posedirs[:n_verts], j_regressor=mano.j_regressor[:, :n_verts],
            weights=mano.weights[:n_verts],
            tips=torch.arange(5, device="cuda") * (n_verts // 5))
    pose = torch.from_numpy(rng.randn(p, 48).astype(np.float32) * 0.2).cuda()
    trans = torch.from_numpy(rng.randn(p, 3).astype(np.float32) * 0.02
                             + np.array([0, 0, 0.45], np.float32)).cuda()
    beta = torch.from_numpy(rng.randn(1, 10).astype(np.float32) * 0.3).cuda()
    return mano, pose, trans, shape_hand(mano, beta)


def _exact_skin_inputs(rng, p: int, n: int):
    """Skinning inputs whose vertices the kernel and skin_reference build
    bitwise alike: no pose blend (pose_map 0), one joint a vertex (weights
    one-hot), every joint's rotation the identity and one translation a
    candidate. Each vertex is then ((v_shaped + t) + offset) on both sides,
    so the sdf isolates the MLP's arithmetic: (pose_map, rt_flat, offset,
    SkinConsts)."""
    from hotrack_tpu_torch.ops.hand_energy_skin import SkinConsts
    mano, _, _, shaped = _skin_candidates(rng, 1, n)
    joint = torch.from_numpy(rng.randint(0, 16, n)).cuda()
    weights_t = torch.nn.functional.one_hot(joint, 16).T.float().contiguous()
    consts = SkinConsts(mano.posedirs.permute(1, 2, 0).contiguous(),
                        shaped[0][0].T.contiguous(), weights_t)
    k = consts.posedirs_cf.shape[1]
    rt = torch.zeros(p, 12, 16, device="cuda")
    rt[:, [0, 4, 8]] = 1.0
    rt[:, 9:] = torch.from_numpy((rng.randn(p, 3, 1) * 0.02).astype(np.float32)).cuda()
    offset = torch.from_numpy((rng.randn(p, 3) * 0.02 + [0, 0, 0.45]).astype(np.float32)).cuda()
    return torch.zeros(p, k, device="cuda"), rt.reshape(p * 12, 16), offset, consts


def _hand_energy_skin_emulated(rng) -> float:
    """#7 on vertices built bitwise alike (`_exact_skin_inputs`) against the
    plain version and its 3xTF32 emulation: sdf within TC_SDF_ATOL of both,
    hit equal. Returns the larger error."""
    from hotrack_tpu_torch.ops.hand_energy_skin import (_hand_energy_skin_torch,
                                                        fused_hand_energy_skin)
    from hotrack_tpu_torch.ops.mask_lookup import pack_mask
    from hotrack_tpu_torch.ops.tf32 import raw_sdf_mlp_3xtf32
    worst = 0.0
    for widths, p in ((MLP_WIDTHS, 512), ((39, 128, 128, 128, 128), 7)):
        model = _random_sdf(rng, widths, 0.05)
        packed_mask = pack_mask(_seeded_mask(rng, HAND_HW))
        frame = _seeded_frame(rng, HAND_HW)
        args = (model, packed_mask, frame, *_exact_skin_inputs(rng, p, HAND_VERTS), HAND_HW)
        sdf, hit = fused_hand_energy_skin(*args)
        want_sdf, want_hit = _hand_energy_skin_torch(*args)
        emu_sdf, _ = _hand_energy_skin_torch(*args, mlp=raw_sdf_mlp_3xtf32)
        torch.cuda.synchronize()
        err = float((sdf - want_sdf).abs().max())
        emu_err = float((sdf - emu_sdf).abs().max())
        worst = max(worst, err)
        if err > TC_SDF_ATOL or emu_err > TC_SDF_ATOL or not torch.equal(hit, want_hit):
            raise AssertionError(f"[kernels] hand_energy_skin on exact vertices {widths}: sdf "
                                 f"{err:.3e} from the plain version, {emu_err:.3e} from the "
                                 f"3xTF32 emulation (bound {TC_SDF_ATOL}), "
                                 f"{int((hit != want_hit).sum())} hits differ")
        print(f"[kernels] hand_energy_skin on exact vertices {widths} ({p},{HAND_VERTS}): sdf "
              f"{err:.3e} from the plain version, {emu_err:.3e} from the 3xTF32 emulation "
              f"(bound {TC_SDF_ATOL}); hit equal", flush=True)
    return worst


def phase_kernels_hand_energy_skin() -> dict:
    """Fused skinning + energy kernel vs plain version on the card: sdf within
    SKIN_SDF_ATOL, hit equal wherever the plain version's pixel coordinates
    are PIXEL_MARGIN clear of an integer and differing on at most
    FLIP_SHARE_BOUND of the vertices; against mano_forward the built vertices
    within 5e-6 m; a second launch bitwise equal. No single PyTorch call
    computes the function: library_ms is null."""
    from hotrack_tpu_torch.mano.layer import mano_forward, mano_skin_inputs
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.ops.hand_energy_skin import (_hand_energy_skin_torch,
                                                        fused_hand_energy_skin, skin_consts,
                                                        skin_reference)
    from hotrack_tpu_torch.ops.mask_lookup import pack_mask
    from hotrack_tpu_torch.ops.sdf_mlp import pack_distilled
    rng = np.random.RandomState(8)
    cases = [(f"hand path ({p},{k},{n}) on {hw}", MLP_WIDTHS, p, n, hw, None,
              (p, hw) == (HAND_PARTICLES, HAND_HW)) for p, k, n, hw in HAND_SKIN_SHAPES]
    cases += [
        ("odd P (33,135,778) on (37,53)", MLP_WIDTHS, 33, HAND_VERTS, (37, 53), None, False),
        ("one candidate, small N (1,135,50) on (480,640)", MLP_WIDTHS, 1, 50, HAND_HW, None,
         False),
        ("6 frequencies, depth 4 (7,135,129) on (480,640)", (39, 128, 128, 128, 128), 7, 129,
         HAND_HW, None, False),
        ("non-geometric frequencies, narrow (6,135,778) on (1,1)", (15, 32, 48), 6, HAND_VERTS,
         NO_MASK_HW, [1.0, 2.5], False),
    ]
    max_err, timed = _hand_energy_skin_emulated(rng), []
    for name, widths, p, n, hw, freqs, is_timed in cases:
        model = _random_sdf(rng, widths, 0.05, freqs)
        packed_mask = pack_mask(_seeded_mask(rng, hw))
        frame = _seeded_frame(rng, hw)
        mano, pose, trans, shaped = _skin_candidates(rng, p, n)
        _, pose_map, rt_flat, offset = mano_skin_inputs(mano, pose, trans, shaped)
        consts = skin_consts(mano, shaped)
        args = (model, packed_mask, frame, pose_map, rt_flat, offset, consts, hw)
        sdf, hit = fused_hand_energy_skin(*args)
        sdf2, hit2 = fused_hand_energy_skin(*args)
        want_sdf, want_hit = _hand_energy_skin_torch(*args)
        verts = skin_reference(pose_map, rt_flat, offset, consts)
        full, _ = mano_forward(mano, pose, trans=trans, shaped=shaped)
        torch.cuda.synchronize()
        if not (torch.equal(sdf, sdf2) and torch.equal(hit, hit2)):
            raise AssertionError(f"[kernels] hand_energy_skin {name}: two launches differ")
        if tuple(sdf.shape) != (p, n) or hit.shape != sdf.shape or not torch.isfinite(sdf).all():
            raise AssertionError(f"[kernels] hand_energy_skin {name}: shape {tuple(sdf.shape)}")
        z = verts[..., 2]
        v_pix = verts[..., 1] / z * frame[13] + frame[15]
        u_pix = verts[..., 0] / z * frame[12] + frame[14]
        clear = ((v_pix - torch.round(v_pix)).abs() > PIXEL_MARGIN) \
            & ((u_pix - torch.round(u_pix)).abs() > PIXEL_MARGIN)
        err = float((sdf - want_sdf).abs().max())
        flips = float((hit != want_hit).float().mean())
        wrong = int((hit[clear] != want_hit[clear]).sum())
        vert_err = float((verts - full).abs().max())
        max_err = max(max_err, err)
        if err > SKIN_SDF_ATOL or wrong or flips > FLIP_SHARE_BOUND or vert_err > 5e-6:
            raise AssertionError(
                f"[kernels] hand_energy_skin {name}: sdf max error {err:.3e} (bound "
                f"{SKIN_SDF_ATOL}), {wrong} hits differ clear of a pixel border, {flips:.2e} "
                f"of all hits differ, vertices {vert_err:.3e} m from mano_forward's")
        line = (f"[kernels] hand_energy_skin {name}: sdf max error {err:.3e} (bound "
                f"{SKIN_SDF_ATOL}); hit equal on the {float(clear.float().mean()):.4f} of "
                f"vertices {PIXEL_MARGIN} px clear of a pixel border, {flips:.2e} of all hits "
                f"flipped (bound {FLIP_SHARE_BOUND}); skin_reference within {vert_err:.2e} m "
                f"of mano_forward; relaunch bitwise equal")
        if is_timed:
            packed = pack_distilled(model)
            m = p * n
            flat = (pose_map, rt_flat, offset, *consts, frame, packed_mask, hw, packed)
            case = _in_turns(lambda: kernels.hand_energy_skin_cuda(*flat),
                             lambda: _hand_energy_skin_torch(*args), None, reps=10)
            case["matmul_chain_ms"] = _chain_ms(model, m)
            k = pose_map.shape[1]
            ops = _hand_ops(widths, m) + (2.0 * (3 * k + 12 * 16) + 18.0) * m
            n_bytes = 4.0 * (pose_map.numel() + rt_flat.numel() + offset.numel()
                             + sum(c.numel() for c in consts) + packed.tc.numel()) \
                + packed_mask.numel() + 8.0 * m
            case.update(_bound(n_bytes, ops - _mlp_ops(widths, m), _mlp_ops(widths, m),
                               tensor_cores=True))
            case["shape"] = name
            timed.append(case)
            line += (f"; {_fmt(case)}; matmul chain {case['matmul_chain_ms']:.4f} ms; "
                     f"{ops / case['ms'] / 1e9:.1f} TFLOP/s")
        print(line, flush=True)
    return {"max_abs_err": max_err, **_headline(timed), "cases": timed}


# --------------------------------------------------------------------------
# the batched kernels: a model, mask, shape and object pose a sequence

def _seq_checks(tag: str, got, again, ones, others=()) -> None:
    """Each sequence bitwise an unbatched launch on its inputs, a second
    batched launch bitwise the first, and (others) a sequence computed with
    another sequence's model, mask or shape differs from its own result."""
    got, again = (got if isinstance(got, tuple) else (got,)), \
        (again if isinstance(again, tuple) else (again,))
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"[kernels] {tag}: two batched launches differ")
    for s, one in enumerate(ones):
        one = one if isinstance(one, tuple) else (one,)
        if not all(torch.equal(g[s], o) for g, o in zip(got, one)):
            raise AssertionError(f"[kernels] {tag}: sequence {s} is not bitwise an unbatched "
                                 f"launch on its own inputs")
    for s, other in others:
        if torch.equal(got[0][s], other):
            raise AssertionError(f"[kernels] {tag}: sequence {s} gives the same result with "
                                 f"sequence 0's model, mask or shape")


def phase_kernels_sdf_mlp_batched() -> dict:
    """#3b against its batched plain version and its 3xTF32 emulation on the
    card: |diff| <= TC_SDF_ATOL a value, a model a sequence (each differs);
    each sequence bitwise an unbatched launch on its inputs; a second launch
    bitwise the first; one model for all (a stride of 0) bitwise the
    unbatched launches too. No single PyTorch call computes the function:
    library_ms is null, and the matmul chain's time is printed as a
    yardstick."""
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.ops.sdf_mlp import (_sdf_mlp_batched_torch, _sdf_mlp_torch,
                                               pack_distilled, pack_distilled_batched)
    from hotrack_tpu_torch.ops.tf32 import raw_sdf_mlp_3xtf32
    rng = np.random.RandomState(21)
    route = {(OBJ_PARTICLES, True): "object composed", (HAND_PARTICLES, True): "hand fused",
             (HAND_PARTICLES, False): "hand separate"}
    cases = [(f"{route[shape[1], cf]} route {shape}", MLP_WIDTHS, shape, cf, None, True)
             for shape, cf in SDF_MLP_BATCHED_SHAPES]
    cases += [("S=3, ragged round (3,37,3,129)", MLP_WIDTHS, (3, 37, 3, 129), True, None, False),
              ("S=3 channels-last (3,5,77,3)", MLP_WIDTHS, (3, 5, 77, 3), False, None, False),
              ("narrow, non-geometric frequencies (2,4,3,100)", (15, 32, 48), (2, 4, 3, 100),
               True, [1.0, 2.5], False),
              ("6 frequencies, depth 4 (2,3,3,300)", (39, 128, 128, 128, 128), (2, 3, 3, 300),
               True, None, False)]
    max_err, timed = 0.0, []
    for name, widths, shape, cf, freqs, is_timed in cases:
        models = [_random_sdf(rng, widths, 0.05, freqs) for _ in range(shape[0])]
        packed = pack_distilled_batched(models)
        pts = torch.from_numpy((rng.randn(*shape) * 0.08).astype(np.float32)).cuda()
        pts_cf = pts if cf else pts.transpose(-1, -2)
        got = kernels.sdf_mlp_batched_cuda(pts, packed, cf)
        again = kernels.sdf_mlp_batched_cuda(pts, packed, cf)
        want = _sdf_mlp_batched_torch(models, pts_cf)
        emu = torch.stack([_sdf_mlp_torch(m, p, mlp=raw_sdf_mlp_3xtf32)
                           for m, p in zip(models, pts_cf)])
        ones = [kernels.sdf_mlp_cuda(pts[i].contiguous(), pack_distilled(m), cf)
                for i, m in enumerate(models)]
        other = kernels.sdf_mlp_cuda(pts[1].contiguous(), pack_distilled(models[0]), cf)
        shared = kernels.sdf_mlp_batched_cuda(pts, pack_distilled(models[0]), cf)
        torch.cuda.synchronize()
        _seq_checks(f"sdf_mlp_batched {name}", got, again, ones, [(1, other)])
        if not torch.equal(shared[1], other):
            raise AssertionError(f"[kernels] sdf_mlp_batched {name}: one model for all is not "
                                 f"bitwise the unbatched launch")
        err = _sdf_checks(f"sdf_mlp_batched {name}", got, again, want, emu)
        max_err = max(max_err, err)
        line = (f"[kernels] sdf_mlp_batched {name}: max error {err:.3e} against the plain "
                f"version and the 3xTF32 emulation (bound {TC_SDF_ATOL}); each sequence bitwise "
                f"an unbatched launch, one model for all too; relaunch bitwise equal")
        del want, emu, ones, shared
        if is_timed:
            m = pts.numel() // 3
            feats = _chain_feats(models[0], pts_cf, m)
            case = _in_turns(lambda: kernels.sdf_mlp_batched_cuda(pts, packed, cf),
                             lambda: _sdf_mlp_batched_torch(models, pts_cf), None, reps=5,
                             slow_reps=2)
            case["matmul_chain_ms"] = _time_ms(lambda: _matmul_chain(models[0], feats), 2)
            del feats
            case.update(_bound(16.0 * m + 4 * packed.wg.numel(), 0.0, _mlp_ops(widths, m),
                               tensor_cores=True))
            case["shape"] = name
            timed.append(case)
            line += _sdf_timed(case, widths, m)
        print(line, flush=True)
    return {"max_abs_err": max_err, **_headline(timed), "cases": timed}


def phase_kernels_obj_energy_batched() -> dict:
    """#4b against its batched plain version: every sum within ENERGY_RTOL
    (+ ENERGY_ATOL a point), a model and a cloud a sequence; each sequence
    bitwise an unbatched launch; a second launch bitwise the first (fixed
    summation order on the (P, S) grid, no atomics). library_ms is null."""
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.ops.obj_energy import _obj_sdf_energy_batched_torch, obj_rts
    from hotrack_tpu_torch.ops.sdf_mlp import pack_distilled, pack_distilled_batched
    from hotrack_tpu_torch.pose.rotations import normalize_quat, unit_quaternion_to_matrix
    rng = np.random.RandomState(22)
    cases = [(f"object path ({s},{p},{n})", MLP_WIDTHS, s, p, n, None, True)
             for s, p, n in OBJ_ENERGY_BATCHED_SHAPES]
    cases += [("S=3, odd P and N (3,2047,1000)", MLP_WIDTHS, 3, 2047, 1000, None, False),
              ("S=3, small (3,10,200)", MLP_WIDTHS, 3, 10, 200, None, False),
              ("narrow, non-geometric frequencies (2,33,129)", (15, 32, 48), 2, 33, 129,
               [1.0, 2.5], False)]
    max_err, timed = 0.0, []
    for name, widths, s, p, n, freqs, is_timed in cases:
        models = [_random_sdf(rng, widths, 0.05, freqs) for _ in range(s)]
        packed = pack_distilled_batched(models)
        pcld = torch.from_numpy((rng.randn(s, 3, n) * 0.06).astype(np.float32)).cuda()
        quat = normalize_quat(torch.from_numpy(rng.randn(s, p, 4).astype(np.float32)).cuda())
        trans = torch.from_numpy((rng.randn(s, p, 3) * 0.03).astype(np.float32)).cuda()
        rts = obj_rts(unit_quaternion_to_matrix(quat), trans).contiguous()
        got = kernels.obj_sdf_energy_batched_cuda(pcld, rts, packed)
        again = kernels.obj_sdf_energy_batched_cuda(pcld, rts, packed)
        want = _obj_sdf_energy_batched_torch(models, pcld, rts)
        ones = [kernels.obj_sdf_energy_cuda(pcld[i].contiguous(), rts[i].contiguous(),
                                            pack_distilled(m)) for i, m in enumerate(models)]
        other = kernels.obj_sdf_energy_cuda(pcld[1].contiguous(), rts[1].contiguous(),
                                            pack_distilled(models[0]))
        torch.cuda.synchronize()
        _seq_checks(f"obj_sdf_energy_batched {name}", got, again, ones, [(1, other)])
        err = (got - want).abs()
        max_err = max(max_err, float(err.max()))
        if got.shape != (s, p) or not bool((err <= ENERGY_RTOL * want.abs()
                                            + ENERGY_ATOL * n).all()):
            raise AssertionError(f"[kernels] obj_sdf_energy_batched {name}: max error "
                                 f"{float(err.max()):.3e}")
        line = (f"[kernels] obj_sdf_energy_batched {name}: max error {float(err.max()):.3e} of "
                f"sums near {float(want.mean()):.3f} (bound {ENERGY_RTOL} relative); each "
                f"sequence bitwise an unbatched launch; relaunch bitwise equal")
        if is_timed:
            case = _in_turns(lambda: kernels.obj_sdf_energy_batched_cuda(pcld, rts, packed),
                             lambda: _obj_sdf_energy_batched_torch(models, pcld, rts), None,
                             reps=5, slow_reps=2)
            ops = _mlp_ops(widths, s * p * n)
            case.update(_bound(12.0 * s * n + 52.0 * s * p + 4 * packed.tc.numel(), 0.0, ops,
                               tensor_cores=True))
            case["shape"] = name
            timed.append(case)
            line += f"; {_fmt(case)}; {ops / case['ms'] / 1e9:.1f} TFLOP/s"
        print(line, flush=True)
    return {"max_abs_err": max_err, **_headline(timed), "cases": timed}


def phase_kernels_mask_lookup_batched() -> dict:
    """#5b against its batched plain version and each sequence's
    mask[iy, ix]: exact; each sequence bitwise an unbatched launch. Library
    call: one advanced index masks[s, iy, ix] on float masks and int64
    indices made beforehand."""
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.ops.mask_lookup import _packed_mask_lookup_batched_torch, pack_mask
    rng = np.random.RandomState(23)
    cases = [(f"hand path {shape} on {hw}", shape, hw, 0, True)
             for shape, hw in MASK_LOOKUP_BATCHED_SHAPES]
    cases += [("S=3, a sequence no multiple of 4 (3,7,13) on (37,53)", (3, 7, 13), (37, 53), 0,
               False),
              ("off a 16-byte boundary (3,1001) on (480,640)", (3, 1001), HAND_HW, 1, False),
              ("one query a sequence (2,1) on (5,8)", (2, 1), (5, 8), 0, False)]
    timed = []
    for name, shape, hw, offset, is_timed in cases:
        s = shape[0]
        masks = torch.stack([_seeded_mask(rng, hw) for _ in range(s)])
        packed = torch.stack([pack_mask(m) for m in masks])
        n = int(np.prod(shape))
        iy = torch.from_numpy(rng.randint(0, hw[0], n + offset).astype(np.int32)).cuda()
        ix = torch.from_numpy(rng.randint(0, hw[1], n + offset).astype(np.int32)).cuda()
        iy, ix = iy[offset:].reshape(shape), ix[offset:].reshape(shape)
        got = kernels.packed_mask_lookup_batched_cuda(packed, iy, ix, hw)
        again = kernels.packed_mask_lookup_batched_cuda(packed, iy, ix, hw)
        ones = [kernels.packed_mask_lookup_cuda(packed[i], iy[i].contiguous(),
                                                ix[i].contiguous(), hw) for i in range(s)]
        masks_f, iy_l, ix_l = masks.float(), iy.long(), ix.long()
        sidx = torch.arange(s, device="cuda").reshape(s, *(1,) * (iy.dim() - 1))
        other = kernels.packed_mask_lookup_cuda(packed[0], iy[1].contiguous(),
                                                ix[1].contiguous(), hw)
        torch.cuda.synchronize()
        _seq_checks(f"packed_mask_lookup_batched {name}", got, again, ones,
                    [(1, other)] if n // s > 8 else [])
        if not (torch.equal(got, masks_f[sidx, iy_l, ix_l])
                and torch.equal(got, _packed_mask_lookup_batched_torch(packed, iy, ix))):
            raise AssertionError(f"[kernels] packed_mask_lookup_batched {name}: not exact")
        line = (f"[kernels] packed_mask_lookup_batched {name}: exact against the plain version "
                f"and masks[s, iy, ix]; each sequence bitwise an unbatched launch; relaunch "
                f"bitwise equal")
        if is_timed:
            case = _in_turns(lambda: kernels.packed_mask_lookup_batched_cuda(packed, iy, ix, hw),
                             lambda: _packed_mask_lookup_batched_torch(packed, iy, ix),
                             lambda: masks_f[sidx, iy_l, ix_l], slow_reps=10)
            case.update(_bound(12.0 * n + packed.numel(), 0))
            case["shape"] = name
            timed.append(case)
            line += "; " + _fmt(case)
        print(line, flush=True)
    return {"max_abs_err": 0.0, **_headline(timed), "cases": timed}


def _skin_sequences(rng, s: int, p: int, n: int, hw):
    """S sequences of P seeded MANO candidates on the (cut) synthetic rig,
    each with its own shape, object pose, mask and model slot: (pose_map,
    rt_flat, offset) stacked, the batched SkinConsts, frames (S, 16), packed
    masks (S, H, WP), and each sequence's unbatched SkinConsts."""
    from hotrack_tpu_torch.mano.layer import mano_skin_inputs
    from hotrack_tpu_torch.ops.hand_energy_skin import skin_consts
    from hotrack_tpu_torch.ops.mask_lookup import pack_mask
    parts, shapes = [], []
    for _ in range(s):
        mano, pose, trans, shaped = _skin_candidates(rng, p, n)
        parts.append(mano_skin_inputs(mano, pose, trans, shaped)[1:])
        shapes.append(shaped)
    pose_map, rt_flat, offset = (torch.stack(t).contiguous() for t in zip(*parts))
    consts = skin_consts(mano, (torch.cat([v for v, _ in shapes]),
                                torch.cat([j for _, j in shapes])), batched=True)
    frames = torch.stack([_seeded_frame(rng, hw) for _ in range(s)])
    masks = torch.stack([pack_mask(_seeded_mask(rng, hw)) for _ in range(s)])
    return pose_map, rt_flat, offset, consts, frames, masks, \
        [skin_consts(mano, shaped) for shaped in shapes]


def phase_kernels_hand_energy_skin_batched() -> dict:
    """#7b against its batched plain version on the card: sdf within
    SKIN_SDF_ATOL, hit equal wherever the plain version's pixel is
    PIXEL_MARGIN clear of an integer and flipped on at most FLIP_SHARE_BOUND
    of the vertices, with a shape, object pose, mask and model a sequence;
    each sequence bitwise an unbatched launch (and sequence 0's shape in
    place of sequence 1's changes the result); a second launch bitwise the
    first. library_ms is null."""
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.ops.hand_energy_skin import (_hand_energy_skin_batched_torch,
                                                        skin_reference)
    from hotrack_tpu_torch.ops.sdf_mlp import pack_distilled, pack_distilled_batched
    rng = np.random.RandomState(24)
    cases = [(f"hand path ({s},{p},{k},{n}) on {hw}", MLP_WIDTHS, s, p, n, hw, None,
              hw == HAND_HW) for s, p, k, n, hw in HAND_SKIN_BATCHED_SHAPES]
    cases += [("S=3, odd P (3,33,135,778) on (37,53)", MLP_WIDTHS, 3, 33, HAND_VERTS, (37, 53),
               None, False),
              ("S=3, one candidate, small N (3,1,135,50) on (480,640)", MLP_WIDTHS, 3, 1, 50,
               HAND_HW, None, False),
              ("narrow, non-geometric frequencies (2,6,135,778) on (1,1)", (15, 32, 48), 2, 6,
               HAND_VERTS, NO_MASK_HW, [1.0, 2.5], False)]
    max_err, timed = 0.0, []
    for name, widths, s, p, n, hw, freqs, is_timed in cases:
        models = [_random_sdf(rng, widths, 0.05, freqs) for _ in range(s)]
        packed = pack_distilled_batched(models)
        pose_map, rt_flat, offset, consts, frames, masks, one_consts = \
            _skin_sequences(rng, s, p, n, hw)
        flat = (pose_map, rt_flat, offset, *consts, frames, masks, hw, packed)
        got = kernels.hand_energy_skin_batched_cuda(*flat)
        again = kernels.hand_energy_skin_batched_cuda(*flat)
        ones = [kernels.hand_energy_skin_cuda(pose_map[i], rt_flat[i], offset[i], *one_consts[i],
                                              frames[i], masks[i], hw, pack_distilled(models[i]))
                for i in range(s)]
        other = kernels.hand_energy_skin_cuda(pose_map[1], rt_flat[1], offset[1], *one_consts[0],
                                              frames[1], masks[1], hw, pack_distilled(models[1]))
        want_sdf, want_hit = _hand_energy_skin_batched_torch(models, masks, frames, pose_map,
                                                             rt_flat, offset, consts, hw)
        torch.cuda.synchronize()
        _seq_checks(f"hand_energy_skin_batched {name}", got, again, ones, [(1, other[0])])
        sdf, hit = got
        verts = torch.stack([skin_reference(pose_map[i], rt_flat[i], offset[i], one_consts[i])
                             for i in range(s)])
        z = verts[..., 2]
        f = frames[:, None, None]
        v_pix = verts[..., 1] / z * f[..., 13] + f[..., 15]
        u_pix = verts[..., 0] / z * f[..., 12] + f[..., 14]
        clear = ((v_pix - torch.round(v_pix)).abs() > PIXEL_MARGIN) \
            & ((u_pix - torch.round(u_pix)).abs() > PIXEL_MARGIN)
        err = float((sdf - want_sdf).abs().max())
        flips = float((hit != want_hit).float().mean())
        wrong = int((hit[clear] != want_hit[clear]).sum())
        max_err = max(max_err, err)
        if tuple(sdf.shape) != (s, p, n) or err > SKIN_SDF_ATOL or wrong \
                or flips > FLIP_SHARE_BOUND:
            raise AssertionError(f"[kernels] hand_energy_skin_batched {name}: sdf max error "
                                 f"{err:.3e}, {wrong} hits differ clear of a pixel border, "
                                 f"{flips:.2e} of all hits differ")
        line = (f"[kernels] hand_energy_skin_batched {name}: sdf max error {err:.3e} (bound "
                f"{SKIN_SDF_ATOL}); hit equal on the {float(clear.float().mean()):.4f} of "
                f"vertices clear of a pixel border, {flips:.2e} flipped; each sequence bitwise "
                f"an unbatched launch; relaunch bitwise equal")
        if is_timed:
            case = _in_turns(lambda: kernels.hand_energy_skin_batched_cuda(*flat),
                             lambda: _hand_energy_skin_batched_torch(
                                 models, masks, frames, pose_map, rt_flat, offset, consts, hw),
                             None, reps=5, slow_reps=2)
            k = pose_map.shape[-1]
            m = s * p * n
            ops = _hand_ops(widths, m) + (2.0 * (3 * k + 12 * 16) + 18.0) * m
            n_bytes = 4.0 * (pose_map.numel() + rt_flat.numel() + offset.numel()
                             + sum(c.numel() for c in consts) + packed.tc.numel()
                             + frames.numel()) + masks.numel() + 8.0 * m
            case.update(_bound(n_bytes, ops - _mlp_ops(widths, m), _mlp_ops(widths, m),
                               tensor_cores=True))
            case["shape"] = name
            timed.append(case)
            line += f"; {_fmt(case)}; {ops / case['ms'] / 1e9:.1f} TFLOP/s"
        print(line, flush=True)
    return {"max_abs_err": max_err, **_headline(timed), "cases": timed}


def _handopt_scene(device: str) -> dict:
    """The pose optimiser's test problem: a ground-truth hand 0.45 m in front
    of the camera around the box, a perturbed start, the network's keypoints
    at the truth with three hidden, a seeded random 480 x 640 mask."""
    from hotrack_tpu_torch.mano.layer import mano_forward
    from hotrack_tpu_torch.mano.model import synthetic_mano_model
    from hotrack_tpu_torch.opt import load_contact_zones
    from hotrack_tpu_torch.pose.rotations import matrix_to_rotvec, rotvec_to_matrix
    rng = np.random.RandomState(5)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    mano = synthetic_mano_model().to(device)
    beta = t(rng.randn(1, 10) * 0.3)
    gt_theta = t(rng.randn(1, 45) * 0.2)
    gt_r = rotvec_to_matrix(t(rng.randn(1, 3) * 0.3))
    gt_t = t([[[0.0], [0.0], [0.45]]])
    _, gt_kp = mano_forward(mano, torch.cat([matrix_to_rotvec(gt_r), gt_theta], -1),
                            betas=beta, trans=gt_t[..., 0])
    init_r = torch.matmul(gt_r, rotvec_to_matrix(t([[0.05, 0.03, -0.04]])))
    init_t, init_theta = gt_t + 0.01, gt_theta + 0.1
    _, init_kp = mano_forward(mano, torch.cat([matrix_to_rotvec(init_r), init_theta], -1),
                              betas=beta, trans=init_t[..., 0])
    vis = torch.ones((1, 21), dtype=torch.bool, device=device)
    vis[0, 18:] = False
    return dict(
        mano=mano, gt_kp=gt_kp, init_kp=init_kp, zones=load_contact_zones(device=device),
        kwargs=dict(hand_shape=beta, init_rotation=init_r, init_translation=init_t,
                    init_theta=init_theta, pred_kp=gt_kp, vis_mask=vis, last_frame_kp=gt_kp,
                    has_last=1.0, obj_rotation=torch.eye(3, device=device),
                    obj_translation=t([0.0, 0.0, 0.45]),
                    background_mask=torch.from_numpy(rng.rand(*HAND_HW) > 0.5).to(device),
                    intrinsics=HAND_INTRINSICS, energy_weight=HAND_WEIGHTS))


def _mpjpe(a, b) -> float:
    return float(torch.mean(torch.linalg.norm(a - b, dim=-1)))


def phase_hand_optimiser(card: str, seen: dict):
    """`optimize_hand_pose` at its operating point on every route, and with
    a smaller bank on the card against the CPU. Returns (launches by route,
    the distilled fit on the CPU)."""
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.opt import optimize_hand_pose, presample_particles
    from hotrack_tpu_torch.sdf.assets import synthetic_box_sdf_setup
    from hotrack_tpu_torch.sdf.distill import distill_sdf_volume, distilled_to
    from hotrack_tpu_torch.train.run_hand_track import HAND_VOLUME_SIZE, HAND_VOXEL_SCALE

    t0 = time.perf_counter()
    volume = synthetic_box_sdf_setup(HAND_VOLUME_SIZE, HAND_VOXEL_SCALE, device="cuda")
    fit = distill_sdf_volume(volume, HAND_VOXEL_SCALE, torch.Generator().manual_seed(3))
    torch.cuda.synchronize()
    distill_s = time.perf_counter() - t0
    bank = presample_particles(HAND_PARTICLES, 16, torch.Generator().manual_seed(4))
    scene = _handopt_scene("cuda")

    def run(route, particles, device="cuda", scene=scene, model=fit, vol=volume):
        trace = []
        out = optimize_hand_pose(
            scene["mano"], particles.to(device), scene["zones"], vol, **scene["kwargs"],
            voxel_scale=HAND_VOXEL_SCALE, distilled=None if route == "volume" else model,
            hand_energy="skin" if route == "volume" else route, trace=trace)
        return out, trace

    want = {"skin": {"hand_energy_skin": HAND_ITERATIONS},
            "fused": {"hand_energy": HAND_ITERATIONS},
            "separate": {"sdf_mlp": HAND_ITERATIONS, "packed_mask_lookup": HAND_ITERATIONS},
            "volume": {"packed_mask_lookup": HAND_ITERATIONS}}
    results, launches, times = {}, {}, {}
    for route in want:
        run(route, bank)  # warm-up
        kernels.reset_launch_counts()
        with noting_shapes(seen):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            results[route] = run(route, bank)
            torch.cuda.synchronize()
            times[route] = 1e3 * (time.perf_counter() - t1)
        launches[route] = dict(kernels.launch_counts)
        if {k: v for k, v in launches[route].items() if v} != want[route]:
            raise AssertionError(f"[handopt] route {route} launched {launches[route]}, "
                                 f"expected {want[route]}")
    err0 = _mpjpe(scene["init_kp"], scene["gt_kp"])
    errs = {route: _mpjpe(out[0], scene["gt_kp"]) for route, (out, _) in results.items()}
    print(f"[handopt] cuda: {HAND_PARTICLES} particles x {HAND_VERTS} vertices x "
          f"{HAND_ITERATIONS} iterations on a {HAND_HW} mask; distillation of the "
          f"{HAND_VOLUME_SIZE}^3 volume {distill_s:.2f} s; ms a call by route "
          f"{ {k: round(v, 3) for k, v in times.items()} }; keypoint error {1e3 * err0:.3f} mm "
          f"at the start -> {{ {', '.join(f'{k}: {1e3 * v:.3f}' for k, v in errs.items())} }} mm; "
          f"launches {launches} | {card}", flush=True)
    if not all(e < err0 for e in errs.values()):
        raise AssertionError("[handopt] the keypoint error did not fall on every route")

    e0 = {route: trace[0][0] for route, (_, trace) in results.items()}
    e_skin = e0["skin"]
    for route, bound in (("fused", None), ("separate", None), ("volume", HAND_VOLUME_ATOL)):
        gap = (e0[route] - (e_skin if route != "separate" else e0["fused"])).abs()
        against = "fused" if route == "separate" else "skin"
        line = (f"[handopt] iteration-0 energies ({float(e_skin.min()):.4f} to "
                f"{float(e_skin.max()):.4f}), {route} vs {against}: max gap "
                f"{float(gap.max()):.3e}")
        if route == "separate":   # the same pixels: the sdf's rounding alone
            ok = float(gap.max()) <= HAND_E_ATOL
            line += f" (bound {HAND_E_ATOL})"
        elif bound is None:       # skin's vertices differ by rounding: pixels may flip
            share = float((gap > HAND_E_ATOL).float().mean())
            ok = float(gap.max()) <= HAND_E_ATOL + HAND_MAX_FLIPS * HAND_FLIP \
                and share <= HAND_FLIPPED_SHARE
            line += (f", {share:.4f} of the candidates beyond {HAND_E_ATOL} (a flipped pixel is "
                     f"{HAND_FLIP:.3e}; bounds {HAND_MAX_FLIPS} flips, share "
                     f"{HAND_FLIPPED_SHARE})")
        else:
            ok = float(gap.max()) <= bound + HAND_MAX_FLIPS * HAND_FLIP
            line += f" (bound {bound}: another SDF)"
        print(line, flush=True)
        if not ok:
            raise AssertionError(f"[handopt] {route} route: iteration-0 energies differ beyond "
                                 f"the bound")

    # card against CPU (plain versions), a smaller bank, the same fit and start
    small = bank[:HAND_CPU_PARTICLES]
    with noting_shapes(seen):
        (kp_card, *_), tr_card = run("skin", small)
    cpu_scene = _handopt_scene("cpu")
    t1 = time.perf_counter()
    (kp_cpu, *_), tr_cpu = run("skin", small, "cpu", cpu_scene, distilled_to(fit, "cpu"),
                               volume.cpu())
    gap = (tr_card[0][0].cpu() - tr_cpu[0][0]).abs()
    share = float((gap > HAND_CPU_E_ATOL).float().mean())
    kp_gap = float((kp_card.cpu() - kp_cpu).abs().max())
    # the first iteration whose candidates better than particle 0 differ
    parted = next((k for k, ((ea, *_), (eb, *_)) in enumerate(zip(tr_card, tr_cpu))
                   if not torch.equal((ea < ea[0]).cpu(), eb < eb[0])), None)
    kp_bound = HAND_KP_BOUND_M if parted is None else HAND_STEP_BOUND_M
    print(f"[handopt] cpu vs cuda, {HAND_CPU_PARTICLES} particles, skin route (cpu run "
          f"{time.perf_counter() - t1:.1f} s): iteration-0 energies differ by at most "
          f"{float(gap.max()):.3e}, {share:.4f} of the candidates beyond {HAND_CPU_E_ATOL}; "
          f"the candidates better than particle 0 "
          + ("the same at every iteration" if parted is None else
             f"first differ at iteration {parted}") + f"; final keypoints differ by "
          f"{1e3 * kp_gap:.4f} mm (bound {1e3 * kp_bound} mm)", flush=True)
    if float(gap.max()) > HAND_CPU_E_ATOL + HAND_MAX_FLIPS * HAND_FLIP \
            or share > HAND_FLIPPED_SHARE or kp_gap > kp_bound:
        raise AssertionError("[handopt] card and CPU differ beyond the bound")
    return launches, distilled_to(fit, "cpu")


def _hand_dataset(frames: int, sequences: int = 1) -> str:
    """A generated set whose test split holds `sequences` sequences of
    `frames` frames, with the two seeded checkpoints the hand pipeline loads
    (HandTrackNet with its delta head scaled, IKNet)."""
    from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset
    from hotrack_tpu_torch.train.cli import load_config
    from hotrack_tpu_torch.train.run_hand_track import build_iknet
    from hotrack_tpu_torch.utils.convert import save_reference_checkpoint
    root = tempfile.mkdtemp(prefix=f"hotrack_smoke_hand{frames}_")
    base = generate_simgrasp_dataset(root, num_instances=sequences + 1, num_frames=frames,
                                     points_per_part=POINTS_PER_PART)
    if sequences > 1:
        _test_split_of(base, sequences)
    os.environ["HOTRACK_DATA_ROOT"] = root
    cfg = load_config(_hand_argv())
    _write_checkpoint(cfg)
    save_reference_checkpoint(build_iknet(cfg, "cpu"),
                              os.path.join(cfg["IKNet_dir"], "ckpt", "model_0001.pt"))
    return root


def _hand_argv(*extra) -> list:
    return ["--config", HAND_CONFIG, "--device", "cuda", "--num_points", str(HAND_NUM_POINTS),
            *extra]


def _hand_run(root: str, seen: dict, fit=None, extra=()):
    """One run of the hand path on the data under `root`: through `test_main`
    when it distils itself, through `run_hand_tracking` with the fit carried
    over otherwise. Returns (mean metrics, stats, launches)."""
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.train.cli import load_config, test_main
    from hotrack_tpu_torch.train.run_hand_track import run_hand_tracking
    os.environ["HOTRACK_DATA_ROOT"] = root
    kernels.reset_launch_counts()
    with noting_shapes(seen):
        if fit is None:
            avg, stats = test_main(_hand_argv(*extra))
        else:
            avg, stats = run_hand_tracking(load_config(_hand_argv(*extra)), distilled=[fit])
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    seq = stats["sequences"][0]
    frames = stats["n_frames"]
    for key, shape in (("pred_kp", (frames, 21, 3)), ("mano_theta", (frames, 45)),
                       ("pred_beta", (1, 10)), ("global_translation", (frames, 3, 1))):
        if seq[key].shape != shape or not np.isfinite(seq[key]).all():
            raise AssertionError(f"[hand] {extra}: {key} {seq[key].shape}, finite "
                                 f"{bool(np.isfinite(seq[key]).all())}")
    if not all(math.isfinite(v) for v in avg.values()):
        raise AssertionError(f"[hand] {extra}: non-finite metrics {avg}")
    return avg, stats, launches


def phase_hand_path(card: str, seen: dict, fit) -> dict:
    from hotrack_tpu_torch.data import get_dataloader, prepare_batch
    from hotrack_tpu_torch.mano.model import get_mano_model
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.opt import load_contact_zones
    from hotrack_tpu_torch.sdf.distill import distilled_to
    from hotrack_tpu_torch.track import track_hand_sequence
    from hotrack_tpu_torch.train.cli import load_config
    from hotrack_tpu_torch.train.run_hand_track import (HAND_VOXEL_SCALE, load_handnet,
                                                        load_iknet)
    roots = {n: _hand_dataset(n) for n in (HAND_FRAMES, HAND_SHORT_FRAMES, HAND_MODE_FRAMES)}
    try:
        # the main run: test_main distils the volume itself; skin route, shape mode 1
        _hand_run(roots[HAND_SHORT_FRAMES], {name: set() for name in KERNELS}, fit)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        avg, stats, launches = _hand_run(roots[HAND_FRAMES], seen)
        peak = torch.cuda.max_memory_allocated()
        seq = stats["sequences"][0]
        expect = {"fps": PER_PREPARE + FPS_PER_FORWARD * (HAND_FRAMES + 1),
                  "gather_rows": PER_PREPARE + GATHERS_PER_FORWARD * (HAND_FRAMES + 1),
                  "hand_energy_skin": HAND_ITERATIONS * HAND_FRAMES}
        if {k: v for k, v in launches.items() if v} != expect:
            raise AssertionError(f"[hand] the main run launched {launches}, expected {expect}")
        if not np.abs(seq["pred_beta"]).max() > 0:
            raise AssertionError("[hand] the frame-0 shape optimiser left beta at zero")
        ms_net = 1e3 * stats["net_seconds"] / HAND_FRAMES
        ms_all = 1e3 * (stats["net_seconds"] + stats["data_seconds"]) / HAND_FRAMES
        print(f"[hand] cuda, skin route, shape mode 1: {HAND_FRAMES} frames at "
              f"{HAND_NUM_POINTS} points, {HAND_PARTICLES} particles; tracking {ms_net:.3f} "
              f"ms/frame (the frame-0 shape optimiser included), {ms_all:.3f} ms/frame with the "
              f"sequence's set-up ({seq['setup_seconds']:.2f} s, of which distillation "
              f"{seq['distill_seconds']:.2f} s); peak memory {peak / 2**20:.1f} MiB; beta "
              f"{np.array2string(seq['pred_beta'][0], precision=3)}; launches {launches}; "
              f"metrics {avg} | {card}", flush=True)
        by_path = {"hand": launches}

        # the same nets with seeded 480 x 640 masks: the silhouette term at work
        os.environ["HOTRACK_DATA_ROOT"] = roots[HAND_FRAMES]
        cfg = load_config(_hand_argv())
        mano = get_mano_model(cfg.get("mano_root")).to("cuda")
        raw, _ = get_dataloader(cfg, "test")[0]
        hj = cfg["hand_jitter_cfg"]
        masks = torch.from_numpy(np.random.RandomState(13).rand(HAND_FRAMES, *HAND_HW) > 0.5)
        kwargs = dict(
            iknet=load_iknet(cfg, "cuda"), use_opt=True, shape_mode=1,
            shape_particles=torch.from_numpy(stats["shape_particles"]).cuda(),
            pose_particles=torch.from_numpy(stats["pose_particles"]).cuda(),
            zones=load_contact_zones(device="cuda"), background_masks=masks.cuda(),
            energy_weight=HAND_WEIGHTS, sdf_voxel_scale=HAND_VOXEL_SCALE,
            distilled=distilled_to(seq["distilled"], "cuda"))
        handnet = load_handnet(cfg, "cuda")
        kernels.reset_launch_counts()
        with noting_shapes(seen):
            batch = prepare_batch(mano, raw, HAND_NUM_POINTS,
                                  generator=torch.Generator().manual_seed(0),
                                  hand_jitter_scale=hj["rand_scale"],
                                  jitter_kind=hj["rand_type"], device="cuda")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            result = track_hand_sequence(handnet, mano, batch, **kwargs)
            torch.cuda.synchronize()
            ms_masks = 1e3 * (time.perf_counter() - t1) / HAND_FRAMES
        by_path["hand_masks"] = dict(kernels.launch_counts)
        if by_path["hand_masks"]["hand_energy_skin"] != HAND_ITERATIONS * HAND_FRAMES \
                or not all(bool(torch.isfinite(t).all()) for t in result):
            raise AssertionError(f"[hand] the run with masks: launches {by_path['hand_masks']}")
        print(f"[hand] cuda, track_hand_sequence with seeded {HAND_HW} masks: {ms_masks:.3f} "
              f"ms/frame; keypoints moved by the optimiser {1e3 * _mpjpe(result.pred_kp, result.baseline_pred_kp):.3f} "
              f"mm from HandTrackNet's", flush=True)

        # the other routes and shape modes, with the hand-optimiser phase's fit
        _, ref, _ = _hand_run(roots[HAND_SHORT_FRAMES], seen, fit)
        ref_kp = ref["sequences"][0]["pred_kp"]
        per_frame = HAND_ITERATIONS * HAND_SHORT_FRAMES
        for tag, extra, expect in (
                ("fused", ("--hand_energy", "fused"), {"hand_energy": per_frame}),
                ("separate", ("--hand_energy", "separate"),
                 {"sdf_mlp": per_frame, "packed_mask_lookup": per_frame}),
                ("volume", ("--sdf_query", "volume"), {"packed_mask_lookup": per_frame})):
            _, st, ln = _hand_run(roots[HAND_SHORT_FRAMES], seen,
                                  None if tag == "volume" else fit, extra)
            got = {k: v for k, v in ln.items() if k not in ("fps", "gather_rows") and v}
            if got != expect:
                raise AssertionError(f"[hand] route {tag} launched {ln}, expected {expect}")
            gap = np.abs(st["sequences"][0]["pred_kp"] - ref_kp).reshape(HAND_SHORT_FRAMES, -1)
            print(f"[hand] cuda, {HAND_SHORT_FRAMES} frames, route {tag}: "
                  f"{1e3 * st['net_seconds'] / HAND_SHORT_FRAMES:.3f} ms/frame against skin's "
                  f"{1e3 * ref['net_seconds'] / HAND_SHORT_FRAMES:.3f}; launches {got}; keypoints "
                  f"against the skin route's: frame 0 {1e3 * gap[0].max():.4f} mm, worst frame "
                  f"{1e3 * gap.max():.4f} mm (closed loop)", flush=True)
            by_path[f"hand_{tag}"] = ln
        for mode in (2, 3):
            _, st, ln = _hand_run(roots[HAND_MODE_FRAMES], seen, fit,
                                  ("--use_pred_hand_shape", str(mode)))
            if ln["hand_energy_skin"] != HAND_ITERATIONS * HAND_MODE_FRAMES:
                raise AssertionError(f"[hand] shape mode {mode} launched {ln}")
            print(f"[hand] cuda, {HAND_MODE_FRAMES} frames, shape mode {mode}: "
                  f"{1e3 * st['net_seconds'] / HAND_MODE_FRAMES:.3f} ms/frame (two "
                  f"re-optimisations included); beta "
                  f"{np.array2string(st['sequences'][0]['pred_beta'][0], precision=3)}",
                  flush=True)
        return by_path
    finally:
        for root in roots.values():
            shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------------------
# several sequences through one loop

@contextlib.contextmanager
def _short_fits(module):
    """The runner in `module` distils with BATCH_FIT_STEPS Adam steps (its
    own draws, so one fit a sequence, each different)."""
    real = module.distill_sdf_volume
    module.distill_sdf_volume = lambda volume, scale, generator: real(
        volume, scale, generator, steps=BATCH_FIT_STEPS)
    try:
        yield
    finally:
        module.distill_sdf_volume = real


def _tree(fn, tree):
    return {k: _tree(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _fits_differ(tag: str, fits) -> None:
    for i in range(1, len(fits)):
        if torch.equal(fits[0].weights[0], fits[i].weights[0]):
            raise AssertionError(f"[{tag}] the fits of sequences 0 and {i} are the same")


def phase_hand_batched(card: str, seen: dict) -> dict:
    """`test_main --eval_batch_seqs HAND_SEQS` on a set of HAND_SEQS
    sequences (skin route, shape mode 1, a fit a sequence), `test_main`
    without it on the same set (the same generator draws in the same order:
    the same inputs and fits; frame 0 of every sequence held at
    HAND_KP_BOUND_M), then `track_hand_sequences_batched` with seeded
    480 x 640 masks a sequence on the skin, fused, separate and volume
    routes."""
    from hotrack_tpu_torch.data import get_dataloader, prepare_batch
    from hotrack_tpu_torch.mano.model import get_mano_model
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.opt import load_contact_zones
    from hotrack_tpu_torch.sdf.distill import distilled_to
    from hotrack_tpu_torch.track import track_hand_sequences_batched
    from hotrack_tpu_torch.train import run_hand_track
    from hotrack_tpu_torch.train.cli import load_config, test_main
    root = _hand_dataset(HAND_BATCH_FRAMES, HAND_SEQS)
    argv = _hand_argv("--data_cfg/num_frames", str(HAND_BATCH_FRAMES))
    frames = HAND_BATCH_FRAMES
    try:
        os.environ["HOTRACK_DATA_ROOT"] = root
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        with noting_shapes(seen), _short_fits(run_hand_track):
            avg, stats = test_main([*argv, "--eval_batch_seqs", str(HAND_SEQS)])
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        seqs = stats["sequences"]
        expect = {"fps": HAND_SEQS * PER_PREPARE + FPS_PER_FORWARD * (frames + 1),
                  "gather_rows": HAND_SEQS * PER_PREPARE + GATHERS_PER_FORWARD * (frames + 1),
                  "hand_energy_skin_batched": HAND_ITERATIONS * frames}
        if {k: v for k, v in launches.items() if v} != expect:
            raise AssertionError(f"[hand batched] launched {launches}, expected {expect}")
        for i, seq in enumerate(seqs):
            for key, shape in (("pred_kp", (frames, 21, 3)), ("mano_theta", (frames, 45)),
                               ("pred_beta", (1, 10))):
                if seq[key].shape != shape or not np.isfinite(seq[key]).all():
                    raise AssertionError(f"[hand batched] sequence {i}: {key} {seq[key].shape}")
        if not all(math.isfinite(v) for v in avg.values()):
            raise AssertionError(f"[hand batched] non-finite metrics {avg}")
        fits = [seq["distilled"] for seq in seqs]
        _fits_differ("hand batched", fits)
        seq_gap = min(float(np.abs(seqs[0]["pred_kp"] - seq["pred_kp"]).max()) for seq in seqs[1:])
        beta_gap = min(float(np.abs(seqs[0]["pred_beta"] - seq["pred_beta"]).max())
                       for seq in seqs[1:])
        if seq_gap < 1e-3 or beta_gap == 0.0:
            raise AssertionError("[hand batched] the sequences' fits or betas do not differ")
        ms_chunk = 1e3 * stats["net_seconds"] / frames
        print(f"[hand batched] cuda, test_main --eval_batch_seqs {HAND_SEQS}: {HAND_SEQS} "
              f"sequences x {frames} frames through one loop, skin route, shape mode 1, "
              f"{HAND_PARTICLES} particles; {ms_chunk:.3f} ms a chunk-frame, "
              f"{stats['n_frames'] / stats['net_seconds']:.2f} frames/s tracking, "
              f"{stats['fps_all']:.2f} frames/s over the whole run (set-up, {HAND_SEQS} fits of "
              f"{BATCH_FIT_STEPS} steps at {np.mean([q['distill_seconds'] for q in seqs]):.2f} s "
              f"each, included); peak memory {peak / 2**20:.1f} MiB; launches {launches}; "
              f"sequences differ by >= {1e3 * seq_gap:.2f} mm; metrics {avg} | {card}",
              flush=True)
        by_path = {"hand_batched": launches}

        # the unbatched runner on the same sequences: the same draws, so the
        # same inputs and fits
        kernels.reset_launch_counts()
        with noting_shapes(seen), _short_fits(run_hand_track):
            _, one = test_main(argv)
        torch.cuda.synchronize()
        by_path["hand_batched_one_at_a_time"] = dict(kernels.launch_counts)
        if by_path["hand_batched_one_at_a_time"]["hand_energy_skin"] \
                != HAND_ITERATIONS * frames * HAND_SEQS:
            raise AssertionError(f"[hand batched] the unbatched runner launched "
                                 f"{by_path['hand_batched_one_at_a_time']}")
        gaps, fit_diff, beta_diff = [], 0.0, []
        for i, (a, b) in enumerate(zip(one["sequences"], seqs)):
            if not (np.array_equal(a["hand_idx0"], b["hand_idx0"])
                    and np.array_equal(a["obj_idx0"], b["obj_idx0"])):
                raise AssertionError(f"[hand batched] sequence {i}: other inputs than the "
                                     f"unbatched runner's")
            gaps.append(np.abs(a["pred_kp"] - b["pred_kp"]).reshape(frames, -1).max(-1))
            fit_diff = max(fit_diff, max(float((wa - wb).abs().max()) for wa, wb in zip(
                a["distilled"].weights, b["distilled"].weights)))
            beta_diff.append(float(np.abs(a["pred_beta"] - b["pred_beta"]).max()))
        gaps = np.stack(gaps)
        # frame 0 to the rounding of two runs that take the same steps; where the
        # frame-0 shape optimiser took another step (a near-tie: its betas
        # differ), to a step of the search
        kp_bound = np.where(np.array(beta_diff) > 1e-4, HAND_SHAPE_STEP_BOUND_M, HAND_KP_BOUND_M)
        ms_one = 1e3 * one["net_seconds"] / one["n_frames"]
        print(f"[hand batched] the unbatched runner on the same {HAND_SEQS} sequences and fits: "
              f"{ms_one:.3f} ms/frame ({1e3 / ms_one:.2f} frames/s) against the batched loop's "
              f"{ms_chunk / HAND_SEQS:.3f} ms a sequence-frame "
              f"({stats['n_frames'] / stats['net_seconds']:.2f} frames/s): "
              f"{ms_one * HAND_SEQS / ms_chunk:.3f}x the aggregate frames/s; the same inputs, "
              f"fits within {fit_diff:.2e} of the batched run's; "
              f"betas differ by {np.array2string(np.array(beta_diff), precision=3)}; keypoint "
              f"gap frame 0 {np.array2string(1e3 * gaps[:, 0], precision=4)} mm (bounds "
              f"{np.array2string(1e3 * kp_bound)} mm), worst frame {1e3 * gaps.max():.4f} mm "
              f"(closed loop)", flush=True)
        if (gaps[:, 0] > kp_bound).any():
            raise AssertionError("[hand batched] frame 0 differs from the unbatched runner's")

        # the batched tracker on the first frames, seeded masks a sequence
        cfg = load_config(argv)
        mano = get_mano_model(cfg.get("mano_root")).to("cuda")
        loader = get_dataloader(cfg, "test")
        hj = cfg["hand_jitter_cfg"]
        gen = torch.Generator().manual_seed(0)
        with noting_shapes(seen):
            batches = [prepare_batch(mano, loader[i][0], HAND_NUM_POINTS, generator=gen,
                                     hand_jitter_scale=hj["rand_scale"],
                                     jitter_kind=hj["rand_type"], device="cuda")
                       for i in range(HAND_SEQS)]
        short = _tree(lambda x: x[:, :HAND_BATCH_SHORT].contiguous(),
                      run_hand_track._stack_tree(batches))
        masks = torch.from_numpy(np.random.RandomState(31).rand(
            HAND_SEQS, HAND_BATCH_SHORT, *HAND_HW) > 0.5).cuda()
        volume = run_hand_track._hand_volume(cfg, loader[0][1][0], "cuda")
        kwargs = dict(
            iknet=run_hand_track.load_iknet(cfg, "cuda"), use_opt=True, shape_mode=1,
            shape_particles=torch.from_numpy(stats["shape_particles"]).cuda(),
            pose_particles=torch.from_numpy(stats["pose_particles"]).cuda(),
            zones=load_contact_zones(device="cuda"), background_masks=masks,
            energy_weight=HAND_WEIGHTS, sdf_voxel_scale=run_hand_track.HAND_VOXEL_SCALE,
            sdf_volumes=torch.stack([volume] * HAND_SEQS))
        handnet = run_hand_track.load_handnet(cfg, "cuda")
        cuda_fits = [distilled_to(f, "cuda") for f in fits]
        per_frame = HAND_ITERATIONS * HAND_BATCH_SHORT
        ref = None
        for tag, extra, want in (
                ("masks", dict(hand_energy="skin", distilled=cuda_fits),
                 {"hand_energy_skin_batched": per_frame}),
                ("fused", dict(hand_energy="fused", distilled=cuda_fits),
                 {"sdf_mlp_batched": per_frame, "packed_mask_lookup_batched": per_frame}),
                ("separate", dict(hand_energy="separate", distilled=cuda_fits),
                 {"sdf_mlp_batched": per_frame, "packed_mask_lookup_batched": per_frame}),
                ("volume", dict(distilled=None), {"packed_mask_lookup_batched": per_frame})):
            kernels.reset_launch_counts()
            with noting_shapes(seen):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                result = track_hand_sequences_batched(handnet, mano, short, **kwargs, **extra)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t1) / HAND_BATCH_SHORT
            counts = dict(kernels.launch_counts)
            by_path[f"hand_batched_{tag}"] = counts
            got = {k: v for k, v in counts.items() if k not in ("fps", "gather_rows") and v}
            if got != want or not all(bool(torch.isfinite(t).all()) for t in result):
                raise AssertionError(f"[hand batched] route {tag} launched {counts}, expected "
                                     f"{want}")
            ref = result.pred_kp if ref is None else ref
            gap = (result.pred_kp - ref).abs().reshape(HAND_SEQS, HAND_BATCH_SHORT, -1)
            print(f"[hand batched] cuda, track_hand_sequences_batched, {HAND_SEQS} x "
                  f"{HAND_BATCH_SHORT} frames with seeded {HAND_HW} masks a sequence, route "
                  f"{'skin' if tag == 'masks' else tag}: {ms:.3f} ms a chunk-frame; launches "
                  f"{got}; keypoints against the skin route's: frame 0 "
                  f"{1e3 * float(gap[:, 0].max()):.4f} mm, worst {1e3 * float(gap.max()):.4f} mm",
                  flush=True)
        return by_path
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _hold_batched_open_loop(tag: str, res, points, init_r, init_t, bank, fits,
                            energy: str) -> None:
    """The batched run `res`, frame by frame from its own previous poses: the
    batched optimiser again (bitwise the same poses) and the unbatched one on
    each sequence (iteration-0 energies within OPEN_SDF_ATOL_M of the mean
    |sdf|, poses within a step of the search, as `_hold_open_loop` holds the
    routes)."""
    from hotrack_tpu_torch.opt import optimize_obj_pose
    from hotrack_tpu_torch.ops.sdf_mlp import pack_distilled, pack_distilled_batched
    packed_b = pack_distilled_batched(fits)
    packs = [pack_distilled(m) for m in fits]
    n_seq, n_frames = points.shape[:2]
    e_gap = 0.0
    poses = {"batched": {"rotation": [], "translation": []},
             "one": {"rotation": [], "translation": []}}
    for f in range(n_frames):
        r0 = init_r if f == 0 else res.rotation[:, f - 1]
        t0 = init_t if f == 0 else res.translation[:, f - 1]
        trace = []
        rb, tb, _ = optimize_obj_pose(None, bank, points[:, f], r0, t0, distilled=fits,
                                      obj_energy=energy, packed=packed_b, trace=trace)
        if not (torch.equal(rb, res.rotation[:, f]) and torch.equal(tb, res.translation[:, f])):
            raise AssertionError(f"[object batched] {tag}: frame {f} again from the same poses "
                                 f"does not give the same poses bitwise")
        for i in range(n_seq):
            one_trace = []
            r1, t1, _ = optimize_obj_pose(None, bank, points[i, f], r0[i], t0[i],
                                          distilled=fits[i], obj_energy=energy,
                                          packed=packs[i], trace=one_trace)
            e_gap = max(e_gap, float((trace[0][0][i] - one_trace[0][0]).abs().max()) / 500.0)
            for key, a, b in (("rotation", rb[i], r1), ("translation", tb[i], t1)):
                poses["batched"][key].append(a.cpu().numpy())
                poses["one"][key].append(b.cpu().numpy())
    rot, trans = _pose_gap(*({k: np.stack(v) for k, v in poses[w].items()}
                             for w in ("batched", "one")))
    tight = (rot <= OPEN_TIGHT_ROT_DEG) & (trans <= OPEN_TIGHT_TRANS_M)
    print(f"[object batched] {tag}, open loop over {n_frames} frames x {n_seq} sequences (the "
          f"batched optimiser again: bitwise the same poses): iteration-0 mean |sdf| of the "
          f"batched and the unbatched optimiser differ by at most {e_gap:.3e} m (bound "
          f"{OPEN_SDF_ATOL_M} m); pose gap up to {rot.max():.2e} deg / {1e3 * trans.max():.2e} mm, "
          f"{int(tight.sum())} of {tight.size} within {OPEN_TIGHT_ROT_DEG} deg / "
          f"{1e3 * OPEN_TIGHT_TRANS_M} mm", flush=True)
    if e_gap > OPEN_SDF_ATOL_M or tight.mean() < OPEN_TIGHT_SHARE \
            or rot.max() > OPEN_ROT_BOUND_DEG or trans.max() > OPEN_TRANS_BOUND_M:
        raise AssertionError(f"[object batched] {tag}: open-loop energies or poses differ "
                             f"beyond the bound")


def phase_object_batched(card: str, seen: dict) -> dict:
    """`track_obj_sequences_batched` at OBJ_SEQS x 2048 particles x 1024
    points x 10 iterations on a set of OBJ_SEQS sequences, a fit a sequence,
    on the fused (#4b) and composed (#3b) routes; held against the unbatched
    runner on the same sequences and fits closed loop (the tracker's
    accuracy) and open loop."""
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.sdf.assets import synthetic_box_sdf_setup
    from hotrack_tpu_torch.sdf.distill import distill_sdf_volume, distilled_to
    from hotrack_tpu_torch.track import track_obj_sequences_batched
    from hotrack_tpu_torch.train.cli import load_config
    from hotrack_tpu_torch.train.run_obj_track import (VOLUME_SIZE, VOXEL_SCALE,
                                                       run_obj_tracking)
    root = _obj_dataset(OBJ_BATCH_FRAMES, OBJ_SEQS)
    frames = OBJ_BATCH_FRAMES
    try:
        os.environ["HOTRACK_DATA_ROOT"] = root
        t0 = time.perf_counter()
        volume = synthetic_box_sdf_setup(VOLUME_SIZE, VOXEL_SCALE, device="cuda")
        fits = [distill_sdf_volume(volume, VOXEL_SCALE, torch.Generator().manual_seed(40 + i),
                                   steps=BATCH_FIT_STEPS) for i in range(OBJ_SEQS)]
        torch.cuda.synchronize()
        fit_s = (time.perf_counter() - t0) / OBJ_SEQS
        _fits_differ("object batched", fits)
        cfg = load_config(["--config", OBJ_CONFIG, "--device", "cuda", "--num_points",
                           str(OBJ_NUM_POINTS), "--data_cfg/num_frames", str(frames),
                           "--sdf_query", "distilled"])
        # the unbatched runner: each sequence's inputs, and the reference runs
        kernels.reset_launch_counts()
        with noting_shapes(seen):
            _, one = run_obj_tracking(cfg, distilled=[distilled_to(f, "cpu") for f in fits])
        torch.cuda.synchronize()
        by_path = {"object_batched_one_at_a_time": dict(kernels.launch_counts)}
        if by_path["object_batched_one_at_a_time"]["obj_sdf_energy"] \
                != OBJ_ITERATIONS * frames * OBJ_SEQS:
            raise AssertionError(f"[object batched] the unbatched runner launched "
                                 f"{by_path['object_batched_one_at_a_time']}")
        seqs = one["sequences"]
        points = torch.from_numpy(np.stack([q["obj_points"] for q in seqs])).cuda()
        init_r = torch.from_numpy(np.stack([q["init_rotation"] for q in seqs])).cuda()
        init_t = torch.from_numpy(np.stack([q["init_translation"] for q in seqs])).cuda()
        bank = torch.from_numpy(one["particles"]).cuda()
        ms_one = 1e3 * one["net_seconds"] / one["n_frames"]
        results = {}
        for energy, name in (("fused", "obj_sdf_energy_batched"), ("composed", "sdf_mlp_batched")):
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            with noting_shapes(seen):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                res = track_obj_sequences_batched(None, bank, points, init_r, init_t,
                                                  voxel_scale=VOXEL_SCALE, bbox_res=VOLUME_SIZE,
                                                  distilled=fits, obj_energy=energy)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t1) / frames
            counts = dict(kernels.launch_counts)
            by_path["object_batched" if energy == "fused" else "object_batched_composed"] = counts
            if {k: v for k, v in counts.items() if v} != {name: OBJ_ITERATIONS * frames}:
                raise AssertionError(f"[object batched] {energy} route launched {counts}")
            if not all(bool(torch.isfinite(t).all()) for t in res):
                raise AssertionError(f"[object batched] {energy} route: non-finite poses")
            results[energy] = res
            rot, trans = [], []
            for i, q in enumerate(seqs):
                r, t = _pose_gap({"rotation": res.rotation[i].cpu().numpy(),
                                  "translation": res.translation[i].cpu().numpy()}, q)
                rot.append(r), trans.append(t)
            print(f"[object batched] cuda, track_obj_sequences_batched, {energy} route: "
                  f"{OBJ_SEQS} sequences x {frames} frames x {OBJ_PARTICLES} particles x "
                  f"{OBJ_NUM_POINTS} points x {OBJ_ITERATIONS} iterations; {ms:.3f} ms a "
                  f"chunk-frame ({1e3 * OBJ_SEQS / ms:.2f} frames/s) against the unbatched "
                  f"runner's {ms_one:.3f} ms/frame ({1e3 / ms_one:.2f} frames/s): "
                  f"{ms_one * OBJ_SEQS / ms:.3f}x the aggregate frames/s; peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; {OBJ_SEQS} fits of "
                  f"{BATCH_FIT_STEPS} steps, {fit_s:.2f} s each | {card}", flush=True)
            _hold_closed_loop(f"batched {energy} route vs the unbatched fused runner",
                              np.concatenate(rot), np.concatenate(trans))
            _hold_batched_open_loop(f"{energy} route", res, points, init_r, init_t, bank,
                                    fits, energy)
        return by_path
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------------------
# the real-data layouts (HO3D, DexYCB) and online serving

def _real_run(tag: str, config: str, seen: dict, *extra):
    """One run of a shipped config through `test_main` on the card, on the
    data under HOTRACK_DATA_ROOT. Returns (mean metrics, stats, launches)."""
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.train.cli import test_main
    kernels.reset_launch_counts()
    with noting_shapes(seen):
        avg, stats = test_main(["--config", config, "--device", "cuda", *extra])
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    if not all(math.isfinite(v) for v in avg.values()):
        raise AssertionError(f"[{tag}] {config}: non-finite metrics {avg}")
    for seq in stats["sequences"]:
        for key in ("pred_kp", "rotation", "translation"):
            if key in seq and not np.isfinite(seq[key]).all():
                raise AssertionError(f"[{tag}] {config}: non-finite {key}")
    return avg, stats, launches


def _ho3d_split(base: str, frames: int) -> None:
    """The test split: the tree's sequence, its first `frames` frames."""
    np.save(os.path.join(base, "splits", "finalv2_test_bottle.npy"),
            {"ABF10": {0: list(range(frames))}})


def _hold_native_on_host(base: str) -> None:
    """The native library against its numpy versions on this machine's host,
    on one HO3D frame: the decode bitwise, the back-projection within
    NATIVE_RTOL of each coordinate with the same points (the numpy version
    given the intrinsics rounded to float32, as the library takes them)."""
    from hotrack_tpu_torch import native
    from hotrack_tpu_torch.data.ho3d import DEPTH_SCALE, read_seg_mask
    from hotrack_tpu_torch.data.image import imread
    from hotrack_tpu_torch.data.real_trees import INTRINSICS as k
    img = imread(os.path.join(base, "train", "ABF10", "depth", "0000.png"))
    depth = native.decode_ho3d_depth(img, DEPTH_SCALE)
    if not np.array_equal(depth, native.decode_ho3d_depth_numpy(img, DEPTH_SCALE)):
        raise AssertionError("[native] the depth decode differs from its numpy version")
    mask = (read_seg_mask(os.path.join(base, "train", "ABF10", "seg", "0000.png"))[..., 0]
            == 255).astype(np.uint8)
    # the numpy version takes the intrinsics as the library does, in float32
    intrinsics = [float(np.float32(k[key])) for key in ("fx", "fy", "cx", "cy")]
    got = native.backproject_filter(depth, mask, 1, *intrinsics, -1.0, -1.0)
    want = native.backproject_filter_numpy(depth, mask, 1, *intrinsics, -1.0, -1.0)
    gap = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    print(f"[native] {native.library_path().name} on this host: decode bitwise its numpy "
          f"version; back-projection of {len(got)} hand points within {gap.max():.3e} of the "
          f"float64 numpy version, relative (bound {NATIVE_RTOL:.3e})", flush=True)
    if got.shape != want.shape or gap.max() > NATIVE_RTOL:
        raise AssertionError("[native] the back-projection differs from its numpy version")


def _trace_kernels(trace_dir: str) -> set:
    """The names of the device kernels in the Chrome trace under trace_dir."""
    (name,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name", "") for e in events if e.get("cat") == "kernel"}


def real_tree() -> dict:
    """The HO3D tree of phases 11 and 12 (data/real_trees.py), written before
    the kernels phase: its reconstruction mesh's vertex count is a shape FPS
    is held at there. The DeepSDF decoder is the shipped 8 x 512 one, seeded
    and shaped into an object (real_trees.decoder_object); its gt and
    reconstruction meshes are marching-tetrahedra meshes at REAL_MESH_RES^3.
    Returns {'root', 'tree', 'latent' (the seeded code, on the CPU),
    'fps_shape' (the chamfer evaluation's FPS: B, N, npoint, masked)}."""
    from hotrack_tpu_torch.data.real_trees import write_ho3d_tree
    from hotrack_tpu_torch.sdf.assets import build_decoder
    from hotrack_tpu_torch.train.cli import load_config
    root = tempfile.mkdtemp(prefix="hotrack_smoke_real_")
    os.environ["HOTRACK_DATA_ROOT"] = root
    t0 = time.perf_counter()
    specs = load_config(["--config", REAL_OBJ_CONFIG])["opt"]["NetworkSpecs"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(DECODER_SEED)
        decoder = build_decoder(specs).eval().cuda()
    latent = (torch.randn(256, generator=torch.Generator().manual_seed(DECODER_SEED))
              * 0.01).cuda()
    tree = write_ho3d_tree(root, REAL_OBJ_FRAMES, decoder=decoder, latent=latent,
                           mesh_res=REAL_MESH_RES)
    verts, faces = tree["mesh"]
    extent = tree["object"].max(0) - tree["object"].min(0)
    print(f"[real] HO3D tree ({REAL_OBJ_FRAMES} frames of 480 x 640, the shipped 8 x 512 "
          f"DeepSDF decoder seeded and shaped into an object of {len(tree['object'])} "
          f"surface points, extent {np.array2string(1e3 * extent, precision=1)} mm; its "
          f"meshes at {REAL_MESH_RES}^3: {len(verts)} vertices, {len(faces)} faces) written "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    if len(verts) <= _fps_shared_max():
        raise AssertionError(f"[real] the reconstruction has {len(verts)} vertices: the "
                             f"chamfer evaluation's FPS would not reach the global-memory "
                             f"kernel above {_fps_shared_max()}")
    fps_shape = (1, len(verts), CHAMFER_SAMPLES, False)
    FPS_SHAPES.append(("chamfer reconstruction mesh", *fps_shape))
    return {"root": root, "tree": tree, "latent": latent.cpu(), "fps_shape": fps_shape}


def phase_real_paths(card: str, seen: dict, real: dict) -> dict:
    """The shipped HO3D and DexYCB configs through `test_main` on trees in
    their layouts (data/real_trees.py): objopt_test_HO3D at its operating
    point (with the chamfer distances of the tree's meshes, FPS's global-memory
    kernel on the reconstruction's vertices) writes the predicted-pose
    pickles that handopt_test_HO3D reads; then handtracknet_test_HO3D (under
    --profile), handiknet_test_HO3D and handtracknet_test_DexYCB."""
    from hotrack_tpu_torch.data.ho3d import HO3DDataset
    from hotrack_tpu_torch.data.real_trees import write_dexycb_tree
    from hotrack_tpu_torch.pose.metrics import rot_diff_degree
    from hotrack_tpu_torch.train.cli import load_config
    from hotrack_tpu_torch.train.run_hand_track import build_iknet
    from hotrack_tpu_torch.utils.convert import save_reference_checkpoint
    root, tree = real["root"], real["tree"]
    os.environ["HOTRACK_DATA_ROOT"] = root
    hand_cfg = load_config(["--config", REAL_HAND_CONFIG])
    _write_checkpoint(hand_cfg)
    save_reference_checkpoint(build_iknet(hand_cfg, "cpu"),
                              os.path.join(hand_cfg["IKNet_dir"], "ckpt", "model_0001.pt"))
    write_dexycb_tree(root, REAL_HAND_FRAMES)
    _hold_native_on_host(tree["basepath"])

    # objopt: 2048 particles x 1024 points x 10 iterations, the fused kernel
    # (its FPS shapes noted apart: the chamfer mesh's must be among them)
    local = {name: set() for name in KERNELS}
    avg, stats, launches = _real_run("real", REAL_OBJ_CONFIG, local, "--save")
    for name, shapes in local.items():
        seen[name] |= shapes
    seq = dict(stats["sequences"][0], particles=stats["particles"])
    frames = stats["n_frames"]
    if launches["obj_sdf_energy"] != OBJ_ITERATIONS * frames or launches["sdf_mlp"] \
            or frames != REAL_OBJ_FRAMES:
        raise AssertionError(f"[real] objopt on {frames} frames launched {launches}")
    _require_launches("real", launches, {"gather_rows": PER_PREPARE})
    chamfer = {k: avg.get(k) for k in CHAMFER_KEYS}
    if launches["fps"] != PER_PREPARE + 1 or real["fps_shape"] not in local["fps"] \
            or not all(v is not None and math.isfinite(v) for v in chamfer.values()):
        raise AssertionError(f"[real] objopt: FPS at {sorted(local['fps'])} "
                             f"({launches['fps']} launches), chamfer {chamfer}: expected "
                             f"the chamfer evaluation's FPS at {real['fps_shape']}")
    print(f"[real] cuda, objopt_test_HO3D chamfer to the gt mesh: {chamfer} (FPS of "
          f"{real['fps_shape'][1]} reconstruction vertices to {CHAMFER_SAMPLES} on the "
          f"global-memory kernel)", flush=True)
    gt0 = torch.from_numpy(seq["gt_rotation"][0])
    init_r = float(rot_diff_degree(gt0, torch.from_numpy(seq["init_rotation"]), 1))
    init_t = float(np.linalg.norm(seq["init_translation"] - seq["gt_translation"][0]))
    ms_obj = 1e3 * stats["net_seconds"] / frames
    print(f"[real] cuda, objopt_test_HO3D: {frames} frames of {OBJ_PARTICLES} particles x "
          f"{OBJ_NUM_POINTS} points x {OBJ_ITERATIONS} iterations, tracking {ms_obj:.3f} "
          f"ms/frame; set-up {seq['setup_seconds']:.2f} s of which distillation "
          f"{seq['distill_seconds']:.2f} s (the 201^3 volume baked from the decoder); "
          f"launches {launches}; jittered init {init_r:.3f} deg / {1e3 * init_t:.2f} mm -> "
          f"mean {seq['rdiff'].mean():.3f} deg / {1e3 * seq['tdiff'].mean():.2f} mm, worst "
          f"{seq['rdiff'].max():.3f} deg / {1e3 * seq['tdiff'].max():.2f} mm | {card}",
          flush=True)
    if not (seq["tdiff"].max() < init_t and seq["rdiff"].max() < REAL_ROT_BOUND_DEG):
        raise AssertionError("[real] the HO3D object's translation error did not fall "
                             "below the jittered initialisation's, or its rotation error "
                             f"passed {REAL_ROT_BOUND_DEG} deg")
    _hold_open_loop("HO3D objopt, card vs CPU (plain versions), same fit", seq,
                    seq["particles"], seq["distilled"], OBJ_CPU_FRAMES, "cpu", "fused",
                    tight_share=1.0 / OBJ_CPU_FRAMES, sdf_atol=REAL_OPEN_SDF_ATOL_M)
    by_path = {"ho3d_objopt": launches}

    # handopt on the first frames, through the object poses just written
    _ho3d_split(tree["basepath"], REAL_HAND_FRAMES)
    avg, stats, launches = _real_run("real", REAL_HAND_CONFIG, seen, "--save")
    frames = stats["n_frames"]
    expect = {"fps": PER_PREPARE + FPS_PER_FORWARD * (frames + 1),
              "gather_rows": PER_PREPARE + GATHERS_PER_FORWARD * (frames + 1),
              "hand_energy_skin": HAND_ITERATIONS * frames}
    if {k: v for k, v in launches.items() if v} != expect or frames != REAL_HAND_FRAMES:
        raise AssertionError(f"[real] handopt launched {launches}, expected {expect}")
    cfg = load_config(["--config", REAL_HAND_CONFIG])
    read = HO3DDataset(dict(cfg, num_points=HAND_NUM_POINTS), "test")[3][0]
    if not np.array_equal(read.pred_obj_rotation, seq["rotation"][3]):
        raise AssertionError("[real] handopt did not read objopt's pose of frame 3")
    hseq = stats["sequences"][0]
    print(f"[real] cuda, handopt_test_HO3D (use_pred_obj_pose: objopt's poses, read back "
          f"bitwise): {frames} frames at {HAND_NUM_POINTS} points, {HAND_PARTICLES} particles "
          f"x {HAND_VERTS} vertices x {HAND_ITERATIONS} iterations against {HAND_HW} masks; "
          f"tracking {1e3 * stats['net_seconds'] / frames:.3f} ms/frame (the frame-0 shape "
          f"optimiser included); set-up {hseq['setup_seconds']:.2f} s of which "
          f"distillation {hseq['distill_seconds']:.2f} s; launches {launches}; metrics "
          f"{avg} | {card}", flush=True)
    by_path["ho3d_handopt"] = launches

    trace_dir = tempfile.mkdtemp(prefix="hotrack_smoke_trace_")
    avg, stats, launches = _real_run("real", "handtracknet_test_HO3D.yml", seen,
                                     "--profile", trace_dir)
    names = _trace_kernels(trace_dir)
    found = {k for k in ("fps_kernel", "gather_rows_kernel") if any(k in n for n in names)}
    print(f"[real] cuda, handtracknet_test_HO3D under --profile: {stats['n_frames']} frames; "
          f"the trace names {len(names)} kernels, ours among them: "
          f"{sorted(n for n in names if 'fps_kernel' in n or 'gather_rows' in n)}",
          flush=True)
    if found != {"fps_kernel", "gather_rows_kernel"}:
        raise AssertionError(f"[real] the --profile trace names no kernel of the path: "
                             f"{sorted(names)[:20]}")
    shutil.rmtree(trace_dir, ignore_errors=True)
    by_path["ho3d_handtracknet"] = launches
    for tag, config, forwards in (("ho3d_handiknet", "handiknet_test_HO3D.yml", 1),
                                  ("dexycb_handtracknet", "handtracknet_test_DexYCB.yml", 0)):
        avg, stats, launches = _real_run("real", config, seen)
        n = stats["n_frames"] + forwards
        _require_launches("real", launches, {"fps": PER_PREPARE + FPS_PER_FORWARD * n,
                                             "gather_rows": PER_PREPARE
                                             + GATHERS_PER_FORWARD * n})
        print(f"[real] cuda, {config}: {stats['n_frames']} frames, "
              f"{1e3 * stats['net_seconds'] / stats['n_frames']:.3f} ms/frame; launches "
              f"{ {k: v for k, v in launches.items() if v} }; metrics {avg}", flush=True)
        by_path[tag] = launches
    return by_path


def phase_shape_update(card: str, seen: dict, real: dict) -> dict:
    """objopt_test_HO3D with `--opt/updateobjshape True` through `test_main`
    on the real tree, SHAPE_FRAMES frames: the volume route on a volume
    re-baked from the refined latent, one update and one re-bake, the refined
    mesh written and read back; the latent moved and every frame's
    translation error below the jittered initialisation's."""
    from hotrack_tpu_torch.sdf.mesh import load_mesh
    os.environ["HOTRACK_DATA_ROOT"] = real["root"]
    _ho3d_split(real["tree"]["basepath"], SHAPE_FRAMES)
    avg, stats, launches = _real_run("shape", REAL_OBJ_CONFIG, seen, "--opt/updateobjshape",
                                     "True")
    seq, frames = stats["sequences"][0], stats["n_frames"]
    expect = {"fps": PER_PREPARE + 1, "gather_rows": PER_PREPARE}
    if {k: v for k, v in launches.items() if v} != expect or frames != SHAPE_FRAMES:
        raise AssertionError(f"[shape] {frames} frames launched {launches}, expected {expect}")
    moved = float((seq["latent"] - real["latent"]).abs().max())
    verts, faces = load_mesh(seq["updated_mesh"]) if seq["updated_mesh"] else ((), ())
    init_t = float(np.linalg.norm(seq["init_translation"] - seq["gt_translation"][0]))
    chamfer = {k: avg.get(k) for k in CHAMFER_KEYS}
    extra = sum(seq["bake_seconds"] + seq["update_seconds"] + seq["rebake_seconds"]) \
        + seq["export_seconds"]
    print(f"[shape] cuda, objopt_test_HO3D --opt/updateobjshape True: {frames} frames of "
          f"{OBJ_PARTICLES} particles x {OBJ_NUM_POINTS} points x {OBJ_ITERATIONS} iterations "
          f"on the re-baked volume, {1e3 * stats['net_seconds'] / frames:.3f} ms/frame with the "
          f"bakes, the update and the mesh export, {1e3 * (stats['net_seconds'] - extra) / frames:.3f} "
          f"without; set-up {seq['setup_seconds']:.2f} s; "
          f"first bake {seq['bake_seconds']} s, update {seq['update_seconds']} s, re-bake "
          f"{seq['rebake_seconds']} s, mesh "
          f"export {seq['export_seconds']:.2f} s ({len(verts)} vertices, {len(faces)} faces); "
          f"latent moved by {moved:.4e}; jittered init {1e3 * init_t:.2f} mm -> mean "
          f"{1e3 * seq['tdiff'].mean():.2f} mm, worst {1e3 * seq['tdiff'].max():.2f} mm; "
          f"chamfer {chamfer}; launches {launches} | {card}", flush=True)
    if seq["sdf_query"] != "volume" or len(seq["update_seconds"]) != 1 \
            or len(seq["rebake_seconds"]) != 1 or not moved > 1e-4:
        raise AssertionError("[shape] expected one latent update and one re-bake on the "
                             "volume route")
    if not seq["updated_mesh"].endswith("_update.ply") or not len(verts) \
            or faces.max() >= len(verts):
        raise AssertionError(f"[shape] the refined mesh {seq['updated_mesh']} does not read back")
    if not (seq["tdiff"].max() < init_t and all(v is not None and math.isfinite(v)
                                               for v in chamfer.values())):
        raise AssertionError("[shape] a translation error did not fall below the jittered "
                             "initialisation's, or the chamfer distances are missing")
    return {"ho3d_shape_update": launches}


def phase_library(card: str, seen: dict) -> dict:
    """PointNet2Encoder (the tracking config's backbone, batch 1, 512 points)
    and a point-transformer down / up stack on 512 points, eval mode, seeded
    weights and running statistics: on the card (FPS and the row gathers on
    the kernels) against the same modules on the CPU (plain versions),
    within LIBRARY_ATOL; the centres FPS picks are bitwise alike."""
    from hotrack_tpu_torch.nn import PointNet2Encoder
    from hotrack_tpu_torch.nn.point_transformer import (PointTransformerDownBlock,
                                                        PointTransformerUpBlock)
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.train.cli import load_config
    net_cfg = load_config(["--config", CONFIG])["pointnet"]["camera"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(31)
        mods = [PointNet2Encoder(net_cfg, 128),
                PointTransformerDownBlock(PT_NPOINT, PT_NSAMPLE, PT_DIM),
                PointTransformerUpBlock(PT_NSAMPLE, PT_DIM, PT_DIM)]
        for mod in (m for module in mods for m in module.modules()):
            if isinstance(mod, torch.nn.BatchNorm1d):
                mod.running_mean.uniform_(-0.1, 0.1)
                mod.running_var.uniform_(0.5, 1.5)
    rng = np.random.RandomState(32)
    xyz = torch.from_numpy((rng.randn(1, PT_POINTS, 3) * 0.05).astype(np.float32))
    feats = torch.from_numpy(rng.randn(1, PT_POINTS, PT_DIM).astype(np.float32))

    def run(device):
        enc, down, up = (m.eval().to(device) for m in mods)
        x, f = xyz.to(device), feats.to(device)
        with torch.no_grad():
            code = enc(x)
            x2, f2 = down(x)
            out = up(x2, x, f2, f)
        return [t.cpu() for t in (code, x2, f2, out)]

    kernels.reset_launch_counts()
    with noting_shapes(seen):
        got = run("cuda")
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    want = run("cpu")
    gaps = [float((a - b).abs().max()) for a, b in zip(got, want)]
    print(f"[library] cuda vs cpu, eval mode: PointNet2Encoder (1,{PT_POINTS},3) -> "
          f"{tuple(got[0].shape)}, point-transformer down ({PT_NPOINT} centres, {PT_NSAMPLE} "
          f"neighbours) and up ({PT_DIM} channels): max |diff| encoder {gaps[0]:.3e}, centres "
          f"{gaps[1]:.3e}, down {gaps[2]:.3e}, up {gaps[3]:.3e} (bound {LIBRARY_ATOL:.0e}); "
          f"launches { {k: v for k, v in launches.items() if v} } | {card}", flush=True)
    _require_launches("library", launches, {"fps": 3, "gather_rows": 7})
    if gaps[1] != 0.0 or max(gaps) > LIBRARY_ATOL:
        raise AssertionError("[library] the card differs from the CPU")
    return {"library": launches}


def _ms(fn) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _same(tag: str, got, want) -> None:
    for key, value in want.items():
        a = got[key] if isinstance(got[key], np.ndarray) else got[key].cpu().numpy()
        b = value if isinstance(value, np.ndarray) else value.cpu().numpy()
        if not np.array_equal(a, b):
            raise AssertionError(f"[serve] {tag}: {key} is not bitwise the reference")


def phase_serving(card: str, seen: dict, hand_fit, obj_fit) -> dict:
    """`track/stream.py` on the card at the hand path's operating point (IKNet,
    the frame-0 shape optimiser and the pose optimiser on the skin route, with
    seeded 480 x 640 masks) and the object path's (fused route): the trackers
    stepped frame by frame against the offline trackers, serve at depths 1 and
    2 and serve_combined against the steps, all bitwise; ms/frame of each."""
    from hotrack_tpu_torch.data import get_dataloader, prepare_batch
    from hotrack_tpu_torch.mano.model import get_mano_model
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.opt import load_contact_zones, presample_particles
    from hotrack_tpu_torch.sdf.distill import distilled_to
    from hotrack_tpu_torch.track import (HandTracker, ObjTracker, serve_combined,
                                         track_hand_sequence, track_obj_sequence)
    from hotrack_tpu_torch.train.cli import load_config
    from hotrack_tpu_torch.train.run_hand_track import (HAND_VOXEL_SCALE, load_handnet,
                                                        load_iknet)
    t = SERVE_FRAMES
    hand_root, obj_root = _hand_dataset(t), _obj_dataset(t)
    try:
        os.environ["HOTRACK_DATA_ROOT"] = hand_root
        cfg = load_config(_hand_argv())
        mano = get_mano_model(cfg.get("mano_root")).to("cuda")
        gen = torch.Generator().manual_seed(21)
        with noting_shapes(seen):
            batch = prepare_batch(mano, get_dataloader(cfg, "test")[0][0], HAND_NUM_POINTS,
                                  generator=gen, hand_jitter_scale=0.01, device="cuda")
        masks = torch.from_numpy(np.random.RandomState(22).rand(t, *HAND_HW) > 0.5).cuda()
        hand_kwargs = dict(
            iknet=load_iknet(cfg, "cuda"), use_opt=True, shape_mode=1,
            shape_particles=presample_particles(HAND_PARTICLES, 10, gen, device="cuda"),
            pose_particles=presample_particles(HAND_PARTICLES, 16, gen, device="cuda"),
            zones=load_contact_zones(device="cuda"), energy_weight=HAND_WEIGHTS,
            sdf_voxel_scale=HAND_VOXEL_SCALE, distilled=distilled_to(hand_fit, "cuda"))
        handnet = load_handnet(cfg, "cuda")
        hand_frames = [{"hand_points": batch["hand_points"][f], "background_mask": masks[f],
                        "obj_rotation": batch["gt_obj_pose"]["rotation"][f],
                        "obj_translation": batch["gt_obj_pose"]["translation"][f],
                        "projection": batch["projection"][f]} for f in range(t)]

        os.environ["HOTRACK_DATA_ROOT"] = obj_root
        ocfg = load_config(["--config", OBJ_CONFIG, "--device", "cuda", "--num_points",
                            str(OBJ_NUM_POINTS)])
        oj = ocfg["obj_jitter_cfg"]
        with noting_shapes(seen):
            obatch = prepare_batch(mano, get_dataloader(ocfg, "test")[0][0], OBJ_NUM_POINTS,
                                   generator=gen, obj_jitter={
                                       "rotation": float(np.deg2rad(oj["r"])),
                                       "translation": oj["t"], "scale": oj["s"]},
                                   obj_jitter_kind=oj["type"], device="cuda")
        clouds = obatch["obj_points"]
        r0 = obatch["jittered_obj_pose"]["rotation"][0]
        t0 = obatch["jittered_obj_pose"]["translation"][0]
        bank = presample_particles(OBJ_PARTICLES, 6, gen, device="cuda")
        ofit = distilled_to(obj_fit, "cuda")

        by_path, ms = {}, {}
        with noting_shapes(seen):
            offline, ms["hand offline"] = _ms(lambda: track_hand_sequence(
                handnet, mano, batch, background_masks=masks, **hand_kwargs))
            tracker = HandTracker(handnet, mano, **hand_kwargs)

            def hand_state():
                return tracker.init_state(batch["hand_points"][0], batch["jittered_hand_kp"][0])

            def stepped():
                state, outs = hand_state(), []
                for frame in hand_frames:
                    state, out = tracker.step(state, **frame)
                    outs.append(out)
                return outs

            steps, ms["hand step"] = _ms(stepped)
            _same("HandTracker.step against track_hand_sequence",
                  {k: torch.stack([o[k] for o in steps]) for k in ("pred_kp", "MANO_theta")},
                  {"pred_kp": offline.pred_kp, "MANO_theta": offline.mano_theta})
            for depth in (1, 2):
                kernels.reset_launch_counts()
                got, ms[f"hand serve depth {depth}"] = _ms(lambda: list(tracker.serve(
                    hand_state(), hand_frames, fetch=("pred_kp", "MANO_theta"), depth=depth)))
                by_path[f"serve_hand_depth{depth}"] = dict(kernels.launch_counts)
                for g, s in zip(got, steps):
                    _same(f"hand serve(depth={depth}) against the steps", g,
                          {k: s[k] for k in ("pred_kp", "MANO_theta")})
            if by_path["serve_hand_depth1"]["hand_energy_skin"] != HAND_ITERATIONS * t:
                raise AssertionError(f"[serve] hand serving launched {by_path['serve_hand_depth1']}")

            offline_o, ms["object offline"] = _ms(lambda: track_obj_sequence(
                None, bank, clouds, r0, t0, distilled=ofit, obj_energy="fused"))
            otracker = ObjTracker(None, bank, distilled=ofit, obj_energy="fused")

            def obj_stepped():
                state, outs = otracker.init_state(r0, t0), []
                for pts in clouds:
                    state, out = otracker.step(state, pts)
                    outs.append(out)
                return outs

            osteps, ms["object step"] = _ms(obj_stepped)
            _same("ObjTracker.step against track_obj_sequence",
                  {k: torch.stack([o[k] for o in osteps]) for k in ("rotation", "translation")},
                  {"rotation": offline_o.rotation, "translation": offline_o.translation})
            for depth in (1, 2):
                kernels.reset_launch_counts()
                got, ms[f"object serve depth {depth}"] = _ms(lambda: list(otracker.serve(
                    otracker.init_state(r0, t0), list(clouds), depth=depth)))
                by_path[f"serve_obj_depth{depth}"] = dict(kernels.launch_counts)
                for g, s in zip(got, osteps):
                    _same(f"object serve(depth={depth}) against the steps", g,
                          {k: s[k] for k in ("rotation", "translation")})
            if by_path["serve_obj_depth1"]["obj_sdf_energy"] != OBJ_ITERATIONS * t:
                raise AssertionError(f"[serve] object serving launched {by_path['serve_obj_depth1']}")

            def both_stepped():
                h, o, outs = hand_state(), otracker.init_state(r0, t0), []
                for frame, pts in zip(hand_frames, clouds):
                    h, h_out = tracker.step(h, **frame)
                    o, o_out = otracker.step(o, pts)
                    outs.append({"pred_kp": h_out["pred_kp"], "obj_rotation": o_out["rotation"],
                                 "obj_translation": o_out["translation"]})
                return outs

            both, ms["combined step"] = _ms(both_stepped)
            kernels.reset_launch_counts()
            got, ms["combined serve depth 1"] = _ms(lambda: list(serve_combined(
                tracker, otracker, hand_state(), otracker.init_state(r0, t0),
                [{**frame, "obj_points": pts} for frame, pts in zip(hand_frames, clouds)])))
            by_path["serve_combined"] = dict(kernels.launch_counts)
            for g, s in zip(got, both):
                _same("serve_combined against stepping both trackers", g, s)
        per_frame = {k: round(v / t, 3) for k, v in ms.items()}
        print(f"[serve] cuda, {t} frames: hand (IKNet + shape optimiser + pose optimiser, skin "
              f"route, {HAND_PARTICLES} particles, {HAND_HW} masks) and object ({OBJ_PARTICLES} "
              f"particles x {OBJ_NUM_POINTS} points x {OBJ_ITERATIONS} iterations, fused); the "
              f"trackers stepped bitwise the offline trackers, serve at depths 1 and 2 and "
              f"serve_combined bitwise the steps; ms/frame {per_frame} | {card}", flush=True)
        return by_path
    finally:
        for root in (hand_root, obj_root):
            shutil.rmtree(root, ignore_errors=True)


def check_no_jax() -> None:
    bad = sorted(m for m in sys.modules if m in ("jax", "hotrack_tpu")
                 or m.startswith(("jax.", "jaxlib", "flax", "optax", "hotrack_tpu.")))
    if bad:
        raise AssertionError(f"the port imported JAX or the JAX package: {bad}")


def main() -> int:
    t0 = time.perf_counter()
    took = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        took[name] = round(time.perf_counter() - t, 1)
        return out

    card = phase_device()
    timed("build", phase_build)
    real = timed("real_tree", real_tree)
    try:
        return _phases(card, real, t0, took, timed)
    finally:
        shutil.rmtree(real["root"], ignore_errors=True)


def _phases(card, real, t0, took, timed) -> int:
    t_kernels = time.perf_counter()
    numbers = {"fps": phase_kernels_fps(), "gather_rows": phase_kernels_gather(),
               "scatter_rows_add": phase_kernels_scatter(),
               "sdf_mlp": phase_kernels_sdf_mlp(),
               "obj_sdf_energy": phase_kernels_obj_energy(),
               "packed_mask_lookup": phase_kernels_mask_lookup(),
               "hand_energy": phase_kernels_hand_energy(),
               "hand_energy_skin": phase_kernels_hand_energy_skin(),
               "sdf_mlp_batched": phase_kernels_sdf_mlp_batched(),
               "obj_sdf_energy_batched": phase_kernels_obj_energy_batched(),
               "packed_mask_lookup_batched": phase_kernels_mask_lookup_batched(),
               "hand_energy_skin_batched": phase_kernels_hand_energy_skin_batched()}
    numbers["gather_rows"]["host_us"] = phase_index_points_host()
    took["kernels"] = round(time.perf_counter() - t_kernels, 1)
    seen = {name: set() for name in KERNELS}
    by_path = {"tracking": timed("tracking", phase_tracking_path, card, seen),
               "train": timed("train", phase_train_path, card, seen)}
    object_launches, obj_fit = timed("object", phase_object_path, card, seen)
    by_path.update(object_launches)
    handopt_launches, fit = timed("handopt", phase_hand_optimiser, card, seen)
    by_path.update({f"handopt_{route}": counts for route, counts in handopt_launches.items()})
    by_path.update(timed("hand", phase_hand_path, card, seen, fit))
    by_path.update(timed("hand_batched", phase_hand_batched, card, seen))
    by_path.update(timed("object_batched", phase_object_batched, card, seen))
    by_path.update(timed("real", phase_real_paths, card, seen, real))
    by_path.update(timed("shape_update", phase_shape_update, card, seen, real))
    by_path.update(timed("serving", phase_serving, card, seen, fit, obj_fit))
    by_path.update(timed("library", phase_library, card, seen))
    # the path whose count stands for the kernel in the result line
    main_path = {"fps": "train", "gather_rows": "train", "scatter_rows_add": "train",
                 "sdf_mlp": "object_composed", "obj_sdf_energy": "object",
                 "packed_mask_lookup": "hand_separate", "hand_energy": "hand_fused",
                 "hand_energy_skin": "hand", "sdf_mlp_batched": "object_batched_composed",
                 "obj_sdf_energy_batched": "object_batched",
                 "packed_mask_lookup_batched": "hand_batched_separate",
                 "hand_energy_skin_batched": "hand_batched"}
    check_seen_shapes(seen)
    check_no_jax()
    print(f"[done] {time.perf_counter() - t0:.1f} s; seconds by phase {took}", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": by_path[main_path[name]][name],
        "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
        **numbers[name]} for name, (source, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
