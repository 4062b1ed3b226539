"""Smoke run of the PyTorch port on one CUDA card: kernels, the --eval path,
the train path, the SOS finetune (frozen, full, random negatives), the
bf16 modes (--compute_dtype bfloat16: --eval, the RGB pretrain and both
finetunes),
mip-NeRF (--mipnerf train and --eval), then the field kernels (--eval_vol
and nets with no fine pass, --N_importance 0), then mip-NeRF at bf16
(train, --eval and --eval_vol), then the classic field kernels at bf16
(--eval_vol, --N_importance 0 and the noisy density-only view), then the
SOS quality gate at fp32 and bf16 and its negative control.

    python3 chip_smoke.py

Phases (one line each; any failure raises and the exit code is nonzero):
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the kernels from nerfsos_torch/csrc with nvcc, one compiler per
     source at once, and beside them tools/tile_probe's fwdonly copy of the
     sources (forward_split's library) in a process of its own, and print
     ptxas's register/spill report,
     with [reverse_ptxas]: the reverse-sweep kernel's line in each of its
     eight modes (four fp32, four bf16), and any wgmma warning (C75xx: serialised wgmma); any such
     warning (K1/K2/K4/K9's kernel, K3's, K6's and K10b's forward, the field
     forwards' kernel, K5's, the reverse sweep's bwd_layer and wgrad
     products) fails the run;
  2. K1 (fused coarse weights: K4's kernel in its sigma-only mode) vs its
     plain PyTorch version at the flagship width: depth 8, width 256,
     multires 10, 64 samples, 8192 rays, two calls bitwise equal; then at
     the eval path's 32768 rays a launch, vs plain and timed beside its
     bound, with ptxas's line for its kernel;
  3. K2 (fused fine render: K4's kernel without noise or sem_in) vs its
     plain version: 8192 rays, 192 samples, semantic head with coordinates
     (sem_dim 2), multires_views 4, fixed sorted z, two calls bitwise equal,
     then timed at the eval path's 32768 rays a launch beside its bound;
     then again without the semantic head;
  4. the eval path: an analytic scene with one 378x504 test view and seeded
     flagship weights saved as a reference-format .ckpt, evaluated through
     ``nerfsos_torch.run_nerf.main --eval``; the kernels' launch counters
     must show both kernels ran, log.json must hold finite metrics, the run's
     seconds are split into render, metrics and the rest, the view's last K1
     and K2 calls are held against their plain versions on their own inputs
     to TOL and against a second call bitwise ([eval_k1], [eval_k2]), and
     the view is rendered again by the plain path and compared;
  5. K3 (fused RGB train pass) vs its plain version at the flagship width,
     sigma noise 1 from a fixed seed, fixed sorted z: at 4096 rays coarse
     S=64 and fine S=192 with the semantic head, then S=192 with white_bkgd
     and no semantic head; at 1024 rays (the train step's size) S=64 and
     S=192; maps, weights and every gradient leaf, and the gradients of two
     calls must be bitwise equal; each case also prints its forward's and
     its reverse sweep's ms (``forward_split``: the call timed again with
     ``tools/tile_probe``'s ``fwdonly`` build) and ptxas's lines for the
     forward kernel and the reverse-sweep kernel;
  6. the train path: ``run_nerf.main`` without --eval, with the flags of
     configs/flower_full.txt (N_rand 1024, 64 + 128 samples, noise 1, the
     semantic head) on 8 train views at 378x504, 30 steps: K3 launches twice
     a step, the loss is finite and falls, the 10/20/30-step checkpoints hold
     optimizer state, the final eval runs through K1/K2, and the last step's
     two K3 calls (importance-sampled z for the fine one) agree with the
     plain version on their inputs;
  7. resume: ``main`` again with 40 steps resumes from latest.ckpt at step 30
     with the Adam state and launches K3 twice a step;
  8. train step timings (CUDA events) at 1024, 4096 and 16384 rays on the
     kernel path and at 1024 and 4096 on the plain path (16384 when it fits),
     and the packing of both fields' weight buffers after an Adam step (the
     forward's and the reverse sweep's rings gathered from them);
  9. K4 (the SOS train forward) and K5 (the semantic-head backward) vs their
     plain versions at the flagship width with the semantic head and
     coordinates, 4096 rays, S=64 and S=192, noise 1 from a fixed seed, fixed
     sorted z: K4's maps, weights and sem_in to TOL and two calls bitwise
     equal, with K4's design numbers (the weight bytes a point reads from
     L2 through its ring, the achieved 3xTF32 rate against the peak,
     ptxas's register/spill line); K5 on K4's own outputs with seeded map
     cotangents, each leaf to GRAD_TOL plus its allowance for semantic-head
     gates near 0, and two calls bitwise equal, with ptxas's line for K5's
     kernel;
 10. the SOS finetune: ``run_nerf.main`` with the flags of
     scripts/train_flower_node0.sh (8 patches of 64x64, stride 6, ViT-S/16
     with seeded weights, both correlation losses) on 8 train views of
     384x512, from the [train] run's last.ckpt (trained without
     --sem_with_coord), 10 steps: K4 twice a step and twice per ARI
     re-render, K5 twice a step, K7a/K7f/K7g once a step; every loss term
     finite and the correlation terms nonzero; the trunk bitwise equal to
     the checkpoint's and the semantic head moved; the final eval through
     K1/K2; the last step's K4 and K5 calls against their plain versions
     and against a second call on the same inputs, bitwise;
 11. K7 (row stats, the four geometry means, the code gradients) on the last
     SOS step's own inputs (16 x 4096 pixels, 2 channels) vs the plain
     versions to K7_TOL, two calls bitwise equal, the pair sweeps'
     reciprocal fast path against 1.f / x on every float it can meet, and
     [K7_design]: each kernel's grid, ptxas line and issue-rate bound (its
     SASS pair loop's instructions a pair over the SMs' issue rate);
 12. the 32768-ray SOS step (CUDA events) on the kernel and the plain path,
     with peak memory, and its parts timed alone (K4 and K5 coarse and
     fine, ViT, the forward kernels' weight packing, appearance loss, K7
     forward and backward, Adam), K4's with its design numbers as in 9,
     K5's with ptxas's line;
 13. K6 (the full train-render backward) vs its plain version on the
     [K4]/[K5] phase's field and rays (4096 rays, S=64 and S=192, noise 1)
     with seeded map and weight cotangents: every leaf to GRAD_TOL plus its
     allowance for trunk, views, alpha and sem_0 gates near 0, two calls
     bitwise equal, and the forward/reverse split as in 5 (between 9 and 10);
 14. [K7s]: K7 with one half and one head (K7b/K7c) and two heads (K7d/K7e)
     vs the plain versions at 8 x 4096 pixels, 2 channels, to K7_TOL, two
     calls bitwise equal, with [K7s_design] as in 11 (after 11);
 15. [sos_full]: the finetune flags without --fix_backbone, 5 steps from the
     [train] run's last.ckpt: K4 and K6 twice a step, K7a/K7f/K7g once,
     every leaf moved, Adam state for every leaf, the last step's two K6
     calls vs the plain version on their own inputs;
 16. [sos_randneg]: the finetune flags with --rand_neg, 5 steps: K5 twice a
     step, K7a/K7b/K7c four times (2 heads x neg/self), the trunk bitwise
     unchanged, the last step's K7b/K7c calls vs the plain versions;
 17. [sos_full_step]: the full finetune's 32768-ray step as in 12, K6 in
     place of K5; [sos_randneg_step]: the --rand_neg finetune's step on the
     kernel and the plain path (K7a/K7b/K7c in place of K7a/K7f/K7g), with
     peak memory, no parts;
 18. [K9]: the mip eval kernel (K4's kernel in its mip mode) vs its plain
     version at the flagship width (8 x 256, multires 10, multires_views
     4), 4096 rays, S=63 and S=190 intervals at fixed sorted fenceposts, a
     378x504 view's base radius: maps and weights to TOL, two calls bitwise
     equal; then at the eval path's 32768 rays a launch, vs plain and timed
     beside its bound, with ptxas's line for the mip mode ([K9_design]);
 19. [K10a]/[K10b]: the mip train forward (noise 1 from a fixed seed) to
     TOL and two calls bitwise equal, also at 32768 rays a launch as K9;
     the mip backward (its forward K6's on K4's tile in the mip mode) on
     its 4096-ray inputs with seeded map and weight cotangents, every leaf
     to GRAD_TOL plus its gate allowance, two calls bitwise equal;
 20. [mip_train]: ``run_nerf.main`` with configs/flower_full.txt's flags and
     --mipnerf on the [train] run's 8 views, 30 steps: K10a and K10b twice a
     step, the loss falls, the checkpoints hold the Adam state, the final
     eval runs through K9, and the last step's two K10b calls agree with the
     plain version on their own inputs;
 21. [mip_eval]: ``--eval --mipnerf`` on the 378x504 test view from that
     run's checkpoint: K9 twice a ray block, finite metrics, the view's last
     two K9 calls held against the plain version on their own inputs to TOL
     and against a second call bitwise ([mip_eval_k9]), and the view
     rendered by the kernel path vs the plain path;
 22. [mip_step]: the mip train step at 1024 and 16384 rays on the kernel
     and the plain path with peak memory, and its K10a/K10b calls timed
     alone beside their bounds (K10b's with its forward/reverse split and
     the forward's and the reverse kernel's ptxas lines);
 23. [K8]: the field forward (K8b/K8d) with the semantic head and without
     it, the sigma forward (K8a/K8e) and K11 at zero and non-zero
     covariances (K4's tile in its point-list modes) vs their plain
     versions at the flagship width on 2^18 points of the x14 density
     grid's cube: each column to TOL over max(1, its max), two calls
     bitwise equal, times, and [K8_design]: each mode's ptxas line, ring
     stages and tiles a CTA;
 24. [K8_bwd]: the field backward at 1024 x 64 points of rays, weights only
     (K8f) and with the points' and directions' gradients (K8c): every leaf
     to GRAD_TOL plus its gate allowance, dpts/ddirs to GRAD_TOL on
     gate-clear points, two calls bitwise equal, each mode's forward/reverse
     split, the forward's ring stages and the forward and reverse kernels'
     ptxas lines;
 25. [eval_vol]: ``run_nerf.main --eval_vol`` (a 256^3 grid, 64 chunks of
     2^18 points) on the [eval] phase's checkpoint, then with --mipnerf on
     the [mip_train] run's: 64 launches of the field kernel (K11), both
     files written, the volume vs the plain path's to TOL x max(1, max);
 26. [train_noimp]: ``run_nerf.main`` with configs/flower_full.txt's flags
     and --N_importance 0, 30 steps: the field forward and backward once a
     step, the loss falls, the final eval through the field forward, the
     last step's backward call vs the plain version on its own inputs;
 27. [sos_noimp]: 5 ``--patch_tune --fix_backbone --N_importance 0`` steps
     from that run's checkpoint (the RGB finetune on patches: the SOS
     losses need a fine pass): every term finite, the trunk bitwise equal;
 28. [sigma_noise]: one 378x504 view through ``NeRFNet.forward(...,
     coarse_outputs=False, raw_noise_std=1.0)``: the sigma and the field
     kernel once a ray block, the view vs the plain net's with the same
     noise, one sigma call vs plain and timed;
 29. [noimp_step]: the --N_importance 0 step at 1024 and 16384 rays, kernel
     vs plain path with peak memory, and its two field calls timed alone;
 30. the bf16 modes (``--compute_dtype bfloat16``, run after 12): [K1_bf16],
     [K2_bf16], [K4_bf16], [K5_bf16] at the flagship width against their
     bf16 plain versions (bf16_columns, bf16_stored: the bf16 rounding
     flips bounded as a group, beside the readings of an fp32 control and
     a tail fault; k5_bf16_over), two calls bitwise equal,
     timed at the main paths' shapes beside the same call's fp32 kernel
     and the bf16 bound; [eval_bf16] the 378x504 view at bf16 (the fp32
     view again beside it, the bf16 counters alone launched, its last K1
     and K2 calls vs plain); [sos_bf16] 10 frozen steps at bf16 from the
     [train] run's fp32 checkpoint with a bf16 DINO (as [sos]); and
     [sos_bf16_step] the bf16 and the fp32 frozen step in turns, with
     peak memory, then the bf16 step split into its parts as [sos_step]'s
     ([sos_bf16_step_part], [sos_bf16_step_split]); then [K3_bf16] (1024
     rays at S = 64 and 192, 4096 at 192) and [K6_bf16] (32768 rays at S =
     192 and 64, the semantic head) against their bf16 plain versions (maps
     and weights: bf16_columns; leaves: bf16_leaves), beside the readings
     of an fp32 control and a fault (the gated cotangents left unrounded),
     two calls bitwise, timed beside the same call's fp32 kernel and the
     bf16 bound; [train_bf16] the [train] pretrain at bf16 (K3's bf16 mode
     twice a step, the last step's calls vs plain); [train_step_bf16] the
     1024- and 16384-ray RGB steps at bf16 and fp32 in turns; and after
     [sos_full_step], [sos_full_bf16] 5 full finetune steps at bf16 (K6's
     bf16 mode twice a step) and [sos_full_bf16_step] the full step at
     bf16 and fp32 in turns, with peak memory. [fp32_train_kernels] (after
     the K3 phases): digests of K3's, K6's, K9's, K10a's, K10b's, K11's and
     K8a's, K8b's, K8f's and K8c's fp32 outputs on seeded inputs, held to
     FP32_FINGERPRINTS (the parent
     tree's), and their times; [bf16_train_kernels] the same calls' digests
     in their bf16 modes, held to BF16_FINGERPRINTS;
 31. mip-NeRF at bf16 (after 25): [K9_bf16] at 32768 rays a launch,
     [K10a_bf16] and [K10b_bf16] at 1024 rays (S = 63 and 190),
     [K10b_bf16_planes] (one wave: the stored planes and the sweep, as
     [K6_bf16_planes]) and [K11_bf16] at 2^18 points, against their bf16
     plain versions (bf16_columns; K10b: bf16_leaves beside bf16_witness)
     beside the readings of the fp32 kernel and a tail fault (K10b: the
     unrounded gate fault), two calls bitwise, timed beside the same call's
     fp32 kernel and the bf16 bound; [mip_train_bf16] 30 --mipnerf steps at
     bf16 (K10a/K10b's bf16 modes twice a step, the last step's K10b calls
     vs plain), [mip_eval_bf16] the 378x504 --eval --mipnerf view at bf16
     (the fp32 view of the same checkpoint beside it; its last K9 calls vs
     plain), [eval_vol_bf16] --eval_vol --mipnerf at bf16 (64 K11 launches,
     the volume vs the export through K11's bf16 plain version, the fp32
     export beside it), and [mip_bf16_step] the 1024- and 16384-ray mip
     steps at bf16 and fp32 in turns, with peak memory;
 32. the classic field kernels at bf16 (after 29): [K8_bf16] the sigma
     forward (K8a/K8e) at 2^18 grid points and 32768 x 64 points of rays,
     the field forward under K8b's head rule (the heads' hidden activations
     unrounded) and under K8d's at 2^18 and 1024 x 64 points, and each on
     4097 points near the origin, against its bf16 plain version
     (bf16_points) beside the fp32 kernel's, the nudged plain version's and
     the other rule's readings; [K8_bwd_bf16] K8f and K8c at 1024 x 64 points
     (bf16_leaves beside bf16_witness, the fp32 kernel's and the unrounded-g
     fault's readings beside; the forward/reverse split) and
     [K8_bwd_bf16_planes] (bf16_planes on the call's workspace); each two
     calls bitwise, timed beside the same call's fp32 kernel and the bf16
     bound; [eval_vol_bf16] with the classic field (64 launches of K8b's
     head rule on its own count, none of K8d's, the volume vs the export
     through K8b's bf16 plain version, bf16_volume); [train_noimp_bf16]
     the [train_noimp] run at bf16 (the bf16 counters alone, the last
     step's K8f call vs plain);
     [noimp_bf16_step] the 1024- and 16384-ray --N_importance 0 steps at
     bf16 and fp32 in turns, with peak memory; [sigma_noise_bf16] the noisy
     density-only view at bf16 (K8e and K8d once a ray block), its last
     K8e and K8d calls vs plain on their own inputs;
 33. the SOS quality gate (nerfsos_torch/tools/validate_sos_protocol.py,
     the twin of tools/validate_sos_protocol.py, with --ret_cluster; after
     32): [sos_gate] at fp32 on the 64x64 sphere scene, the 1500-step RGB
     pretrain (4096 rays), the idle head's --eval, the geometry-only and
     the appearance finetunes (500 frozen steps of 8 16x16 patches each),
     each run a [sos_gate_run] line with its seconds, its train steps' ms
     and its launches (every count set to 0 just before and read just
     after: K3 twice a pretrain step, K4 twice a finetune step and twice a
     train-time ARI re-render, K5 twice a step, K7a/K7f/K7g once, K1/K2
     once a test view, no other launch and no call of the eager field);
     fails unless the gate passes both finetunes (held-out clus ARI >=
     0.5, PSNR within 0.5 dB) and each finetune's PSNR is the pretrain's
     exactly; with the share of sphere pixels labelled 1 after the DINO
     foreground flip; [sos_gate_bf16] the same at --compute_dtype bfloat16
     (bf16 counts; K7 fp32); [sos_gate_control] from [sos_gate]'s
     pretrain, the geometry-only finetune with the loss's sign inverted
     (--Gcorrelation_w -1.0): fails unless its PSNR is the pretrain's, and
     prints refused=true|false; a control the gate does not refuse is the
     finding the gate's design allows for (recorded, the control and the
     thresholds unchanged: PERF.md §7), not a fault of the run. The gate's
     nets start from the JAX entry point's initial weights at --seed 0
     (models/seeded.py), as every seeded run of the port does;
 34. a raw scene to trained views and videos through the port alone (just
     before 33; the fp32 runs' nets of the port's default initialisation,
     the bf16 runs' of torch's nn.Linear law, as every bf16 check's):
     [gen_dataset] two raw scenes of the analytic sphere written as PNGs by
     the port (an LLFF one, 12 views of 378x504 in images_8/ with
     poses_bounds.npy; a Blender one, RGBA 800x800, 8/2/2 views with
     transforms_*.json) prepared by ``python -m nerfsos_torch.data.
     gen_dataset`` at flower_full.txt's and lego.txt's flags, rays_exhibit
     cut to 4 frames; [train_nobatch] 30 steps at lego.txt's flags
     (--no_batching, half_res, white_bkgd) with --precrop_iters 20 (bf16:
     [train_nobatch_bf16], 10 steps, --precrop_iters 5): every ray of a
     cropped step in the centre crop, K3 twice a step at the run's dtype,
     the last step's K3 calls vs plain (bf16: bf16_columns and
     bf16_leaves, as [train_bf16]); [nobatch_step] that step at 1024 rays, fp32
     and bf16 in turns; [video] a 4-step flower_full.txt
     train on the LLFF scene with --i_img and --i_video due once each, then
     --eval --eval_video (and [video_bf16]): K1 and K2 6 times a frame,
     every K1 call of the --i_img and video frames vs plain and every K2
     call at the plain coarse pass's z (fp32: on the rays whose last
     sample's density is clear of 0; bf16: a frame's calls together by
     bf16_columns beside the fp32 kernels), the mp4s written (cv2 or imageio;
     else write_video's error), the --i_img frame's whole-frame reading
     beside the nudged plain path's ([video_frame]).
The last lines are [timing] (the seconds of each phase, each
translation unit's nvcc seconds), the card, one JSON object with the
kernels' numbers, and ``{"ok": true, "device": {...}}``. Scratch files go to
build/chip_smoke/.
"""
from __future__ import annotations

import atexit
import copy
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
# Bound on |kernel - plain| for weights and maps. Both sides are fp32; the
# inputs of every sin/exp are bit-identical (explicit rounding, no FMA
# contraction), and what differs is the summation order of the MLP layers
# (K <= 319 terms per output, relative ~1e-6 per layer after 8+ layers)
# and of the composite sums. Weights and maps are O(1), so 1e-4 leaves two
# orders of margin over that rounding while still catching any indexing or
# layout fault, which moves values by O(1e-2) or more.
TOL = 1e-4
# Bound on max |kernel - plain| of each K3 gradient leaf, relative to that
# leaf's max |plain|, before the leaf's flip allowance (below). Both sides
# are fp32, but a dW entry sums up to 4096 x 192 = 786k products in another
# order on each side (the kernel per 64-point k step, then per chunk, then
# per CTA; cuBLAS in its own blocking), and the cotangents themselves pass
# through the 8-layer reverse sweep; fp32 summation of n terms moves a sum by
# ~sqrt(n) * 2^-24 of its terms' scale, ~5e-5 at n = 786k. 1e-3 leaves an
# order of margin while a layout or indexing fault moves a leaf by O(1e-2)
# (one 512-point chunk of a 1024 x 64 call) to O(1) of its scale.
GRAD_TOL = 1e-3
# A gate (a trunk or views relu, or the relu of sigma + noise) whose input
# lies within this share of its layer's largest |input| of 0 may take the
# other side in the kernel than in the plain version: their inputs differ by
# rounding alone (fp32 sums in another order, 3xTF32 products), mostly below
# 1e-6 of the layer's largest (gates flipped at up to 1.23e-6 of it among
# [K8_bwd]'s 65536 points, H100). A flipped gate moves every leaf by up to
# that point's whole term, which in a 1024-ray train step is above GRAD_TOL
# of a leaf ([train_k3]); each leaf therefore gets twice the largest term of
# a point near a gate on top of GRAD_TOL (a flip just past the margin moves
# a leaf by one point's term, within GRAD_TOL at these sizes).
# tests/test_torch_cuda.py picks rays with no trunk or views gate near 0, so
# that its leaves are held to GRAD_TOL alone.
GATE_MARGIN = 1e-6
# A flipped gate moves its point's input gradient (K8c's dpts and ddirs) by
# that gradient's whole size, so those are compared on the points whose
# every gate clears this share, ten times the largest flip seen.
INPUT_GRAD_MARGIN = 1e-5
# Bound on K7's four means and four code gradients, relative to the largest
# |plain| of the four means and to each gradient's own max |plain|. Both
# sides are fp32 and form every pair's terms with the same operations in the
# same order (IEEE reciprocals: a tile with every input within 2^90 takes
# the division's fast path alone, which [K7] holds against 1.f / x on every
# float it can meet, rcp_fast_path_mismatches=0; the loss's product -cd *
# fd2 rounded on its own with __fmul_rn, not fused into its sum; the
# gradients' dd * sign(.) is exact, so its fusion into a sum changes
# nothing), so the terms are bit-identical; only the order of the sums
# differs (the kernel, in pair tiles of up to 256 rows x 256 columns: a
# lane's running sum over a warp's 64 columns (dc1, the loss) or over its
# rows (dc2), a fixed shuffle tree over the warp and the warps in order,
# then the tiles in order; PyTorch: its blocked reductions). fp32 summation
# of n terms moves a sum by ~sqrt(n) 2^-24 of its terms' scale, ~4e-6 at
# n = 4096; 1e-4 leaves an order of margin (the means sum 16 x 4096 of
# those row sums) while an indexing fault (a wrong column, half or head)
# moves a value by O(1e-2) of its scale or more.
K7_TOL = 1e-4
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, the fp32-accurate
# tensor-core rate of the 3xTF32 products the kernels use (495 TFLOP/s TF32
# dense / 3), and the fp32 rate outside the tensor cores (K7's SIMT work).
HBM_BYTES_S = 3.35e12
FP32_MMA_FLOP_S = 495e12 / 3
FP32_SIMT_FLOP_S = 67e12
# K7's second bound, by instruction issue: an SM issues one warp instruction
# a clock on each of its 4 schedulers (128 lane instructions a clock), and
# its MUFU units take 16 lane reciprocals a clock (the CUDA C++ Programming
# Guide's arithmetic throughput table, compute capability 9.0)
LANE_INSNS_PER_CLOCK = 128
MUFU_LANES_PER_CLOCK = 16
# ptxas's line for K4's kernel (train_render_wg_kernel<kInPoint>, also
# K2's), for K1's (its sigma-only mode, <kInSigma>), for K9's and K10a's
# (its mip mode, <kInMip>), for K5's (frozen_sem_kernel), for
# K3's and K6's forward (train_forward_wg_kernel, kLoss and kCotangent) and
# for the reverse-sweep kernel (train_reverse_kernel by (kSem, kInGrad)) and
# for the field backward's forward (field_bwd_forward_kernel by (kSem,
# kInGrad)), read from the build log in main
K1_PTXAS = None
K4_PTXAS = None
K9_PTXAS = None
# field_wg_kernel by (input mode, kBf16): kInList 3, kInListSigma 4, kInListGauss 5
FIELD_PTXAS = {}
K5_PTXAS = None
# the bf16 modes' lines: train_render_wg_kernel<kInPoint | kInSigma | kInMip, true> (K4
# and K2, K1, K9 and K10a) and frozen_sem_kernel<true> (K5)
K4_BF16_PTXAS = None
K1_BF16_PTXAS = None
K9_BF16_PTXAS = None
K5_BF16_PTXAS = None
FWD_PTXAS = {}
REV_PTXAS = {}
FIELD_BWD_PTXAS = {}
# ptxas's line and the SASS pair loop (sass_spills.inner_loop) of each of
# K7's kernels, by the part of its mangled name K7_KERNEL matches:
# rowsum_tile_kernel (K7a) and every loss_tile_kernel and grad_tile_kernel
# instantiation (ILi<heads>ELi<S>E)
K7_KERNEL = re.compile(r"(rowsum_tile_kernel|(?:loss|grad)_tile_kernelILi\dELi\dE)")
K7_PTXAS = {}
K7_SASS = {}


START = time.perf_counter()
PHASE_SECONDS: dict = {}  # a phase name's seconds: since the line before each of its lines
_LAST_LINE = [0.0]


def phase(name: str, **fields) -> None:
    """One phase line: its fields, then the seconds since the script began
    (``at_s``: where the run's time went); the seconds since the line
    before are added to the phase's total in PHASE_SECONDS ([timing])."""
    at = time.perf_counter() - START
    PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + at - _LAST_LINE[0]
    _LAST_LINE[0] = at
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()) + f" at_s={at:.1f}",
          flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events, after warmup."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def seeded_field(seed: int, **kw):
    """A NeRFField whose weights come from a seeded torch.Generator (the
    default Linear init's U(-1/sqrt(fan_in), 1/sqrt(fan_in)))."""
    from nerfsos_torch.models.fields import NeRFField

    field = NeRFField(**kw)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in field.modules():
            if isinstance(m, torch.nn.Linear):
                b = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-b, b, generator=g)
                m.bias.uniform_(-b, b, generator=g)
    return field.cuda().eval()


def ray_inputs(n: int, s: int, seed: int):
    """Rays from a sphere of radius 4 towards the origin (unnormalized
    directions), their unit viewdirs, and sorted z in [2, 6]."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o / 4.0 * rng.uniform(0.8, 1.2, size=(n, 1)) + 0.1 * rng.normal(size=(n, 3))
    v = d / np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.uniform(2.0, 6.0, size=(n, s)), axis=1)
    odv = torch.from_numpy(np.concatenate([o, d, v], axis=1).astype(np.float32)).cuda()
    return odv, torch.from_numpy(z.astype(np.float32)).cuda()


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach() - b.detach()).abs().max())


def k4_errors(got, want) -> list:
    """K4's (maps, weights, sem_in), or K9's/K10a's (maps, weights), against
    its plain version's: the largest error of each, the maps' taken per
    column over that column's scale max(1, max |plain|). The depth column is
    a z-weighted sum of the weights (z up to far = 13), so its rounding is
    the weights' times z; the other columns are O(1)."""
    maps, maps_p = got[0].detach(), want[0].detach()
    scale = maps_p.abs().amax(0).clamp(min=1.0)
    return [float(((maps - maps_p).abs() / scale).max())] + [
        max_err(a, b) for a, b in zip(got[1:], want[1:])]


def linear_shapes(field):
    """(name, in, out) of every dense layer of a NeRFField."""
    return [(n, m.in_features, m.out_features) for n, m in field.named_modules()
            if isinstance(m, torch.nn.Linear)]


def field_flops(field, kind: str) -> float:
    """Matrix-product FLOP per point: 'k1' the trunk and alpha head, 'k2' every
    layer, 'k3' the forward of every layer + the input-gradient products of
    K3's reverse sweep (each trunk layer but the first on its h input,
    feature and alpha on h, views on the feature input, rgb) + the
    weight-gradient products of every layer but the semantic head; 'k6'
    K3's work + the semantic head's input-gradient products (sem_1, and
    sem_0 on h) and weight-gradient products."""
    shapes = linear_shapes(field)
    mlp = field.mlp
    fwd = sum(2 * i * o for _, i, o in shapes)
    if kind == "k1":
        return sum(2 * i * o for n, i, o in shapes if "pts_linears" in n or "alpha" in n)
    if kind == "k2":
        return fwd
    W = mlp.width
    dx = (2 * W * W * (mlp.depth - 1) + 2 * W * W + 2 * W + 2 * (W // 2) * W
          + 2 * 3 * (W // 2))
    dw = sum(2 * i * o for n, i, o in shapes if "semantic" not in n)
    if kind == "k6" and mlp.use_semantics:
        H, sem = mlp.semantic_linear[0].out_features, mlp.semantic_linear[2].out_features
        dx += 2 * sem * H + 2 * H * W
        dw = sum(2 * i * o for _, i, o in shapes)
    return fwd + dx + dw


def bound_ms(bytes_moved: float, flops: float, flop_s: float = FP32_MMA_FLOP_S) -> dict:
    """The least time the card could take: the larger of the bytes over HBM
    and the operations over their peak rate (by default the fp32-accurate
    tensor-core rate)."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_S * 1e3, flops / flop_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations"}


def n_params(field) -> int:
    return sum(p.numel() for p in field.parameters())


EVAL_CHUNK = 32768  # rays a K1 or K2 launch on the eval path (--ray_chunk's default)


def kernel_vs_plain_k1(fr) -> dict:
    field = seeded_field(0, net_depth=8, net_width=256, multires=10, multires_views=4)
    odv, z = ray_inputs(8192, 64, seed=0)
    od = odv[:, :6].contiguous()
    with torch.no_grad():
        got = fr.fused_coarse_weights(field, od, z)
        again = fr.fused_coarse_weights(field, od, z)
        want = fr.coarse_weights_plain(field, od, z)
        torch.cuda.synchronize()
        err = max_err(got, want)
        ms = cuda_ms(lambda: fr.fused_coarse_weights(field, od, z))
        plain_ms = cuda_ms(lambda: fr.coarse_weights_plain(field, od, z))
    if not (torch.isfinite(got).all() and err <= TOL):
        raise SystemExit(f"K1 disagrees with its plain version: max_abs_err={err} > {TOL}")
    if not torch.equal(got, again):
        raise SystemExit("K1: two calls differ")
    bound = bound_ms(4 * (8192 * (6 + 2 * 64) + n_params(field)),
                     8192 * 64 * field_flops(field, "k1"))
    phase("K1", rays=8192, samples=64, max_abs_err=err, tol=TOL, deterministic=True, ms=ms,
          plain_ms=plain_ms, **bound, ptxas=repr(K1_PTXAS))
    # at the eval path's 32768 rays a launch, the numbers the kernels line reports
    R = EVAL_CHUNK
    odv, z = ray_inputs(R, 64, seed=3)
    od = odv[:, :6].contiguous()
    with torch.no_grad():
        got = fr.fused_coarse_weights(field, od, z)
        err_r = max_err(got, fr.coarse_weights_plain(field, od, z))
        ms = cuda_ms(lambda: fr.fused_coarse_weights(field, od, z), reps=3)
        plain_ms = cuda_ms(lambda: fr.coarse_weights_plain(field, od, z), reps=2, warmup=1)
    if not (torch.isfinite(got).all() and err_r <= TOL):
        raise SystemExit(f"K1 at {R} rays disagrees with its plain version: {err_r} > {TOL}")
    bound = bound_ms(4 * (R * (6 + 2 * 64) + n_params(field)), R * 64 * field_flops(field, "k1"))
    phase("K1", rays=R, samples=64, max_abs_err=err_r, tol=TOL, ms=ms, plain_ms=plain_ms, **bound)
    return {"max_abs_err": max(err, err_r), "ms": ms, "plain_ms": plain_ms, **bound,
            "library_ms": None}


def kernel_vs_plain_k2(fr, use_semantics: bool) -> dict:
    """[K2] (K4's kernel without noise or sem_in) vs its plain version at
    8192 rays x 192 samples, and two calls bitwise equal; with the semantic
    head also timed at the eval path's 32768 rays a launch beside its bound
    (the plain version there in chunks of 8192 rays), the numbers the
    kernels line reports."""
    field = seeded_field(1, net_depth=8, net_width=256, multires=10, multires_views=4,
                         use_semantics=use_semantics, sem_with_coord=use_semantics, sem_dim=2)
    odv, z = ray_inputs(8192, 192, seed=1)
    with torch.no_grad():
        maps, w = fr.fused_render(field, odv, z)
        again = fr.fused_render(field, odv, z)
        maps_p, w_p = fr.render_plain(field, odv, z)
        torch.cuda.synchronize()
        err = max(max_err(maps, maps_p), max_err(w, w_p))
        ms = cuda_ms(lambda: fr.fused_render(field, odv, z))
        plain_ms = cuda_ms(lambda: fr.render_plain(field, odv, z))
    if maps.shape != (8192, 5 + (2 if use_semantics else 0)):
        raise SystemExit(f"K2 maps shape {tuple(maps.shape)}")
    if not (torch.isfinite(maps).all() and torch.isfinite(w).all() and err <= TOL):
        raise SystemExit(f"K2 disagrees with its plain version: max_abs_err={err} > {TOL}")
    if not (torch.equal(maps, again[0]) and torch.equal(w, again[1])):
        raise SystemExit("K2's outputs differ between two calls")
    bound = bound_ms(4 * (8192 * (9 + 2 * 192 + maps.shape[1]) + n_params(field)),
                     8192 * 192 * field_flops(field, "k2"))
    phase("K2", rays=8192, samples=192, semantics=use_semantics, max_abs_err=err, tol=TOL,
          deterministic=True, ms=ms, plain_ms=plain_ms, **bound)
    out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": None}
    if use_semantics:
        R = EVAL_CHUNK
        odv, z = ray_inputs(R, 192, seed=2)
        with torch.no_grad():
            ms = cuda_ms(lambda: fr.fused_render(field, odv, z), reps=3)
            plain_ms = cuda_ms(lambda: [fr.render_plain(field, odv[i:i + 8192], z[i:i + 8192])
                                        for i in range(0, R, 8192)], reps=2, warmup=1)
        bound = bound_ms(4 * (R * (9 + 2 * 192 + maps.shape[1]) + n_params(field)),
                         R * 192 * field_flops(field, "k2"))
        phase("K2", rays=R, samples=192, semantics=True, ms=ms, plain_ms=plain_ms, **bound,
              ptxas=repr(K4_PTXAS))
        out.update(ms=ms, plain_ms=plain_ms, **bound)
    return out


def plain_with_gates(field, R: int, S: int, kw: dict, gates, run):
    """``run()`` (a plain version over the field's ``R x S`` points), and what
    a gate that flips between it and the kernel can move: per point, the
    least |input| of any of its ``gates`` (dense layers whose output goes
    through a relu; the alpha layer's with the sigma noise of ``kw``)
    relative to that layer's largest in the same call (``slack [R*S]``); per
    dense layer (by name), each point's largest |input| and largest |output
    cotangent|, whose product bounds the point's term in every entry of the
    layer's dW. The plain version may run the points in chunks, in order."""
    from nerfsos_torch.ops import fused_render as fr

    mlp = field.mlp
    P = R * S
    noise = (fr.noise_plain(kw["seed"], R, S, kw["noise_std"], field.mlp.alpha_linear.weight.device)
             .reshape(P, 1) if kw["noise_std"] > 0 else None)
    slack = torch.full((P,), float("inf"), device=mlp.alpha_linear.weight.device)
    parts, seen = {}, {}

    def hook(mod, inputs, out):
        n = out.numel() // out.shape[-1]
        o = seen.get(mod, 0)
        seen[mod] = o + n
        t = [inputs[0].detach().reshape(n, -1).abs().amax(1), torch.zeros_like(slack[:n])]
        parts.setdefault(mod, []).append(t)
        if out.requires_grad:
            out.register_hook(lambda g: t.__setitem__(1, g.reshape(n, -1).abs().amax(1)))
        if any(mod is m for m in gates):
            pre = out.detach().reshape(n, -1)
            if mod is mlp.alpha_linear and noise is not None:
                pre = pre + noise[o:o + n]
            pre = pre.abs()
            torch.minimum(slack[o:o + n], pre.amin(1) / pre.max(), out=slack[o:o + n])

    handles = [m.register_forward_hook(hook) for m in field.modules()
               if isinstance(m, torch.nn.Linear)]
    try:
        want = run()
    finally:
        for h in handles:
            h.remove()
    names = {m: n for n, m in field.named_modules()}
    terms = {names[m]: [torch.cat([t[i] for t in ts]) for i in (0, 1)]
             for m, ts in parts.items()}
    return want, slack, terms


def plain_k3_with_gates(field, odv, z, gt, kw):
    """K3's plain version, and ``plain_with_gates``' slack and terms for the
    trunk, views and alpha gates."""
    from nerfsos_torch.ops import fused_render as fr

    mlp = field.mlp
    return plain_with_gates(field, *z.shape, kw,
                            [*mlp.pts_linears, mlp.views_linears[0], mlp.alpha_linear],
                            lambda: fr.rgb_train_grads_plain(field, odv, z, gt, **kw))


def plain_k6_with_gates(field, odv, z, dmaps, dweights, kw):
    """K6's plain version, and ``plain_with_gates``' slack and terms for the
    trunk, views, alpha and sem_0 gates."""
    from nerfsos_torch.ops import fused_render as fr

    mlp = field.mlp
    gates = [*mlp.pts_linears, mlp.views_linears[0], mlp.alpha_linear]
    if mlp.use_semantics:
        gates.append(mlp.semantic_linear[0])
    return plain_with_gates(field, *z.shape, kw, gates,
                            lambda: fr.train_render_grads_plain(field, odv, z, dmaps, dweights,
                                                                **kw))


def plain_k10b_with_gates(field, odvr, z, dmaps, dweights, kw):
    """K10b's plain version, and ``plain_with_gates``' slack and terms for
    the trunk, views and alpha gates of the mip field's ``R x S`` intervals
    (``z`` holds ``S + 1`` fenceposts)."""
    from nerfsos_torch.ops import fused_render as fr

    mlp = field.mlp
    return plain_with_gates(field, z.shape[0], z.shape[1] - 1, kw,
                            [*mlp.pts_linears, mlp.views_linears[0], mlp.alpha_linear],
                            lambda: fr.mip_train_render_grads_plain(field, odvr, z, dmaps,
                                                                    dweights, **kw))


def flip_allowance(slack, terms) -> dict:
    """Per gradient leaf: twice the largest term of a point with a gate
    within GATE_MARGIN of 0, or 0 where there is none."""
    near = slack <= GATE_MARGIN
    allow = {}
    for name, (x, g) in terms.items():
        x, g = x[near], g[near]
        allow[f"{name}.weight"] = 2 * float((x * g).max()) if near.any() else 0.0
        allow[f"{name}.bias"] = 2 * float(g.max()) if near.any() else 0.0
    return allow


def check_k3(what: str, got, want, slack, terms) -> dict:
    """K3's (grads, maps, weights) vs its plain version's: maps and weights
    to TOL, every gradient leaf to GRAD_TOL of its max |plain| plus the
    leaf's flip allowance; raises."""
    (g, maps, w), (gp, maps_p, w_p) = got, want
    err = max(max_err(maps, maps_p), max_err(w, w_p))
    allow = flip_allowance(slack, terms)
    grad_err, worst, over = 0.0, "", 0.0
    for name, ref in gp.items():
        scale = max(float(ref.abs().max()), 1e-12)
        e = max_err(g[name], ref)
        if e / scale >= grad_err:
            grad_err, worst = e / scale, name
        over = max(over, e / (GRAD_TOL * scale + allow[name]))
    finite = all(torch.isfinite(t).all() for t in (maps, w, *g.values()))
    if not (maps.shape == maps_p.shape and finite and err <= TOL and over <= 1.0):
        raise SystemExit(f"K3 disagrees with its plain version ({what}): maps {tuple(maps.shape)} "
                         f"vs {tuple(maps_p.shape)}, maps/weights max_abs_err={err} (tol {TOL}), "
                         f"grads {grad_err} of the leaf's max at {worst}, worst leaf error over "
                         f"its bound {over}, finite={finite}")
    return {"max_abs_err": err, "tol": TOL, "grad_rel_err": grad_err, "worst_leaf": worst,
            "grad_tol": GRAD_TOL, "near_gate_points": int((slack <= GATE_MARGIN).sum()),
            "grad_err_over_bound": over}


def check_k6(what: str, got, want, slack, terms, kernel: str = "K6") -> dict:
    """K6's (or K10b's) grads vs its plain version's: every leaf to GRAD_TOL
    of its max |plain| plus the leaf's flip allowance; raises."""
    allow = flip_allowance(slack, terms)
    grad_err, worst, over, abs_err = 0.0, "", 0.0, 0.0
    for name, ref in want.items():
        scale = max(float(ref.abs().max()), 1e-12)
        e = max_err(got[name], ref)
        abs_err = max(abs_err, e)
        if e / scale >= grad_err:
            grad_err, worst = e / scale, name
        over = max(over, e / (GRAD_TOL * scale + allow[name]))
    finite = all(torch.isfinite(t).all() for t in got.values())
    if not (set(got) == set(want) and finite and over <= 1.0):
        raise SystemExit(f"{kernel} disagrees with its plain version ({what}): grads {grad_err} "
                         f"of the leaf's max at {worst}, worst leaf error over its bound {over}, "
                         f"finite={finite}")
    return {"max_abs_err": abs_err, "grad_rel_err": grad_err, "worst_leaf": worst,
            "grad_tol": GRAD_TOL, "near_gate_points": int((slack <= GATE_MARGIN).sum()),
            "grad_err_over_bound": over}


# forward_split's ptxas lines: the forward kernel's on K4's tile (K3, K6,
# K10b: train_forward_wg_kernel's (mode, input mode, kBf16); K8f, K8c:
# field_bwd_forward_kernel's (kSem, kInGrad, kBf16)) and the reverse-sweep
# kernel's (kSem, kInGrad, kBf16)
SPLIT_PTXAS = {"K3": ((1, 0, 0), (0, 0, 0)), "K6": ((2, 0, 0), (1, 0, 0)),
               "K10b": ((2, 2, 0), (0, 0, 0)), "K10b_bf16": ((2, 2, 1), (0, 0, 1)),
               "K8f": ((1, 0, 0), (1, 0, 0)), "K8c": ((1, 1, 0), (1, 1, 0)),
               "K8f_bf16": ((1, 0, 1), (1, 0, 1)), "K8c_bf16": ((1, 1, 1), (1, 1, 1))}


FWDONLY_BUILD = None  # the process building forward_split's library (start_fwdonly_build)


def start_fwdonly_build() -> None:
    """Starts the build of ``tools/tile_probe``'s ``fwdonly`` copy of the
    sources (forward_split's library) in a process of its own, beside the
    kernels' own build: one nvcc a translation unit of each, all at once,
    this one's at the lowest priority (nice 19), so that the kernels' own
    build takes the cores first. Stopped at exit if it is still running."""
    global FWDONLY_BUILD
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from nerfsos_torch import _build; "
            "from nerfsos_torch.tools import tile_probe; "
            "tile_probe.prepare(_build, sys.argv[1], 'fwdonly'); _build.build()")
    with open(os.path.join(WORK, "fwdonly_build.log"), "w") as log:
        FWDONLY_BUILD = subprocess.Popen([sys.executable, "-c", code, ROOT], stdout=log,
                                         stderr=subprocess.STDOUT,
                                         preexec_fn=lambda: os.nice(19))

    def stop():
        if FWDONLY_BUILD is not None and FWDONLY_BUILD.poll() is None:
            FWDONLY_BUILD.kill()
            FWDONLY_BUILD.wait()

    atexit.register(stop)


def forward_split(run, kernel: str) -> dict:
    """The forward's and the reverse sweep's ms of K3, K6, K10b, K8f or K8c
    (``run`` calls its wrapper): ``run`` timed again with the library of
    ``nerfsos_torch.tools.tile_probe``'s ``fwdonly`` copy of the sources
    (each wave's forward kernel and the reduction, no reverse-sweep kernel;
    built once under build/tile_probe/), its time the forward's; the reverse
    sweep's is the whole call's less that. The kernels' own library is put
    back after. ``forward_ptxas`` (K3: kLoss, K6: kCotangent, K10b:
    kCotangent in the mip mode, K8f/K8c: the field backward's forward) and
    ``reverse_ptxas``: the kernels' ptxas lines."""
    from nerfsos_torch import _build
    from nerfsos_torch.tools import tile_probe

    global FWDONLY_BUILD
    if FWDONLY_BUILD is not None:  # its library is the one tile_probe._use loads below
        if FWDONLY_BUILD.wait() != 0:
            raise SystemExit(f"the fwdonly build failed: {os.path.join(WORK, 'fwdonly_build.log')}")
        FWDONLY_BUILD = None
    whole = cuda_ms(run)
    saved = _build.CSRC_DIR, _build.BUILD_DIR
    try:
        tile_probe._use(_build, ROOT, "fwdonly")
        fwd = cuda_ms(run)
    finally:
        _build.CSRC_DIR, _build.BUILD_DIR = saved
        _build.library.cache_clear()
        _build.library()
    fwd_mode, rev_mode = SPLIT_PTXAS[kernel]
    fwd_ptxas = FIELD_BWD_PTXAS if kernel.startswith("K8") else FWD_PTXAS
    return {"forward_ms": fwd, "reverse_ms": whole - fwd,
            "forward_ptxas": repr(fwd_ptxas.get(fwd_mode)),
            "reverse_ptxas": repr(REV_PTXAS.get(rev_mode))}


def kernel_vs_plain_k3(fr, R: int, S: int, use_semantics: bool, white_bkgd: bool) -> dict:
    field = seeded_field(2, net_depth=8, net_width=256, multires=10, multires_views=4,
                         use_semantics=use_semantics, sem_dim=2)
    odv, z = ray_inputs(R, S, seed=2 + S)
    gt = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (R, 3)).astype(np.float32)).cuda()
    kw = dict(white_bkgd=white_bkgd, noise_std=1.0, seed=1234567)
    got = fr.fused_rgb_train_grads(field, odv, z, gt, **kw)
    g2, _, _ = fr.fused_rgb_train_grads(field, odv, z, gt, **kw)
    torch.cuda.synchronize()
    close = check_k3(f"R={R} S={S}", got, *plain_k3_with_gates(field, odv, z, gt, kw))
    if not all(torch.equal(got[0][k], g2[k]) for k in g2):
        raise SystemExit(f"K3's gradients differ between two calls (R={R} S={S})")
    ms = cuda_ms(lambda: fr.fused_rgb_train_grads(field, odv, z, gt, **kw))
    plain_ms = cuda_ms(lambda: fr.rgb_train_grads_plain(field, odv, z, gt, **kw), reps=3)
    split = forward_split(lambda: fr.fused_rgb_train_grads(field, odv, z, gt, **kw), "K3")
    bound = k3_cost(field, R, S, got[1].shape[1])
    phase("K3", rays=R, samples=S, semantics=use_semantics, white_bkgd=white_bkgd, **close,
          deterministic=True, ms=ms, plain_ms=plain_ms, **split,
          tflop=R * S * field_flops(field, "k3") / 1e12, **bound)
    return {"max_abs_err": close["max_abs_err"], "ms": ms, "plain_ms": plain_ms, **bound,
            "library_ms": None}


def eval_args(*extra):
    """The [eval] phase's flags (its seeded flagship .ckpt, 64 + 128 samples,
    the semantic head with coordinates) with the flags in ``extra``."""
    from nerfsos_torch import run_nerf

    argv = ["--expname", "smoke", "--basedir", os.path.join(WORK, "logs"),
            "--data_path", os.path.join(WORK, "data"), "--data_type", "llff",
            "--sem_with_coord", "--N_samples", "64", "--N_importance", "128",
            "--ckpt_path", os.path.join(WORK, "seeded.ckpt"), *extra]
    args, _ = run_nerf.create_arg_parser().parse_known_args(argv)
    return args


def eval_path(fr) -> dict:
    from nerfsos_torch import run_nerf
    from nerfsos_torch.data.datasets import RayDataset
    from nerfsos_torch.data.synthetic import write_sphere_scene
    from nerfsos_torch.engines import checkpoint as ckpt_lib
    from nerfsos_torch.engines import eval as eval_lib
    from nerfsos_torch.models.nerf import NeRFConfig, NeRFNet

    data, logs = os.path.join(WORK, "data"), os.path.join(WORK, "logs")
    H, W = 378, 504
    write_sphere_scene(data, H, W, n_views=1)
    os.makedirs(os.path.join(logs, "smoke"), exist_ok=True)
    cfg = NeRFConfig(n_samples=64, n_importance=128, use_semantics=True, sem_with_coord=True)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        ckpt_net = NeRFNet(cfg)
    ckpt = os.path.join(WORK, "seeded.ckpt")
    ckpt_lib.save_checkpoint(ckpt, 0, ckpt_net)

    args = eval_args("--eval", "--fast_mode", "--ret_cluster", "--clus_no_sfm", "--use_masks")

    views, spent = [], {"view": 0.0, "render": 0.0}
    orig = eval_lib.eval_one_view

    def timed(key, fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        spent[key] += time.perf_counter() - t0
        return out

    def recording_eval_one_view(render_fn, *a, **kw):
        ret, metrics = timed("view", orig, lambda rays: timed("render", render_fn, rays), *a, **kw)
        views.append(ret)
        return ret, metrics

    fr.fused_coarse_weights.launches = 0
    fr.fused_render.launches = 0
    # the view's K1 and K2 calls, held against plain below
    cap = Capture(fr, ["fused_coarse_weights", "fused_render"])
    cap.on = True
    eval_lib.eval_one_view = recording_eval_one_view
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_nerf.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        eval_lib.eval_one_view = orig
        cap.close()
    launches = {"K1": fr.fused_coarse_weights.launches, "K2": fr.fused_render.launches}
    # the run's seconds: the view's render, then its k-means, ARI and SSIM,
    # then the rest (arguments, model, checkpoint, data, PNGs, logs)
    phase("eval", view=f"{H}x{W}", seconds=seconds, render_s=spent["render"],
          metrics_s=spent["view"] - spent["render"], rest_s=seconds - spent["view"],
          launches=launches)
    if min(launches.values()) < 1:
        raise SystemExit(f"the --eval run did not go through both kernels: {launches}")

    with open(os.path.join(logs, "smoke", "eval", "log.json")) as f:
        log = json.load(f)
    for k in ("total_mse", "total_psnr", "total_ssim"):
        if not (isinstance(log.get(k), float) and math.isfinite(log[k])):
            raise SystemExit(f"log.json {k}={log.get(k)!r} is not finite")
    if not os.path.exists(os.path.join(logs, "smoke", "eval", "rgb_000.png")):
        raise SystemExit("rgb_000.png was not written")
    (ret,) = views
    for k in ("rgb", "depth", "acc", "disp", "semantics", "weights"):
        if not np.isfinite(ret[k]).all():
            raise SystemExit(f"rendered {k} holds non-finite values")
    phase("eval_metrics", psnr=log["total_psnr"], ssim=log["total_ssim"],
          clus_ari=log["total_clus_ari"], sem_ari=log["total_sem_ari"])
    # the view's last K1 call against plain, and again on the same inputs, bitwise
    a, _, got = cap.calls["fused_coarse_weights"][-1]
    with torch.no_grad():
        want = fr.coarse_weights_plain(*a)
        again = fr.fused_coarse_weights(*a)
    torch.cuda.synchronize()
    err = max_err(got, want)
    if not (torch.isfinite(got).all() and err <= TOL):
        raise SystemExit(f"K1 on the eval view disagrees with its plain version: {err} > {TOL}")
    if not torch.equal(got, again):
        raise SystemExit("K1 on the eval view: two calls differ")
    phase("eval_k1", calls=len(cap.calls["fused_coarse_weights"]), rays=a[2].shape[0],
          samples=a[2].shape[1], max_abs_err=err, tol=TOL, deterministic=True)
    # the view's last K2 call (its own importance-sampled z) against plain, and
    # again on the same inputs, bitwise
    a, _, got = cap.calls["fused_render"][-1]
    with torch.no_grad():
        want = fr.render_plain(*a)
        again = fr.fused_render(*a)
    torch.cuda.synchronize()
    err = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
    if not (torch.isfinite(got[0]).all() and err <= TOL):
        raise SystemExit(f"K2 on the eval view disagrees with its plain version: {err} > {TOL}")
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise SystemExit("K2 on the eval view: two calls differ")
    phase("eval_k2", calls=len(cap.calls["fused_render"]), rays=a[2].shape[0],
          samples=a[2].shape[1], max_abs_err=err, tol=TOL, deterministic=True)
    del cap

    # the same view again, render only: kernel path vs plain path
    net, _ = run_nerf.build_model(args, torch.device("cuda"))
    state, _, _ = ckpt_lib.load_checkpoint(ckpt)
    net.load_state_dict(state)
    plain = NeRFNet(dataclasses.replace(net.cfg, fused_field=False)).cuda().eval()
    plain.load_state_dict(state)
    dataset = RayDataset(data, split="test")
    rays, near_far = dataset.get_view(0)["rays"], dataset.near_far()
    out, secs = {}, {}
    for name, model in (("kernel", net), ("plain", plain)):
        render = eval_lib.make_render_fn(model, *near_far)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = render(rays)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    d_rgb = (out["kernel"]["rgb"] - out["plain"]["rgb"]).abs().amax(dim=-1)
    frac = float((d_rgb > 1e-3).float().mean())
    phase("render", view=f"{H}x{W}", kernel_s=secs["kernel"], plain_s=secs["plain"],
          rgb_max_abs_diff=float(d_rgb.max()), frac_rays_over_1e_3=frac)
    # importance samples may move by one bin where a u falls on a CDF edge, so
    # the end-to-end check bounds the share of rays that differ, not the max
    if frac > 1e-3:
        raise SystemExit(f"{frac:.2%} of rays differ by more than 1e-3 from the plain path")
    return launches


TRAIN_STEPS, RESUME_STEPS = 30, 40


def train_args(data: str, logs: str, max_steps: int, expname: str = "smoke_train", extra=()):
    """The flagship pretrain flags (configs/flower_full.txt: N_rand 1024,
    64 + 128 samples, raw_noise_std 1, the semantic head by default) on the
    smoke scene, with the flags in ``extra`` added."""
    from nerfsos_torch import run_nerf

    argv = ["--config", os.path.join(ROOT, "configs", "flower_full.txt"),
            "--expname", expname, "--basedir", logs, "--data_path", data,
            "--max_steps", str(max_steps), "--i_print", "10", "--i_weights", "10",
            "--i_testset", "1000000", "--fast_mode", *extra]
    args, _ = run_nerf.create_arg_parser().parse_known_args(argv)
    return args


TRAIN_COUNTS = {"K1": "fused_coarse_weights", "K2": "fused_render", "K3": "fused_rgb_train_grads"}
MIP_COUNTS = {"K9": "fused_mip_render", "K10a": "mip_train_render",
              "K10b": "mip_train_render_grads"}


def run_train(fr, args, counts: dict, capture=(), capture_step: int = -1, mod=None) -> dict:
    """``run_nerf.main(args)`` in train mode with the kernel counts
    ``counts`` (kernel -> wrapper name in ``mod``, by default ``fr``) set to
    0 just before and read just after; the train step is wrapped to record
    each step's index and loss and the Adam step count it starts from. At
    ``capture_step`` the calls of the wrappers of ``mod`` named in
    ``capture`` are kept in ``rec["calls"]``, as ``Capture`` keeps them."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.engines import trainer

    rec = {"steps": [], "losses": [], "adam_step_at_start": None}
    orig = trainer.make_rgb_train_step

    def recording_make_step(net, optimizer, *a, **kw):
        # K3's wrapper is looked up here, so that the capturing stand-in is called
        kw.setdefault("grads_fn", fr.fused_rgb_train_grads)
        step = orig(net, optimizer, *a, **kw)
        first = next(net.parameters())

        def recorded(batch, global_step):
            if rec["adam_step_at_start"] is None:
                st = optimizer.state.get(first, {})
                rec["adam_step_at_start"] = int(st["step"]) if "step" in st else 0
            cap.on = global_step == capture_step
            try:
                metrics = step(batch, global_step)
            finally:
                cap.on = False
            rec["steps"].append(global_step)
            rec["losses"].append(metrics["loss"])
            return metrics

        return recorded

    mod = fr if mod is None else mod
    for name in counts.values():
        getattr(mod, name).launches = 0
    cap = Capture(mod, list(capture))
    trainer.make_rgb_train_step = recording_make_step
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_nerf.main(args)
        torch.cuda.synchronize()
        rec["seconds"] = time.perf_counter() - t0
    finally:
        trainer.make_rgb_train_step = orig
        cap.close()
    rec["launches"] = {k: getattr(mod, name).launches for k, name in counts.items()}
    rec["calls"] = cap.calls
    rec["losses"] = [float(x) for x in rec["losses"]]
    return rec


def check_checkpoints(run_dir: str, names) -> None:
    from nerfsos_torch.engines import checkpoint as ckpt_lib

    for name in names:
        path = os.path.join(run_dir, "checkpoints", name)
        if not os.path.exists(path):
            raise SystemExit(f"{name} was not written")
        _, _, opt = ckpt_lib.load_checkpoint(path)
        if not (opt and opt.get("state")):
            raise SystemExit(f"{name} holds no optimizer state")


def check_final_eval(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "eval", "log.json")) as f:
        log = json.load(f)
    for k in ("total_mse", "total_psnr", "total_ssim"):
        if not (isinstance(log.get(k), float) and math.isfinite(log[k])):
            raise SystemExit(f"final eval log.json {k}={log.get(k)!r} is not finite")
    return log


def train_path(fr) -> dict:
    from nerfsos_torch.data.synthetic import write_sphere_scene

    write_sphere_scene(os.path.join(WORK, "data"), 378, 504, n_views=8, split="train")
    rec = run_train(fr, train_args(os.path.join(WORK, "data"), os.path.join(WORK, "logs"),
                                   TRAIN_STEPS),
                    TRAIN_COUNTS, ["fused_rgb_train_grads"], TRAIN_STEPS - 1)
    losses, launches = rec["losses"], rec["launches"]
    run_dir = os.path.join(WORK, "logs", "smoke_train")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    phase("train", steps=len(losses), views="8x378x504", seconds_incl_load_and_eval=rec["seconds"],
          launches=launches, loss_first10=first, loss_last10=last,
          loss_step1=losses[0], loss_step30=losses[-1])
    if rec["steps"] != list(range(TRAIN_STEPS)):
        raise SystemExit(f"train ran steps {rec['steps']}")
    if launches["K3"] != 2 * TRAIN_STEPS or min(launches["K1"], launches["K2"]) < 1:
        raise SystemExit(f"the train run did not go through the kernels as expected: {launches}")
    if not (all(math.isfinite(x) for x in losses) and last < first):
        raise SystemExit(f"train loss not finite or not falling: {losses}")
    check_checkpoints(run_dir, ["00000010.ckpt", "00000020.ckpt", "00000030.ckpt",
                                "latest.ckpt", "last.ckpt"])
    log = check_final_eval(run_dir)
    phase("train_eval", psnr=log["total_psnr"], ssim=log["total_ssim"])
    # the last step's two K3 calls (coarse: stratified z; fine: the coarse z
    # and the importance samples, sorted) against the plain version on the
    # same inputs; only the plain version runs here
    calls = rec["calls"]["fused_rgb_train_grads"]
    if len(calls) != 2:
        raise SystemExit(f"captured {len(calls)} K3 calls of step {TRAIN_STEPS - 1}")
    for name, ((field, odv, z, gt), kw, got) in zip(("coarse", "fine"), calls):
        close = check_k3(f"train step {TRAIN_STEPS - 1}, {name}", got,
                         *plain_k3_with_gates(field, odv, z, gt, kw))
        phase("train_k3", step=TRAIN_STEPS - 1, field=name, rays=z.shape[0], samples=z.shape[1],
              **close)
    return launches


def resume_path(fr) -> None:
    rec = run_train(fr, train_args(os.path.join(WORK, "data"), os.path.join(WORK, "logs"),
                                   RESUME_STEPS), TRAIN_COUNTS)
    phase("resume", first_step=rec["steps"][0], adam_step_at_start=rec["adam_step_at_start"],
          launches=rec["launches"], loss_first=rec["losses"][0], loss_last=rec["losses"][-1])
    if rec["steps"] != list(range(TRAIN_STEPS, RESUME_STEPS)):
        raise SystemExit(f"resume ran steps {rec['steps']}, not {TRAIN_STEPS}..{RESUME_STEPS - 1}")
    if rec["adam_step_at_start"] != TRAIN_STEPS:
        raise SystemExit(f"the Adam state was not restored: step {rec['adam_step_at_start']}")
    if rec["launches"]["K3"] != 2 * (RESUME_STEPS - TRAIN_STEPS):
        raise SystemExit(f"resume launched K3 {rec['launches']['K3']} times")
    if not all(math.isfinite(x) for x in rec["losses"]):
        raise SystemExit(f"resume loss not finite: {rec['losses']}")
    check_checkpoints(os.path.join(WORK, "logs", "smoke_train"), ["00000040.ckpt"])


def train_step_timings(fr) -> None:
    """ms per train step (CUDA events) on the kernel path and on the plain
    path (K3's plain version in place of the kernel), with the step's
    matrix-product FLOP and its share of the bound."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.data.datasets import RayDataset
    from nerfsos_torch.engines import state as state_lib
    from nerfsos_torch.engines.trainer import make_rgb_train_step

    args = train_args(os.path.join(WORK, "data"), os.path.join(WORK, "logs"), 0)
    net, _ = run_nerf.build_model(args, torch.device("cuda"))
    optimizer = state_lib.make_optimizer(net.parameters(), args.lrate)
    schedule = state_lib.exp_decay_schedule(args.lrate, args.decay_rate, args.decay_step * 1000)
    dataset = RayDataset(os.path.join(WORK, "data"), split="train")
    near, far = dataset.near_far()
    per_ray = (args.N_samples * field_flops(net.nerf, "k3")
               + (args.N_samples + args.N_importance) * field_flops(net.nerf_fine, "k3"))
    total = torch.cuda.get_device_properties(0).total_memory
    peak = {}
    for path, grads_fn, sizes in (("kernel", fr.fused_rgb_train_grads, (1024, 4096, 16384)),
                                  ("plain", fr.rgb_train_grads_plain, (1024, 4096, 16384))):
        step = make_rgb_train_step(net, optimizer, schedule, near, far, args.rgb_w, args.seed,
                                   grads_fn=grads_fn)
        for R in sizes:
            if path == "plain" and R == 16384:
                need = 4 * peak[4096]
                if need > 0.9 * total:
                    phase("train_step", path=path, rays=R,
                          skipped=f"needs ~{need / 2**30:.1f} GiB (4 x the 4096-ray step's "
                                  f"peak), the card has {total / 2**30:.1f} GiB")
                    continue
            b = dataset.sample_batch(np.random.default_rng(R), R)
            batch = {k: torch.as_tensor(b[k], device="cuda") for k in ("rays", "target")}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reps = 2 if R == 16384 else 5
            ms = cuda_ms(lambda: step(batch, 0), reps=reps, warmup=1)
            peak[R] = torch.cuda.max_memory_allocated()
            flops = R * per_ray
            bound = flops / FP32_MMA_FLOP_S * 1e3
            phase("train_step", path=path, rays=R, ms=ms, rays_per_s=R / ms * 1e3,
                  tflop=flops / 1e12, bound_ms=bound, share_of_bound=bound / ms,
                  peak_gib=peak[R] / 2**30)
    # K3's weight buffers of both fields, which the step packs again after
    # each Adam step: pack_field's, the ring gathered from it,
    # pack_train_bwd's, and the reverse sweep's ring gathered from that
    fields = (net.nerf, net.nerf_fine)
    with torch.no_grad():
        packed = [fr.pack_field(f) for f in fields]
        bwd = [fr.pack_train_bwd(f) for f in fields]
        for part, pack in (("pack_field", lambda: [fr.pack_field(f) for f in fields]),
                           ("ring", lambda: [fr._ring_from(f, *p) for f, p in zip(fields, packed)]),
                           ("pack_train_bwd", lambda: [fr.pack_train_bwd(f) for f in fields]),
                           ("bwd ring", lambda: [fr._bwd_ring_from(f, *b)
                                                 for f, b in zip(fields, bwd)])):
            phase("train_step_part", part=f"weight packing: {part}",
                  ms=cuda_ms(pack, reps=5, warmup=1))


TRAIN_COUNTS_BF16 = {"K1": "fused_coarse_weights", "K2": "fused_render",
                     "K3": "fused_rgb_train_grads"}


def train_bf16_path(fr) -> dict:
    """[train_bf16]: the [train] phase's pretrain (its flags and views,
    TRAIN_STEPS steps from the seed) at ``--compute_dtype bfloat16``: K3 in
    its bf16 mode twice a step and the final eval through K1's and K2's
    (bf16 counts set to 0 just before, no fp32 launch), the loss finite and
    falling, the last step's two K3 calls against their bf16 plain versions
    (bf16_columns, bf16_leaves) and a second call, bitwise."""
    bf = torch.bfloat16
    for n in TRAIN_COUNTS_BF16.values():
        getattr(fr, n).launches_bf16 = 0
    args = train_args(os.path.join(WORK, "data"), os.path.join(WORK, "logs"), TRAIN_STEPS,
                      "smoke_train_bf16", extra=["--compute_dtype", "bfloat16"])
    rec = run_train(fr, args, TRAIN_COUNTS_BF16, ["fused_rgb_train_grads"], TRAIN_STEPS - 1)
    launches = {k: getattr(fr, n).launches_bf16 for k, n in TRAIN_COUNTS_BF16.items()}
    losses = rec["losses"]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    phase("train_bf16", steps=len(losses), seconds_incl_load_and_eval=rec["seconds"],
          launches=launches, fp32_launches=rec["launches"], loss_first10=first,
          loss_last10=last)
    if (any(rec["launches"].values()) or launches["K3"] != 2 * TRAIN_STEPS
            or min(launches["K1"], launches["K2"]) < 1):
        raise SystemExit(f"the bf16 train run did not go through the bf16 kernels alone: bf16 "
                         f"{launches}, fp32 {rec['launches']}")
    if not (all(math.isfinite(x) for x in losses) and last < first):
        raise SystemExit(f"bf16 train loss not finite or not falling: {losses}")
    log = check_final_eval(os.path.join(WORK, "logs", "smoke_train_bf16"))
    checks = {}
    for name, ((field, odv, z, gt), kw, got) in zip(
            ("coarse", "fine"), rec["calls"]["fused_rgb_train_grads"]):
        want = fr.rgb_train_grads_plain(field, odv, z, gt, **kw)
        witness = bf16_witness(lambda f: fr.rgb_train_grads_plain(f, odv, z, gt, **kw)[0],
                               field, want[0])
        again = fr.fused_rgb_train_grads(field, odv, z, gt, **kw)
        if kw["compute_dtype"] != bf or not all(torch.equal(got[0][k], again[0][k])
                                                for k in got[0]):
            raise SystemExit(f"K3 at step {TRAIN_STEPS - 1} ({name}): not bf16, or two calls "
                             "differ")
        checks[name] = {"maps": bf16_columns(f"K3 maps ({name})", got[1], want[1]),
                        "leaves": bf16_leaves(f"K3 ({name})", got[0], want[0], witness)}
    phase("train_bf16_eval", psnr=log["total_psnr"], ssim=log["total_ssim"],
          last_step=checks)
    return launches


def train_step_bf16_timings(fr) -> None:
    """[train_step_bf16]: the flagship RGB step (grads and Adam, CUDA events)
    at bf16 and at fp32 in turns (fp32, bf16, bf16, fp32) on the same
    weights and batch, at 1024 rays (15 steps a turn) and 16384 rays (3),
    with peak memory and each dtype's bound."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.data.datasets import RayDataset
    from nerfsos_torch.engines import state as state_lib
    from nerfsos_torch.engines.trainer import make_rgb_train_step

    dataset = RayDataset(os.path.join(WORK, "data"), split="train")
    near, far = dataset.near_far()
    steps, nets = {}, {}
    for name, dtype in (("fp32", "float32"), ("bf16", "bfloat16")):
        args = train_args(os.path.join(WORK, "data"), os.path.join(WORK, "logs"), 0,
                          extra=["--compute_dtype", dtype])
        nets[name], _ = run_nerf.build_model(args, torch.device("cuda"))
        opt = state_lib.make_optimizer(nets[name].parameters(), args.lrate)
        steps[name] = make_rgb_train_step(
            nets[name], opt, state_lib.exp_decay_schedule(args.lrate, args.decay_rate,
                                                          args.decay_step * 1000),
            near, far, args.rgb_w, args.seed)
    per_ray = (args.N_samples * field_flops(nets["fp32"].nerf, "k3")
               + (args.N_samples + args.N_importance) * field_flops(nets["fp32"].nerf_fine, "k3"))
    for R, reps in ((1024, 15), (16384, 3)):
        b = dataset.sample_batch(np.random.default_rng(R), R)
        batch = {k: torch.as_tensor(b[k], device="cuda") for k in ("rays", "target")}
        for name in ("fp32", "bf16", "bf16", "fp32"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: steps[name](batch, 0), reps=reps, warmup=1)
            rate = BF16_FLOP_S if name == "bf16" else FP32_MMA_FLOP_S
            phase("train_step_bf16", compute_dtype=name, rays=R, steps=reps, ms=ms,
                  rays_per_s=R / ms * 1e3, bound_ms=R * per_ray / rate * 1e3,
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30)


# The fp32 K3's, K6's, K9's, K10a's, K10b's, K11's and the classic field
# kernels' (K8a, K8b, K8f, K8c) outputs on fixed
# seeded inputs, as sha256 digests (fp32_train_kernels), from this tree's
# parent on an NVIDIA H100 80GB HBM3 (nerfsos_torch/tools/fp32_train_kernels.py
# --root on the parent): the bf16 modes share their kernels' sources, and
# their fp32 instantiations must not move by a bit.
FP32_FINGERPRINTS = {"K3": "806e3addc6b0784a", "K6": "099605c1c82da1b0",
                     "K9": "2467f0fc761c5430", "K10a": "41bd02c1ad3cb367",
                     "K10b": "08182680a80f63ed", "K11": "367b6f56084c2655",
                     "K8a": "48804a3b48b8ac6e", "K8b": "acdf0969904792aa",
                     "K8f": "0acefffd9bfa549f", "K8c": "314cb57e3398c4a6"}
# The same calls' outputs in their bf16 modes (--compute_dtype bfloat16),
# from the tree before csrc's larger sources were compiled in parts
# (nerfsos_torch/_build.PARTS), by the same tool, on the same card.
BF16_FINGERPRINTS = {"K3": "312d4c590672dd41", "K6": "d9164c54d6c4af1a",
                     "K9": "8875a76e49e5d460", "K10a": "ce72cea3c94c2e5c",
                     "K10b": "30c8b5d3212868c7", "K11": "3c4389f9b138d6d9",
                     "K8a": "8cd5bd880cb927fd", "K8b": "bb351a4f4563c51d",
                     "K8f": "7ddb763aae897376", "K8c": "fe015e51551923b2"}


def fp32_train_kernels(fr, bf16: bool = False) -> dict:
    """[fp32_train_kernels]: sha256 digests (16 hex digits) of K3's fp32
    grads, maps and weights (1024 rays x 192 samples), of K6's fp32 grads
    (4096 x 64, the semantic head, seeded cotangents), of K9's and K10a's
    maps and weights (4096 rays x 190 intervals; K10a with noise 1), of
    K10b's grads (1024 x 190, seeded cotangents), of K11's raw (2^16
    points, covariances below 1e-4), of the sigma forward's (K8a) and the
    field forward's (K8b) outputs (2^16 points of the x14 grid) and of the
    field backward's grads (K8f) and, in its input-gradient mode (K8c),
    grads, dpts and ddirs (256 x 64 points of rays, a seeded cotangent) on
    seeded flagship-width inputs (the semantic head with coordinates), held
    equal to FP32_FINGERPRINTS where it is set; and the fp32 K3's ms at 1024
    rays (S = 64, 192), K6's at 32768 rays (S = 192, 64), K9's at 32768 x
    190 and K10b's at 1024 x 190, for an A/B against another tree in one
    call. With ``bf16``, [bf16_train_kernels]: the same calls' digests in
    their bf16 modes, held equal to BF16_FINGERPRINTS where it is set, not
    timed."""
    import hashlib

    from nerfsos_torch.ops import fused_field as ff

    def digest(tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().float().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    k3_field = seeded_field(2, net_depth=8, net_width=256, multires=10, multires_views=4,
                            use_semantics=True, sem_dim=2)
    k6_field = seeded_field(3, net_depth=8, net_width=256, multires=10, multires_views=4,
                            use_semantics=True, sem_with_coord=True, sem_dim=2)
    out, ms = {}, {}
    dt = {"compute_dtype": torch.bfloat16 if bf16 else torch.float32}

    def timed(name, fn, **kw):
        if not bf16:
            ms[name] = cuda_ms(fn, **kw)

    for S in (192, 64):
        odv, z = ray_inputs(1024, S, seed=5)
        gt = torch.from_numpy(np.random.default_rng(6).uniform(0, 1, (1024, 3)).astype(np.float32))
        kw = dict(white_bkgd=False, noise_std=1.0, seed=424242)
        g, maps, w = fr.fused_rgb_train_grads(k3_field, odv, z, gt.cuda(), **kw, **dt)
        if S == 192:
            out["K3"] = digest([g[k] for k in sorted(g)] + [maps, w])
        timed(f"K3 1024x{S}", lambda: fr.fused_rgb_train_grads(k3_field, odv, z, gt.cuda(), **kw))
    for R, S in ((4096, 64), (32768, 192), (32768, 64)):
        odv, z = ray_inputs(R, S, seed=7)
        rng = np.random.default_rng(8)
        dmaps = torch.from_numpy(rng.normal(size=(R, 7)).astype(np.float32)).cuda()
        dw = torch.from_numpy(rng.normal(size=(R, S)).astype(np.float32)).cuda()
        kw = dict(noise_std=1.0, seed=535353)
        if R == 4096:
            g = fr.train_render_grads(k6_field, odv, z, dmaps, dw, **kw, **dt)
            out["K6"] = digest([g[k] for k in sorted(g)])
        else:
            timed(f"K6 {R}x{S}", lambda: fr.train_render_grads(k6_field, odv, z, dmaps, dw, **kw),
                  reps=3)
        del odv, z, dmaps, dw
    mip = seeded_mip_field(7)
    with torch.no_grad():
        odvr, z = mip_ray_inputs(4096, 190, seed=9)
        out["K9"] = digest(fr.fused_mip_render(mip, odvr, z, **dt))
        out["K10a"] = digest(fr.mip_train_render(mip, odvr, z, noise_std=1.0, seed=97531, **dt))
        odvr, z = mip_ray_inputs(EVAL_CHUNK, 190, seed=10)
        timed("K9 32768x190", lambda: fr.fused_mip_render(mip, odvr, z), reps=3)
        pts, dirs = grid_points(1 << 16, 11), unit_dirs(1 << 16, 12)
        cov = (torch.rand(1 << 16, 3, generator=torch.Generator().manual_seed(13)) * 1e-4).cuda()
        out["K11"] = digest([ff.fused_mip_field_apply(mip, pts, cov, dirs, **dt)])
    odvr, z = mip_ray_inputs(1024, 190, seed=14)
    rng = np.random.default_rng(15)
    dmaps = torch.from_numpy(rng.normal(size=(1024, 5)).astype(np.float32)).cuda()
    dw = torch.from_numpy(rng.normal(size=(1024, 190)).astype(np.float32)).cuda()
    kw = dict(noise_std=1.0, seed=86420)
    g = fr.mip_train_render_grads(mip, odvr, z, dmaps, dw, **kw, **dt)
    out["K10b"] = digest([g[k] for k in sorted(g)])
    timed("K10b 1024x190", lambda: fr.mip_train_render_grads(mip, odvr, z, dmaps, dw, **kw))
    k8_field = seeded_field(16, net_depth=8, net_width=256, multires=10, multires_views=4,
                            use_semantics=True, sem_with_coord=True, sem_dim=2)
    with torch.no_grad():
        pts, dirs = grid_points(1 << 16, 17), unit_dirs(1 << 16, 18)
        out["K8a"] = digest([ff.fused_sigma_apply(k8_field, pts, **dt)])
        out["K8b"] = digest([ff.field_forward(k8_field, pts, dirs, **dt)])
    pts, dirs = noimp_points(256, 64, seed=19)
    g = torch.from_numpy(np.random.default_rng(20).normal(size=(pts.shape[0], 6))
                         .astype(np.float32)).cuda()
    for name, input_grads in (("K8f", False), ("K8c", True)):
        grads, dp, dd = ff.field_grads(k8_field, pts, dirs, g, input_grads=input_grads, **dt)
        out[name] = digest([grads[k] for k in sorted(grads)] + ([dp, dd] if input_grads else []))
    torch.cuda.empty_cache()
    expected = BF16_FINGERPRINTS if bf16 else FP32_FINGERPRINTS
    name = "bf16" if bf16 else "fp32"
    phase(f"{name}_train_kernels", **out, expected=expected, **({} if bf16 else {"ms": ms}))
    if expected is not None and out != expected:
        raise SystemExit(f"the {name} K3/K6/mip/field outputs moved from the parent's: {out}, "
                         f"expected {expected}")
    return out


# ----------------------------------------------------------------- the SOS finetune


class Capture:
    """Wraps kernel wrappers of ``module`` (by name) so that the calls made
    while ``on`` is set are kept: inputs and outputs by reference, a field
    argument copied (Adam moves it after the step). Each wrapper counts its
    launches on the stand-in while it is in place (every integer counter:
    ``launches``, ``input_grad_launches``); ``close`` adds them to the
    original wrapper's counters and puts the original back."""

    def __init__(self, module, names):
        self.module, self.on = module, False
        self.calls = {n: [] for n in names}
        self.orig = {n: getattr(module, n) for n in names}
        for n in names:
            setattr(module, n, self._wrap(n))

    def _wrap(self, name):
        orig = self.orig[name]

        def wrapper(*a, **kw):
            out = orig(*a, **kw)
            if self.on:
                a = tuple(copy.deepcopy(x) if isinstance(x, torch.nn.Module) else x for x in a)
                self.calls[name].append((a, kw, out))
            return out

        wrapper.__dict__.update({k: 0 for k, v in vars(orig).items() if isinstance(v, int)})
        return wrapper

    def close(self) -> None:
        for n, orig in self.orig.items():
            for k, v in vars(getattr(self.module, n)).items():
                if isinstance(v, int) and k in vars(orig):
                    setattr(orig, k, getattr(orig, k) + v)
            setattr(self.module, n, orig)


def plain_k5_with_allowance(field, sem_in, w, dmaps):
    """K5's plain version, and per leaf what a semantic-head relu gate that
    flips between it and the kernel can move: twice the largest term of a
    point with a gate input within GATE_MARGIN (of the layer's largest
    |input|) of 0 (dW0: |sem_in| x |ds|, db0: |ds|; sem_1's terms hold
    s_act, which is within rounding of 0 at such a gate)."""
    from nerfsos_torch.ops import fused_render as fr

    want = fr.frozen_sem_grads_plain(field, sem_in, w, dmaps)
    lin0, lin2 = field.mlp.semantic_linear[0], field.mlp.semantic_linear[2]
    S = w.shape[1]
    chunks = range(0, sem_in.shape[0], 1 << 20)
    with torch.no_grad():
        top = max(float(torch.nn.functional.linear(sem_in[i:i + (1 << 20)], lin0.weight,
                                                   lin0.bias).abs().max()) for i in chunks)
        x_ds, ds_max, near = 0.0, 0.0, 0
        for i in chunks:
            blk = sem_in[i:i + (1 << 20)]
            pre = torch.nn.functional.linear(blk, lin0.weight, lin0.bias).abs()
            m = pre.amin(1) <= GATE_MARGIN * top
            if not m.any():
                continue
            q = torch.arange(i, i + blk.shape[0], device=blk.device)[m]
            d_sem = dmaps[q // S, 5:] * w.reshape(-1)[q, None]
            ds = (d_sem @ lin2.weight).abs().amax(1)
            x_ds = max(x_ds, float((blk[m].abs().amax(1) * ds).max()))
            ds_max = max(ds_max, float(ds.max()))
            near += int(m.sum())
    names = list(want)
    allow = {names[0]: 2 * x_ds, names[1]: 2 * ds_max, names[2]: 0.0, names[3]: 0.0}
    return want, allow, near


def check_k5(what: str, got, want, allow, near) -> dict:
    """Each semantic-head leaf to GRAD_TOL of its max |plain| plus its flip
    allowance; raises."""
    worst, name_w, over, abs_err = 0.0, "", 0.0, 0.0
    for name, ref in want.items():
        scale = max(float(ref.abs().max()), 1e-12)
        e = max_err(got[name], ref)
        abs_err = max(abs_err, e)
        if e / scale >= worst:
            worst, name_w = e / scale, name
        over = max(over, e / (GRAD_TOL * scale + allow[name]))
    finite = all(torch.isfinite(t).all() for t in got.values())
    if not (finite and over <= 1.0):
        raise SystemExit(f"K5 disagrees with its plain version ({what}): worst leaf {name_w} at "
                         f"{worst} of its max, error over its bound {over}, finite={finite}")
    return {"max_abs_err": abs_err, "grad_rel_err": worst, "worst_leaf": name_w,
            "grad_tol": GRAD_TOL, "near_gate_points": near, "grad_err_over_bound": over}


def k4_cost(field, R: int, S: int) -> dict:
    """K4's bound: the forward of every layer a point (FLOP), the rays, z,
    weights, maps and sem_in moved once (bytes)."""
    C = field.mlp.semantic_linear[0].in_features
    nbytes = 4 * (R * (9 + 2 * S + 7) + R * S * C + n_params(field))
    return bound_ms(nbytes, R * S * field_flops(field, "k2"))


def k4_design(field, R: int, S: int, ms: float, bf16: bool = False) -> dict:
    """What K4's design moves and reaches on R x S points in ms: the weight
    bytes a point reads from L2 (pack_ring's stages, once per 128-point
    tile), the achieved 3xTF32 (``bf16``: bf16) rate and its peak, and
    ptxas's line for the kernel."""
    from nerfsos_torch.ops import fused_render as fr

    ring, _ = fr.pack_ring(field, bf16)
    return {"l2_weight_bytes_per_point": ring.numel() * 4 / 128,
            "achieved_tflop_s": R * S * field_flops(field, "k2") / ms / 1e9,
            "mma_peak_tflop_s": (BF16_FLOP_S if bf16 else FP32_MMA_FLOP_S) / 1e12,
            "ptxas": repr(K4_BF16_PTXAS if bf16 else K4_PTXAS)}


def k4_bf16_cost(field, R: int, S: int) -> dict:
    """K4's bound at bf16: k4_cost's with sem_in and the weights in bf16
    and the products at the bf16 rate."""
    C = field.mlp.semantic_linear[0].in_features
    return bf16_bound(4 * R * (9 + 2 * S + 7) + 2 * R * S * C + 2 * n_params(field),
                      R * S * field_flops(field, "k2"))


def k5_bf16_cost(field, R: int, S: int) -> dict:
    """K5's bound at bf16: k5_cost's with sem_in in bf16 and the products at
    the bf16 rate."""
    C, H = field.mlp.semantic_linear[0].in_features, field.mlp.semantic_linear[0].out_features
    sem = field.mlp.semantic_linear[2].out_features
    return bf16_bound(2 * R * S * C + 4 * (R * S + R * 7 + 2 * (C * H + H + H * sem + sem)),
                      R * S * (4 * C * H + 4 * H * sem))


def k5_cost(field, R: int, S: int) -> dict:
    """K5's bound: per point sem_0's forward, ds, dW1 and dW0 (4 C H + 4 H
    sem FLOP); sem_in, the weights and the maps' cotangent read once."""
    C, H = field.mlp.semantic_linear[0].in_features, field.mlp.semantic_linear[0].out_features
    sem = field.mlp.semantic_linear[2].out_features
    return bound_ms(4 * (R * S * (C + 1) + R * 7 + 2 * (C * H + H + H * sem + sem)),
                    R * S * (4 * C * H + 4 * H * sem))


def k6_cost(field, R: int, S: int, bf16: bool = False) -> dict:
    """K6's bound: field_flops 'k6' a point (``bf16``: at the bf16 rate);
    the rays, z, the maps' and the weights' cotangents and the weights read
    once, the gradients written."""
    nmaps = 5 + (field.mlp.semantic_linear[2].out_features if field.mlp.use_semantics else 0)
    nbytes = 4 * (R * (9 + 2 * S + nmaps) + 2 * n_params(field))
    flops = R * S * field_flops(field, "k6")
    return bf16_bound(nbytes, flops) if bf16 else bound_ms(nbytes, flops)


def k7_ops(S: int, heads: int = 2) -> dict:
    """fp32 operations a pair (p, q) of K7's passes, counting a division
    as one: fd is 3 sub, 3 abs, 3 add, +0.05, div, min (12); K7a adds the
    row sum; the loss sweep (K7b one head, K7d/K7f two) adds -rowmean +
    offset and per head the codes' L1 (3 S - 1), +0.05, div, min, the
    product and the sum; the gradient sweep (K7c, K7e/K7g: one pass, each
    pair once) per head the L1, +0.05, div, the clamp test and three
    products, and per channel sign, product and two sums."""
    return {"K7a": 13, "loss": 14 + heads * (3 * S + 4), "grads": 14 + heads * (7 * S + 5)}


def max_sm_clock_hz() -> float:
    """The card's top SM clock (nvidia-smi's clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def k7_design(kernel: str, heads: int, B2: int, N: int, S: int) -> dict:
    """One K7 kernel's design numbers at a call of B2 x N pixels: its grid
    (fc.tile_grid's tiles; rowsum_tile_kernel's: 256 rows, no codes),
    ptxas's line, and the issue-rate bound: the SASS pair loop's
    instructions a pair (the loop's MUFU reciprocals over the pair's, one
    for fd and one a head in the sweeps) times the pairs over the SMs' issue
    rate at the card's top SM clock, or its reciprocals at the MUFU rate if
    that is slower."""
    from nerfsos_torch.ops import flash_corr as fc

    if kernel == "rowsum_tile_kernel":
        grid, rcp = [*fc.tile_grid(N, 0, 0), B2], 1
    else:
        grid, rcp = [*fc.tile_grid(N, S, heads), B2], 1 + heads
        kernel = f"{kernel}ILi{heads}ELi{S}E"
    loop = K7_SASS[kernel]
    pairs_per_iter = loop["mufu"] / rcp
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clocks = B2 * N * N / pairs_per_iter * max(loop["insns"] / LANE_INSNS_PER_CLOCK,
                                                 loop["mufu"] / MUFU_LANES_PER_CLOCK)
    return {"grid": grid, "ctas": math.prod(grid), "ptxas": repr(K7_PTXAS[kernel]),
            "loop_insns": loop["insns"], "loop_mufu": loop["mufu"],
            "insns_per_pair": loop["insns"] / pairs_per_iter,
            "issue_bound_ms": clocks / (sms * max_sm_clock_hz()) * 1e3}


def k7_costs(f1, c1a, heads: int = 2) -> dict:
    """Bounds of K7a and of the loss and gradient sweeps with ``heads``
    heads over the pairs of ``c1a [B2, N, S]``."""
    B2, N, S = c1a.shape
    pairs = B2 * N * N
    pts, codes = 4 * B2 * N * 3, 4 * B2 * N * S * heads
    ops = k7_ops(S, heads)
    return {"K7a": bound_ms(2 * pts + 4 * B2 * N + 8, pairs * ops["K7a"], FP32_SIMT_FLOP_S),
            "loss": bound_ms(2 * pts + 2 * codes + 4 * B2 * N + 24, pairs * ops["loss"],
                             FP32_SIMT_FLOP_S),
            "grads": bound_ms(2 * pts + 4 * codes + 4 * B2 * N + 40, pairs * ops["grads"],
                              FP32_SIMT_FLOP_S)}


def kernel_vs_plain_k4_k5(fr, S: int) -> dict:
    """[K4] and [K5] at the flagship width, 4096 rays, noise 1 from a fixed
    seed, fixed sorted z; K5 on K4's own sem_in and weights, with seeded
    dmaps, and two calls bitwise equal."""
    field = seeded_field(3, net_depth=8, net_width=256, multires=10, multires_views=4,
                         use_semantics=True, sem_with_coord=True, sem_dim=2)
    R = 4096
    odv, z = ray_inputs(R, S, seed=4 + S)
    kw = dict(noise_std=1.0, seed=7654321, save_semin=True)
    with torch.no_grad():
        got = fr.train_render(field, odv, z, **kw)
        again = fr.train_render(field, odv, z, **kw)
        want = fr.train_render_plain(field, odv, z, **kw)
    torch.cuda.synchronize()
    errs = k4_errors(got, want)
    finite = all(torch.isfinite(t).all() for t in got)
    if not (finite and max(errs) <= TOL):
        raise SystemExit(f"K4 disagrees with its plain version (S={S}): maps (scaled), "
                         f"weights, sem_in errors {errs} (tol {TOL}), finite={finite}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise SystemExit(f"K4's outputs differ between two calls (S={S})")
    with torch.no_grad():
        ms = cuda_ms(lambda: fr.train_render(field, odv, z, **kw))
        plain_ms = cuda_ms(lambda: fr.train_render_plain(field, odv, z, **kw), reps=3)
    phase("K4", rays=R, samples=S, max_err_maps_scaled=errs[0], max_abs_err_weights=errs[1],
          max_abs_err_sem_in=errs[2], tol=TOL, deterministic=True, ms=ms, plain_ms=plain_ms,
          **k4_cost(field, R, S), **k4_design(field, R, S, ms))

    _, w, sem_in = got
    dmaps = torch.from_numpy(np.random.default_rng(S).normal(size=(R, 7)).astype(np.float32))
    dmaps = dmaps.cuda()
    g = fr.frozen_sem_grads(field, sem_in, w, dmaps)
    g2 = fr.frozen_sem_grads(field, sem_in, w, dmaps)
    torch.cuda.synchronize()
    close = check_k5(f"S={S}", g, *plain_k5_with_allowance(field, sem_in, w, dmaps))
    if not all(torch.equal(g[k], g2[k]) for k in g):
        raise SystemExit(f"K5's gradients differ between two calls (S={S})")
    ms5 = cuda_ms(lambda: fr.frozen_sem_grads(field, sem_in, w, dmaps))
    plain5 = cuda_ms(lambda: fr.frozen_sem_grads_plain(field, sem_in, w, dmaps), reps=3)
    phase("K5", rays=R, samples=S, **close, deterministic=True, ms=ms5, plain_ms=plain5,
          **k5_cost(field, R, S), ptxas=repr(K5_PTXAS))
    return {"K4": max(max_err(a, b) for a, b in zip(got, want)), "K5": close["max_abs_err"]}


def kernel_vs_plain_k6(fr, S: int) -> dict:
    """[K6] on the [K4]/[K5] phase's field and rays (4096 rays, noise 1 from
    a fixed seed, fixed sorted z) with seeded map and weight cotangents:
    every leaf to GRAD_TOL plus its gate-flip allowance (trunk, views, alpha
    and sem_0 gates), and two calls bitwise equal."""
    field = seeded_field(3, net_depth=8, net_width=256, multires=10, multires_views=4,
                         use_semantics=True, sem_with_coord=True, sem_dim=2)
    R = 4096
    odv, z = ray_inputs(R, S, seed=4 + S)
    rng = np.random.default_rng(100 + S)
    dmaps = torch.from_numpy(rng.normal(size=(R, 7)).astype(np.float32)).cuda()
    dweights = torch.from_numpy(rng.normal(size=(R, S)).astype(np.float32)).cuda()
    kw = dict(noise_std=1.0, seed=7654321)
    got = fr.train_render_grads(field, odv, z, dmaps, dweights, **kw)
    again = fr.train_render_grads(field, odv, z, dmaps, dweights, **kw)
    torch.cuda.synchronize()
    close = check_k6(f"S={S}", got, *plain_k6_with_gates(field, odv, z, dmaps, dweights, kw))
    if not all(torch.equal(got[k], again[k]) for k in got):
        raise SystemExit(f"K6's gradients differ between two calls (S={S})")
    ms = cuda_ms(lambda: fr.train_render_grads(field, odv, z, dmaps, dweights, **kw))
    plain_ms = cuda_ms(lambda: fr.train_render_grads_plain(field, odv, z, dmaps, dweights, **kw),
                       reps=3)
    split = forward_split(lambda: fr.train_render_grads(field, odv, z, dmaps, dweights, **kw),
                          "K6")
    phase("K6", rays=R, samples=S, **close, deterministic=True, ms=ms, plain_ms=plain_ms,
          **split, **k6_cost(field, R, S))
    return close


# ----------------------------------------------------------------- bf16

# The bf16 modes (--compute_dtype bfloat16: K1, K2 and K4 on the 128-point
# tile's bf16 mode, K5's bf16 mode; wgmma m64nNk16 bf16). A kernel and its
# bf16 plain version round the same operands to bf16 and accumulate in fp32
# in other orders, so an activation within that fp32 rounding of a bf16
# rounding boundary rounds the other way on the two sides (one bf16 step,
# carried on by later layers and at times across a relu gate). At the
# flagship width that is no rare event: a ray meets ~10^5 bf16 roundings,
# ~0.1-0.3% of sem_in's entries differ, and up to 0.63% of a call's rows
# move by more than TOL (the bf16 eval view's K2; by at most 3.8e-4 of the
# column's scale, the SOS run's K4; H100). As GATE_MARGIN sets the points
# near a gate apart, such rows are counted and bounded as a group
# (bf16_columns): at most BF16_FLIP_ROWS of a call's rows may lie further
# than the fp32 kernels' TOL from the plain version (per column, over the
# scale max(1, max |plain|)), and no entry further than BF16_ENTRY of its
# column's scale (about 5x the largest flip measured). Both calls' inputs
# are seeded and the kernels deterministic, so these readings repeat run
# to run. Each [K*_bf16] line prints them over their bounds beside two
# controls: the fp32 kernel's output on the same inputs in place of the
# bf16 one (control_*; refused wherever the bf16-vs-fp32 distance exceeds
# the bounds), and the bf16 output with its last hundredth of rows each
# given its predecessor's values (tail_fault_*: a ragged tail written from
# the wrong ray), which bf16_columns requires the bounds to refuse. sem_in,
# stored in bf16 on both sides (bf16_stored): a flip there is a whole bf16
# step of an entry; at most BF16_STORED_SHARE of its entries may differ
# (measured up to 0.31%), each within BF16_STORED_STEPS bf16 steps (2^-8)
# of its column's largest value (measured up to 4.23, after 20 SOS steps).
# K5's leaves: k5_bf16_over.
BF16_SHARE = 0.1
BF16_FLIP_ROWS = 0.01
BF16_ENTRY = 2e-3
BF16_STORED_SHARE = 1e-2
BF16_STORED_STEPS = 8
BF16_FLOP_S = 989e12  # H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet, 700 W)


def tail_fault(got):
    """``got`` with its last hundredth of rows (one at least) each given the
    values of the row before it."""
    k = max(1, got.shape[0] // 100)
    bad = got.clone()
    bad[-k:] = got[-k - 1:-1]
    return bad


def bf16_columns(what: str, got, want, control=None) -> dict:
    """``got`` (a kernel's bf16 mode) against ``want`` (its bf16 plain
    version) within BF16_FLIP_ROWS and BF16_ENTRY (above), and the same
    bounds' readings on ``control`` (the fp32 kernel's output on the same
    inputs) and on tail_fault(got); raises if got is not within them or
    the tail fault is."""
    g, w = (t.detach().float().reshape(t.shape[0], -1) for t in (got, want))
    scale = w.abs().amax(0).clamp(min=1.0)

    def reading(x):
        e = (x - w).abs() / scale
        return float(e.max()) / BF16_ENTRY, float((e > TOL).any(1).float().mean()) / BF16_FLIP_ROWS

    over, flips = reading(g)
    fault = reading(tail_fault(g))
    finite = bool(torch.isfinite(g).all())
    if not (finite and over <= 1.0 and flips <= 1.0 and max(fault) > 1.0):
        raise SystemExit(f"{what} at bf16 disagrees with its bf16 plain version: its largest "
                         f"error at {over} of BF16_ENTRY, {flips} of BF16_FLIP_ROWS of its rows "
                         f"beyond TOL, finite={finite}; or the bounds do not refuse a tail "
                         f"fault ({fault})")
    out = {"max_abs_err": float((g - w).abs().max()), "err_over_bound": over,
           "flip_rows": flips * BF16_FLIP_ROWS, "flip_rows_over_bound": flips}
    if control is not None:
        out["control_over_bound"], out["control_flip_rows_over_bound"] = reading(
            control.detach().float().reshape(g.shape))
    out["tail_fault_over_bound"], out["tail_fault_flip_rows_over_bound"] = fault
    return out


def bf16_stored(what: str, got, want, share: float = BF16_STORED_SHARE) -> dict:
    """K4's bf16 sem_in against its bf16 plain version's within
    BF16_STORED_SHARE (or ``share``) and BF16_STORED_STEPS; raises. With the
    same bounds' readings on tail_fault(got)."""
    g, w = got.float(), want.float()
    step = (w.abs().amax(0) * 2.0**-8).clamp(min=1e-30)

    def reading(x):
        return (float(((x - w).abs().amax(0) / step).max()) / BF16_STORED_STEPS,
                float((x != w).float().mean()) / share)

    steps, differ = reading(g)
    fault = reading(tail_fault(g))
    if not (bool(torch.isfinite(g).all()) and steps <= 1.0 and differ <= 1.0):
        raise SystemExit(f"{what} at bf16 disagrees with its bf16 plain version: "
                         f"{differ * share} of its entries differ (bound "
                         f"{share}), by up to {steps * BF16_STORED_STEPS} bf16 steps "
                         f"of a column's largest (bound {BF16_STORED_STEPS})")
    return {"differing_share": differ * share, "max_steps": steps * BF16_STORED_STEPS,
            "tail_fault_steps_over_bound": fault[0], "tail_fault_differing_over_bound": fault[1]}


def k5_bf16_over(got, want, want32, allow):
    """K5's bf16 leaves against their bf16 plain version: the worst leaf's
    error, less its gate allowance, over the larger of BF16_SHARE of the
    leaf's bf16-vs-fp32 distance and GRAD_TOL of its max (db1 is a sum of
    the unrounded d_sem in both modes: its distance is 0); and the largest
    error."""
    over, err = 0.0, 0.0
    for k, ref in want.items():
        e = max_err(got[k], ref)
        err = max(err, e)
        bound = max(BF16_SHARE * max_err(ref, want32[k]), GRAD_TOL * float(ref.abs().max()))
        over = max(over, max(0.0, e - allow[k]) / max(bound, 1e-30))
    return over, err


# K3's and K6's bf16 gradient leaves. At the flagship width the bf16 sweep's
# leaves are chaotic in the last bit: a bf16 rounding that fp32 summation
# order flips (one bf16 step of an activation) moves the later layers'
# inputs by a fraction of a bf16 step, which flips further roundings and
# relu gates, so two fp32 orders of the same bf16 semantics part like two
# draws. The plain version with every bias scaled by 1 +- 2^-22 (below fp32
# summation noise) moves its leaves about as far as the kernel lies from
# it, and BF16_SHARE of the bf16-vs-fp32 distance, K5's bound, refused the
# kernel at the flagship width. So each leaf is held to BF16_WITNESS times
# that witness (bf16_witness: the larger of the two perturbations'
# distances) or GRAD_TOL of its max, whichever is larger (bf16_leaves;
# read 0.12 to 0.22 at [K3_bf16]'s and [K6_bf16]'s sizes, H100); and, where a
# call is one wave of chunks, the kernel's reverse sweep is held to
# BF16_PLANES_TOL of each leaf's max against the plain sweep
# (fused_render.bf16_sweep) run on the activations and cotangents the
# kernel's own storing forward left in the workspace (bf16_planes): the
# gates are then the same on both sides, and what still differs is the
# sweep's own bf16 roundings (dhv, d_feat, ds, each dpre) flipped by fp32
# order and carried on linearly. That moved a leaf by 3.0e-4 to 3.4e-4 of
# its max at 49152 and 65536 flagship points ([K6_bf16_planes]) and by
# 1.18e-3 at 4096 (K6, 256 x 16, tests/test_torch_cuda.py; H100);
# BF16_PLANES_TOL is 3.4x the largest. The fp32 kernel's leaves in the bf16
# kernel's place read 14 to 85 times GRAD_TOL there.
BF16_WITNESS = 10
BF16_PLANES_TOL = 4e-3


def nudged(module, sign: float = 1.0):
    """A copy of ``module`` with every bias scaled by 1 + sign * 2^-22: a
    bf16 plain version run on it moves by the rounding flips alone."""
    m = copy.deepcopy(module)
    with torch.no_grad():
        for lin in m.modules():
            if isinstance(lin, torch.nn.Linear):
                lin.bias.mul_(1.0 + sign * 2.0**-22)
    return m


def bf16_witness(run, field, want) -> dict:
    """Per leaf: the largest distance of ``run(f)`` (a bf16 plain version's
    grads on field ``f``) from ``want`` (its grads on ``field``) over ``f`` =
    ``nudged(field, +-1)``."""
    out = {k: 0.0 for k in want}
    for sign in (1.0, -1.0):
        f = nudged(field, sign)
        g = run(f)
        for k, ref in want.items():
            out[k] = max(out[k], max_err(g[k], ref))
        del f, g
    return out


def ulp_step(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """``x`` with each entry stepped one float32 ulp up or down (signs from
    ``gen``)."""
    up = torch.rand(x.shape, generator=gen, device=x.device) < 0.5
    return torch.where(up, torch.nextafter(x, torch.full_like(x, float("inf"))),
                       torch.nextafter(x, torch.full_like(x, -float("inf"))))


def z_ulp_draws(run, z, draws: int, seed: int = 2):
    """Yield ``run(zz)``, a bf16 plain version's outputs, over ``draws``
    draws of ``zz``: every sample depth of ``z`` one float32 ulp up or down
    (signs from a seed). A point's position, whose last bit the positional
    encoding multiplies by up to 2^9 pi, so that it flips the bf16 rounding
    of encoding entries: the rounding bf16_witness's bias nudges leave
    alone, and the one they cannot reach on a net of the JAX law, whose
    biases start at zero (tests/bf16_ulp_spread.py)."""
    gen = torch.Generator(device=z.device).manual_seed(seed)
    for _ in range(draws):
        yield run(ulp_step(z, gen))


def bf16_leaves(what: str, got, want, witness, controls=None) -> dict:
    """K3's and K6's bf16 gradient leaves against their bf16 plain version
    (``want``): the worst leaf's error over the larger of BF16_WITNESS times
    its ``witness`` (bf16_witness) and GRAD_TOL of its max; raises when it
    is over 1. The same reading on each of ``controls`` (name -> grads)
    is returned beside it."""
    def reading(g):
        over = 0.0
        for k, ref in want.items():
            bound = max(BF16_WITNESS * witness[k], GRAD_TOL * float(ref.abs().max()))
            over = max(over, max_err(g[k], ref) / max(bound, 1e-30))
        return over

    over = reading(got)
    finite = all(bool(torch.isfinite(t).all()) for t in got.values())
    if not (set(got) == set(want) and finite and over <= 1.0):
        raise SystemExit(f"{what} at bf16 disagrees with its bf16 plain version: worst leaf at "
                         f"{over} of its bound, finite={finite}")
    out = {"max_abs_err": max(max_err(got[k], ref) for k, ref in want.items()),
           "leaf_err_over_bound": over}
    for name, g in (controls or {}).items():
        out[f"{name}_over_bound"] = reading(g)
    return out


def workspace_planes(fr, launch, R: int, S: int, p: int, n: int) -> torch.Tensor:
    """Rows 0 .. n - 1 of workspace plane ``p`` of every point of a K3 or K6
    call (``launch``: fused_render._train_grads_launch's workspace, desc,
    grid, group) of one wave, ``[R * S, n]`` in point order: CTA b's slice
    holds chunk b, sub j its points 64 j .. 64 j + 63 ([row][kLd])."""
    work, d, grid, group = launch
    rpc = d.rays_per_chunk
    if group != 1 or -(-R // rpc) > grid:
        raise SystemExit(f"workspace_planes needs one wave of chunks: R={R}, S={S}, "
                         f"{-(-R // rpc)} chunks, grid {grid}, group {group}")
    out = []
    for b in range(-(-R // rpc)):
        nq = min(rpc, R - b * rpc) * S
        nsub, rows = -(-nq // 64), d.rows[p]
        at = b * d.ws_size + d.plane[p]
        t = work[at:at + nsub * rows * fr._KLD].view(nsub, rows, fr._KLD)[:, :n, :64]
        out.append(t.permute(0, 2, 1).reshape(nsub * 64, n)[:nq])
    return torch.cat(out)


def bf16_planes(fr, what: str, field, got, launch, odv, z, sem: bool, controls=None,
                mip: bool = False, points=None, inputs=None, stored_share=None) -> dict:
    """What the bf16 storing forward of a one-wave K3 or K6 call (``launch``:
    fused_render._train_grads_launch's workspace, on rays ``odv``, ``z``;
    with ``mip`` a K10b call, fused_render._mip_grads_launch's, on odvr and
    fenceposts; with ``points`` = (pts, dirs) a K8f or K8c call,
    fused_field._field_grads_launch's, odv and z unused) left in the
    workspace, and what its reverse sweep made of it: each stored
    activation plane (the point (K10b: the integrated) and view PE, every
    trunk layer's output, feat, hv and with ``sem`` (K6, K8c/K8f with the
    head) s_act) against the plain bf16 forward's
    (fused_render.bf16_train_forward; bf16_mip_forward;
    _bf16_mlp_forward on the points' PE) within bf16_stored's bounds, and
    the kernel's leaves ``got`` against fused_render.bf16_sweep run on the
    planes (the same gates) within BF16_PLANES_TOL of each leaf's max;
    raises. ``stored_share`` (plane name -> share): bf16_stored's share
    bound for that plane in place of BF16_STORED_SHARE. With the sweep's reading on each of ``controls`` (name -> a
    function of the sweep, returning grads, e.g. the sweep under a
    fault). ``inputs`` (K8c: its dpts and ddirs): held within
    BF16_PLANES_TOL of their max against the sweep's float32 PE cotangents
    run back through the PE's chain rule (autograd of the float32 PE at the
    points); raises."""
    from nerfsos_torch.models.mlp import round_bf16

    mlp = field.mlp
    R, S = (points[0].shape[0], 1) if points else (z.shape[0], z.shape[1] - int(mip))

    def plane(p, n):
        return workspace_planes(fr, launch, R, S, p, n)

    e = plane(fr._P_EMB, mlp.pts_linears[0].in_features)
    dv = plane(fr._P_DEMB, mlp.views_linears[0].in_features - mlp.feature_linear.out_features)
    if points:  # the point-list store keeps the PE in fp32 (K8c's chain rule reads it)
        e, dv = round_bf16(e), round_bf16(dv)
    acts = [plane(fr._P_ACT0 + i, lin.out_features) for i, lin in enumerate(mlp.pts_linears)]
    feat = plane(fr._P_FEAT, mlp.feature_linear.out_features)
    hv = plane(fr._P_HV, mlp.views_linears[0].out_features)
    s_act = plane(fr._P_ACT0 + mlp.depth, mlp.semantic_linear[0].out_features) if sem else None
    with torch.no_grad():
        if points:
            f = fr._bf16_mlp_forward(field, field.embed(points[0]), field.embed_views(points[1]))
        else:
            f = (fr.bf16_mip_forward if mip else fr.bf16_train_forward)(field, odv, z)
    stored = {"emb": (e, f["e"]), "view PE": (dv, f["dv"]), "feat": (feat, f["feat"]),
              "hv": (hv, f["hv"]), **{f"act{i}": (a, b) for i, (a, b) in
                                      enumerate(zip(acts, f["acts"]))}}
    if sem:
        stored["s_act"] = (s_act, f["s_act"])
    readings = {k: bf16_stored(f"{what} stored {k}", *v,
                               **({"share": stored_share[k]} if stored_share else {}))
                for k, v in stored.items()}
    args = (e, dv, acts, feat, hv, s_act, plane(fr._P_DRGB, 3), plane(fr._P_DSIG, 1),
            plane(fr._P_ACT0 + mlp.depth + 1, mlp.semantic_linear[2].out_features)
            if sem else None)

    def sweep(pe_cotangents=False):
        grads = {n: torch.zeros_like(p) for n, p in field.named_parameters()}
        with torch.no_grad():
            pe = fr.bf16_sweep(field, grads, *args, pe_cotangents=pe_cotangents)
        return (grads, pe) if pe_cotangents else grads

    want = sweep()

    def reading(g):
        return max(max_err(g[k], ref) / max(BF16_PLANES_TOL * float(ref.abs().max()), 1e-30)
                   for k, ref in want.items())

    over = reading(got)
    if not over <= 1.0:
        raise SystemExit(f"{what}: the bf16 reverse sweep disagrees with the plain sweep on its "
                         f"own forward's planes: worst leaf at {over} of BF16_PLANES_TOL")
    out = {"stored_steps_over_bound": max(r["max_steps"] for r in readings.values())
           / BF16_STORED_STEPS,
           "stored_differing_share": max(r["differing_share"] for r in readings.values()),
           "planes_leaf_err_over_tol": over}
    if inputs is not None:
        pe = sweep(True)[1]
        with torch.enable_grad():
            p, d = (t.detach().requires_grad_() for t in points)
            want_in = torch.autograd.grad((field.embed(p), field.embed_views(d)), (p, d), pe)
        over_in = max(max_err(a, b) / max(BF16_PLANES_TOL * float(b.abs().max()), 1e-30)
                      for a, b in zip(inputs, want_in))
        if not over_in <= 1.0:
            raise SystemExit(f"{what}: the bf16 sweep's input gradients disagree with the plain "
                             f"sweep's on its own forward's planes: {over_in} of BF16_PLANES_TOL")
        out["planes_input_grads_err_over_tol"] = over_in
    for name, fn in (controls or {}).items():
        out[f"planes_{name}_over_tol"] = reading(fn(sweep))
    return out


def bf16_bound(bytes_moved: float, flops: float) -> dict:
    return bound_ms(bytes_moved, flops, BF16_FLOP_S)


def kernel_vs_plain_bf16(fr) -> dict:
    """[K1_bf16], [K2_bf16], [K4_bf16], [K5_bf16]: each kernel's bf16 mode at
    the flagship width against its bf16 plain version (bf16_columns), two
    calls bitwise equal, then timed at the main paths' shapes beside the
    same call's fp32 kernel and the bf16 bound (bf16 products at
    BF16_FLOP_S, bytes at HBM_BYTES_S): K1/K2 at the eval's 32768 rays a
    launch, K4/K5 at the SOS step's 32768 rays (S = 192 and 64)."""
    bf = torch.bfloat16
    out = {}
    # K1: the eval's coarse pass
    field = seeded_field(0, net_depth=8, net_width=256, multires=10, multires_views=4)
    for R, seed in ((8192, 0), (EVAL_CHUNK, 3)):
        odv, z = ray_inputs(R, 64, seed=seed)
        od = odv[:, :6].contiguous()
        with torch.no_grad():
            got = fr.fused_coarse_weights(field, od, z, bf)
            again = fr.fused_coarse_weights(field, od, z, bf)
            close = bf16_columns(f"K1 ({R} rays)", got, fr.coarse_weights_plain(field, od, z, bf),
                                 fr.fused_coarse_weights(field, od, z))
        if not torch.equal(got, again):
            raise SystemExit("K1 at bf16: two calls differ")
    with torch.no_grad():
        ms = cuda_ms(lambda: fr.fused_coarse_weights(field, od, z, bf), reps=3)
        ms32 = cuda_ms(lambda: fr.fused_coarse_weights(field, od, z), reps=3)
        plain_ms = cuda_ms(lambda: fr.coarse_weights_plain(field, od, z, bf), reps=2, warmup=1)
    bound = bf16_bound(4 * R * (6 + 2 * 64) + 2 * n_params(field),
                       R * 64 * field_flops(field, "k1"))
    phase("K1_bf16", rays=R, samples=64, **close, deterministic=True, ms=ms, fp32_ms=ms32,
          plain_ms=plain_ms, **bound, ptxas=repr(K1_BF16_PTXAS))
    out["K1"] = {"max_abs_err": close["max_abs_err"], "ms": ms, "plain_ms": plain_ms, **bound,
                 "library_ms": None}

    # K2: the eval's fine pass
    field = seeded_field(1, net_depth=8, net_width=256, multires=10, multires_views=4,
                         use_semantics=True, sem_with_coord=True, sem_dim=2)
    odv, z = ray_inputs(8192, 192, seed=1)
    with torch.no_grad():
        got = fr.fused_render(field, odv, z, bf)
        again = fr.fused_render(field, odv, z, bf)
        want, control = fr.render_plain(field, odv, z, bf), fr.fused_render(field, odv, z)
    close = bf16_columns("K2 maps", got[0], want[0], control[0])
    close_w = bf16_columns("K2 weights", got[1], want[1], control[1])
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise SystemExit("K2 at bf16: two calls differ")
    R = EVAL_CHUNK
    odv, z = ray_inputs(R, 192, seed=2)
    with torch.no_grad():
        ms = cuda_ms(lambda: fr.fused_render(field, odv, z, bf), reps=3)
        ms32 = cuda_ms(lambda: fr.fused_render(field, odv, z), reps=3)
        plain_ms = cuda_ms(lambda: [fr.render_plain(field, odv[i:i + 8192], z[i:i + 8192], bf)
                                    for i in range(0, R, 8192)], reps=2, warmup=1)
    bound = bf16_bound(4 * R * (9 + 2 * 192 + 7) + 2 * n_params(field),
                       R * 192 * field_flops(field, "k2"))
    phase("K2_bf16", rays=8192, samples=192, maps=close, weights=close_w, deterministic=True,
          timed_rays=R, ms=ms, fp32_ms=ms32,
          plain_ms=plain_ms, **bound, ptxas=repr(K4_BF16_PTXAS))
    out["K2"] = {"max_abs_err": max(close["max_abs_err"], close_w["max_abs_err"]), "ms": ms,
                 "plain_ms": plain_ms, **bound, "library_ms": None}

    # K4 and K5: the frozen SOS step's forward and backward
    field = seeded_field(3, net_depth=8, net_width=256, multires=10, multires_views=4,
                         use_semantics=True, sem_with_coord=True, sem_dim=2)
    errs = {"K4": 0.0, "K5": 0.0}
    for S in (64, 192):
        R = 4096
        odv, z = ray_inputs(R, S, seed=4 + S)
        kw = dict(noise_std=1.0, seed=7654321, save_semin=True)
        with torch.no_grad():
            got = fr.train_render(field, odv, z, compute_dtype=bf, **kw)
            again = fr.train_render(field, odv, z, compute_dtype=bf, **kw)
            want = fr.train_render_plain(field, odv, z, compute_dtype=bf, **kw)
            control = fr.train_render(field, odv, z, **{**kw, "save_semin": False})
        if got[2].dtype != bf or not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise SystemExit(f"K4 at bf16 (S={S}): sem_in {got[2].dtype}, or two calls differ")
        c4, c4w = (bf16_columns(f"K4 {n} (S={S})", *(t[i] for t in (got, want, control)))
                   for i, n in enumerate(("maps", "weights")))
        c4s = bf16_stored(f"K4 sem_in (S={S})", got[2], want[2])
        del control
        errs["K4"] = max(errs["K4"], c4["max_abs_err"], c4w["max_abs_err"])
        _, w, sem_in = got
        dmaps = torch.from_numpy(np.random.default_rng(S).normal(size=(R, 7)).astype(np.float32))
        dmaps = dmaps.cuda()
        g = fr.frozen_sem_grads(field, sem_in, w, dmaps, bf)
        g2 = fr.frozen_sem_grads(field, sem_in, w, dmaps, bf)
        want5 = fr.frozen_sem_grads_plain(field, sem_in, w, dmaps, bf)
        want5_32, allow, near = plain_k5_with_allowance(field, sem_in.float(), w, dmaps)
        torch.cuda.synchronize()
        if not all(torch.equal(g[k], g2[k]) for k in g):
            raise SystemExit(f"K5 at bf16 (S={S}): two calls differ")
        over5, e5 = k5_bf16_over(g, want5, want5_32, allow)
        if not (all(torch.isfinite(t).all() for t in g.values()) and over5 <= 1.0):
            raise SystemExit(f"K5 at bf16 (S={S}) disagrees with its bf16 plain version: worst "
                             f"leaf at {over5} of its bound")
        errs["K5"] = max(errs["K5"], e5)
        phase("K4_bf16", rays=R, samples=S, maps=c4, weights=c4w, sem_in=c4s,
              deterministic=True)
        phase("K5_bf16", rays=R, samples=S, max_abs_err=e5, err_over_bound=over5,
              near_gate_points=near, deterministic=True)
    R = 32768
    for S in (192, 64):
        odv, z = ray_inputs(R, S, seed=40 + S)
        kw = dict(noise_std=1.0, seed=13579, save_semin=True)
        with torch.no_grad():
            ms = cuda_ms(lambda: fr.train_render(field, odv, z, compute_dtype=bf, **kw), reps=3)
            ms32 = cuda_ms(lambda: fr.train_render(field, odv, z, **kw), reps=3)
            plain_ms = cuda_ms(lambda: fr.train_render_plain(field, odv, z, compute_dtype=bf,
                                                             **kw), reps=1, warmup=1)
            _, w, sem_in = fr.train_render(field, odv, z, compute_dtype=bf, **kw)
        bound = k4_bf16_cost(field, R, S)
        phase("K4_bf16", rays=R, samples=S, ms=ms, fp32_ms=ms32, plain_ms=plain_ms, **bound,
              achieved_tflop_s=R * S * field_flops(field, "k2") / ms / 1e9,
              ptxas=repr(K4_BF16_PTXAS))
        if S == 192:
            out["K4"] = {"max_abs_err": errs["K4"], "ms": ms, "plain_ms": plain_ms, **bound,
                         "library_ms": None}
        dmaps = torch.from_numpy(np.random.default_rng(S).normal(size=(R, 7)).astype(np.float32))
        dmaps = dmaps.cuda()
        ms5 = cuda_ms(lambda: fr.frozen_sem_grads(field, sem_in, w, dmaps, bf), reps=3)
        plain5 = cuda_ms(lambda: fr.frozen_sem_grads_plain(field, sem_in, w, dmaps, bf), reps=1,
                         warmup=1)
        sem32 = sem_in.float()
        ms5_32 = cuda_ms(lambda: fr.frozen_sem_grads(field, sem32, w, dmaps), reps=3)
        del sem32
        bound5 = k5_bf16_cost(field, R, S)
        phase("K5_bf16", rays=R, samples=S, ms=ms5, fp32_ms=ms5_32, plain_ms=plain5, **bound5,
              ptxas=repr(K5_BF16_PTXAS))
        if S == 192:
            out["K5"] = {"max_abs_err": errs["K5"], "ms": ms5, "plain_ms": plain5, **bound5,
                         "library_ms": None}
        del sem_in, w
        torch.cuda.empty_cache()
    return out


def unrounded_gate_fault(fr, run):
    """``run()`` with the bf16 plain versions' relu-gated cotangents (dhv,
    ds, each trunk dpre) left unrounded: the fault of a reverse sweep whose
    gate epilogue skips its bf16 rounding."""
    saved = fr._bf16_gate
    fr._bf16_gate = lambda act, d: torch.where(act > 0, d, torch.zeros_like(d))
    try:
        return run()
    finally:
        fr._bf16_gate = saved


def k3_cost(field, R: int, S: int, maps_cols: int, bf16: bool = False) -> dict:
    """K3's bound: field_flops 'k3' a point at the 3xTF32 (``bf16``: bf16)
    rate; the rays, z, gt, maps and weights and the weights and gradients
    moved once (bytes)."""
    nbytes = 4 * (R * (9 + 3 + 2 * S + maps_cols) + 2 * n_params(field))
    flops = R * S * field_flops(field, "k3")
    return bf16_bound(nbytes, flops) if bf16 else bound_ms(nbytes, flops)


K3_BF16_SHAPES = ((1024, 64), (4096, 192), (1024, 192))  # (rays, samples); the last one's
K6_BF16_SHAPES = ((32768, 192), (32768, 64))             # numbers go to the kernels line
BF16_PLANES_SHAPES = ((1024, 64), (256, 192))  # one wave of chunks: the planes check


def kernel_vs_plain_k3_k6_bf16(fr) -> dict:
    """[K3_bf16] at 1024 rays (S = 64, 192) and 4096 rays (S = 192) and
    [K6_bf16] at the full SOS step's 32768 rays (S = 192, 64, the semantic
    head), each at the flagship width: the bf16 mode against its bf16 plain
    version (maps and weights: bf16_columns; every leaf: bf16_leaves, its
    bf16_witness beside), with the readings of two controls (the fp32
    kernel's output on the same inputs, and the bf16 plain version with its
    gated cotangents left unrounded, unrounded_gate_fault), two calls
    bitwise equal, timed beside the same call's fp32 kernel and the bf16
    bound (products at BF16_FLOP_S); then [K3_bf16_planes] and
    [K6_bf16_planes] at BF16_PLANES_SHAPES (bf16_planes, with the same two
    controls on the sweep)."""
    bf = torch.bfloat16
    out = {}
    k3_field = seeded_field(2, net_depth=8, net_width=256, multires=10, multires_views=4,
                            use_semantics=True, sem_dim=2)
    k6_field = seeded_field(3, net_depth=8, net_width=256, multires=10, multires_views=4,
                            use_semantics=True, sem_with_coord=True, sem_dim=2)

    def k3_inputs(R, S):
        odv, z = ray_inputs(R, S, seed=2 + S)
        gt = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (R, 3)).astype(np.float32))
        return odv, z, gt.cuda()

    def k6_inputs(R, S):
        odv, z = ray_inputs(R, S, seed=40 + S)
        rng = np.random.default_rng(S)
        dmaps = torch.from_numpy(rng.normal(size=(R, 7)).astype(np.float32)).cuda()
        return odv, z, dmaps, torch.from_numpy(rng.normal(size=(R, S)).astype(np.float32)).cuda()

    kw3 = dict(white_bkgd=False, noise_std=1.0, seed=1234567)
    kw6 = dict(noise_std=1.0, seed=13579)
    field = k3_field
    for R, S in K3_BF16_SHAPES:
        odv, z, gt = k3_inputs(R, S)

        def plain(f, dtype=bf):
            return fr.rgb_train_grads_plain(f, odv, z, gt, compute_dtype=dtype, **kw3)

        got = fr.fused_rgb_train_grads(field, odv, z, gt, compute_dtype=bf, **kw3)
        again = fr.fused_rgb_train_grads(field, odv, z, gt, compute_dtype=bf, **kw3)
        control = fr.fused_rgb_train_grads(field, odv, z, gt, **kw3)
        want = plain(field)
        witness = bf16_witness(lambda f: plain(f)[0], field, want[0])
        fault = unrounded_gate_fault(fr, lambda: plain(field)[0])
        torch.cuda.synchronize()
        if not (all(torch.equal(got[0][k], again[0][k]) for k in got[0])
                and torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])):
            raise SystemExit(f"K3 at bf16 (R={R} S={S}): two calls differ")
        close = {"maps": bf16_columns(f"K3 maps (R={R} S={S})", got[1], want[1], control[1]),
                 "weights": bf16_columns(f"K3 weights (R={R} S={S})", got[2], want[2],
                                         control[2]),
                 "leaves": bf16_leaves(f"K3 (R={R} S={S})", got[0], want[0], witness,
                                       {"control": control[0], "fault": fault})}
        del control, want, fault
        ms = cuda_ms(lambda: fr.fused_rgb_train_grads(field, odv, z, gt, compute_dtype=bf, **kw3))
        ms32 = cuda_ms(lambda: fr.fused_rgb_train_grads(field, odv, z, gt, **kw3))
        plain_ms = cuda_ms(lambda: plain(field), reps=3)
        bound = k3_cost(field, R, S, got[1].shape[1], bf16=True)
        phase("K3_bf16", rays=R, samples=S, **close, deterministic=True, ms=ms, fp32_ms=ms32,
              plain_ms=plain_ms, **bound, forward_ptxas=repr(FWD_PTXAS.get((1, 0, 1))),
              reverse_ptxas=repr(REV_PTXAS.get((0, 0, 1))))
        out["K3"] = {"max_abs_err": max(close["maps"]["max_abs_err"],
                                        close["weights"]["max_abs_err"],
                                        close["leaves"]["max_abs_err"]),
                     "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": None}
    field = k6_field
    for R, S in K6_BF16_SHAPES:
        args = (field, *k6_inputs(R, S))

        def plain(f, dtype=bf):
            return fr.train_render_grads_plain(f, *args[1:], compute_dtype=dtype, **kw6)

        got = fr.train_render_grads(*args, compute_dtype=bf, **kw6)
        again = fr.train_render_grads(*args, compute_dtype=bf, **kw6)
        control = fr.train_render_grads(*args, **kw6)
        want = plain(field)
        witness = bf16_witness(plain, field, want)
        fault = unrounded_gate_fault(fr, lambda: plain(field))
        torch.cuda.synchronize()
        if not all(torch.equal(got[k], again[k]) for k in got):
            raise SystemExit(f"K6 at bf16 (S={S}): two calls differ")
        close = bf16_leaves(f"K6 (S={S})", got, want, witness,
                            {"control": control, "fault": fault})
        del control, want, fault
        ms = cuda_ms(lambda: fr.train_render_grads(*args, compute_dtype=bf, **kw6), reps=3)
        ms32 = cuda_ms(lambda: fr.train_render_grads(*args, **kw6), reps=3)
        plain_ms = cuda_ms(lambda: plain(field), reps=1, warmup=1)
        bound = k6_cost(field, R, S, bf16=True)
        phase("K6_bf16", rays=R, samples=S, **close, deterministic=True, ms=ms, fp32_ms=ms32,
              plain_ms=plain_ms, **bound, forward_ptxas=repr(FWD_PTXAS.get((2, 0, 1))),
              reverse_ptxas=repr(REV_PTXAS.get((1, 0, 1))))
        if (R, S) == K6_BF16_SHAPES[0]:
            out["K6"] = {"max_abs_err": close["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
                         **bound, "library_ms": None}
        del args
        torch.cuda.empty_cache()
    for R, S in BF16_PLANES_SHAPES:
        for name, field in (("K3", k3_field), ("K6", k6_field)):
            if name == "K3":
                odv, z, gt = k3_inputs(R, S)
                flat, *_, launch = fr._train_grads_launch(field, odv, z, gt, None, bf16=True,
                                                         **kw3)
                got = fr.unpack_grads(field, flat)
                control = fr.fused_rgb_train_grads(field, odv, z, gt, **kw3)[0]
            else:
                odv, z, dmaps, dw = k6_inputs(R, S)
                flat, *_, launch = fr._train_grads_launch(field, odv, z, dmaps, dw, bf16=True,
                                                         white_bkgd=None, **kw6)
                got = fr.unpack_grads(field, flat, True)
                control = fr.train_render_grads(field, odv, z, dmaps, dw, **kw6)
            close = bf16_planes(fr, f"{name} (R={R} S={S})", field, got, launch, odv, z,
                                name == "K6",
                                {"control": lambda sweep: control,
                                 "fault": lambda sweep: unrounded_gate_fault(fr, sweep)})
            phase(f"{name}_bf16_planes", rays=R, samples=S, **close)
            del launch
    return out


BF16_COUNTS = {"K1": "fused_coarse_weights", "K2": "fused_render", "K4": "train_render",
               "K5": "frozen_sem_grads"}


def zero_counts(fr) -> None:
    for n in BF16_COUNTS.values():
        getattr(fr, n).launches = getattr(fr, n).launches_bf16 = 0


def read_counts(fr, what: str) -> dict:
    """The bf16 launches of K1, K2, K4 and K5 since zero_counts; raises if any
    of them launched in fp32 mode (a bf16 run must not)."""
    f32 = {k: getattr(fr, n).launches for k, n in BF16_COUNTS.items()}
    if any(f32.values()):
        raise SystemExit(f"the bf16 {what} launched fp32 kernels: {f32}")
    return {k: getattr(fr, n).launches_bf16 for k, n in BF16_COUNTS.items()}


def eval_bf16_path(fr) -> dict:
    """[eval_bf16]: the [eval] phase's view with ``--compute_dtype bfloat16``
    (K1 and K2 in their bf16 mode, counts from 0), its seconds beside the
    same view at fp32 run again just before it (the [eval] phase's run is
    the process's first eval), finite metrics, and the view's last K1 and
    K2 calls against their bf16 plain versions (bf16_columns) and a second
    call, bitwise."""
    from nerfsos_torch import run_nerf

    bf = torch.bfloat16
    flags = ("--eval", "--fast_mode", "--ret_cluster", "--clus_no_sfm", "--use_masks")
    os.makedirs(os.path.join(WORK, "logs", "smoke_fp32"), exist_ok=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_nerf.main(eval_args(*flags, "--expname", "smoke_fp32"))
    torch.cuda.synchronize()
    fp32_seconds = time.perf_counter() - t0
    os.makedirs(os.path.join(WORK, "logs", "smoke_bf16"), exist_ok=True)
    args = eval_args(*flags, "--compute_dtype", "bfloat16", "--expname", "smoke_bf16")
    zero_counts(fr)
    cap = Capture(fr, ["fused_coarse_weights", "fused_render"])
    cap.on = True
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_nerf.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        cap.close()
    launches = read_counts(fr, "--eval")
    with open(os.path.join(WORK, "logs", "smoke_bf16", "eval", "log.json")) as f:
        log = json.load(f)
    if launches["K1"] < 1 or launches["K2"] < 1 or not all(
            isinstance(log.get(k), float) and math.isfinite(log[k])
            for k in ("total_mse", "total_psnr", "total_ssim")):
        raise SystemExit(f"the bf16 --eval run: launches {launches}, log {log}")
    (a1, _, w1), (a2, _, m2) = cap.calls["fused_coarse_weights"][-1], cap.calls["fused_render"][-1]
    with torch.no_grad():
        c1 = bf16_columns("K1 on the bf16 eval view", w1, fr.coarse_weights_plain(*a1),
                          fr.fused_coarse_weights(*a1[:3]))
        c2 = bf16_columns("K2 on the bf16 eval view", m2[0], fr.render_plain(*a2)[0],
                          fr.fused_render(*a2[:3])[0])
        same = (torch.equal(w1, fr.fused_coarse_weights(*a1))
                and all(torch.equal(x, y) for x, y in zip(m2, fr.fused_render(*a2))))
    if a1[3] != bf or a2[3] != bf or not same:
        raise SystemExit("the bf16 eval view's K1/K2: not bf16, or two calls differ")
    phase("eval_bf16", view=f"{H_VIEW}x{W_VIEW}", seconds=seconds, fp32_seconds=fp32_seconds,
          launches=launches,
          psnr=log["total_psnr"], k1=c1, k2=c2, deterministic=True)
    return launches


def sos_bf16_path(fr, fc) -> dict:
    """[sos_bf16]: SOS_STEPS frozen finetune steps with ``--compute_dtype
    bfloat16`` from the [train] run's fp32 last.ckpt, a seeded bf16 DINO: K4
    and K5 in their bf16 mode (counts from 0, no fp32 launch), every loss
    term finite, the trunk bitwise unchanged, the head moved, the final eval
    through K1/K2's bf16 mode, the last step's K4 and K5 calls against their
    bf16 plain versions and a second call, bitwise."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.engines import checkpoint as ckpt_lib
    from nerfsos_torch.engines import sos

    bf = torch.bfloat16
    ckpt = os.path.join(WORK, "logs", "smoke_train", "checkpoints", "last.ckpt")
    start_state, start_step, _ = ckpt_lib.load_checkpoint(ckpt)
    last = start_step + SOS_STEPS - 1
    args = sos_args(ckpt, start_step + SOS_STEPS, expname="smoke_sos_bf16",
                    extra=["--compute_dtype", "bfloat16"])
    zero_counts(fr)
    rec = {"metrics": [], "objects": None, "dino": None, "start": None}
    orig, orig_dino = sos.make_sos_train_step, run_nerf.build_dino
    cap = Capture(fr, ["train_render", "frozen_sem_grads"])

    def recording_make_step(net, *a, **kw):
        rec["objects"] = (net, a, kw)
        rec["start"] = {n: p.detach().cpu().clone() for n, p in net.state_dict().items()}
        step = orig(net, *a, **kw)

        def recorded(batch, global_step):
            cap.on = global_step == last
            try:
                m = step(batch, global_step)
            finally:
                cap.on = False
            rec["metrics"].append({k: float(v) for k, v in m.items()})
            return m

        return recorded

    sos.make_sos_train_step = recording_make_step
    run_nerf.build_dino = lambda *a: rec.__setitem__("dino", orig_dino(*a)) or rec["dino"]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_nerf.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        sos.make_sos_train_step, run_nerf.build_dino = orig, orig_dino
        cap.close()
    launches = read_counts(fr, "frozen finetune")
    rerenders = sum(1 for s in range(start_step, last + 1) if (s + 1) % args.i_print == 0
                    or s + 1 == 1)
    want = {"K4": 2 * SOS_STEPS + 2 * rerenders, "K5": 2 * SOS_STEPS}
    if (len(rec["metrics"]) != SOS_STEPS or any(launches[k] != n for k, n in want.items())
            or min(launches["K1"], launches["K2"]) < 1 or rec["dino"].vit.dtype != bf):
        raise SystemExit(f"the bf16 SOS run: {len(rec['metrics'])} steps, launches {launches} "
                         f"(expected {want} and K1/K2 in the final eval), DINO "
                         f"{rec['dino'].vit.dtype}")
    for m in rec["metrics"]:
        if not all(math.isfinite(v) for v in m.values()) or 0.0 in (m["corr1"], m["geo_corr1"]):
            raise SystemExit(f"a bf16 SOS loss term is not finite or is zero: {m}")
    end_state, _, _ = ckpt_lib.load_checkpoint(os.path.join(WORK, "logs", "smoke_sos_bf16",
                                                            "checkpoints", "last.ckpt"))
    for k, v in end_state.items():
        if "semantic_linear" in k:
            if torch.equal(v, rec["start"][k]):
                raise SystemExit(f"the semantic head did not move at bf16: {k}")
        elif not torch.equal(v, start_state[k]):
            raise SystemExit(f"a frozen trunk leaf changed at bf16: {k}")
    checks = {}
    for name, (a, kw, got) in zip(("coarse", "fine"), cap.calls["train_render"]):
        with torch.no_grad():
            refs = (fr.train_render_plain(*a, **kw),
                    fr.train_render(*a, **{**kw, "compute_dtype": torch.float32,
                                           "save_semin": False}))
            checks[f"K4 {name}"] = {
                n: bf16_columns(f"K4 {n} at step {last} ({name})", got[i],
                                *(r[i] for r in refs))
                for i, n in enumerate(("maps", "weights"))}
            checks[f"K4 {name}"]["sem_in"] = bf16_stored(f"K4 sem_in at step {last} ({name})",
                                                         got[2], refs[0][2])
            del refs
            again = fr.train_render(*a, **kw)
        if kw["compute_dtype"] != bf or not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise SystemExit(f"K4 at step {last} ({name}): not bf16, or two calls differ")
    for a, kw, got in cap.calls["frozen_sem_grads"]:
        field, sem_in, w, dmaps, dtype = a
        name = "coarse" if w.shape[1] == args.N_samples else "fine"
        want5 = fr.frozen_sem_grads_plain(*a)
        want32, allow, _ = plain_k5_with_allowance(field, sem_in.float(), w, dmaps)
        over, _ = k5_bf16_over(got, want5, want32, allow)
        again = fr.frozen_sem_grads(*a, **kw)
        if dtype != bf or over > 1.0 or not all(torch.equal(got[k], again[k]) for k in got):
            raise SystemExit(f"K5 at step {last} ({name}): {over} of its bound, or not bf16, or "
                             "two calls differ")
        checks[f"K5 {name}"] = over
    phase("sos_bf16", steps=len(rec["metrics"]), seconds_incl_load_and_eval=seconds,
          launches=launches, loss_first=rec["metrics"][0]["loss"],
          corr1_last=rec["metrics"][-1]["corr1"], trunk_bitwise_equal=True, head_moved=True,
          last_step=checks)
    return {"launches": launches, "rec": rec, "args": args}


def sos_bf16_step_timings(f32_run, bf16_run, name: str = "sos_bf16_step", reps: int = 2) -> None:
    """[sos_bf16_step] (``name``): the frozen 32768-ray SOS step at bf16
    beside the same call's fp32 frozen step ([sos_full_bf16_step]: the full
    step, both from their runs), in turns (fp32, bf16, bf16, fp32), each on
    the same batch, ``reps`` steps a turn, ms from CUDA events and peak
    memory."""
    from nerfsos_torch.data.datasets import PatchDataset
    from nerfsos_torch.engines import sos

    args = bf16_run["args"]
    ds = PatchDataset(args.data_path, patch_size=args.patch_size,
                      patch_stride=args.patch_stride, ret_k=True)
    b = ds.sample_batch(np.random.default_rng(0), args.batch_size)
    device = next(bf16_run["rec"]["objects"][0].parameters()).device
    batch = {k: torch.as_tensor(b[k], device=device) for k in ("rays", "target")}
    steps = {}
    for dtype, run in (("fp32", f32_run), ("bf16", bf16_run)):
        net, a, kw = run["rec"]["objects"]
        steps[dtype] = sos.make_sos_train_step(net, *a, **kw)
    for dtype in ("fp32", "bf16", "bf16", "fp32"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: steps[dtype](batch, 0), reps=reps, warmup=1)
        phase(name, compute_dtype=dtype, rays=batch["target"].shape[0], steps=reps, ms=ms,
              peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def k7_single_pair_inputs(B: int, N: int, S: int, seed: int):
    """Points of B patches of N pixels (back-projected depths in [2, 6]
    along unit rays from one origin) and four channel-normalised codes
    ``[B, N, S]``."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(B, N, 3))
    d /= np.linalg.norm(d, axis=2, keepdims=True)
    pts = [d * rng.uniform(2.0, 6.0, size=(B, N, 1)) for _ in range(2)]
    codes = []
    for _ in range(4):
        c = rng.normal(size=(B, N, S))
        codes.append(c / np.linalg.norm(c, axis=2, keepdims=True))
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda() for a in (*pts, *codes)]


def kernel_vs_plain_k7s(fc) -> dict:
    """[K7s]: the single-head (K7b/K7c) and two-head (K7d/K7e) forms with
    one half, on seeded points and codes at the SOS step's size (8 patches
    of 64 x 64 pixels, 2 channels, max_depth 15, the geometry loss's neg
    shift 0.5): row stats, the means and the code gradients vs their plain
    versions to K7_TOL, two calls bitwise equal, and their times."""
    B, N, S, maxd, shift = 8, 4096, 2, 15.0, 0.5
    f1, f2, *codes = k7_single_pair_inputs(B, N, S, 21)
    rm, gm = fc.geo_row_stats(f1, f2, maxd, 1)
    out = {}
    for heads, (k_m, k_g), (means, grads), (means_p, grads_p) in (
            (1, ("K7b", "K7c"), (fc.geo_single_means, fc.geo_single_grads),
             (fc.geo_single_means_plain, fc.geo_single_grads_plain)),
            (2, ("K7d", "K7e"), (fc.geo_pair_means, fc.geo_pair_grads),
             (fc.geo_pair_means_plain, fc.geo_pair_grads_plain))):
        cs = codes[:2 * heads]
        a_m = (f1, f2, *cs, rm, gm, shift, maxd)
        coeff = torch.tensor([0.7, -1.2][:heads], device=f1.device) / (B * N * N)
        a_g = (f1, f2, *cs, rm, gm, coeff, shift, maxd)
        m, m2 = means(*a_m), means(*a_m)
        g, g2 = grads(*a_g), grads(*a_g)
        torch.cuda.synchronize()
        with torch.no_grad():
            m_p, g_p = means_p(*a_m), grads_p(*a_g)
        err_m = max_err(m, m_p) / max(float(m_p.abs().max()), 1e-30)
        err_g = max(max_err(x, r) / max(float(r.abs().max()), 1e-30) for x, r in zip(g, g_p))
        finite = all(torch.isfinite(t).all() for t in (m, *g))
        if not (finite and max(err_m, err_g) <= K7_TOL):
            raise SystemExit(f"K7 with {heads} head(s) disagrees with its plain version: means "
                             f"{err_m}, gradients {err_g} (tol {K7_TOL}), finite={finite}")
        if not (torch.equal(m, m2) and all(torch.equal(x, y) for x, y in zip(g, g2))):
            raise SystemExit(f"K7 with {heads} head(s) differs between two calls")
        with torch.no_grad():
            t = {k_m: (cuda_ms(lambda: means(*a_m)), cuda_ms(lambda: means_p(*a_m), reps=3)),
                 k_g: (cuda_ms(lambda: grads(*a_g)), cuda_ms(lambda: grads_p(*a_g), reps=3))}
        c = k7_costs(f1, cs[0], heads)
        costs = {k_m: c["loss"], k_g: c["grads"]}
        errs = {k_m: max_err(m, m_p), k_g: max(max_err(x, r) for x, r in zip(g, g_p))}
        phase("K7s", heads=heads, rows=B, pixels=N, channels=S, values=[float(x) for x in m],
              rel_err_means=err_m, rel_err_grads=err_g, tol=K7_TOL, deterministic=True,
              **{f"{k}_ms": v[0] for k, v in t.items()},
              **{f"{k}_plain_ms": v[1] for k, v in t.items()},
              **{f"{k}_bound_ms": costs[k]["bound_ms"] for k in costs})
        for k, kernel in ((k_m, "loss_tile_kernel"), (k_g, "grad_tile_kernel")):
            phase("K7s_design", kernel=k, **k7_design(kernel, heads, B, N, S))
        out.update({k: {"max_abs_err": errs[k], "ms": t[k][0], "plain_ms": t[k][1], **costs[k],
                        "library_ms": None} for k in t})
    return out


SOS_STEPS = 10


def sos_args(ckpt: str, max_steps: int, expname: str = "smoke_sos", drop=(), extra=()):
    """The flagship finetune flags (scripts/train_flower_node0.sh) with
    configs/flower_full.txt on the smoke scene's 384x512 train views; the
    flags in ``drop`` left out and those in ``extra`` added."""
    from nerfsos_torch import run_nerf

    argv = ["--config", os.path.join(ROOT, "configs", "flower_full.txt"),
            "--expname", expname, "--basedir", os.path.join(WORK, "logs"),
            "--data_path", os.path.join(WORK, "sos_data"), "--max_steps", str(max_steps),
            "--i_print", "10", "--i_weights", "10", "--i_testset", "1000000",
            "--patch_tune", "--batch_size", "8", "--patch_size", "64", "--patch_stride", "6",
            "--load_nostrict", "--sem_w", "0", "--use_dino", "--contrast_w", "0",
            "--use_correlation", "--use_geoCorr", "--fix_backbone", "--ret_cluster",
            "--clus_no_sfm", "--sem_with_coord", "--sem_dim", "2", "--use_sim_matrix",
            "--correlation_w", "1", "--Gcorrelation_w", "0.01",
            "--app_corr_params", "0.18", "1", "0.46", "1",
            "--geo_corr_params", "0.5", "1", "3", "1", "--fast_mode", "--ckpt_path", ckpt]
    argv = [a for a in argv if a not in drop] + list(extra)
    args, _ = run_nerf.create_arg_parser().parse_known_args(argv)
    return args


def sos_path(fr, fc) -> dict:
    """[sos]: ``run_nerf.main`` with the flagship finetune flags from the
    [train] run's last.ckpt (no --sem_with_coord there, so --load_nostrict
    keeps a fresh sem_0), SOS_STEPS steps of 8 patches of 64x64. Every kernel
    count is set to 0 just before and read just after; the last step's K4,
    K5 and K7 calls are kept and held against their plain versions."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.data.synthetic import write_sphere_scene
    from nerfsos_torch.engines import checkpoint as ckpt_lib
    from nerfsos_torch.engines import sos

    data = os.path.join(WORK, "sos_data")
    write_sphere_scene(data, 192, 256, n_views=1, split="test")
    write_sphere_scene(data, 384, 512, n_views=8, split="train")
    ckpt = os.path.join(WORK, "logs", "smoke_train", "checkpoints", "last.ckpt")
    start_state, start_step, _ = ckpt_lib.load_checkpoint(ckpt)
    last = start_step + SOS_STEPS - 1
    args = sos_args(ckpt, start_step + SOS_STEPS)

    for w in (fr.fused_coarse_weights, fr.fused_render, fr.train_render, fr.frozen_sem_grads,
              fc.geo_row_stats, fc.geo_quad_means, fc.geo_quad_grads):
        w.launches = 0
    rec = {"metrics": [], "objects": None, "start": None}
    orig = sos.make_sos_train_step
    k4k5 = Capture(fr, ["train_render", "frozen_sem_grads"])
    k7 = Capture(fc, ["geo_row_stats", "geo_quad_means", "geo_quad_grads"])

    def recording_make_step(net, *a, **kw):
        rec["objects"] = (net, a, kw)
        rec["start"] = {n: p.detach().clone() for n, p in net.state_dict().items()}
        step = orig(net, *a, **kw)

        def recorded(batch, global_step):
            k4k5.on = k7.on = global_step == last
            try:
                m = step(batch, global_step)
            finally:
                k4k5.on = k7.on = False
            rec["metrics"].append((global_step, m))
            return m

        return recorded

    sos.make_sos_train_step = recording_make_step
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_nerf.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        sos.make_sos_train_step = orig
        k4k5.close()
        k7.close()
    launches = {"K1": fr.fused_coarse_weights.launches, "K2": fr.fused_render.launches,
                "K4": fr.train_render.launches, "K5": fr.frozen_sem_grads.launches,
                "K7a": fc.geo_row_stats.launches, "K7f": fc.geo_quad_means.launches,
                "K7g": fc.geo_quad_grads.launches}
    steps = [s for s, _ in rec["metrics"]]
    metrics = [{k: float(v) for k, v in m.items()} for _, m in rec["metrics"]]
    rerenders = sum(1 for s in steps if (s + 1) % args.i_print == 0 or s + 1 == 1)
    phase("sos", steps=len(steps), first_step=steps[0] if steps else None,
          patches=f"{args.batch_size}x{args.patch_size}x{args.patch_size}", views="8x384x512", seconds_incl_load_and_eval=seconds, launches=launches,
          loss_first=metrics[0]["loss"] if metrics else None,
          corr1_last=metrics[-1]["corr1"] if metrics else None,
          geo_corr1_last=metrics[-1]["geo_corr1"] if metrics else None)
    if steps != list(range(start_step, start_step + SOS_STEPS)):
        raise SystemExit(f"the SOS run ran steps {steps}")
    want = {"K4": 2 * SOS_STEPS + 2 * rerenders, "K5": 2 * SOS_STEPS, "K7a": SOS_STEPS,
            "K7f": SOS_STEPS, "K7g": SOS_STEPS}
    if any(launches[k] != n for k, n in want.items()) or min(launches["K1"],
                                                               launches["K2"]) < 1:
        raise SystemExit(f"the SOS run did not go through the kernels as expected: {launches}, "
                         f"expected {want} and K1/K2 in the final eval")
    for m in metrics:
        if not all(math.isfinite(v) for v in m.values()):
            raise SystemExit(f"an SOS loss term is not finite: {m}")
        if 0.0 in (m["corr0"], m["corr1"], m["geo_corr0"], m["geo_corr1"]):
            raise SystemExit(f"an SOS correlation term is zero: {m}")
    run_dir = os.path.join(WORK, "logs", "smoke_sos")
    check_checkpoints(run_dir, [f"{start_step + k:08d}.ckpt" for k in range(10, SOS_STEPS + 1, 10)]
                      + ["latest.ckpt", "last.ckpt"])
    end_state, end_step, _ = ckpt_lib.load_checkpoint(os.path.join(run_dir, "checkpoints",
                                                                   "last.ckpt"))
    for k, v in end_state.items():
        if "semantic_linear" in k:
            if torch.equal(v, rec["start"][k].cpu()):
                raise SystemExit(f"the semantic head did not move: {k}")
        elif not torch.equal(v, start_state[k]):
            raise SystemExit(f"a frozen trunk leaf changed: {k}")
    log = check_final_eval(run_dir)
    phase("sos_eval", end_step=end_step, psnr=log["total_psnr"], ssim=log["total_ssim"],
          clus_ari=log["total_clus_ari"], trunk_bitwise_equal=True, head_moved=True)

    # the last step's kernel calls against their plain versions on their own inputs
    errs = {}
    calls4, calls5 = k4k5.calls["train_render"], k4k5.calls["frozen_sem_grads"]
    if len(calls4) != 2 or len(calls5) != 2:
        raise SystemExit(f"captured {len(calls4)} K4 and {len(calls5)} K5 calls of step {last}")
    for name, (a, kw, got) in zip(("coarse", "fine"), calls4):
        with torch.no_grad():
            want4 = fr.train_render_plain(*a, **kw)
        e = k4_errors(got, want4)
        phase("sos_k4_columns", field=name, max_abs_err=[
            float(x) for x in (got[0].detach() - want4[0]).abs().amax(0)])
        if max(e) > TOL:
            raise SystemExit(f"K4 at step {last} ({name}): maps (scaled), weights, sem_in "
                             f"errors {e} > {TOL}")
        with torch.no_grad():
            again = fr.train_render(*a, **kw)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise SystemExit(f"K4 at step {last} ({name}): two calls differ")
        errs[f"K4 {name}"] = max(e)
        del want4
    for a, kw, got in calls5:
        field, sem_in, w, dmaps = a[:4]
        name = "coarse" if w.shape[1] == args.N_samples else "fine"
        close = check_k5(f"step {last}, {name}", got, *plain_k5_with_allowance(field, sem_in, w,
                                                                                dmaps))
        again = fr.frozen_sem_grads(*a, **kw)
        if not all(torch.equal(got[k], again[k]) for k in got):
            raise SystemExit(f"K5 at step {last} ({name}): two calls differ")
        errs[f"K5 {name}"] = close["grad_rel_err"]
        phase("sos_k5", step=last, field=name, rays=w.shape[0], samples=w.shape[1], **close)
    phase("sos_k4", step=last, max_err_coarse=errs["K4 coarse"], max_err_fine=errs["K4 fine"],
          tol=TOL)
    return {"launches": launches, "rec": rec, "k7_calls": k7.calls, "k4_calls": calls4,
            "k5_calls": calls5, "args": args}


def kernel_vs_plain_k7(fc, calls) -> dict:
    """[K7] on the last SOS step's own inputs (16 x 4096 pixels, S = 2):
    row stats, the four means and the four code gradients against their
    plain versions to K7_TOL, two calls bitwise equal, and their times."""
    (a_rs, _, (rm, gm)), = calls["geo_row_stats"]
    (a_m, _, out), = calls["geo_quad_means"]
    (a_g, _, grads), = calls["geo_quad_grads"]
    f1 = a_rs[0]
    with torch.no_grad():
        rm_p, gm_p = fc.geo_row_stats_plain(*a_rs)
        out_p = fc.geo_quad_means_plain(*a_m)
        g_p = fc.geo_quad_grads_plain(*a_g)
    pairs = {"rowmean": (rm, rm_p), "gmean": (gm, gm_p), "means": (out, out_p),
             **dict(zip(("dc1a", "dc2a", "dc1b", "dc2b"), zip(grads, g_p)))}
    abs_err = {k: max_err(x, ref) for k, (x, ref) in pairs.items()}
    err = {k: abs_err[k] / max(float(ref.abs().max()), 1e-30) for k, (_, ref) in pairs.items()}
    finite = all(torch.isfinite(t).all() for t in (rm, gm, out, *grads))
    if not (finite and max(err.values()) <= K7_TOL):
        raise SystemExit(f"K7 disagrees with its plain version: relative errors {err} "
                         f"(tol {K7_TOL}), finite={finite}")
    rm2, gm2 = fc.geo_row_stats(*a_rs)
    out2 = fc.geo_quad_means(*a_m)
    grads2 = fc.geo_quad_grads(*a_g)
    torch.cuda.synchronize()
    if not (torch.equal(rm, rm2) and torch.equal(gm, gm2) and torch.equal(out, out2)
            and all(torch.equal(x, y) for x, y in zip(grads, grads2))):
        raise SystemExit("K7's row stats, means or gradients differ between two calls")
    with torch.no_grad():
        t = {"K7a": (cuda_ms(lambda: fc.geo_row_stats(*a_rs)),
                     cuda_ms(lambda: fc.geo_row_stats_plain(*a_rs), reps=3)),
             "K7f": (cuda_ms(lambda: fc.geo_quad_means(*a_m)),
                     cuda_ms(lambda: fc.geo_quad_means_plain(*a_m), reps=3)),
             "K7g": (cuda_ms(lambda: fc.geo_quad_grads(*a_g)),
                     cuda_ms(lambda: fc.geo_quad_grads_plain(*a_g), reps=3))}
    c = k7_costs(f1, a_m[2])
    costs = {"K7a": c["K7a"], "K7f": c["loss"], "K7g": c["grads"]}
    B2, N, S = a_m[2].shape
    mismatches = fc.rcp_mismatches(f1.device)
    if mismatches:
        raise SystemExit(f"K7's reciprocal fast path differs from 1.f / x on {mismatches} "
                         f"floats of [0.05, 2^95]")
    phase("K7", rows=B2, pixels=N, channels=S, values=[float(x) for x in out],
          rcp_fast_path_mismatches=mismatches,
          **{f"rel_err_{k}": v for k, v in err.items()}, tol=K7_TOL, deterministic=True,
          **{f"{k}_ms": v[0] for k, v in t.items()}, **{f"{k}_plain_ms": v[1] for k, v in t.items()},
          **{f"{k}_bound_ms": costs[k]["bound_ms"] for k in costs})
    for k, kernel in (("K7a", "rowsum_tile_kernel"), ("K7f", "loss_tile_kernel"),
                      ("K7g", "grad_tile_kernel")):
        phase("K7_design", kernel=k, **k7_design(kernel, 2, B2, N, S))
    kerr = {"K7a": max(abs_err["rowmean"], abs_err["gmean"]), "K7f": abs_err["means"],
            "K7g": max(abs_err[k] for k in ("dc1a", "dc2a", "dc1b", "dc2b"))}
    return {k: {"max_abs_err": kerr[k], "ms": t[k][0], "plain_ms": t[k][1], **costs[k],
                "library_ms": None} for k in t}


MODE_STEPS = 5


def sos_mode_path(fr, fc, mode: str, bf16: bool = False) -> dict:
    """[sos_full] (the flagship finetune flags without --fix_backbone: the
    whole network trains, the train render's backward is K6) or
    [sos_randneg] (with --rand_neg: each head's geometry loss is two
    single-head means, K7a + K7b forward and K7c backward), MODE_STEPS steps
    from the [train] run's last.ckpt. Every kernel count is set to 0 just
    before and read just after; the last step's K6 (or K7b/K7c) calls are
    kept and held against their plain versions. ``bf16`` ([sos_full_bf16],
    the full mode at ``--compute_dtype bfloat16``): the kernels of fused_render
    count their bf16 launches (their fp32 counts must stay 0), and the last
    step's K6 calls are held against their bf16 plain versions
    (bf16_leaves) and a second call, bitwise."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.engines import checkpoint as ckpt_lib
    from nerfsos_torch.engines import sos

    ckpt = os.path.join(WORK, "logs", "smoke_train", "checkpoints", "last.ckpt")
    start_state, start_step, _ = ckpt_lib.load_checkpoint(ckpt)
    last, end = start_step + MODE_STEPS - 1, start_step + MODE_STEPS
    full = mode == "full"
    name = ("sos_full" if full else "sos_randneg") + ("_bf16" if bf16 else "")
    args = (sos_args(ckpt, end, "smoke_" + name, drop=("--fix_backbone",),
                     extra=("--compute_dtype", "bfloat16") if bf16 else ()) if full
            else sos_args(ckpt, end, "smoke_" + name, extra=("--rand_neg",)))
    counted = {"K1": (fr, "fused_coarse_weights"), "K2": (fr, "fused_render"),
               "K4": (fr, "train_render"), "K5": (fr, "frozen_sem_grads"),
               "K6": (fr, "train_render_grads"), "K7a": (fc, "geo_row_stats"),
               "K7b": (fc, "geo_single_means"), "K7c": (fc, "geo_single_grads"),
               "K7d": (fc, "geo_pair_means"), "K7e": (fc, "geo_pair_grads"),
               "K7f": (fc, "geo_quad_means"), "K7g": (fc, "geo_quad_grads")}
    for mod, fn in counted.values():
        getattr(mod, fn).launches = 0
        if hasattr(getattr(mod, fn), "launches_bf16"):
            getattr(mod, fn).launches_bf16 = 0
    rec = {"metrics": [], "objects": None, "start": None}
    orig = sos.make_sos_train_step
    cap = (Capture(fr, ["train_render_grads"]) if full
           else Capture(fc, ["geo_single_means", "geo_single_grads"]))

    def recording_make_step(net, *a, **kw):
        rec["objects"] = (net, a, kw)
        rec["start"] = {n: p.detach().clone() for n, p in net.state_dict().items()}
        step = orig(net, *a, **kw)

        def recorded(batch, global_step):
            cap.on = global_step == last
            try:
                m = step(batch, global_step)
            finally:
                cap.on = False
            rec["metrics"].append((global_step, m))
            return m

        return recorded

    sos.make_sos_train_step = recording_make_step
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_nerf.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        sos.make_sos_train_step = orig
        cap.close()
    launches = {k: getattr(mod, fn).launches for k, (mod, fn) in counted.items()}
    if bf16:
        fp32_launches = {k: n for k, n in launches.items() if counted[k][0] is fr and n}
        if fp32_launches:
            raise SystemExit(f"the bf16 {name} run launched fp32 kernels: {fp32_launches}")
        launches.update({k: getattr(fr, fn).launches_bf16 for k, (mod, fn) in counted.items()
                         if mod is fr})
    steps = [s for s, _ in rec["metrics"]]
    metrics = [{k: float(v) for k, v in m.items()} for _, m in rec["metrics"]]
    n = len(steps)
    rerenders = sum(1 for s in steps if (s + 1) % args.i_print == 0 or s + 1 == 1)
    phase(name, steps=n, first_step=steps[0] if steps else None,
          patches=f"{args.batch_size}x{args.patch_size}x{args.patch_size}", views="8x384x512",
          seconds_incl_load_and_eval=seconds, launches=launches,
          loss_first=metrics[0]["loss"] if metrics else None,
          loss_last=metrics[-1]["loss"] if metrics else None)
    if steps != list(range(start_step, end)):
        raise SystemExit(f"the {name} run ran steps {steps}")
    want = dict.fromkeys(counted, 0)
    want.update(K4=2 * n + 2 * rerenders)
    if full:
        want.update(K6=2 * n, K7a=n, K7f=n, K7g=n)
    else:
        want.update(K5=2 * n, K7a=4 * n, K7b=4 * n, K7c=4 * n)
    del want["K1"], want["K2"]
    if any(launches[k] != c for k, c in want.items()) or min(launches["K1"], launches["K2"]) < 1:
        raise SystemExit(f"the {name} run did not go through the kernels as expected: "
                         f"{launches}, expected {want} and K1/K2 in the final eval")
    for m in metrics:
        if not all(math.isfinite(v) for v in m.values()):
            raise SystemExit(f"a {name} loss term is not finite: {m}")
        if 0.0 in (m["corr0"], m["corr1"], m["geo_corr0"], m["geo_corr1"]):
            raise SystemExit(f"a {name} correlation term is zero: {m}")
    run_dir = os.path.join(WORK, "logs", "smoke_" + name)
    check_checkpoints(run_dir, ["last.ckpt"])
    end_state, end_step, opt = ckpt_lib.load_checkpoint(os.path.join(run_dir, "checkpoints",
                                                                     "last.ckpt"))
    for k, v in end_state.items():
        moved = not torch.equal(v, rec["start"][k].cpu())
        if (full or "semantic_linear" in k) and not moved:
            raise SystemExit(f"{k} did not move in the {name} run")
        if not full and "semantic_linear" not in k and not torch.equal(v, start_state[k]):
            raise SystemExit(f"a frozen trunk leaf changed: {k}")
    held = len(opt["state"])
    if held != (len(end_state) if full else sum("semantic_linear" in k for k in end_state)):
        raise SystemExit(f"the {name} checkpoint holds Adam state for {held} leaves")
    log = check_final_eval(run_dir)
    phase(f"{name}_eval", end_step=end_step, psnr=log["total_psnr"], ssim=log["total_ssim"],
          every_trained_leaf_moved=True, adam_leaves=held)

    # the last step's kernel calls against their plain versions on their own inputs
    errs = {}
    if full:
        calls = cap.calls["train_render_grads"]
        if len(calls) != 2:
            raise SystemExit(f"captured {len(calls)} K6 calls of step {last}")
        for a, kw, got in calls:
            field, odv, z, dmaps, dweights = a
            part = "coarse" if z.shape[1] == args.N_samples else "fine"
            if bf16:
                again = fr.train_render_grads(*a, **kw)
                if kw["compute_dtype"] != torch.bfloat16 or not all(
                        torch.equal(got[k], again[k]) for k in got):
                    raise SystemExit(f"K6 at step {last} ({part}): not bf16, or two calls "
                                     "differ")
                want = fr.train_render_grads_plain(*a, **kw)
                close = bf16_leaves(f"K6 at step {last} ({part})", got, want, bf16_witness(
                    lambda f: fr.train_render_grads_plain(f, *a[1:], **kw), field, want))
            else:
                close = check_k6(f"step {last}, {part}", got,
                                 *plain_k6_with_gates(field, odv, z, dmaps, dweights, kw))
            errs[f"K6 {part}"] = close["max_abs_err"]
            phase(f"{name}_k6", step=last, field=part, rays=z.shape[0], samples=z.shape[1],
                  **close)
    else:
        calls_m, calls_g = cap.calls["geo_single_means"], cap.calls["geo_single_grads"]
        if len(calls_m) != 4 or len(calls_g) != 4:
            raise SystemExit(f"captured {len(calls_m)} K7b and {len(calls_g)} K7c calls of "
                             f"step {last}")
        rel = {"K7b": 0.0, "K7c": 0.0}
        errs = {"K7b": 0.0, "K7c": 0.0}
        with torch.no_grad():
            for k, calls, plain in (("K7b", calls_m, fc.geo_single_means_plain),
                                    ("K7c", calls_g, fc.geo_single_grads_plain)):
                for a, _, got in calls:
                    want_k = plain(*a)
                    got_t = got if isinstance(got, tuple) else (got,)
                    want_t = want_k if isinstance(want_k, tuple) else (want_k,)
                    for x, r in zip(got_t, want_t):
                        errs[k] = max(errs[k], max_err(x, r))
                        rel[k] = max(rel[k], max_err(x, r) / max(float(r.abs().max()), 1e-30))
                        if not torch.isfinite(x).all():
                            raise SystemExit(f"{k} at step {last} is not finite")
        if max(rel.values()) > K7_TOL:
            raise SystemExit(f"K7b/K7c at step {last} disagree with their plain versions: "
                             f"relative errors {rel} (tol {K7_TOL})")
        phase("sos_randneg_k7", step=last, calls=4, rel_err_K7b=rel["K7b"],
              rel_err_K7c=rel["K7c"], tol=K7_TOL)
    return {"launches": launches, "rec": rec, "args": args, "errs": errs}


def sos_step_timings(fr, fc, sos_run, name: str = "sos_step",
                     bwd: str = "frozen_sem_grads", parts: bool = True,
                     paths=("kernel", "plain", "kernel")) -> dict:
    """[sos_step] (``bwd`` K5, the frozen finetune), [sos_full_step] (K6,
    the full finetune) or, without its parts, [sos_randneg_step] (K5 and
    the single-head K7b/K7c): the 32768-ray SOS step (8 patches of 64x64) in ms
    from CUDA events on the kernel path and on the plain path (each kernel
    wrapper's plain version in its place; K6's runs its autograd a chunk of
    rays at a time, so the full step's plain path fits too), with peak
    memory; then the kernel path's step
    split into its parts, each timed alone on the step's own inputs: the
    train render's forward (K4) and backward (``bwd``) coarse and fine, the
    ViT, the packing of both fields' weight buffers for the forward kernels
    (``pack_field`` and the ring gathered from it, ``pack_ring``: again
    after every Adam step), the
    appearance loss (forward and backward), K7 forward and backward, and
    Adam. A bf16 run's (``--compute_dtype bfloat16``) parts are its bf16
    kernels, its bf16 ViT and its packing of the bf16 rings."""
    from nerfsos_torch.data.datasets import PatchDataset
    from nerfsos_torch.engines import sos
    from nerfsos_torch.losses.correlation import CorrelationLoss

    net, a, kw = sos_run["rec"]["objects"]
    extractor, app_loss, geo_loss, cfg, optimizer, schedule, near, far = a
    args = sos_run["args"]
    ds = PatchDataset(args.data_path, patch_size=args.patch_size,
                      patch_stride=args.patch_stride, ret_k=True)
    step = sos.make_sos_train_step(net, *a, **kw)
    b = ds.sample_batch(np.random.default_rng(0), args.batch_size)
    device = next(net.parameters()).device
    batch = {k: torch.as_tensor(b[k], device=device) for k in ("rays", "target")}
    bwd_key = {"frozen_sem_grads": "K5", "train_render_grads": "K6"}[bwd]
    cost = {"K5": k5_cost, "K6": k6_cost}[bwd_key]
    out = {}
    plain = {fr: {"train_render": fr.train_render_plain, bwd: getattr(fr, bwd + "_plain")},
             fc: {n: getattr(fc, n + "_plain")
                  for n in ("geo_row_stats", "geo_quad_means", "geo_quad_grads",
                            "geo_single_means", "geo_single_grads")}}
    for path in paths:
        saved = {}
        if path == "plain":
            for mod, fns in plain.items():
                for n, f in fns.items():
                    saved[(mod, n)] = getattr(mod, n)
                    setattr(mod, n, f)
        try:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: step(batch, 0), reps=2, warmup=1)
            peak = torch.cuda.max_memory_allocated() / 2**30
        finally:
            for (mod, n), f in saved.items():
                setattr(mod, n, f)
        out.setdefault(path, []).append((ms, peak))
        rays = batch["target"].shape[0]
        phase(name, path=path, patches=args.batch_size, rays=rays, ms=ms,
              rays_per_s=rays / ms * 1e3, peak_gib=peak)
    if not parts:
        return out

    # one kernel-path step with every part's inputs kept, then each part alone
    k4kb = Capture(fr, ["train_render", bwd])
    k7 = Capture(fc, ["geo_row_stats", "geo_quad_means", "geo_quad_grads"])
    vit_in, app_in = [], []
    orig_vit, orig_pair = extractor.get_vit_attn_feat, CorrelationLoss.pair_heads

    def vit(x, *va, **vkw):
        vit_in.append(x)
        return orig_vit(x, *va, **vkw)

    def pair_heads(self, *pa):
        app_in.append(pa)
        return orig_pair(self, *pa)

    extractor.get_vit_attn_feat, CorrelationLoss.pair_heads = vit, pair_heads
    k4kb.on = k7.on = True
    try:
        step(batch, 0)
        torch.cuda.synchronize()
    finally:
        k4kb.close()
        k7.close()
        extractor.get_vit_attn_feat, CorrelationLoss.pair_heads = orig_vit, orig_pair
    parts = {}
    bf16 = k4kb.calls["train_render"][0][1].get("compute_dtype") == torch.bfloat16
    for part, (fa, fkw, _) in zip(("K4 coarse", "K4 fine"), k4kb.calls["train_render"]):
        with torch.no_grad():
            parts[part] = (cuda_ms(lambda: fr.train_render(*fa, **fkw), reps=3, warmup=1),
                           cuda_ms(lambda: fr.train_render_plain(*fa, **fkw), reps=2, warmup=1))
        parts[part + " cost"] = (k4_bf16_cost if bf16 else k4_cost)(fa[0], *fa[2].shape)
    for fa, fkw, _ in k4kb.calls[bwd]:
        part = f"{bwd_key} coarse" if fa[2].shape[1] == args.N_samples else f"{bwd_key} fine"
        parts[part] = (cuda_ms(lambda: getattr(fr, bwd)(*fa, **fkw), reps=3, warmup=1),
                       cuda_ms(lambda: getattr(fr, bwd + "_plain")(*fa, **fkw), reps=2,
                               warmup=1))
        parts[part + " cost"] = (k5_bf16_cost if bf16 else cost)(fa[0], *fa[2].shape)
    with torch.no_grad():
        parts["ViT"] = (cuda_ms(lambda: orig_vit(vit_in[0]), reps=3, warmup=1), None)
        # the forward kernels' weight buffers of both fields, packed again
        # after each Adam step: pack_field's and the ring gathered from it
        # (pack_ring does both; bf16: the ring in its bf16 layout)
        fields = [fa[0] for fa, _, _ in k4kb.calls["train_render"]]
        parts["weight packing"] = (cuda_ms(lambda: [fr.pack_ring(f, bf16) for f in fields],
                                           reps=3, warmup=1), None)

    def app_fwd_bwd():
        coords, feat, c0, c1, sim = app_in[0]
        c0, c1 = c0.detach().requires_grad_(), c1.detach().requires_grad_()
        sum(app_loss.pair_heads(coords, feat, c0, c1, sim)).backward()

    parts["appearance loss"] = (cuda_ms(app_fwd_bwd, reps=3, warmup=1), None)
    (a_rs, _, _), (a_m, _, _) = k7.calls["geo_row_stats"][0], k7.calls["geo_quad_means"][0]
    (a_g, _, _), = k7.calls["geo_quad_grads"]
    parts["K7 forward"] = (cuda_ms(lambda: (fc.geo_row_stats(*a_rs), fc.geo_quad_means(*a_m))),
                           None)
    parts["K7 backward"] = (cuda_ms(lambda: fc.geo_quad_grads(*a_g)), None)
    parts["Adam"] = (cuda_ms(optimizer.step, reps=5, warmup=1), None)
    for part, v in parts.items():
        if not part.endswith("cost"):
            design = {}
            if part.startswith("K4"):
                fa = k4kb.calls["train_render"][part == "K4 fine"][0]
                design = k4_design(fa[0], *fa[2].shape, v[0], bf16)
            if part.startswith("K5"):
                design = {"ptxas": repr(K5_BF16_PTXAS if bf16 else K5_PTXAS)}
            phase(f"{name}_part", part=part, ms=v[0], plain_ms=v[1],
                  **({"bound_ms": parts[part + " cost"]["bound_ms"]}
                     if part + " cost" in parts else {}), **design)
    step_ms = out["kernel"][-1][0]
    named = sum(v[0] for n, v in parts.items() if not n.endswith("cost") and n != "Adam")
    phase(f"{name}_split", step_ms=step_ms, parts_ms=named + parts["Adam"][0],
          rest_ms=step_ms - named - parts["Adam"][0])
    return parts


# ----------------------------------------------------------------- mip-NeRF

H_VIEW, W_VIEW = 378, 504
MIP_RADII = 2.0 / max(H_VIEW, W_VIEW) * 2 / math.sqrt(12)  # a 378x504 view's base radius


def seeded_mip_field(seed: int):
    """The flagship mip field (8 x 256, multires 10, multires_views 4) with
    weights from a seeded torch.Generator, as ``seeded_field``."""
    from nerfsos_torch.models.fields import MipNeRFField

    field = MipNeRFField(net_depth=8, net_width=256, multires=10, multires_views=4)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in field.modules():
            if isinstance(m, torch.nn.Linear):
                b = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-b, b, generator=g)
                m.bias.uniform_(-b, b, generator=g)
    return field.cuda().eval()


def mip_ray_inputs(n: int, s: int, seed: int):
    """``ray_inputs``' rays with a 378x504 view's base radius as odvr
    [n, 10], and sorted fenceposts [n, s + 1] in [2, 6]."""
    odv, z = ray_inputs(n, s + 1, seed)
    return torch.cat([odv, torch.full_like(odv[:, :1], MIP_RADII)], dim=1).contiguous(), z


def mip_cost(field, R: int, S: int, kind: str, bf16: bool = False) -> dict:
    """Bounds of the mip kernels over R rays of S intervals: K9/K10a the
    forward of every layer a point (``field_flops`` 'k2'), odvr, z, maps and
    weights moved once; K10b the forward, input- and weight-gradient products
    of every layer (``field_flops`` 'k3': the mip field has no semantic
    head), odvr, z, the two cotangents and the weights read once, the
    gradients written. ``bf16``: the products at the bf16 rate, the weights
    read in bf16."""
    rays = 4 * R * (10 + (S + 1) + 5 + S)
    w = 2 if bf16 else 4
    if kind == "K10b":
        nbytes, flops = rays + (w + 4) * n_params(field), R * S * field_flops(field, "k3")
    else:
        nbytes, flops = rays + w * n_params(field), R * S * field_flops(field, "k2")
    return bf16_bound(nbytes, flops) if bf16 else bound_ms(nbytes, flops)


def mip_eval_launch(fr, field, S: int, kw: dict, seed: int) -> dict:
    """K9 (``kw`` empty) or K10a (``kw`` its noise) at the eval path's 32768
    rays a launch and S intervals: vs its plain version (which runs the
    points in chunks of its own, the noise drawn at each point's index in
    the whole call) to TOL, its time and the plain version's, and its
    bound."""
    R = EVAL_CHUNK
    odvr, z = mip_ray_inputs(R, S, seed=seed)
    wrapper, plain = ((fr.mip_train_render, fr.mip_train_render_plain) if kw
                      else (fr.fused_mip_render, fr.mip_render_plain))
    with torch.no_grad():
        got, want = wrapper(field, odvr, z, **kw), plain(field, odvr, z, **kw)
        errs = k4_errors(got, want)
        ms = cuda_ms(lambda: wrapper(field, odvr, z, **kw), reps=3)
        plain_ms = cuda_ms(lambda: plain(field, odvr, z, **kw), reps=2, warmup=1)
    name = "K10a" if kw else "K9"
    if not (all(torch.isfinite(t).all() for t in got) and max(errs) <= TOL):
        raise SystemExit(f"{name} at {R} rays disagrees with its plain version (S={S}): maps "
                         f"(scaled), weights errors {errs} (tol {TOL})")
    bound = mip_cost(field, R, S, name)
    phase(name, rays=R, samples=S, max_err_maps_scaled=errs[0], max_abs_err_weights=errs[1],
          tol=TOL, ms=ms, plain_ms=plain_ms, **bound)
    return {"max_abs_err": max(max_err(a, b) for a, b in zip(got, want)), "ms": ms,
            "plain_ms": plain_ms, **bound, "library_ms": None}


def kernel_vs_plain_k9(fr, S: int) -> dict:
    """[K9] (K4's kernel in its mip mode, no noise) at the flagship width,
    4096 rays, fixed sorted fenceposts: maps (per column over max(1, its
    max)) and weights to TOL, two calls bitwise equal, and times; then at
    the eval path's 32768 rays a launch (``mip_eval_launch``), whose numbers
    it returns, with ptxas's line for the kernel."""
    field = seeded_mip_field(5)
    odvr, z = mip_ray_inputs(4096, S, seed=30 + S)
    R = odvr.shape[0]
    with torch.no_grad():
        got = fr.fused_mip_render(field, odvr, z)
        again = fr.fused_mip_render(field, odvr, z)
        want = fr.mip_render_plain(field, odvr, z)
        torch.cuda.synchronize()
        errs = k4_errors(got, want)
        ms = cuda_ms(lambda: fr.fused_mip_render(field, odvr, z))
        plain_ms = cuda_ms(lambda: fr.mip_render_plain(field, odvr, z), reps=3)
    finite = all(torch.isfinite(t).all() for t in got)
    if not (got[0].shape == (R, 5) and finite and max(errs) <= TOL):
        raise SystemExit(f"K9 disagrees with its plain version (S={S}): maps (scaled), weights "
                         f"errors {errs} (tol {TOL}), finite={finite}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise SystemExit(f"K9's outputs differ between two calls (S={S})")
    bound = mip_cost(field, R, S, "K9")
    phase("K9", rays=R, samples=S, max_err_maps_scaled=errs[0], max_abs_err_weights=errs[1],
          tol=TOL, deterministic=True, ms=ms, plain_ms=plain_ms, **bound)
    out = mip_eval_launch(fr, field, S, {}, seed=50 + S)
    phase("K9_design", samples=S, ptxas=repr(K9_PTXAS))
    return out


def kernel_vs_plain_k10(fr, S: int) -> dict:
    """[K10]: K10a vs its plain version with noise 1 from a fixed seed, to
    TOL, two calls bitwise equal, and at the eval path's 32768 rays a launch
    (``mip_eval_launch``); K10b on K10a's 4096-ray inputs with seeded map
    and weight cotangents, every leaf to GRAD_TOL plus its gate allowance,
    two calls bitwise equal."""
    field = seeded_mip_field(6)
    odvr, z = mip_ray_inputs(4096, S, seed=40 + S)
    R = odvr.shape[0]
    kw = dict(noise_std=1.0, seed=1357911)
    with torch.no_grad():
        got = fr.mip_train_render(field, odvr, z, **kw)
        again = fr.mip_train_render(field, odvr, z, **kw)
        want = fr.mip_train_render_plain(field, odvr, z, **kw)
    torch.cuda.synchronize()
    errs = k4_errors(got, want)
    if not (all(torch.isfinite(t).all() for t in got) and max(errs) <= TOL):
        raise SystemExit(f"K10a disagrees with its plain version (S={S}): maps (scaled), "
                         f"weights errors {errs} (tol {TOL})")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise SystemExit(f"K10a's outputs differ between two calls (S={S})")
    rng = np.random.default_rng(200 + S)
    dmaps = torch.from_numpy(rng.normal(size=(R, 5)).astype(np.float32)).cuda()
    dweights = torch.from_numpy(rng.normal(size=(R, S)).astype(np.float32)).cuda()
    g = fr.mip_train_render_grads(field, odvr, z, dmaps, dweights, **kw)
    again = fr.mip_train_render_grads(field, odvr, z, dmaps, dweights, **kw)
    torch.cuda.synchronize()
    close = check_k6(f"S={S}", g, *plain_k10b_with_gates(field, odvr, z, dmaps, dweights, kw),
                     kernel="K10b")
    if not all(torch.equal(g[k], again[k]) for k in g):
        raise SystemExit(f"K10b's gradients differ between two calls (S={S})")
    with torch.no_grad():
        t_a = (cuda_ms(lambda: fr.mip_train_render(field, odvr, z, **kw)),
               cuda_ms(lambda: fr.mip_train_render_plain(field, odvr, z, **kw), reps=3))
    t_b = (cuda_ms(lambda: fr.mip_train_render_grads(field, odvr, z, dmaps, dweights, **kw)),
           cuda_ms(lambda: fr.mip_train_render_grads_plain(field, odvr, z, dmaps, dweights, **kw),
                   reps=3))
    phase("K10a", rays=R, samples=S, max_err_maps_scaled=errs[0], max_abs_err_weights=errs[1],
          tol=TOL, deterministic=True, ms=t_a[0], plain_ms=t_a[1],
          **mip_cost(field, R, S, "K10a"))
    phase("K10b", rays=R, samples=S, **close, deterministic=True, ms=t_b[0], plain_ms=t_b[1],
          **mip_cost(field, R, S, "K10b"))
    mip_eval_launch(fr, field, S, kw, seed=60 + S)
    return {"K10a": max(max_err(a, b) for a, b in zip(got, want)), "K10b": close["max_abs_err"]}


MIP_STEPS = 30


def mip_args(max_steps: int, *extra):
    """configs/flower_full.txt + --mipnerf (N_rand 1024, 64 + 128 samples,
    raw_noise_std 1) on the [train] run's 8 views of 378x504."""
    from nerfsos_torch import run_nerf

    argv = ["--config", os.path.join(ROOT, "configs", "flower_full.txt"), "--mipnerf",
            "--expname", "smoke_mip", "--basedir", os.path.join(WORK, "logs"),
            "--data_path", os.path.join(WORK, "data"), "--max_steps", str(max_steps),
            "--i_print", "10", "--i_weights", "10", "--i_testset", "1000000", "--fast_mode",
            *extra]
    args, _ = run_nerf.create_arg_parser().parse_known_args(argv)
    return args


def mip_train_path(fr) -> dict:
    """[mip_train]: ``run_nerf.main`` with the flags of
    configs/flower_full.txt + --mipnerf, MIP_STEPS steps. Every mip kernel
    count is set to 0 just before and read just after: K10a and K10b twice a
    step, K9 in the final eval; the loss falls; the checkpoints hold the Adam
    state; the last step's two K10b calls agree with the plain version."""
    rec = run_train(fr, mip_args(MIP_STEPS), MIP_COUNTS, ["mip_train_render_grads"],
                    MIP_STEPS - 1)
    launches, losses = rec["launches"], rec["losses"]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    phase("mip_train", steps=len(losses), views=f"8x{H_VIEW}x{W_VIEW}",
          seconds_incl_load_and_eval=rec["seconds"], launches=launches, loss_first10=first,
          loss_last10=last, loss_step1=losses[0], loss_last=losses[-1])
    if rec["steps"] != list(range(MIP_STEPS)):
        raise SystemExit(f"mip train ran steps {rec['steps']}")
    if (launches["K10a"] != 2 * MIP_STEPS or launches["K10b"] != 2 * MIP_STEPS
            or launches["K9"] < 1):
        raise SystemExit(f"the mip train run did not go through the kernels as expected: "
                         f"{launches}")
    if not (all(math.isfinite(x) for x in losses) and last < first):
        raise SystemExit(f"mip train loss not finite or not falling: {losses}")
    run_dir = os.path.join(WORK, "logs", "smoke_mip")
    check_checkpoints(run_dir, [f"{k:08d}.ckpt" for k in range(10, MIP_STEPS + 1, 10)]
                      + ["latest.ckpt", "last.ckpt"])
    log = check_final_eval(run_dir)
    phase("mip_train_eval", psnr=log["total_psnr"], ssim=log["total_ssim"])
    calls = rec["calls"]["mip_train_render_grads"]
    if len(calls) != 2:
        raise SystemExit(f"captured {len(calls)} K10b calls of step {MIP_STEPS - 1}")
    for a, kw, got in calls:
        field, odvr, z, dmaps, dweights = a
        part = "coarse" if z.shape[1] == 64 else "fine"
        close = check_k6(f"mip step {MIP_STEPS - 1}, {part}", got,
                         *plain_k10b_with_gates(field, odvr, z, dmaps, dweights, kw),
                         kernel="K10b")
        phase("mip_train_k10b", step=MIP_STEPS - 1, field=part, rays=z.shape[0],
              samples=z.shape[1] - 1, **close)
    return launches


def mip_eval_path(fr) -> dict:
    """[mip_eval]: ``--eval --mipnerf`` on the 378x504 test view from the
    [mip_train] run's last.ckpt, the K9 count set to 0 just before: two
    launches a ray block (coarse and fine), finite metrics in log.json; then
    the same view rendered by the kernel path and the plain path."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.data.datasets import RayDataset
    from nerfsos_torch.engines import checkpoint as ckpt_lib
    from nerfsos_torch.engines import eval as eval_lib
    from nerfsos_torch.models.mip import MipNeRFNet

    args = mip_args(0, "--eval")
    run_dir = os.path.join(WORK, "logs", "smoke_mip")
    os.remove(os.path.join(run_dir, "eval", "log.json"))  # [mip_train]'s final eval wrote one
    fr.fused_mip_render.launches = 0
    cap = Capture(fr, ["fused_mip_render"])  # the view's K9 calls, held against plain below
    cap.on = True
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_nerf.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        cap.close()
    launches = fr.fused_mip_render.launches
    blocks = -(-H_VIEW * W_VIEW // args.ray_chunk)
    phase("mip_eval", view=f"{H_VIEW}x{W_VIEW}", seconds=seconds, launches={"K9": launches},
          ray_blocks=blocks, ray_chunk=args.ray_chunk)
    if launches != 2 * blocks:
        raise SystemExit(f"--eval --mipnerf launched K9 {launches} times, not 2 x {blocks}")
    log = check_final_eval(run_dir)
    phase("mip_eval_metrics", psnr=log["total_psnr"], ssim=log["total_ssim"])
    # the view's last two K9 calls (the last ray block's coarse and fine
    # passes, the fine one on its own importance-sampled fenceposts) against
    # plain, and again on the same inputs, bitwise
    calls = cap.calls["fused_mip_render"]
    for a, _, got in calls[-2:]:
        with torch.no_grad():
            want = fr.mip_render_plain(*a)
            again = fr.fused_mip_render(*a)
        torch.cuda.synchronize()
        errs = k4_errors(got, want)
        if not (all(torch.isfinite(x).all() for x in got) and max(errs) <= TOL):
            raise SystemExit(f"K9 on the mip eval view disagrees with its plain version: maps "
                             f"(scaled), weights errors {errs} (tol {TOL})")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise SystemExit("K9 on the mip eval view: two calls differ")
        phase("mip_eval_k9", calls=len(calls), rays=a[2].shape[0], samples=a[2].shape[1] - 1,
              max_err_maps_scaled=errs[0], max_abs_err_weights=errs[1], tol=TOL,
              deterministic=True)
    del cap, calls

    net, _ = run_nerf.build_model(args, torch.device("cuda"))
    state, _, _ = ckpt_lib.load_checkpoint(os.path.join(run_dir, "checkpoints", "last.ckpt"))
    net.load_state_dict(state)
    plain = MipNeRFNet(dataclasses.replace(net.cfg, fused_field=False)).cuda().eval()
    plain.load_state_dict(state)
    dataset = RayDataset(args.data_path, split="test")
    rays = dataset.get_view(0)["rays"]
    out, secs = {}, {}
    for name, model in (("kernel", net), ("plain", plain)):
        render = eval_lib.make_render_fn(model, *dataset.near_far(), radii=dataset.radii())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = render(rays)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    d_rgb = (out["kernel"]["rgb"] - out["plain"]["rgb"]).abs().amax(dim=-1)
    frac = float((d_rgb > 1e-3).float().mean())
    phase("mip_render", view=f"{H_VIEW}x{W_VIEW}", kernel_s=secs["kernel"], plain_s=secs["plain"],
          rgb_max_abs_diff=float(d_rgb.max()), frac_rays_over_1e_3=frac)
    # as [render]: an importance sample may move a bin where a u meets a CDF edge
    if frac > 1e-3:
        raise SystemExit(f"{frac:.2%} of mip rays differ by more than 1e-3 from the plain path")
    return {"K9": launches}


def step_paths(name: str, step, dataset, mod, plain: dict) -> dict:
    """[``name``]: ``step`` (a train step: grads and Adam) timed with CUDA
    events at 1024 and 16384 rays of ``dataset`` on the kernel path and on
    the plain path (each wrapper of ``mod`` named in ``plain`` swapped for
    its plain version), in turns (kernel, plain, kernel), with peak
    memory; returns the ms by (rays, path)."""
    out = {}
    for R in (1024, 16384):
        b = dataset.sample_batch(np.random.default_rng(R), R)
        batch = {k: torch.as_tensor(b[k], device="cuda") for k in ("rays", "target")}
        for path in ("kernel", "plain", "kernel"):
            saved = {n: getattr(mod, n) for n in plain} if path == "plain" else {}
            for n in saved:
                setattr(mod, n, plain[n])
            try:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_ms(lambda: step(batch, 0), reps=3 if R == 1024 else 2, warmup=1)
                peak = torch.cuda.max_memory_allocated() / 2**30
            finally:
                for n, f in saved.items():
                    setattr(mod, n, f)
            out.setdefault((R, path), []).append(ms)
            phase(name, path=path, rays=R, ms=ms, rays_per_s=R / ms * 1e3, peak_gib=peak)
    return out


def mip_step_timings(fr) -> dict:
    """[mip_step]: the mip train step (CUDA events around grads + Adam) at
    1024 and 16384 rays on the kernel path and on the plain path (K10a's and
    K10b's plain versions in their place), in turns, with peak memory; then
    one kernel-path step's K10a and K10b calls (1024 rays, coarse S=63 and
    fine S=190) each timed alone against its plain version and its bound."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.data.datasets import RayDataset
    from nerfsos_torch.engines import state as state_lib
    from nerfsos_torch.engines.trainer import make_rgb_train_step

    args = mip_args(0)
    net, _ = run_nerf.build_model(args, torch.device("cuda"))
    optimizer = state_lib.make_optimizer(net, args.lrate)
    schedule = state_lib.exp_decay_schedule(args.lrate, args.decay_rate, args.decay_step * 1000)
    dataset = RayDataset(args.data_path, split="train")
    test = RayDataset(args.data_path, split="test")
    step = make_rgb_train_step(net, optimizer, schedule, *test.near_far(), args.rgb_w, args.seed,
                               net_kwargs={"radii": test.radii()})
    out = step_paths("mip_step", step, dataset, fr,
                     {"mip_train_render": fr.mip_train_render_plain,
                      "mip_train_render_grads": fr.mip_train_render_grads_plain})

    b = dataset.sample_batch(np.random.default_rng(1024), 1024)
    batch = {k: torch.as_tensor(b[k], device="cuda") for k in ("rays", "target")}
    cap = Capture(fr, ["mip_train_render", "mip_train_render_grads"])
    cap.on = True
    try:
        step(batch, 0)
        torch.cuda.synchronize()
    finally:
        cap.close()
    parts = {}
    for name, wrapper, plain_fn in (("K10a", fr.mip_train_render, fr.mip_train_render_plain),
                                    ("K10b", fr.mip_train_render_grads,
                                     fr.mip_train_render_grads_plain)):
        calls = cap.calls[wrapper.__name__]
        if len(calls) != 2:
            raise SystemExit(f"a mip step made {len(calls)} {name} calls, not 2")
        for a, kw, _ in calls:
            field, z = a[0], a[2]
            part = f"{name} {'coarse' if z.shape[1] == args.N_samples else 'fine'}"
            with torch.no_grad():
                parts[part] = {"ms": cuda_ms(lambda: wrapper(*a, **kw), reps=5, warmup=1),
                               "plain_ms": cuda_ms(lambda: plain_fn(*a, **kw), reps=3, warmup=1),
                               **mip_cost(field, z.shape[0], z.shape[1] - 1, name)}
                split = (forward_split(lambda: wrapper(*a, **kw), name) if name == "K10b"
                         else {})
            phase("mip_step_part", part=part, rays=z.shape[0], samples=z.shape[1] - 1,
                  **parts[part], **split)
    step_ms = out[(1024, "kernel")][-1]
    named = sum(v["ms"] for v in parts.values())
    phase("mip_step_split", rays=1024, step_ms=step_ms, kernels_ms=named, rest_ms=step_ms - named)
    return parts


# ----------------------------------------------------------------- the field kernels

EXPORT_CHUNK = 1 << 18  # points a call of engines/eval.export_density
FIELD_POINTS = EXPORT_CHUNK


def grid_points(n: int, seed: int) -> torch.Tensor:
    """``n`` points uniform in the cube of the x14 density grid, [-14, 14]^3."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, 3, generator=g) * 28.0 - 14.0).cuda()


def unit_dirs(n: int, seed: int) -> torch.Tensor:
    d = torch.randn(n, 3, generator=torch.Generator().manual_seed(seed))
    return (d / d.norm(dim=1, keepdim=True)).cuda()


def field_bwd_flops(field, input_grads: bool) -> float:
    """The field backward's matrix-product FLOP a point: ``field_flops``
    'k6' (the forward, every input-gradient product of the reverse sweep,
    every weight-gradient product), and with ``input_grads`` the products
    that gather the emb cotangent (layer 0, the layer after the skip,
    sem_0's coordinate columns) and the view-PE cotangent (the views
    layer's view-PE columns)."""
    flops = field_flops(field, "k6")
    if input_grads:
        mlp = field.mlp
        E, W = mlp.pts_linears[0].in_features, mlp.width
        Ed = mlp.views_linears[0].in_features - W
        skips = sum(1 for i in range(1, mlp.depth) if i - 1 in mlp.skips)
        flops += 2 * E * W * (1 + skips) + 2 * Ed * (W // 2)
        if mlp.use_semantics and mlp.sem_with_coord:
            flops += 2 * E * mlp.semantic_linear[0].out_features
    return flops


def field_cost(field, n: int, kind: str, input_grads: bool = False, bf16: bool = False) -> dict:
    """Bounds of the field kernels over ``n`` points: 'sigma' the trunk and
    the alpha head (``field_flops`` 'k1'), points in and sigma out; 'field'
    every layer ('k2'), points and directions in, raw out; 'mip' the same
    with the covariances in; 'bwd' ``field_bwd_flops``, points, directions
    and the cotangent in, the gradients (and dpts/ddirs) out. The weights
    are read once (``bf16``, the bf16 modes: in bf16, the products at the
    bf16 rate)."""
    C = 4 + (field.mlp.semantic_linear[2].out_features
             if getattr(field.mlp, "use_semantics", False) else 0)
    w = 4 * n_params(field)
    wr = w // 2 if bf16 else w  # the weights' bytes as the kernel reads them
    cost = bf16_bound if bf16 else bound_ms
    if kind == "sigma":
        return cost(4 * n * 4 + wr, n * field_flops(field, "k1"))
    if kind == "field":
        return cost(4 * n * (6 + C) + wr, n * field_flops(field, "k2"))
    if kind == "mip":
        return cost(4 * n * (9 + C) + wr, n * field_flops(field, "k2"))
    return cost(4 * n * (6 + C + (6 if input_grads else 0)) + wr + w,
                n * field_bwd_flops(field, input_grads))


def scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| of each column over max(1, its max |want|)."""
    got, want = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    return float(((got - want).abs() / want.abs().amax(0).clamp(min=1.0)).max())


def field_design(ff, field, N: int, mode: int, bf16: bool = False,
                 f32_heads: bool = False) -> dict:
    """[K8_design]: the field forward's launch on N points in input mode
    ``mode`` (FIELD_PTXAS's key, with ``bf16`` and K8b's head rule
    ``f32_heads``): its ring stages and tiles a CTA (``_field_plan``), the
    CTAs, and ptxas's line for the kernel."""
    from nerfsos_torch.ops import fused_render as fr

    dev = next(field.parameters()).device
    per, rd = ff._field_plan(fr._packed(field, dev)[1], fr._ring(field, dev, bf16)[1], N,
                             ff._sm_count(dev), mode != 4)
    return {"ring_stages": rd.stages, "tiles_per_cta": per, "ctas": -(-N // (128 * per)),
            "ptxas": repr(FIELD_PTXAS.get((mode, int(bf16), int(f32_heads))))}


def kernel_vs_plain_k8(ff) -> dict:
    """[K8] at the flagship width (8 x 256, multires 10/4) on 2^18 points
    uniform in the x14 density grid's cube with random unit directions: the
    field forward with the semantic head (coordinates, sem_dim 2) and
    without it, the sigma forward, and K11 (the flagship mip field) at
    random non-zero and at zero covariances. Each output column to TOL over
    max(1, its max |plain|) (sigma reaches O(10) at |x| up to 14), two calls
    bitwise equal, each timed against its plain version with CUDA events,
    with its launch's [K8_design]."""
    N = FIELD_POINTS
    pts, dirs = grid_points(N, 50), unit_dirs(N, 51)
    out = {}

    def check(name, got, want, run, plain, cost, **fields):
        err = scaled_err(got, want)
        if not (got.shape == want.shape and torch.isfinite(got).all() and err <= TOL):
            raise SystemExit(f"{name} disagrees with its plain version ({fields}): "
                             f"max scaled error {err} (tol {TOL})")
        with torch.no_grad():
            again = run()
            if not torch.equal(got, again):
                raise SystemExit(f"{name}'s outputs differ between two calls ({fields})")
            ms, plain_ms = cuda_ms(run), cuda_ms(plain, reps=3)
        phase("K8", kernel=name, points=N, **fields, max_err_scaled=err, tol=TOL,
              deterministic=True, ms=ms, plain_ms=plain_ms, **cost)
        return {"max_abs_err": max_err(got, want), "ms": ms, "plain_ms": plain_ms, **cost,
                "library_ms": None}

    for sem in (True, False):
        field = seeded_field(40 + sem, net_depth=8, net_width=256, multires=10, multires_views=4,
                             use_semantics=sem, sem_with_coord=sem, sem_dim=2)
        with torch.no_grad():
            got, want = ff.field_forward(field, pts, dirs), ff.field_plain(field, pts, dirs)
        res = check("field forward", got, want, lambda: ff.field_forward(field, pts, dirs),
                    lambda: ff.field_plain(field, pts, dirs), field_cost(field, N, "field"),
                    semantics=sem)
        phase("K8_design", kernel="field forward", semantics=sem, **field_design(ff, field, N, 3))
        if sem:
            out["field"] = res
            with torch.no_grad():
                got, want = ff.fused_sigma_apply(field, pts), ff.sigma_plain(field, pts)
            out["sigma"] = check("sigma forward", got, want,
                                 lambda: ff.fused_sigma_apply(field, pts),
                                 lambda: ff.sigma_plain(field, pts),
                                 field_cost(field, N, "sigma"), semantics=sem)
            phase("K8_design", kernel="sigma forward", **field_design(ff, field, N, 4))
    mip = seeded_mip_field(42)
    g = torch.Generator().manual_seed(52)
    for zero in (False, True):
        cov = torch.zeros_like(pts) if zero else (torch.rand(N, 3, generator=g) * 1e-4).cuda()
        with torch.no_grad():
            got = ff.fused_mip_field_apply(mip, pts, cov, dirs)
            want = ff.mip_field_plain(mip, pts, cov, dirs)
        res = check("K11", got, want, lambda: ff.fused_mip_field_apply(mip, pts, cov, dirs),
                    lambda: ff.mip_field_plain(mip, pts, cov, dirs), field_cost(mip, N, "mip"),
                    zero_cov=zero)
        if zero:
            out["mip"] = res
    phase("K8_design", kernel="K11", **field_design(ff, mip, N, 5))
    return out


def plain_field_grads_with_gates(ff, field, pts, dirs, g, input_grads: bool):
    """The field backward's plain version, and ``plain_with_gates``' slack
    and terms for the trunk, views and sem_0 gates (the raw sigma has no
    relu in the field)."""
    mlp = field.mlp
    gates = [*mlp.pts_linears, mlp.views_linears[0]]
    if mlp.use_semantics:
        gates.append(mlp.semantic_linear[0])
    return plain_with_gates(field, pts.shape[0], 1, {"noise_std": 0.0}, gates,
                            lambda: ff.field_grads_plain(field, pts, dirs, g,
                                                         input_grads=input_grads))


def check_field_grads(ff, what: str, got, field, pts, dirs, g, input_grads: bool) -> dict:
    """The field backward's (grads, dpts, ddirs) against its plain version's
    on the same inputs: every leaf to GRAD_TOL of its max plus its flip
    allowance (``check_k6``); dpts and ddirs to GRAD_TOL of their max over
    the points whose gates clear INPUT_GRAD_MARGIN (a flipped gate moves
    its own point's input gradient alone); raises."""
    (want, dp, dd), slack, terms = plain_field_grads_with_gates(ff, field, pts, dirs, g,
                                                                input_grads)
    kernel = "K8c" if input_grads else "K8f"
    close = check_k6(what, got[0], want, slack, terms, kernel=kernel)
    if input_grads:
        clear = slack > INPUT_GRAD_MARGIN
        close["input_grad_points"] = int(clear.sum())
        for name, a, b in (("dpts", got[1], dp), ("ddirs", got[2], dd)):
            scale = max(float(b[clear].abs().max()), 1e-12)
            err = float((a[clear] - b[clear]).abs().max()) / scale
            if not (torch.isfinite(a).all() and err <= GRAD_TOL):
                raise SystemExit(f"{kernel} {name} disagrees with its plain version ({what}): "
                                 f"{err} of its max (tol {GRAD_TOL})")
            close[f"{name}_rel_err"] = err
    return close


def kernel_vs_plain_k8_bwd(ff) -> dict:
    """[K8_bwd] the field backward at the --N_importance 0 step's size,
    1024 rays x 64 samples = 65536 points (``ray_inputs``), of the flagship
    field with the semantic head (coordinates), from a seeded cotangent, in
    both modes: weights only (K8f) and with dpts/ddirs (K8c); each checked
    by ``check_field_grads`` and two calls bitwise equal, with its
    forward's ring stages (``_field_ring``) and ``forward_split``."""
    from nerfsos_torch.core.sampling import points_along_rays

    field = seeded_field(43, net_depth=8, net_width=256, multires=10, multires_views=4,
                         use_semantics=True, sem_with_coord=True, sem_dim=2)
    odv, z = ray_inputs(1024, 64, seed=44)
    pts = points_along_rays(odv[:, 0:3], odv[:, 3:6], z).reshape(-1, 3).contiguous()
    dirs = odv[:, None, 6:9].expand(1024, 64, 3).reshape(-1, 3).contiguous()
    N = pts.shape[0]
    g = torch.from_numpy(np.random.default_rng(45).normal(size=(N, 6)).astype(np.float32)).cuda()
    from nerfsos_torch.ops import fused_render as fr
    stages = ff._field_ring(fr._packed(field, pts.device)[1], fr._ring(field, pts.device)[1],
                            True).stages
    out = {}
    for input_grads in (False, True):
        kernel = "K8c" if input_grads else "K8f"
        before = (ff.field_grads.launches, ff.field_grads.input_grad_launches)
        got = ff.field_grads(field, pts, dirs, g, input_grads=input_grads)
        again = ff.field_grads(field, pts, dirs, g, input_grads=input_grads)
        torch.cuda.synchronize()
        launches = (ff.field_grads.launches - before[0],
                    ff.field_grads.input_grad_launches - before[1])
        if launches != (2, 2 * input_grads):
            raise SystemExit(f"{kernel}: two calls counted {launches}")
        close = check_field_grads(ff, kernel, got, field, pts, dirs, g, input_grads)
        same = all(torch.equal(got[0][k], again[0][k]) for k in got[0]) and (
            not input_grads or (torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])))
        if not same:
            raise SystemExit(f"{kernel}'s gradients differ between two calls")
        ms = cuda_ms(lambda: ff.field_grads(field, pts, dirs, g, input_grads=input_grads))
        plain_ms = cuda_ms(lambda: ff.field_grads_plain(field, pts, dirs, g,
                                                        input_grads=input_grads), reps=3)
        cost = field_cost(field, N, "bwd", input_grads)
        split = forward_split(lambda: ff.field_grads(field, pts, dirs, g,
                                                     input_grads=input_grads), kernel)
        phase("K8_bwd", mode=kernel, points=N, launches={"field_grads": launches[0],
                                                          "input_grad_mode": launches[1]},
              **close, deterministic=True, ms=ms, plain_ms=plain_ms, ring_stages=stages, **split,
              **cost)
        out[kernel] = {"max_abs_err": close["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
                       **cost, "library_ms": None}
    return out


def eval_vol_path(ff) -> dict:
    """[eval_vol]: ``run_nerf.main --eval_vol`` at the default --vol_extents
    2.0 --vol_size 2/256 (a 256^3 grid, 64 chunks of 2^18 points) on the
    [eval] phase's seeded flagship .ckpt: the field forward's count, set to
    0 just before, must read 64 just after; density.mrc and density.ply are
    written; the volume equals the plain path's within TOL x max(1, max
    sigma). Then the same on the [mip_train] run's checkpoint with
    --mipnerf (K11, 64 launches)."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.engines import checkpoint as ckpt_lib
    from nerfsos_torch.engines import eval as eval_lib
    from nerfsos_torch.models.mip import MipNeRFNet
    from nerfsos_torch.models.nerf import NeRFNet
    from nerfsos_torch.utils import io as io_utils

    out = {}
    for name, args, wrapper, run_dir, ckpt in (
            ("classic", eval_args("--eval_vol"), ff.field_forward,
             os.path.join(WORK, "logs", "smoke"), os.path.join(WORK, "seeded.ckpt")),
            ("mip", mip_args(0, "--eval_vol"), ff.fused_mip_field_apply,
             os.path.join(WORK, "logs", "smoke_mip"),
             os.path.join(WORK, "logs", "smoke_mip", "checkpoints", "last.ckpt"))):
        wrapper.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_nerf.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = wrapper.launches
        side = int(args.vol_extents[0] / args.vol_size)
        chunks = -(-side**3 // EXPORT_CHUNK)
        files = [os.path.join(run_dir, "eval", f) for f in ("density.mrc", "density.ply")]
        if launches != chunks or not all(os.path.exists(f) for f in files):
            raise SystemExit(f"--eval_vol ({name}) launched {wrapper.__name__} {launches} times, "
                             f"not {chunks}, or did not write {files}")
        vol = io_utils.read_mrc(files[0])
        net, cfg = run_nerf.build_model(args, torch.device("cuda"))
        state, _, _ = ckpt_lib.load_checkpoint(ckpt)
        plain = (MipNeRFNet if name == "mip" else NeRFNet)(dataclasses.replace(cfg, fused_field=False))
        plain = plain.cuda().eval()
        plain.load_state_dict(state)
        net.load_state_dict(state)
        secs = {}
        for path, model in (("kernel", net), ("plain", plain)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v = eval_lib.export_density(model, extents=(args.vol_extents[0],) * 3,
                                        voxel_size=args.vol_size)
            torch.cuda.synchronize()
            secs[path] = time.perf_counter() - t0
            if path == "plain":
                want = v
        top = max(1.0, float(np.abs(want).max()))
        err = float(np.abs(vol - want).max())
        phase("eval_vol", field=name, grid=vol.shape, seconds=seconds,
              launches={wrapper.__name__: launches}, export_kernel_s=secs["kernel"],
              export_plain_s=secs["plain"], max_sigma=float(want.max()),
              occupied=int((want > 1e-6).sum()), max_abs_err=err, tol=TOL * top)
        if not (vol.shape == (side,) * 3 and np.isfinite(vol).all() and err <= TOL * top):
            raise SystemExit(f"--eval_vol ({name}) volume vs the plain path: max abs err {err} "
                             f"(tol {TOL * top}), shape {vol.shape}")
        out[name] = launches
    return out


NOIMP_COUNTS = {"K8d": "field_forward", "K8f": "field_grads", "K8e": "fused_sigma_apply"}


def train_noimp_path(fr, ff) -> dict:
    """[train_noimp]: ``run_nerf.main`` with configs/flower_full.txt's flags
    and --N_importance 0 (N_rand 1024, 64 samples, noise 1, the semantic
    head) on the [train] run's 8 views of 378x504, TRAIN_STEPS steps. The
    field kernels' counts, set to 0 just before: the backward (K8f) once a
    step, the forward (K8d) once a step and once a ray block of the final
    eval, no K1-K4; the loss is finite and falls; the last step's K8f call
    agrees with the plain version on its own inputs."""
    args = train_args(os.path.join(WORK, "data"), os.path.join(WORK, "logs"), TRAIN_STEPS,
                      expname="smoke_noimp", extra=("--N_importance", "0"))
    other = {n: getattr(fr, n).launches for n in (*TRAIN_COUNTS.values(), "train_render")}
    ff.field_grads.input_grad_launches = 0
    rec = run_train(fr, args, NOIMP_COUNTS, ["field_grads"], TRAIN_STEPS - 1, mod=ff)
    launches, losses = rec["launches"], rec["losses"]
    launches["K8c"] = ff.field_grads.input_grad_launches
    blocks = -(-H_VIEW * W_VIEW // args.ray_chunk)
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    phase("train_noimp", steps=len(losses), views=f"8x{H_VIEW}x{W_VIEW}",
          seconds_incl_load_and_eval=rec["seconds"], launches=launches, eval_ray_blocks=blocks,
          loss_first10=first, loss_last10=last, loss_step1=losses[0], loss_last=losses[-1])
    if rec["steps"] != list(range(TRAIN_STEPS)):
        raise SystemExit(f"the --N_importance 0 run ran steps {rec['steps']}")
    if (launches["K8f"] != TRAIN_STEPS or launches["K8d"] != TRAIN_STEPS + blocks
            or launches["K8c"] != 0 or launches["K8e"] != 0
            or any(getattr(fr, n).launches != c for n, c in other.items())):
        raise SystemExit(f"the --N_importance 0 run did not go through the field kernels as "
                         f"expected: {launches}")
    if not (all(math.isfinite(x) for x in losses) and last < first):
        raise SystemExit(f"the --N_importance 0 loss is not finite or not falling: {losses}")
    run_dir = os.path.join(WORK, "logs", "smoke_noimp")
    check_checkpoints(run_dir, ["00000010.ckpt", "00000020.ckpt", "00000030.ckpt", "last.ckpt"])
    log = check_final_eval(run_dir)
    phase("train_noimp_eval", psnr=log["total_psnr"], ssim=log["total_ssim"])
    calls = rec["calls"]["field_grads"]
    if len(calls) != 1:
        raise SystemExit(f"captured {len(calls)} K8f calls of step {TRAIN_STEPS - 1}")
    (field, pts, dirs, g), kw, got = calls[0]
    close = check_field_grads(ff, f"--N_importance 0 step {TRAIN_STEPS - 1}", got, field, pts,
                              dirs, g, kw["input_grads"])
    phase("train_noimp_k8f", step=TRAIN_STEPS - 1, points=pts.shape[0], **close)
    return launches


def sos_noimp_path(fr, ff) -> dict:
    """[sos_noimp]: ``--patch_tune --fix_backbone --N_importance 0``, 5 steps
    from the [train_noimp] run's last.ckpt on the [sos] phase's 8 views of
    384x512 (8 patches of 64x64). The SOS losses read the coarse pass's
    outputs, which a net with no fine pass has not (the entry point stops
    on them), so this is the RGB finetune on patches: K8d once a step, K8f
    once a step (every field counted 0 just before); every term finite, and
    the trunk bitwise equal to the checkpoint's."""
    from nerfsos_torch.engines import checkpoint as ckpt_lib

    ckpt = os.path.join(WORK, "logs", "smoke_noimp", "checkpoints", "last.ckpt")
    start_state, start, _ = ckpt_lib.load_checkpoint(ckpt)
    args = sos_args(ckpt, start + MODE_STEPS, "smoke_sos_noimp",
                    drop=("--use_dino", "--use_correlation", "--use_geoCorr"),
                    extra=("--N_importance", "0"))
    rec = run_train(fr, args, NOIMP_COUNTS, mod=ff)
    launches = rec["launches"]
    state, end, _ = ckpt_lib.load_checkpoint(os.path.join(WORK, "logs", "smoke_sos_noimp",
                                                          "checkpoints", "last.ckpt"))
    trunk = [k for k in start_state if "semantic" not in k]
    moved = [k for k in trunk if not torch.equal(state[k].cpu(), start_state[k].cpu())]
    phase("sos_noimp", steps=len(rec["steps"]), first_step=rec["steps"][0], end_step=end,
          seconds_incl_load_and_eval=rec["seconds"], launches=launches,
          losses=rec["losses"], trunk_leaves=len(trunk), trunk_moved=moved)
    if rec["steps"] != list(range(start, start + MODE_STEPS)) or end != start + MODE_STEPS:
        raise SystemExit(f"--N_importance 0 patch finetune ran steps {rec['steps']}, "
                         f"ended at {end}")
    if launches["K8f"] != MODE_STEPS or launches["K8d"] < MODE_STEPS:
        raise SystemExit(f"the patch finetune did not go through the field kernels: {launches}")
    if not all(math.isfinite(x) for x in rec["losses"]) or moved:
        raise SystemExit(f"patch finetune: losses {rec['losses']}, trunk leaves moved {moved}")
    return launches


def sigma_noise_path(ff) -> dict:
    """[sigma_noise]: the 378x504 test view of the [eval] phase through the
    seeded flagship net's ``forward(..., coarse_outputs=False,
    raw_noise_std=1.0)`` (64 + 128 samples, the semantic head with
    coordinates): the density-only coarse pass with noise runs the sigma
    kernel (K8e) and the fine pass after it the field kernel (K8d), each
    once a ray block (counts set to 0 just before). The plain net renders
    the view with the same generator seed (the noise is drawn in torch,
    outside the kernels); rgb is compared as [render] does. One of the
    view's sigma calls is then held against its plain version and timed."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.data.datasets import RayDataset
    from nerfsos_torch.engines import checkpoint as ckpt_lib
    from nerfsos_torch.models.nerf import NeRFNet

    args = eval_args("--eval")
    net, cfg = run_nerf.build_model(args, torch.device("cuda"))
    state, _, _ = ckpt_lib.load_checkpoint(os.path.join(WORK, "seeded.ckpt"))
    net.load_state_dict(state)
    plain = NeRFNet(dataclasses.replace(cfg, fused_field=False)).cuda().eval()
    plain.load_state_dict(state)
    dataset = RayDataset(args.data_path, split="test")
    rays = torch.as_tensor(dataset.get_view(0)["rays"], device="cuda")
    near_far = dataset.near_far()
    blocks = -(-H_VIEW * W_VIEW // cfg.ray_block)
    for name in NOIMP_COUNTS.values():
        getattr(ff, name).launches = 0
    cap = Capture(ff, ["fused_sigma_apply"])
    out, secs = {}, {}
    for path, model in (("kernel", net), ("plain", plain)):
        cap.on = path == "kernel"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out[path] = model(rays, near_far, train=False, coarse_outputs=False,
                              raw_noise_std=1.0,
                              generator=torch.Generator(device="cuda").manual_seed(7))
        torch.cuda.synchronize()
        secs[path] = time.perf_counter() - t0
    cap.close()
    launches = {k: getattr(ff, n).launches for k, n in NOIMP_COUNTS.items()}
    d_rgb = (out["kernel"]["rgb"] - out["plain"]["rgb"]).abs().amax(dim=-1)
    frac = float((d_rgb > 1e-3).float().mean())
    phase("sigma_noise", view=f"{H_VIEW}x{W_VIEW}", ray_blocks=blocks, launches=launches,
          kernel_s=secs["kernel"], plain_s=secs["plain"], rgb_max_abs_diff=float(d_rgb.max()),
          frac_rays_over_1e_3=frac)
    if launches["K8e"] != blocks or launches["K8d"] != blocks or launches["K8f"] != 0:
        raise SystemExit(f"the noisy density-only render launched {launches}, not the sigma "
                         f"and the field kernel once each of {blocks} ray blocks")
    if not all(torch.isfinite(v).all() for v in out["kernel"].values()) or frac > 1e-3:
        raise SystemExit(f"{frac:.2%} of rays differ by more than 1e-3 from the plain path")
    (field, pts, _), _, got = cap.calls["fused_sigma_apply"][0]  # (field, pts, float32)
    with torch.no_grad():
        want = ff.sigma_plain(field, pts)
        err = scaled_err(got, want)
        ms = cuda_ms(lambda: ff.fused_sigma_apply(field, pts))
        plain_ms = cuda_ms(lambda: ff.sigma_plain(field, pts), reps=3)
    cost = field_cost(field, pts.shape[0], "sigma")
    phase("sigma_noise_k8e", points=pts.shape[0], max_err_scaled=err, tol=TOL, ms=ms,
          plain_ms=plain_ms, **cost)
    if err > TOL:
        raise SystemExit(f"the view's sigma call disagrees with its plain version: {err}")
    return {"launches": launches, "timed": {"max_abs_err": max_err(got, want), "ms": ms,
                                            "plain_ms": plain_ms, **cost, "library_ms": None}}


def noimp_step_timings(ff) -> dict:
    """[noimp_step]: the --N_importance 0 RGB step (configs/flower_full.txt's
    flags: 64 samples, noise 1, the semantic head; autograd through the
    field forward and backward, then Adam) at 1024 and 16384 rays on the
    kernel path and on the plain path (the field wrappers swapped for their
    plain versions), in turns, with peak memory; then one kernel-path
    step's field forward (K8d) and backward (K8f) calls (1024 x 64 points)
    each timed alone against its plain version and its bound."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.data.datasets import RayDataset
    from nerfsos_torch.engines import state as state_lib
    from nerfsos_torch.engines.trainer import make_rgb_train_step

    args = train_args(os.path.join(WORK, "data"), os.path.join(WORK, "logs"), 0,
                      extra=("--N_importance", "0"))
    net, _ = run_nerf.build_model(args, torch.device("cuda"))
    optimizer = state_lib.make_optimizer(net, args.lrate)
    schedule = state_lib.exp_decay_schedule(args.lrate, args.decay_rate, args.decay_step * 1000)
    dataset = RayDataset(args.data_path, split="train")
    step = make_rgb_train_step(net, optimizer, schedule, *dataset.near_far(), args.rgb_w,
                               args.seed)
    step_paths("noimp_step", step, dataset, ff,
               {"field_forward": ff.field_plain, "field_grads": ff.field_grads_plain})

    b = dataset.sample_batch(np.random.default_rng(1024), 1024)
    batch = {k: torch.as_tensor(b[k], device="cuda") for k in ("rays", "target")}
    cap = Capture(ff, ["field_forward", "field_grads"])
    cap.on = True
    try:
        step(batch, 0)
        torch.cuda.synchronize()
    finally:
        cap.close()
    parts = {}
    for name, wrapper, plain_fn, kind in (("K8d", ff.field_forward, ff.field_plain, "field"),
                                          ("K8f", ff.field_grads, ff.field_grads_plain, "bwd")):
        calls = cap.calls[wrapper.__name__]
        if len(calls) != 1:
            raise SystemExit(f"a --N_importance 0 step made {len(calls)} {name} calls, not 1")
        a, kw, got = calls[0]
        with torch.no_grad():
            want = plain_fn(*a, **kw)
            err = (scaled_err(got, want) if name == "K8d"
                   else max(max_err(got[0][k], want[0][k]) for k in want[0]))
            parts[name] = {"max_abs_err": err,
                           "ms": cuda_ms(lambda: wrapper(*a, **kw), reps=5, warmup=1),
                           "plain_ms": cuda_ms(lambda: plain_fn(*a, **kw), reps=3, warmup=1),
                           **field_cost(a[0], a[1].shape[0], kind), "library_ms": None}
        phase("noimp_step_part", part=name, points=a[1].shape[0], **parts[name])
    return parts

# ----------------------------------------------------------------- mip-NeRF at bf16

MIP_BF16_PLANES_SHAPES = ((1024, 63), (256, 190))  # (rays, intervals): one wave of chunks


def kernel_vs_plain_mip_bf16(fr, ff) -> dict:
    """[K9_bf16] at the eval path's 32768 rays a launch (S = 63, 190),
    [K10a_bf16] at the mip step's 1024 rays with noise 1 (S = 63, 190),
    [K10b_bf16] on those rays with seeded map and weight cotangents,
    [K10b_bf16_planes] at MIP_BF16_PLANES_SHAPES and [K11_bf16] at 2^18
    points of the x14 grid (covariances below 1e-4 and zero, as the
    export's), each at the flagship width: the bf16 mode against its bf16
    plain version (maps, weights and raw: bf16_columns; K10b's leaves:
    bf16_leaves beside their bf16_witness; its stored planes and sweep:
    bf16_planes), with the readings of the fp32 kernel's output on the same
    inputs (and for K10b of the plain version with its gated cotangents left
    unrounded, unrounded_gate_fault), two calls bitwise equal, timed beside
    the same call's fp32 kernel and the bf16 bound. Returns the kernels
    line's numbers: K9 at 32768 x 190, K10a and K10b at 1024 x 190, K11 at
    zero covariances."""
    bf = torch.bfloat16
    out = {}
    field = seeded_mip_field(5)
    for S in (63, 190):
        R = EVAL_CHUNK
        odvr, z = mip_ray_inputs(R, S, seed=70 + S)
        with torch.no_grad():
            got = fr.fused_mip_render(field, odvr, z, bf)
            again = fr.fused_mip_render(field, odvr, z, bf)
            want = fr.mip_render_plain(field, odvr, z, bf)
            control = fr.fused_mip_render(field, odvr, z)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise SystemExit(f"K9 at bf16 (S={S}): two calls differ")
        close = {n: bf16_columns(f"K9 {n} (S={S})", got[i], want[i], control[i])
                 for i, n in enumerate(("maps", "weights"))}
        del again, want, control
        with torch.no_grad():
            ms = cuda_ms(lambda: fr.fused_mip_render(field, odvr, z, bf), reps=3)
            ms32 = cuda_ms(lambda: fr.fused_mip_render(field, odvr, z), reps=3)
            plain_ms = cuda_ms(lambda: fr.mip_render_plain(field, odvr, z, bf), reps=2, warmup=1)
        bound = mip_cost(field, R, S, "K9", bf16=True)
        phase("K9_bf16", rays=R, samples=S, **close, deterministic=True, ms=ms, fp32_ms=ms32,
              plain_ms=plain_ms, **bound, ptxas=repr(K9_BF16_PTXAS))
        if S == 190:
            out["K9"] = {"max_abs_err": max(c["max_abs_err"] for c in close.values()), "ms": ms,
                         "plain_ms": plain_ms, **bound, "library_ms": None}

    field = seeded_mip_field(6)
    kw = dict(noise_std=1.0, seed=2468)
    for S in (63, 190):
        R = 1024
        odvr, z = mip_ray_inputs(R, S, seed=80 + S)
        with torch.no_grad():
            got = fr.mip_train_render(field, odvr, z, compute_dtype=bf, **kw)
            again = fr.mip_train_render(field, odvr, z, compute_dtype=bf, **kw)
            want = fr.mip_train_render_plain(field, odvr, z, compute_dtype=bf, **kw)
            control = fr.mip_train_render(field, odvr, z, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise SystemExit(f"K10a at bf16 (S={S}): two calls differ")
        close = {n: bf16_columns(f"K10a {n} (S={S})", got[i], want[i], control[i])
                 for i, n in enumerate(("maps", "weights"))}
        with torch.no_grad():
            ms = cuda_ms(lambda: fr.mip_train_render(field, odvr, z, compute_dtype=bf, **kw))
            ms32 = cuda_ms(lambda: fr.mip_train_render(field, odvr, z, **kw))
            plain_ms = cuda_ms(lambda: fr.mip_train_render_plain(field, odvr, z, compute_dtype=bf,
                                                                 **kw), reps=3)
        bound = mip_cost(field, R, S, "K10a", bf16=True)
        phase("K10a_bf16", rays=R, samples=S, noise_std=1.0, **close, deterministic=True, ms=ms,
              fp32_ms=ms32, plain_ms=plain_ms, **bound, ptxas=repr(K9_BF16_PTXAS))
        if S == 190:
            out["K10a"] = {"max_abs_err": max(c["max_abs_err"] for c in close.values()),
                           "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": None}

        rng = np.random.default_rng(210 + S)
        dmaps = torch.from_numpy(rng.normal(size=(R, 5)).astype(np.float32)).cuda()
        dweights = torch.from_numpy(rng.normal(size=(R, S)).astype(np.float32)).cuda()

        def plain(f, dtype=bf):
            return fr.mip_train_render_grads_plain(f, odvr, z, dmaps, dweights,
                                                   compute_dtype=dtype, **kw)

        def run(dtype=bf):
            return fr.mip_train_render_grads(field, odvr, z, dmaps, dweights, compute_dtype=dtype,
                                             **kw)

        g, again, control = run(), run(), run(torch.float32)
        want = plain(field)
        witness = bf16_witness(plain, field, want)
        fault = unrounded_gate_fault(fr, lambda: plain(field))
        torch.cuda.synchronize()
        if not all(torch.equal(g[k], again[k]) for k in g):
            raise SystemExit(f"K10b at bf16 (S={S}): two calls differ")
        close = bf16_leaves(f"K10b (S={S})", g, want, witness,
                            {"control": control, "fault": fault})
        del again, control, want, fault
        ms = cuda_ms(run)
        ms32 = cuda_ms(lambda: run(torch.float32))
        plain_ms = cuda_ms(lambda: plain(field), reps=3)
        bound = mip_cost(field, R, S, "K10b", bf16=True)
        split = forward_split(run, "K10b_bf16") if S == 190 else {}
        phase("K10b_bf16", rays=R, samples=S, **close, deterministic=True, ms=ms, fp32_ms=ms32,
              plain_ms=plain_ms, **bound, **split)
        if S == 190:
            out["K10b"] = {"max_abs_err": close["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
                           **bound, "library_ms": None}
    for R, S in MIP_BF16_PLANES_SHAPES:
        odvr, z = mip_ray_inputs(R, S, seed=90 + S)
        rng = np.random.default_rng(220 + S)
        dmaps = torch.from_numpy(rng.normal(size=(R, 5)).astype(np.float32)).cuda()
        dweights = torch.from_numpy(rng.normal(size=(R, S)).astype(np.float32)).cuda()
        flat, launch = fr._mip_grads_launch(field, odvr, z, dmaps, dweights, kw["noise_std"],
                                            kw["seed"], True)
        got = fr.unpack_grads(field, flat)
        control = fr.mip_train_render_grads(field, odvr, z, dmaps, dweights, **kw)
        close = bf16_planes(fr, f"K10b (R={R} S={S})", field, got, launch, odvr, z, False,
                            {"control": lambda sweep: control,
                             "fault": lambda sweep: unrounded_gate_fault(fr, sweep)}, mip=True)
        phase("K10b_bf16_planes", rays=R, samples=S, **close)
        del launch

    mip = seeded_mip_field(42)
    N = FIELD_POINTS
    pts, dirs = grid_points(N, 50), unit_dirs(N, 51)
    g = torch.Generator().manual_seed(53)
    for zero in (False, True):
        cov = torch.zeros_like(pts) if zero else (torch.rand(N, 3, generator=g) * 1e-4).cuda()
        with torch.no_grad():
            got = ff.fused_mip_field_apply(mip, pts, cov, dirs, bf)
            again = ff.fused_mip_field_apply(mip, pts, cov, dirs, bf)
            want = ff.mip_field_plain(mip, pts, cov, dirs, bf)
            control = ff.fused_mip_field_apply(mip, pts, cov, dirs)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise SystemExit(f"K11 at bf16 (zero_cov={zero}): two calls differ")
            close = bf16_columns(f"K11 (zero_cov={zero})", got, want, control)
            ms = cuda_ms(lambda: ff.fused_mip_field_apply(mip, pts, cov, dirs, bf))
            ms32 = cuda_ms(lambda: ff.fused_mip_field_apply(mip, pts, cov, dirs))
            plain_ms = cuda_ms(lambda: ff.mip_field_plain(mip, pts, cov, dirs, bf), reps=3)
        bound = field_cost(mip, N, "mip", bf16=True)
        phase("K11_bf16", points=N, zero_cov=zero, **close, deterministic=True, ms=ms,
              fp32_ms=ms32, plain_ms=plain_ms, **bound, **field_design(ff, mip, N, 5, bf16=True))
        if zero:
            out["K11"] = {"max_abs_err": close["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
                          **bound, "library_ms": None}
    return out


def bf16_volume(vol, want, control, witness) -> dict:
    """The bf16 export's density volume against the one exported through
    K11's bf16 plain version: every voxel within BF16_ENTRY of max(1, the
    largest density), and the share of voxels beyond TOL of it within
    BF16_SHARE of that share in ``control`` (the fp32 export of the same
    checkpoint): K5's rule (k5_bf16_over) on the share. bf16_columns'
    BF16_FLIP_ROWS, set on seeded fields, refused the trained flagship mip
    field's 256^3 grid at 1.09% of its voxels moved by a rounding flip
    (H100; [K11_bf16]'s seeded field reads 0.40-0.45% at 2^18 grid
    points), while the fp32 export lies beyond TOL on most voxels. Raises.
    ``witness`` (the plain export with every bias scaled by 1 + 2^-22, as
    bf16_witness perturbs): its share beside, the plain version's own
    sensitivity. A voxel's tail fault is not read here, as neighbouring
    voxels hold alike densities ([K11_bf16] reads it on scattered points)."""
    scale = max(1.0, float(np.abs(want).max()))

    def reading(x):
        e = np.abs(x - want) / scale
        return float(e.max()) / BF16_ENTRY, float((e > TOL).mean())

    over, share = reading(vol)
    c_over, c_share = reading(control)
    share_over = share / max(BF16_SHARE * c_share, 1e-30)
    if not (np.isfinite(vol).all() and over <= 1.0 and share_over <= 1.0):
        raise SystemExit(f"the bf16 export's volume disagrees with its bf16 plain version's: "
                         f"its largest error at {over} of BF16_ENTRY, {share} of its voxels "
                         f"beyond TOL ({share_over} of BF16_SHARE of the fp32 export's "
                         f"{c_share})")
    return {"max_abs_err": float(np.abs(vol - want).max()), "err_over_bound": over,
            "flip_voxels": share, "flip_voxels_over_bound": share_over,
            "control_over_bound": c_over, "control_flip_voxels": c_share,
            "witness_flip_voxels": reading(witness)[1]}


def bf16_points(what: str, got, want, control, others=None, varied: bool = True) -> dict:
    """A field forward's bf16 outputs (a row a point) against its bf16 plain
    version: every entry within BF16_ENTRY of its column's scale max(1,
    max |plain|), and the share of rows beyond TOL within BF16_SHARE of
    that share in ``control`` (the fp32 kernel's output on the same
    points): bf16_volume's rule, K5's on the share. A row is one point, so
    a rounding flip that moves a point's output is not averaged away as in
    a ray's composite: K8d's rule rounds the heads' hidden activations, 256
    entries a point with the semantic head, and 1.6% of 2^18 grid points
    moved beyond TOL ([K8_bf16], H100), over bf16_columns' 1% (the fp32
    kernel's output: 99.8%, the other head rule's: 96.6%). Raises; raises
    too if the bounds do not refuse tail_fault(got), unless not ``varied``:
    points near the origin (norm ~2), whose outputs under the default init
    may differ from point to point by less than TOL (the fault's one row
    at 127 points), so that no bound can be required to refuse it. The
    same readings on each of ``others`` (name -> an output)."""
    g, w, c = (t.detach().float().reshape(t.shape[0], -1) for t in (got, want, control))
    scale = w.abs().amax(0).clamp(min=1.0)

    def reading(x):
        e = (x - w).abs() / scale
        return float(e.max()) / BF16_ENTRY, float((e > TOL).any(1).float().mean())

    over, share = reading(g)
    c_over, c_share = reading(c)
    bound = max(BF16_SHARE * c_share, 1e-30)
    fault = reading(tail_fault(g))
    finite = bool(torch.isfinite(g).all())
    refused = max(fault[0], fault[1] / bound) > 1.0 or not varied
    if not (finite and over <= 1.0 and share <= bound and refused):
        raise SystemExit(f"{what} at bf16 disagrees with its bf16 plain version: its largest "
                         f"error at {over} of BF16_ENTRY, {share} of its rows beyond TOL (bound "
                         f"{bound}: BF16_SHARE of the fp32 kernel's {c_share}), finite={finite}; "
                         f"or the bounds do not refuse a tail fault ({fault})")
    out = {"max_abs_err": float((g - w).abs().max()), "err_over_bound": over,
           "flip_rows": share, "flip_rows_over_bound": share / bound,
           "control_over_bound": c_over, "control_flip_rows": c_share,
           "tail_fault_over_bound": fault[0], "tail_fault_flip_rows_over_bound": fault[1] / bound}
    for name, x in (others or {}).items():
        o, sh = reading(x.detach().float().reshape(g.shape))
        out[f"{name}_over_bound"], out[f"{name}_flip_rows_over_bound"] = o, sh / bound
    return out


def mip_bf16_paths(fr, ff) -> dict:
    """The --mipnerf paths at --compute_dtype bfloat16, each with the bf16
    counts of its kernels set to 0 just before and read just after, and no
    fp32 launch: [mip_train_bf16] ``run_nerf.main`` with mip_args' flags,
    MIP_STEPS steps from the seed (K10a and K10b twice a step, K9 in the
    final eval), the loss finite and falling, the last step's two K10b calls
    against their bf16 plain version (bf16_leaves beside bf16_witness) and
    a second call, bitwise; [mip_eval_bf16] ``--eval`` on the 378x504 test
    view from that run's checkpoint (K9 twice a ray block), its seconds
    beside the same view's at fp32 from the same checkpoint run just
    before, finite metrics, the view's last two K9 calls against their bf16
    plain version (bf16_columns) and a second call, bitwise;
    [eval_vol_bf16] ``--eval_vol`` on that checkpoint (K11 64 times), the
    volume against the export with K11's bf16 plain version in the kernel's
    place (bf16_columns), its seconds beside the fp32 export's of the same
    checkpoint. Returns the bf16 launches of K9 (the view), K10a, K10b (the
    train run) and K11 (the export)."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.engines import checkpoint as ckpt_lib
    from nerfsos_torch.engines import eval as eval_lib
    from nerfsos_torch.utils import io as io_utils

    bf = torch.bfloat16
    bf16_flags = ("--compute_dtype", "bfloat16", "--expname", "smoke_mip_bf16")
    counted = {**MIP_COUNTS, "K11": "fused_mip_field_apply"}

    def zero():
        for k, n in counted.items():
            w = getattr(ff if k == "K11" else fr, n)
            w.launches = w.launches_bf16 = 0

    def read(what):
        f32 = {k: getattr(ff if k == "K11" else fr, n).launches for k, n in counted.items()}
        if any(f32.values()):
            raise SystemExit(f"the bf16 {what} launched fp32 kernels: {f32}")
        return {k: getattr(ff if k == "K11" else fr, n).launches_bf16 for k, n in counted.items()}

    zero()
    rec = run_train(fr, mip_args(MIP_STEPS, *bf16_flags), MIP_COUNTS, ["mip_train_render_grads"],
                    MIP_STEPS - 1)
    launches = read("mip train run")
    losses = rec["losses"]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    phase("mip_train_bf16", steps=len(losses), views=f"8x{H_VIEW}x{W_VIEW}",
          seconds_incl_load_and_eval=rec["seconds"], launches=launches, loss_first10=first,
          loss_last10=last)
    if (rec["steps"] != list(range(MIP_STEPS)) or launches["K10a"] != 2 * MIP_STEPS
            or launches["K10b"] != 2 * MIP_STEPS or launches["K9"] < 1):
        raise SystemExit(f"the bf16 mip train run did not go through the bf16 kernels as "
                         f"expected: steps {rec['steps']}, launches {launches}")
    if not (all(math.isfinite(x) for x in losses) and last < first):
        raise SystemExit(f"bf16 mip train loss not finite or not falling: {losses}")
    run_dir = os.path.join(WORK, "logs", "smoke_mip_bf16")
    check_final_eval(run_dir)
    out = {"K10a": launches["K10a"], "K10b": launches["K10b"]}
    checks = {}
    for (field, odvr, z, dmaps, dweights), kw, got in rec["calls"]["mip_train_render_grads"]:
        part = "coarse" if z.shape[1] == 64 else "fine"

        def plain(f):
            return fr.mip_train_render_grads_plain(f, odvr, z, dmaps, dweights, **kw)

        want = plain(field)
        again = fr.mip_train_render_grads(field, odvr, z, dmaps, dweights, **kw)
        if kw["compute_dtype"] != bf or not all(torch.equal(got[k], again[k]) for k in got):
            raise SystemExit(f"K10b at step {MIP_STEPS - 1} ({part}): not bf16, or two calls "
                             "differ")
        checks[part] = bf16_leaves(f"K10b at step {MIP_STEPS - 1} ({part})", got, want,
                                   bf16_witness(plain, field, want))
    if len(checks) != 2:
        raise SystemExit(f"captured {len(rec['calls']['mip_train_render_grads'])} K10b calls of "
                         f"step {MIP_STEPS - 1}")
    phase("mip_train_bf16_k10b", step=MIP_STEPS - 1, **checks)
    del rec

    ckpt = os.path.join(run_dir, "checkpoints", "last.ckpt")
    os.remove(os.path.join(run_dir, "eval", "log.json"))  # the train run's final eval wrote one
    os.makedirs(os.path.join(WORK, "logs", "smoke_mip_fp32"), exist_ok=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_nerf.main(mip_args(0, "--eval", "--expname", "smoke_mip_fp32", "--ckpt_path", ckpt))
    torch.cuda.synchronize()
    fp32_seconds = time.perf_counter() - t0
    args = mip_args(0, "--eval", *bf16_flags)
    zero()
    cap = Capture(fr, ["fused_mip_render"])
    cap.on = True
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_nerf.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        cap.close()
    launches = read("--eval --mipnerf")
    blocks = -(-H_VIEW * W_VIEW // args.ray_chunk)
    log = check_final_eval(run_dir)
    if launches["K9"] != 2 * blocks:
        raise SystemExit(f"the bf16 --eval --mipnerf launched K9 {launches} times, not 2 x "
                         f"{blocks}")
    checks = {}
    for (field, odvr, z, dtype), _, got in cap.calls["fused_mip_render"][-2:]:
        part = "coarse" if z.shape[1] == args.N_samples else "fine"
        with torch.no_grad():
            want = fr.mip_render_plain(field, odvr, z, dtype)
            control = fr.fused_mip_render(field, odvr, z)
            again = fr.fused_mip_render(field, odvr, z, dtype)
        if dtype != bf or not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise SystemExit("the bf16 mip eval view's K9: not bf16, or two calls differ")
        checks[part] = {n: bf16_columns(f"K9 {n} on the bf16 mip eval view ({part})", got[i],
                                        want[i], control[i])
                        for i, n in enumerate(("maps", "weights"))}
    phase("mip_eval_bf16", view=f"{H_VIEW}x{W_VIEW}", seconds=seconds, fp32_seconds=fp32_seconds,
          launches={"K9": launches["K9"]}, ray_blocks=blocks, psnr=log["total_psnr"],
          ssim=log["total_ssim"], last_calls=checks, deterministic=True)
    out["K9"] = launches["K9"]
    del cap

    args = mip_args(0, "--eval_vol", *bf16_flags)
    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_nerf.main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read("--eval_vol --mipnerf")
    side = int(args.vol_extents[0] / args.vol_size)
    chunks = -(-side**3 // EXPORT_CHUNK)
    vol = io_utils.read_mrc(os.path.join(run_dir, "eval", "density.mrc"))
    if launches["K11"] != chunks or vol.shape != (side,) * 3:
        raise SystemExit(f"the bf16 --eval_vol --mipnerf launched K11 {launches} times, not "
                         f"{chunks}, or wrote a volume of {vol.shape}")
    state = ckpt_lib.load_checkpoint(ckpt)[0]
    nets = {}
    for dtype in ("bfloat16", "float32"):
        nets[dtype] = run_nerf.build_model(mip_args(0, "--compute_dtype", dtype),
                                           torch.device("cuda"))[0]
        nets[dtype].load_state_dict(state)
    nets["witness"] = nudged(nets["bfloat16"])
    secs, vols = {}, {}
    saved = ff.fused_mip_field_apply
    for path, net in (("fp32", nets["float32"]), ("bf16", nets["bfloat16"]),
                      ("plain", nets["bfloat16"]), ("witness", nets["witness"])):
        if path in ("plain", "witness"):  # K11's bf16 plain version in the kernel's place
            ff.fused_mip_field_apply = lambda f, m, c, d, dt: ff.mip_field_plain(f, m, c, d, dt)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vols[path] = eval_lib.export_density(net, extents=(args.vol_extents[0],) * 3,
                                                 voxel_size=args.vol_size)
            torch.cuda.synchronize()
            secs[path] = time.perf_counter() - t0
        finally:
            ff.fused_mip_field_apply = saved
    close = bf16_volume(vol, vols["plain"], vols["fp32"], vols["witness"])
    if not np.array_equal(vol, vols["bf16"]):
        raise SystemExit("the bf16 --eval_vol --mipnerf volume differs from a second export")
    phase("eval_vol_bf16", field="mip", grid=vol.shape, seconds=seconds,
          launches={"K11": launches["K11"]}, export_s=secs["bf16"], export_fp32_s=secs["fp32"],
          export_plain_s=secs["plain"], volume=close, deterministic=True)
    out["K11"] = launches["K11"]
    return out


def mip_step_bf16_timings(fr) -> None:
    """[mip_bf16_step]: the mip train step (mip_args' flags; grads and Adam,
    CUDA events) at bf16 and at fp32 in turns (fp32, bf16, bf16, fp32) on
    the same weights and batch, at 1024 rays (10 steps a turn) and 16384
    rays (3), with peak memory and each dtype's bound."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.data.datasets import RayDataset
    from nerfsos_torch.engines import state as state_lib
    from nerfsos_torch.engines.trainer import make_rgb_train_step

    dataset = RayDataset(os.path.join(WORK, "data"), split="train")
    test = RayDataset(os.path.join(WORK, "data"), split="test")
    steps = {}
    for name, dtype in (("fp32", "float32"), ("bf16", "bfloat16")):
        args = mip_args(0, "--compute_dtype", dtype)
        net, _ = run_nerf.build_model(args, torch.device("cuda"))
        opt = state_lib.make_optimizer(net, args.lrate)
        steps[name] = make_rgb_train_step(
            net, opt, state_lib.exp_decay_schedule(args.lrate, args.decay_rate,
                                                   args.decay_step * 1000),
            *test.near_far(), args.rgb_w, args.seed, net_kwargs={"radii": test.radii()})
    per_ray = (2 * args.N_samples - 2 + args.N_importance) * field_flops(net.mip, "k3")
    for R, reps in ((1024, 10), (16384, 2)):
        b = dataset.sample_batch(np.random.default_rng(R), R)
        batch = {k: torch.as_tensor(b[k], device="cuda") for k in ("rays", "target")}
        for name in ("fp32", "bf16", "bf16", "fp32"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: steps[name](batch, 0), reps=reps, warmup=1)
            rate = BF16_FLOP_S if name == "bf16" else FP32_MMA_FLOP_S
            phase("mip_bf16_step", compute_dtype=name, rays=R, steps=reps, ms=ms,
                  rays_per_s=R / ms * 1e3, bound_ms=R * per_ray / rate * 1e3,
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30)


# ----------------------------------------------------------------- the field kernels at bf16

NOIMP_BF16_COUNTS = {"K8d": "field_forward", "K8f": "field_grads", "K8e": "fused_sigma_apply"}


def zero_field_counts(ff) -> None:
    """Every count of the classic field wrappers (fp32 and bf16, the
    input-gradient mode's and K8b's head rule's too) set to 0."""
    for name in NOIMP_BF16_COUNTS.values():
        w = getattr(ff, name)
        w.launches = w.launches_bf16 = 0
    ff.field_grads.input_grad_launches = ff.field_grads.input_grad_launches_bf16 = 0
    ff.field_forward.launches_bf16_f32_heads = 0


def read_field_counts(ff, what: str) -> dict:
    """The classic field wrappers' bf16 counts (K8b: the field forward's
    under its head rule; K8c: the input-gradient mode's); raises if any
    fp32 launch was counted."""
    f32 = {k: getattr(ff, n).launches for k, n in NOIMP_BF16_COUNTS.items()}
    if any(f32.values()) or ff.field_grads.input_grad_launches:
        raise SystemExit(f"the bf16 {what} launched fp32 field kernels: {f32}")
    out = {k: getattr(ff, n).launches_bf16 for k, n in NOIMP_BF16_COUNTS.items()}
    out["K8b"] = ff.field_forward.launches_bf16_f32_heads
    out["K8c"] = ff.field_grads.input_grad_launches_bf16
    return out


def noimp_points(R: int, S: int, seed: int):
    """The points and unit directions ``[R * S, 3]`` of ``ray_inputs``' rays."""
    odv, z = ray_inputs(R, S, seed=seed)
    pts = (odv[:, None, 0:3] + odv[:, None, 3:6] * z[..., None]).reshape(-1, 3).contiguous()
    return pts, odv[:, None, 6:9].expand(R, S, 3).reshape(-1, 3).contiguous()


def kernel_vs_plain_k8_bf16(ff) -> dict:
    """[K8_bf16]: the classic field forwards' bf16 modes at the flagship
    width (8 x 256, multires 10/4, the semantic head with coordinates):
    the sigma forward (K8a/K8e) on 2^18 points of the x14 grid (an export
    chunk) and on 32768 x 64 points of rays (a noisy density-only view's
    coarse call), the field forward under K8b's head rule (f32_heads) and
    under K8d's on 2^18 grid points and on 1024 x 64 points of rays (the
    --N_importance 0 step's call); each also on 4097 points near the origin
    (norm ~2, bf16_points not ``varied``: no tail fault read there is
    required to be refused). Each against its bf16 plain version
    (bf16_points), beside the readings of the fp32 kernel's output, of the
    plain version on the field nudged both ways (``nudged``: its rounding
    flips alone) and, for a head rule, of the other rule's kernel output on
    the same inputs; two calls bitwise equal; timed beside the same call's
    fp32 kernel and the bf16 bound, with the launch's ring stages, tiles a
    CTA and ptxas line. Returns the kernels line's numbers: K8a at 32768 x
    64, K8b at 2^18, K8d at 1024 x 64. Held by bf16_points (a row a
    point)."""
    bf = torch.bfloat16
    field = seeded_field(41, net_depth=8, net_width=256, multires=10, multires_views=4,
                         use_semantics=True, sem_with_coord=True, sem_dim=2)
    out = {}

    def check(name, run, plain, run32, cost, design, others=None, varied=True, **fields):
        with torch.no_grad():
            got, again, want, control = run(), run(), plain(field), run32()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise SystemExit(f"{name} at bf16 ({fields}): two calls differ")
            beside = {f"witness{sign:+.0f}": plain(nudged(field, sign)) for sign in (1.0, -1.0)}
            beside.update({k: f() for k, f in (others or {}).items()})
            close = bf16_points(f"{name} ({fields})", got, want, control, beside, varied)
            del got, again, want, control, beside
            ms, ms32 = cuda_ms(run), cuda_ms(run32)
            plain_ms = cuda_ms(lambda: plain(field), reps=3)
        phase("K8_bf16", kernel=name, **fields, **close, deterministic=True, ms=ms, fp32_ms=ms32,
              plain_ms=plain_ms, **cost, **design)
        return {"max_abs_err": close["max_abs_err"], "ms": ms, "plain_ms": plain_ms, **cost,
                "library_ms": None}

    N = FIELD_POINTS
    shapes = {"grid": (grid_points(N, 50), unit_dirs(N, 51))}
    shapes["rays"] = noimp_points(1024, 64, seed=46)
    near = torch.randn(4097, 3, generator=torch.Generator().manual_seed(52)).mul(2.0).cuda()
    shapes["near"] = (near, unit_dirs(4097, 53))
    for where, (pts, dirs) in shapes.items():
        n = pts.shape[0]
        for rule, heads in (("K8b", True), ("K8d", False)):
            other = "K8d" if heads else "K8b"
            res = check(
                "field forward", lambda: ff.field_forward(field, pts, dirs, bf, heads),
                lambda f: ff.field_plain(f, pts, dirs, bf, heads),
                lambda: ff.field_forward(field, pts, dirs),
                field_cost(field, n, "field", bf16=True),
                field_design(ff, field, n, 3, bf16=True, f32_heads=heads),
                {f"{other}_rule": lambda: ff.field_forward(field, pts, dirs, bf, not heads)},
                where != "near", points=n, where=where, head_rule=rule)
            if (where, rule) in (("grid", "K8b"), ("rays", "K8d")):
                out[rule] = res
    sig = {"grid": shapes["grid"][0], "rays": noimp_points(32768, 64, seed=47)[0], "near": near}
    del shapes
    for where, pts in sig.items():
        n = pts.shape[0]
        res = check("sigma forward", lambda: ff.fused_sigma_apply(field, pts, bf),
                    lambda f: ff.sigma_plain(f, pts, bf), lambda: ff.fused_sigma_apply(field, pts),
                    field_cost(field, n, "sigma", bf16=True),
                    field_design(ff, field, n, 4, bf16=True), varied=where != "near", points=n,
                    where=where)
        if where == "rays":
            out["K8a"] = res
    return out


def unrounded_g_fault(ff, run):
    """``run()`` with the field backward's bf16 plain version leaving the
    cotangent g unrounded: the fault of a backward that skips g's rounding
    (its bias sums and products then read fp32 values)."""
    saved = ff.round_bf16
    ff.round_bf16 = lambda x: x
    try:
        return run()
    finally:
        ff.round_bf16 = saved


def kernel_vs_plain_k8_bwd_bf16(ff) -> dict:
    """[K8_bwd_bf16]: the field backward's bf16 mode at the --N_importance 0
    step's size (1024 rays x 64 samples of ``ray_inputs``, the [K8_bwd]
    phase's field and cotangent), weights only (K8f) and with dpts/ddirs
    (K8c): every leaf (and K8c's dpts and ddirs as two leaves more) against
    the bf16 plain version (bf16_leaves beside bf16_witness), beside the
    readings of the fp32 kernel's output and of the plain version with g
    left unrounded (unrounded_g_fault); two calls bitwise equal; timed
    beside the same call's fp32 kernel and the bf16 bound, with its
    forward/reverse split. Then [K8_bwd_bf16_planes]: the same call (one
    wave of chunks) through fused_field._field_grads_launch, its stored
    planes and its sweep held by bf16_planes (the unrounded gate fault's
    reading beside). Returns the kernels line's numbers."""
    from nerfsos_torch.ops import fused_render as fr

    bf = torch.bfloat16
    field = seeded_field(43, net_depth=8, net_width=256, multires=10, multires_views=4,
                         use_semantics=True, sem_with_coord=True, sem_dim=2)
    pts, dirs = noimp_points(1024, 64, seed=44)
    N = pts.shape[0]
    g = torch.from_numpy(np.random.default_rng(45).normal(size=(N, 6)).astype(np.float32)).cuda()
    out = {}
    for input_grads in (False, True):
        kernel = "K8c" if input_grads else "K8f"

        def run(dtype=bf):
            return ff.field_grads(field, pts, dirs, g, input_grads=input_grads,
                                  compute_dtype=dtype)

        def plain(f):
            return ff.field_grads_plain(f, pts, dirs, g, input_grads=input_grads,
                                        compute_dtype=bf)

        def leaves(res):  # the grads, and K8c's dpts and ddirs as two leaves more
            grads, dp, dd = res
            return {**grads, **({"dpts": dp, "ddirs": dd} if input_grads else {})}

        zero_field_counts(ff)
        got, again = leaves(run()), leaves(run())
        launches = read_field_counts(ff, kernel)
        if launches != {"K8d": 0, "K8f": 2, "K8e": 0, "K8b": 0, "K8c": 2 * input_grads}:
            raise SystemExit(f"{kernel} at bf16: two calls counted {launches}")
        control = leaves(run(torch.float32))
        want = leaves(plain(field))
        witness = bf16_witness(lambda f: leaves(plain(f)), field, want)
        fault = leaves(unrounded_g_fault(ff, lambda: plain(field)))
        torch.cuda.synchronize()
        if not all(torch.equal(got[k], again[k]) for k in got):
            raise SystemExit(f"{kernel} at bf16: two calls differ")
        close = bf16_leaves(kernel, got, want, witness, {"control": control, "fault": fault})
        del again, want, fault
        ms, ms32 = cuda_ms(run), cuda_ms(lambda: run(torch.float32))
        plain_ms = cuda_ms(lambda: plain(field), reps=3)
        cost = field_cost(field, N, "bwd", input_grads, bf16=True)
        split = forward_split(run, f"{kernel}_bf16")
        phase("K8_bwd_bf16", mode=kernel, points=N, launches=launches, **close,
              deterministic=True, ms=ms, fp32_ms=ms32, plain_ms=plain_ms, **split, **cost)
        out[kernel] = {"max_abs_err": close["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
                       **cost, "library_ms": None}
        flat, dp, dd, launch = ff._field_grads_launch(field, pts, dirs, g, input_grads, True)
        planes = bf16_planes(fr, kernel, field, fr.unpack_grads(field, flat, True), launch,
                             None, None, True,
                             {"control": lambda sweep: control,
                              "fault": lambda sweep: unrounded_gate_fault(fr, sweep)},
                             points=(pts, dirs), inputs=(dp, dd) if input_grads else None)
        phase("K8_bwd_bf16_planes", mode=kernel, points=N, **planes)
        del launch, control, got
    return out


def bf16_classic_export(ff) -> int:
    """[eval_vol_bf16] with the classic field: ``run_nerf.main --eval_vol
    --compute_dtype bfloat16`` on the [eval] phase's seeded flagship .ckpt
    (the fine field at a 256^3 grid, 64 chunks): the field forward's count
    under K8b's head rule (``launches_bf16_f32_heads``), set to 0 just
    before, reads 64 just after, and no other field kernel (K8d's rule
    included) and no fp32 launch is counted; the volume against the export
    with the field forward's bf16 plain version in the kernel's place,
    called with the same rule (bf16_volume, the fp32 export and the plain
    export on the nudged net beside), bitwise equal to a second export, its
    seconds beside the fp32 and the plain exports'. Returns K8b's
    launches."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.engines import checkpoint as ckpt_lib
    from nerfsos_torch.engines import eval as eval_lib
    from nerfsos_torch.utils import io as io_utils

    args = eval_args("--eval_vol", "--compute_dtype", "bfloat16", "--expname", "smoke_vol_bf16")
    zero_field_counts(ff)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_nerf.main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_field_counts(ff, "classic --eval_vol")
    side = int(args.vol_extents[0] / args.vol_size)
    chunks = -(-side**3 // EXPORT_CHUNK)
    vol = io_utils.read_mrc(os.path.join(WORK, "logs", "smoke_vol_bf16", "eval", "density.mrc"))
    if (launches != {"K8d": 0, "K8f": 0, "K8e": 0, "K8b": chunks, "K8c": 0}
            or vol.shape != (side,) * 3):
        raise SystemExit(f"the bf16 classic --eval_vol launched {launches}, not K8b's head rule "
                         f"{chunks} times alone, or wrote a volume of {vol.shape}")
    state = ckpt_lib.load_checkpoint(os.path.join(WORK, "seeded.ckpt"))[0]
    nets = {}
    for dtype in ("bfloat16", "float32"):
        nets[dtype] = run_nerf.build_model(eval_args("--compute_dtype", dtype),
                                           torch.device("cuda"))[0]
        nets[dtype].load_state_dict(state)
        nets[dtype].eval()
    nets["witness"] = nudged(nets["bfloat16"])
    secs, vols = {}, {}
    saved = ff.field_forward
    for path, net in (("fp32", nets["float32"]), ("bf16", nets["bfloat16"]),
                      ("plain", nets["bfloat16"]), ("witness", nets["witness"])):
        if path in ("plain", "witness"):  # the bf16 plain version in the kernel's place
            ff.field_forward = lambda f, p, d, cd, f32_heads=False: ff.field_plain(f, p, d, cd,
                                                                                   f32_heads)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                vols[path] = eval_lib.export_density(net, extents=(args.vol_extents[0],) * 3,
                                                     voxel_size=args.vol_size)
            torch.cuda.synchronize()
            secs[path] = time.perf_counter() - t0
        finally:
            ff.field_forward = saved
    close = bf16_volume(vol, vols["plain"], vols["fp32"], vols["witness"])
    if not np.array_equal(vol, vols["bf16"]):
        raise SystemExit("the bf16 classic --eval_vol volume differs from a second export")
    phase("eval_vol_bf16", field="classic", grid=vol.shape, seconds=seconds,
          launches=launches, export_s=secs["bf16"], export_fp32_s=secs["fp32"],
          export_plain_s=secs["plain"], volume=close, deterministic=True)
    return launches["K8b"]


def train_noimp_bf16_path(fr, ff) -> dict:
    """[train_noimp_bf16]: the [train_noimp] run (configs/flower_full.txt's
    flags, --N_importance 0) at --compute_dtype bfloat16, TRAIN_STEPS steps
    from the seed. The field kernels' counts, fp32 and bf16, set to 0 just
    before: the bf16 backward (K8f) once a step, the bf16 forward (K8d)
    once a step and once a ray block of the final eval, no fp32 launch, no
    K8c, K8e or K1-K4; the loss finite and falling; the last step's K8f call
    against its bf16 plain version (bf16_leaves beside bf16_witness) and a
    second call, bitwise. Returns the bf16 launches."""
    bf = torch.bfloat16
    args = train_args(os.path.join(WORK, "data"), os.path.join(WORK, "logs"), TRAIN_STEPS,
                      expname="smoke_noimp_bf16",
                      extra=("--N_importance", "0", "--compute_dtype", "bfloat16"))
    other = {n: getattr(fr, n).launches_bf16 for n in (*TRAIN_COUNTS.values(), "train_render")}
    zero_field_counts(ff)
    rec = run_train(fr, args, NOIMP_BF16_COUNTS, ["field_grads"], TRAIN_STEPS - 1, mod=ff)
    launches, losses = read_field_counts(ff, "--N_importance 0 run"), rec["losses"]
    blocks = -(-H_VIEW * W_VIEW // args.ray_chunk)
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    phase("train_noimp_bf16", steps=len(losses), views=f"8x{H_VIEW}x{W_VIEW}",
          seconds_incl_load_and_eval=rec["seconds"], launches=launches, eval_ray_blocks=blocks,
          loss_first10=first, loss_last10=last)
    if rec["steps"] != list(range(TRAIN_STEPS)):
        raise SystemExit(f"the bf16 --N_importance 0 run ran steps {rec['steps']}")
    if (launches != {"K8d": TRAIN_STEPS + blocks, "K8f": TRAIN_STEPS, "K8e": 0, "K8b": 0, "K8c": 0}
            or any(getattr(fr, n).launches_bf16 != c for n, c in other.items())):
        raise SystemExit(f"the bf16 --N_importance 0 run did not go through the bf16 field "
                         f"kernels alone: {launches}")
    if not (all(math.isfinite(x) for x in losses) and last < first):
        raise SystemExit(f"the bf16 --N_importance 0 loss is not finite or not falling: {losses}")
    log = check_final_eval(os.path.join(WORK, "logs", "smoke_noimp_bf16"))
    calls = rec["calls"]["field_grads"]
    if len(calls) != 1:
        raise SystemExit(f"captured {len(calls)} K8f calls of step {TRAIN_STEPS - 1}")
    (field, pts, dirs, g), kw, got = calls[0]

    def plain(f):
        return ff.field_grads_plain(f, pts, dirs, g, **kw)[0]

    want = plain(field)
    again = ff.field_grads(field, pts, dirs, g, **kw)[0]
    if kw.get("compute_dtype") != bf or not all(torch.equal(got[0][k], again[k]) for k in again):
        raise SystemExit(f"K8f at step {TRAIN_STEPS - 1}: not bf16, or two calls differ")
    close = bf16_leaves(f"K8f at step {TRAIN_STEPS - 1}", got[0], want,
                        bf16_witness(plain, field, want))
    phase("train_noimp_bf16_k8f", step=TRAIN_STEPS - 1, points=pts.shape[0],
          psnr=log["total_psnr"], ssim=log["total_ssim"], **close)
    return launches


def noimp_bf16_step_timings() -> None:
    """[noimp_bf16_step]: the --N_importance 0 RGB step (the [noimp_step]
    flags; autograd through the field forward and backward, then Adam, CUDA
    events) at bf16 and at fp32 in turns (fp32, bf16, bf16, fp32) on the
    same weights and batch, at 1024 rays (15 steps a turn) and 16384 rays
    (3), with peak memory and each dtype's bound."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.data.datasets import RayDataset
    from nerfsos_torch.engines import state as state_lib
    from nerfsos_torch.engines.trainer import make_rgb_train_step

    dataset = RayDataset(os.path.join(WORK, "data"), split="train")
    steps = {}
    for name, dtype in (("fp32", "float32"), ("bf16", "bfloat16")):
        args = train_args(os.path.join(WORK, "data"), os.path.join(WORK, "logs"), 0,
                          extra=("--N_importance", "0", "--compute_dtype", dtype))
        net, _ = run_nerf.build_model(args, torch.device("cuda"))
        opt = state_lib.make_optimizer(net, args.lrate)
        steps[name] = make_rgb_train_step(
            net, opt, state_lib.exp_decay_schedule(args.lrate, args.decay_rate,
                                                   args.decay_step * 1000),
            *dataset.near_far(), args.rgb_w, args.seed)
    per_ray = args.N_samples * (field_flops(net.nerf, "k2") + field_bwd_flops(net.nerf, False))
    for R, reps in ((1024, 15), (16384, 3)):
        b = dataset.sample_batch(np.random.default_rng(R), R)
        batch = {k: torch.as_tensor(b[k], device="cuda") for k in ("rays", "target")}
        for name in ("fp32", "bf16", "bf16", "fp32"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: steps[name](batch, 0), reps=reps, warmup=1)
            rate = BF16_FLOP_S if name == "bf16" else FP32_MMA_FLOP_S
            phase("noimp_bf16_step", compute_dtype=name, rays=R, steps=reps, ms=ms,
                  rays_per_s=R / ms * 1e3, bound_ms=R * per_ray / rate * 1e3,
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def sigma_noise_bf16_path(ff) -> dict:
    """[sigma_noise_bf16]: the [sigma_noise] view (the [eval] phase's seeded
    flagship .ckpt, ``forward(..., coarse_outputs=False, raw_noise_std=1.0)``)
    at --compute_dtype bfloat16: the bf16 sigma (K8e) and field (K8d)
    kernels once a ray block, no fp32 launch (counts set to 0 just before);
    the view's last K8e and K8d calls against their bf16 plain versions on
    their own inputs (bf16_points, the fp32 kernels' outputs beside) and a
    second call, bitwise; the seconds of the bf16 view, of the fp32 view
    and of the view with both wrappers' bf16 plain versions in the kernels'
    place (the same noise), and the bf16 view's rgb distance from those two
    beside (a flip in a coarse density moves the fine pass's importance
    samples, so the views are not held to each other, as [eval_bf16]).
    Returns the bf16 launches."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.data.datasets import RayDataset
    from nerfsos_torch.engines import checkpoint as ckpt_lib

    bf = torch.bfloat16
    state, _, _ = ckpt_lib.load_checkpoint(os.path.join(WORK, "seeded.ckpt"))
    nets = {}
    for dtype in ("bfloat16", "float32"):
        nets[dtype] = run_nerf.build_model(eval_args("--eval", "--compute_dtype", dtype),
                                           torch.device("cuda"))[0]
        nets[dtype].load_state_dict(state)
        nets[dtype].eval()
    dataset = RayDataset(os.path.join(WORK, "data"), split="test")
    rays = torch.as_tensor(dataset.get_view(0)["rays"], device="cuda")
    near_far = dataset.near_far()
    blocks = -(-H_VIEW * W_VIEW // nets["bfloat16"].cfg.ray_block)
    plain = {"fused_sigma_apply": lambda f, p, cd=torch.float32: ff.sigma_plain(f, p, cd),
             "field_forward": lambda f, p, d, cd=torch.float32, f32_heads=False:
             ff.field_plain(f, p, d, cd, f32_heads)}
    out, secs, launches, calls = {}, {}, None, None
    for path, net in (("bf16", nets["bfloat16"]), ("plain", nets["bfloat16"]),
                      ("fp32", nets["float32"])):
        saved = {n: getattr(ff, n) for n in plain} if path == "plain" else {}
        for n in saved:
            setattr(ff, n, plain[n])
        if path == "bf16":
            zero_field_counts(ff)
            cap = Capture(ff, list(plain))
            cap.on = True
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                out[path] = net(rays, near_far, train=False, coarse_outputs=False,
                                raw_noise_std=1.0,
                                generator=torch.Generator(device="cuda").manual_seed(7))
            torch.cuda.synchronize()
            secs[path] = time.perf_counter() - t0
        finally:
            for n, f in saved.items():
                setattr(ff, n, f)
            if path == "bf16":
                cap.close()
                launches, calls = read_field_counts(ff, "noisy density-only view"), cap.calls
    if launches != {"K8d": blocks, "K8f": 0, "K8e": blocks, "K8b": 0, "K8c": 0}:
        raise SystemExit(f"the bf16 noisy density-only view launched {launches}, not the bf16 "
                         f"sigma and field kernels once each of {blocks} ray blocks")
    if not all(torch.isfinite(v).all() for v in out["bf16"].values()):
        raise SystemExit("the bf16 noisy density-only view is not finite")
    checks = {}
    for name, key in (("K8e", "fused_sigma_apply"), ("K8d", "field_forward")):
        if len(calls[key]) != blocks:
            raise SystemExit(f"captured {len(calls[key])} {name} calls of {blocks} ray blocks")
        a, kw, got = calls[key][-1]
        with torch.no_grad():
            again = getattr(ff, key)(*a, **kw)
            want = plain[key](*a, **kw)
            control = getattr(ff, key)(*a[:-1])  # the fp32 kernel on the same inputs
        if a[-1] != bf or not torch.equal(got, again):
            raise SystemExit(f"the bf16 noisy view's {name}: not bf16, or two calls differ")
        checks[name] = dict(points=a[1].shape[0], **bf16_points(
            f"the bf16 noisy view's last {name} call", got, want, control))
    d_rgb = {k: float((out["bf16"]["rgb"] - out[k]["rgb"]).abs().amax(-1).gt(1e-3).float().mean())
             for k in ("plain", "fp32")}
    phase("sigma_noise_bf16", view=f"{H_VIEW}x{W_VIEW}", ray_blocks=blocks, launches=launches,
          seconds=secs["bf16"], fp32_seconds=secs["fp32"], plain_seconds=secs["plain"],
          last_calls=checks, frac_rays_rgb_over_1e_3=d_rgb, deterministic=True)
    return launches


# ----------------------------------------------------------- raw scenes, --no_batching, videos

RAW_LLFF_VIEWS = 12  # the flower scene has 34; 12 keep llffhold 8's two test views
RAW_BLENDER_VIEWS = (8, 2, 2)  # nerf_synthetic's lego has 100, 100, 200
BLENDER_SIZE = 800  # nerf_synthetic's, 400 x 400 at half_res
EXHIBIT_FRAMES = 4  # rays_exhibit.npy cut after preparation (LLFF 120 poses, Blender 40)
NOBATCH_STEPS, NOBATCH_PRECROP = 30, 20  # configs/lego.txt: precrop_iters 500
NOBATCH_STEPS_BF16, NOBATCH_PRECROP_BF16 = 10, 5
VIDEO_STEPS, VIDEO_I_IMG = 4, 3  # --i_img due at step 3, --i_video at step 4


def raw_scene(name: str) -> str:
    return os.path.join(WORK, f"raw_{name}")


def gen_dataset_path() -> dict:
    """[gen_dataset]: two raw scenes of the analytic sphere written with the
    port's PNG writer (data/synthetic), an LLFF one (RAW_LLFF_VIEWS views of
    378 x 504 in images_8/, the flower scene's layout after minification,
    with poses_bounds.npy and masks/) and a Blender one (RGBA 800 x 800,
    RAW_BLENDER_VIEWS train/val/test views, transforms_*.json), each
    prepared by ``python -m nerfsos_torch.data.gen_dataset`` with its
    config's flags (flower_full.txt at --factor 8; lego.txt: half_res,
    white_bkgd, test_skip 8), its seconds and array shapes; rays_exhibit.npy
    is then cut to EXHIBIT_FRAMES frames. The arrays' shapes are checked,
    every ray and colour finite, colours in [0, 1]."""
    from nerfsos_torch.data import synthetic

    t0 = time.perf_counter()
    synthetic.write_llff_scene(raw_scene("llff"), H_VIEW, W_VIEW, RAW_LLFF_VIEWS, factor=8)
    synthetic.write_blender_scene(raw_scene("blender"), BLENDER_SIZE, RAW_BLENDER_VIEWS)
    write_s = time.perf_counter() - t0
    try:
        import PIL  # noqa: F401

        route = "PIL"
    except ImportError:
        route = "numpy"
    configs = os.path.join(ROOT, "configs")
    flags = {"llff": ["--config", os.path.join(configs, "flower_full.txt"), "--data_type", "llff",
                      "--factor", "8"],
             "blender": ["--config", os.path.join(configs, "lego.txt")]}
    n_train = {"llff": RAW_LLFF_VIEWS - 2, "blender": RAW_BLENDER_VIEWS[0]}
    size = {"llff": (H_VIEW, W_VIEW), "blender": (BLENDER_SIZE // 2, BLENDER_SIZE // 2)}
    out = {}
    for name, argv in flags.items():
        root = raw_scene(name)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "nerfsos_torch.data.gen_dataset", *argv,
                               "--data_path", root], cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise SystemExit(f"gen_dataset on the {name} scene failed:\n{proc.stderr[-3000:]}")
        path = os.path.join(root, "rays_exhibit.npy")
        exhibit = np.load(path)
        np.save(path, exhibit[:EXHIBIT_FRAMES])
        shapes = {f[:-4]: list(np.load(os.path.join(root, f), mmap_mode="r").shape)
                  for f in sorted(os.listdir(root))
                  if f.endswith(".npy") and f != "poses_bounds.npy"}
        with open(os.path.join(root, "meta.json")) as f:
            meta = json.load(f)
        H, W = size[name]
        rays, rgbs = np.load(os.path.join(root, "rays_train.npy")), np.load(
            os.path.join(root, "rgbs_train.npy"))
        if (shapes["rays_train"] != [n_train[name], H, W, 2, 3]
                or shapes["rgbs_test"][1:] != [H, W, 3]
                or (meta["H"], meta["W"]) != (H, W) or not np.isfinite(rays).all()
                or not (np.isfinite(rgbs).all() and rgbs.min() >= 0 and rgbs.max() <= 1)):
            raise SystemExit(f"gen_dataset on the {name} scene: shapes {shapes}, meta {meta}")
        phase("gen_dataset", scene=name, seconds=seconds, image_route=route,
              exhibit_frames=f"{exhibit.shape[0]}->{EXHIBIT_FRAMES}", near=meta["near"],
              far=meta["far"], shapes=shapes)
        out[name] = seconds
    phase("gen_dataset_scenes", write_s=write_s,
          llff=f"{RAW_LLFF_VIEWS}x{H_VIEW}x{W_VIEW} images_8",
          blender=f"{'/'.join(map(str, RAW_BLENDER_VIEWS))}x{BLENDER_SIZE}x{BLENDER_SIZE} RGBA")
    return out


def train_nobatch_path(fr, bf16: bool = False) -> dict:
    """[train_nobatch] / [train_nobatch_bf16]: ``run_nerf.main`` with
    configs/lego.txt's flags (--no_batching, 8 x 256 with view directions,
    64 + 128 samples, N_rand 1024, white_bkgd) on the [gen_dataset] Blender
    scene (half_res: 8 train views of 400 x 400), NOBATCH_STEPS steps with
    --precrop_iters NOBATCH_PRECROP (bf16: NOBATCH_STEPS_BF16 and
    NOBATCH_PRECROP_BF16, so that both runs cross the boundary): every
    batch one image's 1024 rays, each of them a ray of the centre crop while
    the step (counted from 1) is below --precrop_iters and not all of them
    after; K3 twice a step at the run's dtype (counts from 0, none at the
    other); the loss finite; the last step's two K3 calls against the
    plain version (fp32: check_k3 with the gate allowance, as [train_k3];
    bf16: as [train_bf16], the maps by bf16_columns and the leaves by
    bf16_leaves on bf16_witness, two calls bitwise equal, with the fp32
    kernel's readings beside). The fp32 run's nets draw the JAX entry
    point's weights (models/seeded), the bf16 run's torch's nn.Linear law,
    the fixtures of every bf16 check ([train_bf16]): on the JAX law's zero
    biases bf16_witness's nudges move nothing (PERF.md §6, the JAX law at
    bf16 in tests/test_torch_cuda.py and tests/bf16_ulp_spread.py)."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.data.datasets import ViewDataset

    name = "train_nobatch_bf16" if bf16 else "train_nobatch"
    steps, precrop = ((NOBATCH_STEPS_BF16, NOBATCH_PRECROP_BF16) if bf16
                      else (NOBATCH_STEPS, NOBATCH_PRECROP))
    argv = ["--config", os.path.join(ROOT, "configs", "lego.txt"), "--expname", name,
            "--basedir", os.path.join(WORK, "logs"), "--data_path", raw_scene("blender"),
            "--max_steps", str(steps), "--precrop_iters", str(precrop), "--precrop_frac", "0.5",
            "--i_print", "10", "--i_weights", str(steps), "--i_testset", "1000000",
            "--fast_mode", *(["--compute_dtype", "bfloat16"] if bf16 else [])]
    args, _ = run_nerf.create_arg_parser().parse_known_args(argv)
    batches, keys = [], {}
    orig = ViewDataset.sample_batch

    def spy(self, rng, batch_size, step=10**9):
        batch = orig(self, rng, batch_size, step=step)
        if "crop" not in keys:  # every ray of the centre crops, as sorted 24-byte keys
            h0, h1, w0, w1 = self.crop()
            crop = np.ascontiguousarray(self._rays[:, h0:h1, w0:w1]).reshape(-1, 6)
            keys["crop"] = np.sort(crop.view(np.dtype((np.void, 24))).ravel())
        k = np.ascontiguousarray(batch["rays"].transpose(1, 0, 2)).reshape(-1, 6).view(
            np.dtype((np.void, 24))).ravel()
        pos = np.minimum(np.searchsorted(keys["crop"], k), len(keys["crop"]) - 1)
        batches.append((step, float((keys["crop"][pos] == k).mean()), batch_size))
        return batch

    count = "launches_bf16" if bf16 else "launches"
    other = "launches" if bf16 else "launches_bf16"
    fr.fused_rgb_train_grads.launches = fr.fused_rgb_train_grads.launches_bf16 = 0
    ViewDataset.sample_batch = spy
    try:
        rec = run_train(fr, args, {}, ["fused_rgb_train_grads"], steps - 1)
    finally:
        ViewDataset.sample_batch = orig
    k3, k3_other = getattr(fr.fused_rgb_train_grads, count), getattr(fr.fused_rgb_train_grads,
                                                                     other)
    losses = rec["losses"]
    inside = [share for step, share, _ in batches if step < precrop]
    after = [share for step, share, _ in batches if step >= precrop]
    phase(name, steps=len(losses), view=f"{BLENDER_SIZE // 2}x{BLENDER_SIZE // 2} (half_res)",
          precrop_iters=precrop,
          seconds_incl_load_and_eval=rec["seconds"], launches={"K3": k3},
          other_dtype_launches={"K3": k3_other}, loss_first=losses[0], loss_last=losses[-1],
          cropped_steps=len(inside), min_crop_share_before=min(inside),
          max_crop_share_after=max(after))
    if ([s for s, _, _ in batches] != list(range(1, steps + 1))
            or any(b != args.batch_size for _, _, b in batches)):
        raise SystemExit(f"{name}: sampled steps/batches {batches}")
    if min(inside) != 1.0 or max(after) == 1.0 or len(inside) != precrop - 1:
        raise SystemExit(f"{name}: a ray outside the centre crop before step {precrop}, or none "
                         f"outside it after: {batches}")
    if k3 != 2 * steps or k3_other != 0:
        raise SystemExit(f"{name}: K3 launched {k3} times at its dtype ({k3_other} at the other), "
                         f"not {2 * steps}")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{name}: loss not finite: {losses}")
    check_final_eval(os.path.join(WORK, "logs", name))
    calls = rec["calls"]["fused_rgb_train_grads"]
    if len(calls) != 2:
        raise SystemExit(f"{name}: captured {len(calls)} K3 calls of step {steps - 1}")
    for field_name, ((field, odv, z, gt), kw, got) in zip(("coarse", "fine"), calls):
        if bf16:
            want = fr.rgb_train_grads_plain(field, odv, z, gt, **kw)
            witness = bf16_witness(lambda f: fr.rgb_train_grads_plain(f, odv, z, gt, **kw)[0],
                                   field, want[0])
            again = fr.fused_rgb_train_grads(field, odv, z, gt, **kw)
            f32 = fr.fused_rgb_train_grads(field, odv, z, gt,
                                           **{**kw, "compute_dtype": torch.float32})
            if kw["compute_dtype"] != torch.bfloat16 or not all(
                    torch.equal(got[0][k], again[0][k]) for k in got[0]):
                raise SystemExit(f"{name} K3 ({field_name}): not bf16, or two calls differ")
            close = {"maps": bf16_columns(f"{name} K3 maps ({field_name})", got[1], want[1],
                                          f32[1]),
                     "leaves": bf16_leaves(f"{name} K3 ({field_name})", got[0], want[0], witness,
                                           {"fp32": f32[0]})}
        else:
            close = check_k3(f"{name} step {steps - 1}, {field_name}", got,
                             *plain_k3_with_gates(field, odv, z, gt, kw))
        phase(f"{name}_k3", step=steps - 1, field=field_name, rays=z.shape[0],
              samples=z.shape[1], white_bkgd=kw.get("white_bkgd"), **close)
    return {"K3": k3, "seconds": rec["seconds"]}


def nobatch_step_timings() -> None:
    """[nobatch_step]: the ``--no_batching`` RGB step (configs/lego.txt's
    flags; grads and Adam, CUDA events) on one 1024-ray batch of a
    [gen_dataset] Blender view past the centre crop, at fp32 and at bf16 in
    turns (fp32, bf16, bf16, fp32), 15 steps a turn, with peak memory and
    each dtype's bound; the nets of the port's default initialisation."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.data.datasets import ViewDataset
    from nerfsos_torch.engines import state as state_lib
    from nerfsos_torch.engines.trainer import make_rgb_train_step

    steps, nets = {}, {}
    for name, dtype in (("fp32", "float32"), ("bf16", "bfloat16")):
        argv = ["--config", os.path.join(ROOT, "configs", "lego.txt"), "--expname", "nobatch_step",
                "--basedir", os.path.join(WORK, "logs"), "--data_path", raw_scene("blender"),
                "--compute_dtype", dtype]
        args, _ = run_nerf.create_arg_parser().parse_known_args(argv)
        dataset = ViewDataset(args.data_path, split="train", precrop_iters=args.precrop_iters,
                              precrop_frac=args.precrop_frac)
        nets[name], _ = run_nerf.build_model(args, torch.device("cuda"))
        opt = state_lib.make_optimizer(nets[name].parameters(), args.lrate)
        steps[name] = make_rgb_train_step(
            nets[name], opt, state_lib.exp_decay_schedule(args.lrate, args.decay_rate,
                                                          args.decay_step * 1000),
            *dataset.near_far(), args.rgb_w, args.seed)
    per_ray = (args.N_samples * field_flops(nets["fp32"].nerf, "k3")
               + (args.N_samples + args.N_importance) * field_flops(nets["fp32"].nerf_fine, "k3"))
    b = dataset.sample_batch(np.random.default_rng(0), args.batch_size, step=args.precrop_iters)
    batch = {k: torch.as_tensor(b[k], device="cuda") for k in ("rays", "target")}
    for name in ("fp32", "bf16", "bf16", "fp32"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: steps[name](batch, 0), reps=15, warmup=1)
        rate = BF16_FLOP_S if name == "bf16" else FP32_MMA_FLOP_S
        phase("nobatch_step", compute_dtype=name, rays=args.batch_size, steps=15, ms=ms,
              rays_per_s=args.batch_size / ms * 1e3, bound_ms=args.batch_size * per_ray / rate * 1e3,
              peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del steps, nets
    torch.cuda.empty_cache()


LAST_GATE_RAYS = 1e-2  # the share of a call's rays last_gate_clear may leave unheld


def last_gate_clear(fr, field, odv, z) -> torch.Tensor:
    """Per ray: whether the density of its last sample (``field``'s plain
    fp32 output before its relu) is clear of 0 by GATE_MARGIN of the
    call's largest such |density|. The last interval is 1e10 long, so a
    density within rounding of 0 that the kernel and the plain version
    round to opposite signs gives that sample an alpha of 1 in one and 0
    in the other: the ray's last weight is its whole transmittance (a ray
    of the JAX-law nets at fixed z: acc 0.556 vs 1.0, H100)."""
    from nerfsos_torch.core.sampling import points_along_rays

    sig = field(points_along_rays(odv[:, 0:3], odv[:, 3:6], z[:, -1:].contiguous()),
                odv[:, 6:9], fr.kernel_dense(torch.float32))[:, 0, 3].abs()
    return sig > GATE_MARGIN * sig.max()


def video_path(fr, bf16: bool = False) -> dict:
    """[video] / [video_bf16]: on the [gen_dataset] LLFF scene at
    configs/flower_full.txt's flags and net (378 x 504 views, 8 x 256, 64 +
    128 samples, the semantic head), a VIDEO_STEPS-step train with --i_img
    due at step VIDEO_I_IMG and --i_video at step VIDEO_STEPS (both once),
    then ``--eval --eval_video`` from its checkpoint; the fp32 run's nets
    draw the JAX entry point's initial weights (models/seeded), the bf16
    run's torch's nn.Linear law, the fixtures of every bf16 check
    ([eval_bf16]; [train_nobatch]'s docstring). Every rendered frame (the
    --i_img view, the exhibit frames of each video, the evals' views) is
    counted: K1 and K2 launch ceil(H W / --ray_chunk) times a frame at the
    run's dtype (counts from 0, none at the other). Every K1 call of the
    --i_img and video frames is held against its plain version (fp32: TOL
    on the rays whose last sample's density is clear of 0, last_gate_clear,
    at most LAST_GATE_RAYS of a call's rays left out and counted; bf16: a
    frame's calls together by bf16_columns, as [eval_bf16] holds K1 and K2,
    the fp32 kernels' readings beside), and every K2 call at fixed z: the
    plain coarse pass's importance samples fed to the kernel and the plain
    version alike (the kernel's own coarse weights put a sample a CDF bin
    apart now and then). The --i_img frame's whole-frame rgb against the plain path's,
    beside the plain path against itself on the field nudged by 1 +- 2^-22
    (tools/render_init_law's reading; information only). Where cv2 or
    imageio is importable every mp4 must exist; where neither is, both runs
    must stop with write_video's error naming both."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.core import sampling
    from nerfsos_torch.engines import eval as eval_lib
    from nerfsos_torch.models.nerf import NeRFNet
    from nerfsos_torch.tools.render_init_law import nudged as nudged_net
    from nerfsos_torch.utils.io import video_writer
    from nerfsos_torch.utils.summary import tensorboard_available

    name = "video_bf16" if bf16 else "video"
    run_dir = os.path.join(WORK, "logs", name)
    writer = video_writer()
    common = ["--config", os.path.join(ROOT, "configs", "flower_full.txt"), "--expname", name,
              "--basedir", os.path.join(WORK, "logs"), "--data_path", raw_scene("llff"),
              "--factor", "8", "--fast_mode", "--ret_cluster",
              *(["--compute_dtype", "bfloat16"] if bf16 else [])]
    runs = {"train": [*common, "--max_steps", str(VIDEO_STEPS), "--i_img", str(VIDEO_I_IMG),
                      "--i_video", str(VIDEO_STEPS), "--i_weights", str(VIDEO_STEPS),
                      "--i_print", str(VIDEO_STEPS), "--i_testset", "1000000"],
            "eval": [*common, "--eval", "--eval_video"]}
    count = "launches_bf16" if bf16 else "launches"
    other = "launches" if bf16 else "launches_bf16"
    wrappers = {"K1": "fused_coarse_weights", "K2": "fused_render"}
    frames, where = [], ["i_img"]
    orig_view, orig_video, orig_eval = (eval_lib.eval_one_view, eval_lib.render_video,
                                        eval_lib.evaluate)

    def launches():
        return {k: getattr(getattr(fr, n), count) for k, n in wrappers.items()}

    def view(render_fn, batch, **kw):
        before, n1, n2 = launches(), len(cap.calls["fused_coarse_weights"]), len(
            cap.calls["fused_render"])
        t0 = time.perf_counter()
        ret, metrics = orig_view(render_fn, batch, **kw)
        seconds = time.perf_counter() - t0  # the frame's arrays are on the host: done
        now = launches()
        frames.append({"where": where[-1], "launches": {k: now[k] - before[k] for k in now},
                       "seconds": seconds,
                       "k1": cap.calls["fused_coarse_weights"][n1:],
                       "k2": cap.calls["fused_render"][n2:],
                       "rays": batch["rays"] if where[-1] == "i_img" else None,
                       "rgb": ret["rgb"] if where[-1] == "i_img" else None})
        if where[-1] not in ("i_img", "video"):  # the evals' views: counted, not held
            frames[-1]["k1"] = frames[-1]["k2"] = []
        return ret, metrics

    def within(label, fn):
        def wrapped(*a, **kw):
            where.append(label)
            try:
                return fn(*a, **kw)
            finally:
                where.pop()
        return wrapped

    for n in wrappers.values():
        getattr(fr, n).launches = getattr(fr, n).launches_bf16 = 0
    cap = Capture(fr, list(wrappers.values()))
    cap.on = True
    eval_lib.eval_one_view = view
    eval_lib.render_video = within("video", orig_video)
    eval_lib.evaluate = within("eval", orig_eval)
    stops, seconds = {}, {}
    try:
        for run, argv in runs.items():
            args, _ = run_nerf.create_arg_parser().parse_known_args(argv)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                run_nerf.main(args)
            except RuntimeError as e:  # write_video's, where no mp4 writer imports
                if writer != "none" or "cv2" not in str(e) or "imageio" not in str(e):
                    raise
                stops[run] = str(e)
            torch.cuda.synchronize()
            seconds[run] = time.perf_counter() - t0
    finally:
        eval_lib.eval_one_view, eval_lib.render_video, eval_lib.evaluate = (
            orig_view, orig_video, orig_eval)
        cap.close()
    stray = {k: getattr(getattr(fr, n), other) for k, n in wrappers.items()}
    total = launches()
    chunk = run_nerf.create_arg_parser().parse_known_args(runs["eval"])[0].ray_chunk
    per_frame = math.ceil(H_VIEW * W_VIEW / chunk)
    kinds = [f["where"] for f in frames]
    expected = (["i_img"] + ["video"] * EXHIBIT_FRAMES + ([] if "train" in stops else ["eval"])
                + ["eval"] + ["video"] * EXHIBIT_FRAMES)
    frame_s = sorted(f["seconds"] for f in frames if f["where"] == "video")
    phase(name, writer=writer, tensorboard=tensorboard_available(), frames=kinds,
          seconds=seconds, video_frame_s_median=frame_s[len(frame_s) // 2] if frame_s else None,
          video_frame_s=[round(x, 3) for x in frame_s], launches=total, other_dtype_launches=stray,
          per_frame=sorted({tuple(f["launches"].values()) for f in frames}),
          stopped={k: v[:120] for k, v in stops.items()})
    if kinds != expected:
        raise SystemExit(f"{name}: rendered frames {kinds}, not {expected}")
    if any(f["launches"] != {"K1": per_frame, "K2": per_frame} for f in frames) or any(
            stray.values()):
        raise SystemExit(f"{name}: K1/K2 launches a frame {[f['launches'] for f in frames]}, "
                         f"other dtype {stray}")
    if writer == "none":
        if set(stops) != {"train", "eval"}:
            raise SystemExit(f"{name}: no mp4 writer, yet the runs did not stop at their videos: "
                             f"{stops}")
    else:
        want = [f"{k}_{s}.mp4" for s in (VIDEO_STEPS, name)
                for k in ("rgb", "disp", "sem", "clus")]
        missing = [f for f in want if not (os.path.exists(os.path.join(run_dir, f))
                                           and os.path.getsize(os.path.join(run_dir, f)) > 0)]
        if stops or missing:
            raise SystemExit(f"{name}: mp4s missing {missing}, stops {stops}")

    # every K1 call of the --i_img and video frames vs plain, every K2 call at fixed z
    worst = {"K1": 0.0, "K2": 0.0}
    held = near_rays = all_rays = 0
    near_err = 0.0
    with torch.no_grad():
        for f in frames:
            frame = {"k1": [], "k1_plain": [], "k1_fp32": [], "k2": [], "k2_plain": [],
                     "k2_fp32": []}
            for (a1, _, w1), (a2, _, _) in zip(f["k1"], f["k2"]):
                field_c, od, z_c, dtype = a1
                field_f, odv, _, _ = a2
                w_plain = fr.coarse_weights_plain(field_c, od, z_c, dtype)
                n_imp = a2[2].shape[1] - z_c.shape[1]
                z_fix, _ = sampling.importance_sample(z_c, w_plain, n_imp, det=True)
                got2 = fr.fused_render(field_f, odv, z_fix, dtype)
                want2 = fr.render_plain(field_f, odv, z_fix, dtype)
                if bf16:  # held as a whole frame below, beside the fp32 kernels
                    for k, v in (("k1", w1), ("k1_plain", w_plain),
                                 ("k1_fp32", fr.fused_coarse_weights(field_c, od, z_c,
                                                                     torch.float32)),
                                 ("k2", got2[0]), ("k2_plain", want2[0]),
                                 ("k2_fp32", fr.fused_render(field_f, odv, z_fix,
                                                             torch.float32)[0])):
                        frame[k].append(v)
                else:
                    # rays whose last sample's density is within rounding of 0
                    # (last_gate_clear) are counted, not held
                    c1, c2 = last_gate_clear(fr, field_c, odv, z_c), last_gate_clear(
                        fr, field_f, odv, z_fix)
                    e1 = max_err(w1[c1], w_plain[c1])
                    e2 = max(max_err(got2[0][c2], want2[0][c2]), max_err(got2[1][c2], want2[1][c2]))
                    near = (~c1).logical_or(~c2)
                    near_rays += int(near.sum())
                    all_rays += near.numel()
                    if near.any():
                        near_err = max(near_err, max_err(w1[~c1], w_plain[~c1]) if (~c1).any()
                                       else 0.0, max_err(got2[0][~c2], want2[0][~c2])
                                       if (~c2).any() else 0.0)
                    if not (torch.isfinite(w1).all() and e1 <= TOL and e2 <= TOL
                            and near.float().mean() <= LAST_GATE_RAYS):
                        col = (got2[0] - want2[0]).abs()
                        ray = int(col.amax(1).argmax())
                        phase(f"{name}_k2_diag", where=f["where"], k1_err=e1, k2_err=e2,
                              near_rays=int(near.sum()), rays=near.numel(),
                              maps_col_err=col.amax(0).tolist(), ray=ray,
                              ray_last_sample_clear=[bool(c1[ray]), bool(c2[ray])],
                              kernel_maps=got2[0][ray].tolist(),
                              plain_maps=want2[0][ray].tolist())
                        raise SystemExit(f"{name}: a {f['where']} frame's K1 ({e1}) or K2 at fixed "
                                         f"z ({e2}) disagrees with its plain version (tol {TOL}) on "
                                         f"rays whose last density is clear of 0, or "
                                         f"{int(near.sum())} of {near.numel()} rays are not clear")
                    worst["K1"], worst["K2"] = max(worst["K1"], e1), max(worst["K2"], e2)
                held += 1
                del got2, want2, w_plain, z_fix
            if bf16 and frame["k1"]:
                # the frame's rays in a seeded order: the tail fault then takes
                # another part of the view's values, not a neighbouring pixel's
                cat = {k: torch.cat(v) for k, v in frame.items()}
                perm = torch.randperm(cat["k1"].shape[0], generator=torch.Generator().manual_seed(0)
                                      ).to(cat["k1"].device)
                c1 = bf16_columns(f"{name} K1 ({f['where']} frame)", cat["k1"][perm],
                                  cat["k1_plain"][perm], cat["k1_fp32"][perm])
                c2 = bf16_columns(f"{name} K2 at fixed z ({f['where']} frame)", cat["k2"][perm],
                                  cat["k2_plain"][perm], cat["k2_fp32"][perm])
                worst["K1"] = max(worst["K1"], c1["err_over_bound"], c1["flip_rows_over_bound"])
                worst["K2"] = max(worst["K2"], c2["err_over_bound"], c2["flip_rows_over_bound"])
                del cat
    n_held_frames = sum(1 for f in frames if f["k1"])
    phase(f"{name}_kernels", frames_held=n_held_frames, calls_held=held,
          **({"k1_over_bound": worst["K1"], "k2_fixed_z_over_bound": worst["K2"]} if bf16 else
             {"k1_max_abs_err": worst["K1"], "k2_fixed_z_max_abs_err": worst["K2"], "tol": TOL,
              "rays_last_density_near_0": near_rays, "rays": all_rays,
              "their_max_abs_err": near_err}))
    if held != n_held_frames * per_frame or n_held_frames != 1 + EXHIBIT_FRAMES * (
            1 if "train" in stops else 2):
        raise SystemExit(f"{name}: held {held} calls of {n_held_frames} frames")

    # the --i_img frame, whole: kernel path vs plain path, beside the plain path nudged
    (img,) = [f for f in frames if f["where"] == "i_img"]
    field_c, field_f = img["k1"][0][0][0], img["k2"][0][0][0]
    args, _ = run_nerf.create_arg_parser().parse_known_args(runs["eval"])
    plain = NeRFNet(dataclasses.replace(run_nerf.model_config(args), fused_field=False))
    plain = plain.cuda().eval()
    plain.nerf.load_state_dict(field_c.state_dict())
    plain.nerf_fine.load_state_dict(field_f.state_dict())
    with open(os.path.join(raw_scene("llff"), "meta.json")) as fh:
        meta = json.load(fh)
    near_far = (meta["near"], meta["far"])
    rgb = {"kernel": torch.as_tensor(img["rgb"], device="cuda")}
    for k, net in (("plain", plain), ("plain_up", nudged_net(plain, 1.0)),
                   ("plain_down", nudged_net(plain, -1.0))):
        rgb[k] = eval_lib.make_render_fn(net, *near_far)(img["rays"])["rgb"]
        del net
    fractions = {}
    for k in ("kernel", "plain_up", "plain_down"):
        d = (rgb[k] - rgb["plain"]).abs().amax(dim=-1)
        fractions[f"{k}_vs_plain"] = {"max_abs_diff": float(d.max()),
                                      "frac_rays_over_1e_3": float((d > 1e-3).float().mean())}
    phase(f"{name}_frame", view=f"{H_VIEW}x{W_VIEW}", **fractions)
    del frames, rgb, plain
    torch.cuda.empty_cache()
    return {"K1": total["K1"], "K2": total["K2"], "seconds": seconds, "writer": writer}


GATE_FINETUNES = ("geo", "app", "control")


def kernel_counters(*modules) -> dict:
    """Every launch count of the kernel wrappers in ``modules``:
    ``{"<wrapper>.<counter>": wrapper}`` (fp32, bf16, K8b's head rule, the
    input-gradient mode), each wrapper once whatever names a module binds
    it to."""
    out = {}
    for mod in modules:
        for fn in vars(mod).values():
            if callable(fn) and isinstance(getattr(fn, "launches", None), int):
                out.update({f"{fn.__name__}.{k}": fn for k, v in vars(fn).items()
                            if "launches" in k and isinstance(v, int)})
    return out


def gate_expected(proto, phase_name: str) -> dict:
    """The launches a run of the gate must count, from its step counts: K3
    twice a pretrain step; K4 twice a finetune step and twice a train-time
    ARI re-render (each --i_print step), K5 twice a step, K7a/K7f/K7g once;
    K1 and K2 once a ray block of each test view in the final eval; each in
    the run's dtype, and no other launch."""
    from nerfsos_torch.ops import flash_corr as fc
    from nerfsos_torch.ops import fused_render as fr

    args = proto.args(phase_name)
    counter = "launches_bf16" if args.compute_dtype == "bfloat16" else "launches"
    blocks = -(-proto.size * proto.size // args.ray_chunk)
    views = np.load(os.path.join(proto.data, "rays_test.npy"), mmap_mode="r").shape[0]
    want = {"K1": views * blocks, "K2": views * blocks}
    if phase_name == "pretrain":
        want["K3"] = 2 * args.max_steps
    elif phase_name in GATE_FINETUNES:
        first = proto.pretrain_steps + 1
        steps = args.max_steps - proto.pretrain_steps
        rerenders = sum(1 for g in range(first, args.max_steps + 1) if g % args.i_print == 0)
        want.update(K4=2 * steps + 2 * rerenders, K5=2 * steps, K7a=steps, K7f=steps,
                    K7g=steps)
    wrappers = {"K1": fr.fused_coarse_weights, "K2": fr.fused_render,
                "K3": fr.fused_rgb_train_grads, "K4": fr.train_render,
                "K5": fr.frozen_sem_grads, "K7a": fc.geo_row_stats, "K7f": fc.geo_quad_means,
                "K7g": fc.geo_quad_grads}
    # K7 has no bf16 mode: the geometry loss runs in fp32 at either dtype
    return {f"{wrappers[k].__name__}."
            f"{counter if hasattr(wrappers[k], counter) else 'launches'}": n
            for k, n in want.items()}


def gate_run(proto, name: str, counters: dict) -> dict:
    """One run of the gate through the twin (``Protocol.run``): every kernel
    count set to 0 just before and read just after, held to gate_expected;
    no call of the eager field (the plain path) on the card; each train
    step's ms (CUDA synchronised around it: host and device, no overlap).
    Returns the twin's readings with the launches and the step ms."""
    from nerfsos_torch.engines import sos, trainer
    from nerfsos_torch.models.fields import NeRFField

    step_ms, eager = [], []
    makers = {trainer: "make_rgb_train_step", sos: "make_sos_train_step"}
    saved = {mod: getattr(mod, n) for mod, n in makers.items()}
    eager_saved = {m: getattr(NeRFField, m) for m in ("forward", "sigma")}

    def timed(make):
        def wrapped(*a, **kw):
            step = make(*a, **kw)

            def run(batch, global_step):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(batch, global_step)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
                return out
            return run
        return wrapped

    def counted(m):
        def wrapped(self, *a, **kw):
            eager.append(m)
            return eager_saved[m](self, *a, **kw)
        return wrapped

    for mod, n in makers.items():
        setattr(mod, n, timed(saved[mod]))
    for m in eager_saved:
        setattr(NeRFField, m, counted(m))
    for key, fn in counters.items():
        setattr(fn, key.split(".", 1)[1], 0)
    try:
        torch.cuda.synchronize()
        out = proto.run(name)
    finally:
        for mod, n in makers.items():
            setattr(mod, n, saved[mod])
        for m, f in eager_saved.items():
            setattr(NeRFField, m, f)
    launches = {k: getattr(fn, k.split(".", 1)[1]) for k, fn in counters.items()}
    launches = {k: v for k, v in launches.items() if v}
    want = gate_expected(proto, name)
    if launches != want or eager:
        raise SystemExit(f"the gate's {proto.compute_dtype} {name} run launched {launches}, "
                         f"expected {want}; eager field calls: {len(eager)}")
    out.update(launches=launches, steps=len(step_ms))
    if step_ms:
        out.update(step_ms_median=float(np.median(step_ms)), step_ms_first=step_ms[0],
                   step_ms_sum=float(np.sum(step_ms)))
    phase("sos_gate_run", dtype=proto.compute_dtype, run=name, **out)
    return out


GATE_FAULTS = []  # the gate's refusals of a finetune


def sos_gate_path(fr, fc, ff, dtype: str, name: str):
    """[sos_gate] / [sos_gate_bf16]: the SOS quality gate
    (``nerfsos_torch/tools/validate_sos_protocol.py``) at ``dtype`` in its
    own root, with --ret_cluster: the 64x64 sphere scene, the 1500-step
    pretrain, the idle head's eval, the geometry-only and the appearance
    finetunes (500 frozen steps each), each run through gate_run. Fails
    unless each finetune's PSNR is the pretrain's exactly; a finetune the
    gate (held-out clus ARI >= 0.5, PSNR within 0.5 dB) refuses goes into
    GATE_FAULTS, which fails the run after [sos_gate_control]. Returns the
    Protocol and the runs."""
    from nerfsos_torch.tools import validate_sos_protocol as vsp

    proto = vsp.Protocol(root=os.path.join(WORK, f"sos_gate_{dtype}"), compute_dtype=dtype,
                         extra=("--ret_cluster",))
    proto.build_dataset()
    counters = kernel_counters(fr, fc, ff)
    runs = {p: gate_run(proto, p, counters) for p in ("pretrain", "idle", "geo", "app")}
    summary = vsp.verdict(runs)
    fields = {f"{k}_{m}": summary[k][m] for k in ("geo", "app")
              for m in ("clus_ari", "psnr", "psnr_delta", "fg_label_share", "seconds",
                        "step_ms_median")}
    phase(name, dtype=dtype, pretrain_psnr=summary["pretrain_psnr"],
          idle_clus_ari=summary["idle_clus_ari"],
          idle_fg_label_share=runs["idle"]["fg_label_share"],
          pretrain_fg_label_share=runs["pretrain"]["fg_label_share"],
          pretrain_seconds=runs["pretrain"]["seconds"],
          pretrain_step_ms_median=runs["pretrain"]["step_ms_median"],
          idle_seconds=runs["idle"]["seconds"], **fields,
          gate_geo=summary["geo"]["pass"], gate_app=summary["app"]["pass"])
    for k in ("geo", "app"):
        if summary[k]["psnr_delta"] != 0.0:
            raise SystemExit(f"the {dtype} {k} finetune moved the eval's rgb: {summary[k]} "
                             f"(pretrain PSNR {summary['pretrain_psnr']!r})")
        if not summary[k]["pass"]:
            GATE_FAULTS.append(f"the {dtype} gate refused the {k} finetune: {summary[k]} "
                               f"(idle head {summary['idle_clus_ari']!r})")
    return proto, runs


def sos_gate_control(fr, fc, ff, proto, runs) -> None:
    """[sos_gate_control]: the negative control from [sos_gate]'s fp32
    pretrain: the geometry-only finetune with the loss's sign inverted
    (``--Gcorrelation_w -1.0``), through gate_run. Fails unless its PSNR is
    the pretrain's; whether the gate refuses it (held-out clus ARI < 0.5)
    is printed as ``refused``: on this scene the untrained head already
    scores ~0.98 and the inverted loss keeps it (PERF.md §7), so a control
    the gate passes is the gate's finding, not the port's fault. Writes the
    twin's summary.json of the fp32 runs."""
    from nerfsos_torch.tools import validate_sos_protocol as vsp

    runs["control"] = gate_run(proto, "control", kernel_counters(fr, fc, ff))
    summary = vsp.verdict(runs)
    summary["compute_dtype"] = proto.compute_dtype
    with open(os.path.join(proto.root, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    c = summary["control"]
    phase("sos_gate_control", dtype=proto.compute_dtype, clus_ari=c["clus_ari"], psnr=c["psnr"],
          psnr_delta=c["psnr_delta"], fg_label_share=c["fg_label_share"],
          seconds=c["seconds"], step_ms_median=c["step_ms_median"],
          refused=str(c["refused"]).lower(), idle_clus_ari=summary["idle_clus_ari"],
          whole_gate_pass=summary["pass"])
    if c["psnr_delta"] != 0.0:
        raise SystemExit(f"the inverted-loss control moved the eval's rgb: {c}")


def read_ptxas(lib_path: str) -> None:
    """ptxas's lines for the kernels the phases print (K1_PTXAS .. REV_PTXAS)
    from the library's build log, printing every register/spill line;
    raises if a kernel's line is missing or ptxas serialised a wgmma."""
    global K1_PTXAS, K4_PTXAS, K5_PTXAS, K9_PTXAS, K1_BF16_PTXAS, K4_BF16_PTXAS, K5_BF16_PTXAS
    global K9_BF16_PTXAS
    with open(lib_path + ".log") as f:
        lines = f.read().splitlines()
    serialised = []  # ptxas's wgmma warnings
    for i, line in enumerate(lines):
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
        entry = "; ".join(x.replace("ptxas info    :", "").strip() for x in lines[i + 2:i + 4])
        # train_render_wg_kernel<kIn, kBf16>, frozen_sem_kernel<kBf16>
        if "Compiling entry function" in line and "train_render_wg_kernelILi0ELb0E" in line:
            K4_PTXAS = entry
        if "Compiling entry function" in line and "train_render_wg_kernelILi1ELb0E" in line:
            K1_PTXAS = entry
        if "Compiling entry function" in line and "train_render_wg_kernelILi2ELb0E" in line:
            K9_PTXAS = entry
        if "Compiling entry function" in line and "frozen_sem_kernelILb0E" in line:
            K5_PTXAS = entry
        if "Compiling entry function" in line and "train_render_wg_kernelILi0ELb1E" in line:
            K4_BF16_PTXAS = entry
        if "Compiling entry function" in line and "train_render_wg_kernelILi1ELb1E" in line:
            K1_BF16_PTXAS = entry
        if "Compiling entry function" in line and "train_render_wg_kernelILi2ELb1E" in line:
            K9_BF16_PTXAS = entry
        if "Compiling entry function" in line and "frozen_sem_kernelILb1E" in line:
            K5_BF16_PTXAS = entry
        if "Compiling entry function" in line and "train_forward_wg_kernel" in line:
            # (kLoss 1 or kCotangent 2, kInPoint 0 or kInMip 2, kBf16)
            mode, kin = line.split("train_forward_wg_kernelILi")[1].split("ELi")[:2]
            FWD_PTXAS[(int(mode), int(kin[0]), int(kin.split("ELb")[1][0]))] = "; ".join(
                x.replace("ptxas info    :", "").strip() for x in lines[i + 2:i + 4])
        if "Compiling entry function" in line and "field_bwd_forward_kernel" in line:
            sem, ingrad, bf16 = line.split("field_bwd_forward_kernelILb")[1].split("ELb")[:3]
            FIELD_BWD_PTXAS[(int(sem[0]), int(ingrad[0]), int(bf16[0]))] = "; ".join(
                x.replace("ptxas info    :", "").strip() for x in lines[i + 2:i + 4])
        if "Compiling entry function" in line and "field_wg_kernelILi" in line:
            # field_wg_kernel<kIn, kBf16, kHeadF32>
            mode, bf16, heads = line.split("field_wg_kernelILi")[1].split("ELb")[:3]
            FIELD_PTXAS[(int(mode[0]), int(bf16[0]), int(heads[0]))] = "; ".join(
                x.replace("ptxas info    :", "").strip() for x in lines[i + 2:i + 4])
        if "Compiling entry function" in line and "train_reverse_kernel" in line:
            sem, ingrad, bf16 = line.split("train_reverse_kernelILb")[1].split("ELb")[:3]
            used = next(j for j in range(i, len(lines)) if "Used" in lines[j])
            REV_PTXAS.setdefault((int(sem[0]), int(ingrad[0]), int(bf16[0])), "; ".join(
                x.replace("ptxas info    :", "").strip() for x in lines[i + 1:used + 1]
                if "bytes" in x or "Used" in x))
        m = K7_KERNEL.search(line)
        if "Compiling entry function" in line and m:
            used = next(j for j in range(i, len(lines)) if "Used" in lines[j])
            K7_PTXAS[m.group(1)] = "; ".join(
                x.replace("ptxas info    :", "").strip() for x in lines[i + 1:used + 1]
                if "bytes" in x or "Used" in x)
        if ("wgmma" in line and "warning" in line) or "(C75" in line:
            serialised.append(line.strip())
    if (K1_PTXAS is None or K4_PTXAS is None or K5_PTXAS is None or K9_PTXAS is None
            or None in (K1_BF16_PTXAS, K4_BF16_PTXAS, K5_BF16_PTXAS, K9_BF16_PTXAS)
            or sorted(FWD_PTXAS) != [(1, 0, 0), (1, 0, 1), (2, 0, 0), (2, 0, 1), (2, 2, 0),
                                     (2, 2, 1)]
            or len(REV_PTXAS) != 8
            or sorted(FIELD_PTXAS) != [(3, 0, 0), (3, 1, 0), (3, 1, 1), (4, 0, 0), (4, 1, 0),
                                       (5, 0, 0), (5, 1, 0)]
            or len(FIELD_BWD_PTXAS) != 8):
        raise SystemExit("no ptxas report for K1's, K4's and K9's kernel (train_render_wg_kernel "
                         "in its three input modes, each also in the bf16 mode), K5's "
                         "(frozen_sem_kernel, fp32 and bf16), K3's, K6's and K10b's forward "
                         "(train_forward_wg_kernel, each also bf16), the field forwards' three "
                         "point-list modes (field_wg_kernel, each also bf16, kInList in both "
                         "head rules), the field backward's forward's "
                         "eight modes (field_bwd_forward_kernel) or the reverse sweep's eight "
                         f"modes (train_reverse_kernel): forward {sorted(FWD_PTXAS)}, field "
                         f"{sorted(FIELD_PTXAS)}, field backward {sorted(FIELD_BWD_PTXAS)}")
    # every wgmma kernel keeps its pipeline: K1/K2/K4's, K5's, K3's, K6's,
    # K10b's and the field backward's forward, the field forwards', and the
    # reverse sweep's bwd_layer
    # and wgrad products (one inlined call site each, no call in the kernel)
    if serialised:
        raise SystemExit(f"ptxas serialised wgmma: {serialised}")
    phase("reverse_ptxas", modes={f"kSem={k[0]},kInGrad={k[1]},kBf16={k[2]}": v
                                  for k, v in sorted(REV_PTXAS.items())},
          wgmma_warnings=serialised)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    smi = smi_line()
    phase("device", nvidia_smi=repr(smi), torch=torch.__version__, cuda=torch.version.cuda,
          count=torch.cuda.device_count())
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("torch.backends.cuda.matmul.allow_tf32 must be off")

    from nerfsos_torch import _build
    from nerfsos_torch.models import mlp
    from nerfsos_torch.ops import flash_corr as fc
    from nerfsos_torch.ops import fused_field as ff
    from nerfsos_torch.ops import fused_render as fr
    from nerfsos_torch.tools import sass_spills

    # The phases before the SOS gate keep the fixtures their checks were set
    # on: a fresh NeRF MLP keeps each nn.Linear's own draw (torch's law, the
    # weights of every earlier run) instead of the port's default, the JAX
    # package's law, which the gate phases run with. An untrained net of the
    # JAX law puts ~0.5% of the [render] view's rays a CDF bin apart between
    # the kernel and the plain path, over that check's 0.1%, and the plain
    # path nudged by 1 +- 2^-22 puts ~0.15% there alone (PERF.md §7); so
    # run_nerf.build_model's JAX draws (models/seeded) are off there too. The
    # ViT binds the port's law when it is imported, so it is imported first
    # and every phase's seeded DINO draws the port's default.
    from nerfsos_torch.models import seeded, vit  # noqa: F401
    port_init, mlp.flax_dense_init_ = mlp.flax_dense_init_, lambda layer: None
    port_seeded, seeded.jax_seeded_init_ = seeded.jax_seeded_init_, lambda net, seed: None

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t0 = time.perf_counter()
    start_fwdonly_build()
    lib_path = _build.build()
    _build.library()
    with open(lib_path + ".log") as f:  # each translation unit's nvcc seconds and the link's
        units = dict(kv.split("=") for kv in f.read().splitlines()[1].split()[1:])
    phase("build", seconds=time.perf_counter() - t0, lib=os.path.relpath(lib_path, ROOT),
          unit_seconds=units)
    read_ptxas(lib_path)

    def k7_sass():  # the library's SASS (cuobjdump, ~30 s) beside the first phases
        for name, sass in sass_spills.functions(lib_path).items():
            m = K7_KERNEL.search(name)
            if m:
                K7_SASS[m.group(1)] = sass_spills.inner_loop(sass)

    sass_thread = threading.Thread(target=k7_sass)
    sass_thread.start()

    k1 = kernel_vs_plain_k1(fr)
    k2 = kernel_vs_plain_k2(fr, use_semantics=True)
    kernel_vs_plain_k2(fr, use_semantics=False)
    launches = eval_path(fr)
    kernel_vs_plain_k3(fr, 4096, 64, use_semantics=True, white_bkgd=False)
    k3 = kernel_vs_plain_k3(fr, 4096, 192, use_semantics=True, white_bkgd=False)
    kernel_vs_plain_k3(fr, 4096, 192, use_semantics=False, white_bkgd=True)
    kernel_vs_plain_k3(fr, 1024, 64, use_semantics=True, white_bkgd=False)
    kernel_vs_plain_k3(fr, 1024, 192, use_semantics=True, white_bkgd=False)
    fp32_train_kernels(fr)
    fp32_train_kernels(fr, bf16=True)
    train_launches = train_path(fr)
    resume_path(fr)
    train_step_timings(fr)
    kernel_vs_plain_k4_k5(fr, 64)
    k45_err = kernel_vs_plain_k4_k5(fr, 192)
    kernel_vs_plain_k6(fr, 64)
    k6 = kernel_vs_plain_k6(fr, 192)
    sos_run = sos_path(fr, fc)
    sass_thread.join()
    k7_kernels = ["rowsum_tile_kernel"] + [f"{k}_tile_kernelILi{h}ELi{c}E" for k in ("loss", "grad")
                                      for h in (1, 2) for c in range(1, 9)]
    if sorted(K7_PTXAS) != sorted(k7_kernels) or not all(
            K7_SASS.get(k, {}).get("mufu") for k in k7_kernels):
        raise SystemExit(f"no ptxas line or no SASS pair loop with its reciprocals for some of "
                         f"K7's kernels: ptxas {sorted(K7_PTXAS)}, SASS {K7_SASS}")
    k7 = kernel_vs_plain_k7(fc, sos_run["k7_calls"])
    del sos_run["k4_calls"], sos_run["k5_calls"], sos_run["k7_calls"]
    k7s = kernel_vs_plain_k7s(fc)
    torch.cuda.empty_cache()
    full_run = sos_mode_path(fr, fc, "full")
    torch.cuda.empty_cache()
    rand_run = sos_mode_path(fr, fc, "randneg")
    torch.cuda.empty_cache()
    parts = sos_step_timings(fr, fc, sos_run)
    torch.cuda.empty_cache()
    # the bf16 modes: the kernels, the --eval view, the frozen finetune and its step
    bf16 = kernel_vs_plain_bf16(fr)
    eval_bf16_launches = eval_bf16_path(fr)
    sos_bf16 = sos_bf16_path(fr, fc)
    sos_bf16_step_timings(sos_run, sos_bf16)
    torch.cuda.empty_cache()
    bf16.update(kernel_vs_plain_k3_k6_bf16(fr))
    train_bf16_launches = train_bf16_path(fr)
    train_step_bf16_timings(fr)
    torch.cuda.empty_cache()
    sos_step_timings(fr, fc, sos_bf16, "sos_bf16_step", paths=("kernel",))
    del sos_run["rec"], sos_bf16["rec"]
    torch.cuda.empty_cache()
    full_parts = sos_step_timings(fr, fc, full_run, "sos_full_step", "train_render_grads")
    torch.cuda.empty_cache()
    full_bf16 = sos_mode_path(fr, fc, "full", bf16=True)
    sos_bf16_step_timings(full_run, full_bf16, "sos_full_bf16_step", reps=3)
    del full_run["rec"], full_bf16["rec"]
    torch.cuda.empty_cache()
    sos_step_timings(fr, fc, rand_run, "sos_randneg_step", parts=False)
    del rand_run["rec"]
    torch.cuda.empty_cache()
    kernel_vs_plain_k9(fr, 63)
    k9 = kernel_vs_plain_k9(fr, 190)
    kernel_vs_plain_k10(fr, 63)
    k10 = kernel_vs_plain_k10(fr, 190)
    torch.cuda.empty_cache()
    mip_train_launches = mip_train_path(fr)
    mip_eval_launches = mip_eval_path(fr)
    mip_parts = mip_step_timings(fr)
    torch.cuda.empty_cache()
    k8 = kernel_vs_plain_k8(ff)
    k8_bwd = kernel_vs_plain_k8_bwd(ff)
    torch.cuda.empty_cache()
    vol_launches = eval_vol_path(ff)
    torch.cuda.empty_cache()
    # the mip kernels' bf16 modes, then the --mipnerf paths at bf16
    mip_bf16 = kernel_vs_plain_mip_bf16(fr, ff)
    torch.cuda.empty_cache()
    mip_bf16_launches = mip_bf16_paths(fr, ff)
    mip_step_bf16_timings(fr)
    torch.cuda.empty_cache()
    noimp_launches = train_noimp_path(fr, ff)
    sos_noimp_path(fr, ff)
    sigma = sigma_noise_path(ff)
    torch.cuda.empty_cache()
    noimp_parts = noimp_step_timings(ff)
    torch.cuda.empty_cache()
    # the classic field kernels' bf16 modes, then their paths at bf16
    k8_bf16 = kernel_vs_plain_k8_bf16(ff)
    k8_bf16.update(kernel_vs_plain_k8_bwd_bf16(ff))
    torch.cuda.empty_cache()
    vol_bf16_classic = bf16_classic_export(ff)
    torch.cuda.empty_cache()
    noimp_bf16_launches = train_noimp_bf16_path(fr, ff)
    noimp_bf16_step_timings()
    torch.cuda.empty_cache()
    sigma_bf16_launches = sigma_noise_bf16_path(ff)
    torch.cuda.empty_cache()
    # the SOS quality gate at fp32 and bf16, then its negative control, with
    # the port's default initialisation (the JAX entry point's draws)
    mlp.flax_dense_init_, seeded.jax_seeded_init_ = port_init, port_seeded
    # a raw scene to trained views and videos through the port alone: data
    # preparation, --no_batching with precrop (K3), --i_img, --i_video and
    # --eval --eval_video (K1, K2); at fp32 with the port's default
    # initialisation (the JAX entry point's draws), at bf16 on torch's
    # nn.Linear draws, the fixtures of every bf16 check ([train_bf16],
    # [eval_bf16])
    gen_dataset_path()
    nobatch = train_nobatch_path(fr)
    nobatch_step_timings()
    torch.cuda.empty_cache()
    video = video_path(fr)
    torch.cuda.empty_cache()
    mlp.flax_dense_init_, seeded.jax_seeded_init_ = lambda layer: None, lambda net, seed: None
    nobatch_bf16 = train_nobatch_path(fr, bf16=True)
    video_bf16 = video_path(fr, bf16=True)
    torch.cuda.empty_cache()
    mlp.flax_dense_init_, seeded.jax_seeded_init_ = port_init, port_seeded
    gate32 = sos_gate_path(fr, fc, ff, "float32", "sos_gate")
    torch.cuda.empty_cache()
    sos_gate_path(fr, fc, ff, "bfloat16", "sos_gate_bf16")
    torch.cuda.empty_cache()
    sos_gate_control(fr, fc, ff, *gate32)
    if GATE_FAULTS:  # after all three phases, so that each prints its readings
        raise SystemExit("the SOS quality gate failed: " + "; ".join(GATE_FAULTS))
    sos_launches = sos_run["launches"]
    full_launches, rand_launches = full_run["launches"], rand_run["launches"]

    train_src = "nerfsos_torch/csrc/train_render.cu"
    corr_src = "nerfsos_torch/csrc/flash_corr.cu"
    field_src = "nerfsos_torch/csrc/fused_field.cu"
    tile_src = "nerfsos_torch/csrc/wg_tile.cuh"  # K4's tile; the field forwards' kernel is in field_src
    field_tpu = "nerfsos_tpu/ops/pallas/fused_field.py"

    def main_path_numbers(kernel: str, err: float, timed=parts) -> dict:
        """ms and plain ms of the SOS step's fine call (32768 rays, S=192)."""
        ms, plain_ms = timed[f"{kernel} fine"]
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                **timed[f"{kernel} fine cost"], "library_ms": None}

    def mip_step_numbers(kernel: str, err: float) -> dict:
        """The mip train step's fine call (1024 rays, S=190), timed alone."""
        return {"max_abs_err": err, **mip_parts[f"{kernel} fine"], "library_ms": None}

    kernels = [
        {"name": "K1 fused_coarse_weights", "route": "cuda",
         "source": "nerfsos_torch/csrc/wg_tile.cuh",
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:458",
         "launches": launches["K1"], **k1},
        {"name": "K2 fused_render", "route": "cuda", "source": "nerfsos_torch/csrc/wg_tile.cuh",
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:369",
         "launches": launches["K2"], **k2},
        {"name": "K3 fused_rgb_train_grads", "route": "cuda", "source": train_src,
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:940",
         "launches": train_launches["K3"], **k3},
        {"name": "K4 train_render", "route": "cuda",
         "source": "nerfsos_torch/csrc/wg_tile.cuh",
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:852",
         "launches": sos_launches["K4"], **main_path_numbers("K4", k45_err["K4"])},
        {"name": "K5 frozen_sem_grads", "route": "cuda", "source": train_src,
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:1207",
         "launches": sos_launches["K5"], **main_path_numbers("K5", k45_err["K5"])},
        {"name": "K6 train_render_grads", "route": "cuda", "source": train_src,
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:940",
         "launches": full_launches["K6"],
         **main_path_numbers("K6", k6["max_abs_err"], full_parts)},
        {"name": "K7a geo_row_stats", "route": "cuda", "source": corr_src,
         "replaces": "nerfsos_tpu/ops/pallas/flash_corr.py:105",
         "launches": sos_launches["K7a"], **k7["K7a"]},
        {"name": "K7b geo_single_means", "route": "cuda", "source": corr_src,
         "replaces": "nerfsos_tpu/ops/pallas/flash_corr.py:116",
         "launches": rand_launches["K7b"], **k7s["K7b"]},
        {"name": "K7c geo_single_grads", "route": "cuda", "source": corr_src,
         "replaces": "nerfsos_tpu/ops/pallas/flash_corr.py:130",
         "launches": rand_launches["K7c"], **k7s["K7c"]},
        {"name": "K7d geo_pair_means", "route": "cuda", "source": corr_src,
         "replaces": "nerfsos_tpu/ops/pallas/flash_corr.py:281",
         "launches": full_launches["K7d"] + rand_launches["K7d"], **k7s["K7d"]},
        {"name": "K7e geo_pair_grads", "route": "cuda", "source": corr_src,
         "replaces": "nerfsos_tpu/ops/pallas/flash_corr.py:307",
         "launches": full_launches["K7e"] + rand_launches["K7e"], **k7s["K7e"]},
        {"name": "K7f geo_quad_means", "route": "cuda", "source": corr_src,
         "replaces": "nerfsos_tpu/ops/pallas/flash_corr.py:422",
         "launches": sos_launches["K7f"], **k7["K7f"]},
        {"name": "K7g geo_quad_grads", "route": "cuda", "source": corr_src,
         "replaces": "nerfsos_tpu/ops/pallas/flash_corr.py:459",
         "launches": sos_launches["K7g"], **k7["K7g"]},
        {"name": "K9 fused_mip_render", "route": "cuda", "source": "nerfsos_torch/csrc/wg_tile.cuh",
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:1843",
         "launches": mip_eval_launches["K9"], **k9},
        {"name": "K10a mip_train_render", "route": "cuda",
         "source": "nerfsos_torch/csrc/wg_tile.cuh",
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:2040",
         "launches": mip_train_launches["K10a"], **mip_step_numbers("K10a", k10["K10a"])},
        {"name": "K10b mip_train_render_grads", "route": "cuda", "source": train_src,
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:2097",
         "launches": mip_train_launches["K10b"], **mip_step_numbers("K10b", k10["K10b"])},
        # the TPU's row-major and channel-major twins are one kernel each here:
        # K8a/K8e the sigma forward, timed on a [sigma_noise] call (32768 x 64
        # points); K8b/K8d the field forward, K8b at the export's 2^18-point
        # chunks ([K8]), K8d at the --N_importance 0 step's 1024 x 64 points;
        # K8c/K8f the field backward's two modes (K8c at 1024 x 64 points,
        # [K8_bwd]: no path asks for the points' gradients); K11 the field
        # forward's integrated-PE mode, at the export's chunks
        {"name": "K8a fused_sigma_apply", "route": "cuda", "source": tile_src,
         "replaces": f"{field_tpu}:115", "launches": sigma["launches"]["K8e"], **sigma["timed"]},
        {"name": "K8e fused_sigma_apply (planar twin)", "route": "cuda", "source": tile_src,
         "replaces": f"{field_tpu}:688", "launches": sigma["launches"]["K8e"], **sigma["timed"]},
        {"name": "K8b field_forward", "route": "cuda", "source": tile_src,
         "replaces": f"{field_tpu}:68", "launches": vol_launches["classic"], **k8["field"]},
        {"name": "K8d field_forward (planar twin)", "route": "cuda", "source": tile_src,
         "replaces": f"{field_tpu}:638", "launches": noimp_launches["K8d"],
         **noimp_parts["K8d"]},
        {"name": "K8c field_grads (input-gradient mode)", "route": "cuda", "source": field_src,
         "replaces": f"{field_tpu}:346", "launches": noimp_launches["K8c"], **k8_bwd["K8c"]},
        {"name": "K8f field_grads", "route": "cuda", "source": field_src,
         "replaces": f"{field_tpu}:818", "launches": noimp_launches["K8f"],
         **noimp_parts["K8f"]},
        {"name": "K11 fused_mip_field_apply", "route": "cuda", "source": tile_src,
         "replaces": f"{field_tpu}:1044", "launches": vol_launches["mip"], **k8["mip"]},
        # the bf16 modes (--compute_dtype bfloat16): launches on the bf16 --eval view
        # (K1, K2), the bf16 frozen finetune (K4, K5), the bf16 RGB pretrain (K3)
        # and the bf16 full finetune (K6), each counted from 0
        {"name": "K1 fused_coarse_weights (bf16)", "route": "cuda", "source": tile_src,
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:458",
         "launches": eval_bf16_launches["K1"], **bf16["K1"]},
        {"name": "K2 fused_render (bf16)", "route": "cuda", "source": tile_src,
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:369",
         "launches": eval_bf16_launches["K2"], **bf16["K2"]},
        {"name": "K4 train_render (bf16)", "route": "cuda", "source": tile_src,
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:852",
         "launches": sos_bf16["launches"]["K4"], **bf16["K4"]},
        {"name": "K5 frozen_sem_grads (bf16)", "route": "cuda", "source": train_src,
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:1207",
         "launches": sos_bf16["launches"]["K5"], **bf16["K5"]},
        {"name": "K3 fused_rgb_train_grads (bf16)", "route": "cuda", "source": train_src,
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:940",
         "launches": train_bf16_launches["K3"], **bf16["K3"]},
        {"name": "K6 train_render_grads (bf16)", "route": "cuda", "source": train_src,
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:940",
         "launches": full_bf16["launches"]["K6"], **bf16["K6"]},
        # the mip kernels' bf16 modes: launches on the bf16 --eval --mipnerf view (K9),
        # the bf16 --mipnerf train run (K10a, K10b) and its bf16 export (K11)
        {"name": "K9 fused_mip_render (bf16)", "route": "cuda", "source": tile_src,
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:1843",
         "launches": mip_bf16_launches["K9"], **mip_bf16["K9"]},
        {"name": "K10a mip_train_render (bf16)", "route": "cuda", "source": tile_src,
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:2040",
         "launches": mip_bf16_launches["K10a"], **mip_bf16["K10a"]},
        {"name": "K10b mip_train_render_grads (bf16)", "route": "cuda", "source": train_src,
         "replaces": "nerfsos_tpu/ops/pallas/fused_render.py:2097",
         "launches": mip_bf16_launches["K10b"], **mip_bf16["K10b"]},
        {"name": "K11 fused_mip_field_apply (bf16)", "route": "cuda", "source": tile_src,
         "replaces": f"{field_tpu}:1044", "launches": mip_bf16_launches["K11"],
         **mip_bf16["K11"]},
        # the classic field kernels' bf16 modes: launches on the bf16 noisy
        # density-only view (K8a/K8e, K8d there too), the bf16 classic export
        # (K8b, on launches_bf16_f32_heads) and the bf16 --N_importance 0 run
        # (K8d, K8f; K8c: no path asks for the points' gradients); K8a/K8e
        # timed at the view's 32768 x 64 points, K8b at the export's
        # 2^18-point chunks, K8d, K8f and K8c at the --N_importance 0 step's
        # 1024 x 64 ([K8_bf16], [K8_bwd_bf16])
        {"name": "K8a fused_sigma_apply (bf16)", "route": "cuda", "source": tile_src,
         "replaces": f"{field_tpu}:115", "launches": sigma_bf16_launches["K8e"],
         **k8_bf16["K8a"]},
        {"name": "K8e fused_sigma_apply (planar twin) (bf16)", "route": "cuda",
         "source": tile_src, "replaces": f"{field_tpu}:688",
         "launches": sigma_bf16_launches["K8e"], **k8_bf16["K8a"]},
        {"name": "K8b field_forward (bf16, f32_heads)", "route": "cuda", "source": tile_src,
         "replaces": f"{field_tpu}:68", "launches": vol_bf16_classic, **k8_bf16["K8b"]},
        {"name": "K8d field_forward (planar twin) (bf16)", "route": "cuda", "source": tile_src,
         "replaces": f"{field_tpu}:638", "launches": noimp_bf16_launches["K8d"],
         **k8_bf16["K8d"]},
        {"name": "K8c field_grads (input-gradient mode) (bf16)", "route": "cuda",
         "source": field_src, "replaces": f"{field_tpu}:346",
         "launches": noimp_bf16_launches["K8c"], **k8_bf16["K8c"]},
        {"name": "K8f field_grads (bf16)", "route": "cuda", "source": field_src,
         "replaces": f"{field_tpu}:818", "launches": noimp_bf16_launches["K8f"],
         **k8_bf16["K8f"]},
    ]
    # the new paths' launches beside the rows' main-path counts, each counted from 0
    path_launches = {
        "K1 fused_coarse_weights": {"video": video["K1"]},
        "K2 fused_render": {"video": video["K2"]},
        "K3 fused_rgb_train_grads": {"train_nobatch": nobatch["K3"]},
        "K1 fused_coarse_weights (bf16)": {"video": video_bf16["K1"]},
        "K2 fused_render (bf16)": {"video": video_bf16["K2"]},
        "K3 fused_rgb_train_grads (bf16)": {"train_nobatch": nobatch_bf16["K3"]}}
    for row in kernels:
        if row["name"] in path_launches:
            row["path_launches"] = path_launches[row["name"]]
    print("[timing] " + json.dumps({
        "total_s": round(time.perf_counter() - START, 1),
        "build_units_s": {k: float(v) for k, v in units.items()},
        "phases_s": {k: round(v, 1) for k, v in PHASE_SECONDS.items()}}), flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
