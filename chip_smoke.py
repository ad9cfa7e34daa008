#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port ``nerf_texture_tpu_torch`` on a GPU.

    python3 chip_smoke.py

Drives the port's paths through the entry points a user calls, and
checks them: at the width of ``bench.py``'s NGP arm the serving path
(``train.trainer.render_frame`` of an 800x800 novel view) over seeded
weights and the training path (``train.trainer.Trainer``: ``train``,
``eval_psnr``, ``render_frame``), whose trained field is rendered through
both survivor selections; at the width of its curved arm the curved
model's serving path (``CurvedTrainer.initialize_states`` and
``render_frame``, live and ``parity=True``) over seeded weights, and its
training path (``CurvedTrainer.train``, 700 steps), whose trained field
is rendered live, through the pool and through the baked atlas
(``bake_atlas``, ``render_frame(baked=True)``); then the texture
pipelines on that trained field: the flat one (patch export, quilting,
the 'field' and 'patch' imports) and the synthesis onto another mesh
with the 'shape' and 'unhash' imports (``field_io``); then the two
training CLIs on a scene directory (``main_nerf_torch.py``,
``main_torch.py``); then relighting (the SG and Envmap light models,
imported environments, the light modes and rotation) and the vertex
encoder with its progressive levels; then the viewer (``ViewerApp`` and
``serve``, in this process and through ``main_torch.py --gui``), a scene
of JPEG frames and ``main_nerf_torch.py --bound 2 --dt_gamma 1/128``.
After the NGP phases, the per-corner hash grid with the NGP's learned
background sphere, an importance-sampled frame, Morton codes and
``packbits``.  Beside the viewer's scenes, the capture-to-scene path
(image formats, ``data.prepare``), the scribble segmenter and GrabCut's
max-flow kernel.  Phases, run in the order 1-6, 14, 7,
8, 17, 9, 10, then 16's viewer, 11-13, 15 and 16 (with 18-20) at once:
after phase 10 the CLIs of phases 13 and 15 start as subprocesses and
the rest of phases 15 and 16 as worker processes
(``chip_smoke.py --worker relight`` and ``--worker viewer``), all on the
same card beside phases 11-13 of this process, which then reads their
results (their walls and rates are taken under that load, and phase 14's
kernel times before any of it).  Any failure ends the run with a non-zero
exit and no result line, and stops every process it started:

  1. device:  a CUDA card is required (there is no CPU path); prints the
              card's name and power limit as nvidia-smi gives them;
  2. build:   builds the selection kernels and the max-flow kernel from
              csrc/ (one nvcc a source, at once; sm_90a) and prints
              ptxas's register and spill lines;
  3. kernel:  proxy_select_cdf vs its plain PyTorch version on the card,
              at the serving path's shape [16384, 24] cap 4 and at
              [8192, 16] cap 5, with degenerate spans, empty rays and
              ties; times the plain version;
  4. parity:  a small frame rendered by the port on the card vs the same
              frame by the port on the CPU (whose numerics the tier-1 tests
              hold against the JAX package);
  5. slice:   seeded full-width NGP params over a fixture density shell,
              800x800 frames at novel orbit poses: shape, range, live
              count, kernel launches == chunks, and one frame re-rendered
              with the plain selection agrees;
  6. kernel:  proxy_select (top-k) vs its plain version at the trained
              render's shape [16384, 24] cap 8 and at [8192, 32] cap 8 and
              [8192, 16] cap 4, same recipe;
  7. train:   Trainer on SyntheticSphereDataset(8 frames, 800x800) for
              50 + 650 steps: the loss is finite and falls, the grid is
              not empty;
  8. render:  the trained field: training-view and novel-view PSNR with
              the bench selection (inverse CDF, cap 4) and with top-k
              (cap 8), ms/frame of both, launches == chunks for each
              kernel, and a top-k frame re-rendered with the plain
              selection agrees; deferred (per-ray) shading
              (``RenderConfig.deferred``) of the trained field through
              both selections: each deferred kernel frame bit for bit
              with its plain-selection frame, within a mean of 0.02 of
              its per-sample frame, ms/frame, kernel time and PSNR beside
              the per-sample frame's; ``field_io.save_mesh`` of its
              density at 256^3 (main_nerf.py's export) lies on the
              dataset's sphere;
  9. curved:  the NeRF-Texture curved model at the width of bench.py's
              curved arm (``train.curved_trainer.CurvedTrainer`` over
              make_icosphere(4, 0.5), seeded weights): the host set-up
              (projector, near cells, anchor table), initialize_states(1),
              proxy_select_cdf vs plain at [16384, 24] cap 5, live 800x800
              frames through the kernel (launches == chunks, and a frame
              re-rendered with the plain selection agrees), parity=True
              pool frames, kernels a frame from one torch.profiler frame
              of each, and a small frame of both paths on the card vs the
              CPU port;
 10. curved train: proxy_select_cdf vs plain at the baked render's
              shapes [16384, 16] cap 5 and [16384, 20] cap 6; then
              CurvedTrainer at the same width from seeded weights with
              bench.py's schedule (initialize_states(1), 17 + 48 timed +
              635 steps): the loss is finite, it/s, one profiled step,
              s per refresh, peak memory; the trained field at the novel
              pose: live, pool and EMA parity frames, the bake, baked
              frames at cap 5 K 16 and cap 6 K 20 -- each PSNR gated at
              the JAX package's cell less 1 dB, the live and baked frames
              held against their plain-selection frames, launches ==
              chunks, ms/frame over 3 poses; the live field at the baked
              arm's settings (K 16, cap 5), beside the baked frame; the
              pool frame's minimum pixel, and as a probe the same with
              ``seg_sum`` in f64; deferred baked frames at K 16 cap 5 and
              K 20 cap 6, held and reported as phase 8's deferred frames;
 11. texture: the flat texture pipeline on phase 10's trained field:
              ``field_io.save_field`` exports 256 patches of 128^2 texels
              (ray cast, exact projection, encode), the flat quilting CLI
              ``patch_matching_and_quilting_torch.py`` (a subprocess)
              quilts a 2048^2 canvas on the host, ``load_field`` imports
              it (mode 'field', 50 grid refreshes over the z = 0 slab)
              and 800x800 frames look down onto it through
              proxy_select_cdf and, with ``proxy_samples=32``, through
              the two-round proxy and proxy_select; ``load_patch``
              imports one patch (mode 'patch') and frames look at it --
              each path's launches == chunks, ms/frame over 3 poses, one
              profiled frame, and a frame re-rendered with the plain
              selection agrees; then the narrow curved config on the
              card and on the CPU port imports the same texture.npz
              (the CPU's export, quilted) and one patch, and their 64x64
              frames agree;
 12. surfaces: phase 11's patches synthesised onto another mesh (a
              rounded box, 512^2 UV map; the curved-synthesis CLI's
              function, with an iteration cap), then on the trained
              field ``load_field`` + ``load_shape`` (the flat texture
              wrapped onto the box), ``load_unhash`` (the synthesised
              texture) and ``unhash`` (the trained field baked into the
              subdivided template's 40,962 vertices), each with 800x800
              frames through proxy_select_cdf (launches == chunks, a
              plain-selection frame agrees, one profiled frame and the
              share of the uvh / barycentric queries), the unhash
              frame's PSNR, a take_photo PNG; then the narrow config on
              the card and on the CPU port imports one CPU-written
              curved_mesh.npz and bakes one unhash, and their 64x64
              frames agree;
 13. entry points: the reference's two training steps as a user runs
              them, on a scene directory (main.py's synthetic sphere, 24
              frames 400x400, written as PNGs to build/cli/scene):
              ``main_nerf_torch.py --save_mesh`` (1500 steps), then
              ``main_torch.py --distillation`` (200 steps; the
              scene-directory preset, so camera optimisation is on) and
              its resume to 300 steps, and ``main_torch.py`` without
              distillation in a workspace of its own (700 steps, beside
              the distilled run and its resume), as subprocesses (their
              logs in chiprun_out/cli_*.log): exit
              codes, the PSNR and template lines, the mesh, the
              checkpoints and their steps, finite camera deltas, their
              eval frames through proxy_select; the distilled checkpoint
              loaded here and its eval frame through proxy_select equal
              bit for bit to the plain-selection frame, launches ==
              chunks; the staged camera recovery of
              tests/test_training_features.py at 400x400 (4 frames, 4096
              rays); PSNR gated at 24 dB for the NGP CLI and the curved
              CLI without distillation;
 14. timing:  each selection kernel's device time from torch.profiler's
              kernel events (median of 60 launches; cold with 64 MiB
              written between launches, and warm with sig just written),
              against its bound and beside a copy_ of the same bytes,
              and its wrapper's host time a call, at [16384, 24] CDF cap
              5 and cap 4 and top-k cap 8;
 15. relight and vertex: at the bench's curved width, the SG and the
              Envmap light models (``light_model``) each trained 500
              steps from seeded weights: it/s, peak memory, the live
              800x800 frame through proxy_select_cdf equal bit for bit to
              its plain-selection frame, PSNR at the novel pose gated at
              3 dB above the step-0 frame, the Specular / Diffuse /
              Albedo frames and a rotated light; imported environments
              (a 64x128 equirect PNG of an analytic sky): on phase 10's
              trained SH field ``load_envmap`` with visibility probes, a
              relit frame, ``clear_envmap`` back to the learned frame bit
              for bit (this part runs right after phase 10, before phase
              11 imports a texture into that field); ``load_envmap`` on
              the Envmap arm; the SG arm relit with ``envmap_to_sg``'s
              lobes; the vertex encoder (``encoder_type='vertex'``, 3
              levels 4096 -> 128^2 vertices, a level every 32 steps) over
              96 steps: the feature-mesh vertex counts, s a step, s a
              refresh, its live frame through the kernel; 64x64 SG,
              Envmap and vertex frames on the card vs the CPU port;
              ``main_torch.py --light_model SG`` and ``--encoder vertex``
              at once on phase 13's scene (logs in chiprun_out/cli_sg.log,
              cli_vertex.log).  All but the SH import run in the worker
              process (its output in chiprun_out/relight_worker.log and
              .err; this process prints its lines);
 16. viewer and scenes: after phase 10 (and the SH import), in this
              process beside the CLIs and workers, before phase 11,
              ``ViewerApp`` + ``serve(block=False)`` on 127.0.0.1
              around the trained field (training and the dynamic
              resolution off): /status, the stream's frames/s at the
              downscaled and the full tier, an orbit through /control
              whose next frame streams as the bytes the port's encoder
              makes of ``app.render()`` (and differs from the frame
              before), launches == chunks; through /control the growing
              step (``set_dt_gamma(1/128)``, a parity pool frame), the
              crop that halves x, ``toggle_baked`` and ``take_photo``.
              Then a worker process (``--worker viewer``; output in
              chiprun_out/viewer_worker.log): phase 13's scene written
              again as JPEG frames by the port's encoder (quality 95,
              4:4:4), loaded by NeRFDataset and held against the PNG scene
              (PSNR >= 40 dB); ``main_nerf_torch.py --bound 2 --dt_gamma
              0.0078125 --iters 1500 --save_mesh`` on phase 13's scene
              (its RGBA frames: see B2_ITERS's note) (two cascades, a
              finite eval 3 dB above its step-0 frame and at most 3 dB
              below phase 13's NGP CLI, the pool path's eval frames
              launching neither kernel, the mesh on the sphere; its peak
              memory printed by a runpy wrapper; log
              chiprun_out/cli_bound2.log); and ``main_torch.py --gui`` on
              phase 13's undistilled workspace once its checkpoint is
              saved (/status while it trains, 10 stream parts, the step
              advancing, ``stop_training`` and ``switch_visual_mode``
              through /control, exit 0 on SIGTERM; log
              chiprun_out/cli_gui.log).
 17. background: after phase 8, the NGP at NGPConfig's defaults (16
              levels x 2, 2^19 rows a level) with the per-corner grid
              (``encoder='hash'``) and the learned background sphere
              (``bg_radius`` 4), trained with phase 7's schedule: the loss
              falls, the background net's weights move; training-view and
              novel-view PSNR through both selections, each gated at phase
              8's packed arm less 1 dB; image = image(bg=0) + (1 -
              weights_sum) * bg within 1e-5; each selection's frame
              against its plain-selection frame; launches == chunks; an
              800x800 importance-sampled frame (``render/importance.py``)
              and its PSNR; ``morton3d`` / ``morton3d_invert`` over every
              cell of the trained 128^3 grid and ``packbits`` of its
              density; the per-corner and the packed encode's device time
              at the step's points.
 18. prepare: the capture-to-scene path, in the viewer worker of phase
              16 while ``--gui`` waits for its checkpoint: every committed
              format fixture (tests/fixtures/formats/: palette PNGs of 1-8
              bits with and without tRNS, 1/2/4-bit gray, Adam7 PNGs,
              PIL's progressive JPEGs) decoded bit for bit to the arrays
              imageio and the JAX loader gave for it, the 1-bit file
              raising; the seconds to decode one 800x800 frame of a
              baseline and a progressive JPEG (both held to the
              progressive fixture's pixels), an Adam7 PNG and a palette
              PNG (both held to their source); phase 13's scene as a
              capture (a COLMAP text model of its cameras, 6 box-blurred
              copies of its frames): ``remove_blurry_frames`` removes the
              blurred copies only, ``colmap_to_transforms`` +
              ``NeRFDataset`` give phase 13's images bit for bit and its
              poses (mirrored: see PREPARE_MIRROR_NERF) within 1e-5, and
              a Trainer at the bench NGP width takes 100 steps on it, the
              loss finite and falling; ``laplacian_variance`` seconds a
              frame and the phase's wall.
 19. parallel: ``parallel/`` over torch.distributed, after phase 18 in
              the viewer worker: ranks are ``chip_smoke.py --rank <job>``
              processes with torchrun's environment that call
              ``initialize_multihost``.  On 2 ranks sharing the card over
              gloo: the NGP's ``dp_train_step`` at bench width (phase 7's
              config and scene, 4096 rays a step split over the ranks) 50
              steps and the curved ``curved_train_step(mesh=)`` at phase
              10's width 32 steps (2 refreshes, the grid broadcast after
              each) in lockstep with single-rank runs of the same draws
              (the loss within 1% at every step; the curved one within
              1e-2 over the first refresh cycle, 0.1 at every step, 1e-2
              in the mean; training-view PSNR within 0.3 dB); 800x800
              band frames (``parallel.eval.render_image_sharded``) of the
              trained states through proxy_select_cdf and proxy_select,
              each band's kernel frame bit for bit with its
              plain-selection frame, and within the FRAME_* bounds of the
              single-rank frame (the NGP's at block 8, the curved one's at
              the baked arm's block 8; its live block 4 reported); at
              data 2 a deferred NGP band frame (CDF) within 1e-4 of the
              single-rank deferred frame; the
              chunk fallback at 2 cascades against the same split over
              one rank; one NGP and one curved step at model 2.  On 4
              ranks: one step of each at data 2 x model 2 (loss within
              1e-3 of the single-rank step) and the band frames at data
              4.  NCCL at a world of one: the NGP step against two runs
              of the single-rank step.  Every rank's params, Adam moments,
              EMA and grid bit for bit (checksums reduced by MAX and MIN).
              With 2 or more cards, the data-parallel run over NCCL on up
              to 4 cards.  Logs in build/parallel/; the times
              of ranks sharing one card are gloo traffic through the
              host, not a multi-GPU speed.
 20. segment: the foreground masks, after phase 19 in the viewer
              worker: 8 frames of the synthetic sphere at 1920x1080 over a
              dark background (``MaskSession``'s work_scale 2: every cut
              960x540), the JAX test's strokes scaled to the frame,
              ``segment(0)``, ``propagate_all(0)`` and a corrective
              ``segment(1)`` -- IoU with the alpha > 0.7 on the keyframe,
              > 0.6 on the others, seconds a call by stage (resize, flow,
              k-means, assign / learn / graph, cut), the max-flow kernel's
              launches,
              sweeps and global relabels; the kernel against its plain
              version on segment(0)'s five graphs and on one hard 960x540
              graph (a textured background: hundreds of sweeps, many
              global relabels) -- the cut on 99.99% of the pixels, the
              energy within 1e-9, two runs bit for bit -- each cut's device
              ms (CUDA events, and the kernels' busy time from
              torch.profiler) beside its host wall and its bounds; the
              scribble UI on 127.0.0.1
              (info, stroke, segment, /frame, save); ``apply_masks`` on
              phase 18's capture frames and ``colmap_to_transforms`` on the
              masked images.
 21. shell: the seven-stage pipeline on the textured bumpy shell
              (``scripts/torch_shell_pipeline.py``, the JAX package's
              ``tests/test_parity_pipeline.py`` FULL profile, seed 0),
              after phase 15 in the relight worker: coarse NGP 600 steps,
              ``save_mesh`` at 64^3, the template (largest component,
              Laplacian smoothing) and its h_threshold, curved training
              500 steps, patch export, quilting, ``load_field`` and
              ``load_patch`` with their frames -- every gate of the JAX
              test (NGP > 17 dB and curved > 15 dB at its held-out pose,
              > 200 vertices, the median radius within 0.1 of the base,
              h < 0.35, >= 4 patches carrying signal, a textured canvas,
              finite frames); the trained NGP, the trained curved field
              and the imported ``field`` canvas rendered at 400x400
              through proxy_select_cdf and proxy_select, each kernel frame
              bit for bit with its plain-selection frame and its launches
              == chunks; each stage's seconds and the phase's wall.

Prints a ``{"kernels": [...]}`` JSON line before the last, and as the last
line ``{"ok": true, "device": {...}}``.  Needs one card, the CUDA toolkit
(nvcc) and no network; the kernel build goes to build/kernels/, the
texture files to build/texture/, the surface files to build/surfaces/,
the CLIs' scene and workspace to build/cli/, phase 15's sky and CLI
workspaces to build/relight/, phase 16's files to build/viewer/.
``--only segment`` runs phases 1, 2, 13's scene writer, 18's capture
frames and 20 (its files to build/segment/); ``--only shell`` phases 1, 2
and 21; ``--only entry_points`` runs
phases 1, 2 and 13 alone, ``--only relight``
phases 1, 2 and 15 in this process (with an SH arm of its own for the
imports, and the CLIs on a scene and template written for them), ``--only
viewer`` phases 1, 2 and 16 in this process (the viewer on a curved field
trained 48 steps, --gui on a 50-step undistilled run), ``--only
background`` phases 1, 2, 7, 8 and 17, ``--only prepare`` phases 1, 2,
13's scene writer and 18 (its files to build/prepare/), ``--only
parallel`` phases 1, 2 and 19 (its files to build/parallel/); none
prints result lines.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# Tolerances (each with its reason):
# kernel vs plain selection: t values within 1e-5 (float summation order
# may differ in the last bits; the kernel compiles with --fmad=false and
# the same scan association, so it usually agrees exactly); valid equal.
# The inverse CDF maps a quantile u to t through the bin holding it, so
# an error e of the normalised CDF moves t by dts * e / w, w the bin's
# share of the ray's weight: where a quantile falls in a nearly empty
# bin, a one-ulp CDF difference (6e-8 near 1) moves t by more than 1e-5
# (measured 1.56e-5 in a bin holding 7.8e-5 of the weight).  There a CDF
# slot is held in CDF space instead: within CDF_ATOL (16 ulps near 1).
SELECT_ATOL = 1e-5
CDF_ATOL = 1e-6
# a frame on the card vs on the CPU: bf16 rounding of the MLP activations
# and of the table products can fall differently after a last-bit
# difference in f32 sums, and a prepass hit test on a cell border can
# flip a block; the same bounds as the JAX-parity test of the slice.
FRAME_PSNR_MIN = 45.0
FRAME_MAX_ABS = 5e-2
FRAME_LIVE_MISMATCH = 0.005
# kernel frame vs plain-selection frame on the card: the kernels round
# as the plain versions do, so the frames are expected equal.  Should
# the selections part by an ulp, a quantile whose ray's CDF plateaus (an
# empty gap between the front and back crossings of the shell) at a
# level within rounding of u jumps across the gap in one version only,
# and a few pixels differ by up to a sample's contribution: the bounds
# are on the frame's PSNR, its largest difference and the share of
# pixels that differ by more than 1e-3.
TWIN_FRAME_PSNR_MIN = 60.0
TWIN_FRAME_MAX_ABS = 5e-2
TWIN_FRAME_OFF_SHARE = 1e-3
# deferred (per-ray) shading vs the per-sample frame of the same field and
# selection: the JAX package's bound (tests/test_baked.py:104), the mean
# absolute difference of the images.  A deferred band frame is gated as
# the other band frames (FRAME_*) and within DEFERRED_BAND_ATOL (the CPU
# test's bound) of the single-rank deferred frame: on the card the MLPs'
# GEMM kernels depend on a chunk's row count, and every chunk holds the
# full ray chunk (the last one padded, as in JAX), so a ray's rows go
# through products of one shape whichever chunk holds it.  Its change at
# half the ray chunk is reported beside it (that row-count dependence).
DEFERRED_MEAN_MAX = 0.02
DEFERRED_BAND_ATOL = 1e-4
# trained field: the JAX package's cells after the same 700 steps
# (BENCH_r05.json: 27.07 dB on training view 0, 23.94 dB on the novel
# view), less about 1 dB for the port's other random streams.
TRAIN_PSNR_MIN = 26.0
NOVEL_PSNR_MIN = 23.0
JAX_TRAIN_PSNR, JAX_NOVEL_PSNR = 27.07, 23.94

# Kernel timing (phase 14): the selection kernels at the main path's
# shapes -- the curved live chunk (CDF cap 5), the NGP renders (CDF cap 4)
# and the NGP top-k render (cap 8) -- each over TIMED_LAUNCHES launches.
# Bounds use the H100 SXM's published rates (NVIDIA's data sheet, 700 W):
# HBM3 3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores.
TIMED_SHAPES = [("cdf", 16384, 24, 5), ("cdf", 16384, 24, 4),
                ("topk", 16384, 24, 8)]
TIMED_LAUNCHES = 60
WRAPPER_CALLS, WRAPPER_BATCHES = 100, 5
FLUSH_BYTES = 64 << 20
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

BENCH_NGP = dict(bound=1.0, num_levels=8, level_dim=4, log2_bricks=16,
                 desired_resolution=2048)
# RenderConfig of bench.py's NGP arm
BENCH_RENDER = dict(bound=1.0, cascades=1, grid_size=128, max_steps=384,
                    max_samples_train=192, max_samples_infer=96,
                    ray_chunk=16384, pool_mean_samples=64,
                    pool_mean_samples_infer=24, proxy_samples=0,
                    proxy_refined=24, infer_color_cap=4, prepass_block=8,
                    prepass_tau_cull=0.1)
# TrainConfig of bench.py's NGP arm, and its 50 + 650 steps
BENCH_TRAIN = dict(lr=1e-2, total_steps=2000, num_rays=4096, grid_decay=0.85)
WARM_STEPS, TRAIN_STEPS = 50, 650
# the per-corner grid and the learned background sphere (phase 17), in
# two arms with phase 7's schedule: the per-corner NGP (NGPConfig's
# defaults, 16 levels x 2, 2^19 rows a level, resolution 2048, with
# encoder='hash') on phase 7's scene, each PSNR gated at phase 8's
# packed arm's less BG_PSNR_SLACK (the two encoders hash differently);
# and the same NGP with a background sphere of radius BG_RADIUS around
# the cameras' orbit of radius 2 (the JAX package's
# tests/test_e2e_ngp.py:84), on the same cameras and sphere inside a room
# painted at that radius (RoomScene), its training-view PSNR gated at
# its step-0 frame's plus BG_GAIN_MIN (no packed or JAX cell of that
# scene exists).  The sphere arm's novel view is printed, not gated: on
# an 8-view object scene the sphere arm keeps its grid occupied, a fog
# that the training march integrates and the proxy's 4-8 samples a ray
# decimate (PERF.md, ROADMAP Queue 3; scripts/torch_background_probe.py).
# The composite image = image(bg=0) + (1 - weights_sum) * bg within
# BG_COMPOSITE_ATOL (the same f32 sums in both frames).
BG_NGP = dict(encoder="hash")
BG_RADIUS = 4.0
# the sphere arm's warm-up and timed steps, cut from phase 7's 50 + 650
# to keep the smoke's wall (its gate is its own step-0 frame)
BG_SPHERE_STEPS = (50, 300)
BG_PSNR_SLACK = 1.0
BG_GAIN_MIN = 3.0
BG_COMPOSITE_ATOL = 1e-5
# rays a chunk of the importance frame (128 + 128 samples a ray)
IMPORTANCE_CHUNK = 4096
SMALL_NGP = dict(bound=1.0, num_levels=4, level_dim=4, log2_bricks=10,
                 desired_resolution=256)
SMALL_RENDER = dict(bound=1.0, cascades=1, grid_size=32, ray_chunk=1024,
                    proxy_samples=0, proxy_refined=24, infer_color_cap=4,
                    prepass_block=8, prepass_tau_cull=0.1)
# U(-1e-4, 1e-4) init tables give features ~1e-4 and a flat sigma ~1;
# scaled by 1e4 the seeded field has sigma from ~0.1 to ~10 and varied
# colour, so the frame composites real structure.
TABLE_SCALE = 1e4


# bench.py's curved arm (bench.py:340-367): MeshFieldConfig() defaults,
# the SH light, its RenderConfig and CurvedTrainConfig
CURVED_RENDER = dict(bound=1.0, cascades=1, grid_size=128, max_steps=512,
                     max_samples_train=128, max_samples_infer=96,
                     ray_chunk=16384, pool_mean_samples=64,
                     pool_mean_samples_infer=24, march_steps_infer=256,
                     proxy_samples=0, proxy_refined=24, infer_color_cap=5)
CURVED_TRAIN = dict(lr=1e-2, total_steps=4000, num_rays=4096,
                    grid_update_interval=16, grid_full_updates=0)
# host counts of this mesh and grid (compute_near_cells and the anchor
# table's cKDTree prefilter)
NEAR_CELLS, ANCHOR_CELLS = 398104, 885224
# the small card-vs-CPU curved frame: a narrow field over
# make_icosphere(2, 0.5), grid 32, 64x64
SMALL_FIELD = dict(num_levels=4, level_dim=2, base_resolution=32,
                   desired_resolution=64, log2_bricks=12, h_threshold=0.1)
SMALL_CURVED_RENDER = dict(bound=1.0, cascades=1, grid_size=32,
                           max_steps=128, max_samples_infer=48,
                           ray_chunk=1024, pool_mean_samples_infer=16,
                           proxy_samples=0, proxy_refined=24,
                           infer_color_cap=5)
# bench.py's curved schedule (bench.py:368-385): 17 steps, 48 timed
# steps (3 refresh cycles), the rest to 700
CURVED_WARM_STEPS, CURVED_TIMED_STEPS, CURVED_TRAIN_STEPS = 17, 48, 700
# its baked render (bench.py:455-476): cap 5 K 16 over the block-8 carve,
# then the cap 6 K 20 quality line; the selection kernel at those chunks
CURVED_BAKED = dict(prepass_block=8, prepass_tau_cull=0.1, proxy_refined=16)
CURVED_BAKED_CAP6 = dict(infer_color_cap=6, proxy_refined=20)
BAKED_SHAPES = [(16384, 16, 5), (16384, 20, 6)]
# the JAX package's curved cells after the same 700 steps (BENCH_r05.json)
# and the gates: each less 1 dB for the port's other random streams (the
# margin of the NGP gates); the EMA parity frame also keeps the bench's
# own absolute gate of 24 dB
JAX_CURVED_PSNR = {"live": 26.65, "pool": 26.59, "ema_parity": 26.63,
                   "baked": 26.43, "baked_cap6": 27.16}
CURVED_PSNR_MIN = {k: round(v - 1.0, 2) for k, v in JAX_CURVED_PSNR.items()}
# the texture pipeline (phase 11) at PatchSampleConfig's shapes (128^2
# texels, pattern rate 1/50, 16 centres a batch) with the patch budget
# cut from 2000 to 256, quilted at QuiltingConfig's 2048^2 canvas; the
# narrow card-vs-CPU export: 16^2 texels, 8 patches, a 64^2 canvas
TEXTURE_PATCHES, TEXTURE_SIZE = 256, 2048
TEXTURE_DIR = os.path.join("build", "texture")
SMALL_TEXTURE = dict(patch_size=16, max_patch_num=8, center_batch=4,
                     pattern_rate=1 / 4)
SMALL_TEXTURE_SIZE = 64
# the two-round proxy: RenderConfig's default proxy_samples
TWO_ROUND = dict(proxy_samples=32)
# phase 8's mesh export: main_nerf.py's save_mesh at resolution 256 and
# sigma 10 of the trained NGP; the sphere of the dataset has radius 0.5.
# The sigma-10 set holds floaters of the untrained regions too (a first
# run: 418,530 vertices, mean |r - 0.5| 0.126), so the gate is on the
# sphere being there: >= 90% of 2,000 points spread over it within 0.03
# of a vertex (two cells of the 128^3 training grid: the sigma-10 level
# may sit that far off the surface the rays saw)
NGP_MESH_RES = 256
NGP_MESH_PROBES, NGP_MESH_TOL, NGP_MESH_COVER = 2000, 0.03, 0.9
# the surfaces (phase 12): the target mesh, a rounded box of 24,578
# vertices (make_box subdivided to >= 10,000 vertices, 8 laplacian
# steps); the curved synthesis of phase 11's patches onto its 512^2 UV
# map, cut to fit the smoke: the grid gap 4e-3 in place of the CLI's
# 5e-4 (a patch covers 64x the area) and at most 40 iterations (0.7-1.1
# s each on the card's host, scripts/torch_curved_synthesis.py; 60 set
# 60.8% of the texels), which must set at least SURFACE_MIN_DONE of
# them; unhash at field_io's default of >= 100,000 vertices (the
# template's 163,842 after three subdivisions; its projector's tables
# are built on the card, where the host builder took 116 s of set-up)
SURFACE_DIR = os.path.join("build", "surfaces")
SURFACE_BOX, SURFACE_MIN_VERTICES, SURFACE_SMOOTH = (0.5, 0.35, 0.25), \
    10000, 8
SURFACE_RES = 512
SURFACE_GAP, SURFACE_ITERS = 4e-3, 40
SURFACE_MIN_DONE = 0.3
UNHASH_MIN_VERTICES = 100000
# the grid-table kernels (csrc/spatial_build.cu) against their plain
# versions on phase 12's box target (24,578 vertices) and the template
# subdivided to >= GRID_CHECK_VERTICES (40,962): the cell lists and the
# fallback lists bit for bit; each build's card seconds beside the plain (host) seconds, and the
# kernels' device ms over GRID_TIMED calls.  Bounds: HBM3 3.35 TB/s for
# the binning; the fallback's float64 operations (8 a pair) over the
# H100 SXM's 34 TFLOP/s float64 outside the tensor cores (NVIDIA's data
# sheet, 700 W).
GRID_CHECK_VERTICES = 40000
GRID_TIMED = 3
F64_OPS_PER_S = 34e12
# the narrow card-vs-CPU check of phase 12: phase 11's narrow files, the
# target subdivided to >= 600 vertices, a 64^2 UV map, unhash to >= 2000
# vertices
SMALL_SURFACE = dict(min_vertices=600, resolution=64, grid_gap=0.04,
                     max_iters=60)
SMALL_UNHASH_VERTICES = 2000
# seeded curved params: the encoder's mean lanes are U(-1e-4, 1e-4) and
# the phi grid U(0, 1e-3) at init; scaled by 1e4 and 1e3 the features
# and the fine normals vary and the field has structure
PHI_SCALE = 1e3


def surface_target(min_vertices: int = SURFACE_MIN_VERTICES):
    """The smoke's target mesh for the surface imports: a rounded box
    (``make_box(SURFACE_BOX)`` subdivided to ``min_vertices``, smoothed)."""
    from nerf_texture_tpu_torch.geometry.mesh import make_box
    from nerf_texture_tpu_torch.geometry.shape_tools import (
        laplacian_smooth, subdivide_to)

    return laplacian_smooth(subdivide_to(make_box(SURFACE_BOX), min_vertices),
                            SURFACE_SMOOTH)


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a - b) ** 2))
    return 99.0 if mse <= 1e-12 else -10.0 * float(np.log10(mse))


def cuda_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean device time of fn() in ms over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def selection_inputs(N: int, K: int, seed: int, dev):
    """Seeded [N, K] proxy densities with degenerate spans, empty rays and
    ties (the CPU test's recipe)."""
    rng = np.random.default_rng(seed)
    t_lo = rng.uniform(0.5, 1.5, N).astype(np.float32)
    t_hi = t_lo + rng.uniform(0.0, 1.0, N).astype(np.float32)
    t_hi[: N // 4] = t_lo[: N // 4]
    sig = rng.gamma(0.5, 4.0, (N, K)).astype(np.float32)
    sig[N // 4: N // 2] = 0.0
    sig[N // 2: N // 2 + 4] = 3.0
    frac = (np.arange(K, dtype=np.float32) + 0.5) / K
    ts = t_lo[:, None] + np.maximum(t_hi - t_lo, 0.0)[:, None] * frac
    return [torch.from_numpy(a).to(dev) for a in (ts, sig, t_lo, t_hi)]


def cdf_slack(args, ts2, valid2):
    """Per CDF slot [N, cap], the t error that a CDF_ATOL error of the
    normalised CDF makes in the bin where the plain version put it, at
    most one bin width; 0 on rays without weight (valid2 False)."""
    from nerf_texture_tpu_torch.ops.proxy_select import cumsum_lanes

    _, sig, t_lo, t_hi = args
    K = sig.shape[1]
    dts = torch.clamp(t_hi - t_lo, min=0.0)[:, None] / K
    sdt = sig * dts
    w = torch.exp(-(cumsum_lanes(sdt) - sdt)) * (1.0 - torch.exp(-sdt))
    share = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    b = torch.floor((ts2 - t_lo[:, None]) / torch.clamp(dts, min=1e-30))
    share = torch.gather(share, 1, torch.clamp(b.long(), 0, K - 1))
    slack = torch.minimum(dts * CDF_ATOL / torch.clamp(share, min=1e-12),
                          dts)
    return torch.where(valid2, slack, 0.0)


def check_selection(name, got, ref, N, K, cap, zero_unfilled, args=None):
    """Kernel outputs vs the plain version's: t values within SELECT_ATOL
    (with ``args``, the inverse CDF's inputs, a slot may instead agree
    within CDF_ATOL in CDF space; see the tolerances), valid equal, and
    (top-k) zeros in unfilled slots; returns the max abs error in t."""
    err = max(float((got[i] - ref[i]).abs().max()) for i in (0, 1))
    slack = torch.full_like(ref[0], SELECT_ATOL)
    if args is not None:
        slack = torch.maximum(slack, cdf_slack(args, ref[0], ref[2]))
    # a gap dt2[c] moves with the slots at both of its ends
    slack_dt = torch.maximum(slack, torch.cat([slack[:, 1:], slack[:, -1:]],
                                              dim=1))
    ok = bool(((got[0] - ref[0]).abs() <= slack).all()
              and ((got[1] - ref[1]).abs() <= slack_dt).all())
    check(ok, f"{name} kernel vs plain at [{N}, {K}] cap {cap}: max abs "
          f"err {err} beyond {SELECT_ATOL} (or CDF_ATOL in CDF space)")
    check(bool(torch.equal(got[2], ref[2])),
          f"{name} kernel vs plain valid2 differ at [{N}, {K}] cap {cap}")
    if zero_unfilled:
        off = ~got[2]
        check(bool((got[0][off] == 0).all() and (got[1][off] == 0).all()),
              f"{name}: unfilled slots not zero at [{N}, {K}] cap {cap}")
    return err


def seeded_params(ngp, mcfg, generator):
    params = ngp.init(generator, mcfg)
    params["grid"] = params["grid"] * TABLE_SCALE
    return params


def frame_checks(out, H, W, name):
    img = out["image"]
    check(tuple(img.shape) == (H, W, 3), f"{name}: image shape {img.shape}")
    check(bool(torch.isfinite(img).all()), f"{name}: non-finite pixels")
    check(float(img.min()) >= 0.0, f"{name}: negative pixels")
    check(0 < out["live"] < H * W, f"{name}: live rays {out['live']}")
    check(float(out["weights_sum"].max()) > 0.05,
          f"{name}: no pixel composites any weight")


def check_twin(name, img_k, img_p, card):
    """A kernel frame against its plain-selection frame: PSNR, max abs
    and the share of pixels off by > 1e-3, held to the TWIN_FRAME_*
    limits."""
    t_psnr, t_err = psnr(img_p, img_k), float(np.abs(img_p - img_k).max())
    t_off = float(np.mean(np.abs(img_p - img_k).max(-1) > 1e-3))
    print(f"{name}: kernel frame vs plain-selection frame: PSNR "
          f"{t_psnr:.2f} dB, max abs {t_err:.3g}, pixels off by > 1e-3: "
          f"{t_off:.2e} ({card})")
    check(t_psnr >= TWIN_FRAME_PSNR_MIN and t_err <= TWIN_FRAME_MAX_ABS
          and t_off <= TWIN_FRAME_OFF_SHARE,
          f"{name} kernel frame vs plain-selection frame: PSNR {t_psnr} dB, "
          f"max abs {t_err}, share off {t_off}")


# seconds spent under torch.profiler (the profiled calls and the trace
# export), reported beside the phase walls
PROFILE_S = [0.0]


def kernel_events(fn, cats=("kernel",)):
    """(name, device us) of every CUDA kernel that one call of fn runs,
    under torch.profiler, from the trace's ``cat == "kernel"`` events
    (annotation rows would count a kernel twice); ``cats`` may add
    "gpu_memcpy" for copies.  The device activity alone: the host ops'
    events would only slow the call and the trace's export."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    PROFILE_S[0] += time.perf_counter() - t0
    return [(e.get("name", ""), float(e.get("dur", 0.0))) for e in events
            if e.get("cat") in cats]


def profile_frame(fn):
    """(CUDA kernels, their device ms) of one call of fn."""
    kernels = kernel_events(fn)
    return len(kernels), sum(d for _, d in kernels) / 1e3


def select_bound(kind: str, N: int, K: int, cap: int):
    """(bound ms, "bytes" or "operations", bytes) of one selection call:
    the
    larger of its bytes -- each input read once (sig, and ts for top-k;
    t_lo, t_hi), each output written once (two f32 rows and a bool row of
    cap) -- over HBM_BYTES_PER_S and its f32 operations over
    F32_OPS_PER_S.  Operations count the plain algorithm's: per sample a
    multiply, two Hillis-Steele scans (log2 K adds each), two exp, a few
    subtracts and selects, and (CDF) a divide or (top-k) two compares a
    round; per CDF quantile K compares and ~10 ops."""
    n_in = 2 if kind == "topk" else 1
    nbytes = N * K * 4 * n_in + 2 * N * 4 + N * cap * 9
    lg = int(np.ceil(np.log2(max(K, 2))))
    if kind == "topk":
        ops = N * K * (2 * lg + 8 + 2 * cap)
    else:
        ops = N * (K * (2 * lg + 8) + cap * (K + 10))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return ((t_bytes, "bytes", nbytes) if t_bytes >= t_ops
            else (t_ops, "operations", nbytes))


def time_select(select, args, cap: int, flush) -> dict:
    """Device and host times of one selection wrapper at one shape.

    device_us_warm: median device duration of the selection kernel over
    TIMED_LAUNCHES launches, each right after sig is rewritten (so sig
    sits in L2, as _proxy_sigma leaves it on the render path);
    device_us: the same with ``flush`` (64 MiB, more than the 50 MB L2)
    written before each launch, so the inputs come from HBM -- the
    reading compared with the bound; wrapper_us: host time of a call of
    the wrapper (checks, outputs, launch): the median over WRAPPER_BATCHES
    batches of the mean of WRAPPER_CALLS back-to-back calls, which the
    card runs faster than the host issues them."""
    sig = args[1]
    src = sig.clone()
    name = re.compile(r"select(_cdf|_topk)?_kernel")

    def run(before):
        def go():
            for i in range(TIMED_LAUNCHES):
                before(i)
                select(*args, cap=cap, w_eps=1e-4)
        durs = traced_durations(go, lambda n: name.search(n), ("kernel",),
                                "selection kernels")
        return float(np.median(durs)), len(durs)

    select(*args, cap=cap, w_eps=1e-4)                 # warm-up
    warm, n_warm = run(lambda i: sig.copy_(src))
    cold, n_cold = run(lambda i: flush.fill_(float(i)))
    host = []
    for _ in range(WRAPPER_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WRAPPER_CALLS):
            select(*args, cap=cap, w_eps=1e-4)
        host.append((time.perf_counter() - t0) / WRAPPER_CALLS * 1e6)
    torch.cuda.synchronize()
    return {"device_us": cold, "device_us_warm": warm,
            "wrapper_us": float(np.median(host)),
            "traced": min(n_cold, n_warm)}


def traced_durations(go, pick, cats, what: str) -> list[float]:
    """Device durations (us) of the kernels ``pick`` selects by name in
    a trace of go(), which launches TIMED_LAUNCHES of them.  After the
    curved training phase the trace has been seen to miss some kernel
    records (35 and 57 of 60), so the fullest of three traces is taken
    and must hold at least half of the launches."""
    best: list[float] = []
    for _ in range(3):
        durs = [d for n, d in kernel_events(go, cats) if pick(n)]
        if len(durs) > len(best):
            best = durs
        if len(best) == TIMED_LAUNCHES:
            break
    check(TIMED_LAUNCHES // 2 <= len(best) <= TIMED_LAUNCHES,
          f"{len(best)} {what} traced for {TIMED_LAUNCHES} launches")
    return best


def copy_floor_us(nbytes: int, flush, dev) -> float:
    """Median device time (us) of one Tensor.copy_ that reads and writes
    nbytes / 2 bytes each -- the same traffic as the kernel's -- cold, as
    time_select times it: what one pass over these bytes costs on this
    card at this size, launch and DRAM latency included."""
    src = torch.empty(nbytes // 8, device=dev)
    dst = torch.empty_like(src)

    def go():
        for i in range(TIMED_LAUNCHES):
            flush.fill_(float(i))
            dst.copy_(src)
    durs = traced_durations(go, lambda n: "fill" not in n.lower(),
                            ("kernel", "gpu_memcpy"), "copies")
    return float(np.median(durs))


def timing_phase(dev, card: str) -> dict:
    """Phase 13: device time of both selection kernels at the main path's
    shapes against their bounds, and the wrappers' host time."""
    from nerf_texture_tpu_torch.ops import proxy_select as ops

    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    out = {}
    for seed, (kind, N, K, cap) in enumerate(TIMED_SHAPES):
        args = selection_inputs(N, K, 30 + seed, dev)
        fname = "proxy_select" if kind == "topk" else "proxy_select_cdf"
        res = time_select(getattr(ops, fname), args, cap, flush)
        bound_ms, bound_by, nbytes = select_bound(kind, N, K, cap)
        res.update(bound_ms=bound_ms, bound_by=bound_by,
                   bound_share=bound_ms * 1e3 / res["device_us"],
                   copy_us=copy_floor_us(nbytes, flush, dev))
        out[(kind, N, K, cap)] = res
        print(f"timing: {fname} [{N}, {K}] cap {cap}: kernel "
              f"{res['device_us']:.2f} us cold (HBM), "
              f"{res['device_us_warm']:.2f} us warm (L2); bound "
              f"{bound_ms * 1e3:.3f} us by {bound_by}, "
              f"{100 * res['bound_share']:.1f}% of it cold; a copy_ of "
              f"the same bytes {res['copy_us']:.2f} us; wrapper "
              f"{res['wrapper_us']:.2f} us a call (median of "
              f"{res['traced']} or more of {TIMED_LAUNCHES} launches "
              f"traced, torch.profiler) ({card})")
    del flush
    torch.cuda.empty_cache()
    return out


def seeded_curved(trainer, table_scale: float):
    """Scale the seeded curved params (see PHI_SCALE) and render them."""
    field = trainer.state.params["field"]
    rw = trainer.ccfg.field.feature_spec.row_width
    with torch.no_grad():                # the params are trainable leaves
        field["encoder"][:, :rw] *= table_scale
        field["normal"]["phi_grid"] *= PHI_SCALE
    trainer.state.ema_params = trainer.state.params


def curved_phase(dev, card: str, ds, timing: dict) -> dict:
    """Phase 9: the curved serving path; returns the kernel launches of
    its live frames and the selection error at its shape."""
    from scipy.spatial import cKDTree

    from nerf_texture_tpu_torch.data.poses import orbit_pose
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector
    from nerf_texture_tpu_torch.models import mesh_field
    from nerf_texture_tpu_torch.models.curved_field import CurvedFieldConfig
    from nerf_texture_tpu_torch.models.mesh_field import MeshFieldConfig
    from nerf_texture_tpu_torch.ops.proxy_select import (
        proxy_select_cdf, proxy_select_cdf_reference)
    from nerf_texture_tpu_torch.render.renderer import RenderConfig
    from nerf_texture_tpu_torch.train.curved_trainer import (
        CurvedTrainConfig, CurvedTrainer)

    # The normal net's Lipschitz MLPs and the SH products multiply f32
    # operands, which TF32 would round: full f32 for the curved frames.
    torch.backends.cuda.matmul.allow_tf32 = False
    H = W = ds.H
    ccfg = CurvedFieldConfig(field=MeshFieldConfig(), light_model="SH")
    rcfg = RenderConfig(**CURVED_RENDER)
    tcfg = CurvedTrainConfig(**CURVED_TRAIN)

    # -- host set-up ----------------------------------------------------
    t0 = time.perf_counter()
    mesh = make_icosphere(4, radius=0.5)
    mp = MeshProjector(mesh, device=dev)
    proj_s = time.perf_counter() - t0
    tr = CurvedTrainer(ds, mesh_field.make_state(mp), ccfg, rcfg, tcfg,
                       seed=7, device=dev)
    seeded_curved(tr, TABLE_SCALE)
    t0 = time.perf_counter()
    near = tr._get_near_cells()
    near_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tab = tr._anchor_table()
    torch.cuda.synchronize()
    tab_s = time.perf_counter() - t0
    cell = 2.0 * rcfg.bound / rcfg.grid_size
    G = rcfg.grid_size
    c = (np.arange(G) + 0.5) / G * 2.0 - 1.0
    d, _ = cKDTree(mp.arrays.vertices.cpu().numpy()).query(
        np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3),
        workers=-1)
    prefilter = int(np.sum(d < 4.0 * ccfg.field.h_threshold + 2.0 * cell))
    spec = ccfg.field.feature_spec
    print(f"curved: {len(mesh.vertices)} vertices, {len(mesh.faces)} faces "
          f"({mp.arrays.vertices.shape[0]} after the UV atlas); hash "
          f"{spec.num_levels} levels x {spec.level_dim}, "
          f"{spec.table_rows} x {spec.dual_storage_width} dual table; "
          f"grid {G}^3")
    print(f"curved: set-up: MeshProjector {proj_s:.2f} s, near cells "
          f"{near.shape[0]} in {near_s:.2f} s, anchor table over "
          f"{prefilter} cells in {tab_s:.2f} s "
          f"({int((tab[..., 15] > 0.5).sum())} hit) ({card})")
    check(near.shape[0] == NEAR_CELLS, f"near cells {near.shape[0]}")
    check(prefilter == ANCHOR_CELLS, f"anchor prefilter {prefilter}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.initialize_states(1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    occupied = int(tr.state.occ.occ.sum())
    print(f"curved: initialize_states(1) in {init_s:.3f} s; {occupied} of "
          f"{G ** 3} cells occupied ({card})")
    check(0 < occupied < G ** 3, f"occupied cells {occupied}")

    # -- the kernel at this slice's shape --------------------------------
    N, K, cap = rcfg.ray_chunk, rcfg.proxy_refined, rcfg.infer_color_cap
    args = selection_inputs(N, K, 20, dev)
    got = proxy_select_cdf(*args, cap=cap, w_eps=1e-4)
    ref = proxy_select_cdf_reference(*args, cap=cap, w_eps=1e-4)
    torch.cuda.synchronize()
    err = check_selection("proxy_select_cdf", got, ref, N, K, cap,
                          zero_unfilled=False, args=args)
    plain = cuda_ms(lambda: proxy_select_cdf_reference(*args, cap=cap,
                                                       w_eps=1e-4))
    timing[(N, K, cap)] = plain
    print(f"kernel: proxy_select_cdf [{N}, {K}] cap {cap}: max abs err "
          f"{err:.3g}; plain version {plain * 1e3:.2f} us a call ({card})")

    # -- live and pool frames ---------------------------------------------
    poses = [orbit_pose(1.25 + 0.1 * i, 2 * np.pi * (i + 0.5) / 8, 2.0)
             for i in range(4)]
    stats = {}
    for name, parity in (("live", False), ("pool", True)):
        tr.render_frame(poses[0], parity=parity)          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = proxy_select_cdf.launches
        walls, outs = [], []
        for pose in poses[1:]:
            t0 = time.perf_counter()
            outs.append(tr.render_frame(pose, parity=parity))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        launches = proxy_select_cdf.launches - before
        chunks = sum(o["chunks"] for o in outs)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        for o in outs:
            frame_checks(o, H, W, f"curved {name}")
        if parity:
            check(launches == 0, f"the pool path launched {launches} "
                  f"selection kernels")
        else:
            check(launches > 0 and launches == chunks,
                  f"curved live: {launches} kernel launches for {chunks} "
                  f"chunks")
        n_k, k_ms = profile_frame(lambda: tr.render_frame(poses[1],
                                                          parity=parity))
        stats[name] = dict(walls=walls, outs=outs, launches=launches,
                           chunks=chunks, peak=peak, kernels=n_k,
                           kernel_ms=k_ms)
    live = stats["live"]
    img_k = live["outs"][0]["image"].cpu().numpy()
    img_p = tr.render_frame(poses[1], plain_select=True)["image"].cpu().numpy()
    check_twin("curved: live", img_k, img_p, card)
    p_lp = psnr(stats["pool"]["outs"][0]["image"].cpu().numpy(), img_k)
    for name in ("live", "pool"):
        st = stats[name]
        print(f"curved: {name} {H}x{W}: "
              f"{', '.join(f'{w:.2f}' for w in st['walls'])} ms/frame "
              f"(median {float(np.median(st['walls'])):.2f}) over "
              f"{len(st['walls'])} novel poses; live rays "
              f"{[o['live'] for o in st['outs']]}; chunks/frame "
              f"{[o['chunks'] for o in st['outs']]}; proxy_select_cdf "
              f"launches {st['launches']}; peak memory {st['peak']:.1f} "
              f"MiB; one profiled frame: {st['kernels']} CUDA kernels, "
              f"{st['kernel_ms']:.2f} ms of kernel time ({card})")
    print(f"curved: pool frame vs live frame at the same pose: PSNR "
          f"{p_lp:.2f} dB (seeded weights; not a quality gate) ({card})")

    # -- a small frame on the card vs the CPU port -------------------------
    small = {}
    for name, dev_i in (("cpu", torch.device("cpu")), ("cuda", dev)):
        ccfg_s = CurvedFieldConfig(field=MeshFieldConfig(**SMALL_FIELD),
                                   light_model="SH")
        ds_s = type(ds)(n_frames=2, H=64, W=64)
        tr_s = CurvedTrainer(ds_s, mesh_field.make_state(MeshProjector(
            make_icosphere(2, radius=0.5), device=dev_i)), ccfg_s,
            RenderConfig(**SMALL_CURVED_RENDER), tcfg, seed=0, device=dev_i)
        if name == "cpu":
            seeded_curved(tr_s, TABLE_SCALE)
            tr_s.initialize_states(1)
            ref_state = tr_s.state
        else:
            tr_s.state.params = tree_to(ref_state.params, dev_i)
            tr_s.state.ema_params = tr_s.state.params
            tr_s.state.occ = type(ref_state.occ)(
                *(t.to(dev_i) for t in ref_state.occ))
        pose = orbit_pose(1.2, 0.7, 2.0)
        small[name] = [tr_s.render_frame(pose, parity=par)
                       for par in (False, True)]
    for i, name in enumerate(("live", "pool")):
        a = small["cuda"][i]["image"].cpu().numpy()
        b = small["cpu"][i]["image"].cpu().numpy()
        live_a = small["cuda"][i]["weights_sum"].cpu().numpy() > 0
        live_b = small["cpu"][i]["weights_sum"].cpu().numpy() > 0
        p_s, e_s = psnr(a, b), float(np.abs(a - b).max())
        mism = float(np.mean(live_a != live_b))
        print(f"curved parity: {name} 64x64 frame card vs CPU: PSNR "
              f"{p_s:.2f} dB, max abs {e_s:.3g}, live mismatch {mism:.4f} "
              f"({int(live_b.sum())} live on CPU) ({card})")
        check(live_b.any() and b[live_b].std() > 1e-2,
              f"the small {name} frame has no structure")
        check(p_s >= FRAME_PSNR_MIN and e_s <= FRAME_MAX_ABS
              and mism <= FRAME_LIVE_MISMATCH,
              f"curved {name} card vs CPU: PSNR {p_s} dB, max abs {e_s}, "
              f"live mismatch {mism}")
    torch.backends.cuda.matmul.allow_tf32 = True
    return {"launches": live["launches"], "max_abs_err": err}


def op_shares(fn, top: int = 8):
    """(op, share of the device time) of the ``top`` aten ops by self
    device time over one call of fn (torch.profiler's key_averages)."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()]
    PROFILE_S[0] += time.perf_counter() - t0
    rows = [(k, t) for k, t in rows if t > 0 and k.startswith("aten::")]
    total = sum(t for _, t in rows) or 1.0
    return [(k[6:], t / total) for k, t in sorted(rows, key=lambda r: -r[1])
            ][:top]


def room_colour(polar: np.ndarray) -> np.ndarray:
    """[..., 3] paint of phase 17's room, a smooth colour field over the
    normalised polar coordinates [..., 2] of ``ops.polar_from_ray``."""
    theta = (polar[..., 0] + 1.0) * np.pi / 2
    phi = polar[..., 1] * np.pi
    return np.stack([0.5 + 0.3 * np.sin(4 * phi) * np.sin(3 * theta),
                     0.5 + 0.3 * np.cos(5 * theta),
                     0.5 + 0.3 * np.sin(3 * phi + 2 * theta)],
                    -1).astype(np.float32)


def room_gt(ds, pose, radius: float = BG_RADIUS) -> np.ndarray:
    """[H, W, 3] the synthetic sphere seen from ``pose`` inside a painted
    sphere of ``radius`` (phase 17's scene): each miss ray shows the
    paint where it leaves the room, a background with parallax between
    the cameras."""
    fx, fy, cx, cy = ds.intrinsics
    j, i = np.meshgrid(np.arange(ds.H, dtype=np.float32),
                       np.arange(ds.W, dtype=np.float32), indexing="ij")
    d = np.stack([(i + 0.5 - cx) / fx, (j + 0.5 - cy) / fy,
                  np.ones_like(i)], -1)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True) @ pose[:3, :3].T
    o = np.asarray(pose[:3, 3], np.float64)
    b = d @ o
    t = -b + np.sqrt(np.maximum(b * b - (o @ o - radius ** 2), 0.0))
    p = o + t[..., None] * d
    theta = np.arctan2(np.sqrt(p[..., 0] ** 2 + p[..., 2] ** 2), p[..., 1])
    phi = np.arctan2(p[..., 2], p[..., 0])
    paint = room_colour(np.stack([2 * theta / np.pi - 1, phi / np.pi], -1))
    from nerf_texture_tpu_torch.data.synthetic import render_gt_sphere

    gt = render_gt_sphere(pose, ds.intrinsics, ds.H, ds.W,
                          ds.sphere_radius).astype(np.float32) / 255.0
    return gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:]) * paint


class RoomScene:
    """``ds``'s cameras with RGB frames of ``room_gt``: phase 17's
    scene."""

    def __init__(self, ds):
        self.poses, self.intrinsics = ds.poses, ds.intrinsics
        self.H, self.W, self.num_frames = ds.H, ds.W, ds.num_frames
        self.radius, self.sphere_radius = ds.radius, ds.sphere_radius
        self.images = np.stack([np.round(np.clip(room_gt(ds, p), 0, 1)
                                         * 255).astype(np.uint8)
                                for p in ds.poses])


def white_gt(ds, pose):
    """The analytic ground truth of a pose on a white background."""
    from nerf_texture_tpu_torch.data.synthetic import render_gt_sphere

    gt = render_gt_sphere(pose, ds.intrinsics, ds.H, ds.W, ds.sphere_radius)
    a = gt[..., 3:].astype(np.float32) / 255.0
    return gt[..., :3].astype(np.float32) / 255.0 * a + (1.0 - a)


def timed_frames(render, poses, kernel=None):
    """(ms per frame, outputs, launches of ``kernel`` (proxy_select_cdf
    by default), chunks) over the poses; the kernel's count is set to 0
    first and read after."""
    from nerf_texture_tpu_torch.ops.proxy_select import proxy_select_cdf

    kernel = kernel or proxy_select_cdf
    kernel.launches = 0
    walls, outs = [], []
    for pose in poses:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(render(pose))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls, outs, kernel.launches, sum(o["chunks"] for o in outs)


def deferred_frames(name, render, poses, gt, kernel, card: str) -> dict:
    """Deferred (per-ray) shading against the per-sample frame of the same
    field and selection: ``render(pose, deferred, plain_select)``.  The
    deferred and per-sample frames in turns at the poses through
    ``kernel`` (its count set to 0 before them; the deferred frames'
    launches == their chunks), the first deferred frame bit for bit with
    its plain-selection frame and within DEFERRED_MEAN_MAX (mean abs) of
    its per-sample frame; ms a frame (median over the poses after a
    warm-up), kernels and their device ms in one profiled frame, and the
    PSNR against ``gt`` at poses[0], for both.  Returns the launches."""
    from nerf_texture_tpu_torch.utils.metrics import psnr as psnr_of

    t0 = time.perf_counter()
    render(poses[0], True, False)                        # warm-ups
    render(poses[0], False, False)
    # in turns, deferred then per-sample at each pose; the deferred
    # frames' launches are the count's increase over their calls
    walls, walls_ps, outs, outs_ps = [], [], [], []
    kernel.launches = launches = 0
    for pose in poses:
        for deferred, w, o in ((True, walls, outs),
                               (False, walls_ps, outs_ps)):
            before = kernel.launches
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            o.append(render(pose, deferred, False))
            torch.cuda.synchronize()
            w.append((time.perf_counter() - t1) * 1e3)
            if deferred:
                launches += kernel.launches - before
    chunks = sum(o["chunks"] for o in outs)
    check(launches > 0 and launches == chunks,
          f"{name} deferred: {launches} kernel launches for {chunks} chunks")
    plain = render(poses[0], True, True)
    for k in ("image", "depth", "weights_sum"):
        check(bool(torch.equal(outs[0][k], plain[k])),
              f"{name} deferred: the kernel frame's {k} differs from its "
              f"plain-selection frame")
    for o in outs:
        frame_checks(o, o["image"].shape[0], o["image"].shape[1],
                     f"{name} deferred")
    mean = float((outs[0]["image"] - outs_ps[0]["image"]).abs().mean())
    n_k, k_ms = profile_frame(lambda: render(poses[1], True, False))
    n_ps, k_ps = profile_frame(lambda: render(poses[1], False, False))
    p_def, p_ps = (psnr_of(outs[0]["image"], gt),
                   psnr_of(outs_ps[0]["image"], gt))
    print(f"deferred: {name}: deferred {float(np.median(walls)):.2f} ms/frame "
          f"(median of {', '.join(f'{w:.2f}' for w in walls)}), {n_k} CUDA "
          f"kernels, {k_ms:.2f} ms of kernel time, PSNR {p_def:.2f} dB; "
          f"per-sample {float(np.median(walls_ps)):.2f} ms/frame (median of "
          f"{', '.join(f'{w:.2f}' for w in walls_ps)}), {n_ps} kernels, "
          f"{k_ps:.2f} ms, PSNR {p_ps:.2f} dB; deferred - per-sample PSNR "
          f"{p_def - p_ps:+.2f} dB, kernel time {k_ms - k_ps:+.2f} ms "
          f"({100 * (k_ps - k_ms) / k_ps:.1f}% of the per-sample frame's "
          f"removed); mean abs vs per-sample {mean:.4g} (< "
          f"{DEFERRED_MEAN_MAX}); kernel frame == plain-selection frame bit "
          f"for bit; {launches} launches for {chunks} chunks; "
          f"{time.perf_counter() - t0:.1f} s for the pair ({card})")
    check(mean < DEFERRED_MEAN_MAX, f"{name} deferred: mean abs {mean} vs "
          f"the per-sample frame")
    return launches


def curved_train_phase(dev, card: str, ds, timing: dict,
                       seed: int = 7) -> dict:
    """Phase 10: curved training at the width of bench.py's curved arm
    (its schedule: initialize_states(1), train(17), a timed train(48),
    the rest to 700 steps; the trainer seeded ``seed``), then the trained
    field at the novel pose: the live, pool and EMA parity frames, the
    bake, the baked frames at cap 5 K 16 and cap 6 K 20, each PSNR gated
    against the JAX package's cell.  Returns the selection launches of
    the trained live and baked frames, the selection error at the baked
    shapes and the PSNR cells, and the trainer."""
    from nerf_texture_tpu_torch.data.poses import orbit_pose
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector
    from nerf_texture_tpu_torch.models import mesh_field
    from nerf_texture_tpu_torch.models.curved_field import CurvedFieldConfig
    from nerf_texture_tpu_torch.models.mesh_field import MeshFieldConfig
    from nerf_texture_tpu_torch.ops.proxy_select import (
        proxy_select_cdf, proxy_select_cdf_reference)
    from nerf_texture_tpu_torch.render.renderer import RenderConfig
    from nerf_texture_tpu_torch.train.curved_trainer import (
        CurvedTrainConfig, CurvedTrainer)
    from nerf_texture_tpu_torch.utils.metrics import psnr as psnr_of

    # training multiplies f32 gradients, and the curved shading f32
    # operands, which TF32 would round: full f32
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- the selection kernel at the baked render's shapes -----------------
    err = 0.0
    for seed, (N, K, cap) in enumerate(BAKED_SHAPES):
        args = selection_inputs(N, K, 50 + seed, dev)
        got = proxy_select_cdf(*args, cap=cap, w_eps=1e-4)
        ref = proxy_select_cdf_reference(*args, cap=cap, w_eps=1e-4)
        torch.cuda.synchronize()
        e = check_selection("proxy_select_cdf", got, ref, N, K, cap,
                            zero_unfilled=False, args=args)
        err = max(err, e)
        plain = cuda_ms(lambda: proxy_select_cdf_reference(
            *args, cap=cap, w_eps=1e-4))
        timing[(N, K, cap)] = plain
        print(f"kernel: proxy_select_cdf [{N}, {K}] cap {cap}: max abs err "
              f"{e:.3g}; plain version {plain * 1e3:.2f} us a call ({card})")

    # -- training -----------------------------------------------------------
    ccfg = CurvedFieldConfig(field=MeshFieldConfig(), light_model="SH")
    rcfg = RenderConfig(**CURVED_RENDER)
    tcfg = CurvedTrainConfig(**CURVED_TRAIN)
    tr = CurvedTrainer(ds, mesh_field.make_state(MeshProjector(
        make_icosphere(4, radius=0.5), device=dev)), ccfg, rcfg, tcfg,
        seed=seed, device=dev)
    tr._get_near_cells()                     # host set-up, timed in phase 9
    tr._anchor_table()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr.initialize_states(1)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    first = tr.train(CURVED_WARM_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = tr.train(CURVED_TIMED_STEPS)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    # one step without a refresh (the count is not a multiple of 16)
    check(tr.state.step % tcfg.grid_update_interval != 0,
          "the profiled step would refresh the grid")
    n_k, k_ms = profile_frame(lambda: tr.train(1))
    shares = op_shares(lambda: tr.train(1))
    rest = tr.train(CURVED_TRAIN_STEPS - tr.state.step)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = np.asarray(first["losses"] + timed["losses"] + rest["losses"])
    its = CURVED_TIMED_STEPS / timed_s
    occupied = int(tr.state.occ.occ.sum())
    print(f"curved train: loss step 1 {first['losses'][0]:.5f}, step "
          f"{CURVED_WARM_STEPS} {first['losses'][-1]:.5f}, step "
          f"{tr.state.step} {rest['loss']:.5f}; {CURVED_TIMED_STEPS} steps "
          f"(3 refresh cycles) in {timed_s:.2f} s = {its:.2f} it/s; one "
          f"profiled step: {n_k} CUDA kernels, {k_ms:.2f} ms of kernel time "
          f"({card})")
    print(f"curved train: by op (self device time of one step): "
          f"{', '.join(f'{k} {100 * s:.1f}%' for k, s in shares)} ({card})")
    print(f"curved train: a grid refresh {refresh_s:.3f} s; "
          f"{int(tr.state.occ.iter_density)} refreshes, {occupied} of "
          f"{rcfg.grid_size ** 3} cells occupied; peak memory {peak:.1f} "
          f"MiB ({card})")
    check(bool(np.isfinite(losses).all()), "non-finite curved training loss")
    check(tr.state.step == CURVED_TRAIN_STEPS, f"{tr.state.step} steps")
    check(0 < occupied < rcfg.grid_size ** 3, f"occupied cells {occupied}")

    # -- the trained field at the novel pose --------------------------------
    npose = orbit_pose(np.pi / 2 + 0.2, 0.3, ds.radius)
    gt = white_gt(ds, npose)
    timed_poses = [ds.poses[1 + i] for i in range(3)]
    tr.render_frame(ds.poses[0], use_ema=False)               # warm-up
    walls, outs, live_launches, live_chunks = timed_frames(
        lambda p: tr.render_frame(p, use_ema=False), [npose] + timed_poses)
    check(live_launches > 0 and live_launches == live_chunks,
          f"trained live: {live_launches} kernel launches for {live_chunks} "
          f"chunks")
    for o in outs:
        frame_checks(o, ds.H, ds.W, "trained live")
    live_img = outs[0]["image"]
    psnrs = {"live": psnr_of(live_img, gt)}
    check_twin("curved trained live", live_img.cpu().numpy(),
               tr.render_frame(npose, use_ema=False,
                               plain_select=True)["image"].cpu().numpy(),
               card)
    pool = tr.render_frame(npose, use_ema=False, parity=True)["image"]
    psnrs["pool"] = psnr_of(pool, gt)
    pool_minimum(tr, npose, pool, card)
    psnrs["ema_parity"] = psnr_of(tr.render_frame(npose, use_ema=True,
                                                  parity=True)["image"], gt)
    live_ms = walls[1:]
    live_prof = profile_frame(lambda: tr.render_frame(timed_poses[0],
                                                      use_ema=False))

    # -- the bake and the baked frames --------------------------------------
    tr.rcfg = dataclasses.replace(rcfg, **CURVED_BAKED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bake, _ = tr.bake_atlas()
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    tiles = int(bake.tile_of_cell.max()) + 1
    tr.render_frame(ds.poses[0], use_ema=False, baked=True)   # warm-up
    walls, outs, baked_launches, baked_chunks = timed_frames(
        lambda p: tr.render_frame(p, use_ema=False, baked=True),
        [npose] + timed_poses)
    check(baked_launches > 0 and baked_launches == baked_chunks,
          f"baked: {baked_launches} kernel launches for {baked_chunks} "
          f"chunks")
    for o in outs:
        frame_checks(o, ds.H, ds.W, "baked")
    psnrs["baked"] = psnr_of(outs[0]["image"], gt)
    check_twin("curved baked", outs[0]["image"].cpu().numpy(),
               tr.render_frame(npose, use_ema=False, baked=True,
                               plain_select=True)["image"].cpu().numpy(),
               card)
    baked_ms = walls[1:]
    baked_prof = profile_frame(lambda: tr.render_frame(
        timed_poses[0], use_ema=False, baked=True))
    # the discriminator of the baked frame's drift: the live field at the
    # baked arm's settings (K 16, cap 5, block 8, tau_cull 0.1)
    psnrs["live_k16"] = psnr_of(tr.render_frame(npose, use_ema=False)[
        "image"], gt)

    def baked_frame(pose, deferred, plain):
        saved = tr.rcfg
        tr.rcfg = dataclasses.replace(saved, deferred=deferred)
        try:
            return tr.render_frame(pose, use_ema=False, baked=True,
                                   plain_select=plain)
        finally:
            tr.rcfg = saved

    # deferred shading of the baked atlas, at K 16 cap 5 and K 20 cap 6
    deferred_launches = deferred_frames(
        f"curved baked K 16 cap 5 {ds.H}x{ds.W}", baked_frame,
        [npose] + timed_poses[:2], gt, proxy_select_cdf, card)
    tr.rcfg = dataclasses.replace(tr.rcfg, **CURVED_BAKED_CAP6)
    proxy_select_cdf.launches = 0
    out6 = tr.render_frame(npose, use_ema=False, baked=True)
    check(proxy_select_cdf.launches == out6["chunks"],
          "baked cap 6: launches != chunks")
    baked_launches += proxy_select_cdf.launches
    psnrs["baked_cap6"] = psnr_of(out6["image"], gt)
    deferred_launches += deferred_frames(
        f"curved baked K 20 cap 6 {ds.H}x{ds.W}", baked_frame,
        [npose] + timed_poses[:2], gt, proxy_select_cdf, card)
    print(f"curved bake: {bake_s:.2f} s, {tiles} tiles of {bake.T}x{bake.T} "
          f"texels, atlas {bake.atlas.shape[0]} x {bake.atlas.shape[1]} "
          f"bf16 ({card})")
    for name, ms, chunks, (n_k, k_ms) in (
            ("live", live_ms, live_chunks, live_prof),
            ("baked", baked_ms, baked_chunks, baked_prof)):
        print(f"curved trained {name} {ds.H}x{ds.W}: "
              f"{', '.join(f'{w:.2f}' for w in ms)} ms/frame (median "
              f"{float(np.median(ms)):.2f}) over {len(ms)} poses; "
              f"{chunks} chunks and as many launches over 4 frames; one "
              f"profiled frame: {n_k} CUDA kernels, {k_ms:.2f} ms of kernel "
              f"time ({card})")
    for name in CURVED_PSNR_MIN:
        print(f"curved quality: {name} {psnrs[name]:.2f} dB at the novel pose "
              f"(JAX package {JAX_CURVED_PSNR[name]}, gap "
              f"{psnrs[name] - JAX_CURVED_PSNR[name]:+.2f}; gate "
              f">= {CURVED_PSNR_MIN[name]}) ({card})")
    for name, floor in CURVED_PSNR_MIN.items():
        check(psnrs[name] >= floor, f"curved {name} PSNR {psnrs[name]:.2f} "
              f"< {floor}")
    print(f"curved quality: at the baked arm's settings (K 16, cap 5): live "
          f"{psnrs['live_k16']:.2f} dB, baked {psnrs['baked']:.2f} dB; pool - "
          f"live K16 {psnrs['pool'] - psnrs['live_k16']:+.2f} dB, pool - "
          f"baked {psnrs['pool'] - psnrs['baked']:+.2f} dB ({card})")
    check(psnrs["ema_parity"] >= 24.0, "the EMA parity gate is below 24 dB")
    del bake
    tr.rcfg = rcfg
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = True
    return {"live": live_launches, "baked": baked_launches,
            "baked_deferred": deferred_launches,
            "max_abs_err": err, "psnr_live": psnrs["live"],
            "psnrs": psnrs}, tr


def pool_minimum(tr, pose, image, card: str):
    """Prints the trained pool frame's minimum pixel and its negative
    values (ROADMAP Queue 3 item 3), then, as probes only, the same frame
    with ``seg_sum``'s cumulative sums in f64, and with those and
    ``flat_weights``' in f64 too: a ray's weights_sum and transmittance
    are differences of f32 running sums over the whole chunk's samples,
    whose rounding can lift weights_sum past 1 and turn (1 - weights_sum)
    * bg negative."""
    from nerf_texture_tpu_torch.render import compact, renderer

    seg_sum, flat_weights = compact.seg_sum, compact.flat_weights

    def seg_sum_f64(x, offsets):
        if not x.is_floating_point():
            return seg_sum(x, offsets)
        return seg_sum(x.to(torch.float64), offsets).to(x.dtype)

    def flat_weights_f64(sigmas, flat):
        w, trans = flat_weights(sigmas.to(torch.float64), flat._replace(
            dts=flat.dts.to(torch.float64)))
        return w.to(sigmas.dtype), trans.to(sigmas.dtype)

    def frame(**patch):
        for name, fn in patch.items():
            setattr(renderer, name, fn)
            setattr(compact, name, fn)
        try:
            return tr.render_frame(pose, use_ema=False, parity=True)["image"]
        finally:
            for name, fn in (("seg_sum", seg_sum),
                             ("flat_weights", flat_weights)):
                setattr(renderer, name, fn)
                setattr(compact, name, fn)

    probes = {"seg_sum in f64": frame(seg_sum=seg_sum_f64),
              "seg_sum and flat_weights in f64": frame(
                  seg_sum=seg_sum_f64, flat_weights=flat_weights_f64)}
    print(f"curved pool: minimum pixel {float(image.min()):.6f}, "
          f"{int((image < 0).sum())} negative values (f32 as the frame "
          f"runs); probes: " + "; ".join(
              f"{k}: {float(v.min()):.6f}, {int((v < 0).sum())} negative, "
              f"max abs from the f32 frame {float((v - image).abs().max()):.3g}"
              for k, v in probes.items()) + f" ({card})")


def quilt(field_path: str, tex_path: str, size: int) -> tuple:
    """Quilt a field npz's patches into a size^2 canvas and write the
    texture npz with the flat quilting CLI,
    ``patch_matching_and_quilting_torch.py`` (a subprocess; its log
    cli_quilt_<size>.log beside the other CLIs'); returns the canvas's
    shape."""
    code, out, _ = cli_run(["patch_matching_and_quilting_torch.py",
                            field_path, "--output_size", str(size), "--out",
                            tex_path], f"cli_quilt_{size}")
    check(code == 0 and f"saved {tex_path}" in out,
          f"patch_matching_and_quilting_torch.py exited {code}: "
          f"{out[-2000:]}")
    with np.load(tex_path, allow_pickle=True) as tex:
        return tex["features"].shape


def facing_pose(normal, radius: float, tilt: float = 0.0):
    """An orbit pose (looking at the origin) from the direction of
    ``normal``, tilted by ``tilt`` in both angles."""
    from nerf_texture_tpu_torch.data.poses import orbit_pose

    n = np.asarray(normal, np.float64)
    n = n / np.linalg.norm(n)
    return orbit_pose(float(np.arccos(np.clip(n[1], -1, 1))) + tilt,
                      float(np.arctan2(n[0], n[2])) + tilt, radius)


def canvas_share(pose, intrinsics, H: int, W: int, bounds) -> float:
    """Share of the frame's rays that hit the z = 0 canvas of half-extents
    ``bounds``."""
    from nerf_texture_tpu_torch.data.rays import get_rays

    r = get_rays(torch.as_tensor(pose), torch.as_tensor(intrinsics), H, W)
    o, d = r["rays_o"], r["rays_d"]
    t = -o[:, 2] / torch.where(d[:, 2].abs() > 1e-9, d[:, 2], 1e-9)
    p = o + t[:, None] * d
    hit = (t > 0) & (p[:, 0].abs() <= float(bounds[0])) \
        & (p[:, 1].abs() <= float(bounds[1]))
    return float(hit.float().mean())


def import_frames(tr, name, poses, kernel, card):
    """800x800 frames of an imported texture (``name`` labels its lines):
    a warm-up, then the timed poses[1:] with ``kernel``'s launches ==
    chunks, frame checks, a frame re-rendered with the plain selection
    held to its kernel frame, one profiled frame; returns (launches, the
    first timed frame, its profiled kernel ms)."""
    H, W = tr.H, tr.W
    tr.render_frame(poses[0], use_ema=False)                  # warm-up
    walls, outs, launches, chunks = timed_frames(
        lambda p: tr.render_frame(p, use_ema=False), poses[1:], kernel)
    check(launches > 0 and launches == chunks,
          f"{name}: {launches} kernel launches for {chunks} chunks")
    for o in outs:
        frame_checks(o, H, W, name)
    check_twin(name, outs[0]["image"].cpu().numpy(),
               tr.render_frame(poses[1], use_ema=False, plain_select=True)[
                   "image"].cpu().numpy(), card)
    n_k, k_ms = profile_frame(lambda: tr.render_frame(poses[1],
                                                      use_ema=False))
    print(f"{name} {H}x{W}: "
          f"{', '.join(f'{w:.2f}' for w in walls)} ms/frame (median "
          f"{float(np.median(walls)):.2f}) over {len(walls)} poses; live rays "
          f"{[o['live'] for o in outs]}; {kernel.__name__} launches "
          f"{launches} for {chunks} chunks; one profiled frame: {n_k} CUDA "
          f"kernels, {k_ms:.2f} ms of kernel time ({card})")
    return launches, outs[0], k_ms


def texture_phase(dev, card: str, ds, tr) -> dict:
    """Phase 11: the flat texture pipeline on the trained curved field
    ``tr`` (bench width, its RenderConfig); returns the launches of each
    import path's frames and the grid-sample / kNN shares."""
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
    from nerf_texture_tpu_torch.geometry.projector import weighted_project
    from nerf_texture_tpu_torch.ops.proxy_select import (proxy_select,
                                                         proxy_select_cdf)
    from nerf_texture_tpu_torch.render.renderer import RenderConfig
    from nerf_texture_tpu_torch.synthesis.patches import PatchSampleConfig
    from nerf_texture_tpu_torch.train import field_io
    from nerf_texture_tpu_torch.utils.grid_sample import grid_sample_2d

    torch.backends.cuda.matmul.allow_tf32 = False      # curved shading
    os.makedirs(TEXTURE_DIR, exist_ok=True)
    field_path = os.path.join(TEXTURE_DIR, "field.npz")
    tex_path = os.path.join(TEXTURE_DIR, "texture.npz")
    rcfg = RenderConfig(**CURVED_RENDER)
    tr.rcfg = rcfg
    mesh = make_icosphere(4, radius=0.5)

    # -- export, quilt ----------------------------------------------------
    scfg = PatchSampleConfig(max_patch_num=TEXTURE_PATCHES)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp = field_io.save_field(tr, field_path, mesh=mesh, scfg=scfg,
                              stats=stats)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    kept = exp["patches"].shape[0]
    print(f"texture: export {export_s:.2f} s: {stats['candidates']} candidate "
          f"centres, {kept} patches kept of {scfg.patch_size}^2 texels "
          f"(grid gap {exp['grid_gap']:.3g}), {stats['rays']} texel rays cast "
          f"= {stats['rays'] / export_s:.4g} rays/s (with the projection and "
          f"encode of the kept texels) ({card})")
    # the y >= 0 veto drops about half of the 2x oversampled candidates,
    # as in the JAX package: the budget is a ceiling
    check(TEXTURE_PATCHES // 2 <= kept <= TEXTURE_PATCHES,
          f"{kept} patches kept")
    check(all(np.isfinite(exp[k]).all() for k in ("patches",
                                                  "patch_phi_embed",
                                                  "patch_local_tbn")),
          "non-finite exported channels")
    check(float(np.abs(exp["patches"]).max()) > 0, "the exported features "
          "are all zero")
    t0 = time.perf_counter()
    shape = quilt(field_path, tex_path, TEXTURE_SIZE)
    quilt_s = time.perf_counter() - t0
    print(f"texture: quilting {quilt_s:.2f} s (patch_matching_and_quilting_"
          f"torch.py, host), canvas {shape[0]}x{shape[1]} x {shape[2]} "
          f"feature channels ({card})")
    check(shape[0] >= TEXTURE_SIZE and shape[1] >= TEXTURE_SIZE,
          f"canvas {shape}")
    del exp

    # -- the quilted texture imported: mode 'field' ---------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    field_io.load_field(tr, tex_path)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    occupied = int(tr.state.occ.occ.sum())
    near = tr._get_near_cells().shape[0]
    print(f"texture: load_field + initialize_states (50 refreshes over "
          f"{near} slab cells) {init_s:.2f} s; {occupied} cells occupied "
          f"({card})")
    check(tr.mode == "field" and occupied > 0, "the field import is empty")
    bounds = tr.field_state.imported.bounds.cpu().numpy()
    down = [orbit_pose_down(0.08 * i) for i in range(4)]
    share = canvas_share(down[1], ds.intrinsics, ds.H, ds.W, bounds)
    print(f"texture: canvas half-extents {bounds[0]:.3f} x {bounds[1]:.3f}; "
          f"it covers {100 * share:.1f}% of the first timed frame ({card})")
    check(share >= 0.25, f"the canvas covers {share} of the frame")
    launches = {}
    launches["texture_field"], out_f, field_ms = import_frames(
        tr, "texture field (CDF)", down, proxy_select_cdf, card)
    # the grid samples' share of the frame: 4 a chunk on its survivors
    pts = torch.rand((rcfg.ray_chunk * rcfg.infer_color_cap, 2),
                     device=dev) * 2 - 1
    imp = tr.field_state.imported
    ids = imp.sample_tbn_ids_2d[..., None].float()
    n_gs, gs_ms = profile_frame(lambda: (
        grid_sample_2d(imp.features_2d, pts),
        grid_sample_2d(imp.phi_embed_2d, pts),
        grid_sample_2d(imp.local_tbn_2d, pts, mode="nearest"),
        grid_sample_2d(ids, pts, mode="nearest")))
    n_chunks = -(-out_f["live"] // rcfg.ray_chunk)
    print(f"texture: grid_sample_2d, the 4 canvas reads of a chunk's "
          f"{pts.shape[0]} survivors: {n_gs} kernels, {gs_ms:.3f} ms of "
          f"kernel time, x {n_chunks} chunks = "
          f"{100 * gs_ms * n_chunks / field_ms:.1f}% of the field frame's "
          f"kernel time ({card})")
    tr.rcfg = dataclasses.replace(rcfg, **TWO_ROUND)
    proxy_select_cdf.launches = 0
    launches["texture_two_round"], _, _ = import_frames(
        tr, "texture field two-round (top-k)", down, proxy_select, card)
    check(proxy_select_cdf.launches == 0, "the two-round frames launched "
          "proxy_select_cdf")
    tr.rcfg = rcfg

    # -- one patch imported: mode 'patch' -------------------------------------
    data = np.load(field_path, allow_pickle=True)
    normal = data["patch_norms"][0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    field_io.load_patch(tr, field_path, patch_id=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    occupied = int(tr.state.occ.occ.sum())
    print(f"texture: load_patch + initialize_states (50 refreshes over "
          f"{tr._get_near_cells().shape[0]} cells) {init_s:.2f} s; "
          f"{occupied} cells occupied ({card})")
    # from 1.4 along the patch normal: the sphere's decayed shell does
    # not fill the frame
    at_patch = [facing_pose(normal, 1.4, 0.03 * i) for i in range(4)]
    launches["texture_patch"], out_p, patch_ms = import_frames(
        tr, "texture patch (CDF)", at_patch, proxy_select_cdf, card)
    x = torch.rand((rcfg.ray_chunk * rcfg.infer_color_cap, 3), device=dev) \
        * 0.1 - 0.05 + torch.as_tensor(data["picked_vertices"][0],
                                       dtype=torch.float32, device=dev)
    n_knn, knn_ms = profile_frame(lambda: weighted_project(
        tr.field_state.projector_imported, x, k=8, direct_above_check=True,
        direct_above_threshold=1.0))
    n_chunks = -(-out_p["live"] // rcfg.ray_chunk)
    print(f"texture: weighted_project (kNN over the patch points) of a "
          f"chunk's {x.shape[0]} survivors: {n_knn} kernels, {knn_ms:.3f} ms "
          f"of kernel time, x {n_chunks} chunks = "
          f"{100 * knn_ms * n_chunks / patch_ms:.1f}% of the patch frame's "
          f"kernel time ({card})")
    del data

    # -- the narrow config on the card vs the CPU port, on the CPU's files ---
    small, exports, cpu_occ = {}, {}, []
    tex_small = os.path.join(TEXTURE_DIR, "texture_small.npz")
    for name, dev_i in (("cpu", torch.device("cpu")), ("cuda", dev)):
        tr_s = narrow_curved(ds, dev_i, ref if name == "cuda" else None)
        ref = tr_s.state
        path = os.path.join(TEXTURE_DIR, f"field_small_{name}.npz")
        exports[name] = field_io.save_field(
            tr_s, path, mesh=make_icosphere(2, radius=0.5),
            scfg=PatchSampleConfig(**SMALL_TEXTURE))
        if name == "cpu":
            quilt(path, tex_small, SMALL_TEXTURE_SIZE)
            field_small = path
        frames = []
        for load in (lambda: field_io.load_field(tr_s, tex_small),
                     lambda: field_io.load_patch(tr_s, field_small, 0)):
            load()
            if name == "cpu":
                cpu_occ.append(tr_s.state.occ)
            else:               # the CPU's grid: the frames compare alone
                occ = cpu_occ[len(frames)]
                tr_s.state.occ = type(occ)(*(t.to(dev_i) for t in occ))
            pose = (orbit_pose_down(0.3) if tr_s.mode == "field" else
                    facing_pose(exports["cpu"]["patch_norms"][0], 1.4))
            frames.append(tr_s.render_frame(pose, use_ema=False))
        small[name] = frames
    a, b = exports["cuda"], exports["cpu"]
    check(np.array_equal(a["picked_vertices"], b["picked_vertices"]),
          "the card kept other patches than the CPU")
    exp_err = max(float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(),
                                                        1e-12))
                  for k in ("patches", "patch_phi_embed"))
    print(f"texture parity: the narrow export on the card vs the CPU: "
          f"{len(a['patches'])} patches, the same centres, features within "
          f"{exp_err:.3g} of their largest entry ({card})")
    check(exp_err <= 1e-4, f"exported features differ by {exp_err}")
    for i, name in enumerate(("field", "patch")):
        fa, fb = small["cuda"][i], small["cpu"][i]
        ia, ib = fa["image"].cpu().numpy(), fb["image"].cpu().numpy()
        la = fa["weights_sum"].cpu().numpy() > 0
        lb = fb["weights_sum"].cpu().numpy() > 0
        p_s, e_s = psnr(ia, ib), float(np.abs(ia - ib).max())
        mism = float(np.mean(la != lb))
        print(f"texture parity: {name} 64x64 frame card vs CPU on the same "
              f"file: PSNR {p_s:.2f} dB, max abs {e_s:.3g}, live mismatch "
              f"{mism:.4f} ({int(lb.sum())} live on CPU) ({card})")
        check(lb.any() and ib[lb].std() > 1e-3,
              f"the small {name} frame has no structure")
        check(p_s >= FRAME_PSNR_MIN and e_s <= FRAME_MAX_ABS
              and mism <= FRAME_LIVE_MISMATCH,
              f"texture {name} card vs CPU: PSNR {p_s} dB, max abs {e_s}, "
              f"live mismatch {mism}")
    torch.backends.cuda.matmul.allow_tf32 = True
    return launches


def surfaces_phase(dev, card: str, ds, tr, live_psnr: float) -> dict:
    """Phase 12: phase 11's patches synthesised onto another mesh and the
    imports onto it, on phase 10's trained field ``tr`` (bench width, its
    RenderConfig): the curved synthesis (the CLI's function), then
    ``load_field`` + ``load_shape``, ``load_unhash`` and ``unhash``, each
    with 800x800 frames through proxy_select_cdf; then the narrow config
    on the card and on the CPU port on one CPU-written curved_mesh.npz.
    The grid-table kernels' launches are counted over the synthesis and
    the imports, whose projectors build their tables on the card; then
    the kernels are held against their plain versions
    (``grid_tables_check``).  Returns the selection launches of each
    import's frames and the grid-table kernels' JSON entries."""
    import resource

    import texture_synthesis_on_curved_surface_torch as syn_cli
    from nerf_texture_tpu_torch import native
    from nerf_texture_tpu_torch.data.poses import orbit_pose
    from nerf_texture_tpu_torch.geometry import projector as proj
    from nerf_texture_tpu_torch.geometry.mesh import save_obj
    from nerf_texture_tpu_torch.ops.proxy_select import proxy_select_cdf
    from nerf_texture_tpu_torch.render.renderer import RenderConfig
    from nerf_texture_tpu_torch.train import field_io
    from nerf_texture_tpu_torch.utils.metrics import psnr as psnr_of

    torch.backends.cuda.matmul.allow_tf32 = False      # curved shading
    os.makedirs(SURFACE_DIR, exist_ok=True)
    rcfg = RenderConfig(**CURVED_RENDER)
    tr.rcfg = rcfg
    fcfg = tr.ccfg.field
    field_path = os.path.join(TEXTURE_DIR, "field.npz")
    tex_path = os.path.join(TEXTURE_DIR, "texture.npz")
    target_path = os.path.join(SURFACE_DIR, "target.obj")
    curved_path = os.path.join(SURFACE_DIR, "curved_mesh.npz")

    # -- the target mesh and the curved synthesis ---------------------------
    grid_fns = (native.build_vertex_grid, native.build_triangle_grid,
                native.build_fallback)
    for fn in grid_fns:
        fn.launches = 0
    grid_paths = {}

    def grid_count(path: str, before: tuple):
        grid_paths[path] = tuple(fn.launches - b
                                 for fn, b in zip(grid_fns, before))

    t0 = time.perf_counter()
    target = surface_target()
    save_obj(target_path, target)
    print(f"surfaces: target mesh, a rounded box {SURFACE_BOX}: "
          f"{len(target.vertices)} vertices, {len(target.faces)} faces in "
          f"{time.perf_counter() - t0:.2f} s")
    st = {}
    t0 = time.perf_counter()
    before = tuple(fn.launches for fn in grid_fns)
    syn_cli.synthesise(field_path, target_path, grid_gap=SURFACE_GAP,
                       resolution=SURFACE_RES, device=dev,
                       max_iters=SURFACE_ITERS, progress=False,
                       out=curved_path, stats=st)
    grid_count("surface_curved_synthesis_setup", before)
    syn_s = time.perf_counter() - t0
    it = max(st["iters"], 1)
    host_s = st["loop_s"] - st["device_s"]
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(f"surfaces: curved synthesis (grid gap {SURFACE_GAP:g}, at most "
          f"{SURFACE_ITERS} iterations) {syn_s:.2f} s: set-up "
          f"{st['setup_s']:.2f} s (patch library, projector, uv2vert, range "
          f"votes, matcher); {st['iters']} iterations in {st['loop_s']:.2f} "
          f"s = {st['loop_s'] / it:.3f} s an iteration "
          f"({st['device_s'] / it:.3f} s device queries: ray cast, uvh, "
          f"canvas reads; {host_s / it:.3f} s host); UV coverage "
          f"{100 * st['done']:.1f}% of the {st['texels']} texels on the "
          f"surface ({100 * st['texels'] / SURFACE_RES ** 2:.1f}% of the "
          f"{SURFACE_RES}^2 map); process peak RSS {rss:.2f} GiB ({card})")
    feats = np.load(curved_path)["features"]
    check(st["iters"] > 0 and st["done"] >= SURFACE_MIN_DONE
          and bool(np.isfinite(feats).all()),
          f"curved synthesis: {st['iters']} iterations, {st['done']} of the "
          f"texels set")
    del feats

    # -- the imports: load_shape, load_unhash, unhash ------------------------
    def near_surface(n: int = rcfg.ray_chunk * rcfg.infer_color_cap):
        """n points within 0.1 of the imported mesh's vertices."""
        pa = tr.field_state.projector_imported
        g = torch.Generator(device=dev).manual_seed(0)
        i = torch.randint(0, pa.vertices.shape[0], (n,), generator=g,
                          device=dev)
        h = torch.rand((n, 1), generator=g, device=dev) * 0.2 - 0.1
        return pa.vertices[i] + pa.vertex_normals[i] * h

    def shape_chain(x):
        return proj.uvh(tr.field_state.projector_imported, x,
                        k=fcfg.k_for_uv, h_threshold=fcfg.h_threshold,
                        sdf_scale=1.0, sdf_offset=0.0)

    def unhash_chain(x):
        n, _, _, _ = proj.knn_normal(tr.field_state.projector, x, k=fcfg.k)
        return proj.barycentric_mapping(tr.field_state.projector_imported, x,
                                        n, h_threshold=fcfg.h_threshold)

    t0 = time.perf_counter()
    field_io.load_field(tr, tex_path)   # mode 'shape' reads its phi / TBN
    print(f"surfaces: load_field (the phi and TBN canvases of mode 'shape') "
          f"{time.perf_counter() - t0:.2f} s")
    npose = orbit_pose(np.pi / 2 + 0.2, 0.3, ds.radius)
    novel = [orbit_pose(1.25 + 0.1 * i, 2 * np.pi * (i + 0.5) / 8, 2.0)
             for i in range(4)]
    launches = {}
    for key, name, load, poses, chain, what in (
            ("surface_shape", "load_shape",
             lambda: field_io.load_shape(tr, target), novel, shape_chain,
             "uvh"),
            ("surface_curved_synthesis", "load_unhash",
             lambda: field_io.load_unhash(tr, curved_path), novel,
             shape_chain, "uvh"),
            ("surface_unhash", "unhash",
             lambda: field_io.unhash(tr, min_vertices=UNHASH_MIN_VERTICES),
             [ds.poses[0], npose, ds.poses[1], ds.poses[2]], unhash_chain,
             "knn_normal + barycentric_mapping")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        before = tuple(fn.launches for fn in grid_fns)
        mp = load()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        grid_count(key, before)
        occupied = int(tr.state.occ.occ.sum())
        print(f"surfaces: {name} + initialize_states (50 refreshes over "
              f"{tr._get_near_cells().shape[0]} cells) {init_s:.2f} s; mesh "
              f"{len(mp.mesh.vertices)} vertices "
              f"({mp.arrays.vertices.shape[0]} after the UV atlas); mode "
              f"{tr.mode!r}; {occupied} cells occupied ({card})")
        check(occupied > 0, f"the {name} import is empty")
        launches[key], out, k_ms = import_frames(
            tr, f"surfaces {name} (CDF)", poses, proxy_select_cdf, card)
        x = near_surface()
        n_c, c_ms = profile_frame(lambda: chain(x))
        n_chunks = -(-out["live"] // rcfg.ray_chunk)
        print(f"surfaces: {name}: {what} of a chunk's {x.shape[0]} "
              f"survivors: {n_c} kernels, {c_ms:.3f} ms of kernel time, x "
              f"{n_chunks} chunks = {100 * c_ms * n_chunks / k_ms:.1f}% of "
              f"the frame's kernel time ({card})")
    check(len(mp.mesh.vertices) >= UNHASH_MIN_VERTICES,
          f"unhash mesh of {len(mp.mesh.vertices)} vertices")
    grid_launches = [sum(v[i] for v in grid_paths.values())
                     for i in range(3)]
    print(f"surfaces: grid-table kernel launches on the synthesis and the "
          f"imports (build_vertex_grid, build_triangle_grid, "
          f"build_fallback): {grid_paths}, in all {grid_launches}")
    check(all(n > 0 for n in grid_launches)
          and all(sum(v) > 0 for v in grid_paths.values()),
          f"a projector of phase 12 built no table on the card: "
          f"{grid_paths}")
    grid_lines = grid_tables_check(
        dev, card, target, field_io._mesh_from_arrays(
            tr.field_state.projector), mp.mesh, grid_paths)
    p_u = psnr_of(out["image"], white_gt(ds, npose))
    print(f"surfaces: the unhash frame at the novel pose {p_u:.2f} dB, the "
          f"trained live frame {live_psnr:.2f} dB (not gated: no JAX cell; "
          f"the features follow the subdivided mesh's vertex order, which "
          f"the projector's UV atlas renumbers, as in the JAX package) "
          f"({card})")
    photo = os.path.join(SURFACE_DIR, "unhash_novel.png")
    img = field_io.take_photo(tr, npose, path=photo)
    check(img.shape == (ds.H, ds.W, 3) and os.path.getsize(photo) > 0,
          f"take_photo wrote {photo} of {img.shape}")
    print(f"surfaces: take_photo {photo}: {os.path.getsize(photo)} bytes")

    # -- the narrow config on the card vs the CPU port, on one file ----------
    cpu = torch.device("cpu")
    small_target = os.path.join(SURFACE_DIR, "target_small.obj")
    curved_small = os.path.join(SURFACE_DIR, "curved_mesh_small.npz")
    save_obj(small_target, surface_target(SMALL_SURFACE["min_vertices"]))
    st = {}
    t0 = time.perf_counter()
    syn_cli.synthesise(os.path.join(TEXTURE_DIR, "field_small_cpu.npz"),
                       small_target, grid_gap=SMALL_SURFACE["grid_gap"],
                       resolution=SMALL_SURFACE["resolution"], device=cpu,
                       max_iters=SMALL_SURFACE["max_iters"], progress=False,
                       out=curved_small, stats=st)
    print(f"surfaces parity: the CPU's narrow synthesis "
          f"{time.perf_counter() - t0:.2f} s, {st['iters']} iterations, "
          f"{100 * st['done']:.1f}% of {st['texels']} texels")
    pose = orbit_pose(1.2, 0.7, 2.0)
    small, cpu_occ = {}, []
    for name, dev_i in (("cpu", cpu), ("cuda", dev)):
        tr_s = narrow_curved(ds, dev_i, ref if name == "cuda" else None)
        ref = tr_s.state
        field_io.load_field(tr_s, os.path.join(TEXTURE_DIR,
                                               "texture_small.npz"))
        frames = []
        for load in (lambda: field_io.load_unhash(tr_s, curved_small),
                     lambda: field_io.unhash(
                         tr_s, min_vertices=SMALL_UNHASH_VERTICES)):
            load()
            if name == "cpu":
                cpu_occ.append(tr_s.state.occ)
            else:               # the CPU's grid: the frames compare alone
                occ = cpu_occ[len(frames)]
                tr_s.state.occ = type(occ)(*(t.to(dev_i) for t in occ))
            frames.append(tr_s.render_frame(pose, use_ema=False))
        small[name] = frames
    for i, name in enumerate(("load_unhash", "unhash")):
        fa, fb = small["cuda"][i], small["cpu"][i]
        ia, ib = fa["image"].cpu().numpy(), fb["image"].cpu().numpy()
        la = fa["weights_sum"].cpu().numpy() > 0
        lb = fb["weights_sum"].cpu().numpy() > 0
        p_s, e_s = psnr(ia, ib), float(np.abs(ia - ib).max())
        mism = float(np.mean(la != lb))
        print(f"surfaces parity: {name} 64x64 frame card vs CPU on the same "
              f"file: PSNR {p_s:.2f} dB, max abs {e_s:.3g}, live mismatch "
              f"{mism:.4f} ({int(lb.sum())} live on CPU) ({card})")
        check(lb.any() and ib[lb].std() > 1e-3,
              f"the small {name} frame has no structure")
        check(p_s >= FRAME_PSNR_MIN and e_s <= FRAME_MAX_ABS
              and mism <= FRAME_LIVE_MISMATCH,
              f"surfaces {name} card vs CPU: PSNR {p_s} dB, max abs {e_s}, "
              f"live mismatch {mism}")
    torch.backends.cuda.matmul.allow_tf32 = True
    return launches, grid_lines


def _grid_frame(points: np.ndarray, res: int):
    """The grid's float64 origin and cell size over ``points``, as
    ``spatial.build_grid`` / ``build_triangle_grid`` set them."""
    lo = points.min(0) - 1e-3
    return lo, float((points.max(0) + 1e-3 - lo).max() / res)


def _event_ms(fn, n: int, flush=None) -> float:
    """Median device ms of n calls of fn, each between two CUDA events
    (a warm-up call first); with ``flush`` (FLUSH_BYTES, more than the
    50 MB L2) written before each call, its inputs come from HBM."""
    fn()
    times = []
    for i in range(n):
        if flush is not None:
            flush.fill_(float(i))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def grid_tables_check(dev, card: str, target, template, big,
                      paths: dict) -> list:
    """Phase 12's grid-table kernels against their plain versions: the
    projector's two indexes (``spatial.build_grid`` at M 16,
    ``build_triangle_grid`` at M 24, at MeshProjector's resolution) of
    the box target and of the template subdivided to
    GRID_CHECK_VERTICES, built on the card and on the host (the plain
    versions: torch binning, cKDTree's query); the cell lists and the
    fallback lists bit for bit, each build's seconds both ways.
    Then each kernel's device ms (CUDA events, GRID_TIMED calls) and its
    plain version's seconds at the template's shapes, and the card's
    alone at the unhash mesh ``big``.  Returns the three kernels'
    entries of the kernels line; their launches are phase 12's
    (``paths``: the counts of each projector build there)."""
    from nerf_texture_tpu_torch import native
    from nerf_texture_tpu_torch.geometry import spatial
    from nerf_texture_tpu_torch.geometry.shape_tools import subdivide_to

    cpu = torch.device("cpu")
    tmpl = subdivide_to(template, GRID_CHECK_VERTICES)
    err = {"vertex": 0, "triangle": 0, "fallback": 0}

    def res_of(m):
        return int(np.clip(round(len(m.vertices) ** (1 / 3) * 2), 8, 64))

    def timed_build(fn, d):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(d)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for name, m in (("box target", target), ("template", tmpl)):
        res = res_of(m)
        for kind, build in (
                ("vertex", lambda d: spatial.build_grid(m.vertices, res, 16,
                                                        device=d)),
                ("triangle", lambda d: spatial.build_triangle_grid(
                    m.vertices, m.faces, res, 24, device=d))):
            a, card_s = timed_build(build, dev)
            b, plain_s = timed_build(build, cpu)
            dc = (a.cell_items.cpu() - b.cell_items).abs()
            df = (a.fallback.cpu() - b.fallback).abs()
            diff, fb_diff = int((dc > 0).sum()), int((df > 0).sum())
            err[kind] = max(err[kind], int(dc.max()))
            err["fallback"] = max(err["fallback"], int(df.max()))
            print(f"grid tables: {name} ({len(m.vertices)} vertices, "
                  f"{len(m.faces)} faces, res {res}) {kind} grid: card "
                  f"{card_s:.3f} s, plain (host) {plain_s:.3f} s; cell "
                  f"lists {diff} entries apart of {a.cell_items.numel()}; "
                  f"fallback lists {fb_diff} entries apart of "
                  f"{a.fallback.numel()} ({card})")
            check(diff == 0 and torch.equal(a.origin.cpu(), b.origin)
                  and torch.equal(a.cell_size.cpu(), b.cell_size),
                  f"{name} {kind} grid: card tables differ from the plain "
                  f"ones ({diff} entries)")
            check(fb_diff == 0, f"{name} {kind} grid: card fallback lists "
                  f"differ from the plain ones ({fb_diff} entries)")

    # -- each kernel's device time, its plain time, its bound ---------------
    def shapes(m):
        res = res_of(m)
        v = torch.as_tensor(m.vertices, device=dev)
        f = torch.as_tensor(m.faces, device=dev)
        corners = m.vertices[m.faces]
        return (res, v, f, corners.mean(1), _grid_frame(m.vertices, res),
                _grid_frame(corners.reshape(-1, 3), res))

    def bound(kind, res, V, n, kd=None, evals=0):
        """(bytes, float64 operations) the kernel must move and do: its
        inputs read once, its table written once; for the fallback the
        tree's tensors, and 9 operations (3 subtractions, 3
        multiplications, 3 additions) for each distance this run's walk
        evaluated."""
        cells = res ** 3
        if kind == "vertex":
            return V * 12 + cells * 16 * 4, 0
        if kind == "triangle":
            return V * 12 + n * 12 + cells * 24 * 4, 0
        tree_bytes = sum(t.numel() * t.element_size()
                         for t in (kd.points, kd.ids, kd.nodes, kd.splits,
                                   kd.rects))
        return tree_bytes + cells * 8 * 4, evals * 9

    timed = {}
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    for label, m, plain in (("template", tmpl, True), ("unhash", big, False)):
        res, v, f, cent, vframe, tframe = shapes(m)
        t0 = time.perf_counter()
        kd = native.kdtree(cent, dev)
        torch.cuda.synchronize()
        kd_s = time.perf_counter() - t0
        kd_cpu = native.kdtree(cent, cpu)
        print(f"grid tables: kdtree of the {label}'s {len(cent)} centroids "
              f"(scipy's cKDTree on the host, {len(kd.nodes)} nodes laid "
              f"out and copied to the card) {kd_s:.3f} s ({card})")
        calls = {
            "vertex": (lambda: native.build_vertex_grid(v, res, *vframe, 16),
                       lambda: native.build_vertex_grid(v.cpu(), res,
                                                        *vframe, 16),
                       len(v)),
            "triangle": (lambda: native.build_triangle_grid(
                v, f, res, *tframe, 24), lambda: native.build_triangle_grid(
                v.cpu(), f.cpu(), res, *tframe, 24), len(f)),
            "fallback": (lambda: native.build_fallback(kd, res, *tframe, 8),
                         lambda: native.build_fallback(kd_cpu, res, *tframe,
                                                       8),
                         len(cent))}
        for kind, (on_card, on_host, n) in calls.items():
            ms = _event_ms(on_card, GRID_TIMED, flush)
            ms_warm = _event_ms(on_card, GRID_TIMED)
            plain_ms = None
            if plain:
                t0 = time.perf_counter()
                on_host()
                plain_ms = (time.perf_counter() - t0) * 1e3
            evals = int(native.build_fallback.evaluations) \
                if kind == "fallback" else 0
            nbytes, ops = bound(kind, res, len(v), n, kd, evals)
            bms = max(nbytes / HBM_BYTES_PER_S, ops / F64_OPS_PER_S) * 1e3
            by = "operations" if ops / F64_OPS_PER_S \
                > nbytes / HBM_BYTES_PER_S else "bytes"
            timed[(label, kind)] = {
                "shape": f"{len(v)} vertices, {len(f)} faces, res {res}",
                "ms": ms, "ms_warm": ms_warm, "plain_ms": plain_ms,
                "bound_ms": bms,
                "bound_by": by, "bytes": nbytes, "f64_ops": ops or None,
                "bound_share": bms / ms}
            print(f"grid tables: {kind} kernel at the {label} ({len(v)} "
                  f"vertices, {len(f)} faces, res {res}): {ms:.3f} ms on "
                  f"the device, cold ({ms_warm:.3f} warm; median of "
                  f"{GRID_TIMED}), plain "
                  f"{'not run' if plain_ms is None else f'{plain_ms:.1f} ms'}"
                  f", bound {bms:.4f} ms ({by}; {nbytes} bytes"
                  f"{f', {ops:.3g} f64 operations' if ops else ''}), "
                  f"{100 * bms / ms:.1f}% of it ({card})")
        if label == "unhash":
            big_s = sum(timed[("unhash", k)]["ms"] for k in calls) / 1e3
            del flush
            print(f"grid tables: the unhash mesh's two indexes ({len(v)} "
                  f"vertices) in {big_s:.3f} s of device time on the card "
                  f"alone; its plain build is not run here ({card})")

    def line(kind, name, replaces, i):
        t = timed[("template", kind)]
        return {"name": name, "route": "cuda",
                "source": "nerf_texture_tpu_torch/csrc/spatial_build.cu",
                "replaces": replaces,
                "launches": sum(v[i] for v in paths.values()),
                "launches_are": "calls of the wrapper: for the binning "
                                "one entry point pair that queues 4 CUDA "
                                "launches; for build_fallback one kernel "
                                "launch a 65,536 cell centres, more for "
                                "rows that outgrow the node heap",
                "launches_by_path": {k: v[i] for k, v in paths.items()},
                "max_abs_err": err[kind], "ms": t["ms"],
                "ms_warm": t["ms_warm"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None,
                "shape": t["shape"], "bound_share": t["bound_share"],
                "bytes": t["bytes"], "f64_ops": t["f64_ops"],
                "by_shape": {"unhash " + timed[("unhash", kind)]["shape"]:
                             timed[("unhash", kind)]},
                "card": card}

    return [
        line("vertex", "build_vertex_grid",
             "native/spatial_build.cpp:22 build_vertex_grid (host C++, no "
             "TPU kernel), via nerf_texture_tpu/native.py:56 and "
             "geometry/spatial.py:73", 0),
        line("triangle", "build_triangle_grid",
             "native/spatial_build.cpp:47 build_triangle_grid (host C++, no "
             "TPU kernel), via nerf_texture_tpu/native.py:71 and "
             "geometry/spatial.py:122", 1),
        line("fallback", "build_fallback",
             "scipy cKDTree query of nerf_texture_tpu/geometry/spatial.py:"
             "104 in _build_fallback :95 (host, no TPU kernel), as "
             "kd_nearest over the tree native.kdtree lays out", 2)]


def narrow_curved(ds, dev_i, ref=None):
    """The narrow curved config of the card-vs-CPU checks (SMALL_FIELD over
    make_icosphere(2, 0.5), 64x64 frames) on ``dev_i``: seeded and
    refreshed once, or with the params and grid of ``ref`` (a trainer
    state of the same config)."""
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector
    from nerf_texture_tpu_torch.models import mesh_field
    from nerf_texture_tpu_torch.models.curved_field import CurvedFieldConfig
    from nerf_texture_tpu_torch.models.mesh_field import MeshFieldConfig
    from nerf_texture_tpu_torch.render.renderer import RenderConfig
    from nerf_texture_tpu_torch.train.curved_trainer import (
        CurvedTrainConfig, CurvedTrainer)

    tr_s = CurvedTrainer(type(ds)(n_frames=2, H=64, W=64),
                         mesh_field.make_state(MeshProjector(
                             make_icosphere(2, radius=0.5), device=dev_i)),
                         CurvedFieldConfig(field=MeshFieldConfig(
                             **SMALL_FIELD), light_model="SH"),
                         RenderConfig(**SMALL_CURVED_RENDER),
                         CurvedTrainConfig(**CURVED_TRAIN), seed=0,
                         device=dev_i)
    if ref is None:
        seeded_curved(tr_s, TABLE_SCALE)
        tr_s.initialize_states(1)
    else:
        tr_s.state.params = tree_to(ref.params, dev_i)
        tr_s.state.ema_params = tr_s.state.params
        tr_s.state.occ = type(ref.occ)(*(t.to(dev_i) for t in ref.occ))
    return tr_s


def orbit_pose_down(tilt: float):
    """An orbit pose at radius 2 on the +z axis, looking down onto the
    z = 0 canvas, tilted by ``tilt`` in both angles."""
    from nerf_texture_tpu_torch.data.poses import orbit_pose

    return orbit_pose(np.pi / 2 - tilt, tilt, 2.0)


def ngp_mesh(trainer, mcfg, dev, card: str):
    """Phase 8's mesh export: ``field_io.save_mesh`` of the trained NGP's
    density (the params, as main_nerf.py exports them) at resolution
    NGP_MESH_RES and sigma 10.  The sigma-10 set also holds the floaters
    of regions no ray trained, which the reference's template clean-up
    removes, so the gate is that the surface holds the dataset's sphere:
    NGP_MESH_COVER of NGP_MESH_PROBES points spread over it lie within
    NGP_MESH_TOL of a vertex."""
    from scipy.spatial import cKDTree

    from nerf_texture_tpu_torch.geometry.mesh import Mesh
    from nerf_texture_tpu_torch.geometry.shape_tools import (
        keep_largest_component)
    from nerf_texture_tpu_torch.models import ngp
    from nerf_texture_tpu_torch.train import field_io

    radius = trainer.dataset.sphere_radius
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v, f = field_io.save_mesh(
        lambda x: ngp.density(trainer.state.params, x, mcfg)[0],
        os.path.join(SURFACE_DIR, "ngp_mesh.obj"), resolution=NGP_MESH_RES,
        bound=mcfg.bound, device=dev)
    mesh_s = time.perf_counter() - t0
    check(len(f) > 0, "the NGP mesh is empty")
    off = np.abs(np.linalg.norm(v, axis=-1) - radius)
    k = np.arange(NGP_MESH_PROBES) + 0.5         # a Fibonacci sphere
    z = 1.0 - 2.0 * k / NGP_MESH_PROBES
    a = np.pi * (1.0 + 5.0 ** 0.5) * k
    probes = radius * np.stack([np.sqrt(1 - z * z) * np.cos(a),
                                np.sqrt(1 - z * z) * np.sin(a), z], -1)
    cover = float(np.mean(cKDTree(v).query(probes)[0] <= NGP_MESH_TOL))
    big = keep_largest_component(Mesh(v, f))
    off_big = np.abs(np.linalg.norm(big.vertices, axis=-1) - radius)
    print(f"render: save_mesh of the trained density at {NGP_MESH_RES}^3, "
          f"sigma 10: {len(v)} vertices, {len(f)} faces in {mesh_s:.2f} s; "
          f"{100 * np.mean(off <= NGP_MESH_TOL):.1f}% of the vertices within "
          f"{NGP_MESH_TOL} of the r = {radius} sphere, mean |r - {radius}| "
          f"{off.mean():.4f}; the sphere covered at {100 * cover:.1f}% of "
          f"{NGP_MESH_PROBES} points (gate >= {100 * NGP_MESH_COVER:.0f}%); "
          f"largest component {len(big.vertices)} vertices, mean "
          f"|r - {radius}| {off_big.mean():.4f} ({card})")
    check(cover >= NGP_MESH_COVER, f"the NGP mesh covers {cover} of the "
          f"sphere within {NGP_MESH_TOL}")


# the entry points (phase 13): the reference's two-step flow on a scene
# directory, main_nerf_torch.py --save_mesh then main_torch.py
# --distillation and its resume, as a user runs them; the scene is
# main.py's synthetic sphere (24 frames, 400x400) written as PNGs
CLI_DIR = os.path.join("build", "cli")
# (steps cut to fit the smoke's time: the distilled run 700 -> 200 and
# its resume 1000 -> 300, 400 and 600 until phase 15 came; the NGP runs
# 1500, where its eval passes the gate: 23.94-24.04 dB at 1000 steps)
CLI_NGP_ITERS, CLI_NGP_EVAL = 1500, 750
CLI_CURVED_ITERS, CLI_CURVED_EVAL, CLI_RESUME_ITERS = 200, 100, 300
# with --distillation three quarters of the steps are distilled and the
# curved eval stays near an empty frame's PSNR (14.65-14.91 dB after
# 1000 steps; the JAX package loses as much to distillation on the CPU),
# so the 24 dB gate holds a run of main_torch.py without it
CLI_PLAIN_ITERS, CLI_PLAIN_EVAL = 700, 700
CLI_PSNR_MIN = 24.0
# the staged camera recovery of tests/test_training_features.py:73-122
# (its field, light 'None', grid 16) at 400x400, 4 frames, 4096 rays: 300
# steps on the true poses, then 300 with frame 1's pose turned by 0.05 rad
# and camera optimisation on (reg weight 0); the learnt rotation must undo
# at least 30% of the turn
RECOVERY_STEPS = (300, 300)
RECOVERY_TURN = 0.05
RECOVERY_MAX_RESIDUAL = 0.7


# every subprocess the smoke starts, so that a failed phase stops them all
CHILDREN: list = []


class Background:
    """``fn()`` on a thread beside the smoke's phases; ``result()`` joins
    it and raises what it raised."""

    def __init__(self, fn):
        self._out, self._err = None, None
        self._thread = threading.Thread(target=self._run, args=(fn,),
                                        daemon=True)
        self._thread.start()

    def _run(self, fn):
        try:
            self._out = fn()
        except BaseException as e:          # re-raised by result()
            self._err = e

    def result(self):
        self._thread.join()
        if self._err is not None:
            raise self._err
        return self._out


def cli_run(args: list[str], name: str, timeout: float = 900,
            nice: int = 0) -> tuple:
    """Run a CLI of the repo as a subprocess at host priority ``nice``, its
    output (stdout and stderr) in chiprun_out/<name>.log; returns (exit
    code, output, wall s).  Safe on a Background thread: it checks
    nothing."""
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", f"{name}.log")
    t0 = time.perf_counter()
    with open(path, "w") as log:
        proc = subprocess.Popen([sys.executable] + args, stdout=log,
                                stderr=subprocess.STDOUT, text=True,
                                env={**os.environ, "PYTHONUNBUFFERED": "1"},
                                preexec_fn=lambda: os.nice(nice))
        CHILDREN.append(proc)
        try:
            code = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            code = f"killed after {timeout} s"
    with open(path) as f:
        return code, f.read(), time.perf_counter() - t0


def stop_children():
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def cli_output(runs: dict, name: str, what: str = "entry points") -> str:
    """The output of the finished run ``name``; fails unless it exited 0."""
    check(name in runs, f"{name} did not run (an earlier CLI failed)")
    code, out, wall = runs[name]
    check(code == 0, f"{name}: exit {code}: {out[-3000:]}")
    print(f"{what}: {name}: exit 0 in {wall:.1f} s")
    return out


def _lines(out: str, prefix: str) -> list[str]:
    return [ln for ln in out.splitlines() if ln.startswith(prefix)]


def _evals(out: str) -> list[tuple[int, float, float]]:
    """(step, loss, PSNR) of each '[done/iters] loss=... PSNR=...' line."""
    return [(int(m.group(1)), float(m.group(2)), float(m.group(3)))
            for m in re.finditer(r"^\[(\d+)/\d+\] loss=(\S+) PSNR=(\S+)$",
                                 out, re.M)]


def _select_launches(out: str) -> tuple[int, int]:
    """The CLI's eval frames' (proxy_select, proxy_select_cdf) launches."""
    got = re.findall(r"selection launches: proxy_select (\d+), "
                     r"proxy_select_cdf (\d+)", out)
    return (sum(int(a) for a, _ in got), sum(int(b) for _, b in got))


def camera_recovery(dev, card: str) -> float:
    """The staged camera recovery; returns the residual angle / the turn."""
    from nerf_texture_tpu_torch.data.synthetic import SyntheticSphereDataset
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector
    from nerf_texture_tpu_torch.models import mesh_field
    from nerf_texture_tpu_torch.models.curved_field import CurvedFieldConfig
    from nerf_texture_tpu_torch.models.mesh_field import MeshFieldConfig
    from nerf_texture_tpu_torch.render.renderer import RenderConfig
    from nerf_texture_tpu_torch.train.curved_trainer import (
        CurvedTrainConfig, CurvedTrainer, init_curved_state)
    from nerf_texture_tpu_torch.utils.transforms import axis_angle_to_matrix

    fcfg = MeshFieldConfig(num_levels=3, level_dim=2, base_resolution=16,
                           desired_resolution=64, log2_bricks=10,
                           h_threshold=0.12, clustering=False,
                           prob_model=False)
    ccfg = CurvedFieldConfig(field=fcfg, light_model="None", hidden_dim=16,
                             geo_feat_dim=7, dir_degree=2)
    rcfg = RenderConfig(bound=1.0, cascades=1, grid_size=16, max_steps=48,
                        max_samples_train=24, max_samples_infer=32,
                        ray_chunk=1024, pool_mean_samples=16,
                        pool_mean_samples_infer=16)
    t1 = CurvedTrainConfig(lr=5e-3, total_steps=1600, num_rays=4096,
                           grid_update_interval=8, grid_full_updates=2,
                           scan_steps=1)
    t2 = dataclasses.replace(t1, optimize_camera=True, camera_reg_weight=0.0)
    fs = mesh_field.make_state(MeshProjector(make_icosphere(2, radius=0.5),
                                             device=dev))
    t0 = time.perf_counter()
    ds = SyntheticSphereDataset(n_frames=4, H=400, W=400)
    tr1 = CurvedTrainer(ds, fs, ccfg, rcfg, t1, device=dev)
    tr1.train(RECOVERY_STEPS[0])
    ds2 = SyntheticSphereDataset(n_frames=4, H=400, W=400)
    tr2 = CurvedTrainer(ds2, fs, ccfg, rcfg, t2, device=dev)
    params = {**tr1.state.params,
              "camera": tr2.state.params["camera"]}
    tr2.state = init_curved_state(tr2.generator, ccfg, rcfg, t2,
                                  params=params, n_frames=4)
    tr2.state.ema_params = {**tr1.state.ema_params,
                            "camera": tr2.state.ema_params["camera"]}
    tr2.state.occ = tr1.state.occ
    aa = torch.tensor([0.0, RECOVERY_TURN, 0.0])
    R_pert = axis_angle_to_matrix(aa).numpy()
    poses = ds2.poses.copy()
    poses[1][:3, :3] = R_pert @ poses[1][:3, :3]
    ds2.poses = poses
    tr2.poses = torch.as_tensor(poses, device=dev)
    out = tr2.train(RECOVERY_STEPS[1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dR = tr2.state.params["camera"]["dRs"].detach()[1].cpu()
    resid = axis_angle_to_matrix(dR).numpy() @ R_pert

    def angle(R):
        return float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))

    before, after = angle(R_pert), angle(resid)
    print(f"entry points: camera recovery ({RECOVERY_STEPS[0]} + "
          f"{RECOVERY_STEPS[1]} steps, 4 frames 400x400, 4096 rays): turn "
          f"{np.degrees(before):.4f} deg, residual {np.degrees(after):.4f} "
          f"deg ({after / before:.3f} of it); learnt dRs[1] {dR.tolist()}; "
          f"last loss {out['loss']:.5f}; {wall:.1f} s ({card})")
    check(np.isfinite(after) and after < RECOVERY_MAX_RESIDUAL * before,
          f"camera recovery: residual {after} rad of {before}")
    return after / before


def start_clis(relight: bool = True, entry: bool = True) -> dict:
    """Writes phase 13's scene directory and starts, on Background
    threads, phase 13's CLI chain (``entry``) and phase 15's two CLIs
    (``relight``); the phases read their results later."""
    import shutil

    from nerf_texture_tpu_torch.data.synthetic import SyntheticSphereDataset

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    scene = os.path.join(CLI_DIR, "scene")
    t0 = time.perf_counter()
    SyntheticSphereDataset(n_frames=24, H=400, W=400).write_to_disk(scene)
    print(f"entry points: scene written in {time.perf_counter() - t0:.2f} "
          f"s (24 frames 400x400 PNG); the CLIs start")
    return {"entry": Background(entry_point_clis) if entry else None,
            "relight": Background(relight_cli_runs) if relight else None}


def entry_point_clis() -> dict:
    """Phase 13's CLIs: ``main_nerf_torch.py --save_mesh``, then
    ``main_torch.py --distillation`` and its resume beside the
    undistilled ``main_torch.py`` (both need the NGP's mesh, the
    distilled run its checkpoint too).  Returns {name: cli_run's tuple}
    up to the first failure."""
    import shutil

    from nerf_texture_tpu_torch.config import get_preset
    from nerf_texture_tpu_torch.train import trainer as ckpt

    scene, ws = os.path.join(CLI_DIR, "scene"), os.path.join(CLI_DIR, "ws")
    runs = {"cli_ngp": cli_run(
        ["main_nerf_torch.py", scene, "--workspace", ws, "--iters",
         str(CLI_NGP_ITERS), "--eval_interval", str(CLI_NGP_EVAL),
         "--save_mesh"], "cli_ngp")}
    if runs["cli_ngp"][0] != 0:
        return runs
    ws_plain = os.path.join(CLI_DIR, "ws_plain")
    shutil.copytree(os.path.join(ws, "meshes"),
                    os.path.join(ws_plain, "meshes"))
    plain = Background(lambda: cli_run(
        ["main_torch.py", scene, "--workspace", ws_plain, "--eval_interval",
         str(CLI_PLAIN_EVAL), "--iters", str(CLI_PLAIN_ITERS)],
        "cli_curved_plain"))
    curved_args = ["main_torch.py", scene, "--workspace", ws,
                   "--eval_interval", str(CLI_CURVED_EVAL), "--distillation"]
    runs["cli_curved"] = cli_run(
        curved_args + ["--iters", str(CLI_CURVED_ITERS)], "cli_curved")
    if runs["cli_curved"][0] == 0:
        # the distilled run's checkpoint, before the resume overwrites it
        raw = ckpt.read_checkpoint(os.path.join(
            ws, "checkpoints", get_preset(scene).field_name))
        runs["distilled_checkpoint"] = {"step": int(raw["step"]),
                                        "camera": raw["params"]["camera"]}
        del raw
        runs["cli_curved_resume"] = cli_run(
            curved_args + ["--iters", str(CLI_RESUME_ITERS)],
            "cli_curved_resume")
    runs["cli_curved_plain"] = plain.result()
    return runs


def entry_points_phase(dev, card: str, clis: Background) -> dict:
    """Phase 13: the two training CLIs on a scene directory and the
    resume (``clis``, started by start_clis), the checkpoint rendered in
    this process through both selections, and the staged camera
    recovery."""
    import main_torch
    from nerf_texture_tpu_torch.config import get_preset
    from nerf_texture_tpu_torch.data.provider import NeRFDataset
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector
    from nerf_texture_tpu_torch.models import mesh_field
    from nerf_texture_tpu_torch.ops.proxy_select import proxy_select
    from nerf_texture_tpu_torch.train import trainer as ckpt
    from nerf_texture_tpu_torch.train.curved_trainer import CurvedTrainer
    from nerf_texture_tpu_torch.utils.metrics import psnr as psnr_of

    torch.backends.cuda.matmul.allow_tf32 = False
    scene, ws = os.path.join(CLI_DIR, "scene"), os.path.join(CLI_DIR, "ws")
    launches = {}

    # -- the staged camera recovery, while the CLIs may still run -------------
    ratio = camera_recovery(dev, card)
    t0 = time.perf_counter()
    runs = clis.result()
    print(f"entry points: waited {time.perf_counter() - t0:.1f} s for the "
          f"CLIs")

    # -- main_nerf_torch.py --save_mesh ---------------------------------------
    out = cli_output(runs, "cli_ngp")
    for ln in (_lines(out, "setup:") + _lines(out, "[")
               + _lines(out, "timing:") + _lines(out, "checkpoint:")
               + _lines(out, "mesh:")):
        print(f"  ngp cli: {ln}")
    evals = _evals(out)
    check([e[0] for e in evals] == list(range(
        CLI_NGP_EVAL, CLI_NGP_ITERS + 1, CLI_NGP_EVAL)),
          f"NGP CLI eval lines {evals}")
    ngp_psnr = evals[-1][2]
    check(np.isfinite(evals[-1][1]), "NGP CLI: non-finite loss")
    check(os.path.exists(os.path.join(ws, "meshes", "ngp_mesh.obj")),
          "NGP CLI wrote no ngp_mesh.obj")
    raw = ckpt.read_checkpoint(os.path.join(ws, "checkpoints", "ngp"))
    check(int(raw["step"]) == CLI_NGP_ITERS, "NGP checkpoint step")
    launches["entry_ngp_cli_eval"] = _select_launches(out)[0]
    check(launches["entry_ngp_cli_eval"] > 0,
          "the NGP CLI's eval frames never launched proxy_select")

    # -- main_torch.py --distillation, then its resume ------------------------
    out = cli_output(runs, "cli_curved")
    for ln in (_lines(out, "template:") + _lines(out, "setup:")
               + _lines(out, "[") + _lines(out, "timing:")
               + _lines(out, "checkpoint:")):
        print(f"  curved cli: {ln}")
    check("teacher on" in out, "main_torch.py loaded no NGP teacher")
    evals = _evals(out)
    check([e[0] for e in evals] == list(range(
        CLI_CURVED_EVAL, CLI_CURVED_ITERS + 1, CLI_CURVED_EVAL))
          and all(np.isfinite(e[1]) for e in evals),
          f"curved CLI eval lines {evals}")
    cfg = get_preset(scene)
    ck_dir = os.path.join(ws, "checkpoints", cfg.field_name)
    raw = runs["distilled_checkpoint"]
    check(raw["step"] == CLI_CURVED_ITERS, "curved checkpoint step")
    cam = raw["camera"]
    check(all(bool(torch.isfinite(v).all()) for v in cam.values()),
          "non-finite camera deltas")
    print(f"entry points: camera deltas after {CLI_CURVED_ITERS} steps: max "
          f"|dRs| {float(cam['dRs'].abs().max()):.3g} rad, |dts| "
          f"{float(cam['dts'].abs().max()):.3g}, |dfs| "
          f"{float(cam['dfs'].abs().max()):.3g} px")
    n_curved = _select_launches(out)[0]
    out = cli_output(runs, "cli_curved_resume")
    for ln in (_lines(out, "checkpoint:") + _lines(out, "[")
               + _lines(out, "timing:")):
        print(f"  curved resume: {ln}")
    check(f"loaded step {CLI_CURVED_ITERS}" in out,
          "the resume did not start at the checkpoint's step")
    evals_r = _evals(out)
    check([e[0] for e in evals_r] == [CLI_RESUME_ITERS],
          f"resume eval lines {evals_r}")
    check(int(ckpt.read_checkpoint(ck_dir)["step"]) == CLI_RESUME_ITERS,
          "the resumed checkpoint's step")
    distilled_psnr = evals_r[-1][2]
    launches["entry_curved_cli_eval"] = n_curved + _select_launches(out)[0]
    check(launches["entry_curved_cli_eval"] > 0,
          "the curved CLI's eval frames never launched proxy_select")

    # -- main_torch.py without distillation, in a workspace of its own --------
    out = cli_output(runs, "cli_curved_plain")
    for ln in (_lines(out, "setup:") + _lines(out, "[")
               + _lines(out, "timing:")):
        print(f"  curved plain: {ln}")
    check("teacher off" in out, "the plain run loaded a teacher")
    evals_p = _evals(out)
    check([e[0] for e in evals_p] == list(range(
        CLI_PLAIN_EVAL, CLI_PLAIN_ITERS + 1, CLI_PLAIN_EVAL))
          and all(np.isfinite(e[1]) for e in evals_p),
          f"plain curved CLI eval lines {evals_p}")
    curved_psnr = evals_p[-1][2]
    launches["entry_curved_plain_cli_eval"] = _select_launches(out)[0]

    # -- the checkpoint in this process, through both selections --------------
    t0 = time.perf_counter()
    ds = NeRFDataset(scene, split="train", scale=cfg.scale)
    load_s = time.perf_counter() - t0
    template = main_torch.build_template_mesh(cfg, ws)
    tr = CurvedTrainer(ds, mesh_field.make_state(
        MeshProjector(template, device=dev)), cfg.curved, cfg.render,
        cfg.curved_train, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.load_checkpoint(ck_dir)
    torch.cuda.synchronize()
    load_ck_s = time.perf_counter() - t0
    pose = ds.poses[0]
    tr.render_frame(pose)                                  # warm-up
    torch.cuda.synchronize()
    proxy_select.launches = 0
    t0 = time.perf_counter()
    out_k = tr.render_frame(pose)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3
    launches["entry_checkpoint_frame"] = proxy_select.launches
    check(proxy_select.launches > 0 and
          proxy_select.launches == out_k["chunks"],
          f"checkpoint frame: {proxy_select.launches} proxy_select launches "
          f"for {out_k['chunks']} chunks")
    out_p = tr.render_frame(pose, plain_select=True)
    frame_checks(out_k, ds.H, ds.W, "entry points: checkpoint frame")
    check(torch.equal(out_k["image"], out_p["image"]),
          "checkpoint frame: the kernel frame differs from the plain one")
    gt = ds.images[0].astype(np.float32) / 255.0
    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
    frame_psnr = psnr_of(out_k["image"], gt)
    print(f"entry points: checkpoint step {tr.state.step} loaded in "
          f"{load_ck_s:.3f} s; scene load {load_s:.3f} s; eval frame "
          f"{ds.H}x{ds.W} {frame_ms:.1f} ms, PSNR {frame_psnr:.2f} dB, "
          f"{out_k['chunks']} chunks = proxy_select launches, live rays "
          f"{out_k['live']}; kernel frame == plain-selection frame bit for "
          f"bit ({card})")
    del tr
    torch.cuda.empty_cache()

    print(f"entry points: NGP CLI PSNR {ngp_psnr:.2f} dB after "
          f"{CLI_NGP_ITERS} steps; curved CLI PSNR {curved_psnr:.2f} dB "
          f"after {CLI_PLAIN_ITERS} steps (gates >= {CLI_PSNR_MIN}); with "
          f"--distillation {distilled_psnr:.2f} dB after {CLI_RESUME_ITERS} "
          f"(not gated); camera residual {ratio:.3f} of the turn ({card})")
    check(ngp_psnr >= CLI_PSNR_MIN, f"NGP CLI PSNR {ngp_psnr}")
    check(curved_psnr >= CLI_PSNR_MIN, f"curved CLI PSNR {curved_psnr}")
    return launches, ngp_psnr


# the relighting and vertex-encoder phase (15) at the bench's curved
# width (bench.py:340-367): the SG and Envmap arms at CurvedFieldConfig's
# own num_lgt_sgs 8 and env_res 16, 500 steps each (bench.py's 700, cut
# when phase 16 came, for the smoke's time), gated at
# RELIGHT_GAIN dB above the arm's step-0 frame at the novel pose (no JAX
# cell exists for these lights; the CPU lockstep tests carry parity); an
# imported environment, a 64x128 equirect PNG of an analytic sky; the
# vertex arm at the reference's progressive schedule (3 levels, 4096 ->
# 128^2 vertices) with iters_per_level cut from the reference's to 32
# (64 at first; cut again for the smoke's time), so that
# VERTEX_STEPS cross two level advances; the CLIs on phase 13's
# scene at a cut --iters, each with main.py's template of the synthetic
# sphere, an icosphere (phase 13's remeshed NGP template of ~98k vertices
# would add ~25 s of host set-up a run)
RELIGHT_DIR = os.path.join("build", "relight")
RELIGHT_STEPS, RELIGHT_GAIN = 500, 3.0
SKY_H, SKY_W = 64, 128
VERTEX_FIELD = dict(encoder_type="vertex", level_num=3, base_vnum=4096,
                    target_vnum=128 ** 2)
VERTEX_ITERS_PER_LEVEL, VERTEX_STEPS = 32, 96
CLI_SG_ITERS, CLI_VERTEX_ITERS = 50, 20
# the narrow card-vs-CPU frames of phase 15: SMALL_FIELD over
# make_icosphere(2, 0.5), the SG light at 4 lobes, the Envmap light at an
# 8x8 grid, the vertex encoder on the template subdivided to >= 600
# vertices (642), 4 features of 2 bands
SMALL_RELIGHT = {"SG": dict(light_model="SG", num_lgt_sgs=4),
                 "Envmap": dict(light_model="Envmap", env_res=8),
                 "vertex": dict(light_model="SH")}
SMALL_VERTEX = dict(encoder_type="vertex", feature_dim=4, vertex_multires=2,
                    base_vnum=600, target_vnum=600)


def sky_png(path: str):
    """A 64x128 equirect sky (a warm sun over a blue-grey dome and a dark
    ground) written as an 8-bit PNG."""
    from nerf_texture_tpu_torch.data.images import write_png

    th = (np.arange(SKY_H) + 0.5) / SKY_H * np.pi
    ph = (np.arange(SKY_W) + 0.5) / SKY_W * 2 * np.pi
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    sun = np.exp(-((tt - 0.7) ** 2 + (pp - 2.0) ** 2) * 6.0)
    dome = 0.15 + 0.55 * np.clip(np.cos(tt), 0, 1)
    img = np.clip(np.stack([dome + sun, dome + 0.8 * sun,
                            1.2 * dome + 0.4 * sun], -1), 0, 1)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_png(path, (img * 255).astype(np.uint8))
    return path


def relit_frame(tr, pose, name: str, card: str, reference=None) -> dict:
    """One 800x800 live frame of ``tr`` through proxy_select_cdf: launches
    == chunks, the frame checks, equal bit for bit to its plain-selection
    frame (and, given ``reference``, different from it)."""
    from nerf_texture_tpu_torch.ops.proxy_select import proxy_select_cdf

    torch.cuda.synchronize()
    proxy_select_cdf.launches = 0
    t0 = time.perf_counter()
    out = tr.render_frame(pose, use_ema=False)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = proxy_select_cdf.launches
    check(launches > 0 and launches == out["chunks"],
          f"{name}: {launches} kernel launches for {out['chunks']} chunks")
    frame_checks(out, tr.H, tr.W, name)
    plain = tr.render_frame(pose, use_ema=False, plain_select=True)
    check(torch.equal(out["image"], plain["image"]),
          f"{name}: the kernel frame differs from the plain-selection frame")
    if reference is not None:
        diff = float((out["image"] - reference).abs().max())
        check(diff > 1e-2, f"{name}: the frame did not change ({diff})")
    print(f"{name}: {tr.H}x{tr.W} frame {ms:.1f} ms, {out['chunks']} chunks "
          f"= proxy_select_cdf launches, live rays {out['live']}; kernel "
          f"frame == plain-selection frame bit for bit ({card})")
    return {"out": out, "launches": launches, "ms": ms}


def relight_arm(dev, card: str, ds, light: str, field_state, share=None):
    """The SG or Envmap arm at the bench's curved width: RELIGHT_STEPS from
    seeded weights, the live frame at the novel pose (PSNR gated at
    RELIGHT_GAIN dB above the step-0 frame), the light modes and a
    rotated light.  Returns (trainer, launches of its frames)."""
    from nerf_texture_tpu_torch.data.poses import orbit_pose
    from nerf_texture_tpu_torch.models.curved_field import CurvedFieldConfig
    from nerf_texture_tpu_torch.models.mesh_field import MeshFieldConfig
    from nerf_texture_tpu_torch.render.renderer import RenderConfig
    from nerf_texture_tpu_torch.train.curved_trainer import (
        CurvedTrainConfig, CurvedTrainer)
    from nerf_texture_tpu_torch.utils.metrics import psnr as psnr_of

    ccfg = CurvedFieldConfig(field=MeshFieldConfig(), light_model=light)
    tr = CurvedTrainer(ds, field_state, ccfg, RenderConfig(**CURVED_RENDER),
                       CurvedTrainConfig(**CURVED_TRAIN), seed=7, device=dev)
    if share is not None:                  # the same template and grid
        tr._anchor_tab, tr._near_cells = share._anchor_tab, share._near_cells
    name = f"relight {light}"
    npose = orbit_pose(np.pi / 2 + 0.2, 0.3, ds.radius)
    gt = white_gt(ds, npose)
    tr.initialize_states(1)
    psnr0 = psnr_of(tr.render_frame(npose, use_ema=False)["image"], gt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = tr.train(RELIGHT_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = np.asarray(run["losses"])
    check(bool(np.isfinite(losses).all()), f"{name}: non-finite loss")
    tr.render_frame(ds.poses[0], use_ema=False)                # warm-up
    walls, outs, launches, chunks = timed_frames(
        lambda p: tr.render_frame(p, use_ema=False),
        [npose] + [ds.poses[1 + i] for i in range(3)])
    check(launches > 0 and launches == chunks,
          f"{name}: {launches} kernel launches for {chunks} chunks")
    for o in outs:
        frame_checks(o, ds.H, ds.W, name)
    live = relit_frame(tr, npose, f"{name} live", card)
    launches += live["launches"]
    psnr_t = psnr_of(live["out"]["image"], gt)
    modes = {}
    for mode in ("Specular", "Diffuse", "Albedo"):
        tr.light_visual_mode = mode
        img = tr.render_frame(npose, use_ema=False)["image"]
        check(bool(torch.isfinite(img).all()), f"{name} {mode}: non-finite")
        modes[mode] = float(img.mean())
    tr.light_visual_mode = "Full"
    tr.euler = [0.4, -0.3, 0.2]
    img = tr.render_frame(npose, use_ema=False)["image"]
    tr.euler = None
    check(bool(torch.isfinite(img).all()), f"{name} rotated: non-finite")
    rot = float((img - live["out"]["image"]).abs().max())
    print(f"{name}: loss step 1 {losses[0]:.5f}, step {RELIGHT_STEPS} "
          f"{losses[-1]:.5f}; {RELIGHT_STEPS} steps in {train_s:.2f} s = "
          f"{RELIGHT_STEPS / train_s:.2f} it/s (refreshes in); peak memory "
          f"{peak:.1f} MiB ({card})")
    print(f"{name}: {ds.H}x{ds.W} {', '.join(f'{w:.2f}' for w in walls[1:])} "
          f"ms/frame over 3 poses; PSNR at the novel pose {psnr_t:.2f} dB "
          f"(step 0: {psnr0:.2f} dB, gate >= +{RELIGHT_GAIN}); mean of the "
          f"Specular / Diffuse / Albedo frames "
          f"{' / '.join(f'{v:.4f}' for v in modes.values())}; rotated light "
          f"moves the frame by {rot:.3f} ({card})")
    check(psnr_t >= psnr0 + RELIGHT_GAIN,
          f"{name}: PSNR {psnr_t:.2f} < step 0 {psnr0:.2f} + {RELIGHT_GAIN}")
    return tr, launches


def vertex_arm(dev, card: str, ds, mp) -> int:
    """The vertex encoder with its progressive levels at the bench's
    curved width: VERTEX_STEPS steps over the three levels, the vertex
    counts at each, s a step and a refresh, the live frame through the
    kernel, its PSNR (not gated).  Returns the frame's launches."""
    from nerf_texture_tpu_torch.data.poses import orbit_pose
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
    from nerf_texture_tpu_torch.models import mesh_field
    from nerf_texture_tpu_torch.models.curved_field import CurvedFieldConfig
    from nerf_texture_tpu_torch.models.mesh_field import MeshFieldConfig
    from nerf_texture_tpu_torch.render.renderer import RenderConfig
    from nerf_texture_tpu_torch.train.curved_trainer import (
        CurvedTrainConfig, CurvedTrainer)
    from nerf_texture_tpu_torch.utils.metrics import psnr as psnr_of

    fcfg = MeshFieldConfig(**VERTEX_FIELD)
    vnums = mesh_field.levels_vnum(fcfg)
    t0 = time.perf_counter()
    # the template itself (the projector's mesh carries its UV seams)
    fea = mesh_field.make_feature_projector(make_icosphere(4, radius=0.5),
                                            vnums[0], device=dev)
    fea_s = time.perf_counter() - t0
    fcfg = dataclasses.replace(
        fcfg, n_feature_vertices=int(fea.arrays.vertices.shape[0]))
    tr = CurvedTrainer(ds, mesh_field.make_state(mp, fea_projector=fea),
                       CurvedFieldConfig(field=fcfg, light_model="SH"),
                       RenderConfig(**CURVED_RENDER),
                       CurvedTrainConfig(
                           **CURVED_TRAIN,
                           iters_per_level=VERTEX_ITERS_PER_LEVEL),
                       seed=7, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.initialize_states(1)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    counts, walls, losses = [], [], []
    for _ in range(VERTEX_STEPS // VERTEX_ITERS_PER_LEVEL):
        t0 = time.perf_counter()
        run = tr.train(VERTEX_ITERS_PER_LEVEL)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append((tr.fea_level, tr.ccfg.field.n_feature_vertices))
        losses += run["losses"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    check(bool(np.isfinite(losses).all()), "vertex arm: non-finite loss")
    check([c[0] for c in counts] == [0, 1, 2],
          f"vertex arm: levels {counts}")
    check(tr.state.params["field"]["features_v"].shape[0] == counts[-1][1],
          "vertex arm: the features do not match the feature mesh")
    npose = orbit_pose(np.pi / 2 + 0.2, 0.3, ds.radius)
    live = relit_frame(tr, npose, "vertex live", card)
    vpsnr = psnr_of(live["out"]["image"], white_gt(ds, npose))
    per_step = [w / VERTEX_ITERS_PER_LEVEL for w in walls]
    print(f"vertex: schedule {vnums}, feature mesh {counts[0][1]} vertices "
          f"(built in {fea_s:.2f} s); (level, vertices) after each "
          f"{VERTEX_ITERS_PER_LEVEL} steps: {counts}; s a step by level "
          f"{', '.join(f'{s:.3f}' for s in per_step)} (refreshes and level "
          f"advances in); a refresh {refresh_s:.3f} s; loss step 1 "
          f"{losses[0]:.5f}, step {len(losses)} {losses[-1]:.5f}; peak "
          f"memory {peak:.1f} MiB; PSNR at the novel pose {vpsnr:.2f} dB "
          f"(not gated) ({card})")
    del tr
    torch.cuda.empty_cache()
    return live["launches"]


def narrow_relight(ds, dev_i, kind: str, ref=None):
    """The narrow card-vs-CPU config of phase 15 (SMALL_FIELD over
    make_icosphere(2, 0.5), 64x64) with the SG or Envmap light or the
    vertex encoder on ``dev_i``: seeded (the encoder's features and the
    phi grid scaled, see PHI_SCALE) and refreshed once, or with the
    params and grid of ``ref``."""
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector
    from nerf_texture_tpu_torch.models import mesh_field
    from nerf_texture_tpu_torch.models.curved_field import CurvedFieldConfig
    from nerf_texture_tpu_torch.models.mesh_field import MeshFieldConfig
    from nerf_texture_tpu_torch.render.renderer import RenderConfig
    from nerf_texture_tpu_torch.train.curved_trainer import (
        CurvedTrainConfig, CurvedTrainer)

    mesh = make_icosphere(2, radius=0.5)
    field = dict(SMALL_FIELD)
    fea = None
    if kind == "vertex":
        fea = mesh_field.make_feature_projector(
            mesh, SMALL_VERTEX["target_vnum"], device=dev_i)
        field.update(SMALL_VERTEX, n_feature_vertices=int(
            fea.arrays.vertices.shape[0]))
    tr_s = CurvedTrainer(type(ds)(n_frames=2, H=64, W=64),
                         mesh_field.make_state(MeshProjector(mesh,
                                                             device=dev_i),
                                               fea_projector=fea),
                         CurvedFieldConfig(field=MeshFieldConfig(**field),
                                           **SMALL_RELIGHT[kind]),
                         RenderConfig(**SMALL_CURVED_RENDER),
                         CurvedTrainConfig(**CURVED_TRAIN), seed=0,
                         device=dev_i)
    if ref is None:
        p = tr_s.state.params["field"]
        with torch.no_grad():
            if kind != "vertex":
                p["encoder"][:, :tr_s.ccfg.field.feature_spec.row_width] \
                    *= TABLE_SCALE
            p["normal"]["phi_grid"] *= PHI_SCALE
        tr_s.state.ema_params = tr_s.state.params
        tr_s.initialize_states(1)
    else:
        tr_s.state.params = tree_to(ref.params, dev_i)
        tr_s.state.ema_params = tr_s.state.params
        tr_s.state.occ = type(ref.occ)(*(t.to(dev_i) for t in ref.occ))
    return tr_s


# phase 15's CLIs: (log name, flags, --iters, get_preset's keywords)
RELIGHT_CLIS = (("cli_sg", ["--light_model", "SG"], CLI_SG_ITERS,
                 dict(light_model="SG")),
                ("cli_vertex", ["--encoder", "vertex", "--iters_per_level",
                                str(CLI_VERTEX_ITERS // 2)],
                 CLI_VERTEX_ITERS, dict(encoder_type="vertex")))


def relight_cli_runs() -> dict:
    """main_torch.py --light_model SG and --encoder vertex on phase 13's
    scene, each in a workspace of its own holding an icosphere template,
    the two processes at once.  Returns {name: cli_run's tuple}."""
    import shutil

    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere, save_obj

    scene = os.path.join(CLI_DIR, "scene")
    runs = {}
    for name, flags, iters, _ in RELIGHT_CLIS:
        ws = os.path.join(RELIGHT_DIR, name)
        shutil.rmtree(ws, ignore_errors=True)
        os.makedirs(os.path.join(ws, "meshes"))
        save_obj(os.path.join(ws, "meshes", "surface_coacd_remesh.obj"),
                 make_icosphere(4, radius=0.5))
        runs[name] = Background(lambda ws=ws, flags=flags, iters=iters,
                                name=name: cli_run(
            ["main_torch.py", scene, "--workspace", ws, "--iters",
             str(iters), "--eval_interval", str(iters)] + flags, name))
    return {name: run.result() for name, run in runs.items()}


WORKER_START = "relight worker: start"
# phase 21's host priority in the relight worker, on top of the worker's
SHELL_NICE = 10


def relight_clis(card: str, clis: Background) -> dict:
    """Phase 15's CLIs (``clis``, started by start_clis): exit 0, a finite
    PSNR line, a checkpoint.  Returns their eval frames' proxy_select
    launches."""
    from nerf_texture_tpu_torch.config import get_preset
    from nerf_texture_tpu_torch.train import trainer as ckpt

    scene = os.path.join(CLI_DIR, "scene")
    t0 = time.perf_counter()
    runs = clis.result()
    print(f"relight: waited {time.perf_counter() - t0:.1f} s for the CLIs "
          f"(run at once with each other and beside the phases since "
          f"their start)")
    launches = {}
    for name, _, iters, kw in RELIGHT_CLIS:
        out = cli_output(runs, name, what="relight")
        for ln in (_lines(out, "feature mesh:") + _lines(out, "setup:")
                   + _lines(out, "[") + _lines(out, "timing:")
                   + _lines(out, "checkpoint:")):
            print(f"  {name}: {ln}")
        evals = _evals(out)
        check(len(evals) == 1 and evals[0][0] == iters
              and np.isfinite(evals[0][1]) and np.isfinite(evals[0][2]),
              f"{name}: eval lines {evals}")
        raw = ckpt.read_checkpoint(os.path.join(
            RELIGHT_DIR, name, "checkpoints",
            get_preset(scene, **kw).field_name))
        check(int(raw["step"]) == iters, f"{name}: checkpoint step")
        launches[f"relight_{name}_eval"] = _select_launches(out)[0]
        check(launches[f"relight_{name}_eval"] > 0,
              f"{name}: the eval frame never launched proxy_select")
        print(f"relight: {name}: main_torch.py PSNR {evals[0][2]:.2f} dB "
              f"after {iters} steps ({card})")
    return launches


def relight_sh_import(tr, ds, card: str) -> int:
    """Phase 15's imported environment on an SH field ``tr`` in mode
    'none' (phase 10's trained field, before phase 11 imports a texture
    into it): ``load_envmap`` with visibility probes, the relit frame
    through the kernel, ``clear_envmap`` back to the learned frame bit
    for bit.  Returns the relit frame's launches."""
    from nerf_texture_tpu_torch.data.poses import orbit_pose

    check(tr.mode == "none" and tr.ccfg.light_model == "SH",
          f"the SH import needs an SH field in mode 'none' ({tr.mode})")
    torch.backends.cuda.matmul.allow_tf32 = False     # f32 shading
    sky = sky_png(os.path.join(RELIGHT_DIR, "sky.png"))
    npose = orbit_pose(np.pi / 2 + 0.2, 0.3, ds.radius)
    learned = tr.render_frame(npose, use_ema=False)["image"]
    t0 = time.perf_counter()
    tr.load_envmap(sky, with_visibility=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    li = tr.light_import
    launches = relit_frame(tr, npose, "relight SH import", card,
                           reference=learned)["launches"]
    tr.clear_envmap()
    again = tr.render_frame(npose, use_ema=False)["image"]
    check(torch.equal(again, learned),
          "clear_envmap: the frame differs from the learned frame")
    print(f"relight: SH load_envmap (with visibility) {load_s:.3f} s: "
          f"env_import {tuple(li['env_import'].shape)}, env_import_vis "
          f"{tuple(li['env_import_vis'].shape)}, probes "
          f"{tuple(li['probes'].shape)}; after clear_envmap the frame equals "
          f"the learned frame bit for bit ({card})")
    torch.backends.cuda.matmul.allow_tf32 = True
    return launches


def relight_phase(dev, card: str, ds, own_sh: bool) -> dict:
    """Phase 15 but its CLIs: the SG and Envmap arms, imported
    environments (the SH one on a shorter SH arm of this phase's own
    when ``own_sh``; the whole smoke runs it on phase 10's field), the
    vertex arm and the narrow card-vs-CPU frames.  Returns the
    proxy_select_cdf launches of each path."""
    from nerf_texture_tpu_torch.data.poses import orbit_pose
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector
    from nerf_texture_tpu_torch.models import mesh_field
    from nerf_texture_tpu_torch.models.lights import sg as sg_light
    from nerf_texture_tpu_torch.models.lights import sh as sh_light

    torch.backends.cuda.matmul.allow_tf32 = False
    wall0 = time.perf_counter()
    sky = sky_png(os.path.join(RELIGHT_DIR, "sky.png"))
    npose = orbit_pose(np.pi / 2 + 0.2, 0.3, ds.radius)
    cdf = {}
    mp = MeshProjector(make_icosphere(4, radius=0.5), device=dev)
    fs = mesh_field.make_state(mp)

    # -- the SG and Envmap arms ----------------------------------------------
    t0 = time.perf_counter()
    tr_sg, cdf["relight_sg_live"] = relight_arm(dev, card, ds, "SG", fs)
    sg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr_env, cdf["relight_envmap_live"] = relight_arm(dev, card, ds, "Envmap",
                                                     fs, share=tr_sg)
    env_s = time.perf_counter() - t0

    # -- imported environments ---------------------------------------------
    if own_sh:
        tr_sh, _ = relight_arm(dev, card, ds, "SH", fs, share=tr_sg)
        cdf["relight_sh_import"] = relight_sh_import(tr_sh, ds, card)
        del tr_sh
    learned = tr_env.render_frame(npose, use_ema=False)["image"]
    tr_env.load_envmap(sky)
    cdf["relight_envmap_import"] = relit_frame(
        tr_env, npose, "relight Envmap import", card, reference=learned)[
        "launches"]
    learned = tr_sg.render_frame(npose, use_ema=False)["image"]
    t0 = time.perf_counter()
    lobes = sg_light.envmap_to_sg(
        sh_light.image_to_envmap(sky, force_white=False), device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    check(bool(torch.isfinite(lobes).all()), "envmap_to_sg: non-finite")
    tr_sg.light_import = {"lgt_sgs_import": lobes}
    cdf["relight_sg_import"] = relit_frame(
        tr_sg, npose, "relight SG import", card, reference=learned)[
        "launches"]
    print(f"relight: envmap_to_sg {tuple(lobes.shape)} lobes (500 Adam "
          f"steps) in {fit_s:.2f} s ({card})")
    del tr_sg, tr_env
    torch.cuda.empty_cache()

    # -- the vertex arm ------------------------------------------------------
    t0 = time.perf_counter()
    cdf["vertex_live"] = vertex_arm(dev, card, ds, mp)
    vertex_s = time.perf_counter() - t0

    # -- narrow frames, card vs CPU -------------------------------------------
    t0 = time.perf_counter()
    for kind in SMALL_RELIGHT:
        cpu = narrow_relight(ds, "cpu", kind)
        gpu = narrow_relight(ds, dev, kind, ref=cpu.state)
        pose = orbit_pose(1.2, 0.7, 2.0)
        a = gpu.render_frame(pose)
        b = cpu.render_frame(pose)
        ia, ib = a["image"].cpu().numpy(), b["image"].cpu().numpy()
        la = a["weights_sum"].cpu().numpy() > 0
        lb = b["weights_sum"].cpu().numpy() > 0
        p_s, e_s = psnr(ia, ib), float(np.abs(ia - ib).max())
        mism = float(np.mean(la != lb))
        print(f"relight parity: {kind} 64x64 frame card vs CPU: PSNR "
              f"{p_s:.2f} dB, max abs {e_s:.3g}, live mismatch "
              f"{mism:.4f} ({int(lb.sum())} live on CPU) ({card})")
        check(lb.any() and ib[lb].std() > 1e-2,
              f"the small {kind} frame has no structure")
        check(p_s >= FRAME_PSNR_MIN and e_s <= FRAME_MAX_ABS
              and mism <= FRAME_LIVE_MISMATCH,
              f"{kind} card vs CPU: PSNR {p_s} dB, max abs {e_s}, live "
              f"mismatch {mism}")

    narrow_s = time.perf_counter() - t0
    print(f"relight: phase walls: SG arm {sg_s:.1f} s, Envmap arm "
          f"{env_s:.1f} s, vertex arm {vertex_s:.1f} s, narrow frames "
          f"{narrow_s:.1f} s; the phase {time.perf_counter() - wall0:.1f} s "
          f"({card})")
    torch.backends.cuda.matmul.allow_tf32 = True
    return cdf


def relight_from_worker(worker: Background) -> tuple:
    """The relight worker's result (``start_worker('relight')``): its
    phase-15 and phase-21 lines printed here; returns the selection
    launches of phase 15's paths and of phase 21's (by kind)."""
    res = from_worker(worker, "relight", WORKER_START)
    return res["relight_launches"], res["shell"]


# the viewer and scenes larger than the unit cube (phase 16).  The JPEG
# copy of phase 13's scene at quality 95 in 4:4:4 (PIL's subsampling=0:
# at PIL's default 4:2:0 this scene's colour edges cap the PSNR at 37.3
# dB, measured with PIL on the CPU), its decode held against the PNG
# scene at JPEG_PSNR_MIN.  main_nerf_torch.py --bound 2 --dt_gamma 1/128
# for B2_ITERS steps on phase 13's scene, whose RGBA frames train with a
# random background (scripts/torch_bound_probe.py: on the JPEG copy,
# RGB on white, white fog fills the grid, which stays 99.6% occupied
# after 3000 steps, and the inference pool's 24 samples a ray decimate
# it to 12-15 dB while the dense march reads 27.5-30.7 dB; the PNG
# scene's grid empties at ~1,440 steps, when its decay takes the
# untrained cells under the threshold, and the pool reads 27.4 dB at
# 1500 steps against 22.4 at 1000), its eval gated at B2_GAIN dB above
# its step-0 frame and at most B2_SLACK dB below phase 13's NGP CLI, its
# mesh on the sphere as phase 8's; the viewer in this process on phase
# 10's trained field (800x800, STREAM_PARTS frames a tier);
# main_torch.py --gui on phase 13's undistilled workspace, GUI_PARTS
# stream parts while it trains
VIEWER_DIR = os.path.join("build", "viewer")
JPEG_SCENE_QUALITY, JPEG_SCENE_SUBSAMPLING = 95, "4:4:4"
JPEG_PSNR_MIN = 40.0
B2_BOUND, B2_DT_GAMMA, B2_ITERS, B2_EVAL = 2.0, 0.0078125, 1500, 750
B2_GAIN, B2_SLACK = 3.0, 3.0
STREAM_PARTS, GUI_PARTS = 5, 10
STREAM_QUALITY = 85
VIEWER_WORKER_START = "viewer worker: start"
# a CLI run through runpy with its peak device memory printed at exit
# (the CLI itself unchanged)
_PEAK_WRAPPER = """
import atexit, runpy, sys, torch
atexit.register(lambda: print("peak device memory: %.1f MiB"
                              % (torch.cuda.max_memory_allocated() / 2**20),
                              flush=True))
sys.argv = {argv!r}
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def _http(url: str, body: dict | None = None, timeout: float = 300):
    """(status, bytes) of a GET, or of a JSON POST of ``body``."""
    import urllib.request

    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _stream_parts(url: str, n: int, timeout: float = 300) -> list:
    """n consecutive parts of ``url``/stream: [(JPEG bytes, host s when
    read)]."""
    import urllib.request

    parts = []
    with urllib.request.urlopen(url + "/stream", timeout=timeout) as s:
        for _ in range(n):
            head = b""
            while b"\r\n\r\n" not in head:
                c = s.read(1)
                check(len(c) == 1, "the MJPEG stream ended")
                head += c
            size = int(head.split(b"Content-Length: ")[1].split(b"\r\n")[0])
            parts.append((s.read(size), time.perf_counter()))
    return parts


def _wait_frames(app, n: int, timeout: float = 300):
    """Until the viewer loop has rendered n more frames."""
    f0, t0 = app.frames, time.perf_counter()
    while app.frames < f0 + n:
        check(time.perf_counter() - t0 < timeout,
              f"the viewer loop rendered {app.frames - f0} frames in "
              f"{timeout} s")
        time.sleep(0.02)


def quick_curved(dev, ds):
    """A curved field at the bench's curved width from seeded weights,
    one refresh and 48 steps (``--only viewer``'s field)."""
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector
    from nerf_texture_tpu_torch.models import mesh_field
    from nerf_texture_tpu_torch.models.curved_field import CurvedFieldConfig
    from nerf_texture_tpu_torch.models.mesh_field import MeshFieldConfig
    from nerf_texture_tpu_torch.render.renderer import RenderConfig
    from nerf_texture_tpu_torch.train.curved_trainer import (
        CurvedTrainConfig, CurvedTrainer)

    torch.backends.cuda.matmul.allow_tf32 = False
    tr = CurvedTrainer(ds, mesh_field.make_state(MeshProjector(
        make_icosphere(4, radius=0.5), device=dev)),
        CurvedFieldConfig(field=MeshFieldConfig(), light_model="SH"),
        RenderConfig(**CURVED_RENDER), CurvedTrainConfig(**CURVED_TRAIN),
        seed=7, device=dev)
    tr.initialize_states(1)
    tr.train(48)
    return tr


def viewer_phase(dev, card: str, tr) -> dict:
    """Phase 16's viewer in this process: ``ViewerApp`` + ``serve`` on
    127.0.0.1 (a free port) around the trained ``tr``, training off and
    the resolution frozen: /status, the stream's rate at the downscaled
    and the full tier, an orbit through /control whose next whole frame
    streams as the bytes ``data.jpeg.encode`` makes of ``app.render()``
    and differs from the frame before; then through /control the growing
    step (a parity pool frame), the crop that halves x, the baked atlas
    and take_photo.  Returns the selection launches of its frames."""
    from nerf_texture_tpu_torch.data import jpeg
    from nerf_texture_tpu_torch.data.images import read_png
    from nerf_texture_tpu_torch.ops.proxy_select import proxy_select_cdf
    from nerf_texture_tpu_torch.viewer import ViewerApp, serve

    torch.backends.cuda.matmul.allow_tf32 = False      # curved: f32
    os.makedirs(VIEWER_DIR, exist_ok=True)
    H, W = tr.H, tr.W
    app = ViewerApp(tr, W=W, H=H)
    app.set_dynamic_resolution(False, tier=3)
    httpd, stop = serve(app, host="127.0.0.1", port=0, block=False)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    launches = {}
    try:
        status = json.loads(_http(url + "/status")[1])
        check(sorted(status) == ["downscale", "metrics", "steps_per_frame",
                                 "training", "visual_mode"]
              and status["training"] is False and status["downscale"] == 1,
              f"viewer /status {status}")
        rates, last = {}, {}
        for tier in (0, 3):
            _http(url + "/control", {"action": "set_dynamic_resolution",
                                     "on": False, "tier": tier})
            _wait_frames(app, 3)
            parts = _stream_parts(url, STREAM_PARTS + 1)
            rates[tier] = STREAM_PARTS / (parts[-1][1] - parts[0][1])
            last[tier] = parts[-1][0]
        pre = jpeg.decode(last[3])
        check(pre.shape == (H, W, 3), f"stream part of shape {pre.shape}")
        _http(url + "/control", {"action": "orbit", "dx": 60, "dy": 25})
        _wait_frames(app, 3)            # a frame wholly after the orbit
        part = _stream_parts(url, 1)[0][0]
        stop.set()                      # the loop ends after its frame
        n = -1
        while n != app.frames:
            n = app.frames
            time.sleep(1.5)
        torch.cuda.synchronize()
        proxy_select_cdf.launches = 0
        t0 = time.perf_counter()
        img = app.render()
        torch.cuda.synchronize()
        render_ms = (time.perf_counter() - t0) * 1e3
        launches["viewer_live"] = proxy_select_cdf.launches
        full = dict(app.last_frame)
        check(0 < launches["viewer_live"] == full["chunks"],
              f"viewer frame: {launches['viewer_live']} proxy_select_cdf "
              f"launches for {full['chunks']} chunks")
        t0 = time.perf_counter()
        ref = jpeg.encode(img, quality=STREAM_QUALITY)
        encode_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        got = jpeg.decode(part)
        decode_ms = (time.perf_counter() - t0) * 1e3
        check(part == ref, "the streamed part differs from the encoder "
              "applied to app.render() at the same pose")
        check(not np.array_equal(got, pre), "the orbit did not change the "
              "streamed frame")
        print(f"viewer: {H}x{W} on phase 10's trained field, training off: "
              f"stream {rates[3]:.2f} frames/s at the full tier, "
              f"{rates[0]:.2f} at downscale 4; a frame {render_ms:.1f} ms "
              f"({full['live']} live rays, {full['chunks']} chunks = "
              f"proxy_select_cdf launches), JPEG encode {encode_ms:.1f} ms "
              f"({len(ref)} bytes, quality {STREAM_QUALITY}), decode "
              f"{decode_ms:.1f} ms; the part after the orbit equals "
              f"encode(app.render()) byte for byte and differs from the "
              f"frame before ({card})")

        _http(url + "/control", {"action": "set_dt_gamma", "v": 1 / 128})
        check(tr.rcfg.dt_gamma == 1 / 128, "set_dt_gamma did not reach rcfg")
        pose = app.camera.pose
        tr.render_frame(pose, parity=True)                  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = tr.render_frame(pose, parity=True)
        torch.cuda.synchronize()
        g_ms = (time.perf_counter() - t0) * 1e3
        # the trained curved shading is not clamped: a pool frame may
        # hold slightly negative pixels (the viewer clips them)
        img_g = g["image"]
        check(tuple(img_g.shape) == (H, W, 3)
              and bool(torch.isfinite(img_g).all())
              and 0 < g["live"] < H * W
              and float(g["weights_sum"].max()) > 0.05,
              f"viewer: dt_gamma pool frame: shape {tuple(img_g.shape)}, "
              f"live {g['live']}")
        _http(url + "/control", {"action": "set_dt_gamma", "v": 0.0})
        c = tr.render_frame(pose, parity=True)
        g_psnr = psnr(img_g.cpu().numpy(), c["image"].cpu().numpy())
        print(f"viewer: set_dt_gamma(1/128): parity pool frame {g_ms:.1f} "
              f"ms, {g['live']} live rays, {g['chunks']} chunks, pixels in "
              f"[{float(img_g.min()):.4f}, {float(img_g.max()):.4f}] "
              f"(constant step: [{float(c['image'].min()):.4f}, "
              f"{float(c['image'].max()):.4f}]); PSNR {g_psnr:.2f} dB "
              f"against the constant step's frame ({card})")

        _http(url + "/control", {"action": "set_aabb", "dim": 0, "v": 0.0})
        proxy_select_cdf.launches = 0
        half = app.render()
        launches["viewer_crop"] = proxy_select_cdf.launches
        crop = dict(app.last_frame)
        check(0 < crop["live"] < full["live"]
              and launches["viewer_crop"] == crop["chunks"],
              f"the crop that halves x: {crop} against {full}")
        _http(url + "/control", {"action": "set_aabb", "dim": 0, "v": -1.0})
        check(list(tr.crop_aabb) == [-1, -1, -1, 1, 1, 1],
              f"crop {tr.crop_aabb}")
        tr.crop_aabb = None

        _http(url + "/control", {"action": "toggle_baked"})
        check(app.baked, "toggle_baked did not switch the baked frames on")
        app.render()                                        # the bake
        torch.cuda.synchronize()
        proxy_select_cdf.launches = 0
        t0 = time.perf_counter()
        baked = app.render()
        torch.cuda.synchronize()
        baked_ms = (time.perf_counter() - t0) * 1e3
        launches["viewer_baked"] = proxy_select_cdf.launches
        check(0 < launches["viewer_baked"] == app.last_frame["chunks"],
              f"viewer baked frame: {launches['viewer_baked']} launches for "
              f"{app.last_frame}")
        _http(url + "/control", {"action": "toggle_baked"})
        photo = os.path.join(VIEWER_DIR, "photo.png")
        _http(url + "/control", {"action": "take_photo", "path": photo})
        check(read_png(photo).shape == (H, W, 3), "take_photo's PNG")
        print(f"viewer: crop x >= 0: {crop['live']} of {full['live']} live "
              f"rays, PSNR {psnr(half / 255.0, img / 255.0):.2f} dB against "
              f"the whole frame; baked frame {baked_ms:.1f} ms "
              f"({launches['viewer_baked']} launches = chunks), PSNR "
              f"{psnr(baked / 255.0, img / 255.0):.2f} dB against the live "
              f"one; take_photo wrote {photo} ({card})")
    finally:
        stop.set()
        httpd.shutdown()
        httpd.server_close()
    return launches


def jpeg_scene(card: str):
    """Phase 13's scene written again with JPEG frames by the port's
    encoder; loaded with NeRFDataset and held against the PNG scene."""
    import shutil

    from nerf_texture_tpu_torch.data import jpeg
    from nerf_texture_tpu_torch.data.images import read_png
    from nerf_texture_tpu_torch.data.provider import NeRFDataset

    src = os.path.join(CLI_DIR, "scene")
    dst = os.path.join(VIEWER_DIR, "scene_jpeg")
    shutil.rmtree(dst, ignore_errors=True)
    os.makedirs(os.path.join(dst, "images"))
    with open(os.path.join(src, "transforms.json")) as f:
        meta = json.load(f)
    enc_s, nbytes, paths = 0.0, 0, []
    for fr in meta["frames"]:
        rgba = read_png(os.path.join(src, fr["file_path"])).astype(
            np.float32) / 255.0
        rgb = rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])
        u8 = np.round(rgb * 255.0).astype(np.uint8)
        fr["file_path"] = os.path.splitext(fr["file_path"])[0] + ".jpg"
        t0 = time.perf_counter()
        data = jpeg.encode(u8, quality=JPEG_SCENE_QUALITY,
                           subsampling=JPEG_SCENE_SUBSAMPLING)
        enc_s += time.perf_counter() - t0
        nbytes += len(data)
        paths.append(os.path.join(dst, fr["file_path"]))
        with open(paths[-1], "wb") as f:
            f.write(data)
    with open(os.path.join(dst, "transforms.json"), "w") as f:
        json.dump(meta, f)
    dec = []
    for p in paths:
        t0 = time.perf_counter()
        jpeg.read_jpeg(p)
        dec.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    ds_j = NeRFDataset(dst, split="train", scale=0.33)
    load_s = time.perf_counter() - t0
    ds_p = NeRFDataset(src, split="train", scale=0.33)
    check(ds_j.images.shape[:3] == ds_p.images.shape[:3]
          and ds_j.images.shape[-1] == 3, f"JPEG scene images "
          f"{ds_j.images.shape} against {ds_p.images.shape}")
    check(np.array_equal(ds_j.poses, ds_p.poses)
          and np.array_equal(ds_j.intrinsics, ds_p.intrinsics),
          "the JPEG scene's poses or intrinsics differ from the PNG one's")
    gt = ds_p.images.astype(np.float32) / 255.0
    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
    ps = [psnr(ds_j.images[k].astype(np.float32) / 255.0, gt[k])
          for k in range(len(gt))]
    print(f"scenes: phase 13's scene as {len(paths)} JPEG frames "
          f"{ds_j.H}x{ds_j.W} (quality {JPEG_SCENE_QUALITY}, "
          f"{JPEG_SCENE_SUBSAMPLING}): encode {enc_s / len(paths):.4f} s a "
          f"frame, {nbytes / len(paths) / 1024:.1f} KiB a frame; decode "
          f"{np.median(dec):.4f} s a frame (median, {min(dec):.4f}-"
          f"{max(dec):.4f}); NeRFDataset load {load_s:.3f} s "
          f"({ds_j.num_frames} training frames); PSNR against the PNG "
          f"scene {min(ps):.2f}-{max(ps):.2f} dB (gate >= {JPEG_PSNR_MIN}) "
          f"({card})")
    check(min(ps) >= JPEG_PSNR_MIN, f"JPEG scene PSNR {min(ps)} dB")


def _sphere_in_scene(scene: str):
    """(centre, radius) of the synthetic sphere (the origin, r 0.5 in the
    written poses) in the coordinates NeRFDataset(scene, scale=0.33) gives
    the CLIs: the similarity that maps the written camera centres onto the
    loaded ones."""
    from nerf_texture_tpu_torch.data.provider import NeRFDataset

    raw = NeRFDataset(scene, split="train", scale=1.0, normalize=False)
    ds = NeRFDataset(scene, split="train", scale=0.33)
    cw, cl = raw.poses[:, :3, 3], ds.poses[:, :3, 3]
    dw, dl = cw - cw.mean(0), cl - cl.mean(0)
    a = float(np.sum(dw * dl) / np.sum(dw * dw))
    b = cl.mean(0) - a * cw.mean(0)
    fit = float(np.abs(a * cw + b - cl).max())
    check(fit < 1e-4, f"the scene's camera centres are not a similarity "
          f"of the written ones (residual {fit})")
    return b, 0.5 * a


def bound2_cli(dev, card: str, scene: str) -> dict:
    """``main_nerf_torch.py --bound 2 --dt_gamma 1/128 --save_mesh`` on
    ``scene`` (its step-0 frame rendered here by the same trainer at step
    0); returns its PSNR and eval launches."""
    import shutil

    from scipy.spatial import cKDTree

    from nerf_texture_tpu_torch.data.provider import NeRFDataset
    from nerf_texture_tpu_torch.geometry.mesh import load_obj
    from nerf_texture_tpu_torch.models.ngp import NGPConfig
    from nerf_texture_tpu_torch.render.renderer import RenderConfig
    from nerf_texture_tpu_torch.train import trainer as ckpt
    from nerf_texture_tpu_torch.train.trainer import TrainConfig, Trainer

    ws = os.path.join(VIEWER_DIR, "ws_b2")
    shutil.rmtree(ws, ignore_errors=True)
    ds = NeRFDataset(scene, split="train", scale=0.33)
    tr0 = Trainer(ds, NGPConfig(bound=B2_BOUND),
                  RenderConfig.for_bound(B2_BOUND, dt_gamma=B2_DT_GAMMA,
                                         max_steps=384),
                  TrainConfig(lr=1e-2, total_steps=B2_ITERS, num_rays=4096),
                  seed=0, device=dev)
    psnr0 = tr0.eval_psnr([0])
    del tr0
    torch.cuda.empty_cache()
    argv = ["main_nerf_torch.py", scene, "--workspace", ws, "--iters",
            str(B2_ITERS), "--eval_interval", str(B2_EVAL), "--bound",
            str(B2_BOUND), "--dt_gamma", str(B2_DT_GAMMA), "--save_mesh"]
    # below phase 13's CLI chain, which holds the smoke's wall: this run
    # has slack beside it
    code, out, wall = cli_run(["-c", _PEAK_WRAPPER.format(argv=argv)],
                              "cli_bound2", nice=10)
    check(code == 0, f"main_nerf_torch.py --bound 2: exit {code}: "
          f"{out[-3000:]}")
    for ln in (_lines(out, "setup:") + _lines(out, "[")
               + _lines(out, "timing:") + _lines(out, "checkpoint:")
               + _lines(out, "mesh:") + _lines(out, "peak")):
        print(f"  bound-2 cli: {ln}")
    evals = _evals(out)
    check([e[0] for e in evals] == list(range(B2_EVAL, B2_ITERS + 1,
                                              B2_EVAL))
          and all(np.isfinite(e[1]) and np.isfinite(e[2]) for e in evals),
          f"bound-2 CLI eval lines {evals}")
    b2_psnr = evals[-1][2]
    raw = ckpt.read_checkpoint(os.path.join(ws, "checkpoints", "ngp"))
    shape = tuple(raw["occ"]["density"].shape)
    check(int(raw["step"]) == B2_ITERS and shape == (2, 128 ** 3),
          f"bound-2 checkpoint: step {int(raw['step'])}, grid {shape}")
    occ = raw["occ"]["occ"].reshape(2, -1).numpy()
    launches = _select_launches(out)
    check(launches == (0, 0), f"bound-2 eval frames launched the selection "
          f"kernels {launches}: a 2-cascade grid takes the pool path")
    mesh = load_obj(os.path.join(ws, "meshes", "ngp_mesh.obj"))
    check(len(mesh.faces) > 0, "the bound-2 mesh is empty")
    centre, radius = _sphere_in_scene(scene)
    v = mesh.vertices.reshape(-1, 3) - centre
    k = np.arange(NGP_MESH_PROBES) + 0.5
    z = 1.0 - 2.0 * k / NGP_MESH_PROBES
    a = np.pi * (1.0 + 5.0 ** 0.5) * k
    probes = radius * np.stack([np.sqrt(1 - z * z) * np.cos(a),
                                np.sqrt(1 - z * z) * np.sin(a), z], -1)
    cover = (float(np.mean(cKDTree(v).query(probes)[0] <= NGP_MESH_TOL))
             if len(v) else 0.0)
    off = np.abs(np.linalg.norm(v, axis=-1) - radius)
    print(f"scenes: main_nerf_torch.py --bound {B2_BOUND:g} --dt_gamma "
          f"{B2_DT_GAMMA} on {scene}: exit 0 in {wall:.1f} s; grid "
          f"{shape} ({int(occ[0].sum())} + {int(occ[1].sum())} occupied "
          f"cells in levels 0 and 1); PSNR {b2_psnr:.2f} dB after "
          f"{B2_ITERS} steps from {psnr0:.2f} dB at step 0 (gate +"
          f"{B2_GAIN}); eval frames launched neither kernel (the pool "
          f"path); mesh {len(mesh.vertices)} vertices, the sphere (r "
          f"{radius:.4f} in the scene's coordinates) covered at "
          f"{100 * cover:.1f}% of {NGP_MESH_PROBES} points within "
          f"{NGP_MESH_TOL} (gate >= {100 * NGP_MESH_COVER:.0f}%), "
          f"{100 * np.mean(off <= NGP_MESH_TOL):.1f}% of the vertices near "
          f"it ({card})")
    check(b2_psnr >= psnr0 + B2_GAIN, f"bound-2 PSNR {b2_psnr} dB from "
          f"{psnr0} dB at step 0")
    check(cover >= NGP_MESH_COVER, f"the bound-2 mesh covers {cover} of "
          f"the sphere")
    return {"psnr": b2_psnr, "psnr0": psnr0,
            "launches": {"bound2_cli_eval": launches}}


def _log_has(path: str, text: str) -> bool:
    if not os.path.exists(path):
        return False
    with open(path) as f:
        return text in f.read()


def gui_cli(card: str, ws: str, plain_iters: int) -> None:
    """``main_torch.py <scene> --gui`` on the undistilled workspace once its
    run has saved its checkpoint: /status while it trains, GUI_PARTS
    stream parts (the step advances), stop_training and
    switch_visual_mode through /control, exit 0 on SIGTERM."""
    from nerf_texture_tpu_torch.data import jpeg

    plain_log = os.path.join("chiprun_out", "cli_curved_plain.log")
    t0 = time.perf_counter()
    while not _log_has(plain_log, f"checkpoint: saved step {plain_iters}"):
        check(not _log_has(plain_log, "Traceback"),
              "the undistilled CLI failed; no workspace for --gui")
        check(time.perf_counter() - t0 < 1000, "no undistilled checkpoint")
        time.sleep(1.0)
    waited = time.perf_counter() - t0
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    log_p = os.path.join("chiprun_out", "cli_gui.log")
    t0 = time.perf_counter()
    with open(log_p, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "main_torch.py", os.path.join(CLI_DIR, "scene"),
             "--workspace", ws, "--gui", "--port", str(port)], stdout=log,
            stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "PYTHONUNBUFFERED": "1"})
    CHILDREN.append(proc)
    while not _log_has(log_p, "[viewer] serving on"):
        check(proc.poll() is None, f"main_torch.py --gui exited "
              f"{proc.returncode}: {open(log_p).read()[-3000:]}")
        check(time.perf_counter() - t0 < 600, "--gui never served")
        time.sleep(0.5)
    up_s = time.perf_counter() - t0
    check(_log_has(log_p, f"loaded step {plain_iters}"),
          "main_torch.py --gui did not load the undistilled checkpoint")
    url = f"http://127.0.0.1:{port}"
    while True:
        status = json.loads(_http(url + "/status")[1])
        if "step" in status["metrics"]:
            break
        check(time.perf_counter() - t0 < 900, "--gui never trained a frame")
        time.sleep(0.5)
    check(status["training"] is True, f"--gui /status {status}")
    step1 = status["metrics"]["step"]
    parts = _stream_parts(url, GUI_PARTS)
    for data, _ in parts:
        check(jpeg.decode(data).ndim == 3, "a --gui stream part")
    fps = (GUI_PARTS - 1) / (parts[-1][1] - parts[0][1])
    status = json.loads(_http(url + "/status")[1])
    step2 = status["metrics"]["step"]
    check(step2 > step1, f"--gui: the step did not advance ({step1} -> "
          f"{step2})")
    check(_http(url + "/control", {"action": "stop_training"})[0] == 200,
          "stop_training")
    check(json.loads(_http(url + "/status")[1])["training"] is False,
          "--gui still training after stop_training")
    check(_http(url + "/control", {"action": "switch_visual_mode"})[0]
          == 200, "switch_visual_mode")
    mode = json.loads(_http(url + "/status")[1])["visual_mode"]
    check(mode == "UV", f"--gui visual mode {mode}")
    proc.send_signal(signal.SIGTERM)
    code = proc.wait(timeout=120)
    wall = time.perf_counter() - t0
    out = open(log_p).read()
    for ln in _lines(out, "setup:") + _lines(out, "checkpoint:"):
        print(f"  gui cli: {ln}")
    check(code == 0, f"main_torch.py --gui ended {code} on SIGTERM: "
          f"{out[-3000:]}")
    print(f"scenes: main_torch.py --gui on the undistilled workspace "
          f"(waited {waited:.1f} s for its checkpoint): serving after "
          f"{up_s:.1f} s, loaded step {plain_iters}; while training "
          f"{GUI_PARTS} stream parts at {fps:.2f} frames/s, step "
          f"{step1:.0f} -> {step2:.0f}; stop_training and "
          f"switch_visual_mode ({mode}) through /control; exit 0 on "
          f"SIGTERM after {wall:.1f} s ({card})")


# the capture-to-scene path (phase 18): the committed format fixtures
# (scripts/make_format_fixtures.py wrote them with PIL and imageio, each
# beside its arrays) decoded bit for bit; 800x800 decodes timed (a
# baseline JPEG by the port's encoder, the progressive fixture, an Adam7
# PNG and a palette PNG built here, the last two held to their source);
# then phase 13's scene as a capture: its cameras as a COLMAP text model,
# PREPARE_BLURRED box-blurred copies of its frames beside them,
# remove_blurry_frames(PREPARE_KEEP), colmap_to_transforms, NeRFDataset
# against phase 13's (poses within PREPARE_POSE_ATOL: the quaternion round
# trip moves them by rounding, images bit for bit), and PREPARE_STEPS
# training steps at the bench NGP width on it.  The synthetic scene's
# written cameras are improper (det -1: orbit_pose's right, up, forward
# axes, in both packages), which a COLMAP quaternion cannot hold, so the
# model holds them in the world mirrored by PREPARE_MIRROR_NERF (z -> -z
# of the nerf world); NeRFDataset's normalisation commutes with the
# mirror, so the round trip's poses are phase 13's mirrored in the ngp
# frame (y -> -y), PREPARE_MIRROR_NGP
FORMATS_DIR = os.path.join("tests", "fixtures", "formats")
PREPARE_DIR = os.path.join("build", "prepare")
PREPARE_BLURRED, PREPARE_BLUR, PREPARE_KEEP = 6, 9, 0.8
PREPARE_POSE_ATOL = 1e-5
PREPARE_MIRROR_NERF = np.diag([1.0, 1.0, -1.0, 1.0])
PREPARE_MIRROR_NGP = np.diag([1.0, -1.0, 1.0, 1.0]).astype(np.float32)
PREPARE_STEPS = 100
DECODE_REPEATS = 3


def _format_tools():
    """scripts/make_format_fixtures.py as a module (its PNG builder needs
    only numpy and zlib)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_format_fixtures", os.path.join("scripts",
                                             "make_format_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _matches(arr: np.ndarray, want: dict) -> bool:
    """``arr`` equals a fixture's expected array: its .npy, or its SHA-256
    with shape and dtype."""
    import hashlib

    if "npy" in want:
        ref = np.load(os.path.join(FORMATS_DIR, want["npy"]),
                      allow_pickle=False)
        return (arr.dtype == ref.dtype and arr.shape == ref.shape
                and np.array_equal(arr, ref))
    return (str(arr.dtype) == want["dtype"]
            and list(arr.shape) == want["shape"]
            and hashlib.sha256(np.ascontiguousarray(arr).tobytes())
            .hexdigest() == want["sha256"])


def format_fixtures(card: str) -> None:
    """Every committed fixture decodes to what imageio and the JAX loader
    gave for it; the 1-bit gray file raises in load_image."""
    from nerf_texture_tpu_torch.data.images import load_image, read_image

    with open(os.path.join(FORMATS_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    raised = []
    for name, entry in sorted(manifest.items()):
        path = os.path.join(FORMATS_DIR, name)
        check(_matches(read_image(path), entry["imread"]),
              f"fixture {name}: read_image differs from imageio's array")
        if "raises" in entry["load"]:
            try:
                load_image(path)
            except ValueError as e:
                raised.append(f"{name} ({e})")
                continue
            check(False, f"fixture {name}: load_image did not raise")
        check(_matches(load_image(path), entry["load"]),
              f"fixture {name}: load_image differs from the JAX loader's")
    check(len(raised) == 1 and raised[0].startswith("gray1.png"),
          f"the fixtures that raised: {raised}")
    kinds = {}
    for n in manifest:
        kind = re.match(r"(palette|gray|adam7|progressive)", n).group(1)
        kinds[kind] = kinds.get(kind, 0) + 1
    print(f"prepare: {len(manifest)} format fixtures ("
          f"{', '.join(f'{k} {v}' for k, v in sorted(kinds.items()))}) "
          f"decode bit for bit to imageio's and the JAX loader's arrays; "
          f"raises as the JAX loader does: {raised[0]} ({card})")


def decode_times(card: str) -> dict:
    """Seconds to decode one 800x800 frame of each kind (median of
    DECODE_REPEATS), each decode checked."""
    from nerf_texture_tpu_torch.data import jpeg
    from nerf_texture_tpu_torch.data.images import read_image
    from nerf_texture_tpu_torch.data.poses import orbit_pose
    from nerf_texture_tpu_torch.data.synthetic import (render_gt_sphere,
                                                       sphere_intrinsics)

    tools = _format_tools()
    os.makedirs(PREPARE_DIR, exist_ok=True)
    with open(os.path.join(FORMATS_DIR, "manifest.json")) as f:
        manifest = json.load(f)["progressive_sphere_800.jpg"]
    # the progressive fixture's frame, made as the fixture script makes it
    rgba = render_gt_sphere(orbit_pose(1.2, 0.7, 2.0),
                            sphere_intrinsics(800, 800), 800, 800)
    f = rgba.astype(np.float32) / 255.0
    rgb = ((f[..., :3] * f[..., 3:] + (1.0 - f[..., 3:])) * 255).astype(
        np.uint8)
    # a palette of 216 colours (6 levels a channel), indices per pixel
    levels = (rgb.astype(np.int64) * 6) // 256
    idx = (levels[..., 0] * 36 + levels[..., 1] * 6 + levels[..., 2])
    lut = np.stack(np.meshgrid(*[np.arange(6) * 51] * 3, indexing="ij"),
                   -1).reshape(216, 3).astype(np.uint8)
    files = {
        "baseline JPEG": (jpeg.encode(rgb, quality=90), None),
        "progressive JPEG": (open(os.path.join(
            FORMATS_DIR, "progressive_sphere_800.jpg"), "rb").read(), None),
        "Adam7 PNG (RGBA)": (tools.png_bytes(rgba, 8, 6, interlace=1,
                                             filters=(0, 1, 2, 3, 4)), rgba),
        "palette PNG": (tools.png_bytes(idx[..., None], 8, 3,
                                        plte=lut.tobytes(),
                                        filters=(0, 1, 2, 3, 4)), lut[idx]),
    }
    times = {}
    for kind, (data, want) in files.items():
        path = os.path.join(PREPARE_DIR, "decode" + (
            ".jpg" if "JPEG" in kind else ".png"))
        with open(path, "wb") as f:
            f.write(data)
        walls = []
        for _ in range(DECODE_REPEATS):
            t0 = time.perf_counter()
            img = read_image(path)
            walls.append(time.perf_counter() - t0)
        check(img.shape[:2] == (800, 800), f"{kind}: shape {img.shape}")
        if want is not None:
            check(np.array_equal(img, want), f"{kind}: not its source")
        else:
            # the progressive file reorders the baseline file's quantised
            # coefficients (PIL's, which the port's encoder writes byte for
            # byte): both decode to the fixture's array
            check(_matches(img, manifest["imread"]), f"{kind}: not the "
                  f"progressive fixture's pixels")
        times[kind] = float(np.median(walls))
        print(f"prepare: decode an 800x800 {kind} ({len(data) / 1024:.1f} "
              f"KiB): {times[kind]:.4f} s (median of {DECODE_REPEATS}; "
              f"{min(walls):.4f}-{max(walls):.4f}) ({card})")
    return times


def _rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """COLMAP's rotation matrix -> (w, x, y, z) (the symmetric 4x4 whose
    largest eigenvector is the quaternion; w >= 0)."""
    rxx, ryx, rzx, rxy, ryy, rzy, rxz, ryz, rzz = R.flat
    K = np.array([
        [rxx - ryy - rzz, 0, 0, 0],
        [ryx + rxy, ryy - rxx - rzz, 0, 0],
        [rzx + rxz, rzy + ryz, rzz - rxx - ryy, 0],
        [ryz - rzy, rzx - rxz, rxy - ryx, rxx + ryy + rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def _box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """A k x k box filter of uint8 [H, W, C] (edges replicated)."""
    r = k // 2
    x = np.pad(img.astype(np.int64), ((r, r), (r, r), (0, 0)), mode="edge")
    c = np.cumsum(np.cumsum(np.pad(x, ((1, 0), (1, 0), (0, 0))), 0), 1)
    s = c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]
    return (s // (k * k)).astype(np.uint8)


def capture_round_trip(card: str):
    """Phase 13's scene as a capture through the port's prepare steps;
    returns the round trip's NeRFDataset (split 'train')."""
    import shutil

    from nerf_texture_tpu_torch.data import prepare
    from nerf_texture_tpu_torch.data.images import read_image, write_png
    from nerf_texture_tpu_torch.data.provider import NeRFDataset

    src = os.path.join(CLI_DIR, "scene")
    root = os.path.join(PREPARE_DIR, "capture")
    shutil.rmtree(root, ignore_errors=True)
    images_dir, text = os.path.join(root, "images"), os.path.join(root,
                                                                  "text")
    os.makedirs(images_dir)
    os.makedirs(text)
    with open(os.path.join(src, "transforms.json")) as f:
        meta = json.load(f)
    # the cameras as COLMAP writes them: PINHOLE, world2cam quaternions
    with open(os.path.join(text, "cameras.txt"), "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                f"1 PINHOLE {meta['w']} {meta['h']} {meta['fl_x']!r} "
                f"{meta['fl_y']!r} {meta['cx']!r} {meta['cy']!r}\n")
    lines = ["# Image list with two lines of data per image:\n"]
    blurred = []
    for k, fr in enumerate(meta["frames"]):
        name = os.path.basename(fr["file_path"])
        shutil.copy(os.path.join(src, fr["file_path"]),
                    os.path.join(images_dir, name))
        # the mirrored world (a proper rotation), then the colmap camera
        # axes (colmap_to_transforms' flips undone)
        c2w = PREPARE_MIRROR_NERF @ np.asarray(fr["transform_matrix"],
                                               np.float64)
        c2w[0:3, 1] *= -1
        c2w[0:3, 2] *= -1
        w2c = np.linalg.inv(c2w)
        q, t = _rotmat2qvec(w2c[:3, :3]), w2c[:3, 3]
        lines.append(f"{k + 1} {' '.join(repr(float(v)) for v in q)} "
                     f"{' '.join(repr(float(v)) for v in t)} 1 {name}\n\n")
        if k % (len(meta["frames"]) // PREPARE_BLURRED) == 0 \
                and len(blurred) < PREPARE_BLURRED:
            blurred.append(f"blurred_{name}")
            write_png(os.path.join(images_dir, blurred[-1]), _box_blur(
                read_image(os.path.join(src, fr["file_path"])),
                PREPARE_BLUR))
    with open(os.path.join(text, "images.txt"), "w") as f:
        f.write("".join(lines))
    frames = sorted(os.listdir(images_dir))
    lap = []
    for name in frames:
        img = read_image(os.path.join(images_dir, name))
        t0 = time.perf_counter()
        prepare.laplacian_variance(img)
        lap.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    removed = prepare.remove_blurry_frames(images_dir, keep_ratio=PREPARE_KEEP)
    remove_s = time.perf_counter() - t0
    gone = sorted(set(frames) - set(os.listdir(images_dir)))
    print(f"prepare: {len(frames)} frames {meta['h']}x{meta['w']} "
          f"({PREPARE_BLURRED} of them {PREPARE_BLUR}x{PREPARE_BLUR} "
          f"box-blurred copies): laplacian_variance {np.median(lap):.4f} s "
          f"a frame (median; {min(lap):.4f}-{max(lap):.4f}); "
          f"remove_blurry_frames(keep_ratio={PREPARE_KEEP}) removed "
          f"{removed} in {remove_s:.2f} s: {gone} ({card})")
    check(gone == sorted(blurred) and removed == len(blurred),
          f"remove_blurry_frames removed {gone}, not the blurred copies "
          f"{sorted(blurred)}")
    t0 = time.perf_counter()
    out = prepare.colmap_to_transforms(text, images_dir,
                                       os.path.join(root, "transforms.json"))
    ds = NeRFDataset(root, mode="colmap", split="train")
    load_s = time.perf_counter() - t0
    ref = NeRFDataset(src, mode="colmap", split="train")
    dp = float(np.abs(ds.poses - PREPARE_MIRROR_NGP @ ref.poses).max())
    check(ds.images.shape == ref.images.shape
          and np.array_equal(ds.images, ref.images),
          "the round trip's images differ from phase 13's")
    check(dp <= PREPARE_POSE_ATOL and np.array_equal(ds.intrinsics,
                                                     ref.intrinsics),
          f"the round trip's poses differ by {dp} (or its intrinsics)")
    print(f"prepare: colmap_to_transforms ({len(out['frames'])} frames) + "
          f"NeRFDataset in {load_s:.2f} s: {ds.num_frames} training frames "
          f"bit for bit as phase 13's, poses within {dp:.3g} of its mirrored "
          f"ones (<= {PREPARE_POSE_ATOL}), intrinsics equal ({card})")
    return ds


def prepare_phase(dev, card: str) -> None:
    """Phase 18: the format fixtures, the decode times, the capture round
    trip on phase 13's scene, and PREPARE_STEPS steps on it."""
    from nerf_texture_tpu_torch.models.ngp import NGPConfig
    from nerf_texture_tpu_torch.render.renderer import RenderConfig
    from nerf_texture_tpu_torch.train.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    format_fixtures(card)
    decode_times(card)
    ds = capture_round_trip(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = Trainer(ds, NGPConfig(**BENCH_NGP), RenderConfig(**BENCH_RENDER),
                 TrainConfig(**BENCH_TRAIN), seed=7, device=dev)
    t0 = time.perf_counter()
    run = tr.train(PREPARE_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = True
    losses = np.asarray(run["losses"])
    print(f"prepare: Trainer on the round trip ({ds.num_frames} frames, "
          f"bench NGP width): loss step 1 {losses[0]:.5f}, step "
          f"{len(losses)} {losses[-1]:.5f}; mean of first/last 10 "
          f"{losses[:10].mean():.5f} / {losses[-10:].mean():.5f}; "
          f"{PREPARE_STEPS / train_s:.2f} it/s ({card})")
    check(len(losses) == PREPARE_STEPS and bool(np.isfinite(losses).all()),
          "non-finite loss on the round-trip scene")
    check(losses[-10:].mean() < losses[:10].mean(),
          "the loss on the round-trip scene did not fall")
    del tr
    torch.cuda.empty_cache()
    print(f"prepare: phase 18 {time.perf_counter() - t_phase:.1f} s "
          f"({card})")


# the foreground masks (phase 20): SEGMENT_FRAMES frames of the synthetic
# sphere at 1920x1080 over a dark background (as tests/test_segmenter.py
# composites them), so that MaskSession's work_scale is exactly 2 and
# every cut is 960x540; the scripted strokes of that test scaled to the
# frame, segment(0), propagate_all(0) and a corrective segment(1), each
# mask held to the alpha at the JAX test's IoU bounds; the max-flow
# kernel against its plain version on segment(0)'s five graphs and on
# one hard graph of the same size (the cut on MAXFLOW_MATCH of the
# pixels, the energy within MAXFLOW_ENERGY_RTOL, two kernel runs bit for
# bit); the scribble UI on 127.0.0.1; and apply_masks on phase 18's
# capture frames, then colmap_to_transforms on the masked images.
# A cut's bound (bound_ms): the graph read once and the cut written once
# (8 capacities and the weight as float64, a byte of result: 73 bytes a
# node) at the H100's 3.35 TB/s.  Its sweep bound (sweep_bound_ms): the
# state a sweep must read and write once (8 residuals, excess and sink
# residual as float64, the height as int32: 2 x 84 bytes a node) times
# the sweeps that ran, plus a read of the residuals and heights and a
# write of the heights (80 bytes a node) per global relabel.
SEGMENT_DIR = os.path.join("build", "segment")
SEGMENT_FRAMES, SEGMENT_H, SEGMENT_W = 8, 1080, 1920
SEGMENT_IOU_KEY, SEGMENT_IOU_PROP = 0.7, 0.6
MAXFLOW_MATCH, MAXFLOW_ENERGY_RTOL = 0.9999, 1e-9
MAXFLOW_IO_BYTES = 8 * 8 + 8 + 1
MAXFLOW_SWEEP_BYTES, MAXFLOW_RELABEL_BYTES = 168, 80
HBM_BYTES_PER_S = 3.35e12
# the hard graph: N-links over a random texture, net weights from a smooth
# field (amplitude 30, period 128 nodes) plus noise (sigma 10), the left
# column hard background; 471 sweeps and 16 global relabels on the CPU
HARD_PERIOD, HARD_AMPLITUDE, HARD_NOISE, HARD_SEED = 128, 30.0, 10.0, 1


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    return float((a & b).sum() / max(1, (a | b).sum()))


def segment_frames(frames: str) -> list:
    """Writes the phase's frames; returns their alpha masks."""
    from nerf_texture_tpu_torch.data.images import write_png
    from nerf_texture_tpu_torch.data.synthetic import SyntheticSphereDataset

    ds = SyntheticSphereDataset(n_frames=SEGMENT_FRAMES, H=SEGMENT_H,
                                W=SEGMENT_W)
    gts = []
    for i in range(SEGMENT_FRAMES):
        img = ds.images[i]
        rgb = img[..., :3].astype(np.float32)
        a = img[..., 3:].astype(np.float32) / 255.0
        write_png(os.path.join(frames, f"{i:04d}.png"),
                  (rgb * a + 24.0 * (1 - a)).astype(np.uint8))
        gts.append(a[..., 0] > 0.5)
    return gts


def maxflow_bound_ms(H: int, W: int) -> float:
    return H * W * MAXFLOW_IO_BYTES / HBM_BYTES_PER_S * 1e3


def maxflow_sweep_bound_ms(H: int, W: int, sweeps: int,
                           relabels: int) -> float:
    return (H * W * (sweeps * MAXFLOW_SWEEP_BYTES
                     + relabels * MAXFLOW_RELABEL_BYTES)
            / HBM_BYTES_PER_S * 1e3)


def hard_graph(H: int, W: int, dev):
    """(cap [8, H, W], weight [H, W]) float64 on dev: a cut over a
    textured background that takes hundreds of sweeps."""
    from nerf_texture_tpu_torch.ops import grabcut as gcm

    rng = np.random.default_rng(HARD_SEED)
    img = torch.from_numpy(rng.integers(0, 256, (H, W, 3)).astype(np.uint8))
    yy, xx = np.mgrid[0:H, 0:W]
    w = (HARD_AMPLITUDE * np.sin(2 * np.pi * xx / HARD_PERIOD)
         * np.sin(2 * np.pi * yy / HARD_PERIOD)
         + rng.normal(0, HARD_NOISE, (H, W)))
    w[:, :1] = -gcm.LAMBDA
    return (gcm.n_weights(img, gcm.calc_beta(img)).to(dev),
            torch.from_numpy(w).to(dev))


def cut_against_plain(cap, weight, label: str, card: str) -> dict:
    """The kernel's cut against its plain version on one graph: the gates,
    and the kernel's device ms (CUDA events around the call, and the sum
    of its kernels' durations under torch.profiler) beside its host
    wall."""
    from nerf_texture_tpu_torch.ops import maxflow

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    got = maxflow.min_cut(cap, weight)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    k_ms = start.elapsed_time(end)
    stats = dict(maxflow.min_cut.last_stats)
    l0 = maxflow.min_cut.cuda_launches
    again = maxflow.min_cut(cap, weight)
    cuda_launches = maxflow.min_cut.cuda_launches - l0
    try:
        # a measurement, not a gate: a profiler that sees no kernel (this
        # runs in a worker beside other processes) leaves it unmeasured
        events = kernel_events(lambda: maxflow.min_cut(cap, weight))
    except RuntimeError as err:
        print(f"segment: cut {label}: torch.profiler failed: {err}")
        events = []
    busy_ms = sum(d for _, d in events) / 1e3 if events else None
    t0 = time.perf_counter()
    ref, ref_stats = maxflow.min_cut_reference(cap, weight)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    e_k = maxflow.cut_energy(cap, weight, got)
    e_p = maxflow.cut_energy(cap, weight, ref)
    H, W = weight.shape
    r = {"graph": label, "ms": k_ms, "busy_ms": busy_ms,
         "wall_ms": wall_ms, "plain_ms": p_ms,
         "match": float((got == ref).float().mean()),
         "energy_err": abs(e_k - e_p), "energy": e_p,
         "bitwise": bool(torch.equal(got, again)),
         "bound_ms": maxflow_bound_ms(H, W),
         "sweep_bound_ms": maxflow_sweep_bound_ms(H, W, stats["sweeps"],
                                                  stats["relabels"]),
         "cuda_launches": cuda_launches, "profiled_kernels": len(events),
         **stats, "plain_sweeps": ref_stats["sweeps"],
         "plain_relabels": ref_stats["relabels"]}
    busy = "not measured" if busy_ms is None else f"{busy_ms:.3f} ms"
    print(f"segment: cut {label} {H}x{W}: kernel {k_ms:.3f} ms on the "
          f"device (CUDA events; kernels busy {busy} in "
          f"{len(events)} kernels, torch.profiler; host wall "
          f"{wall_ms:.3f} ms), {r['sweeps']} sweeps, {r['relabels']} global "
          f"relabels, {cuda_launches} CUDA launches; bound {r['bound_ms']:.4f}"
          f" ms (the graph once), sweep bound {r['sweep_bound_ms']:.3f} ms; "
          f"plain version {p_ms:.2f} ms ({r['plain_sweeps']} sweeps, "
          f"{r['plain_relabels']} relabels); cut equal on {r['match']:.6f} "
          f"of the pixels, energy {e_p:.6f} differs by "
          f"{r['energy_err']:.3g}; two kernel runs "
          f"{'equal' if r['bitwise'] else 'DIFFER'} ({card})")
    check(r["match"] >= MAXFLOW_MATCH and r["bitwise"]
          and r["energy_err"] <= MAXFLOW_ENERGY_RTOL * abs(e_p)
          and stats == ref_stats,
          f"max-flow kernel vs plain on {label}: {r}")
    return r


def segment_ui(session, card: str) -> int:
    """The scribble UI on 127.0.0.1: info, stroke, segment, /frame, save.
    Returns the cuts it launched."""
    import socket

    from nerf_texture_tpu_torch.ops import maxflow
    from nerf_texture_tpu_torch.viewer.segment import serve_segmenter

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    httpd = serve_segmenter(session, host="127.0.0.1", port=port,
                            block=False)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{port}"

    def api(body):
        return json.loads(_http(url + "/api", body)[1])

    try:
        maxflow.min_cut.launches = 0
        t0 = time.perf_counter()
        check(api({"op": "info"})["n"] == SEGMENT_FRAMES,
              "segmenter UI: info")
        H, W = session.H, session.W
        res = api({"op": "stroke", "i": 2, "label": 2,
                                   "points": [[8, 8], [W - 9, 8]]})
        check(res["ok"], f"segmenter UI: stroke {res}")
        res = api({"op": "segment", "i": 2})
        check(res["ok"], f"segmenter UI: segment {res}")
        launches = maxflow.min_cut.launches
        seg_s = time.perf_counter() - t0
        jpg = _http(url + "/frame?i=2")[1]
        check(jpg[:2] == b"\xff\xd8", "segmenter UI: /frame is no JPEG")
        res = api({"op": "save"})
        check(res["ok"] and res["saved"] == SEGMENT_FRAMES,
              f"segmenter UI: save {res}")
        print(f"segment: the UI on 127.0.0.1: info, stroke, segment "
              f"({seg_s:.2f} s, {launches} cuts), /frame ({len(jpg)} bytes "
              f"of JPEG), save ({res['saved']} frames) ({card})")
    finally:
        httpd.shutdown()
        httpd.server_close()
    return launches


def capture_masks(card: str) -> int:
    """apply_masks on phase 18's capture frames, colmap_to_transforms on
    the masked images; returns the cuts it launched."""
    import shutil

    from nerf_texture_tpu_torch.data import prepare
    from nerf_texture_tpu_torch.data.images import read_image
    from nerf_texture_tpu_torch.ops import maxflow

    root = os.path.join(PREPARE_DIR, "capture")
    masked = os.path.join(SEGMENT_DIR, "capture", "images")
    shutil.rmtree(os.path.dirname(masked), ignore_errors=True)
    maxflow.min_cut.launches = 0
    t0 = time.perf_counter()
    prepare.apply_masks(os.path.join(root, "images"), masked)
    torch.cuda.synchronize()
    mask_s = time.perf_counter() - t0
    launches = maxflow.min_cut.launches
    names = sorted(os.listdir(masked))
    ious = []
    for name in names:
        rgba = read_image(os.path.join(masked, name))
        src = read_image(os.path.join(root, "images", name))
        check(rgba.shape[-1] == 4 and np.array_equal(rgba[..., :3],
                                                     src[..., :3]),
              f"apply_masks: {name} is not the frame with an alpha")
        ious.append(_iou(rgba[..., 3] > 127, src[..., 3] > 127))
    out = prepare.colmap_to_transforms(
        os.path.join(root, "text"), masked,
        os.path.join(SEGMENT_DIR, "capture", "transforms.json"))
    check(all(os.path.basename(f["file_path"]) in names
              for f in out["frames"]) and len(out["frames"]) == len(names),
          "colmap_to_transforms on the masked images")
    print(f"segment: apply_masks on phase 18's {len(names)} frames in "
          f"{mask_s:.2f} s ({launches} cuts), alpha IoU with the scene's "
          f"alpha min {min(ious):.4f} median {np.median(ious):.4f}; "
          f"colmap_to_transforms read {len(out['frames'])} masked frames "
          f"({card})")
    check(min(ious) > SEGMENT_IOU_PROP, f"apply_masks IoU {min(ious)}")
    return launches


def segment_phase(dev, card: str) -> dict:
    """Phase 20: the scribble session at 1920x1080 (cuts at 960x540), the
    kernel against its plain version, the UI and apply_masks.  Returns the
    max-flow kernel's entry for the kernels line."""
    import shutil

    from nerf_texture_tpu_torch.data.segmenter import MaskSession
    from nerf_texture_tpu_torch.ops import grabcut as gcm
    from nerf_texture_tpu_torch.ops import maxflow

    t_phase = time.perf_counter()
    root = os.path.join(SEGMENT_DIR, "scene")
    frames = os.path.join(root, "frames")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(frames)
    gts = segment_frames(frames)
    s = MaskSession(frames, device=dev)
    check(s.work_scale == 2.0, f"work_scale {s.work_scale}, not 2")
    ys, xs = np.nonzero(gts[0])
    cy, cx = int(ys.mean()), int(xs.mean())
    H, W = s.H, s.W
    # the JAX test's strokes, scaled from its 96x96 frames
    k = H / 96
    s.add_stroke(0, [[cx - int(10 * k), cy], [cx + int(10 * k), cy]], 1,
                 radius=int(3 * k))
    s.add_stroke(0, [[2, 2], [W - 3, 2]], 2, radius=int(2 * k))
    s.add_stroke(0, [[2, H - 3], [W - 3, H - 3]], 2, radius=int(2 * k))
    calls = []

    def timed(name, fn):
        before = dict(s.timings)
        l0, sw0, r0 = (maxflow.min_cut.launches, maxflow.min_cut.sweeps,
                       maxflow.min_cut.relabels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        calls.append({"call": name, "s": time.perf_counter() - t0,
                      "cuts": maxflow.min_cut.launches - l0,
                      "sweeps": maxflow.min_cut.sweeps - sw0,
                      "relabels": maxflow.min_cut.relabels - r0,
                      **{key: s.timings.get(key, 0.0) - before.get(key, 0.0)
                         for key in ("resize", "flow", "kmeans", "gmm",
                                     "cut")}})
        return out

    graphs = []
    real_cut = gcm.min_cut

    def recording(cap, weight):
        graphs.append((cap.clone(), weight.clone()))
        return real_cut(cap, weight)

    propagate = s.propagate
    s.propagate = lambda a, b: timed(f"propagate({a}, {b})",
                                     lambda: propagate(a, b))
    maxflow.min_cut.launches = 0
    gcm.min_cut = recording
    try:
        timed("segment(0)", lambda: s.segment(0))
    finally:
        gcm.min_cut = real_cut
    s.propagate_all(0)
    s.add_stroke(1, [[2, 2], [int(40 * k), 2]], 2, radius=int(2 * k))
    timed("segment(1)", lambda: s.segment(1))
    launches = maxflow.min_cut.launches
    del s.propagate
    for c in calls:
        print(f"segment: {c['call']}: {c['s']:.3f} s (resize {c['resize']:.3f}"
              f", flow {c['flow']:.3f}, k-means {c['kmeans']:.3f}, "
              f"assign / learn / graph {c['gmm']:.3f}, cut {c['cut']:.3f}); "
              f"{c['cuts']} cuts, "
              f"{c['sweeps']} sweeps, {c['relabels']} global relabels "
              f"({card})")
    ious = [_iou(s.masks[i], gts[i]) for i in range(SEGMENT_FRAMES)]
    print(f"segment: IoU with the alpha: keyframe {ious[0]:.4f}, propagated "
          f"{', '.join(f'{v:.4f}' for v in ious[1:])} (gates > "
          f"{SEGMENT_IOU_KEY}, > {SEGMENT_IOU_PROP}); {launches} cuts "
          f"(max-flow kernel calls) on the session's path ({card})")
    check(ious[0] > SEGMENT_IOU_KEY and min(ious[1:]) > SEGMENT_IOU_PROP,
          f"segmentation IoU {ious}")
    check(launches == sum(c["cuts"] for c in calls) and launches > 0,
          f"{launches} max-flow launches")
    saved = s.save(os.path.join(root, "masks"),
                   composite_dir=os.path.join(root, "images_masked"))
    check(saved == SEGMENT_FRAMES, f"save wrote {saved} frames")

    # -- the kernel against its plain version: segment(0)'s graphs, a hard one
    check(len(graphs) == 5, f"segment(0) ran {len(graphs)} cuts, not 5")
    rows = [cut_against_plain(cap, weight, f"segment(0) {i + 1}", card)
            for i, (cap, weight) in enumerate(graphs)]
    hard = cut_against_plain(*hard_graph(*graphs[0][1].shape, dev), "hard",
                             card)
    ui = segment_ui(s, card)
    capture = capture_masks(card)
    print(f"segment: phase 20 {time.perf_counter() - t_phase:.1f} s "
          f"({card})")
    def med(key):
        vals = [r[key] for r in rows if r[key] is not None]
        return float(np.median(vals)) if vals else None

    keys = ("ms", "busy_ms", "wall_ms", "plain_ms", "bound_ms",
            "sweep_bound_ms", "sweeps", "relabels", "cuda_launches", "match")
    return {"name": "maxflow_grid", "route": "cuda",
            "source": "nerf_texture_tpu_torch/csrc/maxflow.cu",
            "replaces": "cv2.grabCut's GCGraph::maxFlow (host OpenCV, no "
                        "TPU kernel), via nerf_texture_tpu/data/"
                        "segmenter.py:103 and data/prepare.py:76",
            "launches": launches + ui + capture,
            "launches_are": "cuts: calls of the wrapper, each one entry "
                            "point that queues cuda_launches_per_cut "
                            "CUDA launches",
            "launches_by_path": {"mask_session": launches,
                                 "segmenter_ui": ui,
                                 "apply_masks": capture},
            "cuda_launches_per_cut": med("cuda_launches"),
            "max_abs_err": max(r["energy_err"] for r in rows + [hard]),
            "ms": med("ms"), "plain_ms": med("plain_ms"),
            "bound_ms": med("bound_ms"), "bound_by": "bytes",
            "library_ms": None, "busy_ms": med("busy_ms"),
            "wall_ms": med("wall_ms"),
            "sweep_bound_ms": med("sweep_bound_ms"),
            "shape": f"{graphs[0][1].shape[0]}x{graphs[0][1].shape[1]} "
                     f"grid, 8-connected, float64",
            "per_cut": [{key: r[key] for key in keys} for r in rows],
            "hard_cut": {key: hard[key] for key in keys},
            "per_call": calls, "iou": ious}


def scenes_phase(dev, card: str, plain_iters: int,
                 prepare: bool = False) -> dict:
    """Phase 16 but the viewer in the smoke's process: the JPEG scene, the
    bound-2 CLI and the --gui CLI; with ``prepare`` phases 18 and 19 too,
    while --gui waits for phase 13's undistilled checkpoint (529-568 s in
    earlier smokes), so that they add no wall (phase 19's selection
    launches by path under the result's "parallel")."""
    t0 = time.perf_counter()
    os.makedirs(VIEWER_DIR, exist_ok=True)
    jpeg_scene(card)
    # the bound-2 CLI beside --gui, which waits for phase 13's workspace
    b2 = Background(lambda: bound2_cli(dev, card,
                                       os.path.join(CLI_DIR, "scene")))
    par = seg = {}
    if prepare:
        prepare_phase(dev, card)
        t1 = time.perf_counter()
        par = parallel_phase(dev, card)
        print(f"parallel: phase 19 in the viewer worker "
              f"{time.perf_counter() - t1:.1f} s ({card})")
        seg = segment_phase(dev, card)
    gui_cli(card, os.path.join(CLI_DIR, "ws_plain"), plain_iters)
    res = dict(b2.result(), parallel=par, segment=seg)
    print(f"scenes: {time.perf_counter() - t0:.1f} s ({card})")
    return res


def shell_phase(dev, card: str) -> dict:
    """Phase 21: ``scripts/torch_shell_pipeline.py``'s ``run("FULL", 0,
    "cuda")``, every gate of the JAX package's pipeline test and the six
    kernel frames.  Returns the selection launches of its kernel frames
    by path and kind."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    import torch_shell_pipeline as pipe

    t0 = time.perf_counter()
    res = pipe.run("FULL", 0, str(dev))
    wall = time.perf_counter() - t0
    P = pipe.FULL
    print(f"shell: NGP {res['ngp_psnr']:.2f} dB (gate > {P['ngp_gate']}), "
          f"curved {res['curved_psnr']:.2f} dB (gate > "
          f"{P['curved_gate']}) at the held-out pose; mesh "
          f"{res['vertices']} vertices (> 200), median radius "
          f"{res['median_radius']:.4f} (base 0.5 +- 0.1); h "
          f"{res['h']:.4f} (< 0.35); {res['patches']} patches (>= 4), "
          f"std {res['patch_std']:.4f}; the imported canvas: weights_sum "
          f"max {res['field_ws_max']:.3f}, in-silhouette std "
          f"{res['field_std']:.4f} (> 0.005) ({card})")
    print("shell: stage seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in res["seconds"].items()) + f" ({card})")
    check(not res["failed"], f"shell: failed gates {res['failed']}")
    launches = {"cdf": {}, "topk": {}}
    for field, frames in res["kernel_frames"].items():
        for kind, f in frames.items():
            other = "topk" if kind == "cdf" else "cdf"
            print(f"shell: {field} {kind} 400x400: {f['ms']:.1f} ms, live "
                  f"{f['live']}, chunks {f['chunks']}, launches "
                  f"{f['launches'][kind]}, lit {f['lit']:.3f}; kernel frame "
                  f"== plain-selection frame bit for bit: {f['bitwise']} "
                  f"({card})")
            check(f["bitwise"], f"shell {field} {kind}: the kernel frame "
                  f"differs from its plain-selection frame")
            check(f["launches"][kind] == f["chunks"] > 0
                  and f["launches"][other] == 0,
                  f"shell {field} {kind}: launches {f['launches']} for "
                  f"{f['chunks']} chunks")
            check(f["lit"] > 0.0, f"shell {field} {kind}: nothing lit")
            launches[kind][f"shell_{field}"] = f["launches"][kind]
    print(f"shell: phase 21 {wall:.1f} s ({card})")
    return launches


def start_worker(kind: str, nice: int) -> Background:
    """Phase ``kind`` (relight: 15 but its CLIs, then 21; viewer: 16 but
    its in-process viewer) in a process of its own on the same card
    (``chip_smoke.py --worker <kind>``) at host priority ``nice`` (its
    subprocesses inherit it), on a Background thread: its standard output
    goes to chiprun_out/<kind>_worker.log, its errors to
    <kind>_worker.err.  Returns (exit code, output, errors, wall s)."""
    def run():
        os.makedirs("chiprun_out", exist_ok=True)
        out_p = os.path.join("chiprun_out", f"{kind}_worker.log")
        err_p = os.path.join("chiprun_out", f"{kind}_worker.err")
        t0 = time.perf_counter()
        with open(out_p, "w") as out, open(err_p, "w") as err:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 kind], stdout=out, stderr=err, text=True,
                env={**os.environ, "PYTHONUNBUFFERED": "1"},
                preexec_fn=lambda: os.nice(nice))
            CHILDREN.append(proc)
            try:
                code = proc.wait(timeout=1000)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                code = "killed after 1000 s"
        with open(out_p) as out, open(err_p) as err:
            return code, out.read(), err.read(), time.perf_counter() - t0
    return Background(run)


def from_worker(worker: Background, kind: str, start: str) -> dict:
    """A worker's result: fails unless it exited 0; prints its lines here
    and returns the JSON of its last line."""
    t0 = time.perf_counter()
    code, out, err, wall = worker.result()
    check(code == 0, f"the {kind} worker: exit {code}: {out[-2000:]} "
          f"{err[-3000:]}")
    lines = out.splitlines()
    for ln in lines[lines.index(start) + 1:-1]:
        print(ln)
    print(f"{kind}: the worker process ran {wall:.1f} s beside phases "
          f"11-13 and the CLIs; waited {time.perf_counter() - t0:.1f} s "
          f"for it")
    return json.loads(lines[-1])


def scenes_from_worker(worker: Background, ngp_psnr: float,
                       card: str) -> dict:
    """Phase 16's worker: its lines, and the bound-2 eval gated against
    phase 13's NGP CLI of this run.  Returns its launches by path."""
    res = from_worker(worker, "viewer", VIEWER_WORKER_START)["scenes"]
    print(f"scenes: bound-2 CLI PSNR {res['psnr']:.2f} dB against phase "
          f"13's NGP CLI {ngp_psnr:.2f} dB (gate >= the NGP CLI less "
          f"{B2_SLACK} dB) ({card})")
    check(res["psnr"] >= ngp_psnr - B2_SLACK, f"bound-2 PSNR {res['psnr']} "
          f"dB against the NGP CLI's {ngp_psnr} dB")
    return (res["launches"]["bound2_cli_eval"], res["parallel"],
            res["segment"])


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device)


def encode_times(fn_fwd, fn_step) -> tuple:
    """(kernels, device ms) of one forward and of one forward + backward,
    each profiled after two warm-up calls."""
    out = []
    for fn in (fn_fwd, fn_step):
        fn()
        fn()
        out.append(profile_frame(fn))
    return tuple(out)


def train_arm(ds, mcfg, rcfg, tcfg, dev, name: str, card: str,
              steps=(WARM_STEPS, TRAIN_STEPS)):
    """A Trainer of ``mcfg`` on ``ds`` trained ``steps`` (warm-up, timed;
    phase 7's by default) in full f32; prints its losses, it/s, grid and
    peak memory and checks that the loss is finite and falls.  Returns
    (trainer, last metrics)."""
    from nerf_texture_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    trainer = Trainer(ds, mcfg, rcfg, tcfg, seed=7, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = trainer.train(steps[0])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = trainer.train(steps[1])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = True
    losses = np.asarray(warm["losses"] + run["losses"])
    occ = trainer.state.occ
    print(f"background: {name}: loss step 1 {losses[0]:.5f}, step "
          f"{len(losses)} {losses[-1]:.5f}; mean of first/last 50: "
          f"{losses[:50].mean():.5f} / {losses[-50:].mean():.5f}; "
          f"samples/ray {run['mean_samples']:.1f}; {steps[0]} steps in "
          f"{warm_s:.2f} s, {steps[1]} in {train_s:.2f} s = "
          f"{steps[1] / train_s:.2f} it/s; {int(occ.iter_density)} grid "
          f"refreshes, {int(occ.occ.sum())} of {occ.occ.numel()} cells "
          f"occupied; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB ({card})")
    check(bool(np.isfinite(losses).all()), f"background {name}: non-finite "
          f"loss")
    check(losses[-50:].mean() < losses[:50].mean(),
          f"background {name}: the training loss did not fall")
    return trainer, run


def arm_frames(trainer, gts: dict, poses: dict, name: str, card: str,
               plain_view: str) -> tuple:
    """Frames of a trained NGP at ``poses`` ({view: pose}) through both
    selections (CDF cap 4, top-k cap 8): launches == chunks for each
    kernel, the frame of ``plain_view`` against its plain-selection
    frame, PSNR against ``gts`` ({view: [H, W, 3]}).  Returns
    ({view_selection: PSNR}, {selection: launches}, {view_selection:
    frame})."""
    from nerf_texture_tpu_torch.ops.proxy_select import (proxy_select,
                                                         proxy_select_cdf)
    from nerf_texture_tpu_torch.render.renderer import PrepassState
    from nerf_texture_tpu_torch.train.trainer import render_frame
    from nerf_texture_tpu_torch.utils.metrics import psnr as psnr_of

    ds, mcfg, occ = trainer.dataset, trainer.mcfg, trainer.state.occ
    cfgs = {"cdf": trainer.rcfg,
            "topk": dataclasses.replace(trainer.rcfg, infer_cdf=False,
                                        infer_color_cap=8)}
    kernels = {"cdf": proxy_select_cdf, "topk": proxy_select}
    psnrs, launches, outs = {}, {}, {}
    for sel, kernel in kernels.items():
        prepass = PrepassState.build(occ.occ, cfgs[sel], density=occ.density)

        def frame(pose, plain_select=False):
            return render_frame(trainer.state.params, None, pose,
                                ds.intrinsics, ds.H, ds.W, mcfg, cfgs[sel],
                                prepass=prepass, plain_select=plain_select)

        frame(poses[plain_view])                             # warm-up
        torch.cuda.synchronize()
        proxy_select_cdf.launches = proxy_select.launches = 0
        chunks, walls = 0, []
        for view, pose in poses.items():
            t0 = time.perf_counter()
            out = frame(pose)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            img = out["image"]
            check(tuple(img.shape) == (ds.H, ds.W, 3)
                  and bool(torch.isfinite(img).all())
                  and float(img.min()) >= 0.0 and out["live"] > 0,
                  f"background {name} {sel} {view}: shape {img.shape}, "
                  f"live {out['live']}, or non-finite / negative pixels")
            chunks += out["chunks"]
            psnrs[f"{view}_{sel}"] = psnr_of(img, gts[view])
            outs[f"{view}_{sel}"] = out
        launches[sel] = kernel.launches
        check(launches[sel] > 0 and launches[sel] == chunks,
              f"background {name} {sel}: {launches[sel]} kernel launches "
              f"for {chunks} chunks")
        check_twin(f"background {name} {sel}",
                   outs[f"{plain_view}_{sel}"]["image"].cpu().numpy(),
                   frame(poses[plain_view], plain_select=True)["image"]
                   .cpu().numpy(), card)
        print(f"background: {name} {sel} {ds.H}x{ds.W}: "
              f"{', '.join(f'{w:.2f}' for w in walls)} ms/frame "
              f"({', '.join(poses)}); live rays "
              f"{[outs[f'{v}_{sel}']['live'] for v in poses]}; launches "
              f"{launches[sel]} for {chunks} chunks ({card})")
    return psnrs, launches, outs


def background_phase(dev, card: str, ds, packed: dict) -> dict:
    """Phase 17: the per-corner grid (``encoder='hash'``) and the learned
    background sphere, in two arms trained with phase 7's schedule: the
    per-corner NGP on phase 7's scene, its frames through both selections
    gated at phase 8's packed-arm PSNRs (``packed``) less BG_PSNR_SLACK,
    Morton codes and ``packbits`` over its grid and its encode's device
    time beside the packed one's; and the per-corner NGP with the
    background sphere (``bg_radius`` 4) on the same cameras and sphere
    inside a painted room (``RoomScene``), its frames gated at its
    step-0 frames plus BG_GAIN_MIN, the composite relation, its
    background net moved, an importance-sampled frame.  Each kernel frame
    against its plain-selection frame, launches == chunks.  Returns the
    launches of each selection's frames."""
    from nerf_texture_tpu_torch.data.poses import orbit_pose
    from nerf_texture_tpu_torch.data.rays import get_rays
    from nerf_texture_tpu_torch.models import ngp
    from nerf_texture_tpu_torch.ops import (hash_encode_bound, morton3d,
                                            morton3d_invert, occupancy,
                                            polar_from_ray)
    from nerf_texture_tpu_torch.ops.hashgrid_packed import (
        packed_encode_bound)
    from nerf_texture_tpu_torch.render.importance import (
        render_rays_importance)
    from nerf_texture_tpu_torch.render.renderer import (PrepassState,
                                                        RenderConfig,
                                                        render_image)
    from nerf_texture_tpu_torch.train.trainer import (
        TrainConfig, Trainer, ngp_background_image, ngp_color_apply,
        ngp_field_apply, ngp_infer_params, ngp_sigma_apply, param_leaves)
    from nerf_texture_tpu_torch.utils.metrics import psnr as psnr_of

    H, W = ds.H, ds.W
    rcfg = RenderConfig(**BENCH_RENDER)
    tcfg = TrainConfig(**BENCH_TRAIN)
    novel = orbit_pose(np.pi / 2 + 0.2, 0.3, ds.radius)
    poses = {"train": ds.poses[0], "novel": novel}
    launches = {"cdf": 0, "topk": 0}

    # -- the per-corner NGP on phase 7's scene -----------------------------
    mcfg = ngp.NGPConfig(**BG_NGP)
    spec = mcfg.grid_spec
    print(f"background: per-corner NGP {spec.num_levels} levels x "
          f"{spec.level_dim}, {spec.table_size} table rows, on phase 7's "
          f"scene and schedule")
    trainer, run = train_arm(ds, mcfg, rcfg, tcfg, dev, "per-corner", card)
    psnrs, arm_launches, _ = arm_frames(
        trainer, {v: white_gt(ds, p) for v, p in poses.items()}, poses,
        "per-corner", card, "novel")
    for sel in launches:
        launches[sel] += arm_launches[sel]
    for key, value in psnrs.items():
        floor = packed[key] - BG_PSNR_SLACK
        print(f"background: per-corner {key.replace('_', ' view, ')} PSNR "
              f"{value:.2f} dB (packed arm, phase 8: {packed[key]:.2f}; gate "
              f">= {floor:.2f}) ({card})")
        check(value >= floor, f"background per-corner {key} PSNR "
              f"{value:.2f} < {floor:.2f}")

    # Morton codes and packbits over its trained grid
    occ = trainer.state.occ
    G = rcfg.grid_size
    axis = torch.arange(G, device=dev)
    cells = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"),
                        -1).reshape(-1, 3).to(torch.int32)
    codes = morton3d(cells)
    check(torch.equal(morton3d_invert(codes), cells),
          "morton3d_invert(morton3d) is not the identity")
    check(torch.equal(torch.sort(codes.to(torch.int64)).values,
                      torch.arange(G ** 3, device=dev)),
          "the Morton codes are not a permutation of the cells")
    thresh = torch.clamp(occ.mean_density, max=rcfg.density_thresh)
    bitfield = occupancy.packbits(occ.density, thresh)
    bits = ((bitfield[:, None].to(torch.int32)
             >> torch.arange(8, device=dev, dtype=torch.int32)) & 1)
    bits = bits.reshape(-1).to(torch.bool)
    check(torch.equal(bits, occ.density.reshape(-1) > thresh),
          "packbits differs from density > thresh")
    check(torch.equal(bits, occ.occ.to(torch.bool)),
          "packbits differs from the grid's occupancy")
    print(f"background: morton3d / morton3d_invert round-trip all {G}^3 "
          f"cells; packbits of the trained density: {bitfield.numel()} "
          f"bytes, {int(bits.sum())} cells set == occupancy ({card})")

    # the per-corner encode against the packed one at the step's points
    n_pts = int(round(tcfg.num_rays * run["mean_samples"]))
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand((n_pts, 3), generator=g, device=dev) - 0.5
    pspec = ngp.NGPConfig(**BENCH_NGP).packed_spec
    tables = {"hash": trainer.state.params["grid"].detach().clone()
              .requires_grad_(True),
              "packed": pspec.init(g).requires_grad_(True)}
    encoders = {"hash": lambda t: hash_encode_bound(x, t, spec),
                "packed": lambda t: packed_encode_bound(x, t, pspec,
                                                        amp=True)}
    dims = {"hash": spec.output_dim, "packed": pspec.output_dim}
    for name, enc in encoders.items():
        t = tables[name]
        cot = torch.randn((n_pts, dims[name]), generator=g, device=dev)

        def fwd():
            with torch.no_grad():
                enc(t)

        def step():
            enc(t).backward(cot)
            t.grad = None

        (n_f, ms_f), (n_s, ms_s) = encode_times(fwd, step)
        print(f"background: {name} encode of {n_pts} points "
              f"({tcfg.num_rays} rays x {run['mean_samples']:.1f} samples): "
              f"forward {ms_f:.3f} ms in {n_f} kernels, forward + backward "
              f"{ms_s:.3f} ms in {n_s} kernels (device time) ({card})")
    del trainer, tables, occ, bitfield, bits, codes, cells
    torch.cuda.empty_cache()

    # -- with the background sphere, in the painted room --------------------
    mcfg = ngp.NGPConfig(**BG_NGP, bg_radius=BG_RADIUS)
    room = RoomScene(ds)
    gts = {v: room_gt(ds, p, BG_RADIUS) for v, p in poses.items()}
    step0 = Trainer(room, mcfg, rcfg, tcfg, seed=7, device=dev)
    step0.mark_untrained()
    psnr0 = {v: psnr_of(step0.render_frame(p, use_ema=False)["image"],
                        gts[v]) for v, p in poses.items()}
    bg0 = [t.detach().clone()
           for t in param_leaves(step0.state.params["bg_net"])]
    del step0
    print(f"background: the per-corner NGP with the background sphere (r "
          f"{mcfg.bg_radius}, 2D grid of {mcfg.bg_grid_spec.table_size} "
          f"rows) on phase 7's cameras and sphere in a room painted at the "
          f"sphere's radius; step-0 CDF frames {psnr0['train']:.2f} / "
          f"{psnr0['novel']:.2f} dB (training / novel view)")
    trainer, run = train_arm(room, mcfg, rcfg, tcfg, dev, "sphere", card,
                             steps=BG_SPHERE_STEPS)
    params = trainer.state.params
    moved = max(float((a.detach() - b).abs().max())
                for a, b in zip(param_leaves(params["bg_net"]), bg0))
    check(moved > 0.0, "background: the bg_net weights did not move")
    psnrs, arm_launches, outs = arm_frames(trainer, gts, poses, "sphere",
                                           card, "novel")
    for sel in launches:
        launches[sel] += arm_launches[sel]
    for key, value in psnrs.items():
        view = key.split("_")[0]
        floor = psnr0[view] + BG_GAIN_MIN
        gated = view == "train"
        print(f"background: sphere {key.replace('_', ' view, ')} PSNR "
              f"{value:.2f} dB (step 0: {psnr0[view]:.2f}; "
              + (f"gate >= {floor:.2f}" if gated else "not gated")
              + f"); bg_net moved by up to {moved:.3g} ({card})")
        check(not gated or value >= floor, f"background sphere {key} PSNR "
              f"{value:.2f} < {floor:.2f}")

    # the composite relation on the novel CDF frame
    out = outs["novel_cdf"]
    occ = trainer.state.occ
    rays = get_rays(torch.as_tensor(novel, dtype=torch.float32, device=dev),
                    torch.as_tensor(ds.intrinsics, device=dev), H, W)
    paint = room_colour(polar_from_ray(rays["rays_o"], rays["rays_d"],
                                       BG_RADIUS).cpu().numpy())
    with torch.no_grad():
        fg = render_image(ngp_field_apply, mcfg,
                          ngp_infer_params(params, mcfg),
                          PrepassState.build(occ.occ, rcfg,
                                             density=occ.density),
                          novel, ds.intrinsics, H, W, rcfg, bg_color=0.0,
                          sigma_apply=ngp_sigma_apply,
                          color_apply=ngp_color_apply)
        bg_img = ngp_background_image(params, novel, ds.intrinsics, H=H,
                                      W=W, mcfg=mcfg).reshape(H, W, 3)
    wsum = out["weights_sum"][..., None]
    comp = float((out["image"] - (fg["image"] + (1.0 - wsum) * bg_img))
                 .abs().max())
    print(f"background: novel CDF frame vs image(bg=0) + (1 - weights_sum) "
          f"* bg: max abs {comp:.3g}; mean weights_sum "
          f"{float(wsum.mean()):.3f}; the learned background image "
          f"against the room's paint: PSNR "
          f"{psnr_of(bg_img.reshape(-1, 3), paint):.2f} dB ({card})")
    check(torch.equal(fg["weights_sum"], out["weights_sum"]),
          "background: the bg=0 frame composites other weights")
    check(comp <= BG_COMPOSITE_ATOL, f"background composite: {comp}")

    # one importance-sampled frame of the trained field
    bg_flat = bg_img.reshape(-1, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        parts = []
        for s in range(0, H * W, IMPORTANCE_CHUNK):
            e = s + IMPORTANCE_CHUNK
            parts.append(render_rays_importance(
                lambda x: ngp.density(params, x, mcfg)[0],
                lambda x, d: ngp.forward(params, x, d, mcfg),
                rays["rays_o"][s:e], rays["rays_d"][s:e], bound=rcfg.bound,
                min_near=rcfg.min_near, density_scale=rcfg.density_scale,
                bg_color=bg_flat[s:e])["image"])
        img = torch.cat(parts).reshape(H, W, 3)
    torch.cuda.synchronize()
    imp_s = time.perf_counter() - t0
    check(bool(torch.isfinite(img).all()), "importance frame: non-finite")
    print(f"background: importance frame {H}x{W} (128 + 128 samples a ray, "
          f"{-(-H * W // IMPORTANCE_CHUNK)} chunks of {IMPORTANCE_CHUNK} "
          f"rays): {imp_s:.2f} s, novel-view PSNR "
          f"{psnr_of(img, gts['novel']):.2f} dB beside the CDF frame's "
          f"{psnrs['novel_cdf']:.2f} ({card})")
    del trainer, params, outs, fg, out
    torch.cuda.empty_cache()
    return launches


def ngp_train_render(dev, card: str, mcfg, rcfg, lap, seed: int = 7):
    """Phases 7 and 8: the NGP trained at full width on
    SyntheticSphereDataset(8 frames, 800x800) from a trainer seeded
    ``seed``, and the trained field through both selections;
    ``lap(name)`` closes each phase's wall.
    Returns (the dataset, the kernel launches of each selection's frames,
    the PSNRs of its training and novel views)."""
    from nerf_texture_tpu_torch.data.poses import orbit_pose
    from nerf_texture_tpu_torch.data.synthetic import SyntheticSphereDataset
    from nerf_texture_tpu_torch.ops.proxy_select import (proxy_select,
                                                         proxy_select_cdf)
    from nerf_texture_tpu_torch.render.renderer import PrepassState
    from nerf_texture_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                      ngp_infer_params,
                                                      render_frame)
    from nerf_texture_tpu_torch.utils.metrics import psnr as psnr_of

    # -- 7. training at full width -------------------------------------------
    # Training multiplies f32 gradients, which TF32 would round: full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    ds = SyntheticSphereDataset(n_frames=8, H=800, W=800)
    H, W = ds.H, ds.W
    tcfg = TrainConfig(**BENCH_TRAIN)
    trainer = Trainer(ds, mcfg, rcfg, tcfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    print(f"train: dataset + init {time.perf_counter() - t0:.2f} s; "
          f"{ds.num_frames} frames {H}x{W}, {tcfg.num_rays} rays/step, pool "
          f"{rcfg.pool_mean_samples}/ray")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = trainer.train(WARM_STEPS)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = trainer.train(TRAIN_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = np.asarray(warm["losses"] + run["losses"])
    refreshes = int(trainer.state.occ.iter_density)
    occupied = int(trainer.state.occ.occ.sum())
    its = TRAIN_STEPS / train_s
    print(f"train: loss step 1 {losses[0]:.5f}, step {WARM_STEPS} "
          f"{losses[WARM_STEPS - 1]:.5f}, step {len(losses)} "
          f"{losses[-1]:.5f}; mean of first/last 50: "
          f"{losses[:50].mean():.5f} / {losses[-50:].mean():.5f}; "
          f"samples/ray {run['mean_samples']:.1f}")
    print(f"train: {WARM_STEPS} steps in {warm_s:.2f} s, {TRAIN_STEPS} steps "
          f"in {train_s:.2f} s = {its:.2f} it/s; {refreshes} grid "
          f"refreshes, {occupied} of {rcfg.grid_size ** 3} cells occupied; "
          f"peak memory {train_peak_mb:.1f} MiB ({card})")
    check(bool(np.isfinite(losses).all()), "non-finite training loss")
    check(losses[-50:].mean() < losses[:50].mean(),
          "the training loss did not fall")
    check(occupied > 0, "the occupancy grid is empty after training")
    torch.backends.cuda.matmul.allow_tf32 = True

    lap("7")

    # -- 8. the trained field through both selections ------------------------
    rcfg_topk = dataclasses.replace(rcfg, infer_cdf=False, infer_color_cap=8)
    prepass_topk = PrepassState.build(trainer.state.occ.occ, rcfg_topk,
                                      density=trainer.state.occ.density)
    params_t = ngp_infer_params(trainer.state.params, mcfg)

    def topk_frame(pose, plain_select=False):
        return render_frame(params_t, None, pose, ds.intrinsics, H, W, mcfg,
                            rcfg_topk, prepass=prepass_topk,
                            plain_select=plain_select)

    novel = [orbit_pose(np.pi / 2 + 0.2, 0.3 + 0.1 * i, ds.radius)
             for i in range(4)]
    topk_frame(novel[0])                               # warm-up
    trainer.render_frame(novel[0], use_ema=False)
    torch.cuda.synchronize()
    proxy_select_cdf.launches = 0
    psnr_train = trainer.eval_psnr([0], use_ema=False)
    check(proxy_select_cdf.launches > 0,
          "eval_psnr never launched proxy_select_cdf")
    proxy_select_cdf.launches = 0
    proxy_select.launches = 0
    out = topk_frame(ds.poses[0])
    psnr_train_topk = psnr_of(out["image"], white_gt(ds, ds.poses[0]))
    chunks = {"cdf": 0, "topk": out["chunks"]}
    walls = {"cdf": [], "topk": []}
    outs = {}
    for name in ("cdf", "topk"):
        for pose in novel:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = (trainer.render_frame(pose, use_ema=False) if name == "cdf"
                   else topk_frame(pose))
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
            chunks[name] += out["chunks"]
            outs.setdefault(name, out)
    launches = {"cdf": proxy_select_cdf.launches,
                "topk": proxy_select.launches}
    gt_novel = white_gt(ds, novel[0])
    psnr_novel = {k: psnr_of(outs[k]["image"], gt_novel) for k in outs}
    for name in ("cdf", "topk"):
        img = outs[name]["image"]
        check(bool(torch.isfinite(img).all()), f"{name}: non-finite pixels")
        check(launches[name] > 0, f"{name}: its kernel was never launched")
        check(launches[name] == chunks[name],
              f"{name}: {launches[name]} kernel launches for "
              f"{chunks[name]} chunks")
    img_k = outs["topk"]["image"].cpu().numpy()
    img_p = topk_frame(novel[0], plain_select=True)["image"].cpu().numpy()
    check_twin("render: top-k", img_k, img_p, card)
    print(f"render: trained field, inverse CDF cap 4: training view "
          f"{psnr_train:.2f} dB (JAX package {JAX_TRAIN_PSNR}, gap "
          f"{psnr_train - JAX_TRAIN_PSNR:+.2f}), novel view "
          f"{psnr_novel['cdf']:.2f} dB (JAX package {JAX_NOVEL_PSNR}, gap "
          f"{psnr_novel['cdf'] - JAX_NOVEL_PSNR:+.2f})")
    print(f"render: trained field, top-k cap 8: training view "
          f"{psnr_train_topk:.2f} dB, novel view {psnr_novel['topk']:.2f} dB")
    for name in ("cdf", "topk"):
        print(f"render: {name} {H}x{W}: "
              f"{', '.join(f'{w:.2f}' for w in walls[name])} ms/frame "
              f"(median {float(np.median(walls[name])):.2f}) over "
              f"{len(novel)} novel poses; live rays {outs[name]['live']}, "
              f"chunks/frame {outs[name]['chunks']}; launches "
              f"{launches[name]} for {chunks[name]} chunks ({card})")
    check(psnr_train >= TRAIN_PSNR_MIN, f"training-view PSNR {psnr_train} "
          f"< {TRAIN_PSNR_MIN}")
    check(psnr_novel["cdf"] >= NOVEL_PSNR_MIN, f"novel-view PSNR "
          f"{psnr_novel['cdf']} < {NOVEL_PSNR_MIN}")
    # deferred shading of the trained field through both selections
    prepass = PrepassState.build(trainer.state.occ.occ, rcfg,
                                 density=trainer.state.occ.density)
    for name, rc, pp, kernel in (("cdf", rcfg, prepass, proxy_select_cdf),
                                 ("topk", rcfg_topk, prepass_topk,
                                  proxy_select)):
        launches[name + "_deferred"] = deferred_frames(
            f"NGP trained {name} cap {rc.infer_color_cap} {H}x{W}",
            lambda pose, deferred, plain, rc=rc, pp=pp: render_frame(
                params_t, None, pose, ds.intrinsics, H, W, mcfg,
                dataclasses.replace(rc, deferred=deferred), prepass=pp,
                plain_select=plain),
            novel[:3], gt_novel, kernel, card)
    del prepass
    ngp_mesh(trainer, mcfg, dev, card)

    del trainer, params_t, prepass_topk, outs
    torch.cuda.empty_cache()

    lap("8")
    return ds, launches, {"train_cdf": psnr_train,
                         "novel_cdf": psnr_novel["cdf"],
                         "train_topk": psnr_train_topk,
                         "novel_topk": psnr_novel["topk"]}


# -- phase 19: multi-rank training and band-sharded frames ------------------
# Ranks are processes started with torchrun's environment (MASTER_ADDR,
# MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE) that call
# parallel.initialize_multihost.  On one card the ranks share cuda:0 over
# gloo (NCCL refuses two ranks on one card): the numbers of such a run are
# gloo traffic through the host, not a multi-GPU speed.  PAR_TIMEOUT
# bounds a rank group and each collective.
PAR_NGP_STEPS, PAR_CURVED_STEPS = 50, 32
PAR_TIMEOUT = 600.0
PAR_DIR = os.path.join("build", "parallel")
PAR_RANK_START = "parallel rank: start"


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


# card memory a rank group needs free before it starts, GiB: its ranks'
# peaks alone on an H100 (6.3 + 7.0, 5.8 + 3 x 4.2, 7.0) and a
# margin for the caching allocators; the smoke's other processes share
# the card, so a group waits up to PAR_MEMORY_WAIT s for the room
PAR_MEMORY_GIB = {"dp": 18.0, "tp4": 24.0, "nccl1": 9.0}
PAR_MEMORY_WAIT = 300.0
# the ranks' host priority (the viewer worker runs at 0)
PAR_NICE = 15


def _wait_for_memory(job: str, card: str):
    """Wait (up to PAR_MEMORY_WAIT s) until the card has the room the
    group needs; prints the free memory found and the wait."""
    need = PAR_MEMORY_GIB[job] * 2 ** 30
    t0 = time.perf_counter()
    free = torch.cuda.mem_get_info()[0]
    while free < need and time.perf_counter() - t0 < PAR_MEMORY_WAIT:
        time.sleep(2.0)
        free = torch.cuda.mem_get_info()[0]
    print(f"parallel: {job}: {free / 2 ** 30:.1f} GiB free on the card "
          f"after {time.perf_counter() - t0:.1f} s (wants "
          f"{PAR_MEMORY_GIB[job]:.0f}) ({card})")


def rank_group(job: str, world: int, backend: str,
               card: str = "") -> list[dict]:
    """``chip_smoke.py --rank <job>`` on ``world`` ranks with torchrun's
    environment and ``backend``, once the card has room for them; their
    outputs in build/parallel/<job>_<world>_<rank>.log.  Fails
    unless every rank exits 0 within PAR_TIMEOUT (ranks still running
    then are killed).  Returns each rank's result, in rank order."""
    os.makedirs(PAR_DIR, exist_ok=True)
    _wait_for_memory(job, card)
    port, procs, logs = _free_port(), [], []
    tag = f"{job}_{world}"
    for r in range(world):
        env = {**os.environ, "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port), "WORLD_SIZE": str(world),
               "RANK": str(r), "LOCAL_RANK": str(r),
               "LOCAL_WORLD_SIZE": str(world), "SMOKE_BACKEND": backend,
               "PYTHONUNBUFFERED": "1",
               "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
        logs.append(os.path.join(PAR_DIR, f"{tag}_{r}.log"))
        # below the main process's host work (the smoke's wall), which
        # the ranks' gloo traffic through the host would otherwise slow
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", job],
                stdout=log, stderr=subprocess.STDOUT, env=env,
                preexec_fn=lambda: os.nice(PAR_NICE)))
        CHILDREN.append(procs[-1])
    end = time.monotonic() + PAR_TIMEOUT
    for p in procs:
        try:
            p.wait(max(1.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    hung = [r for r, p in enumerate(procs) if p.poll() is None]
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    tails = "\n".join(f"--- rank {r}:\n" + open(lg).read()[-3000:]
                      for r, lg in enumerate(logs))
    check(not hung, f"parallel {tag}: ranks {hung} still running after "
          f"{PAR_TIMEOUT} s (killed)\n{tails}")
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    check(not bad, f"parallel {tag}: ranks {bad} failed\n{tails}")
    for r, lg in enumerate(logs):
        lines = open(lg).read().splitlines()
        for ln in lines[lines.index(PAR_RANK_START) + 1:]:
            if ln.startswith("parallel"):
                print(ln)
    return [json.load(open(os.path.join(PAR_DIR, f"{tag}_{r}.json")))
            for r in range(world)]


def _ngp_rays(tr, batch):
    """The rays and targets of an NGP batch (``train_loss``'s)."""
    from nerf_texture_tpu_torch.data.rays import get_rays

    H, W = tr.H, tr.W
    rays = get_rays(tr.poses[batch.frame], tr.intrinsics, H, W, batch.inds)
    px = tr.images[batch.frame].reshape(H * W, -1)[batch.inds].to(
        torch.float32) / 255.0
    if px.shape[-1] == 4:
        return rays, px[:, :3] * px[:, 3:] + batch.bg * (1 - px[:, 3:]), \
            batch.bg
    return rays, px[:, :3], torch.ones((3,), device=px.device)


def ngp_loop(tr, steps: int, mesh=None) -> tuple:
    """``Trainer.train``'s schedule (grid refreshes, draws) for ``steps``
    steps: ``train_step`` without ``mesh``, else ``dp_train_step`` with the
    grid broadcast after each refresh.  Returns (losses, ms a step)."""
    from nerf_texture_tpu_torch.ops import occupancy as occ_mod
    from nerf_texture_tpu_torch.parallel import dp_train_step
    from nerf_texture_tpu_torch.parallel.train import sync_grid
    from nerf_texture_tpu_torch.train.trainer import (grid_step, sample_batch,
                                                      train_step)

    tcfg, rcfg = tr.tcfg, tr.rcfg
    if not tr._marked:
        tr.mark_untrained()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(tr.state.step, tr.state.step + steps):
        if step % tcfg.grid_update_interval == 0:
            full = step // tcfg.grid_update_interval < tcfg.grid_full_updates
            draws = occ_mod.grid_draws(tr.generator, grid_size=rcfg.grid_size,
                                       cascades=rcfg.cascades,
                                       bound=rcfg.bound, full=full)
            grid_step(tr.state, draws, mcfg=tr.mcfg, rcfg=rcfg, full=full,
                      decay=tcfg.grid_decay)
            if mesh is not None:
                sync_grid(tr.state, mesh)
        batch = sample_batch(tr.generator, num_frames=tr.dataset.num_frames,
                             H=tr.H, W=tr.W, tcfg=tcfg)
        if mesh is None:
            losses.append(train_step(
                tr.state, batch, tr.poses, tr.images, tr.intrinsics,
                mcfg=tr.mcfg, rcfg=rcfg, tcfg=tcfg, H=tr.H, W=tr.W)["loss"])
        else:
            rays, gt, bg = _ngp_rays(tr, batch)
            losses.append(dp_train_step(
                tr.state, rays["rays_o"], rays["rays_d"], gt, bg, batch.u,
                mcfg=tr.mcfg, rcfg=rcfg, tcfg=tcfg, mesh=mesh))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return torch.stack(losses).tolist(), ms


def curved_loop(tr, steps: int, mesh=None) -> tuple:
    """``CurvedTrainer.train``'s schedule (a refresh every
    ``grid_update_interval`` steps, broadcast under ``mesh``; each step's
    draws) for ``steps`` steps of ``curved_train_step(mesh=)``.  Returns
    (losses, ms a step)."""
    from nerf_texture_tpu_torch.parallel.train import sync_grid
    from nerf_texture_tpu_torch.train.curved_trainer import (
        curved_train_step, sample_curved_batch)

    fcfg, tcfg = tr.ccfg.field, tr.tcfg
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        if tr.state.step % tcfg.grid_update_interval == 0:
            tr._refresh()
            if mesh is not None:
                sync_grid(tr.state, mesh)
        level = (int(torch.randint(0, fcfg.num_levels, (),
                                   generator=tr.generator,
                                   device=tr.device))
                 if fcfg.clustering else None)
        batch = sample_curved_batch(
            tr.generator, num_frames=tr.dataset.num_frames, H=tr.H, W=tr.W,
            tcfg=tcfg, rcfg=tr.rcfg, fcfg=fcfg, level=level)
        losses.append(curved_train_step(
            tr.state, batch, tr.field_state, tr.poses, tr.images,
            tr.intrinsics, ccfg=tr.ccfg, rcfg=tr.rcfg, tcfg=tcfg, H=tr.H,
            W=tr.W, mode=tr.mode, rt=tr.runtime,
            anchor_tab=tr._refresh_anchor_tab(), mesh=mesh)["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return torch.stack(losses).tolist(), ms


def _par_trainers(dev, ds):
    """The phase-7 NGP trainer and a phase-10 curved trainer maker (seed
    7), the curved one sharing one template's host set-up."""
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector
    from nerf_texture_tpu_torch.models import mesh_field, ngp
    from nerf_texture_tpu_torch.models.curved_field import CurvedFieldConfig
    from nerf_texture_tpu_torch.models.mesh_field import MeshFieldConfig
    from nerf_texture_tpu_torch.render.renderer import RenderConfig
    from nerf_texture_tpu_torch.train.curved_trainer import (
        CurvedTrainConfig, CurvedTrainer)
    from nerf_texture_tpu_torch.train.trainer import TrainConfig, Trainer

    def ngp_tr():
        return Trainer(ds, ngp.NGPConfig(**BENCH_NGP),
                       RenderConfig(**BENCH_RENDER),
                       TrainConfig(**BENCH_TRAIN), seed=7, device=dev)

    fstate = mesh_field.make_state(MeshProjector(
        make_icosphere(4, radius=0.5), device=dev))
    shared = {}

    def curved_tr():
        tr = CurvedTrainer(ds, fstate, CurvedFieldConfig(
            field=MeshFieldConfig(), light_model="SH"),
            RenderConfig(**CURVED_RENDER),
            CurvedTrainConfig(**CURVED_TRAIN), seed=7, device=dev)
        if shared:
            tr._near_cells, tr._anchor_tab = shared["near"], shared["tab"]
        tr._get_near_cells()
        tr._anchor_table()
        shared.update(near=tr._near_cells, tab=tr._anchor_tab)
        tr.initialize_states(1)
        return tr

    return ngp_tr, curved_tr


def _par_barrier(mesh):
    mesh.all_reduce(torch.zeros(1, device=mesh.device), "world")


def _state_sums(state, mesh) -> torch.Tensor:
    """One f64 checksum a whole leaf (its bits read as int32) of the
    params, Adam moments, EMA and grid: reduced by MAX and MIN over the
    ranks, equal sums say every rank holds the same bits."""
    from nerf_texture_tpu_torch.parallel.train import gathered_leaf
    from nerf_texture_tpu_torch.train.trainer import param_leaves

    sums = []

    def bits(t):
        t = t.detach().contiguous()
        if t.dtype in (torch.float32, torch.int32):
            t = t.view(torch.int32)
        return torch.sum(t.to(torch.float64) * torch.arange(
            1, t.numel() + 1, device=t.device, dtype=torch.float64).reshape(
                t.shape))

    for p, e in zip(param_leaves(state.params),
                    param_leaves(state.ema_params)):
        st = state.optimizer.state[p]
        for x in (p, e, st["exp_avg"], st["exp_avg_sq"]):
            sums.append(bits(gathered_leaf(p, x)))
    for t in state.occ:
        sums.append(bits(t))
    if getattr(state, "error_map", None) is not None:
        sums.append(bits(state.error_map))
    return torch.stack(sums)


def _ranks_equal(state, mesh) -> bool:
    s = _state_sums(state, mesh)
    hi, lo = s.clone(), s.clone()
    mesh.all_reduce(hi, "world", op=torch.distributed.ReduceOp.MAX)
    mesh.all_reduce(lo, "world", op=torch.distributed.ReduceOp.MIN)
    return bool(torch.equal(hi, lo))


def _single_mesh(dev):
    """A one-rank mesh inside a process group (no collectives)."""
    from nerf_texture_tpu_torch.parallel.sharding import Mesh
    return Mesh(ranks=np.zeros((1, 1), np.int64), data_index=0,
                model_index=0, device=dev)


def _frame_diff(a, b, wa, wb) -> tuple:
    return (psnr(a, b), float(np.abs(a - b).max()),
            float(np.mean((wa > 0) != (wb > 0))))


def par_band_frames(name, render, single, mesh, tag: str) -> dict:
    """One frame through ``render(plain_select)`` (render_image_sharded)
    with the selection kernels' launch counts from 0 just before it: the
    band's kernel frame bit for bit with its plain-selection frame, and
    (rank 0) the frame within the FRAME_* bounds of ``single()``, the
    single-rank frame.  Returns launches and ms."""
    from nerf_texture_tpu_torch.ops.proxy_select import (proxy_select,
                                                         proxy_select_cdf)

    render(False)                                  # warm-up
    torch.cuda.synchronize()
    proxy_select_cdf.launches = proxy_select.launches = 0
    t0 = time.perf_counter()
    out = render(False)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {"cdf": proxy_select_cdf.launches, "topk": proxy_select.launches}
    plain = render(True)
    same = bool(torch.equal(out["image"], plain["image"]))
    res = {"ms": ms, "launches": launches, "bitwise": same,
           "chunks": out["chunks"], "live": out["live"]}
    check(same, f"{tag} {name}: the band's kernel frame differs from its "
          f"plain-selection frame")
    if mesh.data_index == 0 and mesh.model_index == 0 and single is not None:
        ref = single()
        res["vs_single"] = _frame_diff(
            out["image"].cpu().numpy(), ref["image"].cpu().numpy(),
            out["weights_sum"].cpu().numpy(), ref["weights_sum"].cpu().numpy())
    return res


def par_dp(dev, rank: int, world: int) -> dict:
    """Data parallel over ``world`` ranks: the NGP (50 steps) and the
    curved model (32 steps, 2 refreshes) in lockstep with rank 0's
    single-rank runs, band frames of both trained states at data
    ``world``, the NGP's chunk fallback at 2 cascades; on 2 ranks also one
    NGP and one curved step at model 2.  Saves the trained states for the
    4-rank job (rank 0)."""
    from nerf_texture_tpu_torch.data.synthetic import SyntheticSphereDataset
    from nerf_texture_tpu_torch.parallel import make_mesh, shard_state
    from nerf_texture_tpu_torch.parallel.train import shard_curved_state

    torch.backends.cuda.matmul.allow_tf32 = False
    ds = SyntheticSphereDataset(n_frames=8, H=800, W=800)
    ngp_tr, curved_tr = _par_trainers(dev, ds)
    mesh = make_mesh(world, 1, device=dev)
    res = {"rank": rank, "world": world, "ref": {}}
    # the single-rank runs: the NGP's on rank 0, the curved one's on rank
    # 1, side by side
    for name, make, loop, steps in (
            ("ngp", ngp_tr, ngp_loop, PAR_NGP_STEPS),
            ("curved", curved_tr, curved_loop, PAR_CURVED_STEPS)):
        if rank == (0 if name == "ngp" else 1):
            tr = make()
            res["ref"][name], res["ref"][name + "_ms"] = loop(tr, steps)
            res["ref"][name + "_psnr"] = tr.eval_psnr([0], use_ema=False)
            del tr
            torch.cuda.empty_cache()
    _par_barrier(mesh)
    # -- NGP, data parallel
    tr = ngp_tr()
    tr.mark_untrained()
    tr.state = shard_state(tr.state, mesh)
    losses, ms = ngp_loop(tr, PAR_NGP_STEPS, mesh)
    res["ngp"] = {"losses": losses, "ms": ms,
                  "equal": _ranks_equal(tr.state, mesh)}
    if rank == 0:
        res["ngp"]["psnr"] = tr.eval_psnr([0], use_ema=False)
        torch.save({"params": tr.state.params, "occ": tr.state.occ},
                   os.path.join(PAR_DIR, "ngp_state.pt"))
    res["frames"] = par_ngp_frames(tr, mesh, dev)
    del tr
    # -- curved, data parallel
    ctr = curved_tr()
    ctr.state, ctr.field_state = shard_curved_state(ctr.state,
                                                    ctr.field_state, mesh)
    losses, ms = curved_loop(ctr, PAR_CURVED_STEPS, mesh)
    res["curved"] = {"losses": losses, "ms": ms,
                     "equal": _ranks_equal(ctr.state, mesh)}
    if rank == 0:
        res["curved"]["psnr"] = ctr.eval_psnr([0], use_ema=False)
        torch.save({"params": ctr.state.params, "occ": ctr.state.occ},
                   os.path.join(PAR_DIR, "curved_state.pt"))
    res["frames"].update(par_curved_frames(ctr, mesh))
    del ctr
    torch.cuda.empty_cache()
    if world == 2:
        res["tp"] = par_tp_steps(dev, ds, ngp_tr, curved_tr, 1, 2)
    return res


def _par_pose():
    from nerf_texture_tpu_torch.data.poses import orbit_pose
    return orbit_pose(1.25, 2 * np.pi * 0.5 / 8, 2.0)


def par_ngp_frames(tr, mesh, dev) -> dict:
    """Band frames of an NGP state at data ``mesh``: the bench selection
    (CDF, cap 4) and top-k (cap 8); the chunk fallback at 2 cascades."""
    from nerf_texture_tpu_torch.parallel.eval import render_image_sharded
    from nerf_texture_tpu_torch.train.trainer import (ngp_deferred_s1,
                                                      ngp_deferred_s2,
                                                      ngp_field_apply,
                                                      ngp_infer_params,
                                                      render_frame)

    pose, intr = _par_pose(), tr.dataset.intrinsics
    H, W = tr.H, tr.W
    iparams = ngp_infer_params(tr.state.params, tr.mcfg)
    occ = tr.state.occ
    out = {}
    torch.backends.cuda.matmul.allow_tf32 = True
    frames = [("ngp_cdf", tr.rcfg, None),
              ("ngp_topk", dataclasses.replace(
                  tr.rcfg, infer_cdf=False, infer_color_cap=8), None)]
    if mesh.shape["data"] == 2:
        # deferred shading in the bands
        frames.append(("ngp_cdf_deferred", dataclasses.replace(
            tr.rcfg, deferred=True), (ngp_deferred_s1, ngp_deferred_s2)))
    for name, rc, deferred in frames:
        out[name] = par_band_frames(
            name, lambda plain, rc=rc, deferred=deferred:
            render_image_sharded(
                ngp_field_apply, tr.mcfg, iparams, occ.occ, pose, intr, H, W,
                rc, mesh, density=occ.density, deferred_apply=deferred,
                plain_select=plain),
            lambda rc=rc: render_frame(iparams, occ, pose, intr, H, W,
                                       tr.mcfg, rc),
            mesh, "parallel")
        if deferred is not None and mesh.data_index == 0 \
                and mesh.model_index == 0:
            out[name]["atol"] = DEFERRED_BAND_ATOL
            half = render_frame(iparams, occ, pose, intr, H, W, tr.mcfg,
                                dataclasses.replace(
                                    rc, ray_chunk=rc.ray_chunk // 2))
            out[name]["chunk_floor"] = float((
                half["image"] - render_frame(
                    iparams, occ, pose, intr, H, W, tr.mcfg, rc)[
                        "image"]).abs().max())
    # the chunk fallback: the same grid as 2 cascades (the outer one empty)
    rc2 = dataclasses.replace(tr.rcfg, cascades=2)
    occ2 = torch.cat([occ.occ, torch.zeros_like(occ.occ)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fb = render_image_sharded(ngp_field_apply, tr.mcfg, iparams, occ2, pose,
                              intr, H, W, rc2, mesh)
    torch.cuda.synchronize()
    res = {"ms": (time.perf_counter() - t0) * 1e3, "chunks": fb["chunks"]}
    if mesh.data_index == 0 and mesh.model_index == 0:
        one = render_image_sharded(ngp_field_apply, tr.mcfg, iparams, occ2,
                                   pose, intr, H, W, rc2, _single_mesh(dev))
        res["vs_single"] = _frame_diff(
            fb["image"].cpu().numpy(), one["image"].cpu().numpy(),
            fb["weights_sum"].cpu().numpy(), one["weights_sum"].cpu().numpy())
    out["ngp_chunks_2_cascades"] = res
    torch.backends.cuda.matmul.allow_tf32 = False
    return out


def par_curved_frames(ctr, mesh) -> dict:
    """The live band frame (CDF) of a curved state at data ``mesh``."""
    from nerf_texture_tpu_torch.parallel.eval import render_image_sharded
    from nerf_texture_tpu_torch.render.renderer import (PrepassState,
                                                        render_image)
    from nerf_texture_tpu_torch.train.curved_trainer import (
        curved_anchor_apply, curved_field_apply)

    pose, intr = _par_pose(), ctr.dataset.intrinsics
    static = (ctr.ccfg, ctr.mode, "RGB", "Full")
    bundle = {"params": ctr._infer_params(ctr.state.params),
              "field_state": ctr.field_state, "rt": ctr.runtime,
              "anchor_tab": ctr._anchor_table()}
    occ = ctr.state.occ
    kw = dict(anchor_apply=curved_anchor_apply)
    out = {}
    # the bench's block-8 carve (its baked arm's settings) and the live
    # config's block 4, whose hit blocks pass the tau sweep's cap of 4096
    # (a band sweeps 4096 of its own: the frames differ, not gated)
    for name, rc, gate in (
            ("curved_cdf_block8", dataclasses.replace(ctr.rcfg,
                                                      **CURVED_BAKED), True),
            ("curved_cdf_block4", ctr.rcfg, False)):
        out[name] = par_band_frames(
            name, lambda plain, rc=rc: render_image_sharded(
                curved_field_apply, static, bundle, occ.occ, pose, intr,
                ctr.H, ctr.W, rc, mesh, density=occ.density,
                plain_select=plain, **kw),
            lambda rc=rc: torch.no_grad()(render_image)(
                curved_field_apply, static, bundle, PrepassState.build(
                    occ.occ, rc, density=occ.density), pose, intr, ctr.H,
                ctr.W, rc, **kw), mesh, "parallel")
        out[name]["gate"] = gate
    return out


def par_tp_steps(dev, ds, ngp_tr, curved_tr, data: int, model: int) -> dict:
    """One NGP and one curved step on a data x model mesh (the MLPs split
    over 'model'), beside rank 0's single-rank first steps: the losses
    and whether every rank holds the same state."""
    from nerf_texture_tpu_torch.parallel import make_mesh, shard_state
    from nerf_texture_tpu_torch.parallel.train import shard_curved_state

    mesh = make_mesh(data, model, device=dev)
    first = mesh.data_index == 0 and mesh.model_index == 0
    out = {}
    for name, make, loop, shard in (
            ("ngp", ngp_tr, ngp_loop,
             lambda tr: setattr(tr, "state", shard_state(tr.state, mesh))),
            ("curved", curved_tr, curved_loop,
             lambda tr: setattr(tr, "state", shard_curved_state(
                 tr.state, tr.field_state, mesh)[0]))):
        if first:
            tr = make()
            out[name + "_single"] = loop(tr, 1)[0][0]
            del tr
        _par_barrier(mesh)
        tr = make()
        if name == "ngp":
            tr.mark_untrained()
        shard(tr)
        losses, ms = loop(tr, 1, mesh)
        out[name] = losses[0]
        out[name + "_ms"] = ms
        out[name + "_equal"] = _ranks_equal(tr.state, mesh)
        out[name + "_split"] = sum(
            getattr(p, "tp_split", None) is not None
            for p in _leaves(tr.state.params))
        del tr
        torch.cuda.empty_cache()
    out["mesh"] = [data, model]
    return out


def _leaves(params):
    from nerf_texture_tpu_torch.train.trainer import param_leaves
    return param_leaves(params)


def par_tp4(dev, rank: int, world: int) -> dict:
    """4 ranks: one NGP and one curved step at data 2 x model 2, and band
    frames at data 4 of the 2-rank job's trained states."""
    from nerf_texture_tpu_torch.data.synthetic import SyntheticSphereDataset
    from nerf_texture_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    ds = SyntheticSphereDataset(n_frames=8, H=800, W=800)
    ngp_tr, curved_tr = _par_trainers(dev, ds)
    res = {"rank": rank, "world": world,
           "tp": par_tp_steps(dev, ds, ngp_tr, curved_tr, 2, 2)}
    mesh = make_mesh(world, 1, device=dev)
    tr = ngp_tr()
    saved = torch.load(os.path.join(PAR_DIR, "ngp_state.pt"),
                       map_location=dev, weights_only=False)
    tr.state.params, tr.state.occ = saved["params"], saved["occ"]
    res["frames"] = par_ngp_frames(tr, mesh, dev)
    del tr
    ctr = curved_tr()
    saved = torch.load(os.path.join(PAR_DIR, "curved_state.pt"),
                       map_location=dev, weights_only=False)
    ctr.state.params, ctr.state.occ = saved["params"], saved["occ"]
    ctr._params_replaced()
    res["frames"].update(par_curved_frames(ctr, mesh))
    return res


def par_nccl1(dev, rank: int, world: int) -> dict:
    """The NGP's first step over NCCL at a world of one, beside two runs
    of the single-rank step (their difference bounds the NCCL step's:
    CUDA's index_add_ in the backward is not deterministic)."""
    from nerf_texture_tpu_torch.data.synthetic import SyntheticSphereDataset
    from nerf_texture_tpu_torch.parallel import make_mesh, shard_state
    from nerf_texture_tpu_torch.parallel.train import gathered_leaf

    torch.backends.cuda.matmul.allow_tf32 = False
    ds = SyntheticSphereDataset(n_frames=8, H=800, W=800)
    ngp_tr, _ = _par_trainers(dev, ds)
    mesh = make_mesh(1, 1, device=dev)
    runs = []
    for use_mesh in (None, None, mesh):
        tr = ngp_tr()
        tr.mark_untrained()
        if use_mesh is not None:
            tr.state = shard_state(tr.state, use_mesh)
        loss = ngp_loop(tr, 1, use_mesh)[0][0]
        runs.append((loss, [gathered_leaf(p).clone()
                            for p in _leaves(tr.state.params)]))
        del tr

    def diff(a, b):
        d = [torch.abs(x - y) for x, y in zip(a[1], b[1])]
        return (abs(a[0] - b[0]), max(float(t.max()) for t in d),
                sum(int((t > 2e-5).sum()) for t in d))

    return {"backend": mesh.backend, "distributed": mesh.distributed,
            "single_vs_single": diff(runs[0], runs[1]),
            "nccl_vs_single": diff(runs[2], runs[0]),
            "losses": [r[0] for r in runs],
            "entries": sum(t.numel() for t in runs[0][1])}


PAR_JOBS = {"dp": par_dp, "tp4": par_tp4, "nccl1": par_nccl1}


def rank_main(job: str) -> int:
    """One rank of phase 19's ``job`` (started by ``rank_group``)."""
    import torch.distributed as dist

    from nerf_texture_tpu_torch.parallel import initialize_multihost

    print(PAR_RANK_START)
    backend = os.environ["SMOKE_BACKEND"]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if world == 1:
        # a world of one is not a launch to initialize_multihost: join
        # the group here (NCCL's start-up and its reduction path)
        torch.cuda.set_device(0)
        dist.init_process_group(
            backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
            f"{os.environ['MASTER_PORT']}", world_size=1, rank=0)
    else:
        check(initialize_multihost(backend=backend, timeout=PAR_TIMEOUT),
              "initialize_multihost did not join the process group")
    check(dist.get_backend() == backend, f"backend {dist.get_backend()}, "
          f"asked for {backend}")
    if backend == "gloo":
        torch.cuda.set_device(0)               # the ranks share one card
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = PAR_JOBS[job](dev, rank, world)
    res.update(backend=dist.get_backend(), world=world, rank=rank,
               device=str(dev), wall_s=time.perf_counter() - t0,
               peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20)
    with open(os.path.join(PAR_DIR, f"{job}_{world}_{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def _lockstep(got, want, first: int) -> tuple:
    got, want = np.asarray(got), np.asarray(want)
    d = np.abs(got - want)
    return (float(d.max()), float((d / np.abs(want)).max()),
            float(d[:first].max()), float(abs(got.mean() - want.mean())))


def parallel_phase(dev, card: str) -> dict:
    """Phase 19: ``parallel/`` on the card.  Returns the selection kernels'
    launches of the band frames, by path."""
    t0 = time.perf_counter()
    count = torch.cuda.device_count()
    print(f"parallel: {count} card(s) ({card}); ranks of one card share "
          f"cuda:0 over gloo, so every time below is gloo traffic through "
          f"the host on one card, not a multi-GPU speed")
    launches = {}

    def report(tag, ranks):
        for r in ranks:
            print(f"parallel {tag}: rank {r['rank']} of {r['world']}: backend "
                  f"{r['backend']}, {r['device']}, peak memory "
                  f"{r['peak_mib']:.1f} MiB, wall {r['wall_s']:.1f} s "
                  f"({card})")
            check(r["backend"] == tag.split()[0],
                  f"rank {r['rank']} ran {r['backend']}")
        for name, f in ranks[0].get("frames", {}).items():
            key = f"parallel_{tag.split()[1]}_{name}"
            for r in ranks:
                for kind, n in r["frames"][name].get("launches", {}).items():
                    if n:
                        launches.setdefault(kind, {})[key] = \
                            launches.get(kind, {}).get(key, 0) + n
            if "launches" in f:
                kind = "topk" if name.endswith("topk") else "cdf"
                check(launches.get(kind, {}).get(key, 0) > 0,
                      f"{key}: {kind} selection kernel never launched")
            line = (f"parallel {tag}: {name} 800x800: {f['ms']:.1f} ms on "
                    f"rank 0, chunks {[r['frames'][name]['chunks'] for r in ranks]}")
            if "launches" in f:
                line += (f", selection launches "
                         f"{[r['frames'][name]['launches'] for r in ranks]}, "
                         f"kernel frame == plain-selection frame bit for bit "
                         f"on every rank: "
                         f"{all(r['frames'][name]['bitwise'] for r in ranks)}")
            p, e, m = f["vs_single"]
            gate = f.get("gate", True)
            line += (f"; vs the single-rank frame: PSNR {p:.2f} dB, max abs "
                     f"{e:.3g}, live mismatch {m:.4f}"
                     f"{'' if gate else ' (not gated: the tau sweep cap)'}")
            if "atol" in f:
                line += (f"; max abs {'<=' if e <= f['atol'] else '>'} "
                         f"{f['atol']:g} (gated); the single-rank frame at "
                         f"half the ray chunk differs from it by "
                         f"{f['chunk_floor']:.3g}")
                check(e <= f["atol"], f"parallel {tag} {name} vs the "
                      f"single-rank frame: max abs {e} > {f['atol']}")
            print(line + f" ({card})")
            check(not gate or (p >= FRAME_PSNR_MIN and e <= FRAME_MAX_ABS
                               and m <= FRAME_LIVE_MISMATCH),
                  f"parallel {tag} {name} vs the single-rank frame: PSNR {p}, "
                  f"max abs {e}, live mismatch {m}")
        for r in ranks:
            if "tp" in r:
                tp = r["tp"]
                for name in ("ngp", "curved"):
                    check(tp[name + "_equal"], f"{tag} tp {name}: ranks "
                          f"differ after a step")
                    check(tp[name + "_split"] > 0, f"{tag} tp {name}: no "
                          f"leaf split over 'model'")
        tp = ranks[0].get("tp")
        if tp:
            for name in ("ngp", "curved"):
                rel = abs(tp[name] - tp[name + "_single"]) \
                    / abs(tp[name + "_single"])
                print(f"parallel {tag}: {name} step at data {tp['mesh'][0]} "
                      f"x model {tp['mesh'][1]} ({tp[name + '_split']} "
                      f"leaves split): loss {tp[name]:.6f} vs single-rank "
                      f"{tp[name + '_single']:.6f} (rel {rel:.2e}), "
                      f"{tp[name + '_ms']:.1f} ms, ranks bit for bit "
                      f"({card})")
                check(rel <= 1e-3, f"{tag} tp {name} loss rel {rel}")

    # -- data 2 (and model 2), gloo
    torch.cuda.empty_cache()       # this process's cache, for the ranks
    ranks = rank_group("dp", 2, "gloo", card)
    r0 = ranks[0]
    ref = {**ranks[0]["ref"], **ranks[1]["ref"]}
    for name, first in (("ngp", PAR_NGP_STEPS), ("curved", 16)):
        got, want = r0[name]["losses"], ref[name]
        mx, rel, first_mx, mean = _lockstep(got, want, first)
        print(f"parallel gloo dp: {name} {len(got)} steps at data 2 vs the "
              f"single-rank run: loss max abs diff {mx:.3g} (max rel "
              f"{rel:.3g}, first refresh cycle {first_mx:.3g}), mean diff "
              f"{mean:.3g}; training-view PSNR {r0[name]['psnr']:.2f} vs "
              f"{ref[name + '_psnr']:.2f} dB; {r0[name]['ms']:.1f} "
              f"ms/step vs {ref[name + '_ms']:.1f} single-rank; ranks "
              f"bit for bit: {all(r[name]['equal'] for r in ranks)} ({card})")
        check(all(r[name]["equal"] for r in ranks),
              f"gloo dp {name}: the ranks' states differ")
        check(all(r[name]["losses"] == got for r in ranks),
              f"gloo dp {name}: the ranks' losses differ")
        if name == "ngp":
            check(rel <= 1e-2, f"gloo dp ngp lockstep rel {rel}")
        else:
            check(first_mx <= 1e-2 and mx <= 0.1 and mean <= 1e-2,
                  f"gloo dp curved lockstep {mx} {first_mx} {mean}")
        check(abs(r0[name]["psnr"] - ref[name + "_psnr"]) <= 0.3,
              f"gloo dp {name} PSNR {r0[name]['psnr']} vs "
              f"{ref[name + '_psnr']}")
    report("gloo data2", ranks)
    # -- data 4 and data 2 x model 2, gloo
    report("gloo data4", rank_group("tp4", 4, "gloo", card))
    # -- NCCL at a world of one
    n1 = rank_group("nccl1", 1, "nccl", card)[0]
    ss, ns = n1["single_vs_single"], n1["nccl_vs_single"]
    print(f"parallel nccl world 1: backend {n1['backend']} (a process "
          f"group: {n1['distributed']}); one NGP step's loss "
          f"{n1['losses'][2]:.7f} vs single-rank {n1['losses'][0]:.7f} "
          f"(two single-rank runs differ by {ss[0]:.3g}, NCCL by "
          f"{ns[0]:.3g}); params max abs diff {ns[1]:.3g} on {ns[2]} of "
          f"{n1['entries']} entries > 2e-5, single vs single {ss[1]:.3g} on "
          f"{ss[2]} ({card})")
    check(n1["backend"] == "nccl" and n1["distributed"], "nccl world 1")
    check(ns[0] <= max(2 * ss[0], 1e-5 * abs(n1["losses"][0])),
          f"nccl loss diff {ns[0]} beyond the single-rank runs' {ss[0]}")
    check(ns[2] <= max(2 * ss[2], 1e-4 * n1["entries"]),
          f"nccl params: {ns[2]} entries off, single runs {ss[2]}")
    if count >= 2:
        world = min(count, 4)
        report(f"nccl data{world}", rank_group("dp", world, "nccl", card))
    else:
        print(f"parallel: one card: the multi-card runs over NCCL (data "
              f"parallel steps and band frames on min(count, 4) cards) did "
              f"not run ({card})")
    print(f"parallel: phase 19 wall {time.perf_counter() - t0:.1f} s "
          f"({card})")
    return launches


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--rank":
        return rank_main(sys.argv[2])           # one rank of phase 19
    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, torch {torch.__version__}, cuda "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")
    # Every matmul of a render multiplies bf16-rounded operands, which
    # TF32 holds exactly, with f32 accumulation: TF32 changes no product,
    # so the tensor cores may run the MLPs (training turns it off).
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True

    from nerf_texture_tpu_torch import kernels
    from nerf_texture_tpu_torch.data.poses import orbit_pose
    from nerf_texture_tpu_torch.data.synthetic import (
        SyntheticSphereDataset, shell_occupancy, sphere_intrinsics)
    from nerf_texture_tpu_torch.models import ngp
    from nerf_texture_tpu_torch.ops.proxy_select import (
        proxy_select, proxy_select_cdf, proxy_select_cdf_reference,
        proxy_select_reference)
    from nerf_texture_tpu_torch.render.renderer import (PrepassState,
                                                        RenderConfig)
    from nerf_texture_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                      ngp_infer_params,
                                                      render_frame)
    from nerf_texture_tpu_torch.utils.metrics import psnr as psnr_of
    wall0 = time.perf_counter()

    only_entry = sys.argv[1:] == ["--only", "entry_points"]
    only_relight = sys.argv[1:] == ["--only", "relight"]
    only_viewer = sys.argv[1:] == ["--only", "viewer"]
    only_background = sys.argv[1:] == ["--only", "background"]
    only_prepare = sys.argv[1:] == ["--only", "prepare"]
    only_parallel = sys.argv[1:] == ["--only", "parallel"]
    only_segment = sys.argv[1:] == ["--only", "segment"]
    only_shell = sys.argv[1:] == ["--only", "shell"]
    as_worker = sys.argv[1:] == ["--worker", "relight"]
    as_viewer_worker = sys.argv[1:] == ["--worker", "viewer"]

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    # one nvcc a source, started together
    names = ("proxy_select", "maxflow", "spatial_build")
    with ThreadPoolExecutor(len(names)) as pool:
        builds = dict(zip(names, pool.map(kernels.build, names)))
    for name in names:
        kernels.load_library(name)
    build = builds["proxy_select"]
    print(f"build: proxy_select.cu {build.path.name}, maxflow.cu "
          f"{builds['maxflow'].path.name} and spatial_build.cu "
          f"{builds['spatial_build'].path.name} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {build.seconds:.2f} s, "
          f"{builds['maxflow'].seconds:.2f} s and "
          f"{builds['spatial_build'].seconds:.2f} s, at once)")
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        build.log)
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    if build.seconds == 0.0:
        print("  (the library was built before this run: no ptxas lines)")
    else:
        check(len(spills) >= 8, f"ptxas printed {len(spills)} spill lines "
              f"for 8 kernels")
        check(all(a == "0" and b == "0" for a, b in spills),
              f"a selection kernel spills registers: {spills}")
    mf_log = builds["maxflow"].log
    mf_spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", mf_log)
    for line in mf_log.splitlines():
        if "registers" in line:
            print(f"  ptxas (maxflow): {line.strip()}")
    check(all(a == "0" and b == "0" for a, b in mf_spills),
          f"a max-flow kernel spills registers: {mf_spills}")
    sb_log = builds["spatial_build"].log
    sb_spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", sb_log)
    for line in sb_log.splitlines():
        if "registers" in line:
            print(f"  ptxas (spatial_build): {line.strip()}")
    check(all(a == "0" and b == "0" for a, b in sb_spills),
          f"a grid-table kernel spills registers: {sb_spills}")

    if only_entry:
        # a shorter run while working on phase 13: the device, the build
        # and that phase only; no result lines
        entry_points_phase(dev, card, start_clis(relight=False)["entry"])
        print(f"smoke: wall {time.perf_counter() - wall0:.1f} s, phase 13 "
              f"only ({card})")
        return 0
    if only_background:
        # a shorter run while working on phase 17: the device, the build,
        # phases 7-8 (its gates) and 17; no result lines
        walls = {}
        mcfg, rcfg = ngp.NGPConfig(**BENCH_NGP), RenderConfig(**BENCH_RENDER)
        ds, _, packed = ngp_train_render(dev, card, mcfg, rcfg,
                                         lambda name: None)
        t0 = time.perf_counter()
        background_phase(dev, card, ds, packed)
        walls["17"] = time.perf_counter() - t0
        print(f"smoke: wall {time.perf_counter() - wall0:.1f} s, phases 7, "
              f"8 and 17 only, phase 17 {walls['17']:.1f} s ({card})")
        return 0
    if as_worker:
        # phase 15 but its CLIs, then phase 21, for the whole smoke, which
        # reads this output (start_worker)
        print(WORKER_START)
        cdf = relight_phase(dev, card, SyntheticSphereDataset(
            n_frames=8, H=800, W=800), own_sh=False)
        torch.cuda.empty_cache()
        # phase 21 yields the host to phase 13's CLI chain, which holds
        # the smoke's wall: this worker ends long before the viewer's
        os.nice(SHELL_NICE)
        shell = shell_phase(dev, card)
        print(json.dumps({"relight_launches": cdf, "shell": shell}))
        return 0
    if only_shell:
        # a shorter run while working on phase 21: the device, the build
        # and that phase only; no result lines
        shell_phase(dev, card)
        print(f"smoke: wall {time.perf_counter() - wall0:.1f} s, phase 21 "
              f"only ({card})")
        return 0
    if as_viewer_worker:
        # phase 16 but its in-process viewer, for the whole smoke, which
        # reads this output (start_worker)
        print(VIEWER_WORKER_START)
        print(json.dumps({"scenes": scenes_phase(dev, card, CLI_PLAIN_ITERS,
                                                 prepare=True)}))
        return 0
    if only_parallel:
        # a shorter run while working on phase 19: the device, the build
        # and that phase only; no result lines
        t0 = time.perf_counter()
        parallel_phase(dev, card)
        print(f"smoke: wall {time.perf_counter() - wall0:.1f} s, phase 19 "
              f"only, {time.perf_counter() - t0:.1f} s ({card})")
        return 0
    if only_segment:
        # a shorter run while working on phase 20: the device, the build,
        # phase 13's scene (written, no CLI started), phase 18's capture
        # frames (no training) and phase 20; no result lines
        start_clis(relight=False, entry=False)
        capture_round_trip(card)
        segment_phase(dev, card)
        print(f"smoke: wall {time.perf_counter() - wall0:.1f} s, phase 20 "
              f"only ({card})")
        return 0
    if only_prepare:
        # a shorter run while working on phase 18: the device, the build,
        # phase 13's scene (written, no CLI started) and phase 18; no
        # result lines
        start_clis(relight=False, entry=False)
        prepare_phase(dev, card)
        print(f"smoke: wall {time.perf_counter() - wall0:.1f} s, phase 18 "
              f"only ({card})")
        return 0
    if only_viewer:
        # a shorter run while working on phase 16: the device, the build,
        # the viewer on a briefly trained curved field, and the scenes
        # with a 50-step undistilled run on an icosphere template for
        # --gui; no result lines
        viewer_phase(dev, card, quick_curved(dev, SyntheticSphereDataset(
            n_frames=8, H=800, W=800)))
        torch.cuda.empty_cache()
        scene = os.path.join(CLI_DIR, "scene")
        start_clis(relight=False, entry=False)
        from nerf_texture_tpu_torch.geometry.mesh import (make_icosphere,
                                                          save_obj)
        ws_plain = os.path.join(CLI_DIR, "ws_plain")
        os.makedirs(os.path.join(ws_plain, "meshes"))
        save_obj(os.path.join(ws_plain, "meshes",
                              "surface_coacd_remesh.obj"),
                 make_icosphere(4, radius=0.5))
        plain = Background(lambda: cli_run(
            ["main_torch.py", scene, "--workspace", ws_plain, "--iters",
             "50", "--eval_interval", "50"], "cli_curved_plain"))
        scenes_phase(dev, card, 50)
        check(plain.result()[0] == 0, "the 50-step undistilled run")
        print(f"smoke: wall {time.perf_counter() - wall0:.1f} s, phase 16 "
              f"only ({card})")
        return 0
    if only_relight:
        # a shorter run while working on phase 15: the device, the build
        # and that phase only (its own SH arm for the imports); no result
        # lines
        clis = start_clis(entry=False)
        relight_phase(dev, card, SyntheticSphereDataset(n_frames=8, H=800,
                                                        W=800), own_sh=True)
        relight_clis(card, clis["relight"])
        print(f"smoke: wall {time.perf_counter() - wall0:.1f} s, phase 15 "
              f"only ({card})")
        return 0

    phase_walls, lap0 = {}, [time.perf_counter()]

    def lap(name):
        """Closes the wall of the phases since the last lap."""
        now = time.perf_counter()
        phase_walls[name] = now - lap0[0]
        lap0[0] = now

    # -- 3. kernel vs plain version on the card ------------------------------
    max_err = 0.0
    timing = {}
    for seed, (N, K, cap) in enumerate([(16384, 24, 4), (8192, 16, 5)]):
        args = selection_inputs(N, K, seed, dev)
        got = proxy_select_cdf(*args, cap=cap, w_eps=1e-4)
        ref = proxy_select_cdf_reference(*args, cap=cap, w_eps=1e-4)
        torch.cuda.synchronize()
        err = check_selection("proxy_select_cdf", got, ref, N, K, cap,
                              zero_unfilled=False, args=args)
        max_err = max(max_err, err)
        plain = cuda_ms(lambda: proxy_select_cdf_reference(
            *args, cap=cap, w_eps=1e-4))
        timing[(N, K, cap)] = plain
        print(f"kernel: proxy_select_cdf [{N}, {K}] cap {cap}: max abs err "
              f"{err:.3g}; plain version {plain * 1e3:.2f} us a call "
              f"({card})")

    # -- 4. port on the card vs port on the CPU ------------------------------
    mcfg_s = ngp.NGPConfig(**SMALL_NGP)
    rcfg_s = RenderConfig(**SMALL_RENDER)
    params_cpu = seeded_params(ngp, mcfg_s, torch.Generator().manual_seed(0))
    params_gpu = {k: ([{n: t.to(dev) for n, t in layer.items()}
                       for layer in v] if isinstance(v, list) else v.to(dev))
                  for k, v in params_cpu.items()}
    Hs = Ws = 64
    intr_s = sphere_intrinsics(Hs, Ws)
    pose_s = orbit_pose(1.2, 0.7, 2.0)
    frames = {}
    for name, dev_i, params in (("cpu", "cpu", params_cpu),
                                ("cuda", dev, params_gpu)):
        occ = shell_occupancy(rcfg_s.grid_size, device=dev_i)
        out = render_frame(params, occ, pose_s, intr_s, Hs, Ws, mcfg_s,
                           rcfg_s)
        frames[name] = (out["image"].cpu().numpy(),
                        out["weights_sum"].cpu().numpy() > 0)
    img_c, live_c = frames["cpu"]
    img_g, live_g = frames["cuda"]
    p_small = psnr(img_g, img_c)
    e_small = float(np.abs(img_g - img_c).max())
    mism = float(np.mean(live_c != live_g))
    print(f"parity: {Hs}x{Ws} frame card vs CPU: PSNR {p_small:.2f} dB, max "
          f"abs {e_small:.3g}, live mismatch {mism:.4f} "
          f"({int(live_c.sum())} live on CPU)")
    check(live_c.any(), "the small parity frame has no live pixel")
    check(p_small >= FRAME_PSNR_MIN and e_small <= FRAME_MAX_ABS
          and mism <= FRAME_LIVE_MISMATCH,
          f"card vs CPU frame: PSNR {p_small} dB, max abs {e_small}, live "
          f"mismatch {mism}")

    # -- 5. the slice at full width ------------------------------------------
    mcfg = ngp.NGPConfig(**BENCH_NGP)
    rcfg = RenderConfig(**BENCH_RENDER)
    H = W = 800
    intr = sphere_intrinsics(H, W)
    params = seeded_params(ngp, mcfg,
                           torch.Generator(device=dev).manual_seed(0))
    iparams = ngp_infer_params(params, mcfg)
    occ = shell_occupancy(rcfg.grid_size, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prepass = PrepassState.build(occ.occ, rcfg, density=occ.density)
    torch.cuda.synchronize()
    prepass_s = time.perf_counter() - t0
    print(f"slice: NGP {mcfg.num_levels} levels x {mcfg.level_dim}, "
          f"{mcfg.packed_spec.table_rows} table rows; grid "
          f"{rcfg.grid_size}^3; prepass state built in {prepass_s:.3f} s")

    # novel views: the 8-frame training orbit sits at phi = 2 pi k / 8,
    # these sit between its frames and off its theta curve
    poses = [orbit_pose(1.25 + 0.1 * i, 2 * np.pi * (i + 0.5) / 8, 2.0)
             for i in range(4)]

    def frame(pose, plain_select=False):
        return render_frame(iparams, None, pose, intr, H, W, mcfg, rcfg,
                            prepass=prepass, plain_select=plain_select)

    frame(poses[0])                                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    proxy_select_cdf.launches = 0
    walls, outs = [], []
    for pose in poses[1:]:
        t0 = time.perf_counter()
        out = frame(pose)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    chunks_total = sum(out["chunks"] for out in outs)
    launches = proxy_select_cdf.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    check(launches > 0, "proxy_select_cdf was never launched by the slice")
    check(launches == chunks_total, f"{launches} kernel launches for "
          f"{chunks_total} chunks")
    for out in outs:
        img = out["image"]
        check(tuple(img.shape) == (H, W, 3), f"image shape {img.shape}")
        check(bool(torch.isfinite(img).all()), "non-finite pixels")
        check(float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
              f"image outside [0, 1]: [{float(img.min())}, "
              f"{float(img.max())}]")
        check(0 < out["live"] < H * W, f"live rays {out['live']}")
        check(float(out["weights_sum"].max()) > 0.05,
              "no pixel composites any weight")

    img_k = outs[0]["image"].cpu().numpy()
    img_p = frame(poses[1], plain_select=True)["image"].cpu().numpy()
    check_twin("slice", img_k, img_p, card)
    lives = [out["live"] for out in outs]
    print(f"slice: {H}x{W} frames: {', '.join(f'{w:.2f}' for w in walls)} "
          f"ms/frame (median {float(np.median(walls)):.2f}) over "
          f"{len(walls)} novel poses; live rays {lives}; chunks/frame "
          f"{[out['chunks'] for out in outs]}; proxy_select_cdf launches "
          f"{launches}; peak memory {peak_mb:.1f} MiB ({card})")

    slice_launches = launches
    del params, iparams, prepass, outs, occ
    torch.cuda.empty_cache()

    # -- 6. the top-k kernel vs its plain version on the card ----------------
    topk_err = 0.0
    for seed, (N, K, cap) in enumerate([(16384, 24, 8), (8192, 32, 8),
                                        (8192, 16, 4)]):
        args = selection_inputs(N, K, 10 + seed, dev)
        got = proxy_select(*args, cap=cap, w_eps=1e-4)
        ref = proxy_select_reference(*args, cap=cap, w_eps=1e-4)
        torch.cuda.synchronize()
        err = check_selection("proxy_select", got, ref, N, K, cap,
                              zero_unfilled=True)
        topk_err = max(topk_err, err)
        plain = cuda_ms(lambda: proxy_select_reference(*args, cap=cap,
                                                       w_eps=1e-4))
        timing[(N, K, cap)] = plain
        print(f"kernel: proxy_select [{N}, {K}] cap {cap}: max abs err "
              f"{err:.3g}, {int(got[2].sum())} kept of {N * cap} slots; "
              f"plain version {plain * 1e3:.2f} us a call ({card})")

    lap("1-6")

    # -- 14. the selection kernels' device time vs their bounds -------------
    # (here, before any other process shares the card)
    timed = timing_phase(dev, card)
    lap("14")

    # -- 7-8. the NGP's training at full width, and its trained field --------
    ds, launches, packed_psnr = ngp_train_render(dev, card, mcfg, rcfg, lap)

    # -- 17. the per-corner grid with the learned background sphere ----------
    background = background_phase(dev, card, ds, packed_psnr)
    lap("17")

    # -- 9. the curved model's serving path ----------------------------------
    curved = curved_phase(dev, card, ds, timing)
    lap("9")

    # -- 10. curved training, and the trained live, pool and baked frames --
    trained, tr = curved_train_phase(dev, card, ds, timing)
    lap("10")
    # phase 15's SH import, on this trained field before phase 11 imports
    # a texture into it
    sh_import = relight_sh_import(tr, ds, card)
    lap("15 SH import")

    # -- from here the CLIs of phases 13 and 15 and the rest of phases 15
    # and 16 (worker processes) run beside phases 11-13 on the same card
    clis = start_clis()
    # the relight worker at a lower host priority than phase 13's CLI
    # chain, which holds the smoke's wall (the main process waits for
    # it): the worker has slack beside it
    worker = start_worker("relight", nice=5)
    viewer_worker = start_worker("viewer", nice=0)

    # -- 16. the viewer on phase 10's trained field, in this process ---------
    # (before phase 11 imports a texture into it; beside the CLIs, as the
    # main process has slack until phase 13 waits for them)
    viewer = viewer_phase(dev, card, tr)
    lap("16 viewer")

    # -- 11. the texture pipeline on the trained field -----------------------
    texture = texture_phase(dev, card, ds, tr)
    lap("11")

    # -- 12. synthesis onto another mesh, and its imports --------------------
    surfaces, grid_lines = surfaces_phase(dev, card, ds, tr,
                                          trained["psnr_live"])
    lap("12")
    del tr
    torch.cuda.empty_cache()

    # -- 13. the training entry points on a scene directory ------------------
    entry, ngp_psnr = entry_points_phase(dev, card, clis["entry"])
    lap("13")

    # -- 15. relighting and the vertex encoder --------------------------------
    relight_launches, shell = relight_from_worker(worker)
    relight_cdf = {"relight_sh_import": sh_import, **relight_launches}
    relight_topk = relight_clis(card, clis["relight"])
    lap("15, 21")

    # -- 16. the JPEG scene, bound 2 and --gui (the worker) -------------------
    (b2_topk, b2_cdf), par, maxflow_line = scenes_from_worker(
        viewer_worker, ngp_psnr, card)
    lap("16")

    print("smoke: phase walls: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in phase_walls.items())
        + f"; under torch.profiler {PROFILE_S[0]:.1f} s ({card})")
    print(f"smoke: wall {time.perf_counter() - wall0:.1f} s ({card})")
    cdf_paths = {"ngp_serving_slice": slice_launches,
                 "ngp_trained_render": launches["cdf"],
                 "ngp_background": background["cdf"],
                 "curved_live": curved["launches"],
                 "curved_trained_live": trained["live"],
                 "ngp_trained_render_deferred": launches["cdf_deferred"],
                 "curved_baked": trained["baked"],
                 "curved_baked_deferred": trained["baked_deferred"],
                 "texture_field": texture["texture_field"],
                 "texture_patch": texture["texture_patch"], **surfaces,
                 **relight_cdf, **viewer, "bound2_cli_eval": b2_cdf,
                 **par.get("cdf", {}), **shell["cdf"]}

    def kernel_line(name, kind, K, cap, replaces, paths, err, other=()):
        """One kernel's entry of the JSON line at its main-path shape
        [16384, K] cap (device times cold, from HBM, unless _warm), with
        the other timed shapes under ``by_shape``."""
        def cell(key):
            t = timed[key]
            return {"device_us": t["device_us"],
                    "device_us_warm": t["device_us_warm"],
                    "bound_us": t["bound_ms"] * 1e3,
                    "bound_share": t["bound_share"],
                    "wrapper_us": t["wrapper_us"],
                    "copy_us": t["copy_us"],
                    "plain_ms": timing[key[1:]]}
        key = (kind, 16384, K, cap)
        t = timed[key]
        return {"name": name, "route": "cuda",
                "source": "nerf_texture_tpu_torch/csrc/proxy_select.cu",
                "replaces": replaces, "launches": sum(paths.values()),
                "launches_by_path": paths, "max_abs_err": err,
                "ms": t["device_us"] / 1e3,
                "plain_ms": timing[key[1:]], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None,
                "shape": f"[16384, {K}] cap {cap}", **cell(key),
                "by_shape": {f"[16384, {K}] cap {c}": cell((kind, 16384, K,
                                                            c))
                             for c in other},
                "card": card}

    print(json.dumps({"kernels": [
        kernel_line("proxy_select_cdf", "cdf", 24, 5,
                    "nerf_texture_tpu/ops/proxy_select.py:96", cdf_paths,
                    max(max_err, curved["max_abs_err"],
                        trained["max_abs_err"]), other=(4,)),
        kernel_line("proxy_select", "topk", 24, 8,
                    "nerf_texture_tpu/ops/proxy_select.py:49",
                    {"ngp_trained_render_topk": launches["topk"],
                     "ngp_trained_render_topk_deferred":
                         launches["topk_deferred"],
                     "ngp_background_topk": background["topk"],
                     "texture_two_round": texture["texture_two_round"],
                     **entry, **relight_topk, "bound2_cli_eval": b2_topk,
                     **par.get("topk", {}), **shell["topk"]},
                    topk_err),
        {**maxflow_line, "card": card}, *grid_lines]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    # a stop from outside ends the subprocesses too (the finally below)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        code = main()
    finally:
        stop_children()
    sys.exit(code)
