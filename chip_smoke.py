"""Smoke run of the PyTorch port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. probe: the card's name and power limit, torch's CUDA version, nvcc;
  2. build the kernel sources, one nvcc each, started together:
     csrc/mega_whitted.cu (K1a), csrc/mega_pt.cu (K1b, and K1c and K1d,
     each static and with motion) and csrc/mega_bwd.cu (K2a's primal and
     its reverse kernel, K2b's primal and fwd+bwd, their K2c texture twins,
     and the refit of K2's boxes), csrc/tri_intersect.cu (K3, the
     wavefront's dense closest hit), csrc/bigtex_gather.cu (K4, the
     big-texture probe's gather-sum) and csrc/philox_draws.cu (the
     wavefront draw source's Philox uniforms), with ptxas's register, frame and spill lines per kernel
     (kept beside a cached library); the flat instantiations must keep
     their registers: K1a 72, K1b 72 (capped at 7 blocks an SM), K1c 89
     (94 with motion), K1d 127 (127 with motion), K2a 88 (primal; 96 its
     tree twin, both writing their records) and 128 (the reverse kernel,
     capped), K2b 80
     (primal) and 164 (fwd+bwd; the per-target, warp-summed scatter), K3
     50 (the rejection before dividing), K4 31 (its window); K2's tree
     twins, which
     inline the walk of csrc/mega_common.cuh, KEPT_REGISTERS' counts; and
     each K1 and K2 kernel has a tree instantiation (K1e);
  3. K1a against its plain torch version on 65,536 primary rays of
     scenes/whitted_conductors.xml (1 spp, no DoF), and on a ray along -z
     in the plane y = -10 of the first chunk's box and of leaf boxes (the
     room's floor), which the walk must keep to reach the back wall; the
     scene (32,768 faces, past one 128-face chunk) routes to K1a's tree
     instantiation (render/renderer.py::_mega_build_cached), and the flat
     chunk sweep (the tables of FLAT_MAX_FACES, build_mega's default) is
     held to the same plain version on the same rays;
  4. the Whitted main path: render_camera on scenes/whitted_conductors.xml
     at 800x800, 16 spp, depth 6, u8 clamp on the device — with the launch
     counters set to 0 before it, K1a's tree instantiation must launch 16
     times and the others never; the PNG goes to a temporary directory; one
     warm-up frame, then the median of 3 timed frames (Mpaths/s, paths =
     w*h*spp);
  5. K1a at its main path's shape (the 640,000 rays of one sample): time
     per launch, the plain version's time and error on every 8th ray, and
     the least time the card needs for the FP32 work of the walk's box and
     face tests, counted by ops/megakernel.py::TreeWalker on those rays
     (times 8);
  6. K1b against its plain version on 65,536 primary rays in both draw
     modes (a table from a torch.Generator, and Philox) on
     scenes/feat_pt.xml, feat_pt_rr.xml, feat_pt_spec.xml and feat_pt.xml
     without its <Renderer> (Whitted + LightMesh);
  7. the path-tracing main path: render_camera on scenes/feat_pt.xml at
     800x800, 16 spp, depth 4, NEE + importance sampling, u8 clamp on the
     device — with the counters set to 0 before it, K1b must launch 16
     times and the others never; one warm-up frame, then the median of 3
     timed frames; then one frame each of feat_pt_rr.xml (16 spp) and
     feat_pt_spec.xml (1 spp), checked finite and sane;
  8. K1b at its main path's shape (640,000 rays of one sample, Philox):
     time per launch (CUDA events around the wrapper, and the kernel's
     device time), the plain version's time and error on the same rays
     and draws, the bound of the counted FP32 work, and beside it the
     draws and the Philox blocks the kernel computes per ray (counted by
     the plain version; this phase and 11, 14 and 17 alike);
  9. K1c (mega_ext) against its plain version on 65,536 primary rays in
     both draw modes on the scenes of
     advanced_cpu_raytracing_tpu_torch/scene/feature_scenes.py (spot +
     directional, the BRDF zoo, the demo's area light, motion + roughness,
     scenes/feat_spotareaml.xml as Whitted and as path tracing with a rough
     glass sphere) and on scenes/feat_lights_brdf.xml as Whitted and as
     path tracing (NEE + importance sampling, by substitution; on every
     2nd of the rays), through the tree instantiation where the scene has
     more than one chunk, and on feat_lights_brdf.xml the flat chunk sweep
     too, held to the same plain version;
 10. the K1c main path: render_camera on scenes/feat_lights_brdf.xml at
     800x800, 16 spp, depth 4, DoF, u8 clamp on the device — with the
     counters set to 0 before it, K1c's tree instantiation must launch 16
     times and the others never; one warm-up frame, then the median of 3
     timed frames; then one unwarmed 16-spp frame of its path-tracing
     variant;
 11. K1c at its main path's shape (640,000 rays of one sample through
     the lens, Philox): time per launch, the plain version's time and
     error on every 8th ray and its draws, and the bound of the FP32 work
     counted by TreeWalker on those rays (times 8);
 12. K1d (mega_tex) against its plain version on 65,536 primary rays in
     both draw modes on the K1d scenes of
     advanced_cpu_raytracing_tpu_torch/scene/feature_scenes.py (Perlin,
     image, normal and bump maps, six textures, megapixel and HDR
     textures, the background texture, transformed maps, sphere textures
     and bumps, the env light with small and large maps and with a rough
     mirror, scenes/feat_spotareaml.xml under the env light as Whitted and
     as path tracing with a rough glass, and the env scenes whose
     candidates' draws start at each word of a Philox block, 0 to 3
     (feature_scenes.py::env_aligned_xml: a rough mirror with 0-2 mesh and
     area lights), these also with every candidate outside the ball, each
     lit node falling back to its normal) and on scenes/feat_textures.xml
     as Whitted and as path tracing at its depth 4 (NEE + importance
     sampling, by substitution; the plain version on every 4th of the
     65,536 rays); scenes without draws are held to K1a's bound, the others
     to K1c's; feat_textures.xml walks the tree, and its flat chunk sweep
     is held to the same plain version;
 13. the K1d main path: render_camera on scenes/feat_textures.xml at
     800x800, 16 spp, depth 4, u8 clamp on the device — with the counters
     set to 0 before it, K1d's tree instantiation must launch 16 times and
     the others never;
     one warm-up frame, then the median of 3 timed frames; then one
     unwarmed 16-spp frame of its path-tracing variant;
 14. K1d at its main path's shape (640,000 rays of one sample, Philox):
     time per launch, the plain version's time and error on every 8th of
     those rays and their draws, and the bound of the counted FP32 work
     (the plain version's counts times 8), Perlin evaluations, texel taps
     and env candidates included, the walk's tests counted by TreeWalker;
 15. K1e, the tree instantiations, against their plain version: K1a's and
     K1d's on 65,536 primary rays through the centres of every 4th pixel
     (where the grid's shared edges make ties) of the 524,288-face terrain
     of advanced_cpu_raytracing_tpu_torch/scene/synth.py, untextured and
     textured, as it is (its faces point down: ambient and background
     only) and with its winding reversed (lit by its point light, the
     texture showing; the plain version must show the light raising the
     mean radiance by more than 1 and the texture changing more than 20%
     of the rays) (no draws: K1a's bound); then, with the forward route's
     threshold (FWD_FLAT_MAX_FACES) set to 0 so every scene with faces walks
     a tree, K1b's
     on the path-traced 2,048-face terrain, K1c's on the BRDF zoo, on the
     motion + roughness scene and on a moving 512-face terrain (swept leaf
     boxes), and K1d's on the normal and bump maps and on the env + motion
     scene, in both draw modes (K1c's bound);
 16. the K1e main path: render_scene on the untextured and the textured
     terrain at 640x480, 16 spp, depth 1 — with the counters set to 0
     before each, K1a's and K1d's tree instantiations must launch 16 times
     and nothing else; then render_camera on the textured terrain: one
     warm-up frame and the median of 3 timed u8 frames;
 17. K1e at the main path's shape (the 307,200 rays of one sample), K1a's
     and K1d's tree instantiations: time per launch, the plain version's
     time and error on every 16th ray, and the bound: the FP32 work of the
     tree walk, or the bytes it must read once (the node boxes it visits,
     the vertices of the rows it tests, the winners' rows of the per-face
     tables, the rays), both counted by ops/megakernel.py::TreeWalker on
     every ray; the faces-up terrain's time per launch on the same shape;
     then, on every ray of one sample of each of the four forward main
     paths' scenes, the route's kernel beside the other geometry: the
     tree instantiations of whitted_conductors.xml, feat_lights_brdf.xml
     and feat_textures.xml beside the flat chunk sweep of the tables built
     with FLAT_MAX_FACES (the earlier route), and feat_pt.xml's flat kernel
     beside its tree twin (built with flat_max 0): time per launch of each,
     and the tree's radiance equal to the flat sweep's bit for bit on every
     ray (exact_frac_vs_flat 1.0, else the phase fails);
 18. K2a (csrc/mega_bwd.cu, the differentiable render's Whitted chain:
     its primal, writing its segment records, and its reverse kernel on
     them) against its plain version (ops/megabwd.py, autograd) on 16,384
     primary rays (over the gauge scene's chunks the plain version on every
     4th ray, the kernels' radiance cotangent 0 on the others) at full depth of
     the gauge scene (scenes/whitted_conductors.xml with a directional
     light, scene/feature_scenes.py::gauge_scene_xml), of the slice scene
     with the coarse torus, each also with its vertices moved by a seeded offset
     (faces out of their built leaf or chunk boxes, which rays must still
     hit), of the demo scene and of the demo scene with its mirror sphere
     made emissive (in the pack), each with the branch uniforms from a
     torch.Generator table and from Philox (the moved cases Philox), over
     the chunks (FWD_FLAT_MAX_FACES raised to FLAT_MAX_FACES) and over the
     tree (FWD_FLAT_MAX_FACES at 0): exact launch counts (the primal twice,
     the reverse kernel once, the refit twice where boxes are read), the
     primal's radiance held to K1a's bound and equal with and without
     records, every cotangent (materials, lights, background, vertices,
     rays) within rtol 1e-3 and atol 1e-4 max|ref|;
 19. the training main path: diff/optimize.py::optimize on the gauge scene
     at 800x800 (one fixed jitter: 640,000 rays), depth 6, fields
     mat_diffuse, pl_intensity and verts (rates diff/optimize.py::
     GAUGE_RATES), 5 Adam steps
     from the true parameters perturbed by a fixed seed toward a target
     rendered by the primal at the true ones, the same draws every step —
     with every counter at 0 before it, the tree primal must launch 6
     times, the reverse kernel 5 times, the refit 6 times and nothing
     else; the loss falls at every step; then optimize's step in a loop of
     its own, one warm-up and the median of 5 timed steps, rays per second
     and the peak device memory;
 20. K2a at the main path's shape (those 640,000 rays): the refit held to
     refit_ref and to the built tree bit for bit, and its device time; the
     device time per launch (torch.profiler) of the tree primal with and
     without its records and of the reverse kernel with and without its
     scatter, and CUDA events around the wrapper; the same on the flat
     sweep (FWD_FLAT_MAX_FACES raised), the tree's radiance equal to the
     flat sweep's bit for bit on every ray and its cotangents within the
     gates; the plain version's time and agreement on every 16th ray; the
     bounds: the primal's the tree walk's tests (TreeWalker's counts on
     every ray, with the boxes, rows and winners read) and the step per
     traced segment and lit light evaluation against the bytes it reads
     and the records it writes; the reverse kernel's the step and its
     adjoint per segment and lit light against the bytes of the records,
     the cotangent, the winners' rows and the cotangents out; the refit's
     the bytes it reads and writes once;
 21. K2b (csrc/mega_bwd.cu's kPt instantiations: path tracing, spot, area
     and mesh lights) against its plain version (autograd) on 16,384
     primary rays at full depth of scenes/feat_pt.xml (and by substitution
     with NEE only and with neither NEE nor importance sampling),
     feat_pt_rr.xml, feat_pt_spec.xml (and with RussianRoulette added),
     feat_spotareaml.xml (Whitted: spot, area, mesh light, emissive), the
     demo scene with its area light, and the demo under PathTracing + NEE
     with its mirror sphere diffuse, each with table draws from a
     torch.Generator and with Philox (against its twin bwd_draws), over the
     chunks and (FWD_FLAT_MAX_FACES at 0) over the tree: K2a's gates;
 22. the path-traced training main path (JAX bench.py --bwd --bwd-scene pt):
     optimize on scenes/feat_pt.xml at 800x800 (one fixed jitter: 640,000
     rays), depth 4, NEE + importance sampling, fields mat_diffuse,
     ml_radiance (feat_pt has no point light) and verts, 5 Adam steps toward
     a target rendered by the primal at the true parameters — with every
     counter at 0 before it, K2b's primal must launch 6 times, its fwd+bwd 5
     times and nothing else; the loss falls at every step; then the step
     in a loop of its own (median of 5 after a warm-up) and rays per second;
     then one value-and-grad of sum(img^2)/n at 1920x1080 (2,073,600 rays,
     JAX main_bwd's grid and loss) on feat_pt.xml, feat_pt_rr.xml and
     feat_pt_spec.xml, the median of 3 after a warm-up;
 23. K2b at the main path's shape (phase 22's 640,000 rays, and the same on
     feat_pt_rr.xml and feat_pt_spec.xml): as phase 20, time per launch of
     the primal, the fwd+bwd and the fwd+bwd without its scatter, and the
     scatter's split by target (the kernel's device time, torch.profiler,
     with every target, none, and each cotangent target alone), the plain
     version's time and agreement on every 16th ray, the tree twins timed
     and held to the flat kernels on every ray, and the bound over the
     chunks and over the tree, with the GI queries and GI samples counted;
 24. K2c (csrc/mega_bwd.cu's kTex instantiations: diffuse image textures)
     against its plain version (autograd) on 16,384 primary rays at full
     depth of the two-texture scene of the JAX texture-gradient test (a
     nearest replace_kd floor, a bilinear blend_kd wall, a mirror sphere),
     of scenes/feat_pt.xml with a bilinear replace_kd floor (path tracing,
     with table draws from a torch.Generator and with Philox) and of the
     inverse-texture quad carrying scenes/textures/floor_tiles.png
     (1,048,576 texels), over the chunks and (FWD_FLAT_MAX_FACES at 0) over
     the tree: K2a's gates, the texel cotangents included;
 25. the slice's main path: the port's tools/inverse_render.py --texture
     (advanced_cpu_raytracing_tpu_torch/tools/inverse_render.py) as the
     JAX artifact's run: 800x800, 4 sample grids, 300 steps, the 64x64 texture from
     flat grey + noise — with every counter at 0 before it, K2c's primal
     must launch (300 + 2) x 4 + 1 times, its fwd+bwd 301 x 4 times and
     nothing else; the loss finite and lower at the last step than at the
     first; the texture's PSNR at most PSNR_MARGIN_DB below the JAX tool's
     artifact's (tools/artifacts/inverse_render_texture.json); the loss
     every 25 steps, the texture's PSNR and max-rel error beside the
     artifact's, wall seconds, steps/s and rays/s;
 26. K2c at the main path's shape (one sample grid's 640,000 rays of the
     64x64 scene): as phase 20, time per launch of the primal, the fwd+bwd,
     the fwd+bwd without its scatter and with the texels alone (the main
     path's call), the scatter's split by target as phase 23, the plain
     version's time and agreement on every 16th ray; the cotangents on
     the floor cut in two quads that read one 8x8 image through a nearest
     and a bilinear texture against the plain version on every 16th ray;
     the tree twins, the bound with the taps and the textured steps
     counted; the path-traced twins timed on the textured feat_pt.xml; the
     fwd+bwd on one sample grid of the 1,048,576-texel quad (the texels'
     warp sums into global memory, as for every pool), its split by target,
     and every cotangent held to the plain version on every 16th ray; then
     one value-and-grad of sum(img^2)/n with respect to img_atlas at
     1920x1080 on that quad, the median of 3 after a warm-up;
 27. K3 (csrc/tri_intersect.cu, the wavefront's dense closest hit)
     against its plain version (ops/tri_intersect.py::tri_closest_hit_ref)
     bit for bit on t, the item index, beta and gamma, on 65,536 rays: the
     camera rays of the slice D1 scene (scene/feature_scenes.py::
     pt_env_dof_scene_xml: scenes/feat_pt.xml with a 1,920-face torus, the
     HDR sky as an environment light and a thin lens; 1,932 work items)
     against its item table and its shadow table, against feat_pt.xml's 12
     items, rays through a random 2,048-item table with det = 0 items and
     exact ties, the motion scene's table with its motion rows and random
     times, and ops/tri_intersect.py::edge_tables on 65,537 rays (the
     edges of the kernel's rejection before its divisions: quotients
     within rounding of 0 and of beta + gamma = 1, ties at the best t,
     determinants outside the trusted range, denormal numerators and
     quotients that round to -0, det = 0, motion);
 28. K3 at the main path's shape (phase 29's 640,000 rays, through the
     lens, against the 1,932 items): time per launch (CUDA events, 5
     launches; and the kernel's device time, torch.profiler), the plain
     version's time on the same rays, and the bound:
     the FP32 operations of every ray x item test (61 each, counted in the
     source) against the bytes of the rays, the table and the results;
 29. the slice's main path: diff/optimize.py::optimize on that scene at
     800x800 (the pixel centres plus one fixed jitter: 640,000 rays), path
     tracing at depth 4 with NEE and importance sampling, fields
     mat_diffuse and ml_radiance at FEAT_PT_RATES, outside the fused
     kernels on two counts (the env light, the lens), so optimize takes
     the wavefront (torch autograd, K3 for every closest-hit and shadow
     query): 6 Adam steps from the true parameters moved off by a fixed
     seed toward the scene's own wavefront render at the true ones, every
     step on the target's draws — with every counter at 0 before it, K3
     must launch and no K1 or K2 kernel; the loss falls at every step;
     then the step in a loop of its own with a fresh draw key per step
     (optimize's default), one warm-up and 5 timed: the median step,
     rays/s, K3's launches per step, the peak memory and the step's time
     outside K3's launches; then one more step (a fresh key) inside
     utils/profiling.py::device_trace (torch.profiler, a Chrome trace in a
     temporary directory): the 15 ops (by input shapes) and the 15
     kernels with the most device time, with their counts, and the step's
     device time split into K3, the autograd pass, the stack and the lights
     (the integrator's wavefront.stack and wavefront.lights ranges), the
     other gathers and scatters, and the other (elementwise) ops, beside
     the timed step;
 30. the wavefront's forward route: render_camera on that scene at depth
     12 (above the megakernel's 10, so mega_missing routes it to the
     wavefront), 800x800: one warm-up frame at 1 spp, then one timed frame
     at 16 spp with the counters at 0 before it (K3 launches, no K1
     kernel), in Mpaths/s; a Welch z-test over 8 per-seed means of the
     depth-4 scene's 1-spp frame through the wavefront against K1d
     (render_camera's megakernel route); and one BVH-strategy closest-hit
     query's time on 65,536 camera rays of scenes/whitted_conductors.xml
     (32,768 faces: the plain-torch walk of ops/traverse.py);
 31. K4 (csrc/bigtex_gather.cu, the big-texture probe's gather-sum)
     against its plain version (ops/bigtex_gather.py::gather_sum_ref), bit
     for bit (NaN lanes alike, each output poisoned before the call), and
     its path counts (groups of 1,024 lanes served through a shared-memory
     window or directly) against gather_plan_ref: on the two
     configurations the JAX probe asserts (512 rows, taps 1, spread 4, 64
     blocks; 8,192 rows, taps 4, spread 16, 512 blocks), its sweep over
     spread 8, 64, 256 with the window and with every group direct, edge
     lanes (index 0, the last index, a tap repeated in a lane, indices
     outside the table), spans of the window and of 16 bytes more beside
     a one-row group, a group with one far lane and a partial last group
     of NaN lanes (in a table past L2: the groups in window order), an
     incoherent configuration (spread 8,190 of 8,192 rows: every group
     direct), a table off 16 bytes and 5 taps (direct), 40,000 groups
     (more than the order kernel stages in shared memory) and the
     frame-size configuration (tools/probe_bigtex.py::FRAME: 10,240,000
     lanes, taps 4, spread 64, 393,216 rows; all 10,000 groups through the
     window, and all direct with window 0); at the frame size K4's time
     per call with L2 flushed (a 256 MB write before each of 64 calls,
     CUDA events, the median) with its window and with every group direct,
     in turns, embedding_bag's (the same function in one PyTorch call)
     time the same way and its error, the plain version's time, the
     device time of each of K4's kernels (torch.profiler), its registers,
     shared memory and blocks an SM, the bound (the indices, the output
     and each touched 32-byte table sector, moved once) and the bytes the
     windows copy;
 32. the slice's main path: the port's tools/probe_bigtex.py::run on the
     card for the JAX probe's __main__ configurations (the two asserted,
     the sweep over spread 8, 64, 256) and the frame-size one — with every
     counter at 0 before it, K4 must launch 1 + 1 + iters times per
     configuration (the check, the warm-up, the timed loop) and nothing
     else; each err within the JAX probe's asserts (1e-6, 1e-5); then,
     outside that count, per configuration the host's µs a call over
     1,000 calls without a synchronise and K4's device time a call
     (torch.profiler), beside run's back-to-back ms and embedding_bag's;
 33. progressive rendering (render/progressive.py): whitted_conductors.xml
     at 800x800 in 16 passes, a checkpoint after the 8th (the .npz in a
     temporary directory) — K1a's tree instantiation must launch exactly
     16 times and nothing else — each of the last 8 passes timed; a fresh
     renderer resumed from the checkpoint must equal the uninterrupted
     one bit for bit; feat_pt.xml in 4 passes through K1b, finite; the
     Philox draw kernel launched once a jittered pass (every pass but the
     first) and once more a pass where the camera has a lens;
 34. the sharded routes (parallel/) in a one-rank NCCL group (the host has
     one card, and NCCL takes one card a rank): render_camera_sharded on
     whitted_conductors.xml at 16 spp equal to render_camera bit for bit
     (16 K1a launches), reinhard_tonemap_sharded equal to
     reinhard_tonemap, make_sharded_diff_step on the gauge scene at
     640,000 rays (phase 19's rays and start) with the unsharded step's
     loss bit for bit and its gradients within K2's tolerance; the
     sharded frame and step timed in turns against the same work
     unsharded (render_camera; the rank's part of the step without its
     all-reduce) and against their joins alone (the all-gather, the
     all-reduce); then parallel/dryrun.py::dryrun_multichip on one
     spawned NCCL rank;
 35. the native PLY reader (native/ply_reader.cpp) against the Python
     reader on scenes/whitted_conductors_mesh.ply, equal, with both host
     times;
 36. the Philox draw kernel (csrc/philox_draws.cu, ops/rng.py::
     PhiloxDraws on the card) against its int64 twin on the CPU, bit for
     bit and one launch a call: the preview's jitter (640,000 rays x 2,
     [0, 1)), its lens draws (x 2, [-1, 1)) and 65,536 rays x 48 env
     candidates of a light; the jitter timed: device time a launch
     (torch.profiler), CUDA events around back-to-back calls, the host's
     us a call over 1,000 calls without a synchronise, beside the twin on
     the card (events, and the device time of all its kernels) and on the
     CPU, and the bound of the bytes written.
The launches of phases 33 and 34 join K1a's, K1b's and K2a's counts in
the kernels line, and phase 33's draw launches the Philox kernel's.
Every phase line carries t_s, the seconds since the script started.
Then the kernels line (each entry with its rays and the plain version's
stride over them), the card line and, last, the result line.  Any
failed check raises and ends the run with a non-zero exit code; without a
CUDA card it exits non-zero before printing any result.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SCENES = ROOT / "scenes"
WHITTED_SCENE = SCENES / "whitted_conductors.xml"
PT_SCENE = SCENES / "feat_pt.xml"
PT_RR_SCENE = SCENES / "feat_pt_rr.xml"
PT_SPEC_SCENE = SCENES / "feat_pt_spec.xml"
LIGHTS_SCENE = SCENES / "feat_lights_brdf.xml"
TEXTURES_SCENE = SCENES / "feat_textures.xml"
REPLACES = "advanced_cpu_raytracing_tpu/ops/pallas/megakernel.py:912"
REPLACES_K2 = "advanced_cpu_raytracing_tpu/ops/pallas/megabwd.py:428"
# the refit of K2's boxes replaces no TPU kernel: the JAX make_diff_render
# builds its boxes once (megabwd.py:1811)
REPLACES_REFIT = ("none: added; the JAX kernel keeps the initial boxes, "
                  "advanced_cpu_raytracing_tpu/ops/pallas/megabwd.py:1811")
# K2c: the texel cotangents of the same kernel (megabwd.py:1484-1564)
REPLACES_K2C = "advanced_cpu_raytracing_tpu/ops/pallas/megabwd.py:1484"
REPLACES_K3 = "advanced_cpu_raytracing_tpu/ops/pallas/tri_intersect.py:39"
REPLACES_K4 = "tools/probe_bigtex.py:31"
# the Philox draw kernel replaces no TPU kernel: the JAX wavefront draws
# with jax.random
REPLACES_DRAWS = ("none: added; the JAX wavefront draws with jax.random "
                  "(advanced_cpu_raytracing_tpu/render/integrator.py)")
# registers of the K1a-K1d, K2, K3 and K4 kernels since they were first
# measured; the later variants' policies (motion, textures, the tree, K2b's
# template flag) must not change their code; K2's tree twins as ptxas gave
# them with the 4-wide walk; K2b's fwd+bwd kernels with the per-target,
# warp-summed scatter and K3 with its rejection before dividing, as ptxas
# gave them; K2a's primal writing its records and its reverse kernel (held
# at 128 by its launch bounds) as ptxas gave them in slice F3; K1b-K1d with
# their draws by the Philox block, K1b capped at 7 blocks an SM (slice F4);
# K4 with its window (slice F5)
KEPT_REGISTERS = {"mega_whitted_kernel": 72, "mega_pt_kernel": 72,
                  "mega_ext_kernel": 89, "mega_ext_motion_kernel": 94,
                  "mega_tex_kernel": 127, "mega_tex_motion_kernel": 127,
                  "mega_bwd_primal_kernel": 88,
                  "mega_bwd_primal_tree_kernel": 96, "mega_bwd_rev_kernel": 128,
                  "mega_bwd_primal_pt_kernel": 80, "mega_bwd_pt_kernel": 158,
                  "mega_bwd_primal_pt_tree_kernel": 96,
                  "mega_bwd_pt_tree_kernel": 168, "tri_intersect_kernel": 50,
                  "bigtex_gather_kernel": 31}
KERNEL_ENTRIES = ("mega_whitted_kernel", "mega_pt_kernel", "mega_ext_kernel",
                  "mega_ext_motion_kernel", "mega_tex_kernel",
                  "mega_tex_motion_kernel", "mega_whitted_tree_kernel",
                  "mega_pt_tree_kernel", "mega_ext_tree_kernel",
                  "mega_ext_motion_tree_kernel", "mega_tex_tree_kernel",
                  "mega_tex_motion_tree_kernel", "mega_bwd_primal_kernel",
                  "mega_bwd_primal_tree_kernel", "mega_bwd_rev_kernel",
                  "mega_bwd_refit_runs_kernel", "mega_bwd_refit_nodes_kernel",
                  "mega_bwd_refit_chunks_kernel", "mega_bwd_primal_pt_kernel",
                  "mega_bwd_pt_kernel", "mega_bwd_primal_pt_tree_kernel",
                  "mega_bwd_pt_tree_kernel", "mega_bwd_primal_tex_kernel",
                  "mega_bwd_tex_kernel", "mega_bwd_primal_tex_tree_kernel",
                  "mega_bwd_tex_tree_kernel", "mega_bwd_primal_pt_tex_kernel",
                  "mega_bwd_pt_tex_kernel",
                  "mega_bwd_primal_pt_tex_tree_kernel",
                  "mega_bwd_pt_tex_tree_kernel", "tri_intersect_kernel",
                  "bigtex_gather_kernel", "bigtex_keys_kernel",
                  "bigtex_order_kernel", "philox_draws_kernel")

# K1a against its plain version (radiance units, the reference's 0..255
# scale): only fp contraction and reassociation at silhouettes may differ —
# the bound of the JAX package's own kernel test
MEAN_TOL, Q999_TOL = 0.01, 0.5
# K1b against its plain version on the same draws: a last-ulp difference
# (libdevice sinf/cosf/expf against torch's) can flip a Russian-roulette
# kill or a GI hit and change that ray by a whole path, so a few rays may
# differ: 99.5% of them within 1e-3 + 1e-3 |ref|, batch means within 1%
PT_ATOL = PT_RTOL = 1e-3
PT_FRAC, PT_MEAN_REL = 0.995, 0.01
# K1c: the same per-ray bound, batch means within 1e-3 relative (its CPU
# tests' bound against the JAX kernel)
EXT_MEAN_REL = 1e-3

# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, and HBM bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# FP32 operations per test, counted in csrc/mega_common.cuh: a ray x
# triangle test up to its t test (the part every test runs), a chunk slab
# test, a sphere test (object-space ray + quadratic)
TRI_FLOPS, SLAB_FLOPS, SPHERE_FLOPS = 38, 22, 66
# motion moves the origin of each test of a moving face or sphere (3 mul +
# 3 add)
MOTION_FLOPS = 6
# K1d, counted in csrc/mega_tex.cuh: a Perlin evaluation (3 scales, 3
# floors, 3 fractions, then per corner of 8: 3 offsets, the gradient dot
# (3 mul + 2 add), three fades (10 each), their product (2) and the
# accumulation (2); the conversion 2); a texel tap (a bilinear sample's
# coordinates, weights and RGB blend over its 4 taps: 44 / 4); an env
# candidate (3 draws to [-1, 1]: 6, the ball test 5, the hemisphere test 5)
PERLIN_FLOPS, TAP_FLOPS, ENV_CAND_FLOPS = 347, 11, 16
# K2a, counted in csrc/mega_bwd.cu (rounded): per traced segment the step's
# forward (hit point, Beer, the background / emission / ambient terms, the
# child's reflection or refraction with its norm3) and its adjoint (the
# Cramer or sphere solve recomputed and reversed, the child's norm3 and
# Fresnel adjoints); per lit light evaluation the light's direction and
# Blinn-Phong (powmax's log and exp counted once each) and their adjoint
STEP_FLOPS, ADJ_STEP_FLOPS = 60, 150
LIGHT_FLOPS, ADJ_LIGHT_FLOPS = 65, 110
# K2b, counted in csrc/mega_bwd.cu (rounded): per GI sample the direction
# (onb with its two norm3, phi's sine and cosine counted once each, the
# combination and its norm3), the GI origin and the child's Blinn-Phong
# weight, and their adjoint (gi_direction_vjp's three norm3_vjp and four
# cross products, shade_unit_vjp, the RR reweight); a spot, area or mesh
# light's term costs about a point light's (LIGHT_FLOPS above)
GI_FLOPS, ADJ_GI_FLOPS = 90, 260
# K2c, counted in csrc/mega_bwd.cu (rounded): per textured step the
# barycentrics, uv and tile_uv (TEX_FLOPS) and their adjoint beside the
# Cramer one's (ADJ_TEX_FLOPS); per tap the weight and RGB blend (TAP_FLOPS
# above) and its adjoint, the weight's cotangent and three scattered texel
# cotangents (ADJ_TAP_FLOPS)
TEX_FLOPS, ADJ_TEX_FLOPS, ADJ_TAP_FLOPS = 45, 70, 12
# K3, counted in csrc/tri_intersect.cu: per ray x item test the 3
# differences of b, the 27 products and differences of the three cross
# terms, the 15 of the three determinants, the 3 divisions, beta + gamma and
# 7 comparisons; motion adds 6
K3_TEST_FLOPS, K3_MOTION_FLOPS = 61, 6
# phase 30: the wavefront's frame against K1d's in expectation
WELCH_Z, WELCH_SEEDS = 4.0, 8
# K2a against its plain version: the cotangents are sums whose atomic order
# changes from run to run, and the hand-derived adjoint rounds otherwise
# than autograd
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-3, 1e-4
# phase 25: how far the recovered texture's PSNR may fall below the JAX
# tool's artifact (tools/artifacts/inverse_render_texture.json)
PSNR_MARGIN_DB = 1.0


T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **kw, "t_s": time.perf_counter() - T0}),
          flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def exact_frac(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The share of rays whose radiance equals the plain version's bit for
    bit."""
    return float((got == ref).all(dim=1).double().mean())


def check_close(got: torch.Tensor, ref: torch.Tensor, what: str) -> dict:
    diff = (got - ref).abs().flatten().double()
    err = {"max_abs_err": float(diff.max()),
           "exact_frac": exact_frac(got, ref),
           "mean_abs_err": float(diff.mean()),
           "q999_abs_err": float(torch.quantile(diff, 0.999))}
    if not (torch.isfinite(got).all() and err["mean_abs_err"] < MEAN_TOL
            and err["q999_abs_err"] < Q999_TOL):
        raise AssertionError(f"{what}: kernel disagrees with plain: {err}")
    return err


def check_close_pt(got: torch.Tensor, ref: torch.Tensor, what: str,
                   mean_rel: float = PT_MEAN_REL) -> dict:
    diff = (got - ref).abs()
    within = (diff <= PT_ATOL + PT_RTOL * ref.abs()).all(dim=1)
    m_got, m_ref = float(got.double().mean()), float(ref.double().mean())
    err = {"max_abs_err": float(diff.max()),
           "frac_within": float(within.double().mean()),
           "exact_frac": exact_frac(got, ref),
           "mean": m_got, "plain_mean": m_ref}
    if not (torch.isfinite(got).all() and err["frac_within"] >= PT_FRAC
            and abs(m_got - m_ref) <= mean_rel * abs(m_ref)):
        raise AssertionError(f"{what}: kernel disagrees with plain: {err}")
    return err


def cuda_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str, reps: int = 10, tries: int = 3,
              split: bool = False):
    """The device time per call of the kernels whose name holds
    ``kernel``, each launched once per call (torch.profiler over ``reps``
    calls after one warm-up): each kernel's own time, without the
    wrapper's host work between launches, averaged over the launches the
    profile caught (a profile may drop some of them, so a sum over ``reps``
    would read low); with ``split``, a dict of each kernel's time by name
    beside their sum ("total").  A profile that caught no such kernel is
    taken again, up to ``tries`` times, and then raises: a time of 0 is
    never reported."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [r for r in prof.key_averages()
                if r.device_type == DeviceType.CUDA and kernel in r.key
                and r.count]
        if rows:
            each = {r.key: r.device_time_total / r.count / 1e3 for r in rows}
            total = sum(each.values())
            return {**each, "total": total} if split else total
    raise AssertionError(f"device_ms: the profiler caught no {kernel} kernel "
                         f"in {tries} profiles")


def bound(stats: dict, n_bytes: int) -> dict:
    """The least time for the counted FP32 work and the bytes moved."""
    flops = (stats.get("tri_tests", 0) * TRI_FLOPS
             + stats.get("slab_tests", 0) * SLAB_FLOPS
             + stats.get("sphere_tests", 0) * SPHERE_FLOPS
             + (stats.get("tri_motion_tests", 0)
                + stats.get("sphere_motion_tests", 0)) * MOTION_FLOPS
             + stats.get("perlin_evals", 0) * PERLIN_FLOPS
             + stats.get("texel_taps", 0) * TAP_FLOPS
             + stats.get("env_candidates", 0) * ENV_CAND_FLOPS)
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    return {"flops": flops, "bytes": n_bytes, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def entry_of(mc) -> str:
    """The CUDA entry function that ``mega_trace`` launches for the tables
    ``mc``: K1c and K1d scenes with motion take the motion instantiation."""
    motion = "_motion" if mc.has_motion and mc.kernel in (
        "mega_ext", "mega_tex") else ""
    tree = "_tree" if mc.tree is not None else ""
    return f"{mc.kernel}{motion}{tree}_kernel"


def registers(ptxas: str) -> dict:
    """kernel -> {registers, stack frame, spill stores, spill loads} from
    ptxas -v's lines, by the entry function they follow."""
    out, name = {}, None
    for ln in ptxas.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\w+)", ln)
        if m:
            name = next((k for k in KERNEL_ENTRIES if k in m.group(1)), None)
            continue
        if name is None:
            continue
        ent = out.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            ent.update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            ent["registers"] = int(m.group(1))
    return out


# ops whose kernels read or write at computed indices (the gathers and
# scatters of the shading's table lookups; the stack's own are under its
# range)
GATHER_OPS = frozenset((
    "aten::index", "aten::index_select", "aten::gather", "aten::take",
    "aten::take_along_dim", "aten::scatter", "aten::scatter_",
    "aten::scatter_add", "aten::scatter_add_", "aten::index_put",
    "aten::index_put_", "aten::_index_put_impl_", "aten::index_add",
    "aten::index_add_", "aten::index_copy_", "aten::index_fill_",
    "aten::masked_scatter_", "aten::masked_select", "aten::nonzero",
    "aten::embedding"))
SPLIT_PARTS = ("K3", "autograd pass", "stack (wavefront.stack)",
               "lights (wavefront.lights)", "other gathers and scatters",
               "elementwise and other ops", "other kernels")


def device_split(prof) -> dict:
    """A traced section's device time in ms by part, each kernel counted
    once: K3's kernels; the kernels of ops under an autograd engine node
    (the reverse pass); then, of the forward's ops, those inside the
    integrator's ``wavefront.stack`` and ``wavefront.lights`` ranges, the
    other gathers and scatters (GATHER_OPS and the ops under them), and the
    rest (mostly elementwise); and kernels that no op launched."""
    from torch.autograd import DeviceType

    ms = dict.fromkeys(SPLIT_PARTS, 0.0)
    kernels_us = 0.0
    for e in prof.events():
        if e.is_user_annotation:  # a range, not a kernel
            continue
        if e.device_type == DeviceType.CUDA:
            kernels_us += e.device_time_total
            if "tri_intersect" in e.name:
                ms["K3"] += e.device_time_total / 1e3
            continue
        own = e.self_device_time_total - sum(
            k.duration for k in e.kernels if "tri_intersect" in k.name)
        if own <= 0:
            continue
        names, p = [], e
        while p is not None:
            names.append(p.name)
            p = p.cpu_parent
        if any(n.startswith("autograd::engine::evaluate_function")
               for n in names):
            part = "autograd pass"
        elif "wavefront.stack" in names:
            part = "stack (wavefront.stack)"
        elif "wavefront.lights" in names:
            part = "lights (wavefront.lights)"
        elif any(n in GATHER_OPS for n in names):
            part = "other gathers and scatters"
        else:
            part = "elementwise and other ops"
        ms[part] += own / 1e3
    ms["other kernels"] = kernels_us / 1e3 - sum(ms.values())
    return {"total_device_ms": kernels_us / 1e3, "parts_ms": ms}


def top_device(prof, n: int = 15) -> dict:
    """The ``n`` ops (by the device time of their own kernels, per input
    shapes) and the ``n`` kernels with the most device time, with their
    counts."""
    from torch.autograd import DeviceType

    ops = sorted((r for r in prof.key_averages(group_by_input_shape=True)
                  if r.device_type == DeviceType.CPU
                  and r.self_device_time_total > 0),
                 key=lambda r: -r.self_device_time_total)[:n]
    kern = sorted((r for r in prof.key_averages()
                   if r.device_type == DeviceType.CUDA
                   and not r.is_user_annotation),
                  key=lambda r: -r.device_time_total)[:n]
    return {"ops": [{"op": r.key[:100], "shapes": str(r.input_shapes)[:160],
                     "count": r.count,
                     "device_ms": r.self_device_time_total / 1e3}
                    for r in ops],
            "kernels": [{"kernel": r.key[:100], "count": r.count,
                         "device_ms": r.device_time_total / 1e3}
                        for r in kern]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from advanced_cpu_raytracing_tpu_torch.diff.optimize import (
        FEAT_PT_RATES,
        GAUGE_RATES,
        optimize,
        wavefront_value_and_grad,
    )
    from advanced_cpu_raytracing_tpu_torch.diff.params import inject_params
    from advanced_cpu_raytracing_tpu_torch.ops import _build
    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb
    from advanced_cpu_raytracing_tpu_torch.ops import megakernel as mk
    from advanced_cpu_raytracing_tpu_torch.ops import rng as wrng
    from advanced_cpu_raytracing_tpu_torch.ops import bigtex_gather as k4
    from advanced_cpu_raytracing_tpu_torch.ops import traverse
    from advanced_cpu_raytracing_tpu_torch.ops import tri_intersect as k3
    from advanced_cpu_raytracing_tpu_torch.ops.rng import philox_table
    from advanced_cpu_raytracing_tpu_torch.post.writers import write_png
    from advanced_cpu_raytracing_tpu_torch.render import renderer
    from advanced_cpu_raytracing_tpu_torch.render.camera import (
        build_camera,
        generate_rays,
    )
    from advanced_cpu_raytracing_tpu_torch.render.integrator import (
        trace_radiance,
    )
    from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import (
        AREA_DEMO_XML,
        COARSE_TORUS,
        ENV_ALIGNED_LIGHTS,
        K1D_SAMPLED,
        MOTION_ROUGH_XML,
        PT_ENV_TORUS,
        gauge_scene_xml,
        env_aligned_xml,
        k1c_scenes,
        k1d_scenes,
        path_traced,
        ply_bytes,
        pt_env_dof_scene_xml,
        tex_bwd_scene_xml,
        shared_image_scene_xml,
        texture_inverse_scene_xml,
        textured_pt_scene_xml,
        torus_mesh,
    )
    from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu_torch.scene.synth import terrain_scene
    from advanced_cpu_raytracing_tpu_torch.scene.types import SceneConfig
    from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
    from advanced_cpu_raytracing_tpu_torch.tools import inverse_render, probe_bigtex
    from advanced_cpu_raytracing_tpu_torch.utils import profiling
    import torch.distributed as dist

    from advanced_cpu_raytracing_tpu_torch.native.bindings import load_ply_native
    from advanced_cpu_raytracing_tpu_torch.parallel import mesh as pmesh
    from advanced_cpu_raytracing_tpu_torch.parallel import shard_render
    from advanced_cpu_raytracing_tpu_torch.parallel.dryrun import dryrun_multichip
    from advanced_cpu_raytracing_tpu_torch.post.tonemap import (
        reinhard_tonemap,
        reinhard_tonemap_sharded,
    )
    from advanced_cpu_raytracing_tpu_torch.render.progressive import (
        ProgressiveRenderer,
    )
    from advanced_cpu_raytracing_tpu_torch.scene.ply import load_ply_python

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_"))

    # 1. probe
    card = card_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    emit("probe", card=card, torch=torch.__version__,
         torch_cuda=torch.version.cuda, nvcc=nvcc.stdout.strip().splitlines()[-1],
         device_count=torch.cuda.device_count())

    def reset_counts():
        for table in (mk.LAUNCHES, mb.LAUNCHES, k3.LAUNCHES, k4.LAUNCHES):
            for k in table:
                table[k] = 0

    def counts() -> dict:
        """Every kernel's launches since ``reset_counts``: K1's, K2's, K3's
        and K4's."""
        return {**mk.LAUNCHES, **mb.LAUNCHES, **k3.LAUNCHES, **k4.LAUNCHES}

    # 2. build every source in parallel
    t0 = time.perf_counter()
    libs = sorted(set(mk.LIBRARY.values())
                  | {mb.LIBRARY, k3.LIBRARY, k4.LIBRARY, wrng.LIBRARY})
    _build.build_all(libs)
    regs = {}
    for name in libs:
        log = _build.BUILD_LOG[name]
        regs.update(registers(log["ptxas"]))
        emit("build", library=name, seconds=log["seconds"], cached=log["cached"],
             wall_seconds_all=time.perf_counter() - t0,
             ptxas=[ln for ln in log["ptxas"].splitlines() if "registers" in ln
                    or "spill" in ln or "stack frame" in ln])
    emit("registers", kernels=regs, kept=KEPT_REGISTERS)
    for kern, n in KEPT_REGISTERS.items():
        if regs.get(kern, {}).get("registers") != n:
            raise AssertionError(f"{kern}: {regs.get(kern)}, expected {n} "
                                 f"registers")

    def kernel_entry(name, launches, kernel_ms, plain_ms, bd, err, rays,
                     stride, library=None, replaces=REPLACES):
        """One kernel's entry of the kernels line; plain_ms is the plain
        version's time on every ``stride``-th of the ``rays`` rays."""
        return {"name": name, "route": "cuda",
                "source": f"advanced_cpu_raytracing_tpu_torch/csrc/"
                          f"{library or mk.LIBRARY[name]}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err["max_abs_err"], "ms": kernel_ms,
                "plain_ms": plain_ms, "bound_ms": bd["bound_ms"],
                "bound_by": bd["bound_by"], "library_ms": None, "rays": rays,
                "plain_stride": stride, "plain_rays": -(-rays // stride),
                **{k: bd[k] for k in ("device_ms", "draws_per_ray",
                                      "philox_blocks_per_ray") if k in bd}}

    def scene(path_or_xml, name=None):
        """A scene file, an XML text (written to ``name``) or a
        SceneConfig, packed on the card with its tables."""
        if name is not None:  # an XML text: write it beside nothing else
            path = out_dir / name
            path.write_text(path_or_xml)
            path_or_xml = path
        cfg = (path_or_xml if isinstance(path_or_xml, SceneConfig)
               else load_scene(str(path_or_xml)))
        pack = pack_scene(cfg, device=dev)
        cam_cfg = cfg.cameras[0]
        opts = renderer.options_for_camera(cfg, cam_cfg)
        tabs = renderer._mega_build_cached(pack, opts, dev)
        return cfg, pack, cam_cfg, tabs, build_camera(cam_cfg, device=dev)

    def flat_tables(cfg, pack, cam_cfg):
        """The flat chunk sweep's tables of a scene that routes to the
        tree: build_mega with FLAT_MAX_FACES, its default (the forward
        route's and K2's earlier threshold)."""
        mc, tri, chunk = mk.build_mega(
            pack, renderer.options_for_camera(cfg, cam_cfg), device=dev)
        if mc.tree is not None:
            raise AssertionError(f"{mc.variant}: not the flat sweep")
        return mc, tri, chunk

    def primary_rays(cam_cfg, cam, n, seed=0):
        rng = np.random.default_rng(seed)
        px = torch.as_tensor(rng.uniform(0, cam_cfg.width, n).astype(np.float32),
                             device=dev)
        py = torch.as_tensor(rng.uniform(0, cam_cfg.height, n).astype(np.float32),
                             device=dev)
        o, d = generate_rays(cam, px, py)
        return o.contiguous(), d.contiguous()

    def sample_rays(cam_cfg, cam, spp):
        """The rays of one jittered sample of the whole frame, through the
        thin lens where the camera has one."""
        w, h = cam_cfg.width, cam_cfg.height
        idx = torch.arange(w * h, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        jit = torch.rand((w * h, 2), generator=gen, device=dev) / math.isqrt(spp)
        lens = (torch.rand((w * h, 2), generator=gen, device=dev) * 2.0 - 1.0
                if cam.use_dof else None)
        o, d = generate_rays(cam, (idx % w).float() + jit[:, 0],
                             (idx // w).float() + jit[:, 1], lens,
                             dof=cam.use_dof)
        return o.contiguous(), d.contiguous()

    def main_path(pack, cfg, cam_cfg, kernel: str, what: str) -> dict:
        """One checked u8 frame with the counters at 0 before it, then a
        warm-up and the median of 3 timed frames."""
        spp = cam_cfg.num_samples
        reset_counts()
        img = renderer.render_camera(pack, cfg, cam_cfg, seed=0, ldr=True,
                                     device=dev)
        launches = counts()
        want = {k: (spp if k == kernel else 0) for k in launches}
        if launches != want:
            raise AssertionError(f"{what}: launches {launches}, expected {want}")
        w, h = cam_cfg.width, cam_cfg.height
        if img.shape != (h, w, 3) or img.dtype != np.uint8 or not (
                5.0 < float(img.mean()) < 250.0):
            raise AssertionError(f"{what}: bad frame: {img.shape} {img.dtype} "
                                 f"mean {img.mean()}")
        png = out_dir / f"{kernel}_{cam_cfg.image_name}"
        write_png(str(png), img)
        hdr = renderer.render_camera(pack, cfg, cam_cfg, seed=1, device=dev)
        if not np.isfinite(hdr).all():
            raise AssertionError(f"{what}: non-finite radiance")

        def frame(seed):
            return renderer.render_camera(pack, cfg, cam_cfg, seed=seed,
                                          ldr=True, device=dev)

        frame(2)  # warm-up
        times = []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame(3 + i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        frame_s = sorted(times)[1]
        return dict(width=w, height=h, spp=spp, depth=cfg.max_recursion_depth,
                    launches=launches[kernel], frame_s_median=frame_s,
                    frame_s_all=times, mpaths_per_s=w * h * spp / frame_s / 1e6,
                    u8_mean=float(img.mean()), png=str(png), card=card)

    def table_bytes(mc, tabs, reads=None):
        """The bytes of the tables the kernel must read, each once.  A tree
        scene's kernel reads only what its walk reaches (``reads``, the
        masks TreeWalker leaves in the plain version's stats): the boxes of
        the nodes visited, the vertex columns (and motion) of the rows
        tested, and the winners' rows of the per-face tables (the emissive
        flag a shadow query reads on a hit is left out)."""
        tables = [mc.spheres, mc.materials, mc.point_lights, mc.dir_lights,
                  mc.ml_faces, mc.ml_lights]
        n_bytes = 0
        tree = mc.tree is not None
        if tree:
            rows, won = reads["rows"], int(reads["won"].sum())
            # per winner: the normal, the material and the mesh-light id
            n_bytes += (int(reads["nodes"].sum()) * mk.NODE_COLS
                        + int(rows.sum()) * 9 + won * 5) * 4
        else:
            tables += list(tabs)
        if mc.kernel in ("mega_ext", "mega_tex"):
            tables += [mc.spot_lights, mc.area_lights, mc.mat_ext]
            # a motion table that moves nothing is not read
            if mc.faces_move and tree:
                moving = (mc.tri_motion != 0).any(dim=1)
                n_bytes += int((rows[:moving.shape[0]] & moving).sum()) * 3 * 4
            elif mc.faces_move:
                tables.append(mc.tri_motion)
            tables += [mc.sph_motion] if mc.spheres_move else []
        if mc.kernel == "mega_tex":
            # the texel pool and the texture tables, each read once
            tables += [mc.texels, mc.tex_sph, mc.tex_int, mc.tex_flt, mc.perm]
            if tree:
                n_bytes += won * mc.tex_face.shape[1] * 4
            else:
                tables.append(mc.tex_face)
        return n_bytes + sum(t.numel() * 4 for t in tables)

    def at_main_shape(mc, tri_tab, chunk_tab, cam_cfg, cam, kernel, what,
                      stride=1, count_chunk=None):
        """The kernel on one sample's rays (Philox): ms per launch, the
        plain version's time and error on the same rays and draws (every
        ``stride``-th ray), and the bound of the counted work (the plain
        version's counts times ``stride``; with ``count_chunk``, counted on
        every ray in runs of its own of that many rays, so that the tree
        walker's counting stays out of plain_ms and the rows it reads are
        those of every ray)."""
        o, d = sample_rays(cam_cfg, cam, cam_cfg.num_samples)
        got = mk.mega_trace(mc, tri_tab, chunk_tab, o, d, seed=0, sample=0)
        kernel_ms = cuda_ms(lambda: mk.mega_trace(mc, tri_tab, chunk_tab, o, d,
                                                  seed=0, sample=0), 5)
        # the kernel's own device time, without the wrapper's host work
        dev_ms = device_ms(lambda: mk.mega_trace(mc, tri_tab, chunk_tab, o, d,
                                                 seed=0, sample=0),
                           entry_of(mc))
        n_rays = o.shape[0]
        stats: dict = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        draws = (philox_table(0, 0, n_rays, mc.max_iters, mc.n_draws,
                              device=dev)[:, ::stride].contiguous()
                 if mc.n_draws else None)
        o_all, d_all = o, d
        o, d, got = (t[::stride].contiguous() for t in (o, d, got))
        ref = mk.mega_trace_ref(mc, tri_tab, chunk_tab, o, d, draws=draws,
                                stats=None if count_chunk else stats)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        del draws
        count_stride = stride
        if count_chunk:
            table = (philox_table(0, 0, n_rays, mc.max_iters, mc.n_draws,
                                  device=dev) if mc.n_draws else None)
            for lo in range(0, n_rays, count_chunk):
                part = slice(lo, lo + count_chunk)
                mk.mega_trace_ref(
                    mc, tri_tab, chunk_tab, o_all[part].contiguous(),
                    d_all[part].contiguous(), stats=stats,
                    draws=None if table is None
                    else table[:, part].contiguous())
            del table
            count_stride = 1
        reads = stats.pop("reads", None)
        if not mc.n_draws:
            err = check_close(got, ref, what)
        else:
            err = check_close_pt(got, ref, what, EXT_MEAN_REL if mc.kernel in (
                "mega_ext", "mega_tex") else PT_MEAN_REL)
        bd = bound({k: v * count_stride for k, v in stats.items()},
                   n_rays * 9 * 4 + table_bytes(mc, (tri_tab, chunk_tab), reads))
        if reads is not None:
            stats.update(nodes_read=int(reads["nodes"].sum()),
                         rows_read=int(reads["rows"].sum()),
                         rows_won=int(reads["won"].sum()))
        plain_stride = -(-n_rays // o.shape[0])
        # Philox4x32-10 evaluations per ray in counter mode: one per draw
        # before the kernels' per-node cursor (PRs 2-13), one per block the
        # cursor computes since
        bd["draws_per_ray"] = stats.get("draws", 0) * count_stride / n_rays
        bd["philox_blocks_per_ray"] = (stats.get("philox_blocks", 0)
                                       * count_stride / n_rays)
        bd["device_ms"] = dev_ms
        emit("kernel_at_main_shape", kernel=kernel, rays=n_rays,
             plain_stride=plain_stride, count_stride=count_stride,
             kernel_ms=kernel_ms, plain_ms=plain_ms, **bd, **err, **stats,
             card=card)
        return kernel_ms, plain_ms, bd, err, n_rays, plain_stride

    kernels = []

    # ---- K1a: the Whitted path ----
    cfg, pack, cam_cfg, (mc, tri_tab, chunk_tab), cam = scene(WHITTED_SCENE)

    # 3. kernel vs plain on 65,536 primary rays (1 spp, no DoF), and on a
    # ray along -z in the plane y = -10 of chunk 0's box and of leaf boxes,
    # the room's floor: (lo - p) * inf = NaN there, and the walk must keep
    # the boxes to reach the back wall's bottom edge at t = 35 (the JAX
    # chunk_sweep drops such a box)
    if mc.variant != "mega_whitted_tree":
        raise AssertionError(f"the Whitted scene routed to {mc.variant}")
    o, d = primary_rays(cam_cfg, cam, 65536)
    if float(chunk_tab[0, 1]) != -10.0 or not bool(
            (mc.tree[:, mk.TREE_WIDTH:2 * mk.TREE_WIDTH] == -10.0).any()):
        raise AssertionError(f"chunk 0's box: {chunk_tab[0].tolist()}")
    o = torch.cat([o, torch.tensor([[3.3, -10.0, 25.0]], device=dev)])
    d = torch.cat([d, torch.tensor([[0.0, 0.0, -1.0]], device=dev)])
    got = mk.mega_trace(mc, tri_tab, chunk_tab, o, d)
    flat = mk.mega_trace(*flat_tables(cfg, pack, cam_cfg), o, d)
    torch.cuda.synchronize()
    ref = mk.mega_trace_ref(mc, tri_tab, chunk_tab, o, d)
    err = check_close(got, ref, "K1a, 65,536 primary rays")
    err_flat = check_close(flat, ref, "K1a's flat sweep, 65,536 primary rays")
    plane = {"kernel": got[-1].tolist(), "flat": flat[-1].tolist(),
             "plain": ref[-1].tolist()}
    if not ((got[-1] == ref[-1]).all() and (flat[-1] == ref[-1]).all()
            and float(ref[-1].sum()) > 0.0):
        raise AssertionError(f"K1a, the ray in the floor's plane: {plane}")
    emit("kernel_vs_plain", kernel=mc.variant, scene=WHITTED_SCENE.name,
         rays=o.shape[0], **err, flat_sweep=err_flat, in_plane_ray=plane,
         mean_tol=MEAN_TOL, q999_tol=Q999_TOL)
    del flat

    # 4. the Whitted main path
    mp = main_path(pack, cfg, cam_cfg, "mega_whitted_tree",
                   "Whitted main path")
    emit("main_path", kernel="mega_whitted_tree", scene=WHITTED_SCENE.name,
         **mp)

    # 5. K1a at the main path's shape: one sample's 640,000 rays; the plain
    # version and the walk's count on every 8th
    kernel_ms, plain_ms, bd, err, n_rays, stride = at_main_shape(
        mc, tri_tab, chunk_tab, cam_cfg, cam, "mega_whitted_tree",
        "K1a, 640,000 rays of one sample", stride=8)
    kernels.append(kernel_entry("mega_whitted_tree", mp["launches"], kernel_ms,
                                plain_ms, bd, err, n_rays, stride))

    # ---- K1b: the path-tracing path ----
    # 6. kernel vs plain on 65,536 primary rays, both draw modes
    pt_xml = PT_SCENE.read_text()
    variants = [
        ("feat_pt.xml", PT_SCENE, None),
        ("feat_pt_rr.xml", SCENES / "feat_pt_rr.xml", None),
        ("feat_pt_spec.xml", SCENES / "feat_pt_spec.xml", None),
        ("feat_pt.xml, Whitted + LightMesh",
         re.sub(r"<Renderer>.*?</RendererParams>", "", pt_xml, flags=re.S),
         "whitted_meshlight.xml"),
    ]
    for label, src, name in variants:
        _, _, v_cam_cfg, (vmc, vtri, vchunk), vcam = scene(src, name)
        if vmc.kernel != "mega_pt":
            raise AssertionError(f"{label}: routed to {vmc.kernel}")
        o, d = primary_rays(v_cam_cfg, vcam, 65536, seed=1)
        rows = vmc.max_iters * vmc.n_draws
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        for mode, draws in (
                ("table", torch.rand((rows, o.shape[0]), generator=gen,
                                     device=dev)),
                ("philox", None)):
            got = mk.mega_trace(vmc, vtri, vchunk, o, d, draws=draws, seed=9,
                                sample=3)
            torch.cuda.synchronize()
            if draws is None:
                draws = philox_table(9, 3, o.shape[0], vmc.max_iters,
                                     vmc.n_draws, device=dev)
            ref = mk.mega_trace_ref(vmc, vtri, vchunk, o, d, draws=draws)
            err = check_close_pt(got, ref, f"K1b, {label}, {mode}")
            emit("kernel_vs_plain", kernel="mega_pt", scene=label, draws=mode,
                 rays=o.shape[0], max_iters=vmc.max_iters, stack_k=vmc.stack_k,
                 n_draws=vmc.n_draws, **err, atol=PT_ATOL, rtol=PT_RTOL,
                 frac_tol=PT_FRAC, mean_rel_tol=PT_MEAN_REL)
        del draws

    # 7. the path-tracing main path, then one frame of RR and of specular PT
    cfg, pack, cam_cfg, (mc, tri_tab, chunk_tab), cam = scene(PT_SCENE)
    mp = main_path(pack, cfg, cam_cfg, "mega_pt", "path-tracing main path")
    emit("main_path", kernel="mega_pt", scene=PT_SCENE.name, **mp)
    for name in ("feat_pt_rr.xml", "feat_pt_spec.xml"):
        v_cfg, v_pack, v_cam_cfg, _, _ = scene(SCENES / name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hdr = renderer.render_camera(v_pack, v_cfg, v_cam_cfg, seed=0,
                                     device=dev)
        frame_s = time.perf_counter() - t0
        ldr = renderer.ldr_from_radiance(hdr)
        if not (np.isfinite(hdr).all() and hdr.min() >= 0.0
                and 5.0 < float(ldr.mean()) < 250.0):
            raise AssertionError(f"{name}: bad frame: finite "
                                 f"{np.isfinite(hdr).all()}, min {hdr.min()}, "
                                 f"u8 mean {ldr.mean()}")
        write_png(str(out_dir / f"mega_pt_{name}.png"), ldr)
        emit("frame", kernel="mega_pt", scene=name, spp=v_cam_cfg.num_samples,
             frame_s=frame_s, u8_mean=float(ldr.mean()),
             radiance_mean=float(hdr.mean()), card=card)

    # 8. K1b at the main path's shape: one sample's 640,000 rays, Philox
    kernel_ms, plain_ms, bd, err, n_rays, stride = at_main_shape(
        mc, tri_tab, chunk_tab, cam_cfg, cam, "mega_pt",
        "K1b, 640,000 rays of one sample")
    kernels.append(kernel_entry("mega_pt", mp["launches"], kernel_ms, plain_ms,
                                bd, err, n_rays, stride))

    # ---- K1c: spot and area lights, BRDFs, roughness, motion ----
    # 9. kernel vs plain on 65,536 primary rays, both draw modes
    # the path-traced feat_lights_brdf.xml, the script's longest check,
    # on every 2nd of the 65,536 rays
    variants = [(name, xml, f"{name}.xml", 1)
                for name, xml in k1c_scenes(SCENES).items()]
    variants += [
        ("feat_lights_brdf.xml", LIGHTS_SCENE, None, 1),
        ("feat_lights_brdf.xml, path tracing",
         path_traced(LIGHTS_SCENE.read_text()), "feat_lights_brdf_pt.xml", 2)]
    # the path-tracing variant is written to out_dir, beside its mesh
    (out_dir / "whitted_conductors_mesh.ply").symlink_to(
        SCENES / "whitted_conductors_mesh.ply")
    for label, src, name, stride in variants:
        v_cfg, v_pack, v_cam_cfg, (vmc, vtri, vchunk), vcam = scene(src, name)
        if vmc.kernel != "mega_ext":
            raise AssertionError(f"{label}: routed to {vmc.kernel}")
        v_flat = (flat_tables(v_cfg, v_pack, v_cam_cfg)
                  if vmc.tree is not None else None)
        o, d = (t[::stride].contiguous()
                for t in primary_rays(v_cam_cfg, vcam, 65536, seed=2))
        rows = vmc.max_iters * vmc.n_draws
        gen = torch.Generator(device=dev)
        gen.manual_seed(6)
        for mode, draws in (
                ("table", torch.rand((rows, o.shape[0]), generator=gen,
                                     device=dev) if rows else None),
                ("philox", None)):
            got = mk.mega_trace(vmc, vtri, vchunk, o, d, draws=draws, seed=11,
                                sample=4)
            flat = (None if v_flat is None else mk.mega_trace(
                *v_flat, o, d, draws=draws, seed=11, sample=4))
            torch.cuda.synchronize()
            if draws is None and rows:
                draws = philox_table(11, 4, o.shape[0], vmc.max_iters,
                                     vmc.n_draws, device=dev)
            ref = mk.mega_trace_ref(vmc, vtri, vchunk, o, d, draws=draws)
            err = check_close_pt(got, ref, f"K1c, {label}, {mode}",
                                 EXT_MEAN_REL)
            if flat is not None:
                err["flat_sweep"] = check_close_pt(
                    flat, ref, f"K1c's flat sweep, {label}, {mode}",
                    EXT_MEAN_REL)
            emit("kernel_vs_plain", kernel=vmc.variant, scene=label, draws=mode,
                 rays=o.shape[0], stride=stride, max_iters=vmc.max_iters,
                 stack_k=vmc.stack_k,
                 n_draws=vmc.n_draws, **err, atol=PT_ATOL, rtol=PT_RTOL,
                 frac_tol=PT_FRAC, mean_rel_tol=EXT_MEAN_REL)
        del draws

    # 10. the K1c main path, then one frame of its path-tracing variant
    cfg, pack, cam_cfg, (mc, tri_tab, chunk_tab), cam = scene(LIGHTS_SCENE)
    mp = main_path(pack, cfg, cam_cfg, "mega_ext_tree", "K1c main path")
    emit("main_path", kernel="mega_ext_tree", scene=LIGHTS_SCENE.name, **mp)
    v_cfg, v_pack, v_cam_cfg, _, _ = scene(variants[-1][1], variants[-1][2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hdr = renderer.render_camera(v_pack, v_cfg, v_cam_cfg, seed=0, device=dev)
    frame_s = time.perf_counter() - t0
    ldr = renderer.ldr_from_radiance(hdr)
    if not (np.isfinite(hdr).all() and hdr.min() >= 0.0
            and 5.0 < float(ldr.mean()) < 250.0):
        raise AssertionError(f"K1c path-tracing frame: finite "
                             f"{np.isfinite(hdr).all()}, min {hdr.min()}, "
                             f"u8 mean {ldr.mean()}")
    write_png(str(out_dir / "mega_ext_feat_lights_brdf_pt.png"), ldr)
    emit("frame", kernel="mega_ext_tree",
         scene="feat_lights_brdf.xml, path tracing",
         spp=v_cam_cfg.num_samples, frame_s=frame_s, u8_mean=float(ldr.mean()),
         radiance_mean=float(hdr.mean()), card=card)

    # 11. K1c at the main path's shape: one sample's 640,000 rays, Philox;
    # the plain version and the walk's count on every 8th
    kernel_ms, plain_ms, bd, err, n_rays, stride = at_main_shape(
        mc, tri_tab, chunk_tab, cam_cfg, cam, "mega_ext_tree",
        "K1c, 640,000 rays of one sample", stride=8)
    kernels.append(kernel_entry("mega_ext_tree", mp["launches"], kernel_ms,
                                plain_ms, bd, err, n_rays, stride))

    # ---- K1d: textures and the environment light ----
    # 12. kernel vs plain on 65,536 primary rays, both draw modes
    tex_dir = out_dir / "k1d"
    variants = [(name, xml, name in K1D_SAMPLED, tex_dir / f"{name}.xml", 1)
                for name, xml in k1d_scenes(tex_dir, SCENES).items()]
    # the env candidates' draws from each word of a Philox block on: the
    # kernel's cursor crosses block edges at every offset
    variants += [(f"env_aligned{a}", env_aligned_xml(a), True,
                  tex_dir / f"env_aligned{a}.xml", 1)
                 for a in sorted(ENV_ALIGNED_LIGHTS)]
    # the main path's scene beside its mesh and textures, Whitted and PT;
    # the plain version's path tracing at depth 4 (247 node iterations over
    # 257 chunks) takes minutes on all 65,536 rays, so its PT check runs on
    # every 4th of them
    main_dir = out_dir / "feat_textures"
    main_dir.mkdir()
    for name in ("whitted_conductors_mesh.ply", "textures"):
        (main_dir / name).symlink_to(SCENES / name)
    tex_xml = TEXTURES_SCENE.read_text()
    variants += [
        ("feat_textures.xml", tex_xml, True, main_dir / "feat_textures.xml", 1),
        ("feat_textures.xml, path tracing", path_traced(tex_xml), True,
         main_dir / "feat_textures_pt.xml", 4)]
    for label, xml, sampled, path, stride in variants:
        path.write_text(xml)
        v_cfg, v_pack, v_cam_cfg, (vmc, vtri, vchunk), vcam = scene(path)
        if vmc.kernel != "mega_tex":
            raise AssertionError(f"{label}: routed to {vmc.kernel}")
        v_flat = (flat_tables(v_cfg, v_pack, v_cam_cfg)
                  if vmc.tree is not None else None)
        if sampled != (vmc.n_draws > 0):
            raise AssertionError(f"{label}: n_draws {vmc.n_draws}")
        rng = np.random.default_rng(4)
        w, h = v_cam_cfg.width, v_cam_cfg.height
        px = torch.as_tensor(rng.uniform(0, w, 65536).astype(np.float32),
                             device=dev)[::stride].contiguous()
        py = torch.as_tensor(rng.uniform(0, h, 65536).astype(np.float32),
                             device=dev)[::stride].contiguous()
        o, d = (t.contiguous() for t in generate_rays(vcam, px, py))
        pix_uv = (torch.stack((px * (1.0 / w), py * (1.0 / h)), -1)
                  if vmc.bg_tex >= 0 else None)
        rows = vmc.max_iters * vmc.n_draws
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        modes = [("table", torch.rand((rows, o.shape[0]), generator=gen,
                                      device=dev) if rows else None),
                 ("philox", None)]
        if label.startswith("env_aligned"):
            # every candidate at (-1, -1, -1), outside the ball: each lit
            # node draws all 16 and falls back to its normal
            exhausted = modes[0][1].clone()
            base_env = (3 + 3 * vmc.ml_lights.shape[0]
                        + 2 * vmc.area_lights.shape[0])
            for it in range(vmc.max_iters):
                row = it * vmc.n_draws + base_env
                exhausted[row:row + mk.ENV_DRAWS] = 0.0
            modes.append(("exhausted", exhausted))
        for mode, draws in modes:
            got = mk.mega_trace(vmc, vtri, vchunk, o, d, draws=draws, seed=13,
                                sample=6, pix_uv=pix_uv)
            flat = (None if v_flat is None else mk.mega_trace(
                *v_flat, o, d, draws=draws, seed=13, sample=6, pix_uv=pix_uv))
            torch.cuda.synchronize()
            if draws is None and rows:
                draws = philox_table(13, 6, o.shape[0], vmc.max_iters,
                                     vmc.n_draws, device=dev)
            # the draw counts of the aligned scenes (one chunk each: no walk
            # to count)
            env_stats: dict = {}
            ref = mk.mega_trace_ref(
                vmc, vtri, vchunk, o, d, draws=draws, pix_uv=pix_uv,
                stats=env_stats if label.startswith("env_aligned") else None)
            if mode == "exhausted" and not (
                    env_stats["env_exhausted"] * 16
                    == env_stats["env_candidates"] > 0):
                raise AssertionError(f"{label}: not every candidate failed: "
                                     f"{env_stats}")
            for kern, out in (("kernel", got), ("flat_sweep", flat)):
                if out is None:
                    continue
                what = f"K1d{'' if kern == 'kernel' else ' flat'}, {label}, {mode}"
                if rows:
                    e = check_close_pt(out, ref, what, EXT_MEAN_REL)
                    tol = dict(atol=PT_ATOL, rtol=PT_RTOL, frac_tol=PT_FRAC,
                               mean_rel_tol=EXT_MEAN_REL)
                else:
                    e = check_close(out, ref, what)
                    tol = dict(mean_tol=MEAN_TOL, q999_tol=Q999_TOL)
                if kern == "kernel":
                    err = e
                else:
                    err["flat_sweep"] = e
            emit("kernel_vs_plain", kernel=vmc.variant, scene=label, draws=mode,
                 rays=o.shape[0], stride=stride, depth=vmc.max_depth,
                 max_iters=vmc.max_iters, stack_k=vmc.stack_k,
                 n_draws=vmc.n_draws, n_textures=vmc.n_textures,
                 texels=vmc.texels.shape[0], **err, **tol,
                 env_exhausted=env_stats.get("env_exhausted", 0),
                 philox_blocks_per_ray=env_stats.get("philox_blocks", 0)
                 / o.shape[0],
                 draws_per_ray=env_stats.get("draws", 0) / o.shape[0])
        del draws

    # 13. the K1d main path, then one frame of its path-tracing variant
    cfg, pack, cam_cfg, (mc, tri_tab, chunk_tab), cam = scene(TEXTURES_SCENE)
    mp = main_path(pack, cfg, cam_cfg, "mega_tex_tree", "K1d main path")
    emit("main_path", kernel="mega_tex_tree", scene=TEXTURES_SCENE.name, **mp)
    v_cfg, v_pack, v_cam_cfg, _, _ = scene(main_dir / "feat_textures_pt.xml")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hdr = renderer.render_camera(v_pack, v_cfg, v_cam_cfg, seed=0, device=dev)
    frame_s = time.perf_counter() - t0
    ldr = renderer.ldr_from_radiance(hdr)
    if not (np.isfinite(hdr).all() and hdr.min() >= 0.0
            and 5.0 < float(ldr.mean()) < 250.0):
        raise AssertionError(f"K1d path-tracing frame: finite "
                             f"{np.isfinite(hdr).all()}, min {hdr.min()}, "
                             f"u8 mean {ldr.mean()}")
    write_png(str(out_dir / "mega_tex_feat_textures_pt.png"), ldr)
    emit("frame", kernel="mega_tex_tree",
         scene="feat_textures.xml, path tracing",
         spp=v_cam_cfg.num_samples, frame_s=frame_s, u8_mean=float(ldr.mean()),
         radiance_mean=float(hdr.mean()), card=card)

    # 14. K1d at the main path's shape: one sample's 640,000 rays, Philox;
    # the plain version on every 8th of them, to keep the script's time
    kernel_ms, plain_ms, bd, err, n_rays, stride = at_main_shape(
        mc, tri_tab, chunk_tab, cam_cfg, cam, "mega_tex_tree",
        "K1d, 640,000 rays of one sample", stride=8)
    kernels.append(kernel_entry("mega_tex_tree", mp["launches"], kernel_ms,
                                plain_ms, bd, err, n_rays, stride))

    # ---- K1e: large geometry through the tree ----
    def check_modes(label, kernel, src, rays, sampled_tol, name=None, seed=0,
                    centres=False):
        """The tree instantiation of ``kernel`` against the plain version
        on ``rays`` primary rays of a scene (with ``centres``, through the
        centres of evenly spaced pixels, where a regular grid's shared edges
        make ties), in both draw modes where it draws (K1c's bound), else
        once (K1a's)."""
        _, _, v_cam_cfg, (vmc, vtri, vchunk), vcam = scene(src, name)
        if vmc.variant != kernel + "_tree":
            raise AssertionError(f"{label}: routed to {vmc.variant}")
        if centres:
            w = v_cam_cfg.width
            idx = torch.arange(rays, device=dev) * (w * v_cam_cfg.height // rays)
            o, d = (t.contiguous() for t in generate_rays(
                vcam, (idx % w).float() + 0.5, (idx // w).float() + 0.5))
        else:
            o, d = primary_rays(v_cam_cfg, vcam, rays, seed=seed)
        rows = vmc.max_iters * vmc.n_draws
        gen = torch.Generator(device=dev)
        gen.manual_seed(8)
        modes = (("table", torch.rand((rows, o.shape[0]), generator=gen,
                                      device=dev)), ("philox", None))
        for mode, draws in (modes if rows else (("none", None),)):
            got = mk.mega_trace(vmc, vtri, vchunk, o, d, draws=draws, seed=17,
                                sample=2)
            torch.cuda.synchronize()
            if draws is None and rows:
                draws = philox_table(17, 2, o.shape[0], vmc.max_iters,
                                     vmc.n_draws, device=dev)
            t0 = time.perf_counter()
            ref = mk.mega_trace_ref(vmc, vtri, vchunk, o, d, draws=draws)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            if rows:
                err = check_close_pt(got, ref, f"K1e, {label}, {mode}",
                                     sampled_tol)
                tol = dict(atol=PT_ATOL, rtol=PT_RTOL, frac_tol=PT_FRAC,
                           mean_rel_tol=sampled_tol)
            else:
                err = check_close(got, ref, f"K1e, {label}")
                tol = dict(mean_tol=MEAN_TOL, q999_tol=Q999_TOL)
            emit("kernel_vs_plain", kernel=vmc.variant, scene=label, draws=mode,
                 rays=o.shape[0], faces=vmc.n_tri, tree_nodes=vmc.tree.shape[0],
                 tree_depth=vmc.tree_depth, depth=vmc.max_depth,
                 n_draws=vmc.n_draws, plain_s=plain_s, **err, **tol)
        del draws
        return ref

    def faces_up(cfg):
        """The scene with its meshes' winding reversed."""
        for mesh in cfg.meshes:
            mesh.faces = np.ascontiguousarray(mesh.faces[:, ::-1])
            if mesh.uv_indices is not None:
                mesh.uv_indices = np.ascontiguousarray(mesh.uv_indices[:, ::-1])
        return cfg

    # 15. the tree instantiations against their plain version; the JAX
    # package's terrain faces down (its light adds nothing and its texture
    # changes no pixel), so the terrain is checked with its winding
    # reversed too, where the light and the texture show
    terrains = {textured: terrain_scene(n=513, textured=textured)
                for textured in (False, True)}
    lit = {textured: faces_up(terrain_scene(n=513, textured=textured))
           for textured in (False, True)}
    refs = {}
    for up, scenes in ((False, terrains), (True, lit)):
        for textured, kernel in ((False, "mega_whitted"), (True, "mega_tex")):
            refs[up, textured] = check_modes(
                f"terrain n=513{', faces up' if up else ''}"
                f"{', textured' if textured else ''}", kernel,
                scenes[textured], 65536, EXT_MEAN_REL, centres=True)
    light_gain = float(refs[True, False].mean() - refs[False, False].mean())
    tex_changed = float(((refs[True, True] - refs[True, False]).abs().amax(dim=1)
                         > 0.5).float().mean())
    emit("terrain_shading", light_gain=light_gain,
         texture_changed_frac=tex_changed)
    if not (light_gain > 1.0 and tex_changed > 0.2):
        raise AssertionError(f"faces-up terrain: the light adds {light_gain} "
                             f"on average and the texture changes "
                             f"{tex_changed} of the rays")
    del refs
    moving = terrain_scene(n=17, width=64, height=48)
    moving.meshes[0].motion_blur = np.array([0.4, 0.0, 0.2])
    traced = terrain_scene(n=33, width=64, height=48)
    traced.cameras[0].renderer_params.path_tracing = True
    traced.cameras[0].renderer_params.next_event_estimation = True
    traced.cameras[0].renderer_params.importance_sampling = True
    k1c = k1c_scenes(SCENES)
    fwd_flat_max = mk.FWD_FLAT_MAX_FACES
    mk.FWD_FLAT_MAX_FACES = 0  # every scene with faces walks a tree
    try:
        for label, kernel, src, name in (
                ("terrain n=33, path tracing", "mega_pt", traced, None),
                ("brdf_zoo", "mega_ext", k1c["brdf_zoo"], "brdf_zoo.xml"),
                ("motion_rough", "mega_ext", k1c["motion_rough"],
                 "motion_rough.xml"),
                ("terrain n=17, moving", "mega_ext", moving, None),
                ("maps", "mega_tex", tex_dir / "maps.xml", None),
                ("env_motion_rough", "mega_tex", tex_dir / "env_motion_rough.xml",
                 None)):
            check_modes(label, kernel, src, 65536, EXT_MEAN_REL, name, seed=5)
    finally:
        mk.FWD_FLAT_MAX_FACES = fwd_flat_max

    # 16. the K1e main path: render_scene on both terrains, then frames
    main_launches = {}
    for textured, kernel in ((False, "mega_whitted_tree"),
                             (True, "mega_tex_tree")):
        cfg = terrains[textured]
        cfg.cameras[0].num_samples = 16
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (cam_cfg, hdr), = renderer.render_scene(cfg, seed=0, device=dev)
        frame_s = time.perf_counter() - t0
        launches = counts()
        want = {k: (16 if k == kernel else 0) for k in launches}
        if launches != want:
            raise AssertionError(f"K1e render_scene: launches {launches}, "
                                 f"expected {want}")
        ldr = renderer.ldr_from_radiance(hdr)
        if not (hdr.shape == (480, 640, 3) and np.isfinite(hdr).all()
                and hdr.min() >= 0.0 and 5.0 < float(ldr.mean()) < 250.0):
            raise AssertionError(f"K1e {kernel} frame: {hdr.shape}, finite "
                                 f"{np.isfinite(hdr).all()}, u8 mean "
                                 f"{ldr.mean()}")
        write_png(str(out_dir / f"{kernel}_terrain.png"), ldr)
        main_launches[kernel] = launches[kernel]
        emit("render_scene", kernel=kernel, scene="terrain n=513",
             faces=524288, spp=16, launches=launches[kernel],
             frame_s_with_setup=frame_s, u8_mean=float(ldr.mean()), card=card)
    cfg, pack, cam_cfg, (mc, tri_tab, chunk_tab), cam = scene(terrains[True])
    mp = main_path(pack, cfg, cam_cfg, "mega_tex_tree", "K1e main path")
    emit("main_path", kernel="mega_tex_tree", scene="terrain n=513, textured",
         **mp)
    main_launches["mega_tex_tree"] = mp["launches"]

    # 17. K1e at the main path's shape: one sample's 307,200 rays; the
    # plain version on every 16th, the tree walk counted on every ray; then
    # the faces-up terrain's launch on the same shape
    for textured, kernel in ((False, "mega_whitted_tree"),
                             (True, "mega_tex_tree")):
        _, _, cam_cfg, (mc, tri_tab, chunk_tab), cam = scene(terrains[textured])
        kernel_ms, plain_ms, bd, err, n_rays, stride = at_main_shape(
            mc, tri_tab, chunk_tab, cam_cfg, cam, kernel,
            f"K1e {kernel}, 307,200 rays of one sample", stride=16,
            count_chunk=76800)
        # the same instantiations as K1a's and K1d's main paths, on the K1e
        # path's terrain
        kernels.append(kernel_entry(f"{kernel} (terrain)",
                                    main_launches[kernel], kernel_ms,
                                    plain_ms, bd, err, n_rays, stride,
                                    library=mk.LIBRARY[kernel]))
        lit[textured].cameras[0].num_samples = cam_cfg.num_samples
        _, _, l_cam_cfg, (lmc, ltri, lchunk), lcam = scene(lit[textured])
        o, d = sample_rays(l_cam_cfg, lcam, l_cam_cfg.num_samples)
        mk.mega_trace(lmc, ltri, lchunk, o, d, seed=0, sample=0)
        emit("kernel_faces_up", kernel=lmc.variant, rays=o.shape[0],
             kernel_ms=cuda_ms(lambda: mk.mega_trace(
                 lmc, ltri, lchunk, o, d, seed=0, sample=0), 5),
             faces_down_ms=kernel_ms, card=card)

    # the forward route against the flat chunk sweep (the tables built with
    # FLAT_MAX_FACES, build_mega's default) on every ray of one sample of each
    # main path's scene: bit for bit; feat_pt.xml (one chunk) keeps the flat
    # kernel, and is held to its tree twin (flat_max 0)
    for path in (WHITTED_SCENE, PT_SCENE, LIGHTS_SCENE, TEXTURES_SCENE):
        f_cfg, f_pack, f_cam_cfg, route_tabs, f_cam = scene(path)
        f_opts = renderer.options_for_camera(f_cfg, f_cam_cfg)
        other = mk.build_mega(f_pack, f_opts, device=dev,
                              flat_max=mk.FLAT_MAX_FACES if
                              route_tabs[0].tree is not None else 0)
        o, d = sample_rays(f_cam_cfg, f_cam, f_cam_cfg.num_samples)
        res = {}
        for label, (m, tri, chunk) in (("route", route_tabs), ("other", other)):
            res[label] = mk.mega_trace(m, tri, chunk, o, d, seed=0, sample=0)
            res[label + "_ms"] = cuda_ms(lambda: mk.mega_trace(
                m, tri, chunk, o, d, seed=0, sample=0), 5)
        tree = "route" if route_tabs[0].tree is not None else "other"
        flat = "other" if tree == "route" else "route"
        line = dict(scene=path.name, route_kernel=route_tabs[0].variant,
                    flat_kernel=(route_tabs, other)[flat == "other"][0].variant,
                    tree_kernel=(route_tabs, other)[tree == "other"][0].variant,
                    rays=o.shape[0], flat_ms=res[flat + "_ms"],
                    tree_ms=res[tree + "_ms"],
                    exact_frac_vs_flat=exact_frac(res[tree], res[flat]),
                    max_abs_diff=float((res[tree] - res[flat]).abs().max()),
                    card=card)
        emit("route_vs_flat", **line)
        if line["exact_frac_vs_flat"] != 1.0:
            raise AssertionError(f"{path.name}: the tree and the flat sweep "
                                 f"differ: {line}")
        del res

    # ---- K2a: the differentiable render (slice C1) ----
    def check_grads(got, ref, what) -> dict:
        """Every cotangent of the kernel against autograd's: finite, and
        within rtol GRAD_RTOL and atol GRAD_ATOL_SCALE * max|ref|."""
        out = {}
        for k in ref._fields:
            a, b = getattr(ref, k), getattr(got, k)
            if not bool(torch.isfinite(b).all()):
                raise AssertionError(f"{what}: non-finite d_{k}")
            if a.numel() == 0:
                continue
            scale = float(a.abs().max())
            err = (b - a).abs()
            bad = int((err > GRAD_RTOL * a.abs()
                       + GRAD_ATOL_SCALE * scale).sum())
            out[k] = {"max_abs_err": float(err.max()), "ref_max": scale,
                      "n": a.numel(), "outside": bad}
            if bad:
                raise AssertionError(f"{what}: d_{k} disagrees with autograd: "
                                     f"{out[k]}")
        return out

    def scatter_split(bc, tabs, o, d, gbar, draws=None) -> dict:
        """The fwd+bwd's device time per launch (``device_ms``) with every
        target, with none, and with each cotangent target alone that the
        scene has, and what each alone adds to none: the scatter's split
        by target."""
        def run(scatter):
            return device_ms(lambda: mb.mega_bwd_trace(
                bc, tabs, o, d, draws, gbar=gbar, scatter=scatter), "mega_bwd")

        none = run(False)
        out = {"every target": run(True), "no target": none}
        for name in mb.SCATTER_FLAGS:
            if getattr(tabs, name).numel():
                ms = run((name,))
                out[name] = {"ms": ms, "adds_ms": ms - none}
        out["scatter_ms"] = out["every target"] - none
        return out

    def diff_render(path, emissive=False):
        """The differentiable render of a scene file on the card, its
        camera, and its parameter tables at the pack's values; with
        ``emissive``, material 1 made emissive of radiance (3, 2, 1) (an
        XML scene has emissive materials only with a mesh light, outside
        K2a)."""
        cfg = load_scene(str(path))
        pack = pack_scene(cfg, device=dev)
        if emissive:
            mat_type, rad = pack.mat_type.clone(), pack.mat_radiance.clone()
            mat_type[1] = 4  # MaterialType.EMISSIVE
            rad[1] = torch.tensor([3.0, 2.0, 1.0], device=dev)
            pack = dataclasses.replace(
                pack, mat_type=mat_type, mat_radiance=rad,
                static=dataclasses.replace(pack.static, has_emissive_mat=True,
                                           has_mirror=False))
        opts = renderer.options_for_camera(cfg, cfg.cameras[0])
        f = mb.make_diff_render(pack, opts, device=dev)
        tabs = mb.BwdTables(*(t.detach().contiguous() for t in f.tables({})))
        return cfg, pack, opts, f, tabs, build_camera(cfg.cameras[0], device=dev)

    k2a_dir = out_dir / "k2a"
    gauge_path = gauge_scene_xml(k2a_dir, SCENES)
    slice_path = k2a_dir / "slice_coarse.xml"
    slice_path.write_text(WHITTED_SCENE.read_text())
    (k2a_dir / "whitted_conductors_mesh.ply").write_bytes(
        ply_bytes(*torus_mesh(**COARSE_TORUS)))
    demo_path = k2a_dir / "demo.xml"
    demo_path.write_text(re.sub(r"<AreaLight.*?</AreaLight>", "",
                                AREA_DEMO_XML, flags=re.S))

    # 18. K2a against its plain version: 16,384 primary rays at full depth,
    # both draw modes, over the chunks and over the tree, and with the
    # vertices moved
    n18 = 16384
    fwd_flat_max = mk.FWD_FLAT_MAX_FACES

    def left_built_boxes(bc, tri_w) -> torch.Tensor:
        """The work items with a vertex outside the built box that holds
        them (their tree leaf's, or their chunk's)."""
        rows = tri_w.reshape(-1, 3, 3)
        if bc.mc.tree is None:
            box = bc.chunk_tab[torch.arange(bc.n_tri, device=dev) // mk.CHUNK]
            out = ((rows < box[:, None, 0:3]) | (rows > box[:, None, 3:6]))
            return out.flatten(1).any(1).nonzero().squeeze(1)
        wd = mk.TREE_WIDTH
        code = bc.mc.tree.view(torch.int32)[:, 6 * wd:7 * wd]
        leaf = (code < 0).nonzero()
        c = ~code[leaf[:, 0], leaf[:, 1]].long()
        by_row = (c >> 5).argsort()
        leaf, c = leaf[by_row], c[by_row]
        first, count = c >> 5, c & 31
        box = bc.mc.tree[leaf[:, 0], :6 * wd].reshape(-1, 6, wd)[
            torch.arange(leaf.shape[0], device=dev), :, leaf[:, 1]]
        row_of = torch.arange(bc.n_tri, device=dev)
        owner = torch.bucketize(row_of, first, right=True) - 1
        assert bool((row_of < first[owner] + count[owner]).all())
        b = box[owner]
        out = (rows < b[:, None, 0:3]) | (rows > b[:, None, 3:6])
        return out.flatten(1).any(1).nonzero().squeeze(1)

    try:
        for geometry in ("chunks", "tree"):
            mk.FWD_FLAT_MAX_FACES = (mk.FLAT_MAX_FACES if geometry == "chunks"
                                     else 0)
            for label, path, moved in (
                    ("gauge", gauge_path, False),
                    ("gauge, vertices moved", gauge_path, True),
                    ("slice, coarse torus", slice_path, False),
                    ("slice, coarse torus, vertices moved", slice_path, True),
                    ("demo", demo_path, False),
                    ("demo, emissive sphere", demo_path, False)):
                cfg, pack, _, f, tabs, cam = diff_render(
                    path, emissive=label.endswith("emissive sphere"))
                bc = f.bc
                if bc.variant != "mega_bwd" + ("_tree" if geometry == "tree"
                                               else ""):
                    raise AssertionError(f"K2a {label}: routed to {bc.variant}")
                left = None
                if moved:
                    noise = np.random.default_rng(18).normal(
                        0.0, 0.05, tuple(pack.verts.shape)).astype(np.float32)
                    tabs = tabs._replace(tri_w=mb.world_vertices(
                        bc, pack.verts + torch.as_tensor(noise, device=dev))
                        .contiguous())
                    left = left_built_boxes(bc, tabs.tri_w)
                depth = mb.bc_depth(bc)
                # the plain version sweeps the gauge's 32,778 rows in
                # 128-row chunks some 8 times slower than in the tree's
                # groups: there it takes every 4th ray, and the kernels'
                # cotangent of the others is 0, so that their table
                # cotangents are those of the plain version's rays
                n = n18
                stride = (4 if geometry == "chunks" and label.startswith(
                    "gauge") else 1)
                o, d = primary_rays(cfg.cameras[0], cam, n, seed=3)
                gen = torch.Generator(device=dev)
                gen.manual_seed(12)
                gbar = torch.randn((n, 3), generator=gen, device=dev)
                gbar_k = torch.zeros_like(gbar)
                gbar_k[::stride] = gbar[::stride]
                os_, ds_, gs_ = (t[::stride].contiguous() for t in (o, d, gbar))
                for mode in ("table", "philox")[int(moved):]:
                    draws = (torch.rand((depth, n), generator=gen, device=dev)
                             if mode == "table" else None)
                    before = dict(mb.LAUNCHES)
                    prim = mb.mega_bwd_trace(bc, tabs, o, d, draws, seed=19,
                                             step=3)
                    got, g = mb.mega_bwd_trace(bc, tabs, o, d, draws, seed=19,
                                               step=3, gbar=gbar_k)
                    torch.cuda.synchronize()
                    launched = {k: v - before[k] for k, v in mb.LAUNCHES.items()
                                if v != before[k]}
                    want = {bc.primal_kernel: 2, "mega_bwd_rev": 1}
                    if mb.boxes_read(bc):
                        want["mega_bwd_refit"] = 2
                    if launched != want:
                        raise AssertionError(f"K2a {label}: launches "
                                             f"{launched}, expected {want}")
                    if draws is None:
                        draws = mb.ud_table(19, 3, n, depth, device=dev)
                    draws = draws[:, ::stride].contiguous()
                    t0 = time.perf_counter()
                    ref, gref = mb.mega_bwd_trace_ref(bc, tabs, os_, ds_, draws,
                                                      gs_)
                    torch.cuda.synchronize()
                    plain_s = time.perf_counter() - t0
                    what = f"K2a {bc.variant}, {label}, {mode}"
                    err = check_close(prim[::stride], ref, what + ", primal")
                    if not torch.equal(prim, got):
                        raise AssertionError(f"{what}: the primal writing its "
                                             f"records gave another radiance")
                    g = g._replace(o=g.o[::stride], d=g.d[::stride])
                    line = {}
                    if moved:
                        # the rays whose closest hit is a face that left its
                        # built box: the refit boxes must keep them
                        geo = mk._Geometry(bc.mc, torch.cat(
                            [tabs.tri_w, bc.tri_rest], 1), bc.chunk_tab, None)
                        win = geo.trace(*os_.T, *ds_.T, want_win=True)[-1]
                        hit_left = int(torch.isin(win, left).sum())
                        line = {"faces_out_of_built_boxes": left.numel(),
                                "rays_on_them": hit_left}
                        if hit_left == 0:
                            raise AssertionError(f"{what}: no ray hits a "
                                                 f"moved face")
                    emit("kernel_vs_plain", kernel=bc.variant, scene=label,
                         draws=mode, rays=n, plain_stride=stride, depth=depth,
                         faces=bc.n_tri, plain_s=plain_s, primal=err,
                         launches=launched, grads=check_grads(g, gref, what),
                         mean_tol=MEAN_TOL, q999_tol=Q999_TOL,
                         grad_rtol=GRAD_RTOL, grad_atol_scale=GRAD_ATOL_SCALE,
                         **line)
                del draws, gref, g
    finally:
        mk.FWD_FLAT_MAX_FACES = fwd_flat_max

    # 19. the training main path: 5 Adam steps through K2a at 800x800
    fields = ("mat_diffuse", "pl_intensity", "verts")
    cfg, pack, opts, _, _, cam = diff_render(gauge_path)
    cam_cfg = cfg.cameras[0]
    w, h = cam_cfg.width, cam_cfg.height
    idx = torch.arange(w * h, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    jit = torch.rand((w * h, 2), generator=gen, device=dev)
    px = (idx % w).float() + jit[:, 0]
    py = (idx // w).float() + jit[:, 1]
    rng = np.random.default_rng(6)
    start = {
        "mat_diffuse": pack.mat_diffuse * torch.as_tensor(rng.uniform(
            0.7, 1.1, tuple(pack.mat_diffuse.shape)).astype(np.float32),
            device=dev),
        "pl_intensity": pack.pl_intensity * 1.2,
        "verts": pack.verts + torch.as_tensor(rng.normal(
            0.0, 0.01, tuple(pack.verts.shape)).astype(np.float32), device=dev)}
    o, d = (t.contiguous() for t in generate_rays(cam, px, py))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f = mb.make_diff_render(pack, opts, device=dev)
    with torch.no_grad():
        target = f({}, o, d)
    rates = GAUGE_RATES
    _, history = optimize(inject_params(pack, start), cam, px, py, opts, target,
                          fields, steps=5, lr=rates, seed=0, device=dev)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = counts()
    want = {k: {"mega_bwd_primal_tree": 6, "mega_bwd_rev": 5,
                "mega_bwd_refit": 6}.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"training main path: launches {launches}, "
                             f"expected {want}")
    if not (all(math.isfinite(x) for x in history)
            and all(b < a for a, b in zip(history, history[1:]))):
        raise AssertionError(f"training main path: loss history {history}")
    # the step's time: optimize's step (the render's value and gradient,
    # Adam, the loss read back) in a loop of its own, one warm-up then 5
    f_step = mb.make_diff_render(inject_params(pack, start), opts, device=dev)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in start.items()}
    adam = torch.optim.Adam([{"params": [params[k]], "lr": rates[k]}
                             for k in fields])
    step_s = []
    torch.cuda.synchronize()
    mem_base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i in range(6):
        t1 = time.perf_counter()
        adam.zero_grad(set_to_none=True)
        loss = torch.mean((f_step(params, o, d) - target) ** 2)
        loss.backward()
        adam.step()
        float(loss.detach())
        if i:
            step_s.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated()
    del f_step, params, adam, loss
    step_med = sorted(step_s)[len(step_s) // 2]
    emit("main_path", kernel="mega_bwd_primal_tree + mega_bwd_rev",
         scene="gauge (whitted_conductors.xml + a directional light)", width=w,
         height=h, rays=w * h, depth=opts.max_depth, fields=list(fields),
         lr=rates, steps=5, loss_history=history, step_s=step_s,
         step_s_median=step_med, mrays_per_s=w * h / step_med / 1e6,
         total_s_with_setup=total_s, peak_mem_bytes=peak,
         peak_mem_above_start_bytes=peak - mem_base,
         records_bytes=4 * math.prod(mb.records_shape(f.bc, w * h)),
         launches={k: v for k, v in launches.items() if v}, card=card)
    main_bwd_launches = dict(launches)

    # 20. K2a at the main path's shape: 640,000 rays at the true parameters,
    # the route's tree against the flat sweep (the threshold raised), and
    # the primal with and without its records
    bc = f.bc
    if bc.variant != "mega_bwd_tree":
        raise AssertionError(f"K2a's main path routed to {bc.variant}")
    tabs = mb.BwdTables(*(t.detach().contiguous() for t in f.tables({})))
    n20 = o.shape[0]
    gbar = torch.randn((n20, 3), generator=gen, device=dev)
    every = tuple(mb.SCATTER_FLAGS)
    run = mb._Launch(bc, tabs, o, d, None, 0, 0)
    rec = run.new_records()
    # the refit: bit for bit refit_ref's, and on the unmoved vertices the
    # built tree's
    nodes, _ = mb.refit(bc, tabs.tri_w)
    t0 = time.perf_counter()
    nodes_ref, _ = mb.refit_ref(bc, tabs.tri_w)
    torch.cuda.synchronize()
    plain_refit_ms = (time.perf_counter() - t0) * 1e3
    for what, other in (("refit_ref", nodes_ref), ("the built tree", bc.mc.tree)):
        if not torch.equal(nodes.view(torch.int32), other.view(torch.int32)):
            raise AssertionError(f"the refit kernel's boxes differ from {what}")
    refit_ms = device_ms(lambda: mb.refit(bc, tabs.tri_w), "mega_bwd_refit")
    refit_ev_ms = cuda_ms(lambda: mb.refit(bc, tabs.tri_w), 20)
    # device times (torch.profiler) of each launch, and CUDA events around
    # the wrapper's call (mega_bwd_trace: the refit, the primal, and with
    # gbar the primal writing its records and the reverse kernel)
    prim_ms = device_ms(lambda: run.primal(), "mega_bwd_primal_tree")
    prim_rec_ms = device_ms(lambda: run.primal(rec), "mega_bwd_primal_tree")
    rev_ms = device_ms(lambda: run.backward(gbar, every, rec),
                       "mega_bwd_rev_kernel")
    rev_no_scatter_ms = device_ms(lambda: run.backward(gbar, (), rec),
                                  "mega_bwd_rev_kernel")
    prim_ev_ms = cuda_ms(lambda: mb.mega_bwd_trace(bc, tabs, o, d), 5)
    fb_ev_ms = cuda_ms(lambda: mb.mega_bwd_trace(bc, tabs, o, d, gbar=gbar), 5)
    # the flat sweep on the same rays: the tree's radiance equals it bit for
    # bit, its cotangents within the gates (atomic sums)
    mk.FWD_FLAT_MAX_FACES = mk.FLAT_MAX_FACES
    try:
        f_flat = mb.make_diff_render(pack, opts, device=dev)
    finally:
        mk.FWD_FLAT_MAX_FACES = fwd_flat_max
    bcf = f_flat.bc
    if bcf.variant != "mega_bwd":
        raise AssertionError(f"K2a's flat tables routed to {bcf.variant}")
    tabs_f = mb.BwdTables(*(t.detach().contiguous()
                            for t in f_flat.tables({})))
    run_f = mb._Launch(bcf, tabs_f, o, d, None, 0, 0)
    rec_f = run_f.new_records()
    flat_prim_ms = device_ms(lambda: run_f.primal(rec_f), "mega_bwd_primal")
    flat_rev_ms = device_ms(lambda: run_f.backward(gbar, every, rec_f),
                            "mega_bwd_rev_kernel")
    flat_p, flat_g = mb.mega_bwd_trace(bcf, tabs_f, o, d, gbar=gbar)
    tree_p, tree_g = mb.mega_bwd_trace(bc, tabs, o, d, gbar=gbar)
    what = "K2a's tree at the main path's shape, against the flat sweep"
    vs_flat = {"exact_frac": exact_frac(tree_p, flat_p),
               "grads": check_grads(tree_g, flat_g, what)}
    if vs_flat["exact_frac"] != 1.0:
        raise AssertionError(f"{what}: radiance not bit for bit: {vs_flat}")
    del flat_p, flat_g, tree_p, tree_g, rec_f, run_f
    # the plain version on every 16th ray, the kernels on the same rays and
    # draws
    stride = 16
    depth = mb.bc_depth(bc)
    os_, ds_, gs_ = (t[::stride].contiguous() for t in (o, d, gbar))
    draws = mb.ud_table(0, 0, n20, depth, device=dev)[:, ::stride].contiguous()
    prim, (got, g) = (mb.mega_bwd_trace(bc, tabs, os_, ds_, draws),
                      mb.mega_bwd_trace(bc, tabs, os_, ds_, draws, gbar=gs_))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref0 = mb.mega_bwd_trace_ref(bc, tabs, os_, ds_, draws)
    torch.cuda.synchronize()
    plain_prim_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref, gref = mb.mega_bwd_trace_ref(bc, tabs, os_, ds_, draws, gs_)
    torch.cuda.synchronize()
    plain_fb_ms = (time.perf_counter() - t0) * 1e3
    what = "K2a at the main path's shape, every 16th ray"
    err_p = check_close(prim, ref0, what + ", primal")
    err_fb = check_close(got, ref, what + ", with records")
    gerr = check_grads(g, gref, what)
    del prim, got, g, ref0, ref, gref
    # the tree's work on every ray: the plain version's primal, in runs of
    # 160,000 rays sharing its stats (TreeWalker's counts, the boxes, rows
    # and winners read, the traced segments and lit light evaluations)
    tree_stats: dict = {}
    table = mb.ud_table(0, 0, n20, depth, device=dev)
    for lo in range(0, n20, 160000):
        part = slice(lo, lo + 160000)
        mb.mega_bwd_trace_ref(bc, tabs, o[part].contiguous(),
                              d[part].contiguous(),
                              table[:, part].contiguous(), stats=tree_stats)
    del table
    reads = tree_stats.pop("reads")
    tree_stats.update(nodes_read=int(reads["nodes"].sum()),
                      rows_read=int(reads["rows"].sum()),
                      rows_won=int(reads["won"].sum()))

    def with_flops(bd, flops):
        """``bd`` (a ``bound``) with ``flops`` more operations."""
        bd["flops"] += flops
        bd["ops_ms"] = bd["flops"] / PEAK_FP32_FLOPS * 1e3
        bd["bound_ms"] = max(bd["ops_ms"], bd["bytes_ms"])
        bd["bound_by"] = ("operations" if bd["ops_ms"] >= bd["bytes_ms"]
                          else "bytes")
        return bd

    # bytes: the primal reads the rays and what its walk reaches and
    # writes the radiance and the records of the segments traced; the
    # reverse kernel reads those records, the cotangent, the winners' rows
    # and the small tables, and writes the parameters' and rays'
    # cotangents (no trace tests)
    segs = tree_stats["traces"]
    rec_bytes = (segs * mb.SEG_WORDS + n20) * 4
    small = sum(t.numel() * 4 for t in (
        bc.mc.spheres, bc.mc.materials, bc.mc.point_lights, bc.mc.dir_lights,
        tabs.mat, tabs.pl, tabs.dl, tabs.bg))
    won_rows = tree_stats["rows_won"] * (9 + 7) * 4
    tree_tables = table_bytes(bc.mc, None, reads)
    bd_p = with_flops(bound(tree_stats, n20 * 9 * 4 + tree_tables + rec_bytes),
                      segs * STEP_FLOPS
                      + tree_stats["lit_light_evals"] * LIGHT_FLOPS)
    bd_rev = with_flops(
        bound({}, rec_bytes + n20 * 3 * 4 + won_rows + small + n20 * 6 * 4
              + sum(t.numel() * 4 for t in tabs[:4])
              + tree_stats["rows_won"] * 9 * 4),
        segs * (STEP_FLOPS + ADJ_STEP_FLOPS)
        + tree_stats["lit_light_evals"] * (LIGHT_FLOPS + ADJ_LIGHT_FLOPS))
    # the refit: the vertices, the runs, the spans and the built tree read
    # once, the boxes written once
    n_nodes = bc.mc.tree.shape[0]
    bd_refit = bound({}, tabs.tri_w.numel() * 4 + bc.tree_runs.numel() * 4
                     + bc.tree_spans.numel() * 4 + 2 * n_nodes * mk.NODE_COLS
                     * 4)
    grad_err = max(v["max_abs_err"] for v in gerr.values())
    emit("kernel_at_main_shape", kernel="mega_bwd_primal_tree + mega_bwd_rev",
         rays=n20, plain_stride=stride, primal_device_ms=prim_ms,
         primal_records_device_ms=prim_rec_ms,
         records_write_ms=prim_rec_ms - prim_ms, reverse_device_ms=rev_ms,
         reverse_no_scatter_device_ms=rev_no_scatter_ms,
         scatter_ms=rev_ms - rev_no_scatter_ms, refit_device_ms=refit_ms,
         refit_events_ms=refit_ev_ms, plain_refit_ms=plain_refit_ms,
         primal_events_ms=prim_ev_ms, primal_records_reverse_events_ms=fb_ev_ms,
         flat_primal_records_device_ms=flat_prim_ms,
         flat_reverse_device_ms=flat_rev_ms, tree_vs_flat=vs_flat,
         plain_primal_ms=plain_prim_ms, plain_fwd_bwd_ms=plain_fb_ms,
         primal_bound=bd_p, reverse_bound=bd_rev, refit_bound=bd_refit,
         primal=err_p, with_records_exact_frac=err_fb["exact_frac"],
         grads=gerr, counts=tree_stats, records_bytes=rec.numel() * 4,
         card=card)
    del rec, run
    kernels.append({**kernel_entry(
        "mega_bwd_primal_tree", main_bwd_launches["mega_bwd_primal_tree"],
        prim_rec_ms, plain_prim_ms, bd_p, err_p, n20, stride,
        library=mb.LIBRARY, replaces=REPLACES_K2),
        "ms_without_records": prim_ms, "flat_ms": flat_prim_ms,
        "events_ms": prim_ev_ms})
    kernels.append({**kernel_entry(
        "mega_bwd_rev", main_bwd_launches["mega_bwd_rev"], rev_ms, plain_fb_ms,
        bd_rev, {"max_abs_err": max(err_fb["max_abs_err"], grad_err)}, n20,
        stride, library=mb.LIBRARY, replaces=REPLACES_K2),
        "scatter_ms": rev_ms - rev_no_scatter_ms, "flat_ms": flat_rev_ms,
        "plain_ms_is": "the plain version's radiance and autograd cotangents"})
    kernels.append({**kernel_entry(
        "mega_bwd_refit", main_bwd_launches["mega_bwd_refit"], refit_ms,
        plain_refit_ms, bd_refit, {"max_abs_err": 0.0}, bc.n_tri, 1,
        library=mb.LIBRARY, replaces=REPLACES_REFIT), "events_ms": refit_ev_ms})

    # ---- K2b: path tracing, spot, area and mesh lights (slice C2) ----
    k2b_dir = out_dir / "k2b"
    k2b_dir.mkdir()

    def k2b_xml(name, xml):
        path = k2b_dir / name
        path.write_text(xml)
        return path

    pt_xml = PT_SCENE.read_text()
    spec_xml = PT_SPEC_SCENE.read_text()
    k2b_scenes = (
        ("feat_pt.xml", PT_SCENE),
        ("feat_pt.xml, NEE only", k2b_xml("pt_nee.xml", pt_xml.replace(
            "NextEventEstimation ImportanceSampling", "NextEventEstimation"))),
        ("feat_pt.xml, neither NEE nor importance sampling", k2b_xml(
            "pt_plain.xml", pt_xml.replace(
                "NextEventEstimation ImportanceSampling", ""))),
        ("feat_pt_rr.xml", PT_RR_SCENE),
        ("feat_pt_spec.xml", PT_SPEC_SCENE),
        ("feat_pt_spec.xml + RussianRoulette", k2b_xml(
            "pt_spec_rr.xml", spec_xml.replace(
                "ImportanceSampling", "ImportanceSampling RussianRoulette"))),
        ("feat_spotareaml.xml", SCENES / "feat_spotareaml.xml"),
        ("demo, its area light", k2b_xml("demo_area.xml", AREA_DEMO_XML)),
        ("demo under PathTracing + NEE, its mirror sphere diffuse", k2b_xml(
            "demo_pt.xml", path_traced(AREA_DEMO_XML).replace(
                '<Material id="2" type="mirror">', '<Material id="2">'))),
    )

    # 21. K2b against its plain version: 16,384 primary rays at full depth,
    # both draw modes, over the chunks and over the tree
    n21 = 16384
    try:
        for geometry in ("chunks", "tree"):
            if geometry == "tree":
                mk.FWD_FLAT_MAX_FACES = 0
            for label, path in k2b_scenes:
                cfg, _, _, f, tabs, cam = diff_render(path)
                bc = f.bc
                if bc.variant != "mega_bwd_pt" + ("_tree" if geometry == "tree"
                                                  else ""):
                    raise AssertionError(f"K2b {label}: routed to {bc.variant}")
                o, d = primary_rays(cfg.cameras[0], cam, n21, seed=3)
                gen = torch.Generator(device=dev)
                gen.manual_seed(12)
                gbar = torch.randn((n21, 3), generator=gen, device=dev)
                for mode in ("table", "philox"):
                    draws = (mb.table_draws(bc, n21, gen, dev)
                             if mode == "table" else None)
                    prim = mb.mega_bwd_trace(bc, tabs, o, d, draws, seed=19,
                                             step=3)
                    got, g = mb.mega_bwd_trace(bc, tabs, o, d, draws, seed=19,
                                               step=3, gbar=gbar)
                    torch.cuda.synchronize()
                    if draws is None:
                        draws = mb.bwd_draws(bc, 19, 3, n21, device=dev)
                    t0 = time.perf_counter()
                    ref, gref = mb.mega_bwd_trace_ref(bc, tabs, o, d, draws,
                                                      gbar)
                    torch.cuda.synchronize()
                    plain_s = time.perf_counter() - t0
                    what = f"K2b {bc.variant}, {label}, {mode}"
                    err = check_close(prim, ref, what + ", primal")
                    err_fb = check_close(got, ref, what + ", fwd+bwd")
                    emit("kernel_vs_plain", kernel=bc.variant, scene=label,
                         draws=mode, rays=n21, depth=mb.bc_depth(bc),
                         faces=bc.n_tri, plain_s=plain_s, primal=err,
                         fwd_bwd_exact_frac=err_fb["exact_frac"],
                         fwd_bwd_max_abs_err=err_fb["max_abs_err"],
                         grads=check_grads(g, gref, what), mean_tol=MEAN_TOL,
                         q999_tol=Q999_TOL, grad_rtol=GRAD_RTOL,
                         grad_atol_scale=GRAD_ATOL_SCALE)
                    del draws, gref, g
    finally:
        mk.FWD_FLAT_MAX_FACES = fwd_flat_max

    # 22. the path-traced training main path (JAX bench.py --bwd --bwd-scene
    # pt): 5 Adam steps through K2b on feat_pt.xml at 800x800
    fields = ("mat_diffuse", "ml_radiance", "verts")
    cfg, pack, opts, _, _, cam = diff_render(PT_SCENE)
    cam_cfg = cfg.cameras[0]
    w, h = cam_cfg.width, cam_cfg.height
    idx = torch.arange(w * h, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    jit = torch.rand((w * h, 2), generator=gen, device=dev)
    px = (idx % w).float() + jit[:, 0]
    py = (idx // w).float() + jit[:, 1]
    rng = np.random.default_rng(7)
    # the light mesh hangs 0.01 below the ceiling: the vertices move less
    start = {
        "mat_diffuse": pack.mat_diffuse * torch.as_tensor(rng.uniform(
            0.7, 1.1, tuple(pack.mat_diffuse.shape)).astype(np.float32),
            device=dev),
        "ml_radiance": pack.ml_radiance * 1.2,
        "verts": pack.verts + torch.as_tensor(rng.normal(
            0.0, 0.001, tuple(pack.verts.shape)).astype(np.float32),
            device=dev)}
    o, d = (t.contiguous() for t in generate_rays(cam, px, py))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f = mb.make_diff_render(pack, opts, device=dev)
    with torch.no_grad():
        target = f({}, o, d)
    rates = FEAT_PT_RATES
    _, history = optimize(inject_params(pack, start), cam, px, py, opts, target,
                          fields, steps=5, lr=rates, seed=0, device=dev)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = counts()
    want = {k: {"mega_bwd_primal_pt": 6, "mega_bwd_pt": 5}.get(k, 0)
            for k in launches}
    if launches != want:
        raise AssertionError(f"path-traced training main path: launches "
                             f"{launches}, expected {want}")
    if not (all(math.isfinite(x) for x in history)
            and all(b < a for a, b in zip(history, history[1:]))):
        raise AssertionError(f"path-traced training main path: loss history "
                             f"{history}")
    pt_launches = dict(launches)
    f_step = mb.make_diff_render(inject_params(pack, start), opts, device=dev)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in start.items()}
    adam = torch.optim.Adam([{"params": [params[k]], "lr": rates[k]}
                             for k in fields])
    step_s = []
    for i in range(6):
        t1 = time.perf_counter()
        adam.zero_grad(set_to_none=True)
        loss = torch.mean((f_step(params, o, d) - target) ** 2)
        loss.backward()
        adam.step()
        float(loss.detach())
        if i:
            step_s.append(time.perf_counter() - t1)
    del f_step, params, adam, loss
    step_med = sorted(step_s)[len(step_s) // 2]
    emit("main_path", kernel="mega_bwd_pt", scene="feat_pt.xml", width=w,
         height=h, rays=w * h, depth=opts.max_depth, fields=list(fields),
         lr=rates, steps=5, loss_history=history, step_s=step_s,
         step_s_median=step_med, mrays_per_s=w * h / step_med / 1e6,
         total_s_with_setup=total_s,
         launches={k: v for k, v in launches.items() if v}, card=card)
    # one value-and-grad of sum(img^2) / n at 1920x1080 (JAX bench.py
    # main_bwd's grid over the camera's image and its loss), the median of
    # 3 after a warm-up
    bw, bh = 1920, 1080
    ys, xs = np.divmod(np.arange(bw * bh, dtype=np.int64), bw)
    for path in (PT_SCENE, PT_RR_SCENE, PT_SPEC_SCENE):
        cfg_b, pack_b, opts_b, f_b, _, cam_b = diff_render(path)
        sx = cfg_b.cameras[0].width / bw
        sy = cfg_b.cameras[0].height / bh
        ob, db = (t.contiguous() for t in generate_rays(
            cam_b, torch.as_tensor(xs * sx, dtype=torch.float32, device=dev),
            torch.as_tensor(ys * sy, dtype=torch.float32, device=dev)))
        leaves = {k: getattr(pack_b, k).detach().clone().requires_grad_(True)
                  for k in fields}
        vg_s, loss_v = [], None
        for i in range(4):
            t1 = time.perf_counter()
            img = f_b(leaves, ob, db)
            loss = (img ** 2).sum() / float(bw * bh)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            torch.cuda.synchronize()
            if i:
                vg_s.append(time.perf_counter() - t1)
            loss_v = float(loss.detach())
        if not (math.isfinite(loss_v) and all(bool(torch.isfinite(g).all())
                                              for g in grads)):
            raise AssertionError(f"1080p value-and-grad on {path.name}: "
                                 f"loss {loss_v}")
        vg_med = sorted(vg_s)[len(vg_s) // 2]
        emit("value_and_grad_1080p", kernel=f_b.bc.variant, scene=path.name,
             rays=bw * bh, depth=opts_b.max_depth, fields=list(fields),
             loss=loss_v, s=vg_s, s_median=vg_med,
             mrays_per_s=bw * bh / vg_med / 1e6, card=card)
        del f_b, leaves, img, loss, grads, ob, db

    # 23. K2b at the main path's shape: one sample's 640,000 rays of
    # feat_pt.xml (phase 22's), feat_pt_rr.xml and feat_pt_spec.xml
    def k2b_bounds(counted, n_bytes_primal, n_bytes_fwd_bwd):
        """The primal's and the fwd+bwd's bounds (K2b, and K2c whose
        Whitted chain has no GI): the counted sweeps' tests once each, the
        step per segment (traced or reusing the GI ray's hit), lit light
        evaluation and GI sample, and in the fwd+bwd their adjoints."""
        seg = counted.get("traces", 0) + counted.get("reused", 0)
        fwd = (seg * STEP_FLOPS + counted["lit_light_evals"] * LIGHT_FLOPS
               + counted.get("gi_traces", 0) * GI_FLOPS)
        adj = (seg * ADJ_STEP_FLOPS
               + counted["lit_light_evals"] * ADJ_LIGHT_FLOPS
               + counted.get("gi_traces", 0) * ADJ_GI_FLOPS)
        return [with_flops(bound(counted, n_bytes), extra)
                for n_bytes, extra in ((n_bytes_primal, fwd),
                                       (n_bytes_fwd_bwd, fwd + adj))]

    k2b_main = {}
    for path in (PT_SCENE, PT_RR_SCENE, PT_SPEC_SCENE):
        cfg_s, pack_s, opts_s, f_s, tabs_s, cam_s = diff_render(path)
        bc = f_s.bc
        o_s, d_s = (t.contiguous() for t in generate_rays(cam_s, px, py))
        n23 = o_s.shape[0]
        gbar = torch.randn((n23, 3), generator=gen, device=dev)
        prim_ms = cuda_ms(lambda: mb.mega_bwd_trace(bc, tabs_s, o_s, d_s), 5)
        fb_ms = cuda_ms(lambda: mb.mega_bwd_trace(bc, tabs_s, o_s, d_s,
                                                  gbar=gbar), 5)
        no_scatter_ms = cuda_ms(lambda: mb.mega_bwd_trace(
            bc, tabs_s, o_s, d_s, gbar=gbar, scatter=False), 5)
        split = scatter_split(bc, tabs_s, o_s, d_s, gbar)
        # the plain version on every 16th ray, the kernel on the same rays
        # and draws
        stride = 16
        os_, ds_, gs_ = (t[::stride].contiguous() for t in (o_s, d_s, gbar))
        draws = mb.bwd_draws(bc, 0, 0, os_.shape[0], device=dev)
        prim = mb.mega_bwd_trace(bc, tabs_s, os_, ds_, draws)
        got, g = mb.mega_bwd_trace(bc, tabs_s, os_, ds_, draws, gbar=gs_)
        torch.cuda.synchronize()
        stats: dict = {}
        t0 = time.perf_counter()
        ref0 = mb.mega_bwd_trace_ref(bc, tabs_s, os_, ds_, draws, stats=stats)
        torch.cuda.synchronize()
        plain_prim_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ref, gref = mb.mega_bwd_trace_ref(bc, tabs_s, os_, ds_, draws, gs_)
        torch.cuda.synchronize()
        plain_fb_ms = (time.perf_counter() - t0) * 1e3
        what = f"K2b at the main path's shape, {path.name}, every 16th ray"
        err_p = check_close(prim, ref0, what + ", primal")
        err_fb = check_close(got, ref, what + ", fwd+bwd")
        gerr = check_grads(g, gref, what)
        del draws, ref, gref, g
        # the tree twins (FWD_FLAT_MAX_FACES at 0) on every ray, against the
        # flat kernels, and the tree's work counted on every ray
        mk.FWD_FLAT_MAX_FACES = 0
        try:
            f_t = mb.make_diff_render(pack_s, opts_s, device=dev)
        finally:
            mk.FWD_FLAT_MAX_FACES = fwd_flat_max
        bct = f_t.bc
        tabs_t = mb.BwdTables(*(t.detach().contiguous()
                                for t in f_t.tables({})))
        flat_p = mb.mega_bwd_trace(bc, tabs_s, o_s, d_s)
        _, flat_g = mb.mega_bwd_trace(bc, tabs_s, o_s, d_s, gbar=gbar)
        tree_p = mb.mega_bwd_trace(bct, tabs_t, o_s, d_s)
        tree_fb, tree_g = mb.mega_bwd_trace(bct, tabs_t, o_s, d_s, gbar=gbar)
        tree_prim_ms = cuda_ms(lambda: mb.mega_bwd_trace(bct, tabs_t, o_s, d_s),
                               5)
        tree_fb_ms = cuda_ms(lambda: mb.mega_bwd_trace(bct, tabs_t, o_s, d_s,
                                                       gbar=gbar), 5)
        what = f"K2b's tree twins at the main path's shape, {path.name}"
        tree_err = {"primal": check_close(tree_p, flat_p, what + ", primal"),
                    "fwd_bwd": check_close(tree_fb, flat_p, what + ", fwd+bwd"),
                    "grads": check_grads(tree_g, flat_g, what)}
        del flat_p, flat_g, tree_p, tree_fb, tree_g
        tree_stats: dict = {}
        table = mb.bwd_draws(bct, 0, 0, n23, device=dev)
        for lo in range(0, n23, 160000):
            part = slice(lo, lo + 160000)
            mb.mega_bwd_trace_ref(
                bct, tabs_t, o_s[part].contiguous(), d_s[part].contiguous(),
                mb.BwdDraws(*(x[:, part].contiguous() for x in table)),
                stats=tree_stats)
        del table
        reads = tree_stats.pop("reads")
        tree_stats.update(nodes_read=int(reads["nodes"].sum()),
                          rows_read=int(reads["rows"].sum()),
                          rows_won=int(reads["won"].sum()))
        counted = {k: v * stride for k, v in stats.items()}
        ext_tabs = (bc.mc.spot_lights, bc.mc.area_lights, bc.mc.ml_lights,
                    bc.ml_rows)
        tables = sum(t.numel() * 4 for t in (
            bc.tri_rest, tabs_s.tri_w, bc.chunk_tab, bc.mc.spheres,
            bc.mc.materials, bc.mc.point_lights, bc.mc.dir_lights, *ext_tabs))
        grads_bytes = sum(t.numel() * 4 for t in tabs_s)
        flat_bd = k2b_bounds(counted, n23 * 9 * 4 + tables,
                             n23 * 18 * 4 + tables + grads_bytes)
        tree_tables = table_bytes(bct.mc, None, reads) + sum(
            t.numel() * 4 for t in ext_tabs)
        tree_grads = (sum(t.numel() * 4 for t in tabs_t) - tabs_t.tri_w.numel()
                      * 4 + tree_stats["rows_won"] * 9 * 4)
        tree_bd = k2b_bounds(tree_stats, n23 * 9 * 4 + tree_tables,
                             n23 * 18 * 4 + tree_tables + tree_grads)
        bd_p, bd_fb = (dict(min(fb, tb, key=lambda x: x["bound_ms"]),
                            counted_over="chunks" if fb["bound_ms"]
                            <= tb["bound_ms"] else "tree")
                       for fb, tb in zip(flat_bd, tree_bd))
        grad_err = max(v["max_abs_err"] for v in gerr.values())
        emit("kernel_at_main_shape", kernel="mega_bwd_pt", scene=path.name,
             rays=n23, plain_stride=stride, primal_ms=prim_ms, fwd_bwd_ms=fb_ms,
             fwd_bwd_no_scatter_ms=no_scatter_ms,
             scatter_ms=fb_ms - no_scatter_ms, device_ms_by_target=split,
             plain_primal_ms=plain_prim_ms,
             plain_fwd_bwd_ms=plain_fb_ms, primal_bound=bd_p,
             fwd_bwd_bound=bd_fb, primal=err_p,
             fwd_bwd_exact_frac=err_fb["exact_frac"], grads=gerr,
             counts=counted, card=card)
        emit("kernel_at_main_shape", kernel="mega_bwd_pt_tree", scene=path.name,
             rays=n23, primal_ms=tree_prim_ms, fwd_bwd_ms=tree_fb_ms,
             flat_primal_ms=prim_ms, flat_fwd_bwd_ms=fb_ms, vs_flat=tree_err,
             counts=tree_stats, count_stride=1, primal_bound=tree_bd[0],
             fwd_bwd_bound=tree_bd[1], flat_primal_bound=flat_bd[0],
             flat_fwd_bwd_bound=flat_bd[1], card=card)
        k2b_main[path.name] = dict(
            prim_ms=prim_ms, fb_ms=fb_ms, scatter_ms=fb_ms - no_scatter_ms,
            split=split,
            plain_prim_ms=plain_prim_ms, plain_fb_ms=plain_fb_ms, bd_p=bd_p,
            bd_fb=bd_fb, err_p=err_p, err_fb={"max_abs_err": max(
                err_fb["max_abs_err"], grad_err)},
            tree_prim_ms=tree_prim_ms, tree_fb_ms=tree_fb_ms, rays=n23)
        del f_s, f_t, tabs_s, tabs_t, o_s, d_s, gbar
    main = k2b_main[PT_SCENE.name]
    others = {name: {k: v[k] for k in ("prim_ms", "fb_ms", "tree_prim_ms",
                                        "tree_fb_ms")}
              for name, v in k2b_main.items() if name != PT_SCENE.name}
    kernels.append({**kernel_entry(
        "mega_bwd_primal_pt", pt_launches["mega_bwd_primal_pt"],
        main["prim_ms"], main["plain_prim_ms"], main["bd_p"], main["err_p"],
        main["rays"], 16, library=mb.LIBRARY, replaces=REPLACES_K2),
        "bound_counted_over": main["bd_p"]["counted_over"],
        "tree_twin_ms": main["tree_prim_ms"], "other_scenes": others})
    kernels.append({**kernel_entry(
        "mega_bwd_pt", pt_launches["mega_bwd_pt"], main["fb_ms"],
        main["plain_fb_ms"], main["bd_fb"], main["err_fb"], main["rays"], 16,
        library=mb.LIBRARY, replaces=REPLACES_K2),
        "scatter_ms": main["scatter_ms"],
        "device_ms": main["split"]["every target"],
        "scatter_device_ms_by_target": {
            k: v["adds_ms"] for k, v in main["split"].items()
            if isinstance(v, dict)},
        "bound_counted_over": main["bd_fb"]["counted_over"],
        "tree_twin_ms": main["tree_fb_ms"], "other_scenes": others})

    # ---- K2c: diffuse image textures (slice C3) ----
    k2c_dir = out_dir / "k2c"
    tiles_path = texture_inverse_scene_xml(
        image=SCENES / "textures" / "floor_tiles.png", out_dir=k2c_dir / "tiles")
    pt_tex_path = textured_pt_scene_xml(SCENES, k2c_dir / "pt")
    k2c_scenes = (
        ("two textures: nearest replace_kd, bilinear blend_kd, a mirror sphere",
         tex_bwd_scene_xml(k2c_dir / "two")),
        ("feat_pt.xml with a bilinear replace_kd floor", pt_tex_path),
        ("floor_tiles.png on the inverse-texture quad (1,048,576 texels)",
         tiles_path))

    # 24. K2c against its plain version: 16,384 primary rays at full depth,
    # both draw modes where the scene draws, over the chunks and the tree
    n24 = 16384
    try:
        for geometry in ("chunks", "tree"):
            if geometry == "tree":
                mk.FWD_FLAT_MAX_FACES = 0
            for label, path in k2c_scenes:
                cfg, _, _, f, tabs, cam = diff_render(path)
                bc = f.bc
                want = ("mega_bwd" + ("_pt" if bc.pt else "") + "_tex"
                        + ("_tree" if geometry == "tree" else ""))
                if bc.variant != want:
                    raise AssertionError(f"K2c {label}: routed to {bc.variant}")
                o, d = primary_rays(cfg.cameras[0], cam, n24, seed=3)
                gen = torch.Generator(device=dev)
                gen.manual_seed(12)
                gbar = torch.randn((n24, 3), generator=gen, device=dev)
                for mode in (("table", "philox") if mb.needs_draws(bc)
                             else ("none",)):
                    draws = (mb.table_draws(bc, n24, gen, dev)
                             if mode == "table" else None)
                    prim = mb.mega_bwd_trace(bc, tabs, o, d, draws, seed=19,
                                             step=3)
                    got, g = mb.mega_bwd_trace(bc, tabs, o, d, draws, seed=19,
                                               step=3, gbar=gbar)
                    torch.cuda.synchronize()
                    if mode == "philox":
                        draws = mb.bwd_draws(bc, 19, 3, n24, device=dev)
                    stats: dict = {}
                    t0 = time.perf_counter()
                    ref, gref = mb.mega_bwd_trace_ref(bc, tabs, o, d, draws,
                                                      gbar, stats=stats)
                    torch.cuda.synchronize()
                    plain_s = time.perf_counter() - t0
                    what = f"K2c {bc.variant}, {label}, {mode}"
                    err = check_close(prim, ref, what + ", primal")
                    err_fb = check_close(got, ref, what + ", fwd+bwd")
                    if not stats.get("texel_taps"):
                        raise AssertionError(f"{what}: no textured hit")
                    emit("kernel_vs_plain", kernel=bc.variant, scene=label,
                         draws=mode, rays=n24, depth=mb.bc_depth(bc),
                         faces=bc.n_tri, texels=tabs.texels.shape[0],
                         texel_taps=stats["texel_taps"], plain_s=plain_s,
                         primal=err, fwd_bwd_exact_frac=err_fb["exact_frac"],
                         fwd_bwd_max_abs_err=err_fb["max_abs_err"],
                         grads=check_grads(g, gref, what), mean_tol=MEAN_TOL,
                         q999_tol=Q999_TOL, grad_rtol=GRAD_RTOL,
                         grad_atol_scale=GRAD_ATOL_SCALE)
                    del draws, gref, g
    finally:
        mk.FWD_FLAT_MAX_FACES = fwd_flat_max

    # 25. the slice's main path: the port's tools/inverse_render.py
    # --texture at its defaults (JAX tools/inverse_render.py --texture)
    steps25, spp25 = 300, 4
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inv = inverse_render.run("texture", steps=steps25, spp=spp25, res=800,
                             lr=5e-3, device=dev, log=lambda _: None)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = counts()
    want = {k: {"mega_bwd_primal_tex": (steps25 + 2) * spp25 + 1,
                "mega_bwd_tex": (steps25 + 1) * spp25}.get(k, 0)
            for k in launches}
    if launches != want:
        raise AssertionError(f"inverse texture main path: launches {launches}, "
                             f"expected {want}")
    history = inv["loss_history"]
    if not (all(math.isfinite(x) for x in history)
            and history[-1] < history[0]):
        raise AssertionError(f"inverse texture main path: loss history "
                             f"{history[::25]} ... {history[-1]}")
    jax_art = json.loads((ROOT / "tools" / "artifacts"
                          / "inverse_render_texture.json").read_text())
    # the recovery: the JAX tool's run of the same scene, start, grids and
    # rate reached 58.68 dB; the port's must not fall more than 1 dB short
    psnr_floor = jax_art["texture_psnr_db"] - PSNR_MARGIN_DB
    if not inv["texture_psnr_db"] >= psnr_floor:
        raise AssertionError(f"inverse texture main path: texture PSNR "
                             f"{inv['texture_psnr_db']} dB below {psnr_floor}"
                             f" dB (the JAX artifact's less {PSNR_MARGIN_DB})")
    emit("main_path", kernel="mega_bwd_tex",
         scene="inverse texture recovery (tools/inverse_render.py --texture)",
         resolution=inv["resolution"], spp=spp25, steps=steps25, lr=inv["lr"],
         rays_per_grid=800 * 800,
         loss_every_25=history[::25] + [history[-1]],
         texture_psnr_db=inv["texture_psnr_db"],
         texture_mse=inv["texture_mse"], max_rel_err=inv["max_rel_err"],
         max_rel_err_observable=inv["max_rel_err_observable"],
         unobservable_entries=inv["unobservable_entries"],
         image_psnr_db=inv["image_psnr_db"], wall_s=inv["wall_s"],
         steps_per_s=inv["steps_per_s"], rays_per_s=inv["rays_per_s"],
         total_s_with_setup=total_s,
         launches={k: v for k, v in launches.items() if v},
         launches_per_step={"mega_bwd_primal_tex": spp25,
                            "mega_bwd_tex": spp25},
         jax_artifact_tpu={k: jax_art[k] for k in (
             "texture_psnr_db", "max_rel_err", "max_rel_err_observable",
             "loss_first", "loss_last", "image_psnr_db")}, card=card)
    tex_launches = dict(launches)

    # 26. K2c at the main path's shape: one sample grid's 640,000 rays of
    # the 64x64 scene, the true texture
    cfg, pack, opts, f, tabs, cam = diff_render(
        texture_inverse_scene_xml(64, out_dir=k2c_dir / "inv"))
    bc = f.bc
    o, d = inverse_render.sample_grids(cfg.cameras[0], cam, 800, 1, dev)[0]
    n26 = o.shape[0]
    gbar = torch.randn((n26, 3), generator=gen, device=dev)
    prim_ms = cuda_ms(lambda: mb.mega_bwd_trace(bc, tabs, o, d), 5)
    fb_ms = cuda_ms(lambda: mb.mega_bwd_trace(bc, tabs, o, d, gbar=gbar), 5)
    no_scatter_ms = cuda_ms(lambda: mb.mega_bwd_trace(
        bc, tabs, o, d, gbar=gbar, scatter=False), 5)
    # the main path asks for the texels alone (the tool optimizes img_atlas)
    tex_ms = cuda_ms(lambda: mb.mega_bwd_trace(
        bc, tabs, o, d, gbar=gbar, scatter=("texels",)), 5)
    split = scatter_split(bc, tabs, o, d, gbar)
    prim_dev_ms = device_ms(lambda: mb.mega_bwd_trace(bc, tabs, o, d),
                            "mega_bwd")
    stride = 16
    os_, ds_, gs_ = (t[::stride].contiguous() for t in (o, d, gbar))
    prim = mb.mega_bwd_trace(bc, tabs, os_, ds_)
    got, g = mb.mega_bwd_trace(bc, tabs, os_, ds_, gbar=gs_)
    torch.cuda.synchronize()
    stats = {}
    t0 = time.perf_counter()
    ref0 = mb.mega_bwd_trace_ref(bc, tabs, os_, ds_, stats=stats)
    torch.cuda.synchronize()
    plain_prim_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref, gref = mb.mega_bwd_trace_ref(bc, tabs, os_, ds_, gbar=gs_)
    torch.cuda.synchronize()
    plain_fb_ms = (time.perf_counter() - t0) * 1e3
    what = "K2c at the main path's shape, every 16th ray"
    err_p = check_close(prim, ref0, what + ", primal")
    err_fb = check_close(got, ref, what + ", fwd+bwd")
    gerr = check_grads(g, gref, what)
    # the floor cut in two quads that read one 8x8 image through a nearest
    # and a bilinear texture: the warp's texel sums group lanes by first
    # tap and filter, held to the plain version on every 16th ray
    cfg_s, _, _, f_s, tabs_s, cam_s = diff_render(
        shared_image_scene_xml(out_dir=k2c_dir / "shared"))
    if len(f_s.bc.mc.tex_images) != 1:
        raise AssertionError("the two textures' image pooled more than once")
    o_s, d_s = (t[::stride].contiguous() for t in inverse_render.sample_grids(
        cfg_s.cameras[0], cam_s, 800, 1, dev)[0])
    _, g_s = mb.mega_bwd_trace(f_s.bc, tabs_s, o_s, d_s, gbar=gs_)
    _, gref_s = mb.mega_bwd_trace_ref(f_s.bc, tabs_s, o_s, d_s, gbar=gs_)
    gerr_filters = check_grads(g_s, gref_s, "K2c, a nearest and a bilinear "
                               "texture on one image, every 16th ray")
    del f_s, tabs_s, o_s, d_s, g_s, gref_s
    mk.FWD_FLAT_MAX_FACES = 0
    try:
        f_tree = mb.make_diff_render(pack, opts, device=dev)
    finally:
        mk.FWD_FLAT_MAX_FACES = fwd_flat_max
    bct = f_tree.bc
    tabs_t = mb.BwdTables(*(t.detach().contiguous()
                            for t in f_tree.tables({})))
    tree_prim_ms = cuda_ms(lambda: mb.mega_bwd_trace(bct, tabs_t, o, d), 5)
    tree_fb_ms = cuda_ms(lambda: mb.mega_bwd_trace(bct, tabs_t, o, d,
                                                   gbar=gbar), 5)
    what = "K2c's tree twins at the main path's shape, against the flat"
    flat_p = mb.mega_bwd_trace(bc, tabs, o, d)
    _, flat_g = mb.mega_bwd_trace(bc, tabs, o, d, gbar=gbar)
    tree_fb, tree_g = mb.mega_bwd_trace(bct, tabs_t, o, d, gbar=gbar)
    tree_err = {"fwd_bwd": check_close(tree_fb, flat_p, what + ", fwd+bwd"),
                "grads": check_grads(tree_g, flat_g, what)}
    del flat_p, flat_g, tree_fb, tree_g
    # the bound: the chunks' tests (two faces, one chunk) on every 16th ray
    # times 16, the step and its adjoint per segment and lit light, and per
    # textured step and tap; bytes: the rays, the tables and the texel pool
    # read once, and in the fwd+bwd the radiance's cotangent in and every
    # cotangent out (the pool's included)
    counted = {k: v * stride for k, v in stats.items()}
    tex_extra = (counted["tex_steps"] * TEX_FLOPS,
                 counted["tex_steps"] * ADJ_TEX_FLOPS
                 + counted["texel_taps"] * ADJ_TAP_FLOPS)
    tables = sum(t.numel() * t.element_size() for t in (
        bc.tri_rest, tabs.tri_w, bc.chunk_tab, bc.mc.spheres, bc.mc.materials,
        bc.mc.point_lights, bc.mc.dir_lights, bc.mc.tex_face, bc.mc.tex_int,
        tabs.texels))
    grads_bytes = sum(t.numel() * 4 for t in tabs)
    bd_p, bd_fb = k2b_bounds(counted, n26 * 9 * 4 + tables,
                             n26 * 18 * 4 + tables + grads_bytes)
    for bd, extra in ((bd_p, tex_extra[0]), (bd_fb, sum(tex_extra))):
        with_flops(bd, extra)
    emit("kernel_at_main_shape", kernel="mega_bwd_tex", rays=n26,
         plain_stride=stride, primal_ms=prim_ms, fwd_bwd_ms=fb_ms,
         fwd_bwd_no_scatter_ms=no_scatter_ms,
         scatter_ms=fb_ms - no_scatter_ms, fwd_bwd_texels_ms=tex_ms,
         primal_device_ms=prim_dev_ms, device_ms_by_target=split,
         grads_two_filters_one_image=gerr_filters,
         flags={"every target": hex(mb.scatter_flags(bc, True)),
                "texels": hex(mb.scatter_flags(bc, ("texels",)))},
         plain_primal_ms=plain_prim_ms,
         plain_fwd_bwd_ms=plain_fb_ms, primal_bound=bd_p, fwd_bwd_bound=bd_fb,
         primal=err_p, fwd_bwd_exact_frac=err_fb["exact_frac"], grads=gerr,
         counts=counted, tree_primal_ms=tree_prim_ms,
         tree_fwd_bwd_ms=tree_fb_ms, tree_vs_flat=tree_err,
         launches_per_step={"mega_bwd_primal_tex": spp25,
                            "mega_bwd_tex": spp25}, card=card)
    # the path-traced twins on the textured feat_pt.xml, one sample's rays
    _, _, _, f_pt, tabs_pt, cam_pt = diff_render(pt_tex_path)
    o_pt, d_pt = (t.contiguous() for t in generate_rays(
        cam_pt, (torch.arange(n26, device=dev) % 800).float() + 0.5,
        (torch.arange(n26, device=dev) // 800).float() + 0.5))
    pt_prim_ms = cuda_ms(lambda: mb.mega_bwd_trace(f_pt.bc, tabs_pt, o_pt,
                                                   d_pt), 5)
    pt_fb_ms = cuda_ms(lambda: mb.mega_bwd_trace(f_pt.bc, tabs_pt, o_pt, d_pt,
                                                 gbar=gbar), 5)
    pt_no_scatter_ms = cuda_ms(lambda: mb.mega_bwd_trace(
        f_pt.bc, tabs_pt, o_pt, d_pt, gbar=gbar, scatter=False), 5)
    emit("kernel_at_main_shape", kernel=f_pt.bc.variant,
         scene="feat_pt.xml with a textured floor", rays=n26,
         primal_ms=pt_prim_ms, fwd_bwd_ms=pt_fb_ms,
         scatter_ms=pt_fb_ms - pt_no_scatter_ms, card=card)
    del f_pt, tabs_pt, o_pt, d_pt
    # the fwd+bwd on the 1,048,576-texel quad (the warp's sums go to global
    # memory, as for every pool), one sample grid: timed, and held to the
    # plain version on every 16th ray
    cfg_b, pack_b, _, f_b, tabs_b, cam_b = diff_render(tiles_path)
    ot, dt = inverse_render.sample_grids(cfg_b.cameras[0], cam_b, 800, 1,
                                         dev)[0]
    split_big = scatter_split(f_b.bc, tabs_b, ot, dt, gbar)
    ots, dts, gts = (t[::stride].contiguous() for t in (ot, dt, gbar))
    _, g_big = mb.mega_bwd_trace(f_b.bc, tabs_b, ots, dts, gbar=gts)
    _, gref_big = mb.mega_bwd_trace_ref(f_b.bc, tabs_b, ots, dts, gbar=gts)
    emit("kernel_vs_plain", kernel=f_b.bc.variant,
         scene="floor_tiles.png quad (1,048,576 texels), one sample grid",
         rays=ot.shape[0], plain_stride=stride,
         grads=check_grads(g_big, gref_big, "K2c on the 1,048,576-texel "
                           "pool, every 16th ray"),
         device_ms_by_target=split_big, card=card)
    del ot, dt, ots, dts, gts, g_big, gref_big, tabs_b
    # one value-and-grad of sum(img^2) / n with respect to img_atlas at
    # 1920x1080 on the 1,048,576-texel quad, the median of 3 after a warm-up
    bw, bh = 1920, 1080
    ys, xs = np.divmod(np.arange(bw * bh, dtype=np.int64), bw)
    ob, db = (t.contiguous() for t in generate_rays(
        cam_b, torch.as_tensor(xs * (cfg_b.cameras[0].width / bw),
                               dtype=torch.float32, device=dev),
        torch.as_tensor(ys * (cfg_b.cameras[0].height / bh),
                        dtype=torch.float32, device=dev)))
    atlas = pack_b.img_atlas.detach().clone().requires_grad_(True)
    vg_s = []
    for i in range(4):
        t1 = time.perf_counter()
        img = f_b({"img_atlas": atlas}, ob, db)
        loss = (img ** 2).sum() / float(bw * bh)
        (g_atlas,) = torch.autograd.grad(loss, [atlas])
        torch.cuda.synchronize()
        if i:
            vg_s.append(time.perf_counter() - t1)
    if not (math.isfinite(float(loss)) and bool(torch.isfinite(g_atlas).all())
            and float(g_atlas.abs().sum()) > 0):
        raise AssertionError(f"1080p value-and-grad on floor_tiles.png: loss "
                             f"{float(loss)}")
    vg_med = sorted(vg_s)[len(vg_s) // 2]
    emit("value_and_grad_1080p", kernel=f_b.bc.variant,
         scene="floor_tiles.png quad", texels=int(pack_b.img_w[0])
         * int(pack_b.img_h[0]), rays=bw * bh, fields=["img_atlas"],
         loss=float(loss), texels_with_gradient=int(
             (g_atlas.abs().sum(-1) > 0).sum()), s=vg_s, s_median=vg_med,
         mrays_per_s=bw * bh / vg_med / 1e6, card=card)
    del f_b, atlas, img, loss, g_atlas, ob, db
    grad_err = max(v["max_abs_err"] for v in gerr.values())
    pt_twins = {"feat_pt.xml, textured floor": {
        "prim_ms": pt_prim_ms, "fb_ms": pt_fb_ms,
        "scatter_ms": pt_fb_ms - pt_no_scatter_ms}}
    kernels.append({**kernel_entry(
        "mega_bwd_primal_tex", tex_launches["mega_bwd_primal_tex"], prim_ms,
        plain_prim_ms, bd_p, err_p, n26, stride, library=mb.LIBRARY,
        replaces=REPLACES_K2C), "device_ms": prim_dev_ms,
        "bound_counted_over": "chunks",
        "tree_twin_ms": tree_prim_ms, "pt_twin": pt_twins})
    kernels.append({**kernel_entry(
        "mega_bwd_tex", tex_launches["mega_bwd_tex"], fb_ms, plain_fb_ms,
        bd_fb, {"max_abs_err": max(err_fb["max_abs_err"], grad_err)}, n26,
        stride, library=mb.LIBRARY, replaces=REPLACES_K2C),
        "scatter_ms": fb_ms - no_scatter_ms, "device_ms": split["every target"],
        "main_path_ms": tex_ms, "scatter_device_ms_by_target": {
            k: v["adds_ms"] for k, v in split.items() if isinstance(v, dict)},
        "bound_counted_over": "chunks",
        "tree_twin_ms": tree_fb_ms, "pt_twin": pt_twins})

    # 27. K3 against its plain version, bit for bit, on 65,536 rays of each
    # table: the slice D1 scene's items and shadow items, feat_pt.xml's 12
    # items, a random 2,048-item table with det = 0 items and ties, and the
    # motion scene's items with their motion rows
    d1_dir = out_dir / "d1"
    d1_path = pt_env_dof_scene_xml(SCENES, d1_dir, torus=PT_ENV_TORUS)
    cfg_d1 = load_scene(d1_path)
    pack_d1 = pack_scene(cfg_d1, device=dev)
    cam_d1 = build_camera(cfg_d1.cameras[0], device=dev)
    st_d1 = pack_d1.static
    if st_d1.use_bvh or st_d1.n_work_items != 12 + 1920:
        raise AssertionError(f"slice D1 scene: {st_d1.n_work_items} work "
                             f"items, use_bvh {st_d1.use_bvh}")
    n27 = 65536
    o27, d27 = primary_rays(cfg_d1.cameras[0], cam_d1, n27, seed=27)

    def k3_check(what, o, d, v0, v1, v2, mo=None, tau=None):
        got = k3.tri_closest_hit(o, d, v0, v1, v2, mo, tau)
        ref = k3.tri_closest_hit_ref(o, d, v0, v1, v2, mo, tau)
        torch.cuda.synchronize()
        exact = [bool(torch.equal(a, b)) for a, b in zip(got, ref)]
        if not all(exact):
            raise AssertionError(f"K3 on {what}: t, idx, beta, gamma equal "
                                 f"{exact}")
        hit = got[1] >= 0
        return {"items": int(v0.shape[0]), "rays": int(o.shape[0]),
                "hit_frac": float(hit.float().mean()), "exact": exact}

    g27 = np.random.default_rng(27)
    rnd = {}
    for name in ("v0", "v1", "v2"):
        rnd[name] = g27.uniform(-1.0, 1.0, (2048, 3)).astype(np.float32)
    rnd["v1"] = rnd["v0"] + 0.6 * (rnd["v1"] - rnd["v0"])
    rnd["v2"] = rnd["v0"] + 0.6 * (rnd["v2"] - rnd["v0"])
    rnd["v1"][4::5] = rnd["v0"][4::5]  # det = 0
    for name in ("v0", "v1", "v2"):
        rnd[name][6::7] = rnd[name][0]  # exact ties with item 0
    rv0, rv1, rv2 = (torch.as_tensor(rnd[k], device=dev)
                     for k in ("v0", "v1", "v2"))
    pick = torch.as_tensor(g27.integers(0, 2048, n27), device=dev)
    ro = torch.as_tensor(g27.uniform(-0.3, 0.3, (n27, 3)).astype(np.float32)
                         + np.float32([0, 0, 3]), device=dev)
    rd = (rv0[pick] + 0.3 * (rv1[pick] - rv0[pick])
          + 0.3 * (rv2[pick] - rv0[pick]) - ro).contiguous()
    cfg_pt = load_scene(str(PT_SCENE))
    pack_pt = pack_scene(cfg_pt, device=dev)
    mo_path = d1_dir / "motion_rough.xml"
    mo_path.write_text(MOTION_ROUGH_XML)
    cfg_mo = load_scene(str(mo_path))
    pack_mo = pack_scene(cfg_mo, device=dev)
    o_mo, d_mo = primary_rays(cfg_mo.cameras[0], build_camera(
        cfg_mo.cameras[0], device=dev), n27, seed=28)
    tau = torch.rand(n27, generator=torch.Generator(device=dev).manual_seed(27),
                     device=dev)
    checks27 = {
        "slice D1 scene, items": k3_check(
            "the D1 items", o27, d27, pack_d1.wi_v0, pack_d1.wi_v1,
            pack_d1.wi_v2),
        "slice D1 scene, shadow items": k3_check(
            "the D1 shadow items", o27, d27, pack_d1.ws_v0, pack_d1.ws_v1,
            pack_d1.ws_v2),
        "feat_pt.xml, 12 items": k3_check(
            "feat_pt.xml", o27, d27, pack_pt.wi_v0, pack_pt.wi_v1,
            pack_pt.wi_v2),
        "random 2,048 items, det = 0 and ties": k3_check(
            "the random table", ro, rd, rv0, rv1, rv2),
        "motion scene, items with motion": k3_check(
            "the motion table", o_mo, d_mo, pack_mo.wi_v0, pack_mo.wi_v1,
            pack_mo.wi_v2, pack_mo.wi_motion, tau),
    }
    # the edges of the kernel's rejection before its divisions (its
    # header): quotients within rounding of 0 and 1, ties at the best t,
    # determinants outside the trusted range, denormals, det = 0, motion;
    # a ray count that is no multiple of a block's rays
    for name, tab in k3.edge_tables(65537, seed=27, device=dev).items():
        checks27[f"edge table: {name}"] = k3_check(f"the edge table {name}",
                                                   *tab)
    if checks27["random 2,048 items, det = 0 and ties"]["hit_frac"] < 0.2:
        raise AssertionError(f"K3 random table: {checks27}")
    emit("k3_check", kernel="tri_intersect", checks=checks27, card=card)
    del ro, rd, o_mo, d_mo, tau

    # the main path's rays: the pixel centres plus one fixed jitter,
    # through the lens of the main path's draws
    cam_cfg = cfg_d1.cameras[0]
    w, h = cam_cfg.width, cam_cfg.height
    idx = torch.arange(w * h, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    jit = torch.rand((w * h, 2), generator=gen, device=dev)
    px29 = (idx % w).float() + jit[:, 0]
    py29 = (idx // w).float() + jit[:, 1]
    n29 = w * h
    draws29 = wrng.PhiloxDraws(0, device=dev)
    lens = draws29.uniform(-1, wrng.SITE_LENS, n29, 2, lo=-1.0, hi=1.0)
    o28, d28 = (t.contiguous() for t in generate_rays(cam_d1, px29, py29, lens,
                                                      dof=True))

    # 28. K3 at the main path's shape
    k3_ms = cuda_ms(lambda: k3.tri_closest_hit(o28, d28, pack_d1.wi_v0,
                                               pack_d1.wi_v1, pack_d1.wi_v2), 5)
    k3_dev_ms = device_ms(lambda: k3.tri_closest_hit(
        o28, d28, pack_d1.wi_v0, pack_d1.wi_v1, pack_d1.wi_v2), "tri_intersect")
    got28 = k3.tri_closest_hit(o28, d28, pack_d1.wi_v0, pack_d1.wi_v1,
                               pack_d1.wi_v2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref28 = k3.tri_closest_hit_ref(o28, d28, pack_d1.wi_v0, pack_d1.wi_v1,
                                   pack_d1.wi_v2)
    torch.cuda.synchronize()
    k3_plain_ms = (time.perf_counter() - t0) * 1e3
    exact28 = [bool(torch.equal(a, b)) for a, b in zip(got28, ref28)]
    if not all(exact28):
        raise AssertionError(f"K3 at the main path's shape: equal {exact28}")
    hit28 = got28[1] >= 0
    err28 = max(float((got28[0][hit28] - ref28[0][hit28]).abs().max()),
                float((got28[2] - ref28[2]).abs().max()),
                float((got28[3] - ref28[3]).abs().max()))
    w28 = int(pack_d1.wi_v0.shape[0])
    k3_flops = n29 * w28 * K3_TEST_FLOPS
    k3_bytes = n29 * (24 + 16) + w28 * 36
    bd28 = {"flops": k3_flops, "bytes": k3_bytes,
            "ops_ms": k3_flops / PEAK_FP32_FLOPS * 1e3,
            "bytes_ms": k3_bytes / PEAK_BYTES_S * 1e3}
    bd28["bound_ms"] = max(bd28["ops_ms"], bd28["bytes_ms"])
    bd28["bound_by"] = ("operations" if bd28["ops_ms"] >= bd28["bytes_ms"]
                        else "bytes")
    emit("kernel_at_main_shape", kernel="tri_intersect",
         scene="slice D1 (feat_pt.xml + 1,920-face torus + sky + lens)",
         rays=n29, items=w28, ms=k3_ms, device_ms=k3_dev_ms,
         plain_ms=k3_plain_ms, exact=exact28,
         hit_frac=float(hit28.float().mean()), bound=bd28,
         frac_of_bound=bd28["bound_ms"] / k3_ms, card=card)
    del got28, ref28, o28, d28

    # 29. the slice's main path: optimize through the wavefront, 6 Adam
    # steps on the target's draws
    opts29 = renderer.options_for_camera(cfg_d1, cam_cfg)
    missing29 = mb.bwd_missing(st_d1, opts29, pack_d1)
    if missing29 != ["an environment light"] or not cam_d1.use_dof:
        raise AssertionError(f"slice D1 scene inside the fused kernels: "
                             f"{missing29}, DoF {cam_d1.use_dof}")
    fields29 = ("mat_diffuse", "ml_radiance")
    rates29 = {k: FEAT_PT_RATES[k] for k in fields29}
    g29 = np.random.default_rng(7)
    start29 = {
        "mat_diffuse": pack_d1.mat_diffuse * torch.as_tensor(g29.uniform(
            0.7, 1.1, tuple(pack_d1.mat_diffuse.shape)).astype(np.float32),
            device=dev),
        "ml_radiance": pack_d1.ml_radiance * 1.2}
    steps29 = 6
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        target29 = trace_radiance(pack_d1, cam_d1, px29, py29, draws29, opts29)
    _, history29 = optimize(inject_params(pack_d1, start29), cam_d1, px29, py29,
                            opts29, target29, fields29, steps=steps29,
                            lr=rates29, device=dev, draws=[draws29] * steps29)
    torch.cuda.synchronize()
    total29 = time.perf_counter() - t0
    launches29 = counts()
    k3_launches = launches29["tri_intersect"]
    others = {k: v for k, v in launches29.items() if v and k != "tri_intersect"}
    if others or not k3_launches:
        raise AssertionError(f"slice D1 main path: launches {launches29}")
    if not (all(math.isfinite(x) for x in history29)
            and all(b < a for a, b in zip(history29, history29[1:]))):
        raise AssertionError(f"slice D1 main path: loss history {history29}")
    # the step in a loop of its own, a fresh draw key each step (optimize's
    # default): one warm-up and 5 timed; K3's launches and time per step
    w_opts = dataclasses.replace(opts29, differentiable=True)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in start29.items()}
    adam = torch.optim.Adam([{"params": [params[k]], "lr": rates29[k]}
                             for k in fields29])
    step_s, fresh_history, k3_per_step = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(6):
        torch.cuda.synchronize()
        n_k3 = k3.LAUNCHES["tri_intersect"]
        t1 = time.perf_counter()
        adam.zero_grad(set_to_none=True)
        fresh_history.append(wavefront_value_and_grad(
            pack_d1, cam_d1, px29, py29, w_opts, target29, params,
            wrng.PhiloxDraws(0, sample=i, device=dev)))
        adam.step()
        torch.cuda.synchronize()
        k3_per_step.append(k3.LAUNCHES["tri_intersect"] - n_k3)
        if i:
            step_s.append(time.perf_counter() - t1)
    peak29 = torch.cuda.max_memory_allocated()
    # one more step (a fresh key) in a profiler trace: where the device time
    # goes, op by op, beside the timed steps
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tdir:
        with profiling.device_trace(tdir) as prof:
            adam.zero_grad(set_to_none=True)
            wavefront_value_and_grad(
                pack_d1, cam_d1, px29, py29, w_opts, target29, params,
                wrng.PhiloxDraws(0, sample=6, device=dev))
            adam.step()
            torch.cuda.synchronize()
        trace_files = [f.stat().st_size for f in Path(tdir).iterdir()]
    del params, adam
    step_med = sorted(step_s)[len(step_s) // 2]
    split29 = device_split(prof)
    if len(trace_files) != 1 or not split29["parts_ms"]["K3"] > 0:
        raise AssertionError(f"profiled step: trace files {trace_files}, "
                             f"split {split29}")
    emit("profiled_step", scene="slice D1", top=top_device(prof),
         **split29, device_busy_frac_of_timed_step=(
             split29["total_device_ms"] / (step_med * 1e3)),
         trace_mb=trace_files[0] / 1e6, card=card)
    del prof
    k3_step_ms = k3_per_step[-1] * k3_ms  # its launches at phase 28's time
    emit("main_path", kernel="tri_intersect (wavefront, torch autograd)",
         scene="slice D1: feat_pt.xml + 1,920-face torus + sky.hdr env "
               "light + thin lens", width=w, height=h, rays=n29,
         depth=opts29.max_depth, fields=list(fields29), lr=rates29,
         steps=steps29, loss_history=history29,
         fresh_draws_loss_history=fresh_history, step_s=step_s,
         step_s_median=step_med, mrays_per_s=n29 / step_med / 1e6,
         k3_launches_per_step=k3_per_step, k3_ms_per_step=k3_step_ms,
         step_ms_outside_k3=step_med * 1e3 - k3_step_ms,
         peak_memory_gb=peak29 / 1e9,
         total_s_with_setup=total29,
         launches={k: v for k, v in launches29.items() if v}, card=card)
    del target29

    # 30. the forward route: render_camera at depth 12 through the
    # wavefront; the depth-4 frame against K1d in expectation; one BVH query
    d12_path = pt_env_dof_scene_xml(SCENES, d1_dir, torus=PT_ENV_TORUS,
                                    depth=12)
    cfg12 = load_scene(d12_path)
    pack12 = pack_scene(cfg12, device=dev)
    opts12 = renderer.options_for_camera(cfg12, cfg12.cameras[0])
    if mk.mega_missing(pack12.static, opts12, pack12) != ["depth above 10"]:
        raise AssertionError("the depth-12 scene is inside the megakernel")
    renderer.render_camera(pack12, cfg12, cfg12.cameras[0], spp=1, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame12 = renderer.render_camera(pack12, cfg12, cfg12.cameras[0], spp=16,
                                     device=dev)
    frame_s = time.perf_counter() - t0
    launches30 = counts()
    if (any(v for k, v in launches30.items() if k != "tri_intersect")
            or not launches30["tri_intersect"]):
        raise AssertionError(f"depth-12 frame: launches {launches30}")
    if not (frame12.shape == (h, w, 3) and np.isfinite(frame12).all()
            and frame12.mean() > 1.0):
        raise AssertionError(f"depth-12 frame: {frame12.shape}, mean "
                             f"{frame12.mean()}")
    write_png(str(out_dir / "pt_env_dof_d12.png"),
              renderer.ldr_from_radiance(frame12))
    # Welch z over per-seed frame means (1 spp, 800x800): the wavefront
    # against K1d (the verify notes: per-seed means, not per-lane sigmas)
    means = {"wavefront": [], "K1d": []}
    mc_d1 = renderer._mega_build_cached(pack_d1, opts29, dev)[0]
    if mc_d1.kernel != "mega_tex":
        raise AssertionError(f"depth-4 scene routes to {mc_d1.kernel}")
    for seed in range(WELCH_SEEDS):
        wf = renderer._render_image_wavefront(pack_d1, cam_d1, opts29, 1, w, h,
                                              seed, None)
        means["wavefront"].append(float(wf.double().mean()))
        k1 = renderer.render_camera(pack_d1, cfg_d1, cam_cfg, seed=seed, spp=1,
                                    device=dev)
        means["K1d"].append(float(k1.astype(np.float64).mean()))
    a, b = np.array(means["wavefront"]), np.array(means["K1d"])
    z = float((a.mean() - b.mean()) / math.sqrt(
        a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b)))
    if not abs(z) < WELCH_Z:
        raise AssertionError(f"wavefront vs K1d frame means: z {z}, {means}")
    # one BVH-strategy query: the 32,768-face torus of whitted_conductors.xml
    cfg_w = load_scene(str(WHITTED_SCENE))
    pack_w = pack_scene(cfg_w, device=dev)
    if not pack_w.static.use_bvh:
        raise AssertionError("whitted_conductors.xml takes the brute strategy")
    o30, d30 = primary_rays(cfg_w.cameras[0], build_camera(
        cfg_w.cameras[0], device=dev), 65536, seed=30)
    traverse.closest_hit(pack_w, o30[:1024], d30[:1024])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hit30 = traverse.closest_hit(pack_w, o30, d30)
    torch.cuda.synchronize()
    bvh_s = time.perf_counter() - t0
    emit("main_path", kernel="tri_intersect (wavefront forward)",
         scene="slice D1 at depth 12", width=w, height=h, spp=16,
         frame_s=frame_s, mpaths_per_s=w * h * 16 / frame_s / 1e6,
         frame_mean=float(frame12.mean()),
         launches={k: v for k, v in launches30.items() if v},
         welch={"z": z, "seeds": WELCH_SEEDS, **means},
         bvh_query={"scene": "whitted_conductors.xml", "faces":
                    pack_w.static.n_faces, "rays": 65536, "s": bvh_s,
                    "hit_frac": float(hit30.valid.float().mean())}, card=card)
    del frame12, hit30, o30, d30
    kernels.append({**kernel_entry(
        "tri_intersect", k3_launches, k3_ms, k3_plain_ms, bd28,
        {"max_abs_err": err28}, n29, 1, library=k3.LIBRARY,
        replaces=REPLACES_K3), "items": w28, "device_ms": k3_dev_ms})

    # 31. K4 against its plain version, bit for bit (NaN lanes alike), and
    # its path counts against gather_plan_ref: the JAX probe's two asserted
    # configurations, its sweep, the frame-size one, edge lanes and the
    # window's edges; at the frame size K4's time with its window and with
    # every group direct (in turns), embedding_bag's and the plain
    # version's times with L2 flushed, and the bound
    win31 = k4.WINDOW_BYTES

    def k4_check(what, idx, tab, window=win31, want_paths=None):
        paths = torch.zeros(2, dtype=torch.int32, device=dev)
        # freed just before the call: a lane the kernel never writes keeps
        # this value and fails the comparison
        torch.full(idx.shape[1:], 7.0, device=dev)
        got = k4.gather_sum(idx, tab, window, paths)
        ref = k4.gather_sum_ref(idx, tab)
        torch.cuda.synchronize()
        ok = ~torch.isnan(ref)
        if not (torch.equal(torch.isnan(got), ~ok)
                and torch.equal(got[ok], ref[ok])):
            raise AssertionError(f"K4 on {what}: differs from its plain "
                                 f"version")
        plan = list(k4.gather_plan_ref(
            idx, tab.numel(), window if tab.data_ptr() % 16 == 0 else 0)[
                "counts"])
        if paths.tolist() != plan or (want_paths is not None
                                      and plan != want_paths):
            raise AssertionError(f"K4 on {what}: paths {paths.tolist()}, "
                                 f"plan {plan}, expected {want_paths}")
        return {"lanes": got.numel(), "taps": int(idx.shape[0]),
                "window_bytes": window, "paths": plan,
                "ordered": window > 0 and k4.ordered(tab),
                "nan_lanes": int((~ok).sum()),
                "max_abs_err": float((got[ok] - ref[ok]).abs().max())}

    def k4_inputs(cfg, seed=31):
        return probe_bigtex.make_inputs(
            cfg["n_rows"], cfg["taps"], cfg["spread"], cfg["blocks"],
            seed=seed, device=dev)

    checks31 = {}
    for (cfg, _), what in zip(probe_bigtex.ASSERTED,
                              ("JAX asserted 1", "JAX asserted 2")):
        checks31[what] = k4_check(what, *k4_inputs(cfg))
    for cfg in probe_bigtex.SWEEP:
        idx31, tab31 = k4_inputs(cfg)
        for w in (win31, 0):
            checks31[f"spread {cfg['spread']}, window {w}"] = k4_check(
                f"spread {cfg['spread']}", idx31, tab31, w)
    idx31, tab31 = k4_inputs(probe_bigtex.ASSERTED[0][0])
    n31 = tab31.numel()
    edge31 = torch.tensor(
        [[0, n31 - 1, 5, 5, 3, -1, n31, 2**31 - 1, -2**31, 9],
         [0, n31 - 1, 5, 5, 3, 4, 7, 1, 2, n31 + 5],
         [0, n31 - 1, 5, 9, 3, 4, 7, 1, 2, 0]], dtype=torch.int32, device=dev)
    checks31["edge lanes"] = k4_check("the edge lanes", edge31, tab31)
    if checks31["edge lanes"]["nan_lanes"] != 5:
        raise AssertionError(f"K4 edge lanes: {checks31['edge lanes']}")
    # the window's edges: a group spanning exactly win31 bytes (window) and
    # win31 + 16 (direct), beside a group of one table row (window) and a
    # partial last group of 100 lanes with an index outside the table and
    # one of its taps all outside (window), in a table past L2 (ordered)
    gen31 = torch.Generator(device=dev)
    gen31.manual_seed(31)
    tab_e = torch.rand(16 * 2**20, generator=gen31, device=dev)
    g31 = k4.GROUP
    for extra, want in ((0, [3, 1]), (16, [2, 2])):
        # group 0 spans [0, hi]: win31 bytes, or win31 + 16
        hi = (win31 + extra) // 4 - 1
        ix = torch.randint(0, hi + 1, (4, 3 * g31 + 100), generator=gen31,
                           device=dev, dtype=torch.int32)
        ix[0, 0], ix[1, 1] = 0, hi
        # group 1 within 128 entries; group 2 with one lane 4 MB away
        ix[:, g31:2 * g31] = 9000 + ix[:, g31:2 * g31] % 128
        ix[:, 2 * g31] += 2**20
        # the last group's lanes all NaN: tap 2 outside the table, and one
        # index below 0
        ix[:, 3 * g31:] = 100 + ix[:, 3 * g31:] % 512
        ix[0, 3 * g31 + 7] = -3
        ix[2, 3 * g31:] = tab_e.numel() + 11
        checks31[f"span window + {extra}"] = k4_check(
            f"a span of the window + {extra} bytes", ix, tab_e, win31, want)
    # incoherent: spread = n_rows - 2, every group direct; a table off 16
    # bytes and 5 taps, both direct; more groups than the order kernel
    # stages (its scatter into device memory)
    inc = dict(n_rows=8192, taps=4, spread=8190, blocks=256)
    idx_i, tab_i = k4_inputs(inc)
    checks31["incoherent"] = k4_check("the incoherent configuration", idx_i,
                                      tab_i, want_paths=[0, 256])
    checks31["table off 16 bytes"] = k4_check(
        "a table off 16 bytes", idx31.reshape(1, -1)[:, 1:] - 1,
        tab31.reshape(-1)[1:], want_paths=[0, 64])
    checks31["5 taps"] = k4_check(
        "5 taps", torch.randint(0, n31, (5, 4000), generator=gen31,
                                device=dev, dtype=torch.int32), tab31,
        want_paths=[0, 4])
    frame = probe_bigtex.FRAME
    many = dict(frame, taps=1, blocks=40000)
    checks31["40,000 groups"] = k4_check(
        "40,000 groups, 1 tap", *k4_inputs(many), want_paths=[40000, 0])
    idx31, tab31 = k4_inputs(frame)
    checks31["frame size"] = k4_check(
        "the frame-size configuration", idx31, tab31,
        want_paths=[frame["blocks"], 0])
    checks31["frame size, direct"] = k4_check(
        "the frame-size configuration, direct", idx31, tab31, 0,
        want_paths=[0, frame["blocks"]])
    taps31, lanes31 = idx31.shape[0], idx31[0].numel()
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)

    def flushed_ms(fn, reps):
        """Median time of one call after a 256 MB write (L2 is 50 MB)."""
        fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for i, (a, b) in enumerate(ev):
            flush.fill_(float(i))
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return sorted(a.elapsed_time(b) for a, b in ev)[reps // 2]

    # in turns: the window, every group direct, direct, the window
    turns31 = [(w, flushed_ms(lambda: k4.gather_sum(idx31, tab31, w), 64))
               for w in (win31, 0, 0, win31)]
    k4_ms = float(np.median([t for w, t in turns31 if w]))
    k4_direct_ms = float(np.median([t for w, t in turns31 if not w]))
    k4_plain_ms = flushed_ms(lambda: k4.gather_sum_ref(idx31, tab31), 16)
    bags31 = idx31.reshape(taps31, -1).T.contiguous()
    col31 = tab31.reshape(-1, 1)

    def embedding_bag():
        return torch.nn.functional.embedding_bag(bags31, col31, mode="sum")

    lib_ms = flushed_ms(embedding_bag, 64)
    ref31 = k4.gather_sum_ref(idx31, tab31).reshape(-1)
    lib_err = float((embedding_bag()[:, 0] - ref31).abs().max())
    # device time of each of K4's kernels (the keys and the order, then the
    # gather) with L2 warm
    dev31 = device_ms(lambda: k4.gather_sum(idx31, tab31), "bigtex",
                      split=True)
    info31 = k4.kernel_info()
    # the indices and the output moved once, and each touched 32-byte
    # sector of the table read once, at PEAK_BYTES_S
    bd31 = probe_bigtex.traffic(idx31, tab31.numel())
    streams31 = bd31["bytes"] - 32 * bd31["sectors"]
    emit("k4_check", kernel="bigtex_gather", checks=checks31,
         frame=dict(frame), window=win31, ms=k4_ms, direct_ms=k4_direct_ms,
         turns=turns31, plain_ms=k4_plain_ms, embedding_bag_ms=lib_ms,
         embedding_bag_max_abs_err=lib_err, device_ms=dev31, info=info31,
         bound=bd31, frac_of_bound=bd31["bound_ms"] / k4_ms,
         window_bytes=bd31["window_bytes"],
         window_share=bd31["window_bytes"] / (32 * bd31["sectors"]),
         window_floor_ms=(bd31["window_bytes"] + streams31) / PEAK_BYTES_S
         * 1e3,
         timing="one call after a 256 MB write, CUDA events, median of 64 "
                "(plain: 16); the window and direct in turns (W, 0, 0, W); "
                "device_ms: torch.profiler, L2 warm", card=card)
    del idx31, tab31, bags31, col31, ref31, flush, tab_e, idx_i, tab_i

    # 32. the slice's main path: the port's tools/probe_bigtex.py::run on the
    # card for the JAX probe's __main__ configurations and the frame-size
    # one; then, outside the counted run, per configuration the host's time
    # a call and K4's device time
    runs32, lines32 = [], []
    reset_counts()
    for cfg, tol in probe_bigtex.CONFIGS:
        before = k4.LAUNCHES["bigtex_gather"]
        res = probe_bigtex.run(**cfg, device=dev, log=lines32.append)
        launched = k4.LAUNCHES["bigtex_gather"] - before
        if launched != 2 + res["iters"]:
            raise AssertionError(f"probe {cfg}: K4 launched {launched} times, "
                                 f"expected {2 + res['iters']}")
        if not res["err"] < (1e-5 if tol is None else tol):
            raise AssertionError(f"probe {cfg}: err {res['err']}")
        runs32.append(res)
    launches32 = counts()
    if any(v for k, v in launches32.items() if k != "bigtex_gather"):
        raise AssertionError(f"probe: launches {launches32}")
    per32 = []
    for (cfg, _), res in zip(probe_bigtex.CONFIGS, runs32):
        idx32, tab32 = probe_bigtex.make_inputs(
            cfg["n_rows"], cfg["taps"], cfg["spread"], cfg["blocks"],
            seed=res["seed"], device=dev)
        k4.gather_sum(idx32, tab32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            k4.gather_sum(idx32, tab32)
        host_us = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        per32.append({
            "config": {k: cfg[k] for k in ("n_rows", "taps", "spread",
                                           "blocks")},
            "ms": res["ms"], "host_us": host_us,
            "device_ms": device_ms(lambda: k4.gather_sum(idx32, tab32),
                                   "bigtex"),
            "embedding_bag_ms": res["library_ms"],
            "at_or_below_embedding_bag": res["ms"] <= res["library_ms"],
            "window_bytes": res["window_bytes"], "bound_ms": res["bound_ms"]})
        del idx32, tab32
    emit("main_path", kernel="bigtex_gather (tools/probe_bigtex.py)",
         runs=runs32, lines=lines32, per_config=per32,
         timing="ms: run's back-to-back loop (host clock); host_us: 1,000 "
                "calls without a synchronise; device_ms: torch.profiler, "
                "every K4 kernel of a call",
         launches={k: v for k, v in launches32.items() if v}, card=card)
    kernels.append({
        "name": "bigtex_gather", "route": "cuda",
        "source": f"advanced_cpu_raytracing_tpu_torch/csrc/{k4.LIBRARY}.cu",
        "replaces": REPLACES_K4, "launches": launches32["bigtex_gather"],
        "max_abs_err": checks31["frame size"]["max_abs_err"], "ms": k4_ms,
        "plain_ms": k4_plain_ms, "bound_ms": bd31["bound_ms"],
        "bound_by": bd31["bound_by"], "library_ms": lib_ms,
        "library": "torch.nn.functional.embedding_bag(mode='sum')",
        "lanes": lanes31, "taps": taps31, "l2_flushed": True,
        "direct_ms": k4_direct_ms, "window_bytes": win31,
        "paths": checks31["frame size"]["paths"],
        "registers": info31["registers"],
        "static_shared_bytes": info31["static_shared_bytes"],
        "dynamic_shared_bytes": info31["dynamic_shared_bytes"],
        "blocks_per_sm": info31["blocks_per_sm"], "device_ms": dev31})


    # ---- slice G1: progressive rendering, the sharded routes, the native
    # PLY reader ----
    # 33. progressive rendering: the Whitted frame in 16 passes (8, a
    # checkpoint, 8 more, each timed) through K1a's tree instantiation, and
    # a fresh renderer resumed from the checkpoint, bit for bit
    cfg, pack, cam_cfg, _, _ = scene(WHITTED_SCENE)
    w, h = cam_cfg.width, cam_cfg.height
    ck33 = str(out_dir / "progressive.npz")
    reset_counts()
    wrng.LAUNCHES["philox_draws"] = 0
    prog = ProgressiveRenderer(pack, cfg, cam_cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prog.render(8, checkpoint=ck33)
    torch.cuda.synchronize()
    first8_s = time.perf_counter() - t0
    pass_s = []
    for _ in range(8):
        t0 = time.perf_counter()
        prog.step()
        torch.cuda.synchronize()
        pass_s.append(time.perf_counter() - t0)
    launches33 = counts()
    want = {k: (16 if k == "mega_whitted_tree" else 0) for k in launches33}
    if launches33 != want:
        raise AssertionError(f"progressive: launches {launches33}, expected "
                             f"{want}")
    draws33 = wrng.LAUNCHES["philox_draws"]
    if draws33 != 15 + 16 * prog.cam.use_dof:
        raise AssertionError(f"progressive: {draws33} draw launches in 16 "
                             f"passes")
    resumed = ProgressiveRenderer(pack, cfg, cam_cfg, seed=0, device=dev)
    img33 = resumed.render(16, checkpoint=ck33)
    if not (resumed.samples_done == 16 and torch.equal(resumed.acc, prog.acc)
            and np.array_equal(img33, prog.image)):
        raise AssertionError("progressive: the resumed run differs from the "
                             "uninterrupted one")
    if not (np.isfinite(img33).all() and 5.0 < float(img33.mean()) < 250.0):
        raise AssertionError(f"progressive: bad frame, mean {img33.mean()}")
    pass_med = sorted(pass_s)[len(pass_s) // 2]
    cfg_p, pack_p, cam_p, _, _ = scene(PT_SCENE)
    reset_counts()
    wrng.LAUNCHES["philox_draws"] = 0
    prog_p = ProgressiveRenderer(pack_p, cfg_p, cam_p, seed=0, device=dev)
    img33p = prog_p.render(4)
    launches33p = counts()
    if launches33p != {k: (4 if k == "mega_pt" else 0) for k in launches33p}:
        raise AssertionError(f"progressive PT: launches {launches33p}")
    draws33p = wrng.LAUNCHES["philox_draws"]
    if draws33p != 3 + 4 * prog_p.cam.use_dof:
        raise AssertionError(f"progressive PT: {draws33p} draw launches in 4 "
                             f"passes")
    if not np.isfinite(img33p).all():
        raise AssertionError("progressive PT: non-finite radiance")
    emit("progressive", scene=WHITTED_SCENE.name, width=w, height=h,
         passes=16, launches={k: v for k, v in launches33.items() if v},
         draw_launches=draws33,
         resumed_bit_for_bit=True, first_8_with_2_saves_s=first8_s,
         pass_s=pass_s, pass_s_median=pass_med,
         mpaths_per_s=w * h / pass_med / 1e6,
         checkpoint_bytes=Path(ck33).stat().st_size,
         pt={"scene": PT_SCENE.name, "passes": 4,
             "launches": {k: v for k, v in launches33p.items() if v},
             "draw_launches": draws33p, "mean": float(img33p.mean())},
         timing="host clock around each pass, ending in a synchronise",
         card=card)
    del prog, resumed, prog_p

    # 34. the sharded routes at world size 1 under NCCL (one card: NCCL
    # takes one card a rank): the 16-spp Whitted frame, the gauge step at
    # 640,000 rays and the tonemap each equal to the unsharded route; the
    # dry run on one spawned rank; the sharded frame and step timed in
    # turns against the same work unsharded and against their joins alone
    # NCCL allocates its buffers outside PyTorch's caching allocator, which
    # still holds what the earlier phases freed
    gc.collect()
    torch.cuda.empty_cache()
    mem34 = {"allocated_bytes": torch.cuda.memory_allocated(),
             "reserved_bytes": torch.cuda.memory_reserved()}
    made = pmesh.initialize_distributed(device=dev)
    try:
        mesh = pmesh.make_device_mesh(device=dev)
        if dist.get_backend() != "nccl" or mesh.size() != 1:
            raise AssertionError(f"sharded: backend {dist.get_backend()}, "
                                 f"{mesh.size()} ranks")

        def sharded_frame():
            return shard_render.render_camera_sharded(
                pack, cfg, cam_cfg, mesh=mesh, seed=0, spp=16, device=dev)

        def plain_frame():
            return renderer.render_camera(pack, cfg, cam_cfg, seed=0, spp=16,
                                          device=dev)

        reset_counts()
        img34 = sharded_frame()
        launches34 = counts()
        if launches34 != {k: (16 if k == "mega_whitted_tree" else 0)
                          for k in launches34}:
            raise AssertionError(f"sharded frame: launches {launches34}")
        img34_1 = plain_frame()
        if not np.array_equal(img34, img34_1):
            raise AssertionError("sharded frame differs from render_camera's")
        ldr34 = reinhard_tonemap_sharded(img34, mesh, device=dev)
        ldr34_1 = reinhard_tonemap(img34_1, device=dev)
        if not np.array_equal(ldr34, ldr34_1):
            raise AssertionError("sharded tonemap differs from the unsharded")
        group34 = mesh.get_group()

        def timed_turns(calls, rounds=8):
            """Each call's host seconds, ending in a synchronise, the calls
            in turns: ``rounds`` rounds, each in the order of ``calls``,
            every other one reversed."""
            out = {k: [] for k in calls}
            for i in range(rounds):
                for k in (list(calls) if i % 2 == 0 else list(calls)[::-1]):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    calls[k]()
                    torch.cuda.synchronize()
                    out[k].append(time.perf_counter() - t0)
            return out

        # the frame's join alone: the all-gather of the one rank's part
        part34 = torch.zeros((w * h, 3), dtype=torch.float32, device=dev)
        frame_s = timed_turns({
            "unsharded": plain_frame, "sharded": sharded_frame,
            "all_gather": lambda: pmesh.all_gather(part34, 1, group34)})
        del part34

        # the gauge step at 640,000 rays (phase 19's rays and start)
        cfg_g, pack_g, opts_g, f_g, _, cam_g = diff_render(gauge_path)
        wg, hg = cfg_g.cameras[0].width, cfg_g.cameras[0].height
        n34 = wg * hg
        idx = torch.arange(n34, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        jit = torch.rand((n34, 2), generator=gen, device=dev)
        px = (idx % wg).float() + jit[:, 0]
        py = (idx // wg).float() + jit[:, 1]
        o, d = (t.contiguous() for t in generate_rays(cam_g, px, py))
        with torch.no_grad():
            target = f_g({}, o, d)
        rng = np.random.default_rng(6)
        start = {
            "mat_diffuse": pack_g.mat_diffuse * torch.as_tensor(rng.uniform(
                0.7, 1.1, tuple(pack_g.mat_diffuse.shape)).astype(np.float32),
                device=dev),
            "pl_intensity": pack_g.pl_intensity * 1.2,
            "verts": pack_g.verts + torch.as_tensor(rng.normal(
                0.0, 0.01, tuple(pack_g.verts.shape)).astype(np.float32),
                device=dev)}
        step34 = shard_render.make_sharded_diff_step(pack_g, opts_g, cam_g,
                                                     mesh=mesh, device=dev)

        def sharded_step():
            return step34(start, px, py, target, seed=0)

        def unsharded_step():
            # the rank's work of the sharded step (its rays made from px,
            # py, the loss and autograd) through the unsharded render,
            # without the all-reduce
            return shard_render.shard_diff_step(f_g, cam_g, start, px, py,
                                                target, 0, 1, seed=0)

        def plain_step():
            # the unsharded step as a user writes it, on phase 19's rays
            leaves = {k: v.detach().clone().requires_grad_(True)
                      for k, v in start.items()}
            loss = ((f_g(leaves, o, d) - target) ** 2).sum() / (3.0 * n34)
            loss.backward()
            return loss.detach(), {k: v.grad for k, v in leaves.items()}

        reset_counts()
        loss_sh, g_sh = sharded_step()
        torch.cuda.synchronize()
        step_launches = counts()
        loss_1, g_1 = plain_step()
        loss_u = unsharded_step()[0]
        if not float(loss_sh) == float(loss_1) == float(loss_u):
            raise AssertionError(f"sharded step: loss {float(loss_sh)}, "
                                 f"unsharded {float(loss_1)} and "
                                 f"{float(loss_u)}")
        # the cotangents are sums in atomic order: K2's tolerance
        fields34 = collections.namedtuple("Fields", list(start))
        grads34 = check_grads(fields34(**g_sh), fields34(**g_1),
                              "sharded step")
        # the step's join alone: the all-reduce of the loss and gradients
        sums34 = [t.clone() for t in (loss_sh, *g_sh.values())]

        def all_reduce():
            for x in sums34:
                dist.all_reduce(x, group=group34)

        step_s = timed_turns({"unsharded": unsharded_step,
                              "sharded": sharded_step,
                              "all_reduce": all_reduce})
        del sums34
        del step34, f_g, target, o, d, px, py, g_sh, g_1
    finally:
        if made:
            dist.destroy_process_group()
    t0 = time.perf_counter()
    dry = dryrun_multichip(1, "cuda")
    dry_s = time.perf_counter() - t0

    def med(xs):
        return sorted(xs)[len(xs) // 2]

    def spread(times):
        return {"s": times, "median_s": med(times), "min_s": min(times),
                "max_s": max(times)}

    emit("sharded_world_1", backend="nccl", ranks=1, memory_before=mem34,
         frame={"scene": WHITTED_SCENE.name, "width": w, "height": h,
                "spp": 16, "launches": {k: v for k, v in launches34.items()
                                        if v},
                "equal_to_render_camera": True,
                **{k: spread(v) for k, v in frame_s.items()}},
         tonemap_equal=True,
         step={"scene": "gauge", "rays": n34, "loss": float(loss_sh),
               "loss_equal": True, "grads": grads34,
               "launches": {k: v for k, v in step_launches.items() if v},
               **{k: spread(v) for k, v in step_s.items()}},
         dryrun={"ranks": 1, "stages": dry, "s_with_spawn": dry_s},
         timing="host clock around each call, ending in a synchronise; the "
                "calls in turns over 8 rounds, every other round reversed; "
                "unsharded: render_camera for the frame, the rank's work "
                "of the sharded step without its all-reduce for the step; "
                "all_gather, all_reduce: the join alone",
         card=card)

    # 35. the native PLY reader against the Python reader on the in-repo
    # mesh (16,384 vertices, 32,768 faces, binary little endian)
    ply_path = SCENES / "whitted_conductors_mesh.ply"
    t0 = time.perf_counter()
    native = load_ply_native(ply_path)
    first_s = time.perf_counter() - t0
    python = load_ply_python(str(ply_path))
    if native is None or not all(np.array_equal(a, b) and a.dtype == b.dtype
                                 for a, b in zip(native, python)):
        raise AssertionError("native PLY reader differs from the Python one")
    native_s, python_s = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        load_ply_native(ply_path)
        native_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        load_ply_python(str(ply_path))
        python_s.append(time.perf_counter() - t0)
    emit("native_ply", file=ply_path.name, vertices=len(native[0]),
         faces=len(native[1]), equal=True, first_call_s=first_s,
         native_s=native_s, python_s=python_s,
         native_s_median=med(native_s), python_s_median=med(python_s),
         timing="host clock, the file warm in the page cache")

    # 36. the Philox draw kernel against its int64 twin on the CPU, bit
    # for bit and one launch a call; the preview's jitter timed
    n36 = 640_000
    d36 = wrng.PhiloxDraws(3_100_000_021, sample=7, ray0=0, device=dev)
    cases36 = {
        "jitter": dict(it=-1, site=wrng.SITE_JITTER, r=n36, n=2),
        "lens": dict(it=-1, site=wrng.SITE_LENS, r=n36, n=2, lo=-1.0, hi=1.0),
        "env": dict(it=3, site=wrng.SITE_ENV, r=65_536, n=48, light=1,
                    lo=-1.0, hi=1.0)}
    for name, kw in cases36.items():
        before = wrng.LAUNCHES["philox_draws"]
        got = d36.uniform(**kw)
        torch.cuda.synchronize()
        if wrng.LAUNCHES["philox_draws"] != before + 1:
            raise AssertionError(f"philox_draws {name}: not one launch")
        if not torch.equal(got.cpu(), d36.to("cpu").uniform(**kw)):
            raise AssertionError(f"philox_draws {name}: differs from the twin")
    jitter36 = cases36["jitter"]

    def draws36():
        return d36.uniform(**jitter36)

    def twin36():
        return d36._raw(jitter36["it"], jitter36["site"], n36, 2, 0)

    if not torch.equal(twin36(), draws36()):
        raise AssertionError("philox_draws: the twin on the card differs")
    dev36 = device_ms(draws36, "philox_draws", reps=50)
    kernel36 = cuda_ms(draws36, 200)
    twin36_ms = cuda_ms(twin36, 20)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof36:
        for _ in range(10):
            twin36()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    twin36_dev = sum(r.device_time_total for r in prof36.key_averages()
                     if r.device_type == DeviceType.CUDA) / 10 / 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        draws36()
    host36_us = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    d36_cpu = d36.to("cpu")
    t0 = time.perf_counter()
    d36_cpu.uniform(**jitter36)
    plain36_ms = (time.perf_counter() - t0) * 1e3
    bytes36 = 4 * n36 * 2
    bound36_ms = bytes36 / PEAK_BYTES_S * 1e3
    emit("philox_draws", cases=list(cases36), equal_to_twin=True,
         one_launch_a_call=True, rays=n36, draws_per_ray=2,
         device_ms=dev36, events_ms=kernel36, host_us_a_call=host36_us,
         twin_card_events_ms=twin36_ms, twin_card_device_ms=twin36_dev,
         plain_cpu_ms=plain36_ms, bound_ms=bound36_ms, bytes=bytes36,
         timing="device_ms: torch.profiler, the kernel a launch; events_ms: "
                "CUDA events around 200 back-to-back calls; host_us_a_call: "
                "1,000 calls without a synchronise; twin_card: the int64 "
                "twin on the card, events and the device time of all its "
                "kernels a call", card=card)
    kernels.append({
        "name": "philox_draws", "route": "cuda",
        "source": f"advanced_cpu_raytracing_tpu_torch/csrc/{wrng.LIBRARY}.cu",
        "replaces": REPLACES_DRAWS,
        "launches": draws33 + draws33p, "max_abs_err": 0.0, "ms": kernel36,
        "plain_ms": plain36_ms, "bound_ms": bound36_ms, "bound_by": "bytes",
        "library_ms": None, "rays": n36, "device_ms": dev36,
        "twin_card_ms": twin36_ms, "twin_card_device_ms": twin36_dev})

    # the new paths' launches join the counts of the kernels they ran
    for entry in kernels:
        entry["launches"] += {
            "mega_whitted_tree": launches33["mega_whitted_tree"]
            + launches34["mega_whitted_tree"],
            "mega_pt": launches33p["mega_pt"],
            **{k: step_launches[k] for k in ("mega_bwd_primal_tree",
                                             "mega_bwd_rev", "mega_bwd_refit")},
        }.get(entry["name"], 0)


    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
