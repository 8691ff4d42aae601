"""Smoke run of the PyTorch port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. probe: the card's name and power limit, torch's CUDA version, nvcc;
  2. build the kernel sources, one nvcc each, started together:
     csrc/mega_whitted.cu (K1a), csrc/mega_pt.cu (K1b, and K1c and K1d,
     each static and with motion) and csrc/mega_bwd.cu (K2a and K2b, each
     with its primal and its fwd+bwd instantiation, and their K2c texture
     twins), csrc/tri_intersect.cu (K3, the wavefront's dense closest
     hit) and csrc/bigtex_gather.cu (K4, the big-texture probe's
     gather-sum), with ptxas's register, frame and spill lines per kernel
     (kept beside a cached library); K1a must keep its 72 registers, K1b
     its 77, K1c its 84 (90 with motion), K1d its 123 (128 with motion),
     K2a its 72 (primal) and 128 (fwd+bwd), K2b its 80 (primal) and 152 /
     154 (fwd+bwd, flat / tree), K3 its 40 and K4 its 27, and each K1
     and K2 kernel has a tree instantiation (K1e);
  3. K1a against its plain torch version on 65,536 primary rays of
     scenes/whitted_conductors.xml (1 spp, no DoF), and on a ray along -z
     in the plane y = -10 of the first chunk's box (the room's floor), which
     the chunk cull must keep to reach the back wall;
  4. the Whitted main path: render_camera on scenes/whitted_conductors.xml
     at 800x800, 16 spp, depth 6, u8 clamp on the device — with the launch
     counters set to 0 before it, K1a must launch 16 times and the others
     never; the PNG goes to a temporary directory; one warm-up frame, then
     the median of 3 timed frames (Mpaths/s, paths = w*h*spp);
  5. K1a at its main path's shape (the 640,000 rays of one sample): time
     per launch, the plain version's time and error on the same rays, and
     the least time the card needs for the counted FP32 work;
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
     time per launch, the plain version's time and error on the same rays
     and draws, and the bound of the counted FP32 work;
  9. K1c (mega_ext) against its plain version on 65,536 primary rays in
     both draw modes on the scenes of
     advanced_cpu_raytracing_tpu_torch/scene/feature_scenes.py (spot +
     directional, the BRDF zoo, the demo's area light, motion + roughness,
     scenes/feat_spotareaml.xml as Whitted and as path tracing with a rough
     glass sphere) and on scenes/feat_lights_brdf.xml as Whitted and as
     path tracing (NEE + importance sampling, by substitution; on every
     2nd of the rays);
 10. the K1c main path: render_camera on scenes/feat_lights_brdf.xml at
     800x800, 16 spp, depth 4, DoF, u8 clamp on the device — with the
     counters set to 0 before it, K1c must launch 16 times and K1a and K1b
     never; one warm-up frame, then the median of 3 timed frames; then one
     unwarmed 16-spp frame of its path-tracing variant;
 11. K1c at its main path's shape (640,000 rays of one sample through
     the lens, Philox):
     time per launch, the plain version's time and error on the same rays
     and draws, and the bound of the counted FP32 work;
 12. K1d (mega_tex) against its plain version on 65,536 primary rays in
     both draw modes on the K1d scenes of
     advanced_cpu_raytracing_tpu_torch/scene/feature_scenes.py (Perlin,
     image, normal and bump maps, six textures, megapixel and HDR
     textures, the background texture, transformed maps, sphere textures
     and bumps, the env light with small and large maps and with a rough
     mirror, scenes/feat_spotareaml.xml under the env light as Whitted and
     as path tracing with a rough glass) and on scenes/feat_textures.xml
     as Whitted and as path tracing at its depth 4 (NEE + importance
     sampling, by substitution; the plain version on every 4th of the
     65,536 rays); scenes without draws are held to K1a's bound, the others
     to K1c's;
 13. the K1d main path: render_camera on scenes/feat_textures.xml at
     800x800, 16 spp, depth 4, u8 clamp on the device — with the counters
     set to 0 before it, K1d must launch 16 times and the others never;
     one warm-up frame, then the median of 3 timed frames; then one
     unwarmed 16-spp frame of its path-tracing variant;
 14. K1d at its main path's shape (640,000 rays of one sample, Philox):
     time per launch, the plain version's time and error on every 8th of
     those rays and their draws, and the bound of the counted FP32 work
     (the plain version's counts times 8), Perlin evaluations, texel taps
     and env candidates included;
 15. K1e, the tree instantiations, against their plain version: K1a's and
     K1d's on 65,536 primary rays through the centres of every 4th pixel
     (where the grid's shared edges make ties) of the 524,288-face terrain
     of advanced_cpu_raytracing_tpu_torch/scene/synth.py, untextured and
     textured, as it is (its faces point down: ambient and background
     only) and with its winding reversed (lit by its point light, the
     texture showing; the plain version must show the light raising the
     mean radiance by more than 1 and the texture changing more than 20%
     of the rays) (no draws: K1a's bound); then, with the tree threshold
     (FLAT_MAX_FACES) set to 0 so every scene with faces walks a tree, K1b's
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
     then each of the four flat main paths' scenes through its tree twin
     (FLAT_MAX_FACES at 0) beside its flat kernel on one sample's rays:
     time per launch and agreement;
 18. K2a (csrc/mega_bwd.cu, the differentiable render's Whitted chain)
     against its plain version (ops/megabwd.py, autograd) on 16,384
     primary rays at full depth of the gauge scene (scenes/
     whitted_conductors.xml with a directional light,
     scene/feature_scenes.py::gauge_scene_xml), of the slice scene with the
     coarse torus, of the demo scene and of the demo scene with its mirror
     sphere made emissive (in the pack), each with the branch uniforms from
     a torch.Generator table and from Philox, over the chunks and (with
     FLAT_MAX_FACES at 0) over the tree: the primal's and the fwd+bwd's
     radiance held to K1a's bound, every cotangent (materials, lights,
     background, vertices, rays) within rtol 1e-3 and atol 1e-4 max|ref|;
 19. the training main path: diff/optimize.py::optimize on the gauge scene
     at 800x800 (one fixed jitter: 640,000 rays), depth 6, fields
     mat_diffuse, pl_intensity and verts (rates diff/optimize.py::
     GAUGE_RATES), 5 Adam steps
     from the true parameters perturbed by a fixed seed toward a target
     rendered by the primal at the true ones, the same draws every step —
     with every counter at 0 before it, the primal must launch 6 times, the
     fwd+bwd 5 times and no K1 kernel; the loss falls at every step; then
     optimize's step in a loop of its own, one warm-up and the median of 5
     timed steps, and rays per second;
 20. K2a at the main path's shape (those 640,000 rays): time per launch of
     the primal and of the fwd+bwd, and of the fwd+bwd without its scatter;
     the plain version's time and agreement on every 16th ray; the tree
     twins (FLAT_MAX_FACES at 0) on every ray, timed and held to the flat
     kernels; the bound: the closest-hit and shadow tests counted over the
     chunks (the plain version's counts on every 16th ray) and over the
     tree (TreeWalker's on every ray, with the boxes, rows and winners
     read), the cheaper of the two, plus the step and its adjoint per
     traced segment and lit light evaluation;
 21. K2b (csrc/mega_bwd.cu's kPt instantiations: path tracing, spot, area
     and mesh lights) against its plain version (autograd) on 16,384
     primary rays at full depth of scenes/feat_pt.xml (and by substitution
     with NEE only and with neither NEE nor importance sampling),
     feat_pt_rr.xml, feat_pt_spec.xml (and with RussianRoulette added),
     feat_spotareaml.xml (Whitted: spot, area, mesh light, emissive), the
     demo scene with its area light, and the demo under PathTracing + NEE
     with its mirror sphere diffuse, each with table draws from a
     torch.Generator and with Philox (against its twin bwd_draws), over the
     chunks and (FLAT_MAX_FACES at 0) over the tree: K2a's gates;
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
     the primal, the fwd+bwd and the fwd+bwd without its scatter, the plain
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
     (1,048,576 texels), over the chunks and (FLAT_MAX_FACES at 0) over the
     tree: K2a's gates, the texel cotangents included;
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
     64x64 scene): as phase 20, time per launch of the primal, the fwd+bwd
     and the fwd+bwd without its scatter, the plain version's time and
     agreement on every 16th ray, the tree twins, the bound with the taps
     and the textured steps counted; the path-traced twins timed on the
     textured feat_pt.xml; then one value-and-grad of sum(img^2)/n with
     respect to img_atlas at 1920x1080 on the 1,048,576-texel quad, the
     median of 3 after a warm-up;
 27. K3 (csrc/tri_intersect.cu, the wavefront's dense closest hit)
     against its plain version (ops/tri_intersect.py::tri_closest_hit_ref)
     bit for bit on t, the item index, beta and gamma, on 65,536 rays: the
     camera rays of the slice D1 scene (scene/feature_scenes.py::
     pt_env_dof_scene_xml: scenes/feat_pt.xml with a 1,920-face torus, the
     HDR sky as an environment light and a thin lens; 1,932 work items)
     against its item table and its shadow table, against feat_pt.xml's 12
     items, rays through a random 2,048-item table with det = 0 items and
     exact ties, and the motion scene's table with its motion rows and
     random times;
 28. K3 at the main path's shape (phase 29's 640,000 rays, through the
     lens, against the 1,932 items): time per launch (CUDA events, 5
     launches), the plain version's time on the same rays, and the bound:
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
     for bit, on the two configurations the JAX probe asserts (512 rows,
     taps 1, spread 4, 64 blocks; 8,192 rows, taps 4, spread 16, 512
     blocks), on the frame-size one (tools/probe_bigtex.py::FRAME:
     10,240,000 lanes, taps 4, spread 64, 393,216 rows) and on edge lanes
     (index 0, the last index, a tap repeated in a lane, indices outside
     the table: NaN in both); at the frame size K4's time per launch with
     L2 flushed (a 256 MB write before each of 64 launches, CUDA events,
     the median), embedding_bag's (the same PyTorch function in one call)
     time the same way and its error, the plain version's time on the card,
     and the bound (the indices, the output and each touched 32-byte
     table sector, moved once);
 32. the slice's main path: the port's tools/probe_bigtex.py::run on the
     card for the JAX probe's __main__ configurations (the two asserted,
     the sweep over spread 8, 64, 256) and the frame-size one — with every
     counter at 0 before it, K4 must launch 1 + 1 + iters times per
     configuration (the check, the warm-up, the timed loop) and nothing
     else; each err within the JAX probe's asserts (1e-6, 1e-5).
Every phase line carries t_s, the seconds since the script started.
Then the kernels line (each entry with its rays and the plain version's
stride over them), the card line and, last, the result line.  Any
failed check raises and ends the run with a non-zero exit code; without a
CUDA card it exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
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
# K2c: the texel cotangents of the same kernel (megabwd.py:1484-1564)
REPLACES_K2C = "advanced_cpu_raytracing_tpu/ops/pallas/megabwd.py:1484"
REPLACES_K3 = "advanced_cpu_raytracing_tpu/ops/pallas/tri_intersect.py:39"
REPLACES_K4 = "tools/probe_bigtex.py:31"
# registers of the K1a-K1d, K2, K3 and K4 kernels since they were first
# measured; the later variants' policies (motion, textures, the tree, K2b's
# template flag) must not change their code
KEPT_REGISTERS = {"mega_whitted_kernel": 72, "mega_pt_kernel": 77,
                  "mega_ext_kernel": 84, "mega_ext_motion_kernel": 90,
                  "mega_tex_kernel": 123, "mega_tex_motion_kernel": 128,
                  "mega_bwd_primal_kernel": 72, "mega_bwd_kernel": 128,
                  "mega_bwd_primal_tree_kernel": 72, "mega_bwd_tree_kernel": 128,
                  "mega_bwd_primal_pt_kernel": 80, "mega_bwd_pt_kernel": 152,
                  "mega_bwd_primal_pt_tree_kernel": 80,
                  "mega_bwd_pt_tree_kernel": 154, "tri_intersect_kernel": 40,
                  "bigtex_gather_kernel": 27}
KERNEL_ENTRIES = ("mega_whitted_kernel", "mega_pt_kernel", "mega_ext_kernel",
                  "mega_ext_motion_kernel", "mega_tex_kernel",
                  "mega_tex_motion_kernel", "mega_whitted_tree_kernel",
                  "mega_pt_tree_kernel", "mega_ext_tree_kernel",
                  "mega_ext_motion_tree_kernel", "mega_tex_tree_kernel",
                  "mega_tex_motion_tree_kernel", "mega_bwd_primal_kernel",
                  "mega_bwd_kernel", "mega_bwd_primal_tree_kernel",
                  "mega_bwd_tree_kernel", "mega_bwd_primal_pt_kernel",
                  "mega_bwd_pt_kernel", "mega_bwd_primal_pt_tree_kernel",
                  "mega_bwd_pt_tree_kernel", "mega_bwd_primal_tex_kernel",
                  "mega_bwd_tex_kernel", "mega_bwd_primal_tex_tree_kernel",
                  "mega_bwd_tex_tree_kernel", "mega_bwd_primal_pt_tex_kernel",
                  "mega_bwd_pt_tex_kernel",
                  "mega_bwd_primal_pt_tex_tree_kernel",
                  "mega_bwd_pt_tex_tree_kernel", "tri_intersect_kernel",
                  "bigtex_gather_kernel")

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
        K1D_SAMPLED,
        MOTION_ROUGH_XML,
        PT_ENV_TORUS,
        gauge_scene_xml,
        k1c_scenes,
        k1d_scenes,
        path_traced,
        ply_bytes,
        pt_env_dof_scene_xml,
        tex_bwd_scene_xml,
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
                  | {mb.LIBRARY, k3.LIBRARY, k4.LIBRARY})
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
                "plain_stride": stride, "plain_rays": -(-rays // stride)}

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
            err = check_close_pt(got, ref, what, EXT_MEAN_REL if kernel in (
                "mega_ext", "mega_tex") else PT_MEAN_REL)
        bd = bound({k: v * count_stride for k, v in stats.items()},
                   n_rays * 9 * 4 + table_bytes(mc, (tri_tab, chunk_tab), reads))
        if reads is not None:
            stats.update(nodes_read=int(reads["nodes"].sum()),
                         rows_read=int(reads["rows"].sum()),
                         rows_won=int(reads["won"].sum()))
        plain_stride = -(-n_rays // o.shape[0])
        emit("kernel_at_main_shape", kernel=kernel, rays=n_rays,
             plain_stride=plain_stride, count_stride=count_stride,
             kernel_ms=kernel_ms, plain_ms=plain_ms, **bd, **err, **stats,
             card=card)
        return kernel_ms, plain_ms, bd, err, n_rays, plain_stride

    kernels = []

    # ---- K1a: the Whitted path ----
    cfg, pack, cam_cfg, (mc, tri_tab, chunk_tab), cam = scene(WHITTED_SCENE)

    # 3. kernel vs plain on 65,536 primary rays (1 spp, no DoF), and on a
    # ray along -z in the plane y = -10 of chunk 0's box, the room's floor:
    # (lo - p) * inf = NaN there, and the cull must keep the box to reach
    # the back wall's bottom edge at t = 35 (the JAX chunk_sweep drops it)
    o, d = primary_rays(cam_cfg, cam, 65536)
    if float(chunk_tab[0, 1]) != -10.0:
        raise AssertionError(f"chunk 0's box: {chunk_tab[0].tolist()}")
    o = torch.cat([o, torch.tensor([[3.3, -10.0, 25.0]], device=dev)])
    d = torch.cat([d, torch.tensor([[0.0, 0.0, -1.0]], device=dev)])
    got = mk.mega_trace(mc, tri_tab, chunk_tab, o, d)
    torch.cuda.synchronize()
    ref = mk.mega_trace_ref(mc, tri_tab, chunk_tab, o, d)
    err = check_close(got, ref, "K1a, 65,536 primary rays")
    plane = {"kernel": got[-1].tolist(), "plain": ref[-1].tolist()}
    if not (got[-1] == ref[-1]).all() or float(ref[-1].sum()) <= 0.0:
        raise AssertionError(f"K1a, the ray in chunk 0's face plane: {plane}")
    emit("kernel_vs_plain", kernel="mega_whitted", scene=WHITTED_SCENE.name,
         rays=o.shape[0], **err, in_plane_ray=plane, mean_tol=MEAN_TOL,
         q999_tol=Q999_TOL)

    # 4. the Whitted main path
    mp = main_path(pack, cfg, cam_cfg, "mega_whitted", "Whitted main path")
    emit("main_path", kernel="mega_whitted", scene=WHITTED_SCENE.name, **mp)

    # 5. K1a at the main path's shape: one sample's 640,000 rays
    kernel_ms, plain_ms, bd, err, n_rays, stride = at_main_shape(
        mc, tri_tab, chunk_tab, cam_cfg, cam, "mega_whitted",
        "K1a, 640,000 rays of one sample")
    kernels.append(kernel_entry("mega_whitted", mp["launches"], kernel_ms, plain_ms,
                                bd, err, n_rays, stride))

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
        _, _, v_cam_cfg, (vmc, vtri, vchunk), vcam = scene(src, name)
        if vmc.kernel != "mega_ext":
            raise AssertionError(f"{label}: routed to {vmc.kernel}")
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
            torch.cuda.synchronize()
            if draws is None and rows:
                draws = philox_table(11, 4, o.shape[0], vmc.max_iters,
                                     vmc.n_draws, device=dev)
            ref = mk.mega_trace_ref(vmc, vtri, vchunk, o, d, draws=draws)
            err = check_close_pt(got, ref, f"K1c, {label}, {mode}",
                                 EXT_MEAN_REL)
            emit("kernel_vs_plain", kernel="mega_ext", scene=label, draws=mode,
                 rays=o.shape[0], stride=stride, max_iters=vmc.max_iters,
                 stack_k=vmc.stack_k,
                 n_draws=vmc.n_draws, **err, atol=PT_ATOL, rtol=PT_RTOL,
                 frac_tol=PT_FRAC, mean_rel_tol=EXT_MEAN_REL)
        del draws

    # 10. the K1c main path, then one frame of its path-tracing variant
    cfg, pack, cam_cfg, (mc, tri_tab, chunk_tab), cam = scene(LIGHTS_SCENE)
    mp = main_path(pack, cfg, cam_cfg, "mega_ext", "K1c main path")
    emit("main_path", kernel="mega_ext", scene=LIGHTS_SCENE.name, **mp)
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
    emit("frame", kernel="mega_ext", scene="feat_lights_brdf.xml, path tracing",
         spp=v_cam_cfg.num_samples, frame_s=frame_s, u8_mean=float(ldr.mean()),
         radiance_mean=float(hdr.mean()), card=card)

    # 11. K1c at the main path's shape: one sample's 640,000 rays, Philox
    kernel_ms, plain_ms, bd, err, n_rays, stride = at_main_shape(
        mc, tri_tab, chunk_tab, cam_cfg, cam, "mega_ext",
        "K1c, 640,000 rays of one sample")
    kernels.append(kernel_entry("mega_ext", mp["launches"], kernel_ms, plain_ms,
                                bd, err, n_rays, stride))

    # ---- K1d: textures and the environment light ----
    # 12. kernel vs plain on 65,536 primary rays, both draw modes
    tex_dir = out_dir / "k1d"
    variants = [(name, xml, name in K1D_SAMPLED, tex_dir / f"{name}.xml", 1)
                for name, xml in k1d_scenes(tex_dir, SCENES).items()]
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
        _, _, v_cam_cfg, (vmc, vtri, vchunk), vcam = scene(path)
        if vmc.kernel != "mega_tex":
            raise AssertionError(f"{label}: routed to {vmc.kernel}")
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
        for mode, draws in (
                ("table", torch.rand((rows, o.shape[0]), generator=gen,
                                     device=dev) if rows else None),
                ("philox", None)):
            got = mk.mega_trace(vmc, vtri, vchunk, o, d, draws=draws, seed=13,
                                sample=6, pix_uv=pix_uv)
            torch.cuda.synchronize()
            if draws is None and rows:
                draws = philox_table(13, 6, o.shape[0], vmc.max_iters,
                                     vmc.n_draws, device=dev)
            ref = mk.mega_trace_ref(vmc, vtri, vchunk, o, d, draws=draws,
                                    pix_uv=pix_uv)
            if rows:
                err = check_close_pt(got, ref, f"K1d, {label}, {mode}",
                                     EXT_MEAN_REL)
                tol = dict(atol=PT_ATOL, rtol=PT_RTOL, frac_tol=PT_FRAC,
                           mean_rel_tol=EXT_MEAN_REL)
            else:
                err = check_close(got, ref, f"K1d, {label}, {mode}")
                tol = dict(mean_tol=MEAN_TOL, q999_tol=Q999_TOL)
            emit("kernel_vs_plain", kernel="mega_tex", scene=label, draws=mode,
                 rays=o.shape[0], stride=stride, depth=vmc.max_depth,
                 max_iters=vmc.max_iters, stack_k=vmc.stack_k,
                 n_draws=vmc.n_draws, n_textures=vmc.n_textures,
                 texels=vmc.texels.shape[0], **err, **tol)
        del draws

    # 13. the K1d main path, then one frame of its path-tracing variant
    cfg, pack, cam_cfg, (mc, tri_tab, chunk_tab), cam = scene(TEXTURES_SCENE)
    mp = main_path(pack, cfg, cam_cfg, "mega_tex", "K1d main path")
    emit("main_path", kernel="mega_tex", scene=TEXTURES_SCENE.name, **mp)
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
    emit("frame", kernel="mega_tex", scene="feat_textures.xml, path tracing",
         spp=v_cam_cfg.num_samples, frame_s=frame_s, u8_mean=float(ldr.mean()),
         radiance_mean=float(hdr.mean()), card=card)

    # 14. K1d at the main path's shape: one sample's 640,000 rays, Philox;
    # the plain version on every 8th of them, to keep the script's time
    kernel_ms, plain_ms, bd, err, n_rays, stride = at_main_shape(
        mc, tri_tab, chunk_tab, cam_cfg, cam, "mega_tex",
        "K1d, 640,000 rays of one sample", stride=8)
    kernels.append(kernel_entry("mega_tex", mp["launches"], kernel_ms, plain_ms,
                                bd, err, n_rays, stride))

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
    flat_max = mk.FLAT_MAX_FACES
    mk.FLAT_MAX_FACES = 0  # every scene with faces walks a tree
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
        mk.FLAT_MAX_FACES = flat_max

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
        kernels.append(kernel_entry(kernel, main_launches[kernel], kernel_ms,
                                    plain_ms, bd, err, n_rays, stride))
        lit[textured].cameras[0].num_samples = cam_cfg.num_samples
        _, _, l_cam_cfg, (lmc, ltri, lchunk), lcam = scene(lit[textured])
        o, d = sample_rays(l_cam_cfg, lcam, l_cam_cfg.num_samples)
        mk.mega_trace(lmc, ltri, lchunk, o, d, seed=0, sample=0)
        emit("kernel_faces_up", kernel=lmc.variant, rays=o.shape[0],
             kernel_ms=cuda_ms(lambda: mk.mega_trace(
                 lmc, ltri, lchunk, o, d, seed=0, sample=0), 5),
             faces_down_ms=kernel_ms, card=card)

    # the flat main paths' scenes through their tree twins (FLAT_MAX_FACES
    # at 0) beside their flat kernels, on one sample's rays
    for path in (WHITTED_SCENE, PT_SCENE, LIGHTS_SCENE, TEXTURES_SCENE):
        _, _, f_cam_cfg, flat_tabs, f_cam = scene(path)
        flat_max = mk.FLAT_MAX_FACES
        mk.FLAT_MAX_FACES = 0
        try:
            tree_tabs = scene(path)[3]
        finally:
            mk.FLAT_MAX_FACES = flat_max
        o, d = sample_rays(f_cam_cfg, f_cam, f_cam_cfg.num_samples)
        res = {}
        for label, (m, tri, chunk) in (("flat", flat_tabs), ("tree", tree_tabs)):
            res[label] = mk.mega_trace(m, tri, chunk, o, d, seed=0, sample=0)
            res[label + "_ms"] = cuda_ms(lambda: mk.mega_trace(
                m, tri, chunk, o, d, seed=0, sample=0), 5)
        emit("tree_on_flat_scene", scene=path.name,
             flat_kernel=flat_tabs[0].variant, tree_kernel=tree_tabs[0].variant,
             rays=o.shape[0], flat_ms=res["flat_ms"], tree_ms=res["tree_ms"],
             exact_frac_vs_flat=exact_frac(res["tree"], res["flat"]),
             max_abs_diff=float((res["tree"] - res["flat"]).abs().max()),
             card=card)
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
    # both draw modes, over the chunks and over the tree
    n18 = 16384
    flat_max = mk.FLAT_MAX_FACES
    try:
        for geometry in ("chunks", "tree"):
            if geometry == "tree":
                mk.FLAT_MAX_FACES = 0
            for label, path in (("gauge", gauge_path),
                                ("slice, coarse torus", slice_path),
                                ("demo", demo_path),
                                ("demo, emissive sphere", demo_path)):
                cfg, _, _, f, tabs, cam = diff_render(
                    path, emissive=label.endswith("emissive sphere"))
                bc = f.bc
                if bc.variant != "mega_bwd" + ("_tree" if geometry == "tree"
                                               else ""):
                    raise AssertionError(f"K2a {label}: routed to {bc.variant}")
                depth = mb.bc_depth(bc)
                o, d = primary_rays(cfg.cameras[0], cam, n18, seed=3)
                gen = torch.Generator(device=dev)
                gen.manual_seed(12)
                gbar = torch.randn((n18, 3), generator=gen, device=dev)
                for mode in ("table", "philox"):
                    draws = (torch.rand((depth, n18), generator=gen, device=dev)
                             if mode == "table" else None)
                    prim = mb.mega_bwd_trace(bc, tabs, o, d, draws, seed=19,
                                             step=3)
                    got, g = mb.mega_bwd_trace(bc, tabs, o, d, draws, seed=19,
                                               step=3, gbar=gbar)
                    torch.cuda.synchronize()
                    if draws is None:
                        draws = mb.ud_table(19, 3, n18, depth, device=dev)
                    t0 = time.perf_counter()
                    ref, gref = mb.mega_bwd_trace_ref(bc, tabs, o, d, draws,
                                                      gbar)
                    torch.cuda.synchronize()
                    plain_s = time.perf_counter() - t0
                    what = f"K2a {bc.variant}, {label}, {mode}"
                    err = check_close(prim, ref, what + ", primal")
                    err_fb = check_close(got, ref, what + ", fwd+bwd")
                    emit("kernel_vs_plain", kernel=bc.variant, scene=label,
                         draws=mode, rays=n18, depth=depth, faces=bc.n_tri,
                         plain_s=plain_s, primal=err,
                         fwd_bwd_exact_frac=err_fb["exact_frac"],
                         fwd_bwd_max_abs_err=err_fb["max_abs_err"],
                         grads=check_grads(g, gref, what), mean_tol=MEAN_TOL,
                         q999_tol=Q999_TOL, grad_rtol=GRAD_RTOL,
                         grad_atol_scale=GRAD_ATOL_SCALE)
                del draws, gref, g
    finally:
        mk.FLAT_MAX_FACES = flat_max

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
    want = {k: {"mega_bwd_primal": 6, "mega_bwd": 5}.get(k, 0) for k in launches}
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
    emit("main_path", kernel="mega_bwd", scene="gauge (whitted_conductors.xml "
         "+ a directional light)", width=w, height=h, rays=w * h,
         depth=opts.max_depth, fields=list(fields), lr=rates, steps=5,
         loss_history=history, step_s=step_s, step_s_median=step_med,
         mrays_per_s=w * h / step_med / 1e6, total_s_with_setup=total_s,
         launches={k: v for k, v in launches.items() if v}, card=card)
    main_bwd_launches = dict(launches)

    # 20. K2a at the main path's shape: 640,000 rays at the true parameters
    bc = f.bc
    tabs = mb.BwdTables(*(t.detach().contiguous() for t in f.tables({})))
    n20 = o.shape[0]
    gbar = torch.randn((n20, 3), generator=gen, device=dev)
    prim_ms = cuda_ms(lambda: mb.mega_bwd_trace(bc, tabs, o, d), 5)
    fb_ms = cuda_ms(lambda: mb.mega_bwd_trace(bc, tabs, o, d, gbar=gbar), 5)
    no_scatter_ms = cuda_ms(lambda: mb.mega_bwd_trace(
        bc, tabs, o, d, gbar=gbar, scatter=False), 5)
    # the plain version on every 16th ray, the kernel on the same rays and
    # draws
    stride = 16
    depth = mb.bc_depth(bc)
    os_, ds_, gs_ = (t[::stride].contiguous() for t in (o, d, gbar))
    draws = mb.ud_table(0, 0, n20, depth, device=dev)[:, ::stride].contiguous()
    prim = mb.mega_bwd_trace(bc, tabs, os_, ds_, draws)
    got, g = mb.mega_bwd_trace(bc, tabs, os_, ds_, draws, gbar=gs_)
    torch.cuda.synchronize()
    stats: dict = {}
    t0 = time.perf_counter()
    ref0 = mb.mega_bwd_trace_ref(bc, tabs, os_, ds_, draws, stats=stats)
    torch.cuda.synchronize()
    plain_prim_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref, gref = mb.mega_bwd_trace_ref(bc, tabs, os_, ds_, draws, gs_)
    torch.cuda.synchronize()
    plain_fb_ms = (time.perf_counter() - t0) * 1e3
    what = "K2a at the main path's shape, every 16th ray"
    err_p = check_close(prim, ref0, what + ", primal")
    err_fb = check_close(got, ref, what + ", fwd+bwd")
    gerr = check_grads(g, gref, what)
    # the same rays through the tree twins (FLAT_MAX_FACES at 0), against
    # the flat kernels on every ray
    mk.FLAT_MAX_FACES = 0
    try:
        f_tree = mb.make_diff_render(pack, opts, device=dev)
    finally:
        mk.FLAT_MAX_FACES = flat_max
    bct = f_tree.bc
    tabs_t = mb.BwdTables(*(t.detach().contiguous()
                            for t in f_tree.tables({})))
    flat_p = mb.mega_bwd_trace(bc, tabs, o, d)
    _, flat_g = mb.mega_bwd_trace(bc, tabs, o, d, gbar=gbar)
    tree_p = mb.mega_bwd_trace(bct, tabs_t, o, d)
    tree_fb, tree_g = mb.mega_bwd_trace(bct, tabs_t, o, d, gbar=gbar)
    tree_prim_ms = cuda_ms(lambda: mb.mega_bwd_trace(bct, tabs_t, o, d), 5)
    tree_fb_ms = cuda_ms(lambda: mb.mega_bwd_trace(bct, tabs_t, o, d,
                                                   gbar=gbar), 5)
    what = "K2a's tree twins at the main path's shape, against the flat"
    tree_err = {"primal": check_close(tree_p, flat_p, what + ", primal"),
                "fwd_bwd": check_close(tree_fb, flat_p, what + ", fwd+bwd"),
                "grads": check_grads(tree_g, flat_g, what)}
    del flat_p, flat_g, tree_p, tree_fb, tree_g
    # the tree's work on every ray: the plain version's primal over the
    # tree, in runs of 160,000 rays sharing its stats (TreeWalker's counts
    # and the boxes, rows and winners read)
    tree_stats: dict = {}
    table = mb.ud_table(0, 0, n20, depth, device=dev)
    for lo in range(0, n20, 160000):
        part = slice(lo, lo + 160000)
        mb.mega_bwd_trace_ref(bct, tabs_t, o[part].contiguous(),
                              d[part].contiguous(),
                              table[:, part].contiguous(), stats=tree_stats)
    del table
    reads = tree_stats.pop("reads")
    tree_stats.update(nodes_read=int(reads["nodes"].sum()),
                      rows_read=int(reads["rows"].sum()),
                      rows_won=int(reads["won"].sum()))

    def k2a_bounds(counted, n_bytes_primal, n_bytes_fwd_bwd):
        """The primal's and the fwd+bwd's bounds: the counted sweeps' tests
        once each, the step per traced segment and lit light evaluation,
        and in the fwd+bwd their adjoints."""
        fwd = counted["traces"] * STEP_FLOPS + counted["lit_light_evals"] \
            * LIGHT_FLOPS
        adj = counted["traces"] * ADJ_STEP_FLOPS + counted["lit_light_evals"] \
            * ADJ_LIGHT_FLOPS
        out = []
        for n_bytes, extra in ((n_bytes_primal, fwd),
                               (n_bytes_fwd_bwd, fwd + adj)):
            bd = bound(counted, n_bytes)
            bd["flops"] += extra
            bd["ops_ms"] = bd["flops"] / PEAK_FP32_FLOPS * 1e3
            bd["bound_ms"] = max(bd["ops_ms"], bd["bytes_ms"])
            bd["bound_by"] = ("operations" if bd["ops_ms"] >= bd["bytes_ms"]
                              else "bytes")
            out.append(bd)
        return out

    # bytes: the rays, the tables read once (over the tree: the boxes
    # visited, the rows tested, the winners' rows), and in the fwd+bwd the
    # radiance's cotangent in, the parameters' and rays' cotangents out
    counted = {k: v * stride for k, v in stats.items()}
    tables = sum(t.numel() * 4 for t in (
        bc.tri_rest, tabs.tri_w, bc.chunk_tab, bc.mc.spheres, bc.mc.materials,
        bc.mc.point_lights, bc.mc.dir_lights))
    grads_bytes = sum(t.numel() * 4 for t in tabs)
    flat_bd = k2a_bounds(counted, n20 * 9 * 4 + tables,
                         n20 * 18 * 4 + tables + grads_bytes)
    tree_tables = table_bytes(bct.mc, None, reads)
    tree_grads = (sum(t.numel() * 4 for t in tabs_t[:4])
                  + tree_stats["rows_won"] * 9 * 4)
    tree_bd = k2a_bounds(tree_stats, n20 * 9 * 4 + tree_tables,
                         n20 * 18 * 4 + tree_tables + tree_grads)
    # the function's least work: the cheaper of the two ways to find the
    # closest hits
    bd_p, bd_fb = (dict(min(fb, tb, key=lambda x: x["bound_ms"]),
                        counted_over="chunks" if fb["bound_ms"]
                        <= tb["bound_ms"] else "tree")
                   for fb, tb in zip(flat_bd, tree_bd))
    grad_err = max(v["max_abs_err"] for v in gerr.values())
    emit("kernel_at_main_shape", kernel="mega_bwd", rays=n20,
         plain_stride=stride, primal_ms=prim_ms, fwd_bwd_ms=fb_ms,
         fwd_bwd_no_scatter_ms=no_scatter_ms,
         scatter_ms=fb_ms - no_scatter_ms, plain_primal_ms=plain_prim_ms,
         plain_fwd_bwd_ms=plain_fb_ms, primal_bound=bd_p, fwd_bwd_bound=bd_fb,
         primal=err_p, fwd_bwd_exact_frac=err_fb["exact_frac"], grads=gerr,
         counts=counted, card=card)
    emit("kernel_at_main_shape", kernel="mega_bwd_tree", rays=n20,
         primal_ms=tree_prim_ms, fwd_bwd_ms=tree_fb_ms,
         flat_primal_ms=prim_ms, flat_fwd_bwd_ms=fb_ms, vs_flat=tree_err,
         counts=tree_stats, count_stride=1, primal_bound=tree_bd[0],
         fwd_bwd_bound=tree_bd[1], flat_primal_bound=flat_bd[0],
         flat_fwd_bwd_bound=flat_bd[1], card=card)
    kernels.append({**kernel_entry(
        "mega_bwd_primal", main_bwd_launches["mega_bwd_primal"], prim_ms,
        plain_prim_ms, bd_p, err_p, n20, stride, library=mb.LIBRARY,
        replaces=REPLACES_K2), "bound_counted_over": bd_p["counted_over"],
        "tree_twin_ms": tree_prim_ms})
    kernels.append({**kernel_entry(
        "mega_bwd", main_bwd_launches["mega_bwd"], fb_ms, plain_fb_ms, bd_fb,
        {"max_abs_err": max(err_fb["max_abs_err"], grad_err)}, n20, stride,
        library=mb.LIBRARY, replaces=REPLACES_K2),
        "scatter_ms": fb_ms - no_scatter_ms,
        "bound_counted_over": bd_fb["counted_over"],
        "tree_twin_ms": tree_fb_ms})

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
                mk.FLAT_MAX_FACES = 0
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
        mk.FLAT_MAX_FACES = flat_max

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
        """As k2a_bounds, with K2b's segments (traced or reusing the GI
        ray's hit), lit light evaluations and GI samples."""
        seg = counted.get("traces", 0) + counted.get("reused", 0)
        fwd = (seg * STEP_FLOPS + counted["lit_light_evals"] * LIGHT_FLOPS
               + counted.get("gi_traces", 0) * GI_FLOPS)
        adj = (seg * ADJ_STEP_FLOPS
               + counted["lit_light_evals"] * ADJ_LIGHT_FLOPS
               + counted.get("gi_traces", 0) * ADJ_GI_FLOPS)
        out = []
        for n_bytes, extra in ((n_bytes_primal, fwd),
                               (n_bytes_fwd_bwd, fwd + adj)):
            bd = bound(counted, n_bytes)
            bd["flops"] += extra
            bd["ops_ms"] = bd["flops"] / PEAK_FP32_FLOPS * 1e3
            bd["bound_ms"] = max(bd["ops_ms"], bd["bytes_ms"])
            bd["bound_by"] = ("operations" if bd["ops_ms"] >= bd["bytes_ms"]
                              else "bytes")
            out.append(bd)
        return out

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
        # the tree twins (FLAT_MAX_FACES at 0) on every ray, against the
        # flat kernels, and the tree's work counted on every ray
        mk.FLAT_MAX_FACES = 0
        try:
            f_t = mb.make_diff_render(pack_s, opts_s, device=dev)
        finally:
            mk.FLAT_MAX_FACES = flat_max
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
             scatter_ms=fb_ms - no_scatter_ms, plain_primal_ms=plain_prim_ms,
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
                mk.FLAT_MAX_FACES = 0
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
        mk.FLAT_MAX_FACES = flat_max

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
    mk.FLAT_MAX_FACES = 0
    try:
        f_tree = mb.make_diff_render(pack, opts, device=dev)
    finally:
        mk.FLAT_MAX_FACES = flat_max
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
    bd_p, bd_fb = k2a_bounds(counted, n26 * 9 * 4 + tables,
                             n26 * 18 * 4 + tables + grads_bytes)
    for bd, extra in ((bd_p, tex_extra[0]), (bd_fb, sum(tex_extra))):
        bd["flops"] += extra
        bd["ops_ms"] = bd["flops"] / PEAK_FP32_FLOPS * 1e3
        bd["bound_ms"] = max(bd["ops_ms"], bd["bytes_ms"])
        bd["bound_by"] = ("operations" if bd["ops_ms"] >= bd["bytes_ms"]
                          else "bytes")
    emit("kernel_at_main_shape", kernel="mega_bwd_tex", rays=n26,
         plain_stride=stride, primal_ms=prim_ms, fwd_bwd_ms=fb_ms,
         fwd_bwd_no_scatter_ms=no_scatter_ms,
         scatter_ms=fb_ms - no_scatter_ms, plain_primal_ms=plain_prim_ms,
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
    # one value-and-grad of sum(img^2) / n with respect to img_atlas at
    # 1920x1080 on the 1,048,576-texel quad, the median of 3 after a warm-up
    cfg_b, pack_b, _, f_b, _, cam_b = diff_render(tiles_path)
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
        replaces=REPLACES_K2C), "bound_counted_over": "chunks",
        "tree_twin_ms": tree_prim_ms, "pt_twin": pt_twins})
    kernels.append({**kernel_entry(
        "mega_bwd_tex", tex_launches["mega_bwd_tex"], fb_ms, plain_fb_ms,
        bd_fb, {"max_abs_err": max(err_fb["max_abs_err"], grad_err)}, n26,
        stride, library=mb.LIBRARY, replaces=REPLACES_K2C),
        "scatter_ms": fb_ms - no_scatter_ms, "bound_counted_over": "chunks",
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
         rays=n29, items=w28, ms=k3_ms, plain_ms=k3_plain_ms, exact=exact28,
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
        replaces=REPLACES_K3), "items": w28})

    # 31. K4 against its plain version, bit for bit (NaN lanes alike): the
    # JAX probe's two asserted configurations, the frame-size one and edge
    # lanes; at the frame size K4's, embedding_bag's and the plain version's
    # times with L2 flushed, and the bound
    def k4_check(what, idx, tab):
        got = k4.gather_sum(idx, tab)
        ref = k4.gather_sum_ref(idx, tab)
        torch.cuda.synchronize()
        ok = ~torch.isnan(ref)
        if not (torch.equal(torch.isnan(got), ~ok)
                and torch.equal(got[ok], ref[ok])):
            raise AssertionError(f"K4 on {what}: differs from its plain "
                                 f"version")
        return {"lanes": got.numel(), "taps": int(idx.shape[0]),
                "nan_lanes": int((~ok).sum()),
                "max_abs_err": float((got[ok] - ref[ok]).abs().max())}

    def k4_inputs(cfg):
        return probe_bigtex.make_inputs(
            cfg["n_rows"], cfg["taps"], cfg["spread"], cfg["blocks"], seed=31,
            device=dev)

    checks31 = {}
    for (cfg, _), what in zip(probe_bigtex.ASSERTED,
                              ("JAX asserted 1", "JAX asserted 2")):
        checks31[what] = k4_check(what, *k4_inputs(cfg))
    idx31, tab31 = k4_inputs(probe_bigtex.ASSERTED[0][0])
    n31 = tab31.numel()
    edge31 = torch.tensor(
        [[0, n31 - 1, 5, 5, 3, -1, n31, 2**31 - 1, -2**31, 9],
         [0, n31 - 1, 5, 5, 3, 4, 7, 1, 2, n31 + 5],
         [0, n31 - 1, 5, 9, 3, 4, 7, 1, 2, 0]], dtype=torch.int32, device=dev)
    checks31["edge lanes"] = k4_check("the edge lanes", edge31, tab31)
    if checks31["edge lanes"]["nan_lanes"] != 5:
        raise AssertionError(f"K4 edge lanes: {checks31['edge lanes']}")
    frame = probe_bigtex.FRAME
    idx31, tab31 = k4_inputs(frame)
    checks31["frame size"] = k4_check("the frame-size configuration", idx31,
                                      tab31)
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

    k4_ms = flushed_ms(lambda: k4.gather_sum(idx31, tab31), 64)
    k4_plain_ms = flushed_ms(lambda: k4.gather_sum_ref(idx31, tab31), 16)
    bags31 = idx31.reshape(taps31, -1).T.contiguous()
    col31 = tab31.reshape(-1, 1)

    def embedding_bag():
        return torch.nn.functional.embedding_bag(bags31, col31, mode="sum")

    lib_ms = flushed_ms(embedding_bag, 64)
    ref31 = k4.gather_sum_ref(idx31, tab31).reshape(-1)
    lib_err = float((embedding_bag()[:, 0] - ref31).abs().max())
    # the indices and the output moved once, and each touched 32-byte
    # sector of the table read once, at PEAK_BYTES_S
    bd31 = probe_bigtex.traffic(idx31)
    emit("k4_check", kernel="bigtex_gather", checks=checks31,
         frame=dict(frame), ms=k4_ms, plain_ms=k4_plain_ms,
         embedding_bag_ms=lib_ms, embedding_bag_max_abs_err=lib_err,
         bound=bd31, frac_of_bound=bd31["bound_ms"] / k4_ms,
         timing="one call after a 256 MB write, CUDA events, median of 64 "
                "(plain: 16)", card=card)
    del idx31, tab31, bags31, col31, ref31, flush

    # 32. the slice's main path: the port's probe tool on the card, the JAX
    # probe's __main__ configurations and the frame-size one
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
    emit("main_path", kernel="bigtex_gather (tools/probe_bigtex.py)",
         runs=runs32, lines=lines32,
         launches={k: v for k, v in launches32.items() if v}, card=card)
    kernels.append({
        "name": "bigtex_gather", "route": "cuda",
        "source": f"advanced_cpu_raytracing_tpu_torch/csrc/{k4.LIBRARY}.cu",
        "replaces": REPLACES_K4, "launches": launches32["bigtex_gather"],
        "max_abs_err": checks31["frame size"]["max_abs_err"], "ms": k4_ms,
        "plain_ms": k4_plain_ms, "bound_ms": bd31["bound_ms"],
        "bound_by": bd31["bound_by"], "library_ms": lib_ms,
        "library": "torch.nn.functional.embedding_bag(mode='sum')",
        "lanes": lanes31, "taps": taps31, "l2_flushed": True})


    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
