"""The differentiable render: host tables, the plain torch version and the
wrappers of kernels K2a (the fused forward and reverse Whitted chain), K2b
(path tracing and the spot, area and mesh lights) and K2c (diffuse image
textures).

It replaces the JAX package's fused fwd+bwd Pallas kernel
(``ops/pallas/megabwd.py::_kernel``, launched by ``_bwd_call``, reduced by
``_reduce_streams``, wrapped by ``make_diff_render``): per ray, a linear
chain of ``bc_depth`` segments;
each traces the scene, fixes the segment's topology (which primitive wins,
shadow visibility, the material branches, the dielectric's
reflect-or-refract choice, in path tracing the GI ray's hit, the Russian
roulette kill and the spec-vs-GI coin) as constants, and takes one
differentiable step — the hit's t (Cramer's rule through the winner's
vertices, or the sphere's quadratic through the ray), Beer's attenuation,
the primary miss's background, emissive hits, ambient, point, directional,
spot, area and mesh-light Blinn-Phong light, and the one child ray: mirror,
conductor with its Fresnel ratio, the dielectric's single sampled leg, or
the GI bounce (raytracer.cpp:65-191, 208-415, 442-472, 701-806).  On a
face with a diffuse image texture (``replace_kd`` or ``blend_kd``, nearest
or bilinear) the step's kd is the texture's: the hit's barycentrics again
through the winner's vertices, its UV, the taps (their texels constants of
the topology) and the bilinear weights, differentiable in the UV
(raytracer.cpp:478-508; megabwd.py:835-883).  The parameters are the
tables of each call, not constants: the materials' ambient, diffuse,
specular, mirror, Phong and radiance columns, the point, directional,
spot, area and mesh-light intensities, the background, the world vertices
of the work items and the texel pool of the image textures.

* ``diff_trace_ref`` is the plain version: the chain in torch, under
  ``torch.no_grad()`` for the topology (the port's ``_Geometry`` sweeps)
  and differentiated by autograd through each step;
* ``mega_bwd_trace`` launches ``csrc/mega_bwd.cu``: K2a's instantiations
  for a Whitted scene with point and directional lights, K2b's for a
  path-traced scene or one with spot, area or mesh lights, and for a scene
  with diffuse image textures K2c's twin of either; each has a primal (the
  forward only) and a backward, whose hand-derived reverse sweep scatters
  the cotangents with atomics in place of the TPU's one-hot MXU epilogue
  (the texels' by their index in the pool, with no cap on the texels or
  the textures): each add summed first over the warp's lanes that share
  its address, and only the targets asked for (``scatter_flags``).  K2a's
  primal writes each ray's segment records to a buffer
  (``records_shape``), and its backward is a reverse kernel that reads
  them and traces nothing; K2b's and K2c's backward (fwd+bwd) traces the
  chain again.  Past one chunk the kernels walk the tree, its boxes refit
  from each call's vertices (``refit``, a kernel of its own);
* ``make_diff_render`` wraps both in a ``torch.autograd.Function``, whose
  backward asks for the tables that need a gradient alone.

The draws (``BwdDraws``) are the four planes of the JAX ``wavefront_rng``:
the area lights' offsets, the mesh lights' face picks and barycentric
uniforms, the dielectric's branch uniforms and the GI uniforms with the
Russian-roulette and coin draws; handed in, or from Philox keyed by (seed,
step) (``bwd_draws`` is its torch twin).  A bare ``(D, R)`` tensor is the
branch uniforms alone, K2a's only draws.  Scenes outside the kernels
(``bwd_missing``: sphere, background, Perlin or non-diffuse textures, the
environment light, ...) raise ``NotImplementedError`` here;
``diff/optimize.py`` differentiates them through the wavefront integrator
instead, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from advanced_cpu_raytracing_tpu_torch.ops import megakernel as mk
from advanced_cpu_raytracing_tpu_torch.ops import rng
from advanced_cpu_raytracing_tpu_torch.ops import texture as _texture
from advanced_cpu_raytracing_tpu_torch.scene.pack import STREAM_MAX_FACES
from advanced_cpu_raytracing_tpu_torch.scene.types import DecalMode
from advanced_cpu_raytracing_tpu_torch.utils.device import resolve_device

BIG = mk.BIG
TWO_PI = mk.TWO_PI
GI_EPS = 1e-4  # the reference's hard-coded GI epsilon (raytracer.cpp:174)
MAT_PARAM_COLS = 16  # ambient 0:3, diffuse 3:6, specular 6:9, mirror 9:12,
# phong 12, radiance 13:16 (the JAX kernel's mat_tab)
# every light that casts a shadow ray (point, directional, spot, area,
# mesh): the kernel keeps a segment's shadow visibility as one bit per light
# (csrc/mega_bwd.cu VIS_BITS)
MAX_LIGHTS = 32
ML_ROW_COLS = 2  # per mesh-light face: its work-item row, faceArea/surfaceArea


@dataclass(eq=False)
class BwdConsts:
    """Scene facts of the differentiable render that no parameter moves,
    as tensors on one device (the JAX ``BwdConsts``): the K1 tables of the
    initial pack (``mc``: the spheres, the lights' positions and
    directions, the spot lights' cones, the area lights' squares, the mesh
    lights' faces, the materials' type, ior, absorption index and Beer
    coefficient; the chunk boxes ``chunk_tab`` and the tree ``mc.tree`` of
    the initial vertices, whose topology and row order stay while each
    call refits their boxes from its own vertices, ``refit``), the
    tri-table columns after the vertices (``tri_rest``: normal, material,
    mesh light, emissive), the map from the pack's ``verts`` to the work
    items' world vertices, ``rot @ verts[tv] + trn``, each mesh-light
    face's work-item row and area weight (``ml_rows``, the JAX
    ``mlights``: the sampled point moves with that row's vertices) and the
    path tracer's switches.  A textured scene (K2c) reads K1d's tables in
    ``mc``: ``tex_face`` (column 0 a face's diffuse texture, 5:11 its
    vertex UVs), ``tex_int`` (column 6 a texture's first texel in the pool)
    and ``tex_images``, the pool's images in order."""

    mc: mk.MegaConsts
    chunk_tab: torch.Tensor  # (n_chunks, 8)
    tri_rest: torch.Tensor  # (max(W,1), 7): tri-table columns 9:16
    rot: torch.Tensor  # (W, 3, 3)
    trn: torch.Tensor  # (W, 3)
    tv: torch.Tensor  # (W, 3) int64 vertex indices
    mat_types: tuple  # per material: MaterialType int
    max_depth: int
    has_mirror: bool
    has_conductor: bool
    has_dielectric: bool
    has_emissive: bool
    ml_rows: torch.Tensor | None = None  # (F_l, ML_ROW_COLS), mc.ml_faces' order
    pt: bool = False
    pt_importance: bool = False
    pt_nee: bool = False
    pt_rr: bool = False  # Russian roulette (path tracing only)
    pt_spec: bool = False  # path tracing with a mirror, conductor or dielectric
    # what the refit kernel reads of the tree (refit_spans): its leaf runs
    # in depth-first order, and each child slot's span of that order
    tree_runs: torch.Tensor | None = None  # (n_runs,) int32
    tree_spans: torch.Tensor | None = None  # (N * TREE_WIDTH, 2) int32

    @property
    def n_tri(self) -> int:
        return self.mc.n_tri

    @property
    def n_mat(self) -> int:
        return self.mc.materials.shape[0]

    @property
    def n_spot(self) -> int:
        return self.mc.spot_lights.shape[0]

    @property
    def n_area(self) -> int:
        return self.mc.area_lights.shape[0]

    @property
    def n_ml(self) -> int:
        return self.mc.ml_lights.shape[0]

    @property
    def tex(self) -> bool:
        """The scene runs K2c's instantiations: diffuse image textures."""
        return self.mc.n_textures > 0

    @property
    def k2b(self) -> bool:
        """The scene runs K2b's instantiations: path tracing, or a spot,
        area or mesh light."""
        return self.pt or bool(self.n_spot or self.n_area or self.n_ml)

    @property
    def variant(self) -> str:
        """The scene's instantiations: ``mega_bwd`` (K2a) or ``mega_bwd_pt``
        (K2b), with ``_tex`` their K2c twin, over the 128-face chunks, or
        with ``_tree`` over the tree."""
        return ("mega_bwd" + ("_pt" if self.k2b else "")
                + ("_tex" if self.tex else "")
                + ("_tree" if self.mc.tree is not None else ""))

    @property
    def reverse(self) -> bool:
        """K2a: the backward is the reverse kernel on the primal's
        records."""
        return not (self.k2b or self.tex)

    @property
    def primal_kernel(self) -> str:
        """The primal's ``LAUNCHES`` key: ``variant`` with
        ``mega_bwd_primal`` in place of ``mega_bwd``."""
        return self.variant.replace("mega_bwd", "mega_bwd_primal")

    @property
    def backward_kernel(self) -> str:
        """The backward's ``LAUNCHES`` key: K2a's reverse kernel
        ``mega_bwd_rev`` (one for the chunks and the tree: it traces
        nothing), else the fwd+bwd instantiation, ``variant``."""
        return "mega_bwd_rev" if self.reverse else self.variant


class BwdTables(NamedTuple):
    """The parameter tables of one call (differentiable)."""

    mat: torch.Tensor  # (M, MAT_PARAM_COLS)
    pl: torch.Tensor  # (P, 3) point-light intensities
    dl: torch.Tensor  # (Pd, 3) directional radiances
    bg: torch.Tensor  # (3,) background
    tri_w: torch.Tensor  # (max(W,1), 9) world vertices v0 v1 v2
    sl: torch.Tensor  # (Ps, 3) spot-light intensities
    al: torch.Tensor  # (Pa, 3) area-light radiances
    ml: torch.Tensor  # (Pm, 3) mesh-light radiances
    texels: torch.Tensor  # (N, 3) the texel pool (K2c); (0, 3) untextured


class BwdGrads(NamedTuple):
    """Cotangents of ``BwdTables`` and of the rays."""

    mat: torch.Tensor
    pl: torch.Tensor
    dl: torch.Tensor
    bg: torch.Tensor
    tri_w: torch.Tensor
    sl: torch.Tensor
    al: torch.Tensor
    ml: torch.Tensor
    texels: torch.Tensor
    o: torch.Tensor  # (R, 3)
    d: torch.Tensor  # (R, 3)


class BwdDraws(NamedTuple):
    """The draws of one call, each (planes, R) f32, in the layout of the
    JAX ``wavefront_rng`` (megabwd.py:359-420), D = ``bc_depth``."""

    uab: torch.Tensor  # (D*Pa*2, R): area light a of segment k at rows
    # (k*Pa + a)*2 + {0, 1}, offsets in [-0.5, 0.5)
    uml: torch.Tensor  # (D*Pm*3, R): mesh light m of segment k at rows
    # (k*Pm + m)*3 + {0, 1, 2}: the face pick (an integer as a float), the
    # barycentric uniforms
    ud: torch.Tensor  # (D or 0, R): the dielectric's branch uniforms
    ugi: torch.Tensor  # path tracing: 2*D GI uniforms (2k: phi, 2k+1:
    # theta), then D Russian-roulette kill draws (with RR), then D coins
    # (with a specular material)


def bc_depth(bc: BwdConsts) -> int:
    """Chain segments: the primary ray and max_depth bounces, and under
    Russian roulette ``RR_DEPTH_FLOOR`` more (the JAX ``bc_depth``)."""
    return bc.max_depth + 1 + (mk.RR_DEPTH_FLOOR if bc.pt_rr else 0)


def draw_planes(bc: BwdConsts) -> dict:
    """The planes of each ``BwdDraws`` field that the scene draws."""
    d = bc_depth(bc)
    gi = (2 * d + (d if bc.pt_rr else 0) + (d if bc.pt_spec else 0)
          if bc.pt else 0)
    return {"uab": d * bc.n_area * 2, "uml": d * bc.n_ml * 3,
            "ud": d if bc.has_dielectric else 0, "ugi": gi}


def needs_draws(bc: BwdConsts) -> bool:
    return any(draw_planes(bc).values())


_DIFFUSE_DECALS = {int(DecalMode.REPLACE_KD), int(DecalMode.BLEND_KD)}


def bwd_missing(static, opts, pack=None) -> list[str]:
    """Features of a scene/render outside K2a, K2b and K2c (empty list =
    eligible), each worded by what to remove.  The JAX ``bwd_eligible``'s
    semantic gates (no env light, motion, roughness or pluggable BRDFs;
    textures only as diffuse images on meshes) without its TPU caps (rows,
    materials, texels, textures, light, mesh-light face and sphere counts,
    depth 8); the port's own caps are the K1 kernels' and ``MAX_LIGHTS``
    lights that cast shadow rays.  A textured scene is refused without its
    ``pack``, which the texture gates read."""
    missing = []
    if static.n_textures:
        missing += _texture_missing(static, pack)
    if static.n_env:
        missing.append("an environment light")
    if static.has_motion:
        missing.append("motion blur")
    if static.has_rough:
        missing.append("roughness")
    if static.n_brdfs:
        missing.append("pluggable BRDFs")
    if static.n_mesh_lights > mk.MAX_MESH_LIGHTS:
        missing.append(f"more than {mk.MAX_MESH_LIGHTS} mesh lights")
    if static.n_faces and not static.n_work_items:
        missing.append(f"more than {STREAM_MAX_FACES:,} faces")
    if not (static.n_work_items or static.n_spheres):
        missing.append("empty scene")
    if static.n_spheres > mk.MAX_SPHERES:
        missing.append(f"more than {mk.MAX_SPHERES} spheres")
    if static.n_materials > mk.MAX_MATERIALS:
        missing.append(f"more than {mk.MAX_MATERIALS} materials")
    if opts.max_depth > mk.MAX_DEPTH:
        missing.append(f"depth above {mk.MAX_DEPTH}")
    if (static.n_point + static.n_directional + static.n_spot + static.n_area
            + static.n_mesh_lights) > MAX_LIGHTS:
        missing.append(f"more than {MAX_LIGHTS} point, directional, spot, "
                       "area and mesh lights")
    return missing


def _texture_missing(static, pack) -> list[str]:
    """The semantic gates of the JAX ``_bwd_tex_ok`` (megabwd.py:203-230)
    without its caps of 4 textures and 4,096 texels: image textures with a
    ``replace_kd`` or ``blend_kd`` decal, on meshes.  The others go through
    the wavefront (``diff/optimize.py``), as in the JAX package."""
    if pack is None:  # the gates read the pack
        return ["textures"]
    n = static.n_textures
    kind = mk._np(pack.tex_kind)[:n]
    decal = mk._np(pack.tex_decal)[:n]
    timg = mk._np(pack.tex_img)[:n]
    missing = []
    if static.n_spheres and (mk._np(pack.sph_tex)[:static.n_spheres] >= 0).any():
        missing.append("sphere textures")
    if int(static.bg_tex) >= 0:
        missing.append("the background texture")
    if (kind == 1).any():
        missing.append("Perlin textures")
    others = sorted({DecalMode(int(decal[i])).name.lower() for i in range(n)
                     if int(decal[i]) not in _DIFFUSE_DECALS
                     and int(decal[i]) != int(DecalMode.REPLACE_BACKGROUND)})
    if others:
        missing.append("textures with decal " + ", ".join(others)
                       + " (specular-slot, bump or normal-map)")
    if ((kind == 0) & (timg < 0)).any():
        missing.append("an image texture without an image")
    return missing


def bwd_eligible(static, opts, pack=None) -> bool:
    """Static feature gate of K2a and K2b (see ``bwd_missing``)."""
    return not bwd_missing(static, opts, pack)


def build_bwd_consts(pack, opts, device=None) -> BwdConsts:
    """The constant tables of the differentiable render of ``pack`` on
    ``device`` (default ``cuda``); raises ``NotImplementedError`` for a
    scene outside K2a, K2b and K2c."""
    dev = resolve_device(device)
    st = pack.static
    missing = bwd_missing(st, opts, pack)
    if missing:
        raise NotImplementedError(
            "scene outside the differentiable kernels K2a, K2b and K2c: "
            + ", ".join(missing))
    # the forward route's tree past one chunk, over LEAF_ROWS-row leaves:
    # each call refits its boxes from the call's vertices (refit)
    mc, tri_tab, chunk_tab = mk.build_mega(pack, opts, device=dev,
                                           flat_max=mk.FWD_FLAT_MAX_FACES)
    w = st.n_work_items
    ent = pack.ent_fwd.to(dev)[pack.wi_ent[:w].to(dev).long()]  # (W,3,4)
    # each mesh-light face's row and weight, in build_mega's ml_faces order
    # (each light's work items in table order)
    ml_rows = np.zeros((0, ML_ROW_COLS), np.float32)
    n_ml = mc.ml_lights.shape[0]
    if n_ml:
        wi_ent = mk._np(pack.wi_ent)[:w]
        rows = np.concatenate([np.where(wi_ent == int(e))[0]
                               for e in mk._np(pack.ml_ent)[:n_ml]])
        ml_rows = np.stack([rows.astype(np.float32),
                            mk._np(mc.ml_faces)[:, 9]], 1)
    pt = bool(opts.path_tracing)
    any_spec = st.has_mirror or st.has_conductor or st.has_dielectric
    runs = spans = None
    if mc.tree is not None:
        runs, spans = (torch.as_tensor(a, device=dev) for a in refit_spans(
            mk._np(mc.tree), mc.tree_leaf_rows))
    return BwdConsts(
        mc=mc, chunk_tab=chunk_tab, tri_rest=tri_tab[:, 9:].contiguous(),
        rot=ent[:, :, :3].contiguous(), trn=ent[:, :, 3].contiguous(),
        tv=pack.tri_vidx.to(dev)[pack.wi_face[:w].to(dev).long()].long(),
        mat_types=tuple(int(x) for x in mk._np(pack.mat_type)),
        max_depth=int(opts.max_depth), has_mirror=bool(st.has_mirror),
        has_conductor=bool(st.has_conductor),
        has_dielectric=bool(st.has_dielectric),
        has_emissive=bool(st.has_emissive_mat),
        ml_rows=torch.as_tensor(ml_rows, device=dev), pt=pt,
        pt_importance=pt and bool(opts.importance_sampling),
        pt_nee=pt and bool(opts.next_event_estimation),
        pt_rr=pt and bool(opts.russian_roulette),
        pt_spec=pt and bool(any_spec), tree_runs=runs, tree_spans=spans)


def refit_spans(tree: np.ndarray, leaf_rows: int):
    """(runs (n_runs,) int32, spans (N * TREE_WIDTH, 2) int32): the leaf
    runs of the tree ``tree`` (N, NODE_COLS) in depth-first order (run j:
    rows j * ``leaf_rows`` onward), and each child slot's (first, count) of
    that order (count 0: no child), what the refit kernel reads.  In a
    depth-first order each subtree's leaves are consecutive."""
    wd = mk.TREE_WIDTH
    ints = tree.view(np.int32)
    code, cnt = ints[:, 6 * wd:7 * wd], ints[:, 7 * wd:8 * wd]
    runs = []
    spans = np.zeros((tree.shape[0] * wd, 2), np.int32)

    def visit(node):
        for k in range(wd):
            first = len(runs)
            if cnt[node, k] > 0:  # a leaf: ~(first row << 5 | rows)
                runs.append((~int(code[node, k]) >> 5) // leaf_rows)
            elif cnt[node, k] == 0:  # an inner child: its node's row
                visit(int(code[node, k]))
            spans[node * wd + k] = first, len(runs) - first

    visit(0)
    return np.asarray(runs, np.int32), spans


def world_vertices(bc: BwdConsts, verts: torch.Tensor) -> torch.Tensor:
    """The work items' world vertices (max(W,1), 9) from the pack's
    ``verts`` (V,3): ``rot @ verts[tv] + trn`` per corner, elementwise (the
    JAX ``tables``), so that autograd maps their cotangent to ``verts``."""
    if not bc.n_tri:
        return torch.zeros((1, 9), dtype=torch.float32, device=bc.rot.device)
    vk = verts[bc.tv]  # (W, 3 corners, 3)
    tri_w = (bc.rot[:, None, :, :] * vk[:, :, None, :]).sum(-1) \
        + bc.trn[:, None, :]
    return tri_w.reshape(bc.n_tri, 9)


def refit_ref(bc: BwdConsts, tri_w: torch.Tensor):
    """The plain version of ``refit``: (nodes, chunk_tab) with the boxes of
    the vertices ``tri_w`` (max(W,1), 9).  With a tree, ``mc.tree`` with
    each child's box the min and max of the vertices of the rows under it,
    bottom-up over the child codes (a leaf's its rows', an inner child's
    the union of its node's child boxes), its codes, counts and topology
    as built, and ``chunk_tab`` as built (the tree kernels read no chunk
    box); without, None and ``chunk_tab`` with each 128-row chunk's box.
    Min and max do not round, so on ``build_mega``'s own vertices the boxes
    are the built ones bit for bit.  Raises for a scene with motion, whose
    boxes sweep the motion (K2 has none: ``bwd_missing``)."""
    mc = bc.mc
    if mc.has_motion:
        raise ValueError("refit: the scene has motion, which K2 does not "
                         "take (bwd_missing)")
    v = tri_w.detach()[:max(mc.n_tri, 1)].reshape(-1, 3, 3)
    fmin, fmax = v.amin(1), v.amax(1)
    inf = float("inf")
    if mc.tree is None:
        pad = -fmin.shape[0] % mk.CHUNK
        lo = torch.cat([fmin, fmin.new_full((pad, 3), inf)])
        hi = torch.cat([fmax, fmax.new_full((pad, 3), -inf)])
        chunk = bc.chunk_tab.clone()
        chunk[:, 0:3] = lo.reshape(-1, mk.CHUNK, 3).amin(1)
        chunk[:, 3:6] = hi.reshape(-1, mk.CHUNK, 3).amax(1)
        return None, chunk
    wd = mk.TREE_WIDTH
    nodes = mc.tree.clone()
    n = nodes.shape[0]
    ints = nodes.view(torch.int32)
    code, cnt = ints[:, 6 * wd:7 * wd].long(), ints[:, 7 * wd:8 * wd].long()
    lo = torch.full((n, wd, 3), inf, device=nodes.device)
    hi = torch.full((n, wd, 3), -inf, device=nodes.device)
    # each leaf's box: the min and max over its rows
    leaf = cnt > 0
    packed = ~code[leaf]
    first, rows = packed >> 5, packed & 31
    at = first[:, None] + torch.arange(31, device=nodes.device)
    inside = torch.arange(31, device=nodes.device) < rows[:, None]
    at = torch.where(inside, at, 0)
    lo[leaf] = torch.where(inside[..., None], fmin[at], inf).amin(1)
    hi[leaf] = torch.where(inside[..., None], fmax[at], -inf).amax(1)
    # each inner child's box: the union of its node's child boxes, deepest
    # nodes first (a node's children lie below it in the depth-first rows)
    level = torch.zeros(n, dtype=torch.long)
    inner = (cnt == 0).cpu()
    code_c = code.cpu()
    for node in range(n):
        kids = code_c[node][inner[node]]
        level[kids] = level[node] + 1
    level = level.to(nodes.device)
    for lv in range(int(level.max()) - 1, -1, -1):
        slot = (cnt == 0) & (level == lv)[:, None]
        kid = code[slot]
        lo[slot] = lo[kid].amin(1)
        hi[slot] = hi[kid].amax(1)
    # the empty slots keep their built boxes
    keep = (cnt < 0)[:, None, :]
    box = nodes[:, :6 * wd].view(n, 6, wd)  # min xyz, max xyz; by child
    box[:, 0:3] = torch.where(keep, box[:, 0:3], lo.transpose(1, 2))
    box[:, 3:6] = torch.where(keep, box[:, 3:6], hi.transpose(1, 2))
    return nodes, bc.chunk_tab


def ud_table(seed: int, step: int, n_rays: int, depth: int,
             device=None) -> torch.Tensor:
    """The dielectric branch uniforms (depth, n_rays) that the kernel draws
    without a table: Philox4x32-10 keyed by (seed, step), counter (ray,
    segment, 0, 0), word 0 (``ops/rng.py``)."""
    return rng.philox_table(seed, step, n_rays, depth, 1, device=device)


def _philox_block(seed: int, step: int, n_rays: int, depth: int, c2: int,
                  device) -> list:
    """The four words of counter (ray, segment, c2, 0) as uniforms, each
    (depth, n_rays)."""
    ray = torch.arange(n_rays, dtype=torch.int64, device=device)[None, :]
    seg = torch.arange(depth, dtype=torch.int64, device=device)[:, None]
    shape = (depth, n_rays)
    words = rng.philox4x32(ray.expand(shape), seg.expand(shape),
                           torch.full(shape, c2, dtype=torch.int64,
                                      device=device),
                           torch.zeros(shape, dtype=torch.int64, device=device),
                           int(seed), int(step))
    return [rng.uniform_from_bits(w) for w in words]


def bwd_draws(bc: BwdConsts, seed: int, step: int, n_rays: int,
              device=None) -> BwdDraws:
    """The draws that the kernels take without a table, in torch: Philox4x32
    -10 keyed by (seed, step) with counter (ray, segment, c, 0), each word
    as a 23-bit uniform: c = 0 the branch uniform (word 0, ``ud_table``'s);
    c = 1 the GI pair, the RR kill draw and the coin (words 0-3); c = 2 + a
    area light a's offsets (words 0-1, minus 0.5); c = 2 + n_area + m mesh
    light m's face pick min(floor(u count), count - 1) (word 0, as a float)
    and barycentric uniforms (words 1-2)."""
    d = bc_depth(bc)
    planes = draw_planes(bc)
    f32 = torch.float32
    empty = torch.zeros((0, n_rays), dtype=f32, device=device)
    ud = ud_table(seed, step, n_rays, d, device) if planes["ud"] else empty
    ugi = empty
    if planes["ugi"]:
        w = _philox_block(seed, step, n_rays, d, 1, device)
        parts = [torch.stack(w[:2], 1).reshape(2 * d, n_rays)]
        if bc.pt_rr:
            parts.append(w[2])
        if bc.pt_spec:
            parts.append(w[3])
        ugi = torch.cat(parts)
    uab = empty
    if planes["uab"]:
        offs = []
        for a in range(bc.n_area):
            w = _philox_block(seed, step, n_rays, d, 2 + a, device)
            offs.append(torch.stack([w[0] - 0.5, w[1] - 0.5], 1))
        uab = torch.stack(offs, 1).reshape(d * bc.n_area * 2, n_rays)
    uml = empty
    if planes["uml"]:
        counts = [int(x) for x in mk._np(bc.mc.ml_lights[:, 4])]
        picks = []
        for m, count in enumerate(counts):
            w = _philox_block(seed, step, n_rays, d, 2 + bc.n_area + m, device)
            face = torch.clamp((w[0] * float(count)).to(torch.int64),
                               max=count - 1).to(f32)
            picks.append(torch.stack([face, w[1], w[2]], 1))
        uml = torch.stack(picks, 1).reshape(d * bc.n_ml * 3, n_rays)
    return BwdDraws(uab.contiguous(), uml.contiguous(), ud.contiguous(),
                    ugi.contiguous())


def table_draws(bc: BwdConsts, n_rays: int, generator: torch.Generator,
                device=None) -> BwdDraws:
    """Random draws in the ``BwdDraws`` layout from ``generator`` (a table
    in place of JAX's, for checks): uniforms, the area offsets shifted to
    [-0.5, 0.5) and the mesh-light picks made integers below each light's
    face count."""
    planes = draw_planes(bc)
    dr = BwdDraws(*(torch.rand((planes[k], n_rays), generator=generator,
                               device=device)
                    for k in ("uab", "uml", "ud", "ugi")))
    uml = dr.uml
    if bc.n_ml:
        uml = uml.reshape(-1, bc.n_ml, 3, n_rays).clone()
        for m, count in enumerate(int(x) for x in mk._np(bc.mc.ml_lights[:, 4])):
            uml[:, m, 0] = torch.clamp((uml[:, m, 0] * count).floor(),
                                       max=count - 1)
        uml = uml.reshape(-1, n_rays)
    return dr._replace(uab=dr.uab - 0.5, uml=uml)


def as_draws(bc: BwdConsts, draws, n_rays: int) -> BwdDraws | None:
    """``draws`` (a ``BwdDraws``, a bare ``(D, R)`` tensor of branch
    uniforms, or None) as a ``BwdDraws``, its planes checked against the
    scene's; None stays None."""
    if draws is None:
        return None
    if torch.is_tensor(draws):
        empty = draws.new_zeros((0, n_rays))
        if tuple(draws.shape) != (bc_depth(bc), n_rays):
            raise ValueError(f"draws: shape {tuple(draws.shape)}, expected "
                             f"({bc_depth(bc)}, {n_rays})")
        return BwdDraws(empty, empty, draws, empty)
    draws = BwdDraws(*draws)
    for name, n in draw_planes(bc).items():
        x = getattr(draws, name)
        if n and tuple(x.shape) != (n, n_rays):
            raise ValueError(f"draws.{name}: shape {tuple(x.shape)}, expected "
                             f"({n}, {n_rays})")
    return draws


# ---------------------------------------------------------------------------
# plain torch version
# ---------------------------------------------------------------------------


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _norm3(v):
    return mk._norm3(*v)


def _powmax(base, e):
    """``powmax`` of the JAX kernel (megabwd.py:469-473): e * log(base)
    only where base > 0, so that autograd gives no gradient elsewhere."""
    pos = base > 0.0
    val = torch.exp(e * torch.log(torch.where(pos, base, 1.0)))
    return torch.where(pos, val, torch.where(e == 0.0, 1.0, 0.0))


def _cramer_t(v9, o, d, bary: bool = False):
    """The ray parameter of the plane hit through the winner's vertices
    (Mesh::IntersectFace, mesh.cpp:201-236; megabwd.py:809-818): the t of
    ``_tri_hit``, differentiable in v9, o and d; with ``bary`` (t, beta,
    gamma), the hit's barycentrics too (megabwd.py:842-847), in the
    expressions of csrc/mega_tex.cuh's ``surface``."""
    v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z = v9
    e1x, e1y, e1z = v0x - v1x, v0y - v1y, v0z - v1z
    e2x, e2y, e2z = v0x - v2x, v0y - v2y, v0z - v2z
    bx, by, bz = v0x - o[0], v0y - o[1], v0z - o[2]
    m0 = e2y * d[2] - d[1] * e2z
    m1 = e2x * d[2] - d[0] * e2z
    m2 = e2x * d[1] - d[0] * e2y
    det_a = e1x * m0 - e1y * m1 + e1z * m2
    safe = torch.where(det_a == 0.0, 1.0, det_a)
    q0 = e2y * bz - by * e2z
    q1 = e2x * bz - bx * e2z
    q2 = e2x * by - bx * e2y
    t = (e1x * q0 - e1y * q1 + e1z * q2) / safe
    if not bary:
        return t
    beta = (bx * m0 - by * m1 + bz * m2) / safe
    n0 = by * d[2] - d[1] * bz
    n1 = bx * d[2] - d[0] * bz
    n2 = bx * d[1] - d[0] * by
    gamma = (e1x * n0 - e1y * n1 + e1z * n2) / safe
    return t, beta, gamma


def _texture_kd(bc: BwdConsts, texels, slot, row, beta, gamma, kd3, count):
    """The step's kd on a face with a diffuse image texture (JAX
    megabwd.py:835-883; raytracer.cpp:478-508): uv = uv0 + beta (uv1 - uv0)
    + gamma (uv2 - uv0) tiled, the nearest tap or the four bilinear taps of
    ``texels`` (the pool) weighted by the bilinear weights of uv, over 255;
    ``blend_kd`` averages it with the material's kd.  ``slot`` (R,) is the
    winner's diffuse texture or -1 (stop-grad), ``kd3`` the material's kd;
    differentiable in the texels, beta, gamma and kd.  The expressions are
    csrc/mega_bwd.cu's ``tex_step``."""
    mc = bc.mc
    on = slot >= 0
    q = mc.tex_face[row.clamp(min=0)]
    # untextured lanes take uv 0: their barycentrics may be any number
    beta = torch.where(on, beta, 0.0)
    gamma = torch.where(on, gamma, 0.0)
    u = _texture.tile_uv(q[:, 5] + beta * (q[:, 7] - q[:, 5])
                         + gamma * (q[:, 9] - q[:, 5]))
    v = _texture.tile_uv(q[:, 6] + beta * (q[:, 8] - q[:, 6])
                         + gamma * (q[:, 10] - q[:, 6]))
    out = list(kd3)
    for ti, (_, interp, blend, _, w, h, first) in enumerate(
            mc.tex_int.tolist()):
        m = slot == ti
        n_on = int(m.sum())
        if not n_on:
            continue

        def fetch(i, j):
            return texels[first + j * w + i]

        if interp == 0:
            tap = fetch(*_texture.nearest_ij(u.detach(), v.detach(), w, h))
        else:
            taps, wts = _texture.bilinear_taps(u, v, w, h)
            tap = wts[0][:, None] * fetch(*taps[0])
            for wt, ij in zip(wts[1:], taps[1:]):
                tap = tap + wt[:, None] * fetch(*ij)
        count("tex_steps", n_on)
        count("texel_taps", n_on * (1 if interp == 0 else 4))
        val = tap * mk._INV255
        for c in range(3):
            kc = (val[:, c] + kd3[c]) * 0.5 if blend else val[:, c]
            out[c] = torch.where(m, kc, out[c])
    return out


def _sphere_local(s, o, d):
    """The ray in a sphere's object space: s (R, SPH_COLS) rows."""
    ol = [s[:, 4 * i] * o[0] + s[:, 4 * i + 1] * o[1] + s[:, 4 * i + 2] * o[2]
          + s[:, 4 * i + 3] for i in range(3)]
    dl = [s[:, 4 * i] * d[0] + s[:, 4 * i + 1] * d[1] + s[:, 4 * i + 2] * d[2]
          for i in range(3)]
    return ol, dl


def _sphere_t(s, o, d):
    """Differentiable quadratic solve (Sphere::Intersect, sphere.cpp:31-72;
    megabwd.py:545-566), its square root guarded where the discriminant is
    not positive."""
    ol, dl = _sphere_local(s, o, d)
    oc = [ol[i] - s[:, 21 + i] for i in range(3)]
    rad = s[:, 24]
    a = _dot(dl, dl)
    b = 2.0 * _dot(dl, oc)
    cc = _dot(oc, oc) - rad * rad
    delta = b * b - 4.0 * a * cc
    pos = delta > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, delta, 1.0)), 0.0)
    denom = torch.where(a > 0.0, 2.0 * a, 1.0)
    t1 = (-b + sq) / denom
    t2 = (-b - sq) / denom
    lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
    return torch.where(lo > 0.0, lo, hi)


def _sphere_normal(s, o, d, t):
    """Unit world normal at t (megabwd.py:568-580): nrm @ ((ol + t dl) - c)."""
    ol, dl = _sphere_local(s, o, d)
    pr = [ol[i] + t * dl[i] - s[:, 21 + i] for i in range(3)]
    return _norm3([s[:, 12 + 3 * i] * pr[0] + s[:, 13 + 3 * i] * pr[1]
                   + s[:, 14 + 3 * i] * pr[2] for i in range(3)])


def _conductor_ratio(n2, k2, c):
    """The conductor's Fresnel ratio at cos c (raytracer.cpp:208-254;
    megabwd.py:1102-1109)."""
    n2k2 = n2 * n2 + k2 * k2
    two = 2.0 * n2 * c
    cos2 = c * c
    rs = (n2k2 - two + cos2) / torch.clamp(n2k2 + two + cos2, min=1e-20)
    rp = (n2k2 * cos2 - two + 1.0) / torch.clamp(n2k2 * cos2 + two + 1.0,
                                                 min=1e-20)
    return 0.5 * (rs + rp)


def _towards(target, p):
    """Unit direction and clamped squared distance from p to ``target``
    (three tensors or numbers): tl = target - p, d2 = max(tl . tl, 1e-20),
    wi = tl / sqrt(d2), as the kernel's ``light_at`` and ``ext_at``."""
    tl = [target[c] - p[c] for c in range(3)]
    d2 = torch.clamp(_dot(tl, tl), min=1e-20)
    inv = 1.0 / torch.sqrt(d2)
    return [c * inv for c in tl], d2


def _spot_e(sl, wi, d2):
    """A spot light's irradiance factor 1/d2 times its falloff (the
    kernel's ``spot_falloff``: cosine-space cone tests, spotLight.h:33-57)
    toward unit wi; ``sl`` is its constant row (SPOT_COLS, floats)."""
    cos_a = torch.clamp(-(sl[3] * wi[0] + sl[4] * wi[1] + sl[5] * wi[2]),
                        -1.0, 1.0)
    irr = 1.0 / d2
    frac = torch.clamp(mk._div(cos_a - sl[9], sl[11]), min=0.0)
    scale = torch.where(cos_a < sl[10], frac * frac * frac * frac, 1.0)
    scale = torch.where((cos_a >= 1.0) | (cos_a < sl[9]), 0.0, scale)
    return irr * scale


def _area_point(al, o1, o2):
    """The sampled point of an area light's square (areaLight.h:34-41):
    pos + u (extent o1) + v (extent o2); ``al`` its row (AREA_COLS)."""
    ext = al[9]
    return [al[c] + al[11 + c] * (ext * o1) + al[14 + c] * (ext * o2)
            for c in range(3)]


def _ml_point(v9, b1, b2):
    """The sqrt-warped barycentric point of a mesh-light face
    (MeshLight::SampleRandomPoint, meshLight.h:27-50) of corners v9 (R,9)."""
    sq = torch.sqrt(b1)
    q = [v9[:, 3 + c] * (1.0 - b2) + v9[:, 6 + c] * b2 for c in range(3)]
    return [v9[:, c] * (1.0 - sq) + q[c] * sq for c in range(3)]


def diff_trace_ref(bc: BwdConsts, tabs: BwdTables, o, d, draws=None,
                   stats=None):
    """Plain torch version of K2a and K2b: radiance (R,3) of rays o, d (R,3),
    differentiable by autograd in ``tabs`` and in o and d.

    Shaped like the JAX kernel's unrolled chain (megabwd.py:1189-1483):
    for each of the ``bc_depth`` segments, the closest hit of the rays still
    in the chain (the port's ``_Geometry`` over ``tabs.tri_w`` and the
    boxes refit from it, ``refit_ref``, under ``no_grad``; a ray that took
    its GI child keeps the GI ray's hit), the stop-grad topology — in path
    tracing the GI ray traced before the light terms, whose mesh light it
    hit NEE skips — then
    one differentiable step over every ray (masked, with the JAX kernel's
    guards, so that a masked lane passes no NaN back).  ``draws`` (see
    ``as_draws``) are needed where the scene draws (``draw_planes``).
    ``stats``, when given, receives the slab, triangle and sphere tests the
    kernel performs (``_Geometry``'s counts), the traced segments
    (``traces``; ``reused``: segments that took their GI ray's hit), the GI
    rays, shadow rays and lit light evaluations, and the textured steps and
    their texel taps."""
    mc = bc.mc
    dev, f32 = o.device, torch.float32
    r = o.shape[0]
    depth = bc_depth(bc)
    dr = as_draws(bc, draws, r)
    if needs_draws(bc) and dr is None:
        raise ValueError(f"this scene draws: it needs draws {draw_planes(bc)} "
                         f"planes of {r} rays")
    with torch.no_grad():
        tri_tab = torch.cat([tabs.tri_w.detach(), bc.tri_rest], 1)
        # the boxes of the call's vertices, as the kernels read them
        nodes, chunk_tab = refit_ref(bc, tabs.tri_w)
        geo = mk._Geometry(mc if nodes is None
                           else dataclasses.replace(mc, tree=nodes),
                           tri_tab, chunk_tab, stats)
        mfix = mc.materials  # type 0, ior 14, k 15, absorption 16:19
        # sphere rows, and an identity row for the lanes that hit no sphere
        n_sph = mc.spheres.shape[0]
        ident = torch.zeros((1, mk.SPH_COLS), dtype=f32, device=dev)
        ident[0, [0, 5, 10, 12, 16, 20, 24]] = 1.0
        sph_tab = torch.cat([mc.spheres, ident])
        pl_pos = mc.point_lights[:, 0:3]
        dl_wi = mc.dir_lights[:, 0:3]
        ambient = torch.tensor(mc.ambient, dtype=f32, device=dev)
        spots = mc.spot_lights.tolist()
        areas = mc.area_lights.tolist()
        mls = mc.ml_lights.tolist()
        ml_rows = bc.ml_rows
    has_amb = any(a != 0.0 for a in mc.ambient)
    eps = mc.eps
    any_spec = bc.has_mirror or bc.has_conductor or bc.has_dielectric
    sample_direct = not bc.pt or bc.pt_nee
    n_pa, n_pm = len(areas), len(mls)
    sg_off = 2 * depth + (depth if bc.pt_rr else 0)

    def count(key, n):
        if stats is not None:
            stats[key] = stats.get(key, 0) + int(n)

    def type_mask(matl, mtype):
        m = torch.zeros(r, dtype=torch.bool, device=dev)
        for i, ty in enumerate(bc.mat_types):
            if ty == mtype:
                m = m | (matl == i)
        return m

    o3 = [o[:, i] for i in range(3)]
    d3 = [d[:, i] for i in range(3)]
    w3 = [torch.ones(r, dtype=f32, device=dev) for _ in range(3)]
    active = torch.ones(r, dtype=torch.bool, device=dev)
    medium = torch.ones(r, dtype=f32, device=dev)
    absorb = torch.zeros((r, 3), dtype=f32, device=dev)
    L = [torch.zeros(r, dtype=f32, device=dev) for _ in range(3)]
    # path tracing: the hit of the GI ray of the lanes that took it (t,
    # hit, winner, material), the next segment's hit
    pending, cont_prev = None, torch.zeros(r, dtype=torch.bool, device=dev)
    for k in range(depth):
        # ---- topology (stop-grad) ----
        with torch.no_grad():
            od = [c.detach() for c in o3]
            dd = [c.detach() for c in d3]
            fresh = active & ~cont_prev
            idx = fresh.nonzero().squeeze(1)
            count("traces", idx.numel())
            count("reused", int((active & cont_prev).sum()))
            t0 = torch.zeros(r, dtype=f32, device=dev)
            hit = torch.zeros(r, dtype=torch.bool, device=dev)
            win = torch.full((r,), -1, dtype=torch.int64, device=dev)
            matl = torch.zeros(r, dtype=torch.int64, device=dev)
            if idx.numel():
                tb, _, _, _, mf, _, h, wn = geo.trace(
                    *(c[idx] for c in od + dd), want_win=True)
                t0[idx], hit[idx], win[idx] = tb, h, wn
                matl[idx] = mf.long()
            if pending is not None:
                t0 = torch.where(cont_prev, pending[0], t0)
                hit = torch.where(cont_prev, pending[1], hit)
                win = torch.where(cont_prev, pending[2], win)
                matl = torch.where(cont_prev, pending[3], matl)
            row = torch.where(win >= 0, win, -1)
            sph = torch.where(win <= -2, -2 - win, -1)
            is_tri, is_sph = row >= 0, sph >= 0
            s_sel = sph_tab[torch.where(is_sph, sph, n_sph)]
            t_safe = torch.where(hit, t0, 0.0)
            n_tri = bc.tri_rest[row.clamp(min=0), 0:3]
            # the winner's diffuse texture (a sphere clears it, megabwd.py:
            # 711-714)
            slot = (torch.where(is_tri, mc.tex_face[row.clamp(min=0), 0], -1.0)
                    .long() if bc.tex else None)
            ng = [torch.where(is_tri, n_tri[:, i], 0.0 if i < 2 else 1.0)
                  for i in range(3)]
            if n_sph:
                ns = _sphere_normal(s_sel, od, dd, torch.where(is_sph, t0, 0.0))
                ng = [torch.where(is_sph, ns[i], ng[i]) for i in range(3)]
            is_em = (hit & type_mask(matl, mk._EMISSIVE) if bc.has_emissive
                     else torch.zeros_like(hit))
            shadeable = hit & ~is_em
            lit = shadeable
            if bc.has_dielectric:
                lit = lit & ~(medium > 1.00001)
            if not sample_direct:
                lit = torch.zeros_like(hit)
            miss_primary = active & ~hit if k == 0 else torch.zeros_like(hit)
            # children: mirror, conductor, dielectric (depth left)
            chain = torch.zeros_like(hit)
            is_mirror = is_cond = d_reflect = d_refract = chain
            next_medium = torch.ones(r, dtype=f32, device=dev)
            next_absorb = torch.zeros((r, 3), dtype=f32, device=dev)
            sgn = ratio_n = torch.ones(r, dtype=f32, device=dev)
            mrow = mfix[matl]
            if k < bc.max_depth and any_spec:
                if bc.has_mirror:
                    is_mirror = hit & type_mask(matl, mk._MIRROR)
                if bc.has_conductor:
                    cos_g = _dot(ng, [-c for c in dd])
                    ratio_g = _conductor_ratio(mrow[:, 14], mrow[:, 15], cos_g)
                    is_cond = hit & type_mask(matl, mk._CONDUCTOR) \
                        & (ratio_g > 1e-4)
                if bc.has_dielectric:
                    is_diel = hit & type_mask(matl, mk._DIELECTRIC)
                    cos0 = -_dot(ng, dd)
                    entering = cos0 > 0.0
                    ior = mrow[:, 14]
                    n1 = torch.where(entering, medium, ior)
                    n2d = torch.where(entering, ior, 1.0)
                    obj_n = n2d
                    ratio_n = mk._div(n1, torch.clamp(n2d, min=1e-20))
                    cos_i = cos0.abs()
                    crit = ratio_n * ratio_n * (1.0 - cos_i * cos_i)
                    tir = crit > 1.0
                    cos_p = torch.where(tir, 0.0, torch.sqrt(
                        torch.clamp(1.0 - crit, min=1e-20)))
                    n2cos = n2d * cos_i
                    n1cosp = n1 * cos_p
                    rpar = (n2cos - n1cosp) / torch.clamp(n2cos + n1cosp,
                                                          min=1e-20)
                    rperp = (n1 * cos_i - n2d * cos_p) / torch.clamp(
                        n1 * cos_i + n2d * cos_p, min=1e-20)
                    r_refl = 0.5 * (rpar * rpar + rperp * rperp)
                    choose_refl = dr.ud[k] < r_refl
                    rl = is_diel & ~tir
                    d_reflect = (is_diel & tir) | (rl & choose_refl)
                    d_refract = rl & ~choose_refl
                    sgn = torch.where(entering, 1.0, -1.0)
                    next_medium = torch.where(is_diel & tir, medium, next_medium)
                    next_medium = torch.where(rl, obj_n, next_medium)
                    take = ((is_diel & tir & (medium > 1.0001))
                            | (rl & choose_refl & (obj_n > 1.00001))
                            | (rl & ~choose_refl & (obj_n > 1.001)))
                    next_absorb = torch.where(take[:, None], mrow[:, 16:19],
                                              next_absorb)
                chain = is_mirror | is_cond | d_reflect | d_refract
            p_top = [od[i] + t_safe * dd[i] for i in range(3)]
            # ---- path tracing: the GI ray, traced now (integrator.py:
            # 259-297): NEE skips the mesh light it hit, and its hit is the
            # next segment's where the GI child is taken ----
            skip = [torch.zeros_like(hit) for _ in range(n_pm)]
            cont_gi = both = torch.zeros_like(hit)
            if bc.pt and k < depth - 1:
                r1, r2 = dr.ugi[2 * k], dr.ugi[2 * k + 1]
                gi_alive = shadeable
                if bc.pt_rr and k >= bc.max_depth:
                    # the kill on the post-Beer weight, as the oracle
                    # (integrator.py:218-219, 260-265) and the step's
                    # reweight take it
                    wt = [c.detach() for c in w3]
                    if bc.has_dielectric and k > 0:
                        wt = [wt[c] * torch.exp(-absorb[:, c] * t_safe)
                              for c in range(3)]
                    prob = torch.clamp(torch.stack(wt).amax(0), 1e-4, 1.0)
                    gi_alive = gi_alive & ~(dr.ugi[2 * depth + k] > prob)
                gd_top = list(mk._gi_direction(*ng, r1, r2, bc.pt_importance))
                go_top = [p_top[i] + ng[i] * GI_EPS for i in range(3)]
                gi = gi_alive.nonzero().squeeze(1)
                count("gi_traces", gi.numel())
                g_t = torch.zeros(r, dtype=f32, device=dev)
                g_hit = torch.zeros_like(hit)
                g_win = torch.full((r,), -1, dtype=torch.int64, device=dev)
                g_mat = torch.zeros(r, dtype=torch.int64, device=dev)
                g_ml = torch.full((r,), -1.0, dtype=f32, device=dev)
                if gi.numel():
                    tb, _, _, _, mf, gml, h, wn = geo.trace(
                        *(c[gi] for c in go_top + gd_top), want_win=True)
                    g_t[gi], g_hit[gi], g_win[gi] = tb, h, wn
                    g_mat[gi], g_ml[gi] = mf.long(), gml
                skip = [g_hit & (g_ml == float(m)) for m in range(n_pm)]
                gi_would = gi_alive & g_hit
                if bc.pt_spec:
                    coin = dr.ugi[sg_off + k] < 0.5
                    both = gi_would & chain
                    cont_gi = gi_would & (~chain | coin)
                    chain = cont_gi | (chain & (~gi_would | ~coin))
                else:
                    cont_gi = chain = gi_would
                # a GI child keeps the medium and carries no Beer constant
                next_medium = torch.where(cont_gi, medium, next_medium)
                next_absorb = torch.where(cont_gi[:, None], 0.0, next_absorb)
                pending = (g_t, g_hit, g_win, g_mat)
            # shadow visibility per light (stop-grad), from the lit lanes
            so = [p_top[i] + ng[i] * eps for i in range(3)]
            lidx = lit.nonzero().squeeze(1)
            vis_p, vis_d, vis_s, vis_a, vis_m = [], [], [], [], []
            for i in range(pl_pos.shape[0]):
                wi, d2 = _towards([pl_pos[i, c] for c in range(3)], p_top)
                vis_p.append(_visible(geo, lidx, so, wi, torch.sqrt(d2), r))
            for i in range(dl_wi.shape[0]):
                wi = [dl_wi[i, c].expand(r) for c in range(3)]
                vis_d.append(_visible(geo, lidx, so, wi,
                                      torch.full((r,), BIG, device=dev), r))
            for sl in spots:
                wi, d2 = _towards(sl[0:3], p_top)
                vis_s.append(_visible(geo, lidx, so, wi, torch.sqrt(d2), r))
            for a, al in enumerate(areas):
                base = (k * n_pa + a) * 2
                wi, d2 = _towards(_area_point(al, dr.uab[base],
                                              dr.uab[base + 1]), p_top)
                vis_a.append(_visible(geo, lidx, so, wi, torch.sqrt(d2), r))
            # mesh lights: the sampled face's row (a table row per lane)
            ml_row, ml_w = [], []
            for m, ml in enumerate(mls):
                base = (k * n_pm + m) * 3
                face = int(ml[3]) + dr.uml[base].long()
                ml_row.append(ml_rows[face, 0].long())
                ml_w.append(ml_rows[face, 1])
                pt_ = _ml_point(tabs.tri_w.detach()[ml_row[m]],
                                dr.uml[base + 1], dr.uml[base + 2])
                wi, d2 = _towards(pt_, p_top)
                gate = (lit & ~skip[m]).nonzero().squeeze(1)
                vis_m.append(_visible(geo, gate, so, wi, torch.sqrt(d2), r))
            n_sh = len(vis_p) + len(vis_d) + len(vis_s) + len(vis_a)
            count("shadow_rays", lidx.numel() * n_sh + sum(
                int((lit & ~s_).sum()) for s_ in skip))

        # ---- the differentiable step ----
        matp = tabs.mat[matl]
        amb3 = [matp[:, c] for c in range(3)]
        kd3 = [matp[:, 3 + c] for c in range(3)]
        ks3 = [matp[:, 6 + c] for c in range(3)]
        mir3 = [matp[:, 9 + c] for c in range(3)]
        phong = matp[:, 12]
        rad3 = [matp[:, 13 + c] for c in range(3)]
        t = torch.zeros(r, dtype=f32, device=dev)
        nrm = [torch.where(is_tri, n_tri[:, i], 0.0 if i < 2 else 1.0)
               for i in range(3)]
        if bc.n_tri:
            v9 = tabs.tri_w[row.clamp(min=0)]
            tc = _cramer_t([v9[:, j] for j in range(9)], o3, d3, bary=bc.tex)
            if bc.tex:
                tc, beta, gamma = tc
                kd3 = _texture_kd(bc, tabs.texels, slot, row, beta, gamma, kd3,
                                  count)
            t = torch.where(is_tri, tc, 0.0)
        if n_sph:
            ts = _sphere_t(s_sel, o3, d3)
            ns = _sphere_normal(s_sel, o3, d3, torch.where(is_sph, ts, 0.0))
            t = torch.where(is_sph, ts, t)
            nrm = [torch.where(is_sph, ns[i], nrm[i]) for i in range(3)]
        t = torch.where(hit, t, 0.0)
        p = [o3[i] + t * d3[i] for i in range(3)]
        wo = [-c for c in d3]
        wb = w3
        if bc.has_dielectric and k > 0:
            wb = [w3[c] * torch.exp(-absorb[:, c] * t) for c in range(3)]
        seg = [torch.zeros(r, dtype=f32, device=dev) for _ in range(3)]
        for c in range(3):
            if k == 0:
                seg[c] = seg[c] + torch.where(miss_primary,
                                              wb[c] * tabs.bg[c], 0.0)
            if bc.has_emissive:
                seg[c] = seg[c] + torch.where(is_em, wb[c] * rad3[c] * TWO_PI,
                                              0.0)
            if has_amb:
                seg[c] = seg[c] + torch.where(lit, wb[c] * ambient[c] * amb3[c],
                                              0.0)

        def shade_unit(wi):
            cos_t = torch.clamp(_dot(wi, nrm), min=0.0)
            h = _norm3([wi[i] + wo[i] for i in range(3)])
            spec = _powmax(torch.clamp(_dot(h, nrm), min=0.0), phong)
            return [kd3[c] * cos_t + ks3[c] * spec for c in range(3)]

        def add_light(gate, intensity, e, wi):
            """The light term ((w I) e) v of a light of intensity I (3
            numbers or 0-d tensors) and irradiance factor e toward wi."""
            v = shade_unit(wi)
            for c in range(3):
                seg[c] = seg[c] + torch.where(
                    gate, wb[c] * intensity[c] * e * v[c], 0.0)

        for i, vis in enumerate(vis_p):
            tl = [pl_pos[i, c] - p[c] for c in range(3)]
            d2 = torch.clamp(_dot(tl, tl), min=1e-20)
            inv = 1.0 / torch.sqrt(d2)
            v = shade_unit([c * inv for c in tl])
            g = lit & vis
            for c in range(3):
                seg[c] = seg[c] + torch.where(
                    g, mk._div(wb[c] * tabs.pl[i, c], d2) * v[c], 0.0)
        for i, vis in enumerate(vis_d):
            v = shade_unit([dl_wi[i, c].expand(r) for c in range(3)])
            g = lit & vis
            for c in range(3):
                seg[c] = seg[c] + torch.where(g, wb[c] * tabs.dl[i, c] * v[c],
                                              0.0)
        for i, (sl, vis) in enumerate(zip(spots, vis_s)):
            wi, d2 = _towards(sl[0:3], p)
            add_light(lit & vis, tabs.sl[i], _spot_e(sl, wi, d2), wi)
        for a, (al, vis) in enumerate(zip(areas, vis_a)):
            base = (k * n_pa + a) * 2
            wi, d2 = _towards(_area_point(al, dr.uab[base], dr.uab[base + 1]),
                              p)
            e = al[10] * torch.abs(al[3] * wi[0] + al[4] * wi[1]
                                   + al[5] * wi[2]) / d2
            add_light(lit & vis, tabs.al[a], e, wi)
        for m, vis in enumerate(vis_m):
            base = (k * n_pm + m) * 3
            wi, _ = _towards(_ml_point(tabs.tri_w[ml_row[m]], dr.uml[base + 1],
                                       dr.uml[base + 2]), p)
            add_light(lit & ~skip[m] & vis, tabs.ml[m], ml_w[m] * TWO_PI, wi)
        count("lit_light_evals", int(lit.sum()) * (
            len(vis_p) + len(vis_d) + len(vis_s) + len(vis_a) + len(vis_m)))
        L = [L[c] + seg[c] for c in range(3)]
        if k == depth - 1 or not (any_spec or bc.pt):
            break
        with torch.no_grad():
            if not bool(chain.any()):
                break
        # ---- the child: mirror, conductor, the dielectric's leg or GI ----
        o2 = [torch.zeros(r, dtype=f32, device=dev) for _ in range(3)]
        d2_ = [torch.zeros(r, dtype=f32, device=dev) for _ in range(3)]
        w2 = [torch.zeros(r, dtype=f32, device=dev) for _ in range(3)]
        if any_spec:
            ndotwo = _dot(nrm, wo)
            rdir = _norm3([2.0 * nrm[i] * ndotwo - wo[i] for i in range(3)])
            f3 = [torch.zeros(r, dtype=f32, device=dev) for _ in range(3)]
            if bc.has_mirror:
                f3 = [torch.where(is_mirror, mir3[c], f3[c]) for c in range(3)]
            if bc.has_conductor:
                ratio = _conductor_ratio(mrow[:, 14], mrow[:, 15], ndotwo)
                f3 = [torch.where(is_cond, mir3[c] * ratio, f3[c])
                      for c in range(3)]
            o2 = [p[i] + nrm[i] * eps for i in range(3)]
            d2_ = rdir
            w2 = [wb[c] * f3[c] for c in range(3)]
        if bc.has_dielectric:
            nm = [nrm[i] * sgn for i in range(3)]
            cos_i = -_dot(d3, nm)
            rm = _norm3([2.0 * nm[i] * cos_i + d3[i] for i in range(3)])
            crit = ratio_n * ratio_n * (1.0 - cos_i * cos_i)
            cos_p = torch.sqrt(torch.where(
                d_refract, torch.clamp(1.0 - crit, min=1e-20), 1.0))
            tn = _norm3([(d3[i] + nm[i] * cos_i) * ratio_n - nm[i] * cos_p
                         for i in range(3)])
            o2 = [torch.where(d_reflect, p[i] + nm[i] * eps, o2[i])
                  for i in range(3)]
            o2 = [torch.where(d_refract, p[i] - nm[i] * eps, o2[i])
                  for i in range(3)]
            d2_ = [torch.where(d_reflect, rm[i], d2_[i]) for i in range(3)]
            d2_ = [torch.where(d_refract, tn[i], d2_[i]) for i in range(3)]
            w2 = [torch.where(d_reflect | d_refract, wb[c], w2[c])
                  for c in range(3)]
        if bc.pt:
            # the GI bounce (integrator.py:270-299): its direction through
            # the step's normal (a sphere's moves with the ray), weight w
            # Shade(gi) 2pi, under Russian roulette past max_depth times
            # 1/prob of the same post-Beer weight
            gd = mk._gi_direction(*nrm, r1, r2, bc.pt_importance)
            gv = shade_unit(gd)
            fac = TWO_PI
            if bc.pt_rr and k >= bc.max_depth:
                prob = torch.clamp(torch.stack(wb).amax(0), 1e-4, 1.0)
                fac = TWO_PI * (1.0 / prob)
            o2 = [torch.where(cont_gi, p[i] + nrm[i] * GI_EPS, o2[i])
                  for i in range(3)]
            d2_ = [torch.where(cont_gi, gd[i], d2_[i]) for i in range(3)]
            w2 = [torch.where(cont_gi, wb[c] * gv[c] * fac, w2[c])
                  for c in range(3)]
            if bc.pt_spec:  # the coin's child where both existed: weight x2
                w2 = [w2[c] * torch.where(both, 2.0, 1.0) for c in range(3)]
        o3 = [torch.where(chain, o2[i], 0.0) for i in range(3)]
        d3 = [torch.where(chain, d2_[i], 0.0 if i < 2 else 1.0)
              for i in range(3)]
        w3 = [torch.where(chain, w2[c], 0.0) for c in range(3)]
        active, medium, absorb = chain, next_medium, next_absorb
        cont_prev = cont_gi
    return torch.stack(L, dim=-1)


def _visible(geo, lidx, so, wi, limit, r):
    """Shadow visibility (R,) bool of rays from ``so`` along ``wi`` up to
    ``limit``, traced for the lanes ``lidx`` (false elsewhere)."""
    vis = torch.zeros(r, dtype=torch.bool, device=so[0].device)
    if lidx.numel():
        blocked = geo.shadow(*(c[lidx] for c in so), *(c[lidx] for c in wi),
                             limit[lidx])
        vis[lidx] = ~blocked
    return vis


# ---------------------------------------------------------------------------
# the kernel's wrapper and the autograd Function
# ---------------------------------------------------------------------------

LIBRARY = "mega_bwd"
# kernel launches per instantiation: K2a's and K2b's primal (forward only)
# and their K2c twins (``_tex``), K2b's and K2c's fwd+bwd, each over the
# chunks or (``_tree``) the tree; K2a's reverse kernel (``mega_bwd_rev``);
# and the refit of the boxes (``mega_bwd_refit``)
LAUNCHES = {f"mega_bwd{pr}{pt}{tex}{tree}": 0 for pr in ("_primal", "")
            for pt in ("", "_pt") for tex in ("", "_tex")
            for tree in ("", "_tree") if pr or pt or tex}
LAUNCHES.update(mega_bwd_rev=0, mega_bwd_refit=0)
# one segment record of K2a's primal, in 32-bit words (csrc/mega_bwd.cu
# Seg, REC_WORDS): origin 0:3, direction 3:6, weight 6:9, Beer constant
# 9:12, the dielectric's ratio 12; winner row 13, sphere 14, material 15,
# topology bits 16 and visibility bits 17 as the bits of int32 words
SEG_WORDS = 18
FLAG_EMISSIVE = 8
FLAG_PT, FLAG_IMPORTANCE, FLAG_NEE, FLAG_RR, FLAG_PT_SPEC = 32, 64, 128, 256, 512
# the fwd+bwd's cotangent targets, by BwdTables field, and their flags in
# csrc/mega_bwd.cu (SC_*): a target without its flag is never added to
SCATTER_FLAGS = {name: 1 << (10 + k)
                 for k, name in enumerate(BwdTables._fields)}
# the rows' sums (9 floats a work item), which each block keeps in shared
# memory before one global atomic per value up to TRI_SHARED_MAX_ROWS work
# items; past them, and for every other large target (the texel pool), the
# warp's sums go to global memory.  Measured on an H100 (PERF.md section
# 6): the rows' copy cut K2b's fwd+bwd on feat_pt.xml from 1.20 to 0.84 ms;
# a copy of the texel pool ran slower than the warp's sums at every pool
# size tried (32x32 to 128x128 texels), so the pool has none
FLAG_TRI_SHARED = 1 << 19
TRI_SHARED_MAX_ROWS = 256


def scatter_targets(scatter) -> tuple:
    """The targets ``mega_bwd_trace``'s ``scatter`` names: True every
    ``BwdTables`` field, False none, else the fields listed."""
    if scatter is True:
        return tuple(SCATTER_FLAGS)
    if scatter is False or scatter is None:
        return ()
    names = tuple(scatter)
    unknown = set(names) - set(SCATTER_FLAGS)
    if unknown:
        raise ValueError(f"scatter: unknown targets {sorted(unknown)}; "
                         f"the targets are {list(SCATTER_FLAGS)}")
    return names


def scatter_flags(bc: BwdConsts, scatter=True) -> int:
    """The flag word of the fwd+bwd's scatter: one SC_* flag per target
    (``scatter_targets``), and FLAG_TRI_SHARED where the rows' sums fit a
    block's shared memory under ``TRI_SHARED_MAX_ROWS``."""
    names = scatter_targets(scatter)
    flags = 0
    for name in names:
        flags |= SCATTER_FLAGS[name]
    if "tri_w" in names and 0 < bc.n_tri <= TRI_SHARED_MAX_ROWS:
        flags |= FLAG_TRI_SHARED
    return flags


def launch_flags(bc: BwdConsts, scatter=False) -> int:
    """The flag word of ``mega_bwd_trace``'s launch: the scene's switches
    (mirror 1, dielectric 2, conductor 4, FLAG_EMISSIVE, the path tracer's)
    and, for the fwd+bwd, ``scatter_flags(bc, scatter)`` (the primal
    passes False)."""
    return ((1 if bc.has_mirror else 0) | (2 if bc.has_dielectric else 0)
            | (4 if bc.has_conductor else 0)
            | (FLAG_EMISSIVE if bc.has_emissive else 0)
            | scatter_flags(bc, scatter)
            | (FLAG_PT if bc.pt else 0)
            | (FLAG_IMPORTANCE if bc.pt_importance else 0)
            | (FLAG_NEE if bc.pt_nee else 0) | (FLAG_RR if bc.pt_rr else 0)
            | (FLAG_PT_SPEC if bc.pt_spec else 0))


def mega_bwd_trace_ref(bc: BwdConsts, tabs: BwdTables, o, d, draws=None,
                       gbar=None, stats=None):
    """The plain version of ``mega_bwd_trace`` on any device: the radiance
    of ``diff_trace_ref``, and with ``gbar`` the cotangents by autograd (a
    ``BwdGrads``); ``stats`` as ``diff_trace_ref``'s."""
    if gbar is None:
        with torch.no_grad():
            return diff_trace_ref(bc, tabs, o, d, draws, stats)
    leaves = [t.detach().requires_grad_(True) for t in (*tabs, o, d)]
    with torch.enable_grad():
        out = diff_trace_ref(bc, BwdTables(*leaves[:-2]), leaves[-2],
                             leaves[-1], draws, stats)
        grads = torch.autograd.grad(out, leaves, gbar, allow_unused=True)
    return out.detach(), BwdGrads(*(torch.zeros_like(x) if g is None else g
                                    for g, x in zip(grads, leaves)))


def records_shape(bc: BwdConsts, n_rays: int) -> tuple:
    """The shape of K2a's records for ``n_rays`` rays, f32: per segment
    (``bc_depth``) ``SEG_WORDS`` rows of ``n_rays`` words, field-major (the
    warp's threads store and load neighbouring words), then one row of
    each ray's segment count (int32 bits).  At 640,000 rays and depth 6,
    127 rows: 325 MB."""
    return (bc_depth(bc) * SEG_WORDS + 1, n_rays)


def refit(bc: BwdConsts, tri_w: torch.Tensor):
    """The boxes of the call's vertices ``tri_w`` (max(W,1), 9): (nodes,
    chunk_tab) as ``refit_ref`` returns them.  A CPU tensor runs
    ``refit_ref``; a CUDA one launches ``csrc/mega_bwd.cu``'s refit
    kernels (``LAUNCHES["mega_bwd_refit"]``: each leaf run's box, then each
    child slot's over its span, a warp to a slot; or each chunk's, a warp
    to a chunk) or raises.  No TPU kernel had one: the JAX
    ``make_diff_render`` keeps the initial pack's boxes."""
    mc = bc.mc
    if tri_w.device.type == "cpu":
        return refit_ref(bc, tri_w)
    if mc.has_motion:
        raise ValueError("refit: the scene has motion, which K2 does not "
                         "take (bwd_missing)")
    from advanced_cpu_raytracing_tpu_torch.ops import _build

    mk._check("tri_w", tri_w, (max(mc.n_tri, 1), 9))
    f32 = torch.float32
    dev = tri_w.device
    nodes = chunk = run_box = None
    if mc.tree is not None:
        for name, t in (("tree", mc.tree), ("tree_runs", bc.tree_runs),
                        ("tree_spans", bc.tree_spans)):
            if t.device != dev:
                raise ValueError(f"refit: {name} on {t.device}, tri_w on {dev}")
        mk._check("tree_runs", bc.tree_runs, dtype=torch.int32)
        mk._check("tree_spans", bc.tree_spans,
                  (mc.tree.shape[0] * mk.TREE_WIDTH, 2), dtype=torch.int32)
        nodes = torch.empty_like(mc.tree)
        run_box = torch.empty((bc.tree_runs.shape[0], 6), dtype=f32,
                              device=dev)
    else:
        chunk = torch.empty_like(bc.chunk_tab)

    def ptr(x):
        return ctypes.c_void_p(None if x is None else x.data_ptr())

    lib = _build.load(LIBRARY)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        rc = lib.mega_bwd_refit_launch(
            mk._ptr(tri_w), mc.n_tri, mc.tree_leaf_rows, ptr(bc.tree_runs),
            0 if run_box is None else run_box.shape[0], ptr(bc.tree_spans),
            ptr(mc.tree), 0 if nodes is None else nodes.shape[0],
            ptr(run_box), ptr(nodes), ptr(chunk),
            0 if chunk is None else mc.n_chunks, stream)
    if rc != 0:
        err = lib.mega_bwd_error_string(rc).decode()
        raise RuntimeError(f"mega_bwd_refit launch failed: CUDA error {rc} "
                           f"({err})")
    LAUNCHES["mega_bwd_refit"] += 1
    return nodes, bc.chunk_tab if chunk is None else chunk


def boxes_read(bc: BwdConsts) -> bool:
    """The kernels read boxes: a tree, or more than one chunk (a scene of
    one chunk sweeps its rows in one brute loop)."""
    return bc.mc.tree is not None or bc.mc.n_chunks > 1


class _Launch:
    """One call's launches of ``csrc/mega_bwd.cu`` on the card: the rays,
    the parameter tables in the K1 layouts (vertices beside the constant
    columns, parameters beside the materials' and lights' constants), the
    draws and the boxes of the call's vertices (``boxes``, a ``refit``
    result; refit here where the kernels read boxes, when None), all
    checked once."""

    def __init__(self, bc, tabs, o, d, dr, seed, step, boxes=None):
        mc = bc.mc
        r = o.shape[0]
        n_mat, n_pl, n_dl = (bc.n_mat, mc.point_lights.shape[0],
                             mc.dir_lights.shape[0])
        n_sl, n_al, n_ml = bc.n_spot, bc.n_area, bc.n_ml
        mk._check("o", o, (r, 3))
        mk._check("d", d, (r, 3))
        mk._check("mat", tabs.mat, (n_mat, MAT_PARAM_COLS))
        for name, n in (("pl", n_pl), ("dl", n_dl), ("sl", n_sl),
                        ("al", n_al), ("ml", n_ml)):
            mk._check(name, getattr(tabs, name), (n, 3))
        mk._check("bg", tabs.bg, (3,))
        mk._check("tri_w", tabs.tri_w, (max(bc.n_tri, 1), 9))
        self.n_texels = sum(h * w for _, h, w in mc.tex_images)
        if bc.tex:
            mk._check("texels", tabs.texels, (self.n_texels, 3))
        if dr is not None:
            for name, n in draw_planes(bc).items():
                if n:
                    mk._check(f"draws.{name}", getattr(dr, name), (n, r))
        if mc.tree is not None and mc.tree_stack > mk.TREE_STACK:
            raise ValueError(f"tree stack {mc.tree_stack} > {mk.TREE_STACK}")
        depth = bc_depth(bc)
        if depth > mk.MAX_DEPTH + 1 + mk.RR_DEPTH_FLOOR:
            raise ValueError(f"depth {depth} segments > "
                             f"{mk.MAX_DEPTH + 1 + mk.RR_DEPTH_FLOOR}")
        if boxes is None:
            boxes = (refit(bc, tabs.tri_w) if boxes_read(bc)
                     else (mc.tree, bc.chunk_tab))
        nodes, chunk = boxes
        if (nodes is None) != (mc.tree is None):
            raise ValueError("boxes: a tree's nodes with a tree, None without")
        mk._check("chunk_tab", chunk, (mc.n_chunks, 8))
        if nodes is not None:
            mk._check("nodes", nodes, tuple(mc.tree.shape))
        m = mc.materials
        tri = torch.cat([tabs.tri_w, bc.tri_rest], 1).contiguous()
        mat = torch.cat([m[:, 0:1], tabs.mat[:, 0:13], m[:, 14:19],
                         tabs.mat[:, 13:16]], 1).contiguous()
        pl = torch.cat([mc.point_lights[:, 0:3], tabs.pl], 1).contiguous()
        dl = torch.cat([mc.dir_lights[:, 0:3], tabs.dl], 1).contiguous()
        tables = [tri, chunk, mc.spheres, mat, pl, dl, tabs.bg]
        ext = None
        if bc.k2b:
            sp, ar = mc.spot_lights, mc.area_lights
            ext = [torch.cat([sp[:, 0:6], tabs.sl, sp[:, 9:12]], 1).contiguous(),
                   torch.cat([ar[:, 0:6], tabs.al, ar[:, 9:17]], 1).contiguous(),
                   torch.cat([tabs.ml, mc.ml_lights[:, 3:5]], 1).contiguous(),
                   bc.ml_rows]
            tables += ext
        if nodes is not None:
            tables.append(nodes)
        if bc.tex:
            tables += [mc.tex_face, tabs.texels]
            mk._check("tex_int", mc.tex_int, dtype=torch.int32)
        for i, t in enumerate(tables):
            mk._check(f"table {i}", t)
        devs = {t.device for t in (o, d, *tables)}
        devs |= {t.device for t in (*(dr or ()),) if t is not None}
        if len(devs) != 1:
            raise ValueError(f"mega_bwd_trace: tensors on several devices {devs}")
        if any(t.data_ptr() % 16 for t in (tri, chunk, *(
                [] if nodes is None else [nodes]))):
            raise ValueError("the tri table, chunk_tab and the tree must be "
                             "16-byte aligned")
        self.bc, self.tabs, self.o, self.d, self.r = bc, tabs, o, d, r
        self.dr, self.seed, self.step, self.depth = dr, seed, step, depth
        self.boxes, self.tri, self.mat, self.pl, self.dl = boxes, tri, mat, pl, dl
        self.ext = ext

    def new_records(self) -> torch.Tensor:
        """An empty records buffer for this call (``records_shape``)."""
        return torch.empty(records_shape(self.bc, self.r), dtype=torch.float32,
                           device=self.o.device)

    def _grads(self):
        bc, f32, dev = self.bc, torch.float32, self.o.device
        mc = bc.mc
        return BwdGrads(*(torch.zeros(s, dtype=f32, device=dev) for s in (
            (bc.n_mat, MAT_PARAM_COLS), (mc.point_lights.shape[0], 3),
            (mc.dir_lights.shape[0], 3), (3,), (max(bc.n_tri, 1), 9),
            (bc.n_spot, 3), (bc.n_area, 3), (bc.n_ml, 3), (self.n_texels, 3),
            (self.r, 3), (self.r, 3))))

    def _run(self, name, out, gbar, grads, targets, rec):
        """One launch through ``mega_bwd_launch``: the primal (``gbar``
        None; ``rec`` the records to write, or None), the reverse kernel
        (K2a; ``rec`` the primal's) or the fwd+bwd."""
        from advanced_cpu_raytracing_tpu_torch.ops import _build

        bc, mc = self.bc, self.bc.mc
        lib = _build.load(LIBRARY)
        consts = (ctypes.c_float * 4)(mc.eps, *mc.ambient)
        flags = launch_flags(bc, targets if gbar is not None else False)

        def ptr(x):
            return ctypes.c_void_p(None if x is None else x.data_ptr())

        g = grads or BwdGrads(*([None] * len(BwdGrads._fields)))
        dw = self.dr or BwdDraws(None, None, None, None)
        ext, ext_p, tex_p = self.ext, None, None
        if ext is not None:
            ext_p = _build.BwdExtParams(
                ptr(ext[0]), bc.n_spot, ptr(ext[1]), bc.n_area, ptr(ext[2]),
                bc.n_ml, ptr(ext[3]), ptr(dw.uab), ptr(dw.uml), ptr(dw.ugi),
                ptr(g.sl), ptr(g.al), ptr(g.ml))
        if bc.tex:
            tex_p = _build.BwdTexParams(ptr(mc.tex_face), ptr(mc.tex_int),
                                        ptr(self.tabs.texels), ptr(g.texels))
        nodes, chunk = self.boxes
        o, r = self.o, self.r
        with torch.cuda.device(o.device):
            stream = ctypes.c_void_p(
                torch.cuda.current_stream(o.device).cuda_stream)
            rc = lib.mega_bwd_launch(
                mk._ptr(o), mk._ptr(self.d), ptr(gbar), ptr(out), r,
                mk._ptr(self.tri), bc.n_tri, mk._ptr(chunk), mc.n_chunks,
                ptr(nodes), mk._ptr(mc.spheres), mc.spheres.shape[0],
                mk._ptr(self.mat), bc.n_mat, mk._ptr(self.pl),
                mc.point_lights.shape[0], mk._ptr(self.dl),
                mc.dir_lights.shape[0], mk._ptr(self.tabs.bg), consts,
                ptr(dw.ud), self.depth, bc.max_depth, flags,
                ctypes.c_uint32(self.seed & 0xFFFFFFFF),
                ctypes.c_uint32(self.step & 0xFFFFFFFF),
                ptr(g.tri_w), ptr(g.mat), ptr(g.pl), ptr(g.dl), ptr(g.bg),
                ptr(g.o), ptr(g.d), ptr(rec),
                None if ext_p is None else ctypes.byref(ext_p),
                None if tex_p is None else ctypes.byref(tex_p), stream)
        if rc != 0:
            err = lib.mega_bwd_error_string(rc).decode()
            raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({err})")
        LAUNCHES[name] += 1

    def primal(self, rec=None) -> torch.Tensor:
        """The radiance (R,3); K2a writes its segment records to ``rec``
        when given (``records_shape``)."""
        if rec is not None:
            if not self.bc.reverse:
                raise ValueError("records: only K2a's primal writes them")
            mk._check("records", rec, records_shape(self.bc, self.r))
        out = torch.empty((self.r, 3), dtype=torch.float32,
                          device=self.o.device)
        if self.r:
            self._run(self.bc.primal_kernel, out, None, None, False, rec)
        return out

    def backward(self, gbar, targets, rec=None):
        """The cotangents (a ``BwdGrads``) of radiance cotangent ``gbar``:
        K2a's reverse kernel on the primal's records ``rec`` (raises when
        they are missing or mis-shaped), else the fwd+bwd, which also
        returns the radiance: (out or None, grads)."""
        bc = self.bc
        mk._check("gbar", gbar, (self.r, 3))
        if gbar.device != self.o.device:
            raise ValueError("gbar: on another device than the rays")
        grads = self._grads()
        if bc.reverse:
            if rec is None:
                raise ValueError("K2a's reverse kernel needs the primal's "
                                 "records")
            mk._check("records", rec, records_shape(bc, self.r))
            if rec.device != self.o.device:
                raise ValueError("records: on another device than the rays")
            if self.r:
                self._run(bc.backward_kernel, None, gbar, grads, targets, rec)
            return None, grads
        if rec is not None:
            raise ValueError("records: K2b's and K2c's fwd+bwd reads none")
        out = torch.empty((self.r, 3), dtype=torch.float32,
                          device=self.o.device)
        if self.r:
            self._run(bc.backward_kernel, out, gbar, grads, targets, None)
        return out, grads


def mega_bwd_trace(bc: BwdConsts, tabs: BwdTables, o, d, draws=None,
                   seed: int = 0, step: int = 0, gbar=None,
                   scatter: bool = True):
    """Radiance (R,3) f32 of rays o/d (R,3) f32 under the parameter tables
    ``tabs``; with ``gbar`` (R,3), the radiance's cotangent, also the
    cotangents of ``tabs``, o and d (a ``BwdGrads``).

    CPU tensors run the plain version (autograd for the cotangents); CUDA
    tensors launch K2a or K2b (``bc.k2b``), or its K2c twin (``bc.tex``),
    or raise, after the refit of the boxes where the kernels read them:
    the primal without ``gbar``; with it, for K2a the primal writing its
    records and the reverse kernel reading them, for K2b and K2c the
    fwd+bwd.  The draws come from ``draws`` (``as_draws``) when given, else
    from Philox keyed by (``seed``, ``step``) — on the CPU through
    ``bwd_draws``.
    ``scatter`` names the parameter cotangents to compute (True all,
    False none, or ``BwdTables`` fields, ``scatter_targets``); the others
    stay 0 and the kernel never adds to them.  The rays' cotangents are
    always computed.  ``LAUNCHES`` counts the launches."""
    r = o.shape[0]
    dr = as_draws(bc, draws, r)
    targets = scatter_targets(scatter)
    if o.device.type == "cpu":
        if dr is None and needs_draws(bc):
            dr = bwd_draws(bc, seed, step, r)
        res = mega_bwd_trace_ref(bc, tabs, o, d, dr, gbar)
        if gbar is None:
            return res
        out, g = res
        return out, g._replace(**{f: torch.zeros_like(getattr(g, f))
                                  for f in SCATTER_FLAGS if f not in targets})
    run = _Launch(bc, tabs, o, d, dr, seed, step)
    if gbar is None:
        return run.primal()
    if not bc.reverse:
        return run.backward(gbar, targets)
    rec = run.new_records()
    out = run.primal(rec)
    return out, run.backward(gbar, targets, rec)[1]


class _Render(torch.autograd.Function):
    """Forward: the primal instantiation (or the plain version on the
    CPU), K2a's writing its segment records where an input needs a
    gradient; backward: K2a's reverse kernel on those records, or K2b's
    and K2c's fwd+bwd, scattering only the tables that need a gradient
    (``None`` for the others).  The boxes refit in the forward and K2a's
    records are saved for the backward with the inputs, so autograd frees
    them after it unless the graph is retained.  The JAX
    ``make_diff_render``'s ``custom_vjp``."""

    @staticmethod
    def forward(ctx, bc, draws, seed, step, mat, pl, dl, bg, tri_w, sl, al, ml,
                texels, o, d):
        ctx.bc, ctx.draws, ctx.key = bc, draws, (seed, step)
        tabs = BwdTables(mat, pl, dl, bg, tri_w, sl, al, ml, texels)
        if o.device.type == "cpu":
            ctx.save_for_backward(*tabs, o, d, None, None, None)
            return mega_bwd_trace(bc, tabs, o, d, draws, seed, step)
        run = _Launch(bc, tabs, o, d, as_draws(bc, draws, o.shape[0]), seed,
                      step)
        rec = None
        if bc.reverse and any(ctx.needs_input_grad[4:]):
            rec = run.new_records()
        out = run.primal(rec)
        ctx.save_for_backward(*tabs, o, d, rec, *run.boxes)
        return out

    @staticmethod
    def backward(ctx, gbar):
        *tabs, o, d, rec, nodes, chunk = ctx.saved_tensors
        needs = ctx.needs_input_grad[4:]  # the tables', then o's and d's
        targets = [f for f, need in zip(BwdTables._fields, needs) if need]
        tabs = BwdTables(*tabs)
        if o.device.type == "cpu":
            _, g = mega_bwd_trace(ctx.bc, tabs, o, d, ctx.draws, *ctx.key,
                                  gbar=gbar.contiguous(), scatter=targets)
        else:
            run = _Launch(ctx.bc, tabs, o, d,
                          as_draws(ctx.bc, ctx.draws, o.shape[0]), *ctx.key,
                          boxes=(nodes, chunk))
            g = run.backward(gbar.contiguous(), targets, rec)[1]
        return (None, None, None, None,
                *(x if need else None for x, need in zip(g, needs)))


def texel_pool(bc: BwdConsts, atlas) -> torch.Tensor:
    """The texel pool (N, 3) of ``build_mega``'s layout from the atlas
    (I, Hmax, Wmax, 3): each pooled image's texels row by row, so that
    autograd maps the pool's cotangent back to ``atlas`` (the JAX
    ``tables``' texel table, megabwd.py:1843-1863, without its channel
    blocks and 128-lane padding); (0, 3) without textures."""
    if not bc.tex:
        return atlas.new_zeros((0, 3))
    return torch.cat([atlas[img, :h, :w].reshape(-1, 3)
                      for img, h, w in bc.mc.tex_images])


def make_diff_render(pack, opts, device=None):
    """Differentiable render of ``pack`` on ``device`` (default ``cuda``):
    returns ``f(params, o, d, draws=None, seed=0, step=0) -> (R,3)``.

    ``params`` maps any of ``mat_ambient``, ``mat_diffuse``,
    ``mat_specular``, ``mat_mirror``, ``mat_phong``, ``mat_radiance``,
    ``pl_intensity``, ``dl_radiance``, ``sl_intensity``, ``al_radiance``,
    ``ml_radiance``, ``bg_color``, ``verts`` and ``img_atlas`` to tensors;
    the others come from ``pack``.  The forward runs the primal
    instantiation of K2a, K2b or their K2c twin, ``backward`` the fwd+bwd
    one (on the CPU, the plain version both ways).  The tables are built
    from ``params`` with torch ops outside the kernel (the JAX ``tables``),
    so the vertices' cotangent reaches ``verts`` through autograd, the
    sampled mesh-light faces' included, and the texel pool's reaches
    ``img_atlas``.  ``f.bc`` is the scene's ``BwdConsts``."""
    bc = build_bwd_consts(pack, opts, device)
    dev = bc.rot.device
    n_mat = bc.n_mat
    n_pl, n_dl = bc.mc.point_lights.shape[0], bc.mc.dir_lights.shape[0]

    def tables(params) -> BwdTables:
        def g(f):
            return params.get(f, getattr(pack, f)).to(dev, torch.float32)

        mat = torch.cat([g("mat_ambient")[:n_mat], g("mat_diffuse")[:n_mat],
                         g("mat_specular")[:n_mat], g("mat_mirror")[:n_mat],
                         g("mat_phong")[:n_mat, None],
                         g("mat_radiance")[:n_mat]], 1)
        return BwdTables(mat, g("pl_intensity").reshape(-1, 3)[:n_pl],
                         g("dl_radiance").reshape(-1, 3)[:n_dl],
                         g("bg_color").reshape(3),
                         world_vertices(bc, g("verts")),
                         g("sl_intensity").reshape(-1, 3)[:bc.n_spot],
                         g("al_radiance").reshape(-1, 3)[:bc.n_area],
                         g("ml_radiance").reshape(-1, 3)[:bc.n_ml],
                         texel_pool(bc, g("img_atlas")))

    def f(params, o, d, draws=None, seed: int = 0, step: int = 0):
        tabs = [t.contiguous() for t in tables(params)]
        return _Render.apply(bc, draws, seed, step, *tabs, o.contiguous(),
                             d.contiguous())

    f.bc = bc
    f.tables = tables
    return f
