"""Design measurements of the forward kernels' tree walk (K1a, K1c, K1d
over ``mc.tree``).

    python advanced_cpu_raytracing_tpu_torch/tools/tree_design.py --count \\
        [--stride 32] [--device cpu]
    python advanced_cpu_raytracing_tpu_torch/tools/tree_design.py --time \\
        [--root DIR]
    python advanced_cpu_raytracing_tpu_torch/tools/tree_design.py --twins \\
        [--root DIR] [--leaf-rows 4 16]

Run it by path, so that ``--root`` decides which package it imports.  It
runs on the card unless ``--device cpu`` asks for the CPU, and raises
without a card.

``--count``: for each design of the tree
table (leaves of 4, 8 or 16 rows; the midpoint builder or a binned SAH
builder over the leaf boxes; nodes of 4 or 8 children), the child-box and
face tests that ``ops/megakernel.py::TreeWalker`` counts on every
``stride``-th ray of one jittered sample of ``scenes/whitted_conductors.xml``
and ``scenes/feat_lights_brdf.xml``, on their first mirror bounce and on a
shadow ray from each hit to the first point (else spot, else area)
light; with the FP32
operations of those tests (38 per face, 22 per box, as ``chip_smoke.py``
counts them).

``--time`` (the card): on one jittered sample's 640,000 rays of each of
``scenes/whitted_conductors.xml``, ``feat_lights_brdf.xml`` and
``feat_textures.xml`` (through the lens where the camera has one, Philox
draws), ms per launch (CUDA events, 5 launches after one) of the flat
chunk sweep and of the tree kernel under each design, and each design's
share of rays equal to the flat sweep bit for bit
(``exact_frac_vs_first``); then the same on the
307,200 rays of the 524,288-face terrain of ``scene/synth.py``, untextured
(K1a's tree instantiation) and textured (K1d's), held to the first design
(the flat sweep is not timed there).  The designs that change the source
(nodes of 8 children; the stack in shared memory instead of local memory)
are built from a copy of ``csrc/`` edited here, under
``build/tree_design/``.  With ``--root DIR`` it imports the package of
another checkout (an earlier commit unpacked by ``git archive``) and times
that checkout's flat sweep and its tree (``FLAT_MAX_FACES`` set to 0) on
the same rays.

``--twins``: the tree twins of K1b and K2b, which no main path takes, on
one jittered sample's 640,000 rays of ``scenes/feat_pt.xml`` (12 faces) and
of that scene with the 32,768-face torus of ``whitted_conductors.xml``
(``scene/feature_scenes.py::torus_mesh``, centred in the room): ms per
launch of ``mega_pt`` over the chunks and ``mega_pt_tree``, and of K2b's
primal and fwd+bwd over the chunks and over the tree (``make_diff_render``,
Philox draws; the tree's boxes refit from the call's vertices): the chunks
with ``FLAT_MAX_FACES`` and ``FWD_FLAT_MAX_FACES`` (K2's threshold) at
``FLAT_MAX_FACES``, the tree with both at 0.  Each tree's share of rays
equal to its chunks' bit for bit, and ptxas's registers of each kernel;
for each of ``--leaf-rows`` (set as ``LEAF_ROWS``, the forward's and K2's
leaf size).

One JSON line per scene and design, the card's name and power limit on
each.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SCENES = ("whitted_conductors.xml", "feat_lights_brdf.xml",
          "feat_textures.xml")
TERRAINS = ("terrain n=513", "terrain n=513, textured")
TRI_FLOPS, SLAB_FLOPS = 38, 22  # chip_smoke.py's counts per test
# name: (leaf rows, builder, children per node, source edit or None); the
# first is the design of csrc/ and ops/megakernel.py as they are
DESIGNS = {
    "w4_l4": (4, "midpoint", 4, None),
    "w4_l8": (8, "midpoint", 4, None),
    "w4_l16": (16, "midpoint", 4, None),
    "w4_l16_sah": (16, "sah", 4, None),
    "w4_l16_shared_stack": (16, "midpoint", 4, "shared"),
    "w8_l16": (16, "midpoint", 8, "w8"),
    "w8_l8": (8, "midpoint", 8, "w8"),
    "w8_l4": (4, "midpoint", 8, "w8"),
}
# the stack as a thread's slice of one block-wide array in shared memory,
# entry k at k * THREADS + threadIdx.x (40 entries: 40 KB a block)
SHARED_STACK = """struct SharedStack {
  int2* s;
  __device__ __forceinline__ int2& operator[](int k) const {
    return s[k * THREADS + threadIdx.x];
  }
};

__device__ __forceinline__ SharedStack shared_stack() {
  __shared__ int2 s[TREE_STACK * THREADS];
  return SharedStack{s};
}

"""
# the source edits: (file, old text, new text)
EDITS = {
    "shared": [("mega_common.cuh", "  int2 stk[TREE_STACK];",
                "  SharedStack stk = shared_stack();"),
               ("mega_common.cuh", "// The tree walk (K1e).",
                SHARED_STACK + "// The tree walk (K1e)."),
               ("mega_common.cuh", "constexpr int TREE_STACK = 64;",
                "constexpr int TREE_STACK = 40;")],
    "w8": [("mega_common.cuh", "constexpr int NODE_W = 4;",
            "constexpr int NODE_W = 8;")],
}
# the stack entries of each source
STACK = {None: 64, "shared": 40, "w8": 64}


def sah_bvh(bmin, bmax, ctr, bins: int = 16):
    """A binary BVH over boxes by binned SAH (``bins`` bins of the centroid
    extent on each axis, the least sum of area x count of the two sides),
    one box per leaf; the layout of ``accel/bvh.py::FlatBVH``, nodes
    depth-first from the root."""
    from advanced_cpu_raytracing_tpu_torch.accel.bvh import FlatBVH

    bmin, bmax = np.asarray(bmin, np.float64), np.asarray(bmax, np.float64)
    ctr = np.asarray(ctr, np.float64)
    order = np.arange(len(ctr))
    nodes = []  # [min, max, left, right, first, count]

    def area(lo, hi):
        e = np.maximum(hi - lo, 0.0)
        return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]

    def build(lo, hi, depth):
        idx = order[lo:hi]
        me = len(nodes)
        nodes.append([bmin[idx].min(0), bmax[idx].max(0), -1, -1, lo, hi - lo,
                      depth])
        if hi - lo < 2:
            return me, depth
        c = ctr[idx]
        cmin, ext = c.min(0), c.max(0) - c.min(0)
        best = (math.inf, None, None)
        for axis in range(3):
            if ext[axis] <= 0.0:
                continue
            b = np.minimum(((c[:, axis] - cmin[axis]) / ext[axis]
                            * bins).astype(np.int64), bins - 1)
            cnt = np.bincount(b, minlength=bins)
            lo_b = np.full((bins, 3), np.inf)
            hi_b = np.full((bins, 3), -np.inf)
            np.minimum.at(lo_b, b, bmin[idx])
            np.maximum.at(hi_b, b, bmax[idx])
            l_lo = np.minimum.accumulate(lo_b)[:-1]
            l_hi = np.maximum.accumulate(hi_b)[:-1]
            r_lo = np.minimum.accumulate(lo_b[::-1])[::-1][1:]
            r_hi = np.maximum.accumulate(hi_b[::-1])[::-1][1:]
            n_l = np.cumsum(cnt)[:-1]
            cost = area(l_lo, l_hi) * n_l + area(r_lo, r_hi) * (len(idx) - n_l)
            cost = np.where((n_l > 0) & (n_l < len(idx)), cost, np.inf)
            k = int(np.argmin(cost))
            if cost[k] < best[0]:
                best = (cost[k], b, k)
        if best[1] is None:
            left = np.arange(len(idx)) < len(idx) // 2
        else:
            left = best[1] <= best[2]
        order[lo:hi] = np.concatenate((idx[left], idx[~left]))
        mid = lo + int(left.sum())
        l_node, dl = build(lo, mid, depth + 1)
        r_node, dr = build(mid, hi, depth + 1)
        nodes[me][2:6] = [l_node, r_node, 0, 0]
        return me, max(dl, dr)

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))
    _, depth = build(0, len(ctr), 1)
    col = list(zip(*nodes))
    return FlatBVH(node_min=np.asarray(col[0], np.float32),
                   node_max=np.asarray(col[1], np.float32),
                   node_left=np.asarray(col[2], np.int32),
                   node_right=np.asarray(col[3], np.int32),
                   node_first=np.asarray(col[4], np.int32),
                   node_count=np.asarray(col[5], np.int32),
                   order=order.astype(np.int32), max_depth=depth)


def use_design(mk, name):
    """Set the table parameters of design ``name`` on ``mk``."""
    leaf, builder, width, edit = DESIGNS[name]
    mk.LEAF_ROWS = leaf
    mk.TREE_WIDTH, mk.NODE_COLS = width, 8 * width
    mk.TREE_STACK = STACK[edit]
    mk.build_bvh = sah_bvh if builder == "sah" else BUILD_BVH


def use_sources(build, edit):
    """Point ``ops/_build.py`` at ``csrc/`` as it is (None) or at a copy
    with the edits of ``edit``."""
    build._LIBS.clear()
    if edit is None:
        build.CSRC, build.BUILD_DIR = CSRC0, BUILD0
        return
    out = ROOT / "build" / "tree_design" / edit
    shutil.rmtree(out / "csrc", ignore_errors=True)
    shutil.copytree(CSRC0, out / "csrc")
    for fname, old, new in EDITS[edit]:
        path = out / "csrc" / fname
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{fname}: {old!r} not found once")
        path.write_text(text.replace(old, new))
    build.CSRC, build.BUILD_DIR = out / "csrc", out / "kernels"


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    global BUILD_BVH, CSRC0, BUILD0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--count", action="store_true")
    mode.add_argument("--time", action="store_true")
    mode.add_argument("--twins", action="store_true")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the checkout whose package to import")
    ap.add_argument("--device", default=None)
    ap.add_argument("--stride", type=int, default=32)
    ap.add_argument("--designs", nargs="*", default=list(DESIGNS),
                    help="the designs to count or time (default: all)")
    ap.add_argument("--leaf-rows", type=int, nargs="*", default=[4, 16],
                    help="the leaf sizes of --twins")
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    from advanced_cpu_raytracing_tpu_torch.ops import _build
    from advanced_cpu_raytracing_tpu_torch.ops import megakernel as mk
    from advanced_cpu_raytracing_tpu_torch.render import renderer
    from advanced_cpu_raytracing_tpu_torch.render.camera import (
        build_camera,
        generate_rays,
    )
    from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu_torch.scene.synth import terrain_scene
    from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
    from advanced_cpu_raytracing_tpu_torch.utils.device import resolve_device

    if not Path(mk.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {mk.__file__}, not the package of "
                           f"{root}: run the tool by its path")
    BUILD_BVH, CSRC0, BUILD0 = mk.build_bvh, _build.CSRC, _build.BUILD_DIR
    new_api = hasattr(mk, "FWD_FLAT_MAX_FACES")
    dev = resolve_device(args.device)
    card = card_line() if dev.type == "cuda" else "cpu"

    def sample_rays(cfg):
        """chip_smoke.py's rays of one jittered sample of the frame."""
        cam_cfg = cfg.cameras[0]
        cam = build_camera(cam_cfg, device=dev)
        w, h = cam_cfg.width, cam_cfg.height
        idx = torch.arange(w * h, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        jit = (torch.rand((w * h, 2), generator=gen, device=dev)
               / math.isqrt(cam_cfg.num_samples))
        lens = (torch.rand((w * h, 2), generator=gen, device=dev) * 2.0 - 1.0
                if cam.use_dof else None)
        o, d = generate_rays(cam, (idx % w).float() + jit[:, 0],
                             (idx // w).float() + jit[:, 1], lens,
                             dof=cam.use_dof)
        return o.contiguous(), d.contiguous()

    def tables(path, tree: bool):
        if path in TERRAINS:
            cfg = terrain_scene(n=513, textured=path.endswith("textured"))
        else:
            cfg = load_scene(str(path))
        pack = pack_scene(cfg, device=dev)
        opts = renderer.options_for_camera(cfg, cfg.cameras[0])
        flat_max = mk.FLAT_MAX_FACES
        mk.FLAT_MAX_FACES = 0 if tree else flat_max
        try:
            return cfg, mk.build_mega(pack, opts, device=dev)
        finally:
            mk.FLAT_MAX_FACES = flat_max

    if args.count:
        for scene in SCENES[:2]:
            cfg, _ = tables(ROOT / "scenes" / scene, False)
            o, d = (t[::args.stride].contiguous() for t in sample_rays(cfg))
            rays = {}
            for name in args.designs:
                use_design(mk, name)
                _, (mc, tab, _) = tables(ROOT / "scenes" / scene, True)
                walker = mk.TreeWalker(mc, tab)
                if not rays:  # the same rays for every design
                    hit = walker.walk(o, d)
                    keep = hit["row"] >= 0
                    p = o + hit["t"][:, None] * d
                    nrm = tab[hit["row"].clamp(min=0), 9:12]
                    r = d - 2.0 * (d * nrm).sum(1, keepdim=True) * nrm
                    # the first point light, else spot light, else area light
                    light = next(t[0, 0:3] for t in (
                        mc.point_lights, mc.spot_lights, mc.area_lights)
                        if t.shape[0])
                    ls = light - p
                    dist = ls.norm(dim=1)
                    rays = {"primary": (o, d, None),
                            "bounce": ((p + 1e-3 * nrm)[keep], r[keep], None),
                            "shadow": ((p + 1e-3 * nrm)[keep],
                                       (ls / dist[:, None])[keep], dist[keep])}
                out = {"scene": scene, "design": name, "rays": o.shape[0],
                       "stride": args.stride, "nodes": mc.tree.shape[0],
                       "depth": mc.tree_depth, "stack": mc.tree_stack}
                total = 0
                for q, (qo, qd, lim) in rays.items():
                    w = walker.walk(qo.contiguous(), qd.contiguous(), limit=lim)
                    slab, tri = int(w["slab_tests"].sum()), int(w["tri_tests"].sum())
                    out[q] = {"slab_tests": slab, "tri_tests": tri}
                    total += slab + tri
                    out["flops"] = out.get("flops", 0) + slab * SLAB_FLOPS + tri * TRI_FLOPS
                out["tests"] = total
                print(json.dumps(out), flush=True)
        return 0

    def cuda_ms(fn, reps=5):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    if args.twins:
        return twins(args, mk, renderer, load_scene, pack_scene, sample_rays,
                     cuda_ms, dev, card)

    designs = ["flat", "tree"] if not new_api else ["flat", *args.designs]
    for scene in (*SCENES, *TERRAINS):
        flat = None
        for name in designs:
            if scene in TERRAINS and name == "flat":
                continue
            if name in DESIGNS:
                use_design(mk, name)
                use_sources(_build, DESIGNS[name][3])
            else:
                use_sources(_build, None)
            cfg, (mc, tab, ctab) = tables(
                scene if scene in TERRAINS else ROOT / "scenes" / scene,
                name != "flat")
            o, d = sample_rays(cfg)
            got = mk.mega_trace(mc, tab, ctab, o, d, seed=0, sample=0)
            ms = cuda_ms(lambda: mk.mega_trace(mc, tab, ctab, o, d, seed=0,
                                               sample=0))
            if flat is None:
                flat = got
            line = {"scene": scene, "design": name, "root": str(args.root),
                    "variant": mc.variant, "rays": o.shape[0], "ms": ms,
                    "exact_frac_vs_first": float((got == flat).all(dim=1)
                                                 .double().mean()),
                    "max_abs_diff": float((got - flat).abs().max()),
                    "card": card}
            if mc.tree is not None:
                line.update(nodes=mc.tree.shape[0], depth=mc.tree_depth,
                            stack=getattr(mc, "tree_stack", None))
            print(json.dumps(line), flush=True)
    use_sources(_build, None)
    return 0


def registers(names) -> dict:
    """ptxas's register count of each kernel in ``names`` from the builds of
    this process (``ops/_build.py::BUILD_LOG``)."""
    from advanced_cpu_raytracing_tpu_torch.ops import _build

    out = {}
    for log in _build.BUILD_LOG.values():
        name = None
        for ln in log["ptxas"].splitlines():
            m = re.search(r"Compiling entry function '?(\w+)", ln)
            if m:
                name = next((k for k in names if f"{k}_kernel" in m.group(1)),
                            None)
            m = re.search(r"Used (\d+) registers", ln)
            if m and name is not None:
                out[name] = int(m.group(1))
                name = None
    return out


def pt_torus_xml(out_dir: Path) -> Path:
    """``scenes/feat_pt.xml`` with the 32,768-face torus of
    ``whitted_conductors.xml`` (``torus_mesh``) centred in its room,
    diffuse white, written with its PLY to ``out_dir``."""
    from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import (
        FULL_TORUS,
        ply_bytes,
        torus_mesh,
    )

    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "torus.ply").write_bytes(ply_bytes(*torus_mesh(
        **FULL_TORUS, center=(0.0, 5.0, 0.0))))
    xml = (ROOT / "scenes" / "feat_pt.xml").read_text()
    if xml.count("</Objects>") != 1:
        raise ValueError("feat_pt.xml: no single </Objects>")
    out = out_dir / "pt_torus.xml"
    out.write_text(xml.replace("</Objects>", (
        '<Mesh id="7"><Material>1</Material>'
        '<Faces plyFile="torus.ply"/></Mesh>\n  </Objects>')))
    return out


def twins(args, mk, renderer, load_scene, pack_scene, sample_rays, cuda_ms,
          dev, card) -> int:
    """``--twins``: see the module's docstring."""
    import torch

    from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb

    scenes = {"feat_pt.xml": ROOT / "scenes" / "feat_pt.xml",
              "feat_pt.xml + torus": pt_torus_xml(
                  ROOT / "build" / "tree_design" / "scenes")}
    kernels = ("mega_pt", "mega_bwd_primal_pt", "mega_bwd_pt")
    flat_max, fwd_flat_max, leaf_rows = (mk.FLAT_MAX_FACES,
                                         mk.FWD_FLAT_MAX_FACES, mk.LEAF_ROWS)
    for label, path in scenes.items():
        cfg = load_scene(str(path))
        pack = pack_scene(cfg, device=dev)
        opts = renderer.options_for_camera(cfg, cfg.cameras[0])
        o, d = sample_rays(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(2)
        gbar = torch.randn(o.shape, generator=gen, device=dev)
        for rows in args.leaf_rows:
            mk.LEAF_ROWS = rows
            line = {"scene": label, "root": str(args.root), "leaf_rows": rows,
                    "rays": o.shape[0], "faces": pack.static.n_work_items}
            res = {}
            for geo in ("chunks", "tree"):
                mk.FLAT_MAX_FACES = mk.FWD_FLAT_MAX_FACES = (
                    0 if geo == "tree" else flat_max)
                try:
                    mc, tri, chunk = mk.build_mega(pack, opts, device=dev)
                    f = mb.make_diff_render(pack, opts, device=dev)
                finally:
                    mk.FLAT_MAX_FACES = flat_max
                    mk.FWD_FLAT_MAX_FACES = fwd_flat_max
                bc = f.bc
                tabs = mb.BwdTables(*(t.detach().contiguous()
                                      for t in f.tables({})))
                calls = {
                    mc.variant: lambda: mk.mega_trace(mc, tri, chunk, o, d,
                                                      seed=0, sample=0),
                    bc.variant.replace("mega_bwd", "mega_bwd_primal"):
                        lambda: mb.mega_bwd_trace(bc, tabs, o, d),
                    bc.variant: lambda: mb.mega_bwd_trace(bc, tabs, o, d,
                                                          gbar=gbar)[0]}
                for name, fn in calls.items():
                    res[geo, name.replace("_tree", "")] = fn()
                    line[name + "_ms"] = cuda_ms(fn)
                if geo == "tree":
                    line.update(tree_nodes=mc.tree.shape[0],
                                tree_depth=mc.tree_depth)
            for name in kernels:
                line[name + "_tree_exact_frac"] = float(
                    (res["tree", name] == res["chunks", name]).all(dim=1)
                    .double().mean())
            line.update(registers=registers(
                [k + t for k in kernels for t in ("", "_tree")]), card=card)
            print(json.dumps(line), flush=True)
    mk.LEAF_ROWS = leaf_rows
    return 0


if __name__ == "__main__":
    sys.exit(main())
