"""The inverse-rendering job of ``tools/inverse_render.py`` (and of
``diff/optimize.py``'s fused route): Adam over the closure of
``ops/megabwd.py::make_diff_render`` toward targets that the same render
makes at the true parameters.

The traffic file gives the fields, their Adam rates and starts, the grids
(``grids`` fixed jitters of the whole pixel grid: one offset a grid, or
one a pixel), whether the fields move in the tool's normalized form (u =
p / max|p_true|), the residual's divisor, and the job's length in steps.
A step is one update a grid.  Each step's loss goes to the host as the
step ends, by a copy that does not wait, and is read there once the step
is ``READ_LAG_S`` old, so the host does not drain the card at every step
but runs ahead as far as the card's queue lets it; the window's last
losses are read before it closes.
Set-up builds the one closure, parameters and optimizer, and drives them
through the job's first step; the window goes on with the same objects,
job after job, each job from the same start.

The check: two jobs' first three updates, the first job's (in set-up) and
those of the last job that started in the window and got through three
updates.  The reference runs the job's first three updates from the scene
file once, since every job starts alike, and each of the two is compared
with it: each update's loss, each field's first gradient as Adam got it
(its first moment over 1 - beta1) and each field's change after the three
updates, by norms.

The differentiable chain (``reference/diffchain.py``) works on
``whitted``'s tables, so a configuration that names another reference is
refused here.
"""

from __future__ import annotations

import gc
import time
from collections import deque

import numpy as np
import torch

from benchmark.harness import Run, median
from benchmark.reference import diffchain
from benchmark.reference import scene as ref_scene
from benchmark.reference import whitted

CHECKED_UPDATES = 3
READ_LAG_S = 4.0  # a step's loss is read on the host once it is this old
COUNT_STRIDE = 16
ZERO_GRAD = 1e-3  # a field whose reference gradient is below this share
# of the median field's is left out of the change's comparison


def _ref_scene(run: Run):
    name = run.config.get("reference", "whitted")
    if name != "whitted":
        raise ValueError(
            f"the training runner's reference chain works on whitted's "
            f"tables; this configuration names the reference {name!r}")
    sc = ref_scene.load(run.scene_path())
    w = run.overrides.get("width", run.config["width"])
    h = run.overrides.get("height", run.config["height"])
    sc.camera.width, sc.camera.height = w, h
    return sc


def draw_seed(run: Run) -> int:
    return int(run.seed) & 0x7FFFFFFF


def inputs(run: Run, sc) -> dict:
    """What the benchmark makes from the seed and hands to both sides: the
    grids' rays, the true fields (read from the scene file) and the
    start."""
    tr = run.traffic
    dev = run.device
    w, h = sc.camera.width, sc.camera.height
    rng = np.random.default_rng([run.seed, 3])
    g = torch.Generator(device=dev)
    g.manual_seed(int(run.seed))
    idx = torch.arange(w * h, device=dev)
    rays = []
    for _ in range(tr["grids"]):
        if tr["jitter"] == "grid":
            j = torch.as_tensor(rng.uniform(0, 1, 2).astype(np.float32),
                                device=dev).expand(w * h, 2)
        else:
            j = torch.rand((w * h, 2), generator=g, device=dev)
        px = (idx % w).to(torch.float32) + j[:, 0]
        py = (idx // w).to(torch.float32) + j[:, 1]
        rays.append(whitted.camera_rays(sc, px, py))
    true = {"mat_diffuse": sc.mat_diffuse, "pl_intensity": sc.pl_intensity,
            "verts": sc.verts}
    true = {k: torch.as_tensor(true[k], device=dev) for k in tr["fields"]}
    start = {}
    for k, v in true.items():
        s = tr["start"][k]
        if k == "verts":
            noise = rng.normal(0.0, s, tuple(v.shape)).astype(np.float32)
            start[k] = v + torch.as_tensor(noise, device=dev)
        else:
            f = rng.uniform(s[0], s[1], tuple(v.shape)).astype(np.float32)
            start[k] = v * torch.as_tensor(f, device=dev)
    return {"rays": rays, "true": true, "start": start}


def _scales(run: Run, true: dict) -> dict:
    if not run.traffic["normalized"]:
        return {}
    return {k: torch.clamp(v.abs().max(), min=1e-3) for k, v in true.items()}


def loss_of(img, target, norm: float):
    return torch.mean(((img - target) / norm) ** 2)


def _send(total):
    """A step's loss on its way to the host: on a card a copy into pinned
    memory that does not wait, and the event that marks its arrival."""
    if total.device.type != "cuda":
        return total, None
    host = torch.empty((), dtype=total.dtype, pin_memory=True)
    host.copy_(total, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def _read(sent) -> float:
    host, ev = sent
    if ev is not None:
        ev.synchronize()
    return float(host)


def setup(run: Run) -> dict:
    from advanced_cpu_raytracing_tpu_torch.ops.megabwd import make_diff_render
    from advanced_cpu_raytracing_tpu_torch.render.renderer import (
        options_for_camera,
    )
    from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene

    tr = run.traffic
    dev = torch.device(run.device)
    sc = _ref_scene(run)
    with run.spans("tables"):
        cfg = load_scene(str(run.scene_path()))
        cam = cfg.cameras[0]
        cam.width, cam.height = sc.camera.width, sc.camera.height
        pack = pack_scene(cfg, device=dev)
        render = make_diff_render(pack, options_for_camera(cfg, cam),
                                  device=dev)
    inp = inputs(run, sc)
    for k, v in inp["true"].items():  # the fields' rows are the file's
        if not torch.equal(getattr(pack, k).to(dev, torch.float32), v):
            raise RuntimeError(f"the program's {k} is not the scene file's")
    seed = draw_seed(run)
    with run.spans("targets"):
        with torch.no_grad():
            targets = [render(inp["true"], o, d, seed=seed)
                       for o, d in inp["rays"]]
    scales = _scales(run, inp["true"])
    u0 = {k: (v / scales[k] if k in scales else v).detach().clone()
          for k, v in inp["start"].items()}
    u = {k: v.clone().requires_grad_(True) for k, v in u0.items()}
    adam = torch.optim.Adam([{"params": [u[k]], "lr": tr["rates"][k]}
                             for k in tr["fields"]])
    norm = float(tr["norm"])

    def update(gi: int):
        o, d = inp["rays"][gi]
        adam.zero_grad(set_to_none=True)
        p = {k: (v * scales[k] if k in scales else v) for k, v in u.items()}
        loss = loss_of(render(p, o, d, seed=seed), targets[gi], norm)
        loss.backward()
        adam.step()
        return loss.detach()

    st = {"update": update, "u": u, "u0": u0, "adam": adam,
          "grids": len(targets), "render": render, "targets": targets,
          "inp": inp, "job": [], "window_job": None}
    # the job's first step, its first three updates checked
    with run.spans("first_step"):
        n_first = max(CHECKED_UPDATES, st["grids"])
        total = None
        for i in range(n_first):
            loss = _checked_update(st, i % st["grids"])
            total = loss if total is None else total + loss
            if (i + 1) % st["grids"] == 0:
                _read(_send(total))
                total = None
    st["step"] = n_first // st["grids"]
    st["setup_job"] = st["job"]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return st


def _checked_update(st: dict, gi: int):
    """One update; while the job is in its first three, keep on the device
    what the check reads of it: the loss, after the first Adam's first
    moment over 1 - beta1 (an optimizer that kept no state got no
    gradient), after the third each field's change."""
    loss = st["update"](gi)
    job = st["job"]
    if len(job) < CHECKED_UPDATES:
        adam = st["adam"]
        rec = {"loss": loss}
        if not job:
            beta1 = adam.param_groups[0]["betas"][0]
            rec["first"] = {k: (adam.state[v]["exp_avg"] / (1.0 - beta1))
                            .norm() if "exp_avg" in adam.state[v] else None
                            for k, v in st["u"].items()}
        if len(job) == CHECKED_UPDATES - 1:
            rec["change"] = {k: (v.detach() - st["u0"][k]).norm()
                             for k, v in st["u"].items()}
        job.append(rec)
    return loss


def _read_job(job: list) -> dict:
    def num(x):
        return 0.0 if x is None else float(x)

    return {"losses": [num(r["loss"]) for r in job],
            "first": {k: num(v) for k, v in job[0]["first"].items()},
            "change": {k: num(v) for k, v in job[-1]["change"].items()}}


def _reset(st: dict):
    with torch.no_grad():
        for k, v in st["u"].items():
            v.copy_(st["u0"][k])
    st["adam"].state.clear()
    st["step"] = 0
    st["job"] = []


def window(run: Run, st: dict) -> dict:
    steps_per_job = run.overrides.get("steps_per_job",
                                      run.traffic["steps_per_job"])
    n_grid = st["grids"]
    updates = 0
    sent = deque()  # (sent at, loss on its way) of the steps not read yet
    t0 = time.perf_counter()
    end = t0 + run.seconds
    while True:
        if st["step"] >= steps_per_job:
            _reset(st)
        total = None
        for gi in range(n_grid):
            with run.spans("update"):
                loss = _checked_update(st, gi)
            total = loss if total is None else total + loss
        sent.append((time.perf_counter(), _send(total)))
        with run.spans("loss_read"):
            while sent and time.perf_counter() - sent[0][0] >= READ_LAG_S:
                _read(sent.popleft()[1])
        updates += n_grid
        st["step"] += 1
        if len(st["job"]) == CHECKED_UPDATES and \
                st["job"] is not st["setup_job"]:
            st["window_job"] = st["job"]
        # a job that started goes on through its checked updates
        if time.perf_counter() >= end and \
                len(st["job"]) in (0, CHECKED_UPDATES):
            break
    with run.spans("loss_read"):
        for _, x in sent:
            _read(x)
    rays = st["inp"]["rays"][0][0].shape[0]
    return {"units": updates, "unit": "update", "rays": updates * rays}


def answers(run: Run, st: dict, work: dict) -> dict:
    """The two jobs' checked updates: set-up's and the window's last job
    that got through three (none if no job started in the window)."""
    win = st["window_job"]
    out = {"jobs": [_read_job(st["setup_job"])]
           + ([_read_job(win)] if win else []),
           "window_job": win is not None}
    st.clear()
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    return out


def reference_answers(run: Run, ans: dict, dtype=torch.float32) -> dict:
    """The reference's job from the same inputs, in ``dtype``: its first
    three updates."""
    tr = run.traffic
    sc = _ref_scene(run)
    tb = whitted.tables(sc, run.device, dtype)
    inp = inputs(run, sc)
    scales = _scales(run, inp["true"])
    job = diffchain.Job(tb, inp["true"], inp["start"], tr["rates"], scales,
                        float(tr["norm"]), draw_seed(run))
    u0 = {k: v.detach().clone() for k, v in job.u.items()}
    n_grid = len(inp["rays"])
    targets = {}
    losses, first = [], {}
    for i in range(CHECKED_UPDATES):
        gi = i % n_grid
        if gi not in targets:
            targets[gi] = job.target(*inp["rays"][gi])
        loss, grads = job.update(*inp["rays"][gi], targets[gi])
        losses.append(loss)
        if i == 0:
            first = {k: float(g.float().norm()) for k, g in grads.items()}
    change = {k: float((v.detach() - u0[k]).float().norm())
              for k, v in job.u.items()}
    return {"jobs": [{"losses": losses, "first": first, "change": change}],
            "window_job": True}


def _leaf_gap(prog: dict, ref: dict, keep) -> float:
    med = median(list(ref.values()))
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in ref if keep(k)]
    return float(max(gaps)) if gaps else 0.0


def _compare_job(prog: dict, ref: dict) -> dict:
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["losses"], ref["losses"]))
    if not all(np.isfinite(prog["losses"])):
        loss = float("inf")
    med_g = median(list(ref["first"].values()))
    return {"loss_rel_gap": float(loss),
            "grad_norm_gap": _leaf_gap(prog["first"], ref["first"],
                                       lambda k: True),
            "change_norm_gap": _leaf_gap(
                prog["change"], ref["change"],
                lambda k: ref["first"][k] >= ZERO_GRAD * med_g)}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers judged, each the worse of the two jobs': the largest
    relative gap of an update's loss, and by the worst field the gap of
    the first gradient's norm and of the change's norm after the three
    updates, each over the reference's norm of that field or of the median
    field, whichever is larger; fields whose reference gradient is below
    ZERO_GRAD of the median field's are left out of the change.  With no
    job of the window checked, every number is infinite."""
    r = ref["jobs"][0]
    per = [_compare_job(p, r) for p in prog["jobs"]]
    if not prog["window_job"]:
        per.append({k: float("inf") for k in per[0]})
    return {k: max(p[k] for p in per) for k in per[0]}


def checked(prog: dict) -> int:
    return CHECKED_UPDATES * len(prog["jobs"])


def counts(run: Run, ans: dict) -> dict:
    """The reference's closest-hit and shadow queries of one update's
    forward chain at the start, counted on every ``COUNT_STRIDE``th ray of
    grid 0 and scaled to the grid."""
    sc = _ref_scene(run)
    tb = whitted.tables(sc, run.device)
    inp = inputs(run, sc)
    o, d = inp["rays"][0]
    o, d = o[::COUNT_STRIDE].contiguous(), d[::COUNT_STRIDE].contiguous()
    ud = diffchain.branch_uniforms(draw_seed(run), 0, inp["rays"][0][0]
                                   .shape[0], sc.max_depth + 1,
                                   device=run.device)[:, ::COUNT_STRIDE]
    with torch.no_grad():
        diffchain.render(tb, inp["start"], o, d, ud)
    n = inp["rays"][0][0].shape[0]
    return {"queries": (tb.counts.closest + tb.counts.shadow) * n
            / o.shape[0], "rays": n,
            "verts": sc.verts.shape[0] if "verts" in run.traffic["fields"]
            else 0}
