"""The multi-rank dry run: the counterpart of the JAX package's
``__graft_entry__.py::dryrun_multichip`` (its lines 102-213).

``dryrun_multichip(n_ranks, device)`` spawns ``n_ranks`` processes with
``torch.multiprocessing``, joins them into one process group (NCCL on
``cuda``, one card a rank; gloo on ``cpu``) and runs the JAX dry run's
stages on ``scene/feature_scenes.py``'s copy of its demo scene (a floor, a
mirror and a glass sphere under a point and an area light, 64x64):

  1.  the 4-spp frame through ``render_camera_sharded``;
  1b. the 1-spp frame through ``render_camera_sharded_mega`` (K1);
  2.  ``reinhard_tonemap_sharded`` of the frame of stage 1;
  3.  a ``loss_and_grads`` step through the wavefront, path traced;
  3b. a ``make_sharded_diff_step`` step (K2) at depth 2.

Each stage's shapes, dtypes and finiteness are checked as in JAX.  The
rendezvous and the process group each have a time limit of 60 s
(``parallel/mesh.py::TIMEOUT``) and the parent waits a bounded time, so a
hang fails.  The workers import only this package.

    python -c "from advanced_cpu_raytracing_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(2, 'cpu')"
"""

from __future__ import annotations

import dataclasses
import os
import queue
import socket
import tempfile
import time
import traceback

import numpy as np
import torch

from advanced_cpu_raytracing_tpu_torch.utils.logging import get_logger

RES = 64
JOIN_TIMEOUT_S = 600.0  # the parent's wait for every rank's result

_log = get_logger("acrt.dryrun")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _finite(what: str, x) -> None:
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if not np.isfinite(a).all():
        raise AssertionError(f"{what}: non-finite values")


def _stages(rank: int, n_ranks: int, dev: torch.device, mesh) -> dict:
    """The dry run's stages on this rank; returns what each one gave."""
    from advanced_cpu_raytracing_tpu_torch.diff.params import (
        extract_params,
        inject_params,
    )
    from advanced_cpu_raytracing_tpu_torch.ops.megabwd import bwd_eligible
    from advanced_cpu_raytracing_tpu_torch.parallel.shard_render import (
        loss_and_grads,
        make_sharded_diff_step,
        render_camera_sharded,
        render_camera_sharded_mega,
    )
    from advanced_cpu_raytracing_tpu_torch.post.tonemap import (
        reinhard_tonemap_sharded,
    )
    from advanced_cpu_raytracing_tpu_torch.render.camera import build_camera
    from advanced_cpu_raytracing_tpu_torch.render.integrator import RenderOptions
    from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import (
        AREA_DEMO_XML,
    )
    from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene

    with tempfile.TemporaryDirectory(prefix="acrt_dryrun_") as tmp:
        path = os.path.join(tmp, "demo.xml")
        with open(path, "w") as f:
            f.write(AREA_DEMO_XML)
        cfg = load_scene(path)
    pack = pack_scene(cfg, device=dev)
    cam = build_camera(cfg.cameras[0], device=dev)
    out = {}

    # 1. the production render, sharded
    cam_cfg = dataclasses.replace(cfg.cameras[0], num_samples=4)
    img = render_camera_sharded(pack, cfg, cam_cfg, mesh=mesh, seed=0,
                                device=dev)
    if img.shape != (RES, RES, 3) or img.dtype != np.float32:
        raise AssertionError(f"stage 1: {img.shape} {img.dtype}")
    _finite("stage 1, the sharded render", img)
    out["1"] = {"shape": list(img.shape), "mean": float(img.mean())}

    # 1b. the fused kernel K1 on every rank's shard
    cam_1spp = dataclasses.replace(cfg.cameras[0], num_samples=1)
    img_mega = render_camera_sharded_mega(pack, cfg, cam_1spp, mesh=mesh,
                                          seed=0, device=dev)
    if img_mega.shape != (RES, RES, 3):
        raise AssertionError(f"stage 1b: {img_mega.shape}")
    _finite("stage 1b, the sharded K1 render", img_mega)
    out["1b"] = {"shape": list(img_mega.shape), "mean": float(img_mega.mean())}

    # 2. the sharded tonemap
    ldr = reinhard_tonemap_sharded(img, mesh, device=dev)
    if ldr.shape != (RES, RES, 3) or ldr.dtype != np.uint8:
        raise AssertionError(f"stage 2: {ldr.shape} {ldr.dtype}")
    out["2"] = {"shape": list(ldr.shape), "mean": float(ldr.mean())}

    # 3. a differentiable step through the wavefront (the JAX dry run's
    # path-traced options, __graft_entry__.py:68-71)
    opts = RenderOptions(path_tracing=True, importance_sampling=True,
                         next_event_estimation=True, russian_roulette=False,
                         max_depth=cfg.max_recursion_depth, differentiable=True,
                         max_iters=12)
    n = 8 * n_ranks
    ys, xs = np.divmod(np.arange(n), RES)
    px, py = xs.astype(np.float32), ys.astype(np.float32)
    target = np.zeros((n, 3), np.float32)
    fields = ("mat_diffuse", "pl_intensity", "verts")
    loss, grads = loss_and_grads(
        pack, cam, px, py, 0, opts, target,
        lambda p: extract_params(p, fields), inject_params, mesh=mesh)
    _finite("stage 3, the loss", loss)
    for k, g in grads.items():
        _finite(f"stage 3, the gradient of {k}", g)
    out["3"] = {"loss": float(loss)}

    # 3b. the fused fwd+bwd kernels K2 per rank, depth 2
    w_opts = dataclasses.replace(
        opts, path_tracing=False, importance_sampling=False,
        next_event_estimation=False, max_depth=2, stochastic_dielectric=True)
    if not bwd_eligible(pack.static, w_opts, pack):
        raise AssertionError("stage 3b: the demo scene is outside K2")
    step = make_sharded_diff_step(pack, w_opts, cam, mesh=mesh, device=dev)
    floss, fgrads = step(extract_params(pack, fields), px, py, target, seed=0)
    _finite("stage 3b, the loss", floss)
    for k, g in fgrads.items():
        _finite(f"stage 3b, the gradient of {k}", g)
    out["3b"] = {"loss": float(floss)}
    return out


def _worker(rank: int, n_ranks: int, device: str, port: int, results) -> None:
    """One rank: join the group through a TCP store on ``port``, run the
    stages, put (rank, result or the traceback) on ``results``."""
    import torch.distributed as dist

    from advanced_cpu_raytracing_tpu_torch.parallel.mesh import (
        TIMEOUT,
        initialize_distributed,
        make_device_mesh,
    )

    try:
        if device == "cpu":
            torch.set_num_threads(1)
        else:
            os.environ["LOCAL_RANK"] = str(rank)
        store = dist.TCPStore("localhost", port, n_ranks, rank == 0,
                              timeout=TIMEOUT)
        initialize_distributed(device=device, store=store, rank=rank,
                               world_size=n_ranks)
        try:
            dev = torch.device(device if device == "cpu" else f"cuda:{rank}")
            mesh = make_device_mesh(n_ranks, device=device)
            res = _stages(rank, n_ranks, dev, mesh)
        finally:
            dist.destroy_process_group()
        results.put((rank, res))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, traceback.format_exc()))
        raise


def dryrun_multichip(n_ranks: int, device: str = "cuda",
                     timeout_s: float = JOIN_TIMEOUT_S) -> dict:
    """Run the dry run on ``n_ranks`` spawned ranks on ``device`` (on
    ``cuda``, one card a rank: ``n_ranks`` at most the cards there are);
    returns rank 0's stage results.  Raises when a rank fails, or when the
    ranks have not all finished within ``timeout_s`` (the ranks are then
    killed)."""
    import torch.multiprocessing as mp

    if device == "cuda":
        from advanced_cpu_raytracing_tpu_torch.parallel.mesh import backend_for

        backend_for(device)  # raises without a card or without NCCL
        if n_ranks > torch.cuda.device_count():
            raise ValueError(f"{n_ranks} ranks on {torch.cuda.device_count()} "
                             f"cards: NCCL takes one card a rank")
    elif device != "cpu":
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, n_ranks, device, port,
                                               results), daemon=True)
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout_s
    try:
        # drain the queue before joining (a full pipe blocks the writer)
        while len(got) < n_ranks:
            try:
                rank, res = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead or time.monotonic() > deadline:
                    raise TimeoutError(
                        f"dry run: ranks {sorted(set(range(n_ranks)) - set(got))}"
                        f" gave no result (exited: {dead}) within "
                        f"{timeout_s} s") from None
                continue
            got[rank] = res
            if isinstance(res, str):
                raise RuntimeError(f"dry run rank {rank} failed:\n{res}")
            _log.info("dry run rank %d of %d: %s", rank, n_ranks, res)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"dry run: ranks exited with codes {bad}")
    return got[0]

