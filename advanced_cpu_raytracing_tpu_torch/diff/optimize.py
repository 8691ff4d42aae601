"""Gradient-based scene-parameter optimization (inverse rendering): Adam
over the differentiable render toward a target image (the JAX package's
``diff/optimize.py``, with ``torch.optim.Adam`` in place of optax; both
add eps to sqrt(v-hat)).

A scene inside the fused kernels goes through ``make_diff_render`` (kernel
K2a, or K2b for path tracing and spot, area and mesh lights, each with its
K2c twin for diffuse image textures, on the card; their plain version
with ``device="cpu"``), so ``fields`` may hold ``img_atlas``.  Any other
scene (``bwd_missing`` names something: spheres, the background or
Perlin or non-diffuse textures, an environment light, motion, roughness,
BRDFs), or a camera with depth of field, takes the JAX package's fallback:
the value and gradient of ``make_loss`` through the wavefront integrator
(``render/integrator.py`` with ``differentiable=True``) by torch autograd,
with a fresh draw key each step.
"""

from __future__ import annotations

import dataclasses

import torch

from advanced_cpu_raytracing_tpu_torch.diff.params import inject_params
from advanced_cpu_raytracing_tpu_torch.ops import rng
from advanced_cpu_raytracing_tpu_torch.ops.megabwd import (
    bwd_missing,
    make_diff_render,
)
from advanced_cpu_raytracing_tpu_torch.render.camera import generate_rays
from advanced_cpu_raytracing_tpu_torch.render.integrator import trace_radiance
from advanced_cpu_raytracing_tpu_torch.utils.device import resolve_device

# Per-field Adam rates at which the training runs of the port's smoke script
# lose at every one of their 5 steps (held by tests/test_torch_diff_pt.py on
# the CPU).  Adam moves each value about its rate a step, so kd's rate sits
# below the distance of its closest channels from the truth (at 2e-2 the
# loss rises after the third step); the vertices take kd's rate / 30, as the
# JAX package's tools/inverse_render.py sets it; the light's rate is scaled
# to its size.  GAUGE_RATES: the gauge scene (gauge_scene_xml), K2a;
# FEAT_PT_RATES: scenes/feat_pt.xml, whose mesh light hangs 0.01 below the
# ceiling, K2b.
GAUGE_RATES = {"mat_diffuse": 5e-3, "pl_intensity": 400.0, "verts": 5e-3 / 30}
FEAT_PT_RATES = {"mat_diffuse": 5e-3, "ml_radiance": 0.4, "verts": 5e-3 / 30}


def make_loss(cam, px, py, opts, target):
    """The JAX ``make_loss``: ``loss(params, pack, draws)``, the mean
    squared error of the wavefront's render of ``pack`` with ``params`` in
    place, against ``target`` (R,3)."""
    def loss_fn(params, pack, draws):
        img = trace_radiance(inject_params(pack, params), cam, px, py, draws,
                             opts)
        return torch.mean((img - target) ** 2)

    return loss_fn


def wavefront_value_and_grad(pack, cam, px, py, opts, target, params,
                             draws) -> float:
    """The wavefront's ``make_loss`` with ``params`` in place; its gradient
    goes into ``params``' ``.grad``.  Returns the loss."""
    loss = make_loss(cam, px, py, opts, target)(params, pack, draws)
    loss.backward()
    return float(loss.detach())


def optimize(pack, cam, px, py, opts, target, fields, steps: int = 50,
             lr=5e-2, seed: int = 0, device=None, draws=None):
    """Returns (optimized pack, loss history).

    ``cam`` is the camera on ``device`` (default ``cuda``); ``px``, ``py``
    (R,) the pixel coordinates of the rays; ``target`` (R,3) the radiance
    to match in mean squared error; ``fields`` the pack fields to optimize;
    ``lr`` the rate of every field, or field -> rate (as the JAX package's
    tools/inverse_render.py gives the vertices a smaller step).

    Inside the fused kernels (no jitter, no lens), every step takes its
    draws (the dielectric's branch uniforms, the light samples, the GI
    directions, the Russian-roulette and coin draws) from Philox keyed by
    (``seed``, 0): the same draws each step, as in the JAX fused route,
    whose key stays ``PRNGKey(0)``; ``draws`` (a ``BwdDraws`` table,
    ``ops/megabwd.py``), when given, replaces them at every step.

    Outside them, each step's value and gradient go through the wavefront
    with ``differentiable=True`` and a fresh draw key (the JAX loop's
    ``key, sub = jax.random.split(key)``): Philox keyed by (``seed``,
    step), or ``draws[step]`` when ``draws`` is a sequence of draw sources
    (``ops/rng.py``)."""
    dev = resolve_device(device)
    params = {f: getattr(pack, f).detach().to(dev, torch.float32).clone()
              .requires_grad_(True) for f in fields}
    f32 = torch.float32
    px = torch.as_tensor(px, dtype=f32, device=dev)
    py = torch.as_tensor(py, dtype=f32, device=dev)
    target = torch.as_tensor(target, dtype=f32, device=dev)
    rates = lr if isinstance(lr, dict) else dict.fromkeys(fields, lr)
    adam = torch.optim.Adam([{"params": [v], "lr": rates[k]}
                             for k, v in params.items()])
    history = []
    if bwd_missing(pack.static, opts, pack) or getattr(cam, "use_dof", False):
        w_opts = dataclasses.replace(opts, differentiable=True)
        for step in range(steps):
            adam.zero_grad(set_to_none=True)
            step_draws = (rng.PhiloxDraws(seed, sample=step) if draws is None
                          else draws[step])
            history.append(wavefront_value_and_grad(
                pack, cam, px, py, w_opts, target, params, step_draws.to(dev)))
            adam.step()
    else:
        render = make_diff_render(pack, opts, device=dev)
        o, d = generate_rays(cam, px, py)
        for _ in range(steps):
            adam.zero_grad(set_to_none=True)
            loss = torch.mean((render(params, o, d, draws=draws, seed=seed)
                               - target) ** 2)
            loss.backward()
            adam.step()
            history.append(float(loss.detach()))
    return inject_params(pack, {k: v.detach() for k, v in params.items()}), \
        history
