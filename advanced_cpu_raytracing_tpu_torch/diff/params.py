"""Differentiable parameters over a ScenePack (the JAX package's
``diff/params.py``).

Gradients flow through intersection (t), shading and lights; which
primitive wins, and shadow visibility, contribute none — the
stop-gradient-on-topology stance: gradients are exact for shading and
light parameters and first order for geometry while visibility is
locally constant.

``extract_params`` pulls the optimizable leaves; ``inject_params`` writes
a (possibly updated) dict back into a pack; ``params_from_arrays`` turns
numpy leaves (the JAX package's ``extract_params``, as numpy) into the
port's leaf tensors, so both packages differentiate the same values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Leaves exposed to optimization, in stable order.
PARAM_FIELDS = (
    "mat_ambient", "mat_diffuse", "mat_specular", "mat_mirror",
    "mat_phong", "mat_roughness", "mat_radiance",
    "pl_intensity", "dl_radiance", "sl_intensity", "al_radiance",
    "ml_radiance", "verts", "img_atlas", "bg_color",
)


def extract_params(pack, fields=PARAM_FIELDS) -> dict:
    return {f: getattr(pack, f) for f in fields}


def inject_params(pack, params: dict):
    return dataclasses.replace(pack, **params)


def params_from_arrays(arrays: dict, device) -> dict:
    """name -> f32 leaf tensor on ``device`` that requires grad, from
    name -> numpy array (or anything ``np.asarray`` takes)."""
    return {k: torch.tensor(np.asarray(v, dtype=np.float32), device=device,
                            requires_grad=True)
            for k, v in arrays.items()}
