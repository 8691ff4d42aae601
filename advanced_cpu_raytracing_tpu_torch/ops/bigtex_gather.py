"""The big-texture gather probe's kernel (K4): a gather-sum by flat index.

It replaces the Pallas kernel of the repo's ``tools/probe_bigtex.py``
(``_kernel``, launched by ``run``), the design probe behind the JAX
megakernel's megapixel and HDR textures.  Per lane it adds ``taps`` entries
of a table gathered by flat index (on the TPU: row ``i >> 7``, lane
``i & 127`` of an (n_rows, 128) table), left to right in tap order.
``gather_sum`` launches ``csrc/bigtex_gather.cu`` for CUDA tensors and runs
the plain version, ``gather_sum_ref``, for CPU tensors; the two add in the
same order and agree bit for bit.  A lane with an index outside the table
(which the TPU kernel would wait on forever) is NaN in both.
"""

from __future__ import annotations

import ctypes

import torch

LIBRARY = "bigtex_gather"
# launches of the CUDA kernel (only those count)
LAUNCHES = {"bigtex_gather": 0}


def gather_sum_ref(idx, tab):
    """The plain version of K4: for ``idx`` (taps, *lanes) of flat indices
    into ``tab`` (any shape, read flat), the per-lane sum
    ``tab[idx[0]] + tab[idx[1]] + ...`` in that order, one torch op a step;
    NaN where any of a lane's indices is outside the table."""
    flat = tab.reshape(-1)
    n = flat.numel()
    bad = ((idx < 0) | (idx >= n)).any(dim=0)
    safe = idx.clamp(0, max(n - 1, 0)).long()
    acc = flat[safe[0]]
    for k in range(1, idx.shape[0]):
        acc = acc + flat[safe[k]]
    return torch.where(bad, torch.nan, acc)


def gather_sum(idx, tab):
    """Per-lane gather-sum of ``tab`` (read flat) at ``idx`` (taps, *lanes)
    int32, shape ``lanes``: CPU tensors run ``gather_sum_ref``, CUDA tensors
    launch K4 or raise.  ``LAUNCHES`` counts the kernel's launches."""
    if idx.dim() < 1 or idx.shape[0] < 1:
        raise ValueError(f"gather_sum: idx needs a tap axis, got shape "
                         f"{tuple(idx.shape)}")
    if tab.numel() < 1:
        raise ValueError("gather_sum: an empty table")
    if idx.device.type == "cpu":
        return gather_sum_ref(idx, tab)
    from advanced_cpu_raytracing_tpu_torch.ops import _build
    from advanced_cpu_raytracing_tpu_torch.ops.megakernel import _check, _ptr

    _check("idx", idx, dtype=torch.int32)
    _check("tab", tab)
    if idx.device != tab.device:
        raise ValueError(f"gather_sum: idx on {idx.device}, tab on "
                         f"{tab.device}")
    taps, lanes = idx.shape[0], idx.shape[1:]
    out = torch.empty(lanes, dtype=torch.float32, device=idx.device)
    if out.numel() == 0:
        return out
    lib = _build.load(LIBRARY)
    with torch.cuda.device(idx.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(idx.device).cuda_stream)
        rc = lib.bigtex_gather_launch(_ptr(idx), _ptr(tab), out.numel(), taps,
                                      tab.numel(), _ptr(out), stream)
    if rc != 0:
        err = lib.bigtex_gather_error_string(rc).decode()
        raise RuntimeError(f"bigtex_gather launch failed: CUDA error {rc} "
                           f"({err})")
    LAUNCHES["bigtex_gather"] += 1
    return out
