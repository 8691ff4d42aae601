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

The kernel serves groups of ``GROUP`` consecutive lanes.  A group whose
in-range indices span at most ``window_bytes`` of the table (rounded out to
16 bytes) is served from a copy of that window in shared memory, the others
directly; ``gather_plan_ref`` is that rule on the host.
"""

from __future__ import annotations

import ctypes

import torch

from advanced_cpu_raytracing_tpu_torch.ops import _build

LIBRARY = "bigtex_gather"
# launches of the CUDA kernel (only those count)
LAUNCHES = {"bigtex_gather": 0}
# lanes a CUDA block serves (csrc/bigtex_gather.cu k4::GROUP)
GROUP = 1024
# taps whose indices a thread holds; more taps send every group direct
WINDOW_MAX_TAPS = 4
# the largest window a group is served through (K4's design table in
# PERF.md §6, tools/k4_design.py): the probe's 64-row windows (32 KB) and
# narrower; the 128 KB windows of spread 256 go direct
WINDOW_BYTES = 32 * 1024

_LIB = None
_L2_BYTES: dict = {}  # device index -> its L2 cache's bytes
# torch's current raw CUDA stream by device index, without a Stream object
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


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


def gather_plan_ref(idx, n_tab: int, window_bytes: int) -> dict:
    """The kernel's rule for each group of ``GROUP`` consecutive lanes of
    ``idx`` (taps, *lanes), on the host: ``span`` (groups,) int64, the bytes
    from the group's lowest in-range index rounded down to 16 bytes to its
    highest rounded up (0 for a group with no index in ``[0, n_tab)``);
    ``window`` (groups,) bool, served through a window (some index in
    range, ``span <= window_bytes`` and at most ``WINDOW_MAX_TAPS`` taps);
    ``counts``, the groups served through a window and directly."""
    taps = idx.shape[0]
    flat = idx.reshape(taps, -1).long()
    groups = -(-flat.shape[1] // GROUP)
    flat = torch.nn.functional.pad(flat, (0, groups * GROUP - flat.shape[1]),
                                   value=-1).reshape(taps, groups, GROUP)
    ok = (flat >= 0) & (flat < n_tab)
    lo = torch.where(ok, flat, torch.iinfo(torch.int64).max).amin(dim=(0, 2))
    hi = torch.where(ok, flat, -1).amax(dim=(0, 2))
    has = hi >= 0
    span = torch.where(has, 4 * (((hi + 4) & ~3) - (lo & ~3)), 0)
    window = has & (span <= window_bytes) & (taps <= WINDOW_MAX_TAPS)
    n_window = int(window.sum())
    return {"span": span, "window": window,
            "counts": (n_window, groups - n_window)}


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = _build.load(LIBRARY)
    return _LIB


def _check(name, x, dtype):
    if x.dtype != dtype or not x.is_cuda or not x.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous {dtype} CUDA tensor, "
                         f"got {x.dtype} on {x.device} (contiguous="
                         f"{x.is_contiguous()})")


def gather_sum(idx, tab, window_bytes: int = WINDOW_BYTES, paths=None):
    """Per-lane gather-sum of ``tab`` (read flat) at ``idx`` (taps, *lanes)
    int32, shape ``lanes``: CPU tensors run ``gather_sum_ref``, CUDA tensors
    launch K4 or raise.  ``window_bytes`` (a multiple of 16) is the widest
    span a group is served through a shared-memory window; 0 serves every
    group directly, as does a table that is not 16-byte aligned.  ``paths``,
    an int32 tensor of 2 on ``idx``'s device, gets the groups served through
    a window and directly added into it (on the CPU from
    ``gather_plan_ref``).  ``LAUNCHES`` counts the kernel's launches."""
    if idx.dim() < 1 or idx.shape[0] < 1:
        raise ValueError(f"gather_sum: idx needs a tap axis, got shape "
                         f"{tuple(idx.shape)}")
    if tab.numel() < 1:
        raise ValueError("gather_sum: an empty table")
    if window_bytes < 0 or window_bytes % 16:
        raise ValueError(f"gather_sum: window_bytes {window_bytes} is not a "
                         f"multiple of 16 >= 0")
    if paths is not None and (paths.dtype != torch.int32 or paths.shape != (2,)
                              or paths.device != idx.device):
        raise ValueError(f"gather_sum: paths needs an int32 tensor of 2 on "
                         f"{idx.device}")
    if tab.data_ptr() % 16:
        window_bytes = 0
    dev = idx.device
    if dev.type == "cpu":
        if paths is not None:
            paths += torch.tensor(
                gather_plan_ref(idx, tab.numel(), window_bytes)["counts"],
                dtype=torch.int32)
        return gather_sum_ref(idx, tab)
    _check("idx", idx, torch.int32)
    _check("tab", tab, torch.float32)
    if tab.device != dev:
        raise ValueError(f"gather_sum: idx on {dev}, tab on {tab.device}")
    out = torch.empty(idx.shape[1:], dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _lib()
    order = None
    if window_bytes and idx.shape[0] <= WINDOW_MAX_TAPS and ordered(tab):
        order = torch.empty(2 * -(-out.numel() // GROUP), dtype=torch.int32,
                            device=dev)
    args = (idx.data_ptr(), tab.data_ptr(), out.numel(), idx.shape[0],
            tab.numel(), window_bytes,
            None if order is None else order.data_ptr(), out.data_ptr(),
            None if paths is None else paths.data_ptr())
    if dev.index == torch.cuda.current_device():
        stream = (_RAW_STREAM(dev.index) if _RAW_STREAM is not None
                  else torch.cuda.current_stream(dev).cuda_stream)
        rc = lib.bigtex_gather_launch(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = lib.bigtex_gather_launch(
                *args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        err = lib.bigtex_gather_error_string(rc).decode()
        raise RuntimeError(f"bigtex_gather launch failed: CUDA error {rc} "
                           f"({err})")
    LAUNCHES["bigtex_gather"] += 1
    return out


def ordered(tab) -> bool:
    """Whether K4 takes the groups in the order of their windows (two
    small kernels before the gather): where the table is larger than the
    card's L2, since there only groups served close in time share their
    windows' rows."""
    i = tab.device.index
    if i not in _L2_BYTES:
        _L2_BYTES[i] = torch.cuda.get_device_properties(i).L2_cache_size
    return 4 * tab.numel() > _L2_BYTES[i]


def kernel_info(window_bytes: int = WINDOW_BYTES) -> dict:
    """The CUDA kernel's registers, static shared memory and resident
    blocks an SM when it is launched with ``window_bytes`` of dynamic
    shared memory (the card only)."""
    info = (ctypes.c_int * 3)()
    rc = _lib().bigtex_gather_info(window_bytes, info)
    if rc != 0:
        raise RuntimeError(f"bigtex_gather_info failed: CUDA error {rc}")
    return {"registers": info[0], "static_shared_bytes": info[1],
            "dynamic_shared_bytes": window_bytes, "blocks_per_sm": info[2]}
