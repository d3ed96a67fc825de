"""Projection linearization + Schur segment assembly: CUDA kernel and its
plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas_proj.py``, whose Pallas
kernel fused the per-observation reprojection Jacobian and the segment
sums into one TPU kernel.  Here ``proj_segments_pallas`` keeps that name
and contract (the segment dict ``S`` of ``solver.structured._proj_segments``
plus the cost) and runs:

  - on CUDA tensors: the hand-written kernel ``csrc/proj_segments.cu``
    (each block owns a frame or a tile of landmarks and writes its outputs
    once, sums in a fixed order, no atomics into the outputs), counted in
    ``LAUNCHES``.  It takes the observations grouped by landmark and by
    frame: a ``ProjPlan`` from ``proj_plan``, built once for ids that do
    not change (a solve's nine evaluations share one) or per call when
    none is passed;
  - on CPU tensors: ``proj_segments_plain`` — the autodiff
    ``projection_factor_batch``, then ``cauchy_correct``, then
    ``_proj_segments``.

Any other device, dtype or shape raises, and so does a plan built for
other ids; a CUDA build or launch failure raises too.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ..core.state import TangentLayout, WindowState
from ..factors.robust import cauchy_correct
from ..factors.visual import projection_factor_batch
from ..solver.structured import _proj_segments
from .build import load
from .launches import LAUNCHES


def proj_segments_plain(lay: TangentLayout, p, q, tic, qic, landmarks, pbg,
                        f_ids, cam_ids, l_ids, meas_xy, valid, weight,
                        cauchy_a: float = 0.0):
    """Plain PyTorch version of the kernel (leading window dim B)."""
    B = p.shape[0]
    state = WindowState.zeros(lay.nf, lay.nl, lay.nb, lay.nc, dtype=p.dtype,
                              device=p.device, batch_shape=(B,))._replace(
        p=p, q=q, tic=tic, qic=qic, landmarks=landmarks)
    fb = projection_factor_batch(state, f_ids, cam_ids, l_ids, meas_xy,
                                 valid, pbg, weight)
    res, jac = fb.res, fb.jac
    cost = 0.5 * torch.sum(res * res, dim=(-2, -1))
    if cauchy_a > 0:
        res, jac, delta = cauchy_correct(res, jac, cauchy_a)
        cost = 0.5 * torch.sum(res * res, dim=(-2, -1)) + delta
    return _proj_segments(lay, f_ids, cam_ids, l_ids, res, jac), cost


class ProjPlan(NamedTuple):
    """Live observations (valid, every id in range) of each window sorted
    for the kernel by stable counting sorts: by landmark and, within a
    landmark, by frame (rows of one (landmark, frame) pair keep their
    original order), and by frame.  ``rows_l[b, s]`` is the s-th row of
    window b in the first order as (row, frame, camera, landmark), and
    landmark l has the rows ``s`` in ``off_l[b, l]:off_l[b, l+1]``;
    ``rows_f``, ``off_f`` likewise by frame.  ``counter`` is the kernel's
    per-window count of finished frame blocks (zero between calls), so
    calls sharing a plan run in order on one stream."""

    ids: tuple             # (f_ids, cam_ids, l_ids, valid) it was built for
    versions: tuple        # their in-place version counters then
    nf: int
    nl: int
    nc: int
    rows_l: torch.Tensor   # (B, nobs, 4) int32
    off_l: torch.Tensor    # (B, nl + 1) int32
    rows_f: torch.Tensor   # (B, nobs, 4) int32
    off_f: torch.Tensor    # (B, nf + 1) int32
    counter: torch.Tensor  # (B,) int32


def _group(key, n, step, ids):
    """Stable sort of each row of ``key`` (left-out rows hold the largest
    key, n·step): the sorted rows as (row, *ids) int32 and where keys 0,
    step, .., n·step start."""
    sorted_key, perm = torch.sort(key, dim=-1, stable=True)
    rows = torch.stack([perm] + [t.gather(1, perm) for t in ids], dim=-1)
    bounds = (torch.arange(n + 1, device=key.device) * step).expand(
        key.shape[0], n + 1).contiguous()
    return rows.to(torch.int32), torch.searchsorted(sorted_key, bounds,
                                                    out_int32=True)


def proj_plan(lay: TangentLayout, f_ids, cam_ids, l_ids, valid) -> ProjPlan:
    """Group the observations of a batch of windows for the kernel; ids
    (B, nobs) int64, ``valid`` (B, nobs) bool, on one device."""
    ids = (f_ids, cam_ids, l_ids, valid)
    shape, dev = tuple(f_ids.shape), f_ids.device
    for name, t in zip(("f_ids", "cam_ids", "l_ids", "valid"), ids):
        dt = torch.bool if name == "valid" else torch.int64
        if t.dim() != 2 or tuple(t.shape) != shape or t.dtype != dt \
                or t.device != dev:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, expected (B, nobs) {dt} like "
                             f"f_ids {shape} on {dev}")
    nf, nl, nc = lay.nf, lay.nl, lay.nc
    live = valid & (f_ids >= 0) & (f_ids < nf) & (cam_ids >= 0) \
        & (cam_ids < nc) & (l_ids >= 0) & (l_ids < nl)
    fcl = (f_ids, cam_ids, l_ids)
    rows_l, off_l = _group(torch.where(live, l_ids * nf + f_ids, nl * nf),
                           nl, nf, fcl)
    rows_f, off_f = _group(torch.where(live, f_ids, nf), nf, 1, fcl)
    return ProjPlan(ids, tuple(t._version for t in ids), nf, nl, nc, rows_l,
                    off_l, rows_f, off_f,
                    torch.zeros(shape[0], dtype=torch.int32, device=dev))


def _check_plan(plan: ProjPlan, lay: TangentLayout, ids):
    if (plan.nf, plan.nl, plan.nc) != (lay.nf, lay.nl, lay.nc) \
            or any(t is not r or t._version != v
                   for t, r, v in zip(ids, plan.ids, plan.versions)):
        raise ValueError("proj_segments: the plan was built for other ids "
                         "or another layout (or the ids changed since)")


# kernel pointer arguments, in order (csrc/proj_segments.cu)
_N_PTRS = 23
_ARGTYPES = [ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 6 \
    + [ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
# largest landmark tile of a block
MAX_TILE = 16


def _kernel(dtype, defines=()):
    lib = load("proj_segments", defines)
    fn = lib.proj_segments_f64 if dtype == torch.float64 \
        else lib.proj_segments_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _tile(device_index, nf, nc, want_ext, esz, max_tile, defines=()):
    """Landmark tile L of a block, as the kernel library picks it for this
    device and shape (cached: it queries the device)."""
    lib = load("proj_segments", defines)
    for fn in (lib.proj_segments_tile, lib.proj_segments_smem_bytes):
        fn.argtypes = [ctypes.c_int] * 5
    lib.proj_segments_tile.restype = ctypes.c_int
    lib.proj_segments_smem_bytes.restype = ctypes.c_size_t
    with torch.cuda.device(device_index):
        L = lib.proj_segments_tile(nf, nc, int(want_ext), esz, max_tile)
    if L < 0:
        raise RuntimeError("proj_segments: cannot query the device's shared "
                           "memory")
    if L == 0:
        raise ValueError(
            f"proj_segments: nf={nf} nc={nc} want_ext={want_ext} needs "
            f"{lib.proj_segments_smem_bytes(nf, nc, int(want_ext), esz, 1)}"
            f" bytes of shared memory per block, more than a block of this "
            f"device may use")
    return L


def _proj_segments_cuda(lay, p, q, tic, qic, landmarks, pbg, meas_xy, plan,
                        weight, cauchy_a, want_ext, max_tile=MAX_TILE,
                        defines=()):
    """The kernel launch; ``max_tile`` and ``defines`` (a build of the
    kernel with other preprocessor defines) serve measurements."""
    dtype, dev = p.dtype, p.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"proj_segments kernel takes f32/f64, not {dtype}")
    B, nobs = plan.ids[0].shape
    nf, nl, nc = lay.nf, lay.nl, lay.nc
    # kernel argument order
    expect = {"p": (p, (B, nf, 3)), "landmarks": (landmarks, (B, nl, 3)),
              "q": (q, (B, nf, 4)), "qic": (qic, (B, nc, 4)),
              "tic": (tic, (B, nc, 3)), "pbg": (pbg, (3,)),
              "meas_xy": (meas_xy, (B, nobs, 2))}
    ins = []
    for k, (t, shape) in expect.items():
        if tuple(t.shape) != shape or t.device != dev or t.dtype != dtype:
            raise ValueError(f"{k}: {tuple(t.shape)} {t.dtype} on {t.device},"
                             f" expected {shape} {dtype} on {dev}")
        ins.append(t.contiguous())
    if plan.counter.device != dev:
        raise ValueError(f"the plan is on {plan.counter.device}, not {dev}")
    ins += [plan.rows_l, plan.off_l, plan.rows_f, plan.off_f, plan.counter]
    esz = torch.finfo(dtype).bits // 8
    L = _tile(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        nf, nc, bool(want_ext), esz, max_tile, defines)

    # per-window output shapes, in kernel argument order, PL first (the
    # largest, at the allocation's alignment); one uninitialized buffer
    # holds them all, the cost and the kernel's scratch: the kernel writes
    # every element of the outputs
    shapes = dict(PP=(nf, 6, 6), PL=(nf, nl, 6, 3), PE=(nf, nc, 6, 6),
                  EE=(nc, 6, 6), LE=(nl, nc, 6, 3), LL=(nl, 3, 3),
                  GP=(nf, 6), GL=(nl, 3), GE=(nc, 6))
    order = ["PL"] + [k for k in shapes if k != "PL"]
    sizes = [B * math.prod(shapes[k]) for k in order] + [B] \
        + [B * nf * (1 + (27 * nc if want_ext else 0))]
    parts = dict(zip(order + ["cost", "scratch"],
                     torch.empty(sum(sizes), dtype=dtype,
                                 device=dev).split(sizes)))
    S = {k: parts[k].view((B,) + s) for k, s in shapes.items()}
    ptrs = [t.data_ptr() for t in ins] + [parts["scratch"].data_ptr()] \
        + [S[k].data_ptr() for k in shapes] + [parts["cost"].data_ptr()]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel(dtype, defines)(
        (ctypes.c_void_p * _N_PTRS)(*ptrs), B, nf, nl, nc, nobs, L,
        float(weight), float(cauchy_a), int(want_ext), stream)
    if rc != 0:
        raise RuntimeError(f"proj_segments kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["proj_segments"] += 1
    return S, parts["cost"]


def proj_segments_pallas(lay: TangentLayout, p, q, tic, qic, landmarks, pbg,
                         f_ids, cam_ids, l_ids, meas_xy, valid, weight,
                         cauchy_a: float = 0.0, want_ext: bool = True,
                         plan: ProjPlan | None = None):
    """Segment blocks S + cost (B,) for a batch of windows.

    Returns S with PP (B,nf,6,6), LL (B,nl,3,3), EE (B,nc,6,6),
    PL (B,nf,nl,6,3), PE (B,nf,nc,6,6), LE (B,nl,nc,6,3), GP (B,nf,6),
    GL (B,nl,3), GE (B,nc,6) — Jᵀr gradient convention, Cauchy corrector
    applied when cauchy_a > 0 (cost is then the true robust cost ½Σρ(s)).
    ``want_ext=False`` leaves the extrinsic blocks (PE, EE, LE, GE) zero on
    CUDA; the plain version always computes them.  ``plan``, from
    ``proj_plan`` on these very id tensors, saves grouping them per call.
    """
    ids = (f_ids, cam_ids, l_ids, valid)
    if plan is not None:
        _check_plan(plan, lay, ids)
    if p.device.type == "cpu":
        return proj_segments_plain(lay, p, q, tic, qic, landmarks, pbg,
                                   f_ids, cam_ids, l_ids, meas_xy, valid,
                                   weight, cauchy_a)
    if p.device.type != "cuda":
        raise ValueError(f"proj_segments runs on cuda or cpu, not "
                         f"{p.device}")
    if plan is None:
        plan = proj_plan(lay, *ids)
    return _proj_segments_cuda(lay, p, q, tic, qic, landmarks, pbg, meas_xy,
                               plan, weight, cauchy_a, want_ext)
