"""Projection linearization + Schur segment assembly: CUDA kernel and its
plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas_proj.py``, whose Pallas
kernel fused the per-observation reprojection Jacobian and the segment
sums into one TPU kernel.  Here ``proj_segments_pallas`` keeps that name
and contract (the segment dict ``S`` of ``solver.structured._proj_segments``
plus the cost) and runs:

  - on CUDA tensors: the hand-written kernel ``csrc/proj_segments.cu``
    (one thread per observation, analytic Jacobian, shared-memory and
    atomic segment sums), counted in ``LAUNCHES``;
  - on CPU tensors: ``proj_segments_plain`` — the autodiff
    ``projection_factor_batch``, then ``cauchy_correct``, then
    ``_proj_segments``.

Any other device, dtype or shape raises; a CUDA build or launch failure
raises too.
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from ..core.state import TangentLayout, WindowState
from ..factors.robust import cauchy_correct
from ..factors.visual import projection_factor_batch
from ..solver.structured import _proj_segments
from .build import load

# kernel launches per wrapper; a run resets and reads it to show which
# kernels its main path went through
LAUNCHES = collections.Counter()


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


_ARGTYPES = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 5 \
    + [ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_void_p]


def _kernel(dtype):
    lib = load("proj_segments")
    fn = lib.proj_segments_f64 if dtype == torch.float64 \
        else lib.proj_segments_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _proj_segments_cuda(lay, p, q, tic, qic, landmarks, pbg, f_ids, cam_ids,
                        l_ids, meas_xy, valid, weight, cauchy_a, want_ext):
    dtype, dev = p.dtype, p.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"proj_segments kernel takes f32/f64, not {dtype}")
    B, nf = p.shape[0], lay.nf
    nl, nc, nobs = lay.nl, lay.nc, f_ids.shape[-1]
    # kernel argument order
    expect = {"p": (p, (B, nf, 3), dtype),
              "landmarks": (landmarks, (B, nl, 3), dtype),
              "q": (q, (B, nf, 4), dtype), "qic": (qic, (B, nc, 4), dtype),
              "tic": (tic, (B, nc, 3), dtype), "pbg": (pbg, (3,), dtype),
              "f_ids": (f_ids, (B, nobs), torch.int64),
              "cam_ids": (cam_ids, (B, nobs), torch.int64),
              "l_ids": (l_ids, (B, nobs), torch.int64),
              "meas_xy": (meas_xy, (B, nobs, 2), dtype),
              "valid": (valid, (B, nobs), torch.bool)}
    ins = []
    for k, (t, shape, dt) in expect.items():
        if tuple(t.shape) != shape or t.device != dev or t.dtype != dt:
            raise ValueError(f"{k}: {tuple(t.shape)} {t.dtype} on {t.device},"
                             f" expected {shape} {dt} on {dev}")
        ins.append(t.contiguous())

    # per-window output shapes, in kernel argument order; one zero-filled
    # buffer holds them all (and the cost)
    shapes = dict(PP=(nf, 6, 6), PL=(nf, nl, 6, 3), PE=(nf, nc, 6, 6),
                  EE=(nc, 6, 6), LE=(nl, nc, 6, 3), LL=(nl, 3, 3),
                  GP=(nf, 6), GL=(nl, 3), GE=(nc, 6))
    sizes = [B * math.prod(s) for s in shapes.values()] + [B]
    parts = torch.zeros(sum(sizes), dtype=dtype, device=dev).split(sizes)
    S = {k: part.view((B,) + s)
         for (k, s), part in zip(shapes.items(), parts)}
    cost = parts[-1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel(dtype)(*[t.data_ptr() for t in ins + list(parts)], B, nf,
                        nl, nc, nobs, float(weight), float(cauchy_a),
                        int(want_ext), stream)
    if rc != 0:
        raise RuntimeError(f"proj_segments kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["proj_segments"] += 1
    return S, cost


def proj_segments_pallas(lay: TangentLayout, p, q, tic, qic, landmarks, pbg,
                         f_ids, cam_ids, l_ids, meas_xy, valid, weight,
                         cauchy_a: float = 0.0, want_ext: bool = True):
    """Segment blocks S + cost (B,) for a batch of windows.

    Returns S with PP (B,nf,6,6), LL (B,nl,3,3), EE (B,nc,6,6),
    PL (B,nf,nl,6,3), PE (B,nf,nc,6,6), LE (B,nl,nc,6,3), GP (B,nf,6),
    GL (B,nl,3), GE (B,nc,6) — Jᵀr gradient convention, Cauchy corrector
    applied when cauchy_a > 0 (cost is then the true robust cost ½Σρ(s)).
    ``want_ext=False`` leaves the extrinsic blocks (PE, EE, LE, GE) zero on
    CUDA; the plain version always computes them.
    """
    if p.device.type == "cpu":
        return proj_segments_plain(lay, p, q, tic, qic, landmarks, pbg,
                                   f_ids, cam_ids, l_ids, meas_xy, valid,
                                   weight, cauchy_a)
    if p.device.type != "cuda":
        raise ValueError(f"proj_segments runs on cuda or cpu, not "
                         f"{p.device}")
    return _proj_segments_cuda(lay, p, q, tic, qic, landmarks, pbg, f_ids,
                               cam_ids, l_ids, meas_xy, valid, weight,
                               cauchy_a, want_ext)
