#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. print the card's name and power limit; build the CUDA kernels from
     the sources in this checkout (one nvcc per source, all in parallel);
  2. hold every kernel against its plain PyTorch version on the card:
     f64 and f32, Cauchy a in {0, 1}, want_ext in {True, False}, random
     ids with ragged nobs and near-plane landmarks, and the flagship shape;
     time kernel and plain version per call at the flagship shape;
  3. drive the main path once — the flagship batched RTK-VI window solve
     at full width (nf=11, nl=352, nobs=2816, cap=11, ns=14, nb=16, B=32,
     f32, 8 dogleg iterations) through ``batched_rtk_solve`` — with the
     launch counts zeroed just before and read just after; apply the
     bench's hard gate; time a few more solves; check the CUDA solve
     against the CPU solve on a small f64 problem;
  4. print the ``kernels`` JSON line, then the card line, then the final
     ``{"ok": true, ...}`` line.

It imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

PKG = "rtk_visual_inertial_navigation_tpu_torch"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}   # non-tensor-core
# arithmetic of one valid observation in proj_segments.cu, counted from the
# source: two quaternion->matrix conversions ~40, transforms and Jacobian
# rows ~200, Gram/gradient products and their sums ~230 (per-frame and
# per-landmark blocks, no extrinsics)
PROJ_FLOPS_PER_OBS = 470
FLAGSHIP = dict(nf=11, nl=352, nobs=2816, nsamp=8, cap=11, ns=14, nb=16)
BATCH = 32


def _fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def _time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps, kernel_name):
    """Device time per call of the kernels named ``kernel_name``, from a
    torch.profiler trace (CUDA events around the calls also count the gaps
    while the host prepares each launch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel_name in e.name)
    return us / 1e3 / reps


def _rand_proj_problem(gen, B, nf, nl, nc, nobs, dtype, device,
                       near_plane_frac=0.15):
    """Random frames/landmarks/extrinsics, random ids, every 5th row
    invalid, some landmarks dragged onto the camera plane."""
    import torch
    from rtk_visual_inertial_navigation_tpu_torch.ops import lie

    def randn(*s):
        return torch.randn(s, generator=gen, dtype=torch.float64)

    def randi(n, *s):
        return torch.randint(0, n, s, generator=gen)

    off = torch.tensor([4.0, 0, 0, 0], dtype=torch.float64)
    p = randn(B, nf, 3)
    q = lie.quat_normalize(randn(B, nf, 4) + off)
    tic = 0.05 * randn(B, nc, 3)
    qic = lie.quat_normalize(randn(B, nc, 4) + off)
    lm = randn(B, nl, 3) * 3.0 + torch.tensor([0, 0, 8.0],
                                              dtype=torch.float64)
    n_bad = max(1, int(near_plane_frac * nl))
    lm[:, :n_bad, 2] = p[:, :1, 2] + 1e-4
    pbg = 0.01 * randn(3)
    f_ids, c_ids, l_ids = randi(nf, B, nobs), randi(nc, B, nobs), \
        randi(nl, B, nobs)
    xy = 0.3 * randn(B, nobs, 2)
    valid = (torch.arange(nobs) % 5 != 3).expand(B, nobs)
    fl = lambda t: t.to(dtype).to(device)
    return (fl(p), fl(q), fl(tic), fl(qic), fl(lm), fl(pbg),
            f_ids.to(device), c_ids.to(device), l_ids.to(device), fl(xy),
            valid.to(device))


def _compare(S1, c1, S0, c0, dtype, keys, label):
    """Tolerances of the JAX kernel test: atol = eps·max|ref| (scale-aware:
    summation order differs), rtol 1e-9 (f64) / 2e-3 (f32).  The cost is
    held to the same rule: in f32 a row near the camera plane carries a
    relative residual error ~eps·|X|/|z| (the kernel rotates by matrices,
    the plain version by quaternions), and such rows dominate the sum."""
    import torch
    eps = 3e-13 if dtype == torch.float64 else 2e-4
    rtol = 1e-9 if dtype == torch.float64 else 2e-3
    worst = 0.0
    for k in tuple(keys) + ("cost",):
        ref = (c0 if k == "cost" else S0[k]).double()
        got = (c1 if k == "cost" else S1[k]).double()
        atol = eps * max(ref.abs().max().item(), 1.0)
        err = (got - ref).abs()
        if k != "cost":
            worst = max(worst, err.max().item())
        if not bool((err <= atol + rtol * ref.abs()).all()):
            _fail(f"{label}: {k} differs from the plain version "
                  f"(max abs err {err.max().item():.3e}, atol {atol:.3e})")
    return worst


def phase_kernel_checks(torch, dev, card):
    from rtk_visual_inertial_navigation_tpu_torch.core.state import \
        TangentLayout
    from rtk_visual_inertial_navigation_tpu_torch.factors.visual import \
        PROJ_SQRT_INFO
    from rtk_visual_inertial_navigation_tpu_torch.ops.pallas_proj import (
        proj_segments_pallas, proj_segments_plain)

    ext_keys = ("PE", "EE", "LE", "GE")
    all_keys = ("PP", "LL", "PL", "GP", "GL") + ext_keys
    gen = torch.Generator().manual_seed(0)
    cases = 0
    for dtype in (torch.float64, torch.float32):
        for nobs in (40, 37):
            for cauchy_a in (0.0, 1.0):
                for want_ext in (True, False):
                    args = _rand_proj_problem(gen, 3, 4, 12, 2, nobs, dtype,
                                              dev)
                    lay = TangentLayout(nf=4, nl=12, nb=4, nc=2)
                    S1, c1 = proj_segments_pallas(
                        lay, *args, PROJ_SQRT_INFO, cauchy_a=cauchy_a,
                        want_ext=want_ext)
                    S0, c0 = proj_segments_plain(lay, *args, PROJ_SQRT_INFO,
                                                 cauchy_a=cauchy_a)
                    torch.cuda.synchronize()
                    keys = all_keys if want_ext else all_keys[:5]
                    _compare(S1, c1, S0, c0, dtype, keys,
                             f"random {dtype} nobs={nobs} a={cauchy_a} "
                             f"ext={want_ext}")
                    if not want_ext and any(bool(S1[k].any())
                                            for k in ext_keys):
                        _fail("want_ext=False wrote extrinsic blocks")
                    cases += 1

    # flagship shape: the state the main path starts from
    from rtk_visual_inertial_navigation_tpu_torch.parallel.problems_gnss \
        import make_synthetic_rtk_windows
    res = {}
    for dtype in (torch.float32, torch.float64):
        pr = make_synthetic_rtk_windows(1, BATCH, dtype=dtype, device=dev,
                                        **FLAGSHIP)
        lay = TangentLayout(nf=FLAGSHIP["nf"], nl=FLAGSHIP["nl"],
                            nb=FLAGSHIP["nb"], nc=2)
        w = pr.state0
        pbg = torch.zeros(3, dtype=dtype, device=dev)
        args = (w.p, w.q, w.tic, w.qic, w.landmarks, pbg, pr.f_ids,
                torch.zeros_like(pr.f_ids), pr.l_ids, pr.obs_xy,
                pr.obs_valid)
        kern = lambda: proj_segments_pallas(lay, *args, PROJ_SQRT_INFO,
                                            want_ext=False)
        plain = lambda: proj_segments_plain(lay, *args, PROJ_SQRT_INFO)
        S1, c1 = kern()
        S0, c0 = plain()
        torch.cuda.synchronize()
        err = _compare(S1, c1, S0, c0, dtype, ("PP", "LL", "PL", "GP", "GL"),
                       f"flagship {dtype}")
        cases += 1
        if dtype == torch.float32:
            ms = _time_ms(kern, 50)
            device_ms = _device_ms(kern, 20, "proj_segments")
            plain_ms = _time_ms(plain, 5)
            esz = torch.finfo(dtype).bits // 8
            B, nf, nl, nobs = BATCH, lay.nf, lay.nl, pr.f_ids.shape[1]
            nc = 2
            # inputs read once: p, lm, q, qic, tic, pbg, 3 int64 id arrays,
            # xy, bool valid; outputs written once: PP, PL, LL, GP, GL, cost
            in_bytes = B * (esz * (nf * 3 + nl * 3 + nf * 4 + nc * 4
                                   + nc * 3 + nobs * 2) + 8 * 3 * nobs
                            + nobs) + esz * 3
            out_bytes = B * esz * (nf * 36 + nf * nl * 18 + nl * 9 + nf * 6
                                   + nl * 3 + 1)
            n_valid = int(pr.obs_valid.sum().item())
            t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
            t_ops = n_valid * PROJ_FLOPS_PER_OBS / PEAK_FLOPS["float32"] \
                * 1e3
            res = dict(max_abs_err=err, ms=ms, device_ms=device_ms,
                       plain_ms=plain_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else
                       "operations", bytes=in_bytes + out_bytes,
                       valid_obs=n_valid)
    print(f"phase 2: proj_segments kernel matches its plain version in "
          f"{cases} cases; flagship B={BATCH} f32: kernel {res['ms']:.4f} "
          f"ms/call ({res['device_ms']:.4f} ms device time), plain "
          f"{res['plain_ms']:.3f} ms/call, bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']}, "
          f"{res['bytes']} bytes) on {card}", flush=True)
    return res


def phase_flagship(torch, dev, card):
    from rtk_visual_inertial_navigation_tpu_torch.core.state import \
        TangentLayout
    from rtk_visual_inertial_navigation_tpu_torch.ops.pallas_proj import \
        LAUNCHES
    from rtk_visual_inertial_navigation_tpu_torch.parallel.problems_gnss \
        import batched_rtk_solve, make_synthetic_rtk_windows
    from rtk_visual_inertial_navigation_tpu_torch.solver.gauss_newton \
        import DoglegConfig

    F = FLAGSHIP
    lay = TangentLayout(nf=F["nf"], nl=F["nl"], nb=F["nb"], nc=2)
    cfg = DoglegConfig(max_iters=8)
    t0 = time.time()
    probs = make_synthetic_rtk_windows(0, BATCH, dtype=torch.float32,
                                       device=dev, **F)
    torch.cuda.synchronize()
    t_gen = time.time() - t0

    LAUNCHES.clear()
    t0 = time.time()
    win, hid, cost, nacc, X = batched_rtk_solve(probs, lay, cfg, F["cap"],
                                                device=dev)
    torch.cuda.synchronize()
    t_first = time.time() - t0
    launches = dict(LAUNCHES)

    perr = (win.p - probs.truth.p).norm(dim=-1)
    pberr = (win.phase_bias - probs.truth.phase_bias).abs()[:, :F["ns"]]
    nacc_min = int(nacc.min().item())
    cov_ok = bool(torch.isfinite(X).all().item())
    shape_ok = (tuple(win.p.shape) == (BATCH, F["nf"], 3)
                and tuple(X.shape) == (BATCH, lay.dim, F["nb"]))
    gate = dict(nacc_min=nacc_min, max_pos_err_m=perr.max().item(),
                max_amb_err_cyc=pberr.max().item(), cov_finite=cov_ok)
    print(f"phase 3: flagship solve B={BATCH} f32: {json.dumps(gate)}; "
          f"first call {t_first:.2f} s, synthesis {t_gen:.2f} s",
          flush=True)
    fails = []
    if nacc_min == 0:
        fails.append("a window accepted no step")
    if gate["max_pos_err_m"] > 0.02:
        fails.append("max position error > 0.02 m")
    if gate["max_amb_err_cyc"] > 0.1:
        fails.append("max ambiguity error > 0.1 cycle")
    if not cov_ok:
        fails.append("covariance not finite")
    if not shape_ok:
        fails.append("unexpected output shapes")
    if fails:
        _fail("flagship gate: " + "; ".join(fails))

    reps = 3
    t0 = time.time()
    for _ in range(reps):
        out = batched_rtk_solve(probs, lay, cfg, F["cap"], device=dev)
    torch.cuda.synchronize()
    dt = time.time() - t0
    del out
    ups = BATCH * reps / dt
    print(f"phase 3: {ups:.3f} flagship updates/s ({reps} timed solves of "
          f"B={BATCH}, {dt / reps * 1e3:.1f} ms per solve) on {card}",
          flush=True)
    return launches


def phase_small_reference(torch, dev):
    """CUDA solve (kernel path) against the CPU solve (plain path) on a
    small f64 problem."""
    from rtk_visual_inertial_navigation_tpu_torch.core.state import \
        TangentLayout
    from rtk_visual_inertial_navigation_tpu_torch.parallel.problems_gnss \
        import batched_rtk_solve, make_synthetic_rtk_windows
    from rtk_visual_inertial_navigation_tpu_torch.solver.gauss_newton \
        import DoglegConfig

    sh = dict(nf=5, nl=12, nobs=40, nsamp=6, cap=4, ns=6, nb=8)
    lay = TangentLayout(nf=5, nl=12, nb=8, nc=2)
    cfg = DoglegConfig(max_iters=4)
    probs = make_synthetic_rtk_windows(7, 2, device="cpu", **sh)
    ref = batched_rtk_solve(probs, lay, cfg, sh["cap"], device="cpu")
    got = batched_rtk_solve(probs, lay, cfg, sh["cap"], device=dev)
    for name, a, b in (("p", got[0].p, ref[0].p),
                       ("phase_bias", got[0].phase_bias, ref[0].phase_bias),
                       ("X", got[4], ref[4])):
        err = (a.cpu() - b).abs().max().item()
        if not err <= 1e-8:
            _fail(f"small f64 solve: {name} on cuda differs from cpu by "
                  f"{err:.3e}")
    print("phase 3: small f64 solve on cuda matches the cpu solve "
          "(atol 1e-8)", flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / PKG / "__init__.py").is_file():
        print(f"chip_smoke: the {PKG} package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    dev = torch.device("cuda")

    card = _card_line()
    print(f"phase 1: {card}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}", flush=True)
    from rtk_visual_inertial_navigation_tpu_torch.ops import build
    t0 = time.time()
    logs = build.build(["proj_segments"], verbose=True)
    for name, log in logs.items():
        print(f"phase 1: built {name} in {time.time() - t0:.1f} s\n"
              + log.strip(), flush=True)
    from rtk_visual_inertial_navigation_tpu_torch import full_precision
    full_precision()

    kres = phase_kernel_checks(torch, dev, card)
    launches = phase_flagship(torch, dev, card)
    phase_small_reference(torch, dev)

    n = launches.get("proj_segments", 0)
    if n == 0:
        _fail("the main path never launched the proj_segments kernel")
    kernels = [dict(
        name="proj_segments", route="cuda",
        source=f"{PKG}/ops/csrc/proj_segments.cu",
        replaces="rtk_visual_inertial_navigation_tpu/ops/pallas_proj.py:108",
        launches=n, max_abs_err=kres["max_abs_err"], ms=kres["ms"],
        plain_ms=kres["plain_ms"], bound_ms=kres["bound_ms"],
        bound_by=kres["bound_by"], library_ms=None,
        device_ms=kres["device_ms"], phase="phase 2")]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
