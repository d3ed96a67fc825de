#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. print the card's name and power limit; build the CUDA kernels from
     the sources in this checkout (one nvcc per source, all in parallel);
  2. hold the projection kernel against its plain PyTorch version on the
     card: f64 and f32, Cauchy a in {0, 1}, want_ext in {True, False},
     random ids with ragged nobs and near-plane landmarks, and the flagship
     shape, where 100 calls must also be bitwise equal, with the frames
     no row observes exactly zero; time kernel (with
     the solve's observation plan and without), plan build and plain
     version per call at the flagship shape, and the device time against
     the largest landmark tile (information);
  3. drive the main path once — the flagship batched RTK-VI window solve
     at full width (nf=11, nl=352, nobs=2816, cap=11, ns=14, nb=16, B=32,
     f32, 8 dogleg iterations) through ``batched_rtk_solve`` — with the
     launch counts zeroed just before and read just after (the projection
     kernel, and the Cholesky factor and solve kernels of the f32 step and
     covariance); apply the bench's hard gate; time a few more solves of
     the same problem and report whether their positions are bitwise equal
     to the first (information); check the CUDA solve against the CPU
     solve on a small f64 problem;
  4. the batched Cholesky kernels (``chol_factor_lanes``,
     ``chol_solve_factored``) at the shapes the solves give them — the VI
     step (B=256, n=120) and the flagship step and covariance (B=32,
     n=339; 1 and 16 right-hand sides) — and at B=300 n=37, B=3 n=400 and
     a non-SPD input, held against their plain versions; kernel, plain
     version and ``torch.linalg.cholesky_ex`` / ``cholesky_solve`` timed,
     bounds computed, and the factor's cluster size swept at the flagship
     shape (information);
  5. the VI sub-bench (``bench.py --vi``) at full width through
     ``batched_vi_solve`` (nf=8, nl=64, nobs=448, 16 IMU samples, B=256,
     f32, 8 dogleg iterations, landmark Schur, 120 kept reduced slots),
     counts zeroed and read around it (the Cholesky kernels must have
     run); its gate (each window held to the same window solved on the
     host CPU), updates/s over 3 solves, the latency of one B=1 solve
     (``bench.py --latency``), and a CUDA vs CPU check on a small f64
     problem;
  6. print the ``kernels`` JSON line, then the card line, then the final
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
# bench.py --vi: shape, batch and solver configuration (bench.py:270-287)
VI = dict(nf=8, nl=64, nobs=448, n_samples=16)
VI_BATCH = 256
# a window's f32 frame-1+ error on the card may differ from the CPU solve's
# by this much (the tolerance of tests/test_torch_vi_f32.py against JAX)
VI_ERR_TOL_M = 5e-3
# the reduced blocks the f32 step factors: the VI solve's 15·nf kept slots
# and the flagship's Dr = 339 (TangentLayout(11, 352, 16, 2): D = 1395,
# 3·352 of it landmarks); the flagship covariance solves nb = 16 columns
CHOL_SHAPES = {"vi": (VI_BATCH, 15 * VI["nf"]), "flagship": (BATCH, 339)}
COV_COLS = FLAGSHIP["nb"]
CHOL_KERNELS = ("chol_lanes", "chol_lanes_solve")
# projection kernel calls at the flagship shape that must be bitwise equal
REPEATS = 100


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
    while the host prepares each launch).  A trace that lost launches is no
    measurement: it is taken again, and after three such traces the time is
    None ("not measured")."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and kernel_name in e.name]
        if len(ev) == reps:
            return sum(e.device_time for e in ev) / 1e3 / reps
    return None


def _ms(x):
    """A time for a message: 4 decimals, or "not measured"."""
    return "not measured" if x is None else f"{x:.4f}"


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
    from rtk_visual_inertial_navigation_tpu_torch.ops.pallas_proj import (
        _proj_segments_cuda, proj_plan)
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
        cam_ids = torch.zeros_like(pr.f_ids)
        ids = (pr.f_ids, cam_ids, pr.l_ids, pr.obs_valid)
        args = (w.p, w.q, w.tic, w.qic, w.landmarks, pbg, pr.f_ids,
                cam_ids, pr.l_ids, pr.obs_xy, pr.obs_valid)
        # as the solve calls it: the plan built once, passed to every call
        plan = proj_plan(lay, *ids)
        kern = lambda: proj_segments_pallas(lay, *args, PROJ_SQRT_INFO,
                                            want_ext=False, plan=plan)
        plain = lambda: proj_segments_plain(lay, *args, PROJ_SQRT_INFO)
        S1, c1 = kern()
        S0, c0 = plain()
        torch.cuda.synchronize()
        err = _compare(S1, c1, S0, c0, dtype, ("PP", "LL", "PL", "GP", "GL"),
                       f"flagship {dtype}")
        # repeated calls bitwise equal, each into memory left full of NaN
        # (an output element the kernel failed to write would show), and
        # the frames no live row observes exactly zero in every call (a
        # block that reads shared memory another warp has not yet written
        # shows only in an occasional call)
        nrows = torch.zeros((BATCH, FLAGSHIP["nf"]), dtype=torch.int64,
                            device=dev)
        nrows.scatter_add_(1, pr.f_ids.long(), pr.obs_valid.long())
        empty = nrows == 0
        for _ in range(REPEATS - 1):
            torch.full((1 << 24,), float("nan"), dtype=dtype, device=dev)
            S2, c2 = kern()
            if not (torch.equal(c1, c2)
                    and all(torch.equal(S1[k], S2[k]) for k in S1)):
                _fail(f"flagship {dtype}: two kernel calls differ")
            if bool(S2["PP"][empty].any()) or bool(S2["GP"][empty].any()):
                _fail(f"flagship {dtype}: a frame without rows is not zero")
        cases += 1
        if dtype == torch.float32:
            ms = _time_ms(kern, 50)
            device_ms = _device_ms(kern, 20, "proj_segments")
            noplan_ms = _time_ms(lambda: proj_segments_pallas(
                lay, *args, PROJ_SQRT_INFO, want_ext=False), 50)
            plan_ms = _time_ms(lambda: proj_plan(lay, *ids), 20)
            plain_ms = _time_ms(plain, 5)
            # information: the landmark tile L against device time
            tiles = {}
            for max_tile in (8, 16, 32, 64):
                fn = lambda: _proj_segments_cuda(
                    lay, w.p, w.q, w.tic, w.qic, w.landmarks, pbg,
                    pr.obs_xy, plan, PROJ_SQRT_INFO, 0.0, False, max_tile)
                St, _ = fn()
                if not torch.equal(St["PL"], S1["PL"]) and max_tile != 32:
                    d = (St["PL"] - S1["PL"]).abs().max().item()
                    print(f"phase 2: tile {max_tile}: PL differs from tile "
                          f"32 by {d:.3e}", flush=True)
                tiles[max_tile] = _device_ms(fn, 20, "proj_segments")
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
                       noplan_ms=noplan_ms, plan_ms=plan_ms,
                       plain_ms=plain_ms, tile_device_ms=tiles,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else
                       "operations", bytes=in_bytes + out_bytes,
                       valid_obs=n_valid)
            res["share_of_bound"] = (res["bound_ms"] / device_ms
                                     if device_ms else None)
    print(f"phase 2: proj_segments kernel matches its plain version in "
          f"{cases} cases, {REPEATS} flagship calls bitwise equal and "
          f"frames without rows zero (f32, f64); "
          f"flagship B={BATCH} f32: kernel {res['ms']:.4f} ms/call with the "
          f"solve's plan ({_ms(res['device_ms'])} ms device time, bound "
          f"/ device time {res['share_of_bound']}), "
          f"{res['noplan_ms']:.4f} ms/call building the plan per call, "
          f"plan build {res['plan_ms']:.4f} ms, plain "
          f"{res['plain_ms']:.3f} ms/call, bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']}, "
          f"{res['bytes']} bytes); device ms by max landmark tile "
          f"{json.dumps(res['tile_device_ms'])} on {card}", flush=True)
    return res


def phase_flagship(torch, dev, card):
    from rtk_visual_inertial_navigation_tpu_torch.core.state import \
        TangentLayout
    from rtk_visual_inertial_navigation_tpu_torch.ops.launches import \
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
          f"first call {t_first:.2f} s, synthesis {t_gen:.2f} s; kernel "
          f"launches in this solve {json.dumps(launches)}", flush=True)
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
    for name in ("proj_segments",) + CHOL_KERNELS:
        if not launches.get(name, 0):
            fails.append(f"the solve never launched the {name} kernel")
    if fails:
        _fail("flagship gate: " + "; ".join(fails))

    reps = 3
    t0 = time.time()
    outs = []
    for _ in range(reps):
        outs.append(batched_rtk_solve(probs, lay, cfg, F["cap"],
                                      device=dev))
    torch.cuda.synchronize()
    dt = time.time() - t0
    # information, not a gate: is the f32 solve repeatable bit for bit?
    same = all(torch.equal(o[0].p, win.p) for o in outs)
    diff = max((o[0].p - win.p).abs().max().item() for o in outs)
    print(f"phase 3: {reps} more solves of the same problem give "
          f"{'bitwise-equal' if same else 'different'} positions (max "
          f"|diff| {diff:.3e} m)", flush=True)
    del outs
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


def _spd_systems(gen, B, n, not_spd=False, k=1):
    """The recipe of tests/test_pallas_chol.py:15-18 (f32), with k
    right-hand sides ((B, n) for k = 1); ``not_spd`` makes the last pivot
    negative."""
    import torch
    A = torch.randn((B, n, 3 * n), generator=gen).float()
    S = A @ A.transpose(-1, -2) / n + 0.5 * torch.eye(n)
    if not_spd:
        S[:, -1, -1] = -1.0
    rhs = torch.randn((B, n) if k == 1 else (B, n, k), generator=gen).float()
    return S.cuda(), rhs.cuda()


def _tril_bytes(B, n, sector=32):
    """Bytes of the lower triangles of B contiguous f32 (n, n) matrices,
    counted in the 32-byte sectors their rows span."""
    import torch
    r, c = torch.tril_indices(n, n)
    elem = (torch.arange(B)[:, None] * (n * n) + (r * n + c)).flatten()
    return sector * torch.unique(elem * 4 // sector).numel()


def _bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _chol_check(torch, label, S, b, not_spd=False):
    """Factor and solve kernels against their plain versions: L within
    1e-5·max|L| and info equal, x within 1e-5·max|x|, relative residual
    < 1e-4 (tests/test_pallas_chol.py:31).  Returns the two errors."""
    from rtk_visual_inertial_navigation_tpu_torch.ops.pallas_chol_lanes \
        import (chol_factor_lanes, chol_factor_lanes_plain,
                chol_solve_factored, chol_solve_factored_plain)
    L1, info1 = chol_factor_lanes(S)
    L0, info0 = chol_factor_lanes_plain(S)
    torch.cuda.synchronize()
    if not torch.equal(info1, info0):
        _fail(f"{label}: factor info {info1.tolist()[:8]} differs from the "
              f"plain version's {info0.tolist()[:8]}")
    if bool(info1.any()) != not_spd:
        _fail(f"{label}: info {'misses' if not_spd else 'flags'} a failure")
    if not bool(torch.isfinite(L1).all()) or bool(torch.triu(L1, 1).any()):
        _fail(f"{label}: L not finite or not lower triangular")
    l_err = (L1 - L0).abs().max().item()
    if not l_err <= 1e-5 * L0.abs().max().item():
        _fail(f"{label}: L differs from the plain version's by {l_err:.3e}")
    x1 = chol_solve_factored(L1, b)
    x0 = chol_solve_factored_plain(L1, b)
    torch.cuda.synchronize()
    x_err = (x1 - x0).abs().max().item()
    if not bool(torch.isfinite(x1).all()) or \
            not x_err <= 1e-5 * max(x0.abs().max().item(), 1.0):
        _fail(f"{label}: x differs from the plain version's by {x_err:.3e}")
    if not not_spd:
        bb, xx = (b, x1) if b.dim() == 3 else (b[..., None], x1[..., None])
        r = S.double() @ xx.double() - bb.double()
        rel = (r.norm(dim=1) / bb.double().norm(dim=1)).max().item()
        if not rel < 1e-4:
            _fail(f"{label}: relative residual {rel:.3e}")
    return l_err, x_err


def phase_chol(torch, card):
    from rtk_visual_inertial_navigation_tpu_torch.ops.pallas_chol_lanes \
        import (_factor_cuda, chol_factor_lanes, chol_factor_lanes_plain,
                chol_solve_factored, chol_solve_factored_plain,
                chol_solve_lanes)

    gen = torch.Generator().manual_seed(2)
    res = {}
    for shape, (B, n) in CHOL_SHAPES.items():
        S, b1 = _spd_systems(gen, B, n)
        l_err, x_err = _chol_check(torch, f"chol {shape} B={B} n={n}", S, b1)
        bk = torch.randn((B, n, COV_COLS), generator=gen).cuda()
        _, xk_err = _chol_check(torch, f"chol {shape} B={B} n={n} "
                                f"k={COV_COLS}", S, bk)
        # chol_solve_lanes keeps the TPU kernel's contract: factor + solve
        L, _ = chol_factor_lanes(S)
        if not torch.equal(chol_solve_lanes(S, b1),
                           chol_solve_factored(L, b1)):
            _fail(f"chol {shape}: chol_solve_lanes differs from factor + "
                  f"solve")
        f = dict(max_abs_err=l_err,
                 ms=_time_ms(lambda: chol_factor_lanes(S), 50),
                 device_ms=_device_ms(lambda: chol_factor_lanes(S), 20,
                                      "chol_lanes_factor"),
                 plain_ms=_time_ms(lambda: chol_factor_lanes_plain(S), 3),
                 library_ms=_time_ms(lambda: torch.linalg.cholesky_ex(S), 50))
        f["bound_ms"], f["bound_by"] = _bound(
            2 * _tril_bytes(B, n) + 4 * B, B * n ** 3 / 3)
        Ll, _ = torch.linalg.cholesky_ex(S)
        solve = {}
        for k, rhs, err in ((1, b1, x_err), (COV_COLS, bk, xk_err)):
            rb = rhs if k > 1 else rhs[..., None]
            sv = dict(max_abs_err=err,
                      ms=_time_ms(lambda: chol_solve_factored(L, rhs), 50),
                      device_ms=_device_ms(
                          lambda: chol_solve_factored(L, rhs), 20,
                          "chol_lanes_solve"),
                      plain_ms=_time_ms(
                          lambda: chol_solve_factored_plain(L, rhs), 3),
                      library_ms=_time_ms(
                          lambda: torch.cholesky_solve(rb, Ll), 50))
            sv["bound_ms"], sv["bound_by"] = _bound(
                _tril_bytes(B, n) + 2 * 4 * B * n * k, 2 * B * n * n * k)
            solve[k] = sv
        res[shape] = dict(B=B, n=n, factor=f, solve=solve)
        print(f"phase 4: chol {shape} B={B} n={n} f32: factor "
              f"{json.dumps(f)}; solve k=1 {json.dumps(solve[1])}; solve "
              f"k={COV_COLS} {json.dumps(solve[COV_COLS])}; factor + one "
              f"solve bound {f['bound_ms'] + solve[1]['bound_ms']:.5f} ms "
              f"on {card}", flush=True)

    cases = [(300, 37, False, 1), (3, 400, False, COV_COLS),
             (4, 40, True, 1)]
    for B, n, not_spd, k in cases:
        S, b = _spd_systems(gen, B, n, not_spd, k)
        _chol_check(torch, f"chol B={B} n={n} k={k}"
                    f"{' not SPD' if not_spd else ''}", S, b, not_spd)
    # information: the factor's CTAs per system at the flagship shape
    B, n = CHOL_SHAPES["flagship"]
    S, _ = _spd_systems(gen, B, n)
    L_ref, _ = chol_factor_lanes(S)
    sweep = {}
    for cluster in (2, 3, 4, 8):
        fn = lambda: _factor_cuda(S, cluster)
        if not torch.equal(fn()[0], L_ref):
            _fail(f"chol flagship: cluster {cluster} gives another factor")
        sweep[cluster] = _device_ms(fn, 20, "chol_lanes_factor")
    res["flagship"]["factor"]["cluster_device_ms"] = sweep
    print(f"phase 4: chol kernels match their plain versions at both "
          f"shapes (k = 1, {COV_COLS}) and in {len(cases)} more cases; "
          f"flagship factor device ms by CTAs per system "
          f"{json.dumps(sweep)} on {card}", flush=True)
    return res


def phase_vi(torch, dev, card):
    from torch.utils._pytree import tree_map

    from rtk_visual_inertial_navigation_tpu_torch.core.state import \
        TangentLayout
    from rtk_visual_inertial_navigation_tpu_torch.ops.launches import \
        LAUNCHES
    from rtk_visual_inertial_navigation_tpu_torch.parallel import (
        batched_vi_solve, make_synthetic_windows)
    from rtk_visual_inertial_navigation_tpu_torch.solver.gauss_newton \
        import DoglegConfig

    nf, nl = VI["nf"], VI["nl"]
    lay = TangentLayout(nf=nf, nl=nl, nb=1, nc=2)
    cfg = DoglegConfig(max_iters=8, schur_nl=nl,
                       reduced_keep=tuple(range(15 * nf)))
    t0 = time.time()
    probs64 = make_synthetic_windows(0, VI_BATCH, dtype=torch.float64,
                                     device=dev, **VI)
    probs = tree_map(lambda x: x.float() if x.is_floating_point() else x,
                     probs64)
    torch.cuda.synchronize()
    t_gen = time.time() - t0

    LAUNCHES.clear()
    t0 = time.time()
    state, cost, nacc = batched_vi_solve(probs, lay, cfg, device=dev)
    torch.cuda.synchronize()
    t_first = time.time() - t0
    launches = dict(LAUNCHES)

    # the bench's accuracy statistics (bench.py:298-304): frames 1+ start
    # ~0.1 m off and must be pulled back
    def window_err(st, pr):
        return (st.p - pr.truth.p).norm(dim=-1)[:, 1:].max(dim=1).values

    worst = window_err(state, probs)
    # the same windows on the host CPU: the plain path, which
    # tests/test_torch_vi_f32.py holds window by window against the JAX f32
    # solve of the same problem
    t0 = time.time()
    probs_cpu = tree_map(lambda x: x.cpu(), probs)
    worst_cpu = window_err(batched_vi_solve(probs_cpu, lay, cfg,
                                            device="cpu")[0], probs_cpu)
    t_cpu = time.time() - t0
    # the same windows in f64: the model and solver recover truth exactly
    state64, cost64, nacc64 = batched_vi_solve(probs64, lay, cfg, device=dev)
    gate = dict(
        cost_finite=bool(torch.isfinite(cost).all().item()),
        nacc_min=int(nacc.min().item()), max_pos_err_m=worst.max().item(),
        frac_windows_err_gt_1cm=(worst > 0.01).double().mean().item(),
        median_window_err_m=worst.median().item(),
        cpu_max_pos_err_m=worst_cpu.max().item(),
        cpu_frac_windows_err_gt_1cm=(worst_cpu > 0.01).double().mean()
        .item(),
        max_window_err_diff_vs_cpu_m=(worst.cpu() - worst_cpu).abs().max()
        .item(),
        f64_max_pos_err_m=window_err(state64, probs64).max().item(),
        f64_nacc_min=int(nacc64.min().item()), launches=launches)
    print(f"phase 5: VI solve B={VI_BATCH} f32: {json.dumps(gate)}; first "
          f"call {t_first:.2f} s, synthesis {t_gen:.2f} s, the same windows "
          f"on the CPU {t_cpu:.2f} s", flush=True)
    # f32 limits.  The f32 step factors the shifted system A + 1e-5·I, as
    # the JAX solver does, and 8 iterations leave a few cm along weak
    # directions.  On the JAX generator's problems at B=128 the JAX f32
    # solve leaves 11.7 % and 18.8 % of the windows above 1 cm (max
    # 0.049 m), and the port's CPU solve of the same problems matches it
    # window by window (PERF.md §6, tests/test_torch_vi_f32.py); here each
    # window is held to the CPU solve of the same window.
    fails = []
    if not gate["cost_finite"]:
        fails.append("a cost is not finite")
    if gate["nacc_min"] < 1:
        fails.append("a window accepted no step")
    if not gate["max_window_err_diff_vs_cpu_m"] <= VI_ERR_TOL_M:
        fails.append(f"a window's error differs from the CPU solve's by > "
                     f"{VI_ERR_TOL_M} m")
    if gate["max_pos_err_m"] > 0.05:
        fails.append("max frame-1+ position error > 0.05 m")
    if gate["frac_windows_err_gt_1cm"] > 1 / 4:
        fails.append("more than 1/4 of the windows err > 1 cm")
    if not gate["f64_max_pos_err_m"] <= 1e-6:
        fails.append("the f64 solve misses truth by > 1e-6 m")
    if tuple(state.p.shape) != (VI_BATCH, nf, 3):
        fails.append("unexpected output shape")
    for name in CHOL_KERNELS:
        if not launches.get(name, 0):
            fails.append(f"the solve never launched the {name} kernel")
    if fails:
        _fail("VI gate: " + "; ".join(fails))
    del probs64, state64

    reps = 3
    t0 = time.time()
    for _ in range(reps):
        out = batched_vi_solve(probs, lay, cfg, device=dev)
    torch.cuda.synchronize()
    dt = time.time() - t0
    del out, probs
    ups = VI_BATCH * reps / dt
    print(f"phase 5: {ups:.3f} VI updates/s ({reps} timed solves of "
          f"B={VI_BATCH}, {dt / reps * 1e3:.1f} ms per solve) on {card}",
          flush=True)

    # bench.py --latency: one window, the result fetched after each solve
    one = make_synthetic_windows(0, 1, dtype=torch.float32, device=dev,
                                 **VI)
    batched_vi_solve(one, lay, cfg, device=dev)[1].cpu()
    reps = 20
    t0 = time.time()
    for _ in range(reps):
        batched_vi_solve(one, lay, cfg, device=dev)[1].cpu()
    lat_ms = (time.time() - t0) / reps * 1e3
    print(f"phase 5: B=1 VI solve latency {lat_ms:.1f} ms (mean of {reps}, "
          f"host-synced) = {1e3 / lat_ms:.3f} updates/s on {card}",
          flush=True)

    # small f64 problem: the CUDA solve against the CPU solve
    sh = dict(nf=4, nl=8, nobs=24, n_samples=8)
    lay_s = TangentLayout(nf=4, nl=8, nb=1, nc=2)
    cfg_s = DoglegConfig(max_iters=4, schur_nl=8)
    small = make_synthetic_windows(7, 2, device="cpu", **sh)
    ref = batched_vi_solve(small, lay_s, cfg_s, device="cpu")
    got = batched_vi_solve(small, lay_s, cfg_s, device=dev)
    for name, a, b in (("p", got[0].p, ref[0].p),
                       ("landmarks", got[0].landmarks, ref[0].landmarks),
                       ("cost", got[1], ref[1])):
        err = (a.cpu() - b).abs().max().item()
        if not err <= 1e-8:
            _fail(f"small f64 VI solve: {name} on cuda differs from cpu by "
                  f"{err:.3e}")
    print("phase 5: small f64 VI solve on cuda matches the cpu solve "
          "(atol 1e-8)", flush=True)
    return dict(gate, updates_per_s=ups, latency_ms=lat_ms)


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
    logs = build.build(["proj_segments", *CHOL_KERNELS], verbose=True)
    for name, log in logs.items():
        print(f"phase 1: built {name} in {time.time() - t0:.1f} s\n"
              + log.strip(), flush=True)
    from rtk_visual_inertial_navigation_tpu_torch import full_precision
    full_precision()

    kres = phase_kernel_checks(torch, dev, card)
    launches = phase_flagship(torch, dev, card)
    phase_small_reference(torch, dev)
    cres = phase_chol(torch, card)
    vres = phase_vi(torch, dev, card)

    n = launches.get("proj_segments", 0)
    if n == 0:
        _fail("the main path never launched the proj_segments kernel")
    for name in CHOL_KERNELS:
        if not launches.get(name, 0) or not vres["launches"].get(name, 0):
            _fail(f"a window solve never launched the {name} kernel")
    fl, vi = cres["flagship"], cres["vi"]
    kernels = [dict(
        name="proj_segments", route="cuda",
        source=f"{PKG}/ops/csrc/proj_segments.cu",
        replaces="rtk_visual_inertial_navigation_tpu/ops/pallas_proj.py:108",
        launches=n, max_abs_err=kres["max_abs_err"], ms=kres["ms"],
        plain_ms=kres["plain_ms"], bound_ms=kres["bound_ms"],
        bound_by=kres["bound_by"], library_ms=None,
        device_ms=kres["device_ms"], share_of_bound=kres["share_of_bound"],
        plan_ms=kres["plan_ms"], noplan_ms=kres["noplan_ms"],
        tile_device_ms=kres["tile_device_ms"],
        phase="phase 3 (flagship solve); timed in phase 2")]
    # the Cholesky kernels: numbers at the flagship shape (B=32, n=339;
    # library: cholesky_ex for the factor, cholesky_solve for the solve),
    # the VI shape's and the 16-column solve's beside them
    for name, src, key in (("chol_lanes", "chol_lanes.cu", "factor"),
                           ("chol_lanes_solve", "chol_lanes_solve.cu",
                            "solve")):
        pick = (lambda r: r["factor"]) if key == "factor" else \
            (lambda r: r["solve"][1])
        main = pick(fl)
        extra = dict(vi_shape=dict(B=vi["B"], n=vi["n"], **pick(vi)))
        if key == "solve":
            extra.update(k16=fl["solve"][COV_COLS],
                         vi_k16=vi["solve"][COV_COLS])
        else:
            extra.update(cluster_device_ms=main["cluster_device_ms"])
        kernels.append(dict(
            name=name, route="cuda", source=f"{PKG}/ops/csrc/{src}",
            replaces="rtk_visual_inertial_navigation_tpu/ops/"
                     "pallas_chol_lanes.py:40",
            launches=launches[name], max_abs_err=main["max_abs_err"],
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], device_ms=main["device_ms"],
            shape=dict(B=fl["B"], n=fl["n"]),
            launches_per_vi_solve=vres["launches"][name], **extra,
            phase="phases 3 and 5 (the f32 step and covariance of both "
                  "window solves); timed in phase 4"))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
