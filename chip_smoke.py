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
     no row observes exactly zero; the same checks on every shard the
     sharded solves of phase 10 give the kernel (phase 3's problem at fp=2,
     the dry run's problem as it is laid out on the visible cards), each
     with its own plan, where the landmarks without a row must be zero
     too; time kernel (with the solve's observation plan and without),
     plan build and plain version per call at the flagship shape, and the
     device time against the largest landmark tile (information);
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
  6. the estimator pipeline (``bench.py --pipeline``) through the port's
     ``pipeline.Estimator`` on the card: the bench's 30 s noiseless RTK-VI
     sequence (cam 2 Hz, GNSS 2 Hz, nf=10, nl=48, nb=32, IMU-GNSS chains at
     the default caps, LAMBDA fixing), the f32 step, counts zeroed and read
     around it (the Cholesky kernels must have run); the gate of
     tests/test_pipeline_gnss.py:117-138 (initialized, fixed, the fixed
     double differences equal the simulated integers, the last 10 frames
     within 0.02 m of truth); steady-state frames/s as the bench computes
     it (12 warm-up frames, then the mean of the stamp gaps, median and
     p90), launches per frame, and the host time per frame by stage;
     6b. the bench's 8 s ``--smoke`` sequence in f64 on the card and on the
     host CPU: every frame's position within PIPE_F64_TOL_M, the same
     per-frame ``rtk_fixed`` flags and the same fixed integers;
  7. the bench's 8 s sequence written as a bz2 rosbag (``sim_to_bag``),
     read by the native reader (message for message equal to the Python
     reader's) and replayed by ``replay_bag`` into the estimator on the
     card, f32 step, a ``ResultWriter`` attached, counts zeroed and read
     around it: phase 6's gate, one CSV row per IMU sample, the CSV read
     back through ``io/evaluate.py`` against the bag's ground truth;
     frames/s, parse ms per message;
  8. a. the image frontend at full width (752x480 stereo, ``max_cnt`` 350,
     ``min_dist`` 30) on 24 textured frames under a known warp, on the card
     and on the host CPU: the same ids on every frame, points within
     FE_PX_TOL, the median tracking error against the warp; ms, kernels
     and host syncs per frame;
     b. images -> ``TrackerFrontend`` -> ``Estimator`` on the card at
     tests/test_tracker_frontend.py's configuration and bounds;
  9. the demo's ``main`` on the card in each of its five modes: initialized,
     finite positions, one CSV row per IMU sample;
  10. the sharded flagship solve at full width (phase 3's problem) through
     the multihost layer, counts zeroed and read around each solve (the
     projection kernel and both Cholesky kernels must have run, on every
     rank):
     a. at world size 1 over NCCL, joined as torchrun would
     (``initialize_from_env``, ``global_mesh(fp=1)``,
     ``distribute_local_rtk_problems``, ``multihost_rtk_solve``): the
     bench's gate, the result held to phase 3's within phase 3's repeat
     spread, updates/s beside phase 3's;
     b. two processes on the one card over gloo, dp=1 x fp=2 (1408 rows
     and 5 chains each; NCCL refuses two ranks on one device, and gloo
     reduces through host memory): the gate, the gathered result held to
     10a's within phase 3's error against the truth, updates/s; then the
     same problem in f64 after one dogleg iteration and after eight, each
     held to the single-process f64 solve at the JAX package's tolerances
     for its sharded solve (the check that sees a wrong reduction);
     c. in the same two processes, the VI solve at fp=2 (phase 5's
     windows): each window held to phase 5's CPU f32 solve of it;
     d. ``dryrun_multichip`` on every visible card;
     any rank's failure or hang (``multihost.TIMEOUT_S``) fails the script;
  11. print the ``kernels`` JSON line, then the card line, then the final
     ``{"ok": true, ...}`` line.

It imports nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
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
# the reduced blocks the f32 step factors: the VI solve's 15·nf kept slots,
# the flagship's Dr = 339 (TangentLayout(11, 352, 16, 2): D = 1395, 3·352
# of it landmarks) and the pipeline's one window, Dr = 327
# (TangentLayout(10, 48, 32, 2): D = 471, 3·48 of it landmarks); the
# flagship covariance solves nb = 16 columns
CHOL_SHAPES = {"vi": (VI_BATCH, 15 * VI["nf"]), "flagship": (BATCH, 339),
               "pipeline": (1, 327)}
COV_COLS = FLAGSHIP["nb"]
CHOL_KERNELS = ("chol_lanes", "chol_lanes_solve")
# projection kernel calls at the flagship shape that must be bitwise equal
REPEATS = 100
# bench.py --pipeline (bench.py:49-64): the simulated sequence, seed 0,
# noiseless; 30 s, or 8 s with --smoke
PIPE_SIM = dict(imu_rate=200.0, cam_rate=2.0, gnss_rate=2.0, n_landmarks=60,
                n_sats=10, seed=0)
PIPE_DURATION = 30.0
PIPE_SMOKE_DURATION = 8.0
PIPE_WARMUP = 12
# the f64 replay on the card against the same replay on the host CPU: the
# same decisions, positions apart by roundoff only
PIPE_F64_TOL_M = 1e-6
# phase 7: the pipeline's sequence written as a bz2 rosbag and replayed
# through replay_bag (main3.cpp's loop) with the f32 step and a ResultWriter;
# the 8 s --smoke sequence (phase 6 replays the 30 s one), which keeps the
# whole script near half of its 1200 s limit
BAG_DURATION = PIPE_SMOKE_DURATION
# phase 8a: the image frontend at the reference's width (752x480,
# SURVEY.md:594; MAX_CNT=350, MIN_DIST=30, SURVEY.md:264) on frames of
# Gaussian blobs made from a seed, each frame the texture under a known
# rotation + translation, with a right image shifted by a known disparity
FE_H, FE_W = 480, 752
FE_FRAMES = 24
FE_BLOBS = 8000
FE_MAX_CNT, FE_MIN_DIST = 350, 30
FE_FOCAL = 460.0
FE_DISPARITY = 10.0           # px, the right image's shift
FE_ROT_PER_FRAME = 0.002      # rad about the image center
FE_SHIFT_PER_FRAME = (2.5, -1.2)   # px
# tracked points on the card within this many pixels of the port's CPU
# frontend on the same frames (both sum float32 patches, in other orders)
FE_PX_TOL = 0.01
# and the median tracking error against the known warp (px)
FE_TRUTH_TOL_PX = 0.25
FE_PROFILE_FRAMES = 3
# phase 8b: tests/test_tracker_frontend.py:34-63's configuration
WIRE_H, WIRE_W, WIRE_F = 240, 320, 160.0
# phase 9: the demo's five modes, a few seconds each
DEMO_MODES = ("rtk", "rtd", "spp", "spp_cp", "vi")
DEMO_DURATION = 4.0
# phase 10b in f64: the dogleg iterations of the two solves held to the
# single-process f64 solve (the first step alone, where a wrong sum of the
# shards' blocks moves the step, and the whole solve), and the tolerances,
# the JAX package's own for its sharded solve (tests/test_parallel_rtk.py)
F64_ITERS = (1, 8)
F64_ATOL = 1e-8
F64_COST_RTOL, F64_COST_ATOL = 1e-6, 1e-12


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


def _check_proj_shards(torch, dev, pr, shape, n_dp, n_fp, label):
    """The projection kernel on every dp x fp shard of the problem ``pr``,
    cut as the sharded solve's ranks cut it (windows over dp, observation
    rows over fp) and with each shard's own plan, against its plain
    version (``_compare``); REPEATS calls per shard bitwise equal, each
    into NaN-filled memory, and the blocks of every frame and landmark
    that no live row of the shard observes exactly zero.  Returns the
    largest error and the most frames / landmarks without a row on one
    shard."""
    from rtk_visual_inertial_navigation_tpu_torch.core.state import \
        TangentLayout
    from rtk_visual_inertial_navigation_tpu_torch.factors.visual import \
        PROJ_SQRT_INFO
    from rtk_visual_inertial_navigation_tpu_torch.ops.pallas_proj import (
        proj_plan, proj_segments_pallas, proj_segments_plain)
    from rtk_visual_inertial_navigation_tpu_torch.parallel.mesh import _part

    nf, nl = shape["nf"], shape["nl"]
    lay = TangentLayout(nf=nf, nl=nl, nb=shape["nb"], nc=2)
    dtype = pr.state0.p.dtype
    worst, most = 0.0, [0, 0]
    for d in range(n_dp):
        wins = lambda x: _part(x, 0, n_dp, d)
        w = pr.state0._replace(**{k: wins(getattr(pr.state0, k)) for k in (
            "p", "q", "tic", "qic", "landmarks")})
        for i in range(n_fp):
            f, l, xy, valid = (_part(wins(x), 1, n_fp, i).contiguous()
                               for x in (pr.f_ids, pr.l_ids, pr.obs_xy,
                                         pr.obs_valid))
            cam = torch.zeros_like(f)
            pbg = torch.zeros(3, dtype=dtype, device=dev)
            args = (w.p, w.q, w.tic, w.qic, w.landmarks, pbg, f, cam, l, xy,
                    valid)
            plan = proj_plan(lay, f, cam, l, valid)
            kern = lambda: proj_segments_pallas(
                lay, *args, PROJ_SQRT_INFO, want_ext=False, plan=plan)
            S1, c1 = kern()
            S0, c0 = proj_segments_plain(lay, *args, PROJ_SQRT_INFO)
            torch.cuda.synchronize()
            where = f"{label} {dtype} dp {d} fp {i}"
            worst = max(worst, _compare(S1, c1, S0, c0, dtype,
                                        ("PP", "LL", "PL", "GP", "GL"),
                                        where))
            count = lambda ids, n: torch.zeros(
                (ids.shape[0], n), dtype=torch.int64, device=dev
            ).scatter_add_(1, ids.long(), valid.long())
            no_f, no_l = count(f, nf) == 0, count(l, nl) == 0
            most = [max(most[0], int(no_f.sum())),
                    max(most[1], int(no_l.sum()))]
            for _ in range(REPEATS):
                torch.full((1 << 24,), float("nan"), dtype=dtype, device=dev)
                S2, c2 = kern()
                if not (torch.equal(c1, c2)
                        and all(torch.equal(S1[k], S2[k]) for k in S1)):
                    _fail(f"{where}: two kernel calls differ")
                if (bool(S2["PP"][no_f].any()) or bool(S2["GP"][no_f].any())
                        or bool(S2["PL"][no_f].any())
                        or bool(S2["LL"][no_l].any())
                        or bool(S2["GL"][no_l].any())
                        or bool(S2["PL"].transpose(1, 2)[no_l].any())):
                    _fail(f"{where}: a frame or landmark without rows is "
                          f"not zero")
    return worst, most


def phase_shard_kernel_checks(torch, dev):
    """The projection kernel at the shapes the sharded solves of phase 10
    give it: phase 3's problem cut for 10b (dp=1 x fp=2, 1408 rows a
    shard) and the dry run's problem as 10d lays it out on the visible
    cards, each in f32 and f64."""
    from rtk_visual_inertial_navigation_tpu_torch.parallel.dryrun import (
        RTK_SEED, RTK_SHAPE, mesh_shape)
    from rtk_visual_inertial_navigation_tpu_torch.parallel.problems_gnss \
        import make_synthetic_rtk_windows

    n_dp, n_fp = mesh_shape(torch.cuda.device_count())
    t0 = time.time()
    out = {}
    for dtype in (torch.float32, torch.float64):
        pr = make_synthetic_rtk_windows(0, BATCH, dtype=dtype, device=dev,
                                        **FLAGSHIP)
        out[f"10b {dtype}"] = _check_proj_shards(torch, dev, pr, FLAGSHIP,
                                                 1, 2, "10b shard")
        pr = make_synthetic_rtk_windows(RTK_SEED, 2 * n_dp, dtype=dtype,
                                        device=dev, **RTK_SHAPE)
        out[f"10d {dtype}"] = _check_proj_shards(torch, dev, pr, RTK_SHAPE,
                                                 n_dp, n_fp, "10d shard")
    print(f"phase 2: proj_segments kernel matches its plain version on "
          f"every shard of phase 10's sharded solves (10b: phase 3's "
          f"problem at dp=1 x fp=2; 10d: the dry run's at dp={n_dp} x "
          f"fp={n_fp}), {REPEATS} calls per shard bitwise equal and frames "
          f"and landmarks without rows zero; max abs err and the most "
          f"[frames, landmarks] without a row on one shard, summed over its "
          f"windows: {json.dumps(out)}; {time.time() - t0:.1f} s",
          flush=True)
    return out


def _flagship_gate(torch, probs, out, launches, label):
    """The bench's hard gate (bench.py:169-193) on a flagship solve's
    output, plus its shapes and the kernels the solve must have launched;
    fails the script, else returns the gate's numbers."""
    F = FLAGSHIP
    win, _, _, nacc, X = out
    perr = (win.p - probs.truth.p).norm(dim=-1)
    pberr = (win.phase_bias - probs.truth.phase_bias).abs()[:, :F["ns"]]
    nacc_min = int(nacc.min().item())
    cov_ok = bool(torch.isfinite(X).all().item())
    from rtk_visual_inertial_navigation_tpu_torch.core.state import \
        TangentLayout
    dim = TangentLayout(nf=F["nf"], nl=F["nl"], nb=F["nb"], nc=2).dim
    shape_ok = (tuple(win.p.shape) == (BATCH, F["nf"], 3)
                and tuple(X.shape) == (BATCH, dim, F["nb"]))
    gate = dict(nacc_min=nacc_min, max_pos_err_m=perr.max().item(),
                max_amb_err_cyc=pberr.max().item(), cov_finite=cov_ok)
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
        _fail(f"{label} gate: " + "; ".join(fails))
    return gate


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

    out = (win, hid, cost, nacc, X)
    gate = _flagship_gate(torch, probs, out, launches, "flagship")
    print(f"phase 3: flagship solve B={BATCH} f32: {json.dumps(gate)}; "
          f"first call {t_first:.2f} s, synthesis {t_gen:.2f} s; kernel "
          f"launches in this solve {json.dumps(launches)}", flush=True)

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
    return dict(launches=launches, probs=probs, out=out, gate=gate,
                repeat_spread_m=diff, updates_per_s=ups)


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
        import (_factor_cluster, _factor_cuda, chol_factor_lanes,
                chol_factor_lanes_plain, chol_solve_factored,
                chol_solve_factored_plain, chol_solve_lanes)

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
    # the pipeline's one window: every cluster size that fits, against the
    # launcher's own choice
    B, n = CHOL_SHAPES["pipeline"]
    S, _ = _spd_systems(gen, B, n)
    L_ref, _ = chol_factor_lanes(S)
    psweep = {}
    for cluster in range(1, 9):
        fn = lambda: _factor_cuda(S, cluster)
        try:
            L_c = fn()[0]
        except ValueError:              # its CTAs do not fit
            psweep[cluster] = None
            continue
        if not torch.equal(L_c, L_ref):
            _fail(f"chol pipeline: cluster {cluster} gives another factor")
        psweep[cluster] = dict(
            device_ms=_device_ms(fn, 20, "chol_lanes_factor"),
            ms=_time_ms(fn, 50))
    pipe = res["pipeline"]["factor"]
    pipe["cluster"] = _factor_cluster(B, n)
    pipe["cluster_sweep"] = psweep
    print(f"phase 4: chol kernels match their plain versions at all "
          f"shapes (k = 1, {COV_COLS}) and in {len(cases)} more cases; "
          f"flagship factor device ms by CTAs per system "
          f"{json.dumps(sweep)}; pipeline B={B} n={n} factor by CTAs per "
          f"system (launcher takes {pipe['cluster']}) {json.dumps(psweep)} "
          f"on {card}", flush=True)
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
    return dict(gate, updates_per_s=ups, latency_ms=lat_ms,
                cpu_window_err_m=worst_cpu.numpy())


def _pipeline_cfg(torch, sim, f32):
    """bench.py --pipeline's estimator configuration (bench.py:56-65)."""
    import numpy as np

    from rtk_visual_inertial_navigation_tpu_torch.config import \
        EstimatorConfig
    from rtk_visual_inertial_navigation_tpu_torch.ops import lie
    q_ic = lie.rot_to_quat(torch.from_numpy(sim.cfg.r_ic)).numpy()
    return EstimatorConfig(
        nf=10, nl=48, nb=32, max_obs=256, imu_capacity=128, average_imu=40,
        qic=np.tile(q_ic, (2, 1)), tic=np.tile(sim.cfg.t_ic, (2, 1)),
        anchor_ecef=sim.anchor_ecef, enu_to_ecef=sim.enu_to_ecef,
        max_gnss_pr=160, max_gnss_cp=160, max_gnss_dopp=160,
        min_sats_per_epoch=6, initial_gnss_boost_epochs=5,
        min_fix_continuity=1, fix_continue_threshold=3,
        use_gnss=True, use_doppler=True, use_rtd=True, use_rtk=True,
        use_n_resolve=True,
        solve_step_dtype=("float32" if f32 else "same"))


# host time of the estimator's stages, by method (an outer stage's time
# includes what it calls)
PIPE_STAGES = {"solve": "_optimize", "marginalize": "_marginalize_oldest",
               "drop_frame": "_drop_second_newest",
               "preintegrate": "_preintegrate_buffer",
               "triangulate": "_triangulate_new",
               "outliers": "_reject_outliers", "integer_fix": "_integer_solve",
               "condense_chains": "_condense_gnss_runs",
               "prior_sync": "_sync_prior_with_features"}


def _pipeline_replay(est, sim, stage_log=None):
    """The bench's replay (``pipeline.replay``, bench.py:67-80).  Returns
    the host stamp after each event and the per-event ``rtk_fixed`` flags;
    with ``stage_log`` (a list), appends each event's host seconds by
    stage."""
    from rtk_visual_inertial_navigation_tpu_torch.pipeline import replay
    cur = {}
    if stage_log is not None:
        depth = [0]

        def timed(name, fn):
            def run(*a, **kw):
                depth[0] += 1
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    depth[0] -= 1
                    if depth[0] == 0:
                        cur[name] = cur.get(name, 0.0) \
                            + time.perf_counter() - t0
            return run
        for name, meth in PIPE_STAGES.items():
            setattr(est, meth, timed(name, getattr(est, meth)))
    stamps, fixed = [], []

    def on_event(i):
        stamps.append(time.time())
        fixed.append(bool(est.rtk_fixed))
        if stage_log is not None:
            stage_log.append(dict(cur))
            cur.clear()

    replay(est, sim, on_event=on_event)
    return stamps, fixed


def _fix_keys(est):
    """The phase-bias slots' keys as they were when ``est`` made its last
    integer fix (a slot of the fix may be freed or reused later, by a
    cycle slip the estimator forces or by staleness).  Call before the
    replay; read ``["keys"]`` after it."""
    snap = {"keys": None}
    inner = est._integer_solve

    def run(*a, **kw):
        out = inner(*a, **kw)
        snap["keys"] = list(est.gnss.bias.key)
        return out
    est._integer_solve = run
    return snap


def _pipeline_gate(est, sim, launches, label, keys):
    """The gate of tests/test_pipeline_gnss.py:117-138 on a replay of
    ``sim``: initialized, fixed at the end, every fixed double difference
    equal to the simulated integer (the slots' satellites as they were at
    the fix, ``keys``), the last 10 frames within 0.02 m; and the Cholesky
    kernels launched.  Returns the last 10 frames' errors."""
    import numpy as np
    wrong = [(i, r, n) for (i, r, n) in est._last_fix
             if keys is None or keys[i] is None or keys[r] is None
             or n != int(sim.rtk_ambiguities[keys[i][1]]
                         - sim.rtk_ambiguities[keys[r][1]])]
    errs = [float(np.linalg.norm(p - sim.p[np.argmin(np.abs(sim.imu_t
                                                             - t))]))
            for (t, p, q, v) in est.trajectory[-10:]]
    fails = []
    if not est.initialized:
        fails.append("not initialized")
    if not est.rtk_fixed:
        fails.append("no fixed solution at the end")
    if not est._last_fix or wrong:
        fails.append(f"fixed double differences {wrong or 'none'} are not "
                     f"the simulated integers")
    if not (len(errs) == 10 and max(errs) < 0.02):
        fails.append(f"last 10 positions err up to "
                     f"{max(errs, default=float('nan')):.4f} m")
    for name in CHOL_KERNELS:
        if not launches.get(name, 0):
            fails.append(f"the replay never launched the {name} kernel")
    if fails:
        _fail(f"{label}: " + "; ".join(fails))
    return errs


def phase_pipeline(torch, dev, card):
    import numpy as np

    from rtk_visual_inertial_navigation_tpu_torch.ambiguity import \
        fix_differences
    from rtk_visual_inertial_navigation_tpu_torch.io import \
        evaluate_trajectory

    from rtk_visual_inertial_navigation_tpu_torch.ops.launches import \
        LAUNCHES
    from rtk_visual_inertial_navigation_tpu_torch.pipeline import Estimator
    from rtk_visual_inertial_navigation_tpu_torch.sim import (SimConfig,
                                                              simulate)

    t0 = time.time()
    sim = simulate(SimConfig(duration=PIPE_DURATION, **PIPE_SIM))
    t_sim = time.time() - t0
    est = Estimator(_pipeline_cfg(torch, sim, f32=True), device=dev)
    fix = _fix_keys(est)
    stage_log = []
    LAUNCHES.clear()
    t0 = time.time()
    stamps, _ = _pipeline_replay(est, sim, stage_log)
    torch.cuda.synchronize()
    t_run = time.time() - t0
    launches = dict(LAUNCHES)

    errs = _pipeline_gate(est, sim, launches, "pipeline gate", fix["keys"])

    # the whole trajectory against truth, RTK convention (no alignment)
    traj = evaluate_trajectory(
        [t for (t, _, _, _) in est.trajectory],
        np.stack([p for (_, p, _, _) in est.trajectory]), sim.imu_t, sim.p,
        align=False)

    # bench.py:82-95: steady state after 12 warm-up frames
    steady = np.diff(np.asarray(stamps))[PIPE_WARMUP:]
    n_frames = len(stamps)
    stages = {}
    for log in stage_log[PIPE_WARMUP + 1:]:
        for k, v in log.items():
            stages[k] = stages.get(k, 0.0) + v
    per_frame_ms = {k: round(1e3 * v / len(steady), 3)
                    for k, v in sorted(stages.items(), key=lambda x: -x[1])}
    per_frame_ms["other"] = round(1e3 * (steady.sum() - sum(stages.values()))
                                  / len(steady), 3)
    out = dict(
        frames_per_s=1.0 / float(np.mean(steady)),
        median_ms=1e3 * float(np.median(steady)),
        p90_ms=1e3 * float(np.percentile(steady, 90)),
        frames_timed=int(len(steady)), warmup_frames_skipped=PIPE_WARMUP,
        n_frames_total=n_frames, duration_s=PIPE_DURATION,
        max_err_last10_m=max(errs), mae_3d_m=traj.mae_3d,
        n_associated=traj.n_associated, n_fixed_dd=len(est._last_fix),
        chain_stats=est._chain_stats, launches=launches,
        launches_per_frame={k: v / n_frames for k, v in launches.items()},
        stage_ms_per_frame=per_frame_ms, replay_s=t_run, sim_s=t_sim)
    print(f"phase 6: pipeline RTK-VI {PIPE_DURATION:g} s f32 on {card}: "
          f"{json.dumps(out)}", flush=True)

    # 6b: bench.py --smoke's sequence in f64 on the card and on the host
    sim8 = simulate(SimConfig(duration=PIPE_SMOKE_DURATION, **PIPE_SIM))
    runs = {}
    for where in (dev, "cpu"):
        e = Estimator(_pipeline_cfg(torch, sim8, f32=False), device=where)
        t0 = time.time()
        _, fixed = _pipeline_replay(e, sim8)
        runs[str(where)] = (e, fixed, time.time() - t0)
    (ec, fc, tc), (eh, fh, th) = runs[str(dev)], runs["cpu"]
    pc = np.stack([p for (_, p, _, _) in ec.trajectory])
    ph = np.stack([p for (_, p, _, _) in eh.trajectory])
    fails = []
    if pc.shape != ph.shape:
        _fail(f"pipeline f64: {len(pc)} frames on the card, {len(ph)} on "
              f"the cpu")
    diff = float(np.abs(pc - ph).max())
    if not diff <= PIPE_F64_TOL_M:
        fails.append(f"positions differ by {diff:.3e} m")
    if fc != fh:
        where = [i for i, (a, b) in enumerate(zip(fc, fh)) if a != b]
        fails.append(f"rtk_fixed flags differ at events {where}")
    if fix_differences(ec._last_fix) != fix_differences(eh._last_fix):
        fails.append("the last fixes differ")
    if fails:
        _fail("pipeline f64 card vs cpu: " + "; ".join(fails))
    print(f"phase 6b: pipeline RTK-VI {PIPE_SMOKE_DURATION:g} s f64: "
          f"{len(pc)} frames, card vs cpu max position difference "
          f"{diff:.3e} m (tol {PIPE_F64_TOL_M:g}), the same {len(fc)} "
          f"rtk_fixed flags ({sum(fc)} fixed) and fixes; replay {tc:.1f} s "
          f"on the card, {th:.1f} s on the cpu", flush=True)
    return out


def _sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _frame_stamps(est):
    """A host stamp after each GNSS or image frame ``est`` processes."""
    stamps = []
    for meth in ("process_gnss", "process_image"):
        def run(*a, _fn=getattr(est, meth), **kw):
            out = _fn(*a, **kw)
            stamps.append(time.time())
            return out
        setattr(est, meth, run)
    return stamps


def phase_bag(torch, dev, card, duration=BAG_DURATION):
    """Phase 7: sim -> bz2 rosbag -> native reader -> replay_bag into the
    estimator on the card, one CSV row per IMU sample, read back through
    io/evaluate.py against the bag's ground-truth CSV."""
    import numpy as np

    from rtk_visual_inertial_navigation_tpu_torch.io import (
        ResultWriter, evaluate_trajectory)
    from rtk_visual_inertial_navigation_tpu_torch.io.bag_writer import \
        sim_to_bag
    from rtk_visual_inertial_navigation_tpu_torch.io.reference_bag import (
        iter_bag_events, read_bag, replay_bag)
    from rtk_visual_inertial_navigation_tpu_torch.native import \
        read_bag_native
    from rtk_visual_inertial_navigation_tpu_torch.ops.launches import \
        LAUNCHES
    from rtk_visual_inertial_navigation_tpu_torch.pipeline import Estimator
    from rtk_visual_inertial_navigation_tpu_torch.sim import (SimConfig,
                                                              simulate)

    sim = simulate(SimConfig(duration=duration, **PIPE_SIM))
    with tempfile.TemporaryDirectory() as tmp:
        bag, gt, csv = (os.path.join(tmp, n)
                        for n in ("seq.bag", "gt.csv", "result.csv"))
        t0 = time.perf_counter()
        sim_to_bag(sim, bag, gt, compression="bz2")
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        native = read_bag_native(bag)
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        python = read_bag(bag)
        t_python = time.perf_counter() - t0
        if len(native) != len(python) or any(
                (a.topic, a.msg_type, a.t, a.raw)
                != (b.topic, b.msg_type, b.t, b.raw)
                for a, b in zip(native, python)):
            _fail("bag: the native reader's messages differ from the "
                  "Python reader's")
        n_msgs = len(native)
        t0 = time.perf_counter()
        kinds = [k for k, _, _ in iter_bag_events(bag)]
        t_events = time.perf_counter() - t0

        est = Estimator(_pipeline_cfg(torch, sim, f32=True), device=dev)
        writer = ResultWriter(csv, anchor_ecef=sim.anchor_ecef,
                              enu_to_ecef=sim.enu_to_ecef)
        est.attach_writer(writer)
        stamps = _frame_stamps(est)
        fix = _fix_keys(est)
        LAUNCHES.clear()
        t0 = time.time()
        replay_bag(bag, est)
        _sync(torch, dev)
        t_run = time.time() - t0
        launches = dict(LAUNCHES)
        writer.close()
        errs = _pipeline_gate(est, sim, launches, "bag replay gate",
                              fix["keys"])
        rows = np.loadtxt(csv, delimiter=",", skiprows=1, ndmin=2)
        gt_rows = np.loadtxt(gt, delimiter=",", skiprows=1, ndmin=2)
        bag_bytes = os.path.getsize(bag)

    # one row per IMU sample after the first solved frame, time-ordered,
    # and every 10 Hz ground-truth point (1 s after it) associated within
    # evaluate.py's 2.5 ms
    t_first = est.trajectory[0][0]
    n_expected = int(np.sum(sim.imu_t > t_first))
    times = rows[:, 0] * 1e-9
    keep = gt_rows[:, 0] > t_first + 1.0
    m = evaluate_trajectory(times, rows[:, 1:4], gt_rows[keep, 0],
                            gt_rows[keep, 1:4], align=False)
    fails = []
    if len(rows) != n_expected:
        fails.append(f"{len(rows)} CSV rows for {n_expected} IMU samples")
    if not bool(np.all(np.diff(times) > 0)):
        fails.append("CSV rows are not time-ordered")
    if m.n_associated != int(keep.sum()) or not m.mae_3d < 0.05:
        fails.append(f"CSV vs ground truth: {m.n_associated} of "
                     f"{int(keep.sum())} associated, 3-D MAE {m.mae_3d}")
    if kinds.count("imu") != len(sim.imu_t):
        fails.append("the bag does not hold every IMU sample")
    if fails:
        _fail("bag replay: " + "; ".join(fails))
    steady = np.diff(np.asarray(stamps))[PIPE_WARMUP:]
    out = dict(
        frames_per_s=1.0 / float(np.mean(steady)),
        median_ms=1e3 * float(np.median(steady)),
        p90_ms=1e3 * float(np.percentile(steady, 90)),
        frames_timed=int(len(steady)), n_frames_total=len(stamps),
        duration_s=duration, bag_bytes=bag_bytes, messages=n_msgs,
        write_s=t_write, native_parse_ms_per_msg=1e3 * t_native / n_msgs,
        python_parse_ms_per_msg=1e3 * t_python / n_msgs,
        decode_ms_per_msg=1e3 * t_events / n_msgs, csv_rows=len(rows),
        csv_mae_3d_m=m.mae_3d, csv_associated=m.n_associated,
        max_err_last10_m=max(errs), n_fixed_dd=len(est._last_fix),
        launches=launches,
        launches_per_frame={k: v / len(stamps) for k, v in launches.items()},
        replay_s=t_run)
    print(f"phase 7: bag replay {duration:g} s (bz2, native reader) f32 on "
          f"{card}: {json.dumps(out)}", flush=True)
    return out


def _blob_frames(torch, dev, n_frames, H, W, n_blobs, seed=0):
    """Frames of a texture of Gaussian blobs made from ``seed``: frame f is
    the texture under T_f(x) = R(θ_f)(x − c) + c + t_f (θ_f, t_f grow by
    FE_ROT_PER_FRAME and FE_SHIFT_PER_FRAME per frame; c the image center),
    rendered analytically in float64 on ``dev``, with a right image shifted
    left by FE_DISPARITY.  Returns host [(left, right)] and the warps
    [(R_f, t_f)]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    margin = 150.0
    u = np.stack([rng.uniform(-margin, W + margin, n_blobs),
                  rng.uniform(-margin, H + margin, n_blobs)], -1)
    amp = torch.tensor(rng.uniform(0.3, 1.0, n_blobs), device=dev)
    sig = torch.tensor(rng.uniform(1.5, 3.0, n_blobs), device=dev)
    c = np.array([W / 2.0, H / 2.0])
    r = 14                                  # 4.7 σ of the widest blob
    off = torch.arange(-r, r + 1, device=dev)

    def render(centers):
        cen = torch.tensor(centers, device=dev)
        base = torch.round(cen).long()
        xs = (base[:, 0, None, None] + off[None, None, :]).expand(-1, 2 * r
                                                                  + 1, -1)
        ys = (base[:, 1, None, None] + off[None, :, None]).expand(-1, -1, 2
                                                                  * r + 1)
        d2 = ((xs - cen[:, 0, None, None]) ** 2
              + (ys - cen[:, 1, None, None]) ** 2)
        val = amp[:, None, None] * torch.exp(-d2 / (2 * sig[:, None, None]
                                                    ** 2))
        ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
        img = torch.zeros(H * W, dtype=torch.float64, device=dev)
        img.index_add_(0, (ys * W + xs)[ok], val[ok])
        return img.reshape(H, W).cpu().numpy()

    frames, warps = [], []
    for f in range(n_frames):
        th = FE_ROT_PER_FRAME * f
        t = np.asarray(FE_SHIFT_PER_FRAME) * f
        R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        centers = (u - c - t) @ R + c           # T_f⁻¹ of each blob center
        frames.append((render(centers),
                       render(centers - [FE_DISPARITY, 0.0])))
        warps.append((R, t))
    return frames, warps


def _warp_px(warps, f, g, x):
    """Pixels ``x`` (N, 2) of frame f mapped to frame g: T_g⁻¹(T_f(x))."""
    import numpy as np
    c = np.array([FE_W / 2.0, FE_H / 2.0])
    (Rf, tf), (Rg, tg) = warps[f], warps[g]
    u = (x - c) @ Rf.T + c + tf
    return (u - c - tg) @ Rg + c


def _run_frontend(torch, dev, frames, cam):
    """The frames through a TrackerFrontend on ``dev``: per frame the
    returned ids and rays and the live slots' pixels, and the host ms of
    each frame (synchronized)."""
    from rtk_visual_inertial_navigation_tpu_torch.frontend.tracker_frontend \
        import TrackerFrontend
    fe = TrackerFrontend(cam, max_cnt=FE_MAX_CNT, min_dist=FE_MIN_DIST,
                         device=dev)
    out, ms = [], []
    for left, right in frames:
        t0 = time.perf_counter()
        ids, xy, ids_r, xy_r = fe.process(left, img_right=right)
        _sync(torch, dev)
        ms.append(1e3 * (time.perf_counter() - t0))
        live = fe.ok & (fe.ids >= 0)
        out.append(dict(ids=ids, xy=xy, ids_r=ids_r, xy_r=xy_r,
                        pid=fe.ids[live].copy(), pts=fe.pts[live].copy()))
    return out, ms


def phase_frontend(torch, dev, card, n_frames=FE_FRAMES):
    """Phase 8a: the image frontend at full width on the card against the
    port's CPU frontend on the same frames and against the known warp."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from rtk_visual_inertial_navigation_tpu_torch.frontend.tracker_frontend \
        import TrackerFrontend
    from rtk_visual_inertial_navigation_tpu_torch.models import \
        PinholeCamera

    t0 = time.time()
    frames, warps = _blob_frames(torch, dev, n_frames, FE_H, FE_W,
                                 FE_BLOBS)
    t_render = time.time() - t0
    cam = PinholeCamera(fx=FE_FOCAL, fy=FE_FOCAL, cx=FE_W / 2.0,
                        cy=FE_H / 2.0)
    card_out, card_ms = _run_frontend(torch, dev, frames, cam)
    t0 = time.time()
    cpu_out, cpu_ms = _run_frontend(torch, "cpu", frames, cam)
    t_cpu = time.time() - t0

    # the card against the CPU: the same ids, points within FE_PX_TOL
    px_diff = 0.0
    for f, (a, b) in enumerate(zip(card_out, cpu_out)):
        for k in ("ids", "ids_r", "pid"):
            if not np.array_equal(a[k], b[k]):
                _fail(f"frontend frame {f}: {k} on the card differ from "
                      f"the cpu's")
        px_diff = max(px_diff, float(np.abs(a["pts"] - b["pts"]).max(
            initial=0.0)), FE_FOCAL * float(np.abs(a["xy_r"] - b["xy_r"])
                                           .max(initial=0.0)))
    if not px_diff <= FE_PX_TOL:
        _fail(f"frontend: card and cpu points differ by {px_diff:.3e} px")

    # the tracks against the known warp, and the right matches against the
    # disparity
    errs, errs_r, n_tracked = [], [], []
    for f in range(1, n_frames):
        a, b = card_out[f - 1], card_out[f]
        common, ia, ib = np.intersect1d(a["pid"], b["pid"],
                                        return_indices=True)
        n_tracked.append(len(common))
        truth = _warp_px(warps, f - 1, f, a["pts"][ia])
        errs.append(np.linalg.norm(b["pts"][ib] - truth, axis=1))
        left = dict(zip(b["pid"], b["pts"]))
        right = b["xy_r"] * FE_FOCAL + [FE_W / 2.0, FE_H / 2.0]
        errs_r.append([np.linalg.norm(p - left[i] + [FE_DISPARITY, 0.0])
                       for i, p in zip(b["ids_r"], right)])
    errs = np.concatenate(errs)
    errs_r = np.concatenate([np.asarray(e) for e in errs_r])
    med, med_r = float(np.median(errs)), float(np.median(errs_r))
    if not (med < FE_TRUTH_TOL_PX and med_r < FE_TRUTH_TOL_PX):
        _fail(f"frontend: median error against the warp {med:.4f} px, "
              f"right against the disparity {med_r:.4f} px")
    if min(n_tracked) < FE_MAX_CNT // 4:
        _fail(f"frontend: as few as {min(n_tracked)} tracks survive a frame")

    # launches and host syncs per frame, on a fresh frontend: the first
    # two frames untraced, then FE_PROFILE_FRAMES traced
    fe = TrackerFrontend(cam, max_cnt=FE_MAX_CNT, min_dist=FE_MIN_DIST,
                         device=dev)
    for left, right in frames[:2]:
        fe.process(left, img_right=right)
    _sync(torch, dev)
    prof_frames = frames[2:2 + FE_PROFILE_FRAMES]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for left, right in prof_frames:
            fe.process(left, img_right=right)
        _sync(torch, dev)
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = sum(1 for e in ev if "Memcpy" in e.name or "Memset" in e.name)
    fe2 = TrackerFrontend(cam, max_cnt=FE_MAX_CNT, min_dist=FE_MIN_DIST,
                          device=dev)
    for left, right in frames[:2]:
        fe2.process(left, img_right=right)
    _sync(torch, dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for left, right in prof_frames:
                fe2.process(left, img_right=right)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum(1 for w in caught if "synchroniz" in str(w.message))
    n_prof = len(prof_frames)
    out = dict(
        shape=[FE_H, FE_W], frames=n_frames, blobs=FE_BLOBS,
        max_cnt=FE_MAX_CNT, min_dist=FE_MIN_DIST,
        ms_per_frame_median=float(np.median(card_ms[1:])),
        ms_per_frame_mean=float(np.mean(card_ms[1:])),
        first_frame_ms=card_ms[0],
        cpu_ms_per_frame_median=float(np.median(cpu_ms[1:])),
        kernels_per_frame=(len(ev) - copies) / n_prof,
        copies_per_frame=copies / n_prof,
        host_syncs_per_frame=syncs / n_prof,
        max_px_diff_card_vs_cpu=px_diff, px_tol=FE_PX_TOL,
        median_err_vs_warp_px=med, p90_err_vs_warp_px=float(
            np.percentile(errs, 90)),
        median_right_err_px=med_r,
        tracks_per_frame_min=int(min(n_tracked)),
        tracks_per_frame_mean=float(np.mean(n_tracked)),
        right_matches_per_frame=float(np.mean([len(o["ids_r"])
                                               for o in card_out[1:]])),
        ids_total=int(max(o["pid"].max(initial=-1) for o in card_out) + 1),
        render_s=t_render, cpu_s=t_cpu)
    print(f"phase 8a: frontend {FE_W}x{FE_H} stereo, card vs cpu and vs "
          f"the warp, on {card}: {json.dumps(out)}", flush=True)
    return out


def _render_wiring(sim, fi):
    """tests/test_tracker_frontend.py's renderer: a Gaussian blob image of
    the landmarks visible at camera frame ``fi``."""
    import numpy as np
    H, W, F = WIRE_H, WIRE_W, WIRE_F
    img = np.zeros((H, W))
    yy, xx = np.mgrid[0:H, 0:W]
    for lm in range(sim.landmarks.shape[0]):
        if not sim.obs_valid[fi, lm]:
            continue
        u = F * sim.obs_xy[fi, lm, 0] + W / 2
        v = F * sim.obs_xy[fi, lm, 1] + H / 2
        if 5 < u < W - 5 and 5 < v < H - 5:
            img += np.exp(-((yy - v) ** 2 + (xx - u) ** 2) / (2 * 2.0 ** 2))
    return img


def phase_wiring(torch, dev, card):
    """Phase 8b: images -> TrackerFrontend -> Estimator on the card at
    tests/test_tracker_frontend.py:34-63's configuration and bounds."""
    import numpy as np

    from rtk_visual_inertial_navigation_tpu_torch.config import \
        EstimatorConfig
    from rtk_visual_inertial_navigation_tpu_torch.frontend.tracker_frontend \
        import TrackerFrontend
    from rtk_visual_inertial_navigation_tpu_torch.models import \
        PinholeCamera
    from rtk_visual_inertial_navigation_tpu_torch.ops import lie
    from rtk_visual_inertial_navigation_tpu_torch.ops.launches import \
        LAUNCHES
    from rtk_visual_inertial_navigation_tpu_torch.pipeline import Estimator
    from rtk_visual_inertial_navigation_tpu_torch.sim import (SimConfig,
                                                              simulate)

    sim = simulate(SimConfig(duration=6.0, imu_rate=200.0, cam_rate=10.0,
                             n_landmarks=50, n_sats=4, seed=5))
    cam = PinholeCamera(fx=WIRE_F, fy=WIRE_F, cx=WIRE_W / 2, cy=WIRE_H / 2)
    fe = TrackerFrontend(cam, max_cnt=48, min_dist=10, device=dev)
    q_ic = lie.rot_to_quat(torch.from_numpy(sim.cfg.r_ic)).numpy()
    cfg = EstimatorConfig(nf=8, nl=64, nb=1, max_obs=320, imu_capacity=64,
                          average_imu=40, qic=np.tile(q_ic, (2, 1)),
                          tic=np.tile(sim.cfg.t_ic, (2, 1)))
    est = Estimator(cfg, device=dev)
    LAUNCHES.clear()
    fe_ms, est_ms = [], []
    t0 = time.time()
    cam_ptr = 0
    for i, t in enumerate(sim.imu_t):
        est.process_imu(t, sim.acc[i], sim.gyr[i])
        if cam_ptr < len(sim.cam_idx) and sim.cam_idx[cam_ptr] == i:
            img = _render_wiring(sim, cam_ptr)
            t1 = time.perf_counter()
            ids, xy = fe.process(img)
            t2 = time.perf_counter()
            if len(ids) >= 5:
                est.process_image(t, ids, xy)
            fe_ms.append(1e3 * (t2 - t1))
            est_ms.append(1e3 * (time.perf_counter() - t2))
            cam_ptr += 1
    _sync(torch, dev)
    t_run = time.time() - t0
    errs = np.asarray(
        [np.linalg.norm(p - sim.p[np.argmin(np.abs(sim.imu_t - t))])
         for (t, p, q, v) in est.trajectory])
    out = dict(initialized=bool(est.initialized),
               trajectory=len(est.trajectory),
               final_err_m=float(errs[-1]) if len(errs) else None,
               median_err_m=float(np.median(errs)) if len(errs) else None,
               frames=cam_ptr, ids_total=int(fe._next_id),
               frontend_ms_per_frame=float(np.median(fe_ms[1:])),
               estimator_ms_per_frame=float(np.median(est_ms[1:])),
               launches=dict(LAUNCHES), run_s=t_run)
    print(f"phase 8b: images -> TrackerFrontend -> Estimator (240x320, "
          f"max_cnt 48, 6 s, f64 step) on {card}: {json.dumps(out)}",
          flush=True)
    # the bounds of tests/test_tracker_frontend.py:58-63
    if not (est.initialized and len(est.trajectory) > 30
            and errs[-1] < 1.5 and np.median(errs) < 0.8):
        _fail("wiring: the trajectory misses the test's bounds (final < "
              "1.5 m, median < 0.8 m, > 30 entries)")
    return out


def phase_demo(torch, dev, card):
    """Phase 9: the demo's ``main`` on the card in each mode."""
    import numpy as np

    from rtk_visual_inertial_navigation_tpu_torch.examples import \
        run_sim_demo
    from rtk_visual_inertial_navigation_tpu_torch.ops.launches import \
        LAUNCHES

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode in DEMO_MODES:
            LAUNCHES.clear()
            t0 = time.time()
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                r = run_sim_demo.main(["--mode", mode, "--duration",
                                       str(DEMO_DURATION), "--out", tmp,
                                       "--device", str(dev)])
            t_run = time.time() - t0
            finite = bool(np.isfinite(r["positions"]).all())
            out = dict(initialized=r["initialized"], frames=r["frames"],
                       csv_rows=r["csv_rows"],
                       imu_samples=r["imu_samples_after_first"],
                       plane_rmse_m=r["plane_rmse"],
                       height_rmse_m=r["height_rmse"], mae_3d_m=r["mae_3d"],
                       rtk_fixed=r["rtk_fixed"], finite=finite,
                       npz=os.path.exists(os.path.join(
                           tmp, f"{mode}_viz.npz")),
                       launches=dict(LAUNCHES), run_s=t_run,
                       timing=r["timing"].splitlines())
            print(f"phase 9: demo --mode {mode} --duration "
                  f"{DEMO_DURATION:g} on {card}: {json.dumps(out)}",
                  flush=True)
            if not (r["initialized"] and r["frames"] > 0 and finite
                    and r["csv_rows"] == r["imu_samples_after_first"] > 0
                    and out["npz"]):
                _fail(f"demo {mode}: not initialized, non-finite positions "
                      f"or not one CSV row per IMU sample")
            res[mode] = out
    return res


def _free_port():
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def phase_sharded_one(torch, dev, card, flag):
    """10a: the multihost layer at world size 1 (NCCL), torchrun's way of
    joining, on phase 3's problem."""
    import torch.distributed as dist

    from rtk_visual_inertial_navigation_tpu_torch.core.state import \
        TangentLayout
    from rtk_visual_inertial_navigation_tpu_torch.ops.launches import \
        LAUNCHES
    from rtk_visual_inertial_navigation_tpu_torch.parallel import (
        distribute_local_rtk_problems, global_mesh, initialize_from_env,
        multihost_rtk_solve)
    from rtk_visual_inertial_navigation_tpu_torch.solver.gauss_newton \
        import DoglegConfig

    F = FLAGSHIP
    lay = TangentLayout(nf=F["nf"], nl=F["nl"], nb=F["nb"], nc=2)
    cfg = DoglegConfig(max_iters=8)
    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    os.environ.update(env)
    try:
        if not initialize_from_env():
            _fail("phase 10a: initialize_from_env did not join a group")
        backend = dist.get_backend()
        mesh = global_mesh(fp=1)
        probs = distribute_local_rtk_problems(mesh, flag["probs"])
        LAUNCHES.clear()
        t0 = time.time()
        out = multihost_rtk_solve(mesh, probs, lay, cfg, F["cap"])
        torch.cuda.synchronize()
        t_first = time.time() - t0
        launches = dict(LAUNCHES)
        gate = _flagship_gate(torch, flag["probs"], out, launches,
                              "phase 10a")
        ref = flag["out"]
        diff = {k: (a - b).abs().max().item() for k, a, b in (
            ("p", out[0].p, ref[0].p),
            ("phase_bias", out[0].phase_bias, ref[0].phase_bias),
            ("X", out[4], ref[4]))}
        # at world size 1 the all-reduce is a copy and the decisions are
        # the solver's own: the result is phase 3's, within phase 3's own
        # repeat spread (0 so far: bitwise)
        tol = flag["repeat_spread_m"]
        print(f"phase 10a: multihost_rtk_solve at world size 1 ({backend}) "
              f"B={BATCH} f32: {json.dumps(gate)}; first call "
              f"{t_first:.2f} s; launches {json.dumps(launches)}; max |diff| "
              f"against phase 3 {json.dumps(diff)} (tolerance {tol:.3e}, "
              f"phase 3's repeat spread)", flush=True)
        if not max(diff.values()) <= tol:
            _fail(f"phase 10a: the world-size-1 solve differs from phase 3 "
                  f"by more than {tol:.3e}: {diff}")
        reps = 3
        t0 = time.time()
        for _ in range(reps):
            multihost_rtk_solve(mesh, probs, lay, cfg, F["cap"])
        torch.cuda.synchronize()
        dt = time.time() - t0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k)
    ups = BATCH * reps / dt
    print(f"phase 10a: {ups:.3f} flagship updates/s through the collective "
          f"path at world size 1 ({reps} solves, "
          f"{dt / reps * 1e3:.1f} ms per solve; phase 3: "
          f"{flag['updates_per_s']:.3f}) on {card}", flush=True)
    return dict(gate, launches=launches, diff=diff, updates_per_s=ups)


def _phase10_rank(rank):
    """10b and 10c in one rank of a gloo group of two on the one card."""
    import torch
    from torch.utils._pytree import tree_map

    from rtk_visual_inertial_navigation_tpu_torch.core.state import \
        TangentLayout
    from rtk_visual_inertial_navigation_tpu_torch.ops.launches import \
        LAUNCHES
    from rtk_visual_inertial_navigation_tpu_torch.parallel import (
        distribute_local_problems, distribute_local_rtk_problems,
        gather_rtk_results, gather_vi_results, global_mesh,
        make_synthetic_rtk_windows, make_synthetic_windows,
        multihost_rtk_solve, multihost_vi_solve)
    from rtk_visual_inertial_navigation_tpu_torch.solver.gauss_newton \
        import DoglegConfig
    from rtk_visual_inertial_navigation_tpu_torch import full_precision

    full_precision()
    mesh = global_mesh(fp=2)
    res = dict(rank=rank)

    # 10b: phase 3's problem, rows and chains split over fp = 2
    F = FLAGSHIP
    lay = TangentLayout(nf=F["nf"], nl=F["nl"], nb=F["nb"], nc=2)
    cfg = DoglegConfig(max_iters=8)
    probs = make_synthetic_rtk_windows(0, BATCH, dtype=torch.float32,
                                       device="cuda", **F)
    mine = distribute_local_rtk_problems(mesh, probs)
    rows = mine.obs_valid.sum(1)
    frame_rows = torch.zeros((BATCH, F["nf"]), dtype=torch.int64,
                             device=rows.device).scatter_add_(
        1, mine.f_ids, mine.obs_valid.long())
    lm_rows = torch.zeros((BATCH, F["nl"]), dtype=torch.int64,
                          device=rows.device).scatter_add_(
        1, mine.l_ids, mine.obs_valid.long())
    res.update(obs_rows=mine.f_ids.shape[1], chains=mine.st.left.shape[1],
               frames_without_rows=int((frame_rows == 0).sum()),
               landmarks_without_rows=int((lm_rows == 0).sum()))
    LAUNCHES.clear()
    t0 = time.time()
    out = multihost_rtk_solve(mesh, mine, lay, cfg, F["cap"])
    torch.cuda.synchronize()
    res["rtk_first_s"] = time.time() - t0
    res["rtk_launches"] = dict(LAUNCHES)
    win, hid, cost, nacc, X = gather_rtk_results(mesh, out)
    res["rtk"] = dict(p=win.p, phase_bias=win.phase_bias, nacc=nacc, X=X,
                      truth_p=probs.truth.p)
    reps = 2
    t0 = time.time()
    for _ in range(reps):
        multihost_rtk_solve(mesh, mine, lay, cfg, F["cap"])
    torch.cuda.synchronize()
    res["rtk_updates_per_s"] = BATCH * reps / (time.time() - t0)
    del probs, mine, out, win, hid, X

    # 10b in f64, F64_ITERS iterations each, for the parent to hold to the
    # single-process f64 solve
    p64 = distribute_local_rtk_problems(mesh, make_synthetic_rtk_windows(
        0, BATCH, dtype=torch.float64, device="cuda", **F))
    res["rtk64"] = {}
    for iters in F64_ITERS:
        win, hid, cost, nacc, X = gather_rtk_results(
            mesh, multihost_rtk_solve(mesh, p64, lay,
                                      DoglegConfig(max_iters=iters),
                                      F["cap"]))
        res["rtk64"][iters] = dict(p=win.p, phase_bias=win.phase_bias,
                                   hid_p=hid.p, cost=cost, nacc=nacc, X=X)
    del p64, win, hid, X

    # 10c: phase 5's VI windows, rows split over fp = 2
    nf, nl = VI["nf"], VI["nl"]
    vlay = TangentLayout(nf=nf, nl=nl, nb=1, nc=2)
    vcfg = DoglegConfig(max_iters=8, schur_nl=nl,
                        reduced_keep=tuple(range(15 * nf)))
    vprobs = tree_map(lambda x: x.float() if x.is_floating_point() else x,
                      make_synthetic_windows(0, VI_BATCH,
                                             dtype=torch.float64,
                                             device="cuda", **VI))
    vmine = distribute_local_problems(mesh, vprobs)
    LAUNCHES.clear()
    t0 = time.time()
    vout = multihost_vi_solve(mesh, vmine, vlay, vcfg)
    torch.cuda.synchronize()
    res["vi_first_s"] = time.time() - t0
    res["vi_launches"] = dict(LAUNCHES)
    state, cost, nacc = gather_vi_results(mesh, vout)
    res["vi"] = dict(
        window_err=(state.p - vprobs.truth.p).norm(dim=-1)[:, 1:]
        .max(dim=1).values, cost=cost, nacc=nacc, obs_rows=vmine.f_ids
        .shape[1])
    return res


def phase_sharded_gloo(torch, card, flag, ones, vres):
    """10b and 10c: two ranks on the one card over gloo (dp=1 x fp=2)."""
    import numpy as np

    from rtk_visual_inertial_navigation_tpu_torch.parallel.multihost \
        import run_ranks

    t0 = time.time()
    ranks = run_ranks(_phase10_rank, 2, device="cuda", backend="gloo")
    t_all = time.time() - t0
    F = FLAGSHIP
    probs = flag["probs"]
    fails = []
    for r in ranks:
        for name in ("proj_segments",) + CHOL_KERNELS:
            if not r["rtk_launches"].get(name, 0):
                fails.append(f"rank {r['rank']}: the flagship solve never "
                             f"launched the {name} kernel")
        for name in CHOL_KERNELS:
            if not r["vi_launches"].get(name, 0):
                fails.append(f"rank {r['rank']}: the VI solve never "
                             f"launched the {name} kernel")
    if fails:
        _fail("phase 10b/c: " + "; ".join(fails))

    # 10b: the gathered flagship result, on rank 0 (every rank holds it)
    g = ranks[0]["rtk"]
    T = lambda a: torch.from_numpy(a).to(probs.truth.p.device)
    if not torch.equal(T(g["truth_p"]), probs.truth.p):
        _fail("phase 10b: the ranks' problem is not phase 3's")
    win = probs.truth._replace(p=T(g["p"]), phase_bias=T(g["phase_bias"]))
    out = (win, None, None, T(g["nacc"]), T(g["X"]))
    gate = _flagship_gate(torch, probs, out, ranks[0]["rtk_launches"],
                          "phase 10b")
    ref = flag["out"]
    diff = dict(p=(win.p - ref[0].p).abs().max().item(),
                phase_bias=(win.phase_bias - ref[0].phase_bias).abs().max()
                .item(),
                X_rel=((out[4] - ref[4]).abs().max()
                       / ref[4].abs().max()).item())
    # a gate, not the check of the reduction: the observations are
    # noiseless, so a wrong sum of the shards' blocks would still converge
    # near the truth; the f64 solves below hold the reduction.  Here the
    # same f32 solve with its sums in another order (per fp shard, then
    # across the two) lands within phase 3's own error against the truth
    # (information only for X)
    tol = dict(p=flag["gate"]["max_pos_err_m"],
               phase_bias=flag["gate"]["max_amb_err_cyc"])
    shards = {k: [r[k] for r in ranks] for k in (
        "obs_rows", "chains", "frames_without_rows",
        "landmarks_without_rows")}
    ups = ranks[0]["rtk_updates_per_s"]
    print(f"phase 10b: multihost_rtk_solve dp=1 x fp=2, two processes on "
          f"one card over gloo (collectives through host memory) B={BATCH} "
          f"f32: {json.dumps(gate)}; shards {json.dumps(shards)}; launches "
          f"per rank {json.dumps([r['rtk_launches'] for r in ranks])}; "
          f"first call {max(r['rtk_first_s'] for r in ranks):.2f} s; max "
          f"|diff| against 10a {json.dumps(diff)} (tolerance "
          f"{json.dumps(tol)}, phase 3's error against the truth)",
          flush=True)
    for k in tol:
        if not diff[k] <= tol[k]:
            _fail(f"phase 10b: {k} differs from 10a by {diff[k]:.3e} > "
                  f"{tol[k]:.3e}")
    f64 = _check_f64_shards(torch, probs.truth.p.device, ranks[0]["rtk64"])
    print(f"phase 10b: f64, dp=1 x fp=2 against the single-process f64 "
          f"solve of the same problem, by dogleg iterations: "
          f"{json.dumps(f64)} (tolerance {F64_ATOL:g} m / cycle, X "
          f"{F64_ATOL:g} of its largest, cost rtol {F64_COST_RTOL:g} atol "
          f"{F64_COST_ATOL:g})",
          flush=True)
    print(f"phase 10b: {ups:.3f} flagship updates/s over gloo through host "
          f"memory, two processes on one card (10a at world size 1: "
          f"{ones['updates_per_s']:.3f}; phase 3: "
          f"{flag['updates_per_s']:.3f}) on {card}", flush=True)

    # 10c: each VI window held to phase 5's CPU f32 solve of it
    v = ranks[0]["vi"]
    worst = v["window_err"]
    vgate = dict(
        cost_finite=bool(np.isfinite(v["cost"]).all()),
        nacc_min=int(v["nacc"].min()), max_pos_err_m=float(worst.max()),
        frac_windows_err_gt_1cm=float((worst > 0.01).mean()),
        max_window_err_diff_vs_cpu_m=float(
            np.abs(worst - vres["cpu_window_err_m"]).max()),
        obs_rows_per_rank=[r["vi"]["obs_rows"] for r in ranks])
    print(f"phase 10c: multihost_vi_solve dp=1 x fp=2 over gloo, B="
          f"{VI_BATCH} f32: {json.dumps(vgate)}; launches per rank "
          f"{json.dumps([r['vi_launches'] for r in ranks])}; first call "
          f"{max(r['vi_first_s'] for r in ranks):.2f} s; the group's run "
          f"{t_all:.1f} s on {card}", flush=True)
    fails = []
    if not vgate["cost_finite"]:
        fails.append("a cost is not finite")
    if vgate["nacc_min"] < 1:
        fails.append("a window accepted no step")
    if not vgate["max_window_err_diff_vs_cpu_m"] <= VI_ERR_TOL_M:
        fails.append(f"a window's error differs from the CPU solve's by > "
                     f"{VI_ERR_TOL_M} m")
    if vgate["max_pos_err_m"] > 0.05:
        fails.append("max frame-1+ position error > 0.05 m")
    if vgate["frac_windows_err_gt_1cm"] > 1 / 4:
        fails.append("more than 1/4 of the windows err > 1 cm")
    if fails:
        _fail("phase 10c gate: " + "; ".join(fails))
    return dict(rtk=dict(gate, diff=diff, f64=f64, updates_per_s=ups,
                         launches=[r["rtk_launches"] for r in ranks]),
                vi=dict(vgate, launches=[r["vi_launches"] for r in ranks]),
                shards=shards)


def _check_f64_shards(torch, dev, got):
    """10b's gathered f64 results (``got``: by dogleg iterations) against
    the single-process f64 solve of the same problem; fails the script
    past F64_ATOL / F64_COST_RTOL, else returns the differences."""
    from rtk_visual_inertial_navigation_tpu_torch.core.state import \
        TangentLayout
    from rtk_visual_inertial_navigation_tpu_torch.parallel.problems_gnss \
        import batched_rtk_solve, make_synthetic_rtk_windows
    from rtk_visual_inertial_navigation_tpu_torch.solver.gauss_newton \
        import DoglegConfig

    F = FLAGSHIP
    lay = TangentLayout(nf=F["nf"], nl=F["nl"], nb=F["nb"], nc=2)
    probs = make_synthetic_rtk_windows(0, BATCH, dtype=torch.float64,
                                       device=dev, **F)
    out = {}
    for iters in F64_ITERS:
        g = {k: torch.from_numpy(v).to(dev) for k, v in got[iters].items()}
        win, hid, cost, nacc, X = batched_rtk_solve(
            probs, lay, DoglegConfig(max_iters=iters), F["cap"], device=dev)
        d = dict(p=(g["p"] - win.p).abs().max().item(),
                 phase_bias=(g["phase_bias"] - win.phase_bias).abs().max()
                 .item(),
                 hid_p=(g["hid_p"] - hid.p).abs().max().item(),
                 X_rel=((g["X"] - X).abs().max()
                        / X.abs().max().clamp_min(1.0)).item(),
                 cost=(g["cost"] - cost).abs().max().item(),
                 cost_max=cost.abs().max().item(),
                 nacc_equal=bool(torch.equal(g["nacc"], nacc)),
                 max_pos_err_m=(win.p - probs.truth.p).norm(dim=-1).max()
                 .item())
        out[iters] = d
        bad = [k for k in ("p", "phase_bias", "hid_p", "X_rel")
               if not d[k] <= F64_ATOL]
        # assert_allclose's rule: a converged noiseless cost is roundoff
        if not bool(((g["cost"] - cost).abs()
                     <= F64_COST_ATOL + F64_COST_RTOL * cost.abs()).all()):
            bad.append("cost")
        # the first step is accepted or not by a wide margin; once the
        # noiseless solve has converged, cost decreases are roundoff and
        # their accept flags coin flips, so later counts may differ
        if iters == 1 and not d["nacc_equal"]:
            bad.append("nacc_equal")
        if bad:
            _fail(f"phase 10b f64, {iters} iterations: {bad} differ from "
                  f"the single-process solve: {d}")
    return out


def phase_dryrun(torch, card):
    from rtk_visual_inertial_navigation_tpu_torch.parallel.dryrun import \
        dryrun_multichip
    n = torch.cuda.device_count()
    t0 = time.time()
    out = dryrun_multichip(n)
    print(f"phase 10d: dryrun_multichip({n}) on cuda: {json.dumps(out)} in "
          f"{time.time() - t0:.1f} s on {card}", flush=True)


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
    from rtk_visual_inertial_navigation_tpu_torch import native
    t0 = time.time()
    native._get_lib(), native._get_bag_lib()
    print(f"phase 1: built the native codec and bag reader (g++) in "
          f"{time.time() - t0:.1f} s", flush=True)
    full_precision()

    kres = phase_kernel_checks(torch, dev, card)
    phase_shard_kernel_checks(torch, dev)
    flag = phase_flagship(torch, dev, card)
    launches = flag["launches"]
    phase_small_reference(torch, dev)
    cres = phase_chol(torch, card)
    vres = phase_vi(torch, dev, card)
    pres = phase_pipeline(torch, dev, card)
    bres = phase_bag(torch, dev, card)
    phase_frontend(torch, dev, card)
    wres = phase_wiring(torch, dev, card)
    dres = phase_demo(torch, dev, card)
    t0 = time.time()
    ones = phase_sharded_one(torch, dev, card, flag)
    sres = phase_sharded_gloo(torch, card, flag, ones, vres)
    phase_dryrun(torch, card)
    print(f"phase 10: {time.time() - t0:.1f} s in all", flush=True)

    n = launches.get("proj_segments", 0)
    if n == 0:
        _fail("the main path never launched the proj_segments kernel")
    for name in CHOL_KERNELS:
        if not launches.get(name, 0) or not vres["launches"].get(name, 0):
            _fail(f"a window solve never launched the {name} kernel")
    fl, vi, pl = cres["flagship"], cres["vi"], cres["pipeline"]
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
        launches_sharded_world1=ones["launches"]["proj_segments"],
        launches_sharded_fp2_per_rank=[
            r["proj_segments"] for r in sres["rtk"]["launches"]],
        phase="phase 3 (flagship solve) and phase 10 (the sharded flagship "
              "solve: 10a at world size 1, 10b per rank of fp=2); timed in "
              "phase 2")]
    # the Cholesky kernels: numbers at the flagship shape (B=32, n=339;
    # library: cholesky_ex for the factor, cholesky_solve for the solve),
    # the VI shape's and the 16-column solve's beside them
    for name, src, key in (("chol_lanes", "chol_lanes.cu", "factor"),
                           ("chol_lanes_solve", "chol_lanes_solve.cu",
                            "solve")):
        pick = (lambda r: r["factor"]) if key == "factor" else \
            (lambda r: r["solve"][1])
        main = pick(fl)
        extra = dict(vi_shape=dict(B=vi["B"], n=vi["n"], **pick(vi)),
                     pipeline_shape=dict(B=pl["B"], n=pl["n"], **pick(pl)),
                     launches_per_pipeline_replay=pres["launches"][name],
                     launches_per_pipeline_frame=pres[
                         "launches_per_frame"][name],
                     launches_per_bag_replay=bres["launches"][name],
                     launches_per_bag_frame=bres["launches_per_frame"][name],
                     launches_frontend_wiring=wres["launches"].get(name, 0),
                     launches_demo={m: r["launches"].get(name, 0)
                                    for m, r in dres.items()},
                     launches_sharded_world1=ones["launches"][name],
                     launches_sharded_fp2_per_rank=[
                         r[name] for r in sres["rtk"]["launches"]],
                     launches_sharded_vi_fp2_per_rank=[
                         r[name] for r in sres["vi"]["launches"]])
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
            phase="phases 3, 5, 6, 7 and 10 (the f32 step and covariance "
                  "of the window solves, the f32 step of the pipeline's and "
                  "the bag replay's solves, and of the sharded flagship and "
                  "VI solves); timed in phase 4"))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
