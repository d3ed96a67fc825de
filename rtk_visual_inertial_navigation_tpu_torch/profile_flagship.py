"""Where the time of a batched window solve goes, on one GPU.

    python3 -m rtk_visual_inertial_navigation_tpu_torch.profile_flagship \
        [--vi | --pipeline] [--batch B] [--trace PATH]

Runs the full-width flagship solve (nf=11, nl=352, nobs=2816, cap=11,
ns=14, nb=16, f32, 8 dogleg iterations, B=32) or, with ``--vi``, the VI
sub-bench solve (nf=8, nl=64, nobs=448, 16 IMU samples, f32, 8 dogleg
iterations with landmark Schur and 120 kept reduced slots, B=256) once to
warm up, then:
  - times one solve by host clock around ``torch.cuda.synchronize()``;
  - counts the host syncs inside one solve (``set_sync_debug_mode``);
  - traces one solve with ``torch.profiler`` and prints the device-busy
    share (summed kernel time over wall time), the number of kernel
    launches, and the top kernels by device time;
  - writes the chrome trace to ``--trace`` if given (tens of MB).

With ``--pipeline`` it replays ``bench.py --pipeline``'s sequence through
the port's estimator (f32 step) to t = 10 s, then counts the host syncs
of the next 2 s of frames and traces the 4 s after them: device-busy
share, kernel launches per frame, top kernels.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
import warnings


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--vi", action="store_true",
                    help="profile the VI sub-bench solve instead")
    ap.add_argument("--batch", type=int, default=0,
                    help="windows per solve (default 32, or 256 with --vi)")
    ap.add_argument("--pipeline", action="store_true",
                    help="profile frames of the estimator pipeline instead")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    if args.pipeline:
        return _pipeline(args)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from .core.state import TangentLayout
    from .parallel import batched_vi_solve, make_synthetic_windows
    from .parallel.problems_gnss import (batched_rtk_solve,
                                         make_synthetic_rtk_windows)
    from .solver.gauss_newton import DoglegConfig

    card = _card()
    if args.vi:
        B = args.batch or 256
        lay = TangentLayout(nf=8, nl=64, nb=1, nc=2)
        cfg = DoglegConfig(max_iters=8, schur_nl=64,
                           reduced_keep=tuple(range(15 * 8)))
        probs = make_synthetic_windows(0, B, 8, 64, 448, 16,
                                       dtype=torch.float32)
        solve = lambda: batched_vi_solve(probs, lay, cfg)
    else:
        F = dict(nf=11, nl=352, nobs=2816, nsamp=8, cap=11, ns=14, nb=16)
        B = args.batch or 32
        lay = TangentLayout(nf=F["nf"], nl=F["nl"], nb=F["nb"], nc=2)
        cfg = DoglegConfig(max_iters=8)
        probs = make_synthetic_rtk_windows(0, B, dtype=torch.float32, **F)
        solve = lambda: batched_rtk_solve(probs, lay, cfg, F["cap"])

    solve()
    torch.cuda.synchronize()
    t0 = time.time()
    solve()
    torch.cuda.synchronize()
    wall = time.time() - t0

    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        solve()
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        solve()
        torch.cuda.synchronize()
        traced_wall = time.time() - t0
    if args.trace:
        prof.export_chrome_trace(args.trace)

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time for e in kernels)
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:25]
    print(json.dumps({
        "card": card, "cell": "vi" if args.vi else "flagship",
        "batch": B, "solve_s": wall,
        "updates_per_s": B / wall, "host_syncs_per_solve": syncs,
        "traced_solve_s": traced_wall, "device_kernel_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e6 / traced_wall,
        "kernel_launches": len(kernels),
        "proj_segments_ms": sum(t for n, (_, t) in by_name.items()
                                if "proj_segments" in n) / 1e3}))
    for name, (n, t) in top:
        print(f"{t / 1e3:10.3f} ms {n:6d}x  {name[:110]}")


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _pipeline(args):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .config import EstimatorConfig
    from .ops import lie
    from .pipeline import Estimator, replay
    from .sim import SimConfig, simulate

    sim = simulate(SimConfig(duration=16.0, imu_rate=200.0, cam_rate=2.0,
                             gnss_rate=2.0, n_landmarks=60, n_sats=10,
                             seed=0))
    q_ic = lie.rot_to_quat(torch.from_numpy(sim.cfg.r_ic)).numpy()
    # bench.py:56-65
    est = Estimator(EstimatorConfig(
        nf=10, nl=48, nb=32, max_obs=256, imu_capacity=128, average_imu=40,
        qic=np.tile(q_ic, (2, 1)), tic=np.tile(sim.cfg.t_ic, (2, 1)),
        anchor_ecef=sim.anchor_ecef, enu_to_ecef=sim.enu_to_ecef,
        max_gnss_pr=160, max_gnss_cp=160, max_gnss_dopp=160,
        min_sats_per_epoch=6, initial_gnss_boost_epochs=5,
        min_fix_continuity=1, fix_continue_threshold=3, use_gnss=True,
        use_doppler=True, use_rtd=True, use_rtk=True, use_n_resolve=True,
        solve_step_dtype="float32"))
    at = lambda t: int(np.searchsorted(sim.imu_t, t))
    replay(est, sim, stop=at(10.0))
    frames = []
    count = lambda i: frames.append(i)

    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        replay(est, sim, start=at(10.0), stop=at(12.0), on_event=count)
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    n_sync_frames = len(frames)

    frames.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        replay(est, sim, start=at(12.0), stop=at(16.0), on_event=count)
        torch.cuda.synchronize()
        wall = time.time() - t0
    if args.trace:
        prof.export_chrome_trace(args.trace)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time for e in kernels)
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:25]
    n = len(frames)
    print(json.dumps({
        "card": _card(), "cell": "pipeline", "frames_traced": n,
        "traced_s": wall, "ms_per_frame": 1e3 * wall / n,
        "host_syncs_per_frame": syncs / n_sync_frames,
        "device_kernel_ms_per_frame": busy_us / 1e3 / n,
        "device_busy_share": busy_us / 1e6 / wall,
        "kernel_launches_per_frame": len(kernels) / n,
        "chol_lanes_ms": sum(t for k, (_, t) in by_name.items()
                             if "chol_lanes" in k) / 1e3}))
    for name, (c, t) in top:
        print(f"{t / 1e3:10.3f} ms {c:6d}x  {name[:110]}")


if __name__ == "__main__":
    main()
