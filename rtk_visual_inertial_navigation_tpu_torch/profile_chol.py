"""Where the batched Cholesky kernels' time goes, on one GPU.

    python3 -m rtk_visual_inertial_navigation_tpu_torch.profile_chol

At the shapes the f32 step gives them — the VI step (B=256, n=120) and the
flagship step and covariance (B=32, n=339) — on SPD systems made from a
seed:
  - the device time per launch of ``csrc/chol_lanes.cu`` (for each number
    of CTAs per system, 1 to 8, that fits) and of ``csrc/chol_lanes_solve.cu`` (1
    and 16 right-hand sides), from ``torch.profiler`` over 20 launches;
  - one launch of each kernel built with ``-DCHOL_LANES_TIMELINE``: thread
    0 of every CTA adds up the SM clock cycles it spends in each phase over
    all panels (waits at barriers included); the script prints the mean
    and the 90th percentile over CTAs, and the SM clock read beside it.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np

SHAPES = {"vi": (256, 120), "flagship": (32, 339)}
FACTOR_PHASES = ("load S", "diagonal tile (warp 0; warps 1-7 store the "
                 "last panel) + barrier", "panel solve + pushes",
                 "cluster barrier 1", "trailing update", "cluster barrier 2",
                 "last panel store", "barrier after the load")
SOLVE_PHASES = ("load b + first strip", "forward diagonal",
                "barrier after the diagonal", "forward update",
                "back diagonal", "back update", "strip wait + barrier",
                "store x")
TIMELINE = ("CHOL_LANES_TIMELINE",)


def _smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def _device_ms(torch, fn, name, reps=20):
    """Device ms per launch from a torch.profiler trace; a trace that lost
    launches is taken again, and after three such traces the time is None
    (not measured)."""
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
              and name in e.name]
        if len(ev) == reps:
            return round(sum(e.device_time for e in ev) / 1e3 / reps, 6)
    return None


def _timeline(torch, lib_name, fn_name, launch, nblocks, phases):
    """Phase cycles of one launch of the timeline build: mean and p90 over
    the CTAs."""
    from .ops.build import load
    launch()
    torch.cuda.synchronize()
    host = np.zeros((nblocks, 8), dtype=np.int64)
    get = getattr(load(lib_name, TIMELINE), fn_name)
    get.argtypes = [ctypes.c_void_p, ctypes.c_int]
    rc = get(host.ctypes.data, nblocks)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc}")
    return {ph: {"mean": int(host[:, i].mean()),
                 "p90": int(np.percentile(host[:, i], 90))}
            for i, ph in enumerate(phases)} | {
        "total_mean": int(host.sum(1).mean())}


def main():
    import torch

    from .ops import pallas_chol_lanes as pc

    card = _smi("name,power.limit")
    gen = torch.Generator().manual_seed(5)
    data, out = {}, {}
    for shape, (B, n) in SHAPES.items():
        A = torch.randn((B, n, 3 * n), generator=gen)
        S = (A @ A.transpose(-1, -2) / n + 0.5 * torch.eye(n)).cuda()
        b1 = torch.randn((B, n), generator=gen).cuda()
        b16 = torch.randn((B, n, 16), generator=gen).cuda()
        data[shape] = (B, n, S, b1, b16, pc._factor_cuda(S)[0])
    # every device time before any timeline build is loaded: with two
    # libraries holding kernels of the same names, the traces lose launches
    for shape, (B, n, S, b1, b16, L) in data.items():
        res = {"factor_device_ms": {}, "solve_device_ms": {}}
        for cluster in range(1, 9):
            try:
                pc._factor_cuda(S, cluster)
            except ValueError:           # this cluster size does not fit
                continue
            res["factor_device_ms"][cluster] = _device_ms(
                torch, lambda: pc._factor_cuda(S, cluster),
                "chol_lanes_factor")
        for k, b in ((1, b1), (16, b16)):
            res["solve_device_ms"][k] = _device_ms(
                torch, lambda: pc._solve_cuda(L, b), "chol_lanes_solve")
        res["factor_cluster_default"] = pc._factor_cluster(B, n)
        out[shape] = res
    for shape, (B, n, S, b1, b16, L) in data.items():
        res = out[shape]
        res["factor_timeline_cycles"] = _timeline(
            torch, "chol_lanes", "chol_lanes_factor_timeline",
            lambda: pc._factor_cuda(S, 0, TIMELINE),
            B * res["factor_cluster_default"], FACTOR_PHASES)
        for k, b in ((1, b1), (16, b16)):
            res[f"solve_k{k}_timeline_cycles"] = _timeline(
                torch, "chol_lanes_solve", "chol_lanes_solve_timeline",
                lambda: pc._solve_cuda(L, b, TIMELINE), B, SOLVE_PHASES)
        res["sm_clock"] = _smi("clocks.sm")
        print(f"profile_chol: {shape} B={B} n={n}: {json.dumps(res)}",
              flush=True)
    print(card)


if __name__ == "__main__":
    main()
