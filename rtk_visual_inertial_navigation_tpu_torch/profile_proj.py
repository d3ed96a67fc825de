"""Where the projection kernel's time goes, on one GPU.

    python3 -m rtk_visual_inertial_navigation_tpu_torch.profile_proj \
        [--batch B] [--tiles 8,16,32]

At the flagship shape (nf=11, nl=352, nobs=2816, f32, the solve's
observation plan, want_ext=False):
  - the device time per launch of ``csrc/proj_segments.cu`` for each
    largest landmark tile, from ``torch.profiler`` over 30 launches;
  - one launch of the kernel built with ``-DPROJ_SEGMENTS_TIMELINE`` at the
    default tile: thread 0 of every block stamps the global timer at its
    phase boundaries, and the script prints, for frame blocks and landmark
    blocks apart, when they started after the first block (the wait for a
    free slot on an SM) and the 10th, 50th and 90th percentile of each
    phase's duration.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np

PHASES = {
    "frame": [("prologue", 0, 1), ("first linearize", 1, 2),
              ("first warp sums", 2, 3), ("rest of the loop", 3, 4),
              ("epilogue", 4, 7)],
    "landmark": [("prologue", 0, 1), ("first linearize + stage", 1, 2),
                 ("first PL runs", 2, 3), ("first LL/GL tasks", 3, 4),
                 ("rest of the loop", 4, 5), ("tile write-out", 5, 7)],
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--tiles", default="8,16,32")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from .core.state import TangentLayout
    from .factors.visual import PROJ_SQRT_INFO
    from .ops import pallas_proj as pp
    from .ops.build import load
    from .parallel.problems_gnss import make_synthetic_rtk_windows

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    F = dict(nf=11, nl=352, nobs=2816, nsamp=8, cap=11, ns=14, nb=16)
    B, dev = args.batch, torch.device("cuda")
    pr = make_synthetic_rtk_windows(1, B, dtype=torch.float32, device=dev,
                                    **F)
    lay = TangentLayout(nf=F["nf"], nl=F["nl"], nb=F["nb"], nc=2)
    w = pr.state0
    pbg = torch.zeros(3, dtype=torch.float32, device=dev)
    plan = pp.proj_plan(lay, pr.f_ids, torch.zeros_like(pr.f_ids), pr.l_ids,
                        pr.obs_valid)

    def call(max_tile=pp.MAX_TILE, defines=()):
        return pp._proj_segments_cuda(
            lay, w.p, w.q, w.tic, w.qic, w.landmarks, pbg, pr.obs_xy, plan,
            PROJ_SQRT_INFO, 0.0, False, max_tile, defines)

    device_ms = {}
    for max_tile in (int(t) for t in args.tiles.split(",")):
        fn = lambda: call(max_tile)
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(30):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "proj_segments" in e.name)
        device_ms[max_tile] = us / 1e3 / 30

    defines = ("PROJ_SEGMENTS_TIMELINE",)
    for _ in range(3):
        call(defines=defines)
    torch.cuda.synchronize()
    L = pp._tile(torch.cuda.current_device(), lay.nf, lay.nc, False, 4,
                 pp.MAX_TILE, defines)
    gx = lay.nf + -(-lay.nl // L)
    n = B * gx
    stamps = np.zeros(n * 8, dtype=np.uint64)
    lib = load("proj_segments", defines)
    rc = lib.proj_segments_timeline(stamps.ctypes.data_as(ctypes.c_void_p),
                                    ctypes.c_int(n))
    if rc != 0:
        raise RuntimeError(f"reading the timeline failed: CUDA error {rc}")
    t = stamps.reshape(n, 8).astype(np.int64)
    t0 = t[:, 0].min()
    kind = np.where(np.arange(n) % gx < lay.nf, "frame", "landmark")
    pct = lambda x: [round(float(v) / 1e3, 3)
                     for v in np.percentile(x, [10, 50, 90])]
    out = dict(card=card, batch=B, device_ms_by_max_tile=device_ms,
               timeline_tile=L, blocks=n,
               timeline_span_us=round(float(t[:, 7].max() - t0) / 1e3, 3))
    for k, phases in PHASES.items():
        # blocks with rows of their own (the others stamp no phase)
        m = (kind == k) & (t[:, 2] > 0)
        out[k] = dict(blocks=int(m.sum()),
                      start_after_first_us=pct(t[m, 0] - t0),
                      total_us=pct(t[m, 7] - t[m, 0]),
                      **{name: pct(t[m, b] - t[m, a])
                         for name, a, b in phases})
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
