"""Multi-process dry run of the sharded solves, the counterpart of the JAX
package's ``__graft_entry__.dryrun_multichip``.

    python -m rtk_visual_inertial_navigation_tpu_torch.parallel.dryrun N [--cpu]

starts N processes, one per device, on a ("dp", "fp") mesh of shape
(N // 2, 2) for an even N >= 4, else (N, 1), and runs on it the VI
sub-problem (``sharded_vi_solve``) and the flagship RTK solve at the
reference's 11-frame window (64 landmarks, cap-8 chains) routed through
the multihost layer (``distribute_local_rtk_problems`` +
``multihost_rtk_solve``).  On ``cuda`` it needs N GPUs and raises with
fewer; ``device="cpu"`` runs gloo processes instead.
"""

from __future__ import annotations

import sys

import torch

from ..core.state import TangentLayout
from ..device import resolve_device
from ..solver.gauss_newton import DoglegConfig
from .mesh import dp_windows, sharded_vi_solve
from .multihost import (distribute_local_rtk_problems, global_mesh,
                        multihost_rtk_solve, run_ranks)
from .problems import make_synthetic_windows
from .problems_gnss import make_synthetic_rtk_windows


# the flagship RTK problem of the dry run: the reference's 11-frame window,
# 64 landmarks, cap-8 chains (70 hidden GNSS epochs), every landmark seen
# from every frame; float64, seed 2, two windows per dp group
RTK_SHAPE = dict(nf=11, nl=64, nobs=11 * 64, nsamp=6, cap=8, ns=8, nb=8)
RTK_SEED = 2


def mesh_shape(n_devices: int):
    """(dp, fp) of the dry run's mesh, as the JAX dry run lays it out."""
    if n_devices >= 4 and n_devices % 2 == 0:
        return n_devices // 2, 2
    return n_devices, 1


def _check(ok, what):
    if not ok:
        raise RuntimeError(f"dry run: {what}")


def _dryrun_rank(rank, n_devices, device):
    n_dp, n_fp = mesh_shape(n_devices)
    mesh = global_mesh(fp=n_fp, device=device)

    # --- VI sub-problem ---
    nf, nl, nsamp = 4, 8, 8
    B = n_dp * 2                 # windows divisible by dp
    nobs = n_fp * 12             # observations divisible by fp
    lay = TangentLayout(nf=nf, nl=nl, nb=1, nc=2)
    cfg = DoglegConfig(max_iters=2, schur_nl=nl)
    probs = make_synthetic_windows(1, B, nf, nl, nobs, nsamp, device="cpu")
    _, cost, _ = sharded_vi_solve(mesh, probs, lay, cfg)
    _check(bool(torch.isfinite(cost).all()), "non-finite VI cost")

    # --- flagship RTK solve (RTK_SHAPE); the rows and the chains split
    # over fp ---
    S = RTK_SHAPE
    lay = TangentLayout(nf=S["nf"], nl=S["nl"], nb=S["nb"], nc=2)
    cfg = DoglegConfig(max_iters=4, schur_nl=S["nl"])
    cap = S["cap"]
    probs = dp_windows(mesh, make_synthetic_rtk_windows(
        RTK_SEED, B, **S, device="cpu"))
    placed = distribute_local_rtk_problems(mesh, probs)
    win, _, cost, nacc, X = multihost_rtk_solve(mesh, placed, lay, cfg, cap)
    _check(bool(torch.isfinite(cost).all()), "non-finite RTK cost")
    _check(bool((nacc >= 1).all()), "no accepted dogleg step")
    _check(bool(torch.isfinite(X).all()), "non-finite tail covariance")
    perr = (win.p - placed.truth.p).norm(dim=-1).max().item()
    _check(perr < 0.05, f"solve off by {perr} m")
    return dict(max_pos_err_m=perr, mesh=(n_dp, n_fp),
                device=str(win.p.device))


def dryrun_multichip(n_devices: int, device=None):
    """Run the dry run on ``n_devices`` new processes (see the module
    docstring); raises if any process fails.  Returns each rank's
    ``max_pos_err_m``, mesh shape and device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"the dry run needs {n_devices} CUDA devices; "
                           f"{torch.cuda.device_count()} are visible")
    return run_ranks(_dryrun_rank, n_devices, (n_devices, dev.type),
                     device=dev.type)


if __name__ == "__main__":
    n = int(sys.argv[1])
    for r in dryrun_multichip(n, "cpu" if "--cpu" in sys.argv else None):
        print(r)
