"""The batched VI window solve (the VI sub-bench, ``bench.py --vi``).

Every window of the batch runs the same dogleg loop on a dense Hessian:
projection rows placed by segment sums (``projection_assemble``), the IMU
rows scatter-added (``assemble``), the gauge prior in information form
formed once per solve, and the landmark group Schur-eliminated first
(``DoglegConfig.schur_nl``).  The dp x fp sharded solve of the JAX package
is not ported yet.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_map

from ..core.state import TangentLayout, retract_window
from ..device import full_precision, resolve_device
from ..factors.inertial import imu_factor_batch
from ..factors.priors import MargPrior
from ..factors.visual import projection_factor_batch
from ..solver.gauss_newton import DoglegConfig, assemble, dogleg_solve
from ..solver.structured import projection_assemble
from .problems import VIWindowProblem


def _solve_one(prob: VIWindowProblem, lay: TangentLayout, cfg: DoglegConfig):
    """The VI window solve of every window of the batch ``prob``."""
    dtype, dev = prob.state0.p.dtype, prob.state0.p.device
    pbg = torch.zeros(3, dtype=dtype, device=dev)
    g_world = torch.tensor([0.0, 0.0, 9.81], dtype=dtype, device=dev)
    prior = MargPrior(J=prob.prior_J, r0=prob.prior_r0, x0=prob.prior_x0,
                      valid_rows=torch.ones(prob.prior_r0.shape,
                                            dtype=torch.bool, device=dev))
    prior_contrib = prior.precompute()
    cam_ids = torch.zeros_like(prob.f_ids)

    def eval_fn(state):
        b_imu = imu_factor_batch(state, prob.pre, pbg, g_world,
                                 prob.pre_valid, W=prob.imu_W)
        b_proj = projection_factor_batch(
            state, prob.f_ids, cam_ids, prob.l_ids, prob.obs_xy,
            prob.obs_valid, pbg)
        H, g, cost = projection_assemble(lay, prob.f_ids, cam_ids,
                                         prob.l_ids, b_proj.res, b_proj.jac)
        Hi, gi, ci = assemble([b_imu], lay.dim)
        Hp, gp, cp = prior_contrib(state)
        return H + Hi + Hp, g + gi + gp, cost + ci + cp

    res = dogleg_solve(eval_fn, retract_window, prob.state0, prob.free_mask,
                       cfg)
    return res.state, res.cost, res.n_accepted


def batched_vi_solve(probs: VIWindowProblem, lay: TangentLayout,
                     cfg: DoglegConfig, device=None):
    """Solve a batch of VI windows on ``device`` (default ``cuda``; pass
    ``device="cpu"`` for the CPU).  Returns (state, cost (B,),
    n_accepted (B,))."""
    dev = resolve_device(device)
    full_precision()
    probs = tree_map(lambda x: x.to(dev), probs)
    return _solve_one(probs, lay, cfg)
