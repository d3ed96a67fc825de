"""The batched VI window solve (the VI sub-bench, ``bench.py --vi``), and
its dp x fp sharded form over a ``torch.distributed`` device mesh.

Every window of the batch runs the same dogleg loop on a dense Hessian:
projection rows placed by segment sums (``projection_assemble``), the IMU
rows scatter-added (``assemble``), the gauge prior in information form
formed once per solve, and the landmark group Schur-eliminated first
(``DoglegConfig.schur_nl``).

The sharded solve runs one process per device on a mesh with axes
("dp", "fp") (``multihost.global_mesh``):

  - ``dp``: the window batch is split over the dp groups; no
    communication.
  - ``fp``: within a window the observation rows are split over the fp
    peers.  Each peer assembles its rows, one ``all_reduce`` over the fp
    group sums H, g and the cost (the JAX package's ``psum``), and the
    replicated remainder — IMU rows, prior, step, retraction — runs on
    every peer, whose dogleg decisions are made one by a second, small
    reduction per iteration (``dogleg_solve(reduce=)``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves, tree_map

from ..core.state import TangentLayout, retract_window
from ..device import full_precision, resolve_device
from ..factors.inertial import imu_factor_batch
from ..factors.priors import MargPrior
from ..factors.visual import projection_factor_batch
from ..solver.gauss_newton import DoglegConfig, assemble, dogleg_solve
from ..solver.structured import projection_assemble
from .problems import VIWindowProblem

# the observation rows of a window problem, split over the fp peers
OBS_FIELDS = ("f_ids", "l_ids", "obs_xy", "obs_valid")


def psum(tensors, group):
    """Sum each of ``tensors`` (leading dim B) over the processes of
    ``group``, in place, in one ``all_reduce`` of one flat buffer (as one
    ``psum`` of a pytree: one collective per call, whatever the number of
    tensors).  Writing back in place keeps each tensor's layout, so the
    arithmetic after the sum is the single-process path's."""
    flat = torch.cat([t.reshape(t.shape[0], -1) for t in tensors], dim=1)
    dist.all_reduce(flat, group=group)
    i = 0
    for t in tensors:
        n = t[0].numel()
        t.copy_(flat[:, i:i + n].reshape(t.shape))
        i += n


def min_over(group):
    """``dogleg_solve``'s ``reduce`` hook for the peers of ``group``."""
    def reduce(flags):
        dist.all_reduce(flags, op=dist.ReduceOp.MIN, group=group)
        return flags
    return reduce


def mesh_device(mesh, device=None) -> torch.device:
    """The device of this process on ``mesh``: the current CUDA device for
    a ``cuda`` mesh, else the CPU.  The mesh fixes it; a ``device`` given
    (``sharded_rtk_solve``'s) is only checked to be of the mesh's type."""
    if device is not None:
        dev = resolve_device(device)
        if dev.type != mesh.device_type:
            raise ValueError(f"device {dev} is not on the {mesh.device_type} "
                             f"mesh")
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return resolve_device(mesh.device_type)


def check_divisible(what: str, n: int, parts: int, axis: str):
    if n % parts != 0:
        raise ValueError(f"{what} ({n}) is not divisible by the {axis} "
                         f"axis of the mesh ({parts})")


def _part(x, dim: int, parts: int, i: int):
    k = x.shape[dim] // parts
    return x.narrow(dim, i * k, k)


def dp_windows(mesh, probs):
    """This process's windows of a global batch: the ``dp`` slice."""
    n_dp = mesh.size(0)
    B = probs.state0.p.shape[0]
    check_divisible("the window batch", B, n_dp, "dp")
    i = mesh.get_local_rank("dp")
    return tree_map(lambda x: _part(x, 0, n_dp, i), probs)


def fp_shard(mesh, probs, fields, device):
    """``probs`` with each of ``fields`` cut to this process's ``fp`` part
    of its axis 1 (observation rows, chains), on ``device``; every other
    field is copied whole.  Raises unless the fp axis divides each."""
    n_fp = mesh.size(1)
    for k in fields:
        for x in tree_leaves(getattr(probs, k)):
            check_divisible(f"axis 1 of {k}", x.shape[1], n_fp, "fp")
    i = mesh.get_local_rank("fp")
    cut = {k: tree_map(lambda x: _part(x, 1, n_fp, i), getattr(probs, k))
           for k in fields}
    return tree_map(lambda x: x.to(device).contiguous(),
                    probs._replace(**cut))


def _solve_one(prob: VIWindowProblem, lay: TangentLayout, cfg: DoglegConfig,
               fp_group=None):
    """The VI window solve of every window of the batch ``prob``.  With
    ``fp_group``, ``prob`` holds this process's share of the observation
    rows, and H, g and the cost of the projection rows are summed over the
    group before the IMU rows and the prior are added once."""
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
        if fp_group is not None:
            psum((H, g, cost), fp_group)
        Hi, gi, ci = assemble([b_imu], lay.dim)
        Hp, gp, cp = prior_contrib(state)
        return H + Hi + Hp, g + gi + gp, cost + ci + cp

    res = dogleg_solve(eval_fn, retract_window, prob.state0, prob.free_mask,
                       cfg, reduce=None if fp_group is None
                       else min_over(fp_group))
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


def sharded_vi_solve(mesh, probs: VIWindowProblem, lay: TangentLayout,
                     cfg: DoglegConfig):
    """dp x fp sharded solve of the global batch ``probs``, which every
    process of ``mesh`` passes whole: its windows over dp, the observation
    rows of each window over fp.  Raises unless the batch divides by dp
    and the rows by fp.  Returns this process's windows' (state, cost,
    n_accepted); ``multihost.gather_vi_results`` collects the batch."""
    full_precision()
    local = fp_shard(mesh, dp_windows(mesh, probs), OBS_FIELDS,
                     mesh_device(mesh))
    return _solve_one(local, lay, cfg, fp_group=mesh.get_group("fp"))
