"""Rank functions of tests/test_torch_parallel.py.

They run in processes that ``multihost.run_ranks`` starts, which import
them by module name: this module imports torch and the port only (the
test module imports JAX, whose import here would start JAX in every rank).
"""

from rtk_visual_inertial_navigation_tpu_torch.parallel import (
    distribute_local_problems, distribute_local_rtk_problems,
    gather_rtk_results, gather_vi_results, global_mesh, multihost_rtk_solve,
    multihost_vi_solve, sharded_rtk_solve, sharded_vi_solve)
from rtk_visual_inertial_navigation_tpu_torch.parallel.mesh import dp_windows
from rtk_visual_inertial_navigation_tpu_torch.parallel.problems import \
    vi_problem_from_numpy
from rtk_visual_inertial_navigation_tpu_torch.parallel.problems_gnss import (
    _solve_one_rtk, batched_rtk_solve, problem_from_numpy)
from torch.utils._pytree import tree_map


def _error(fn):
    """The type name of what ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as e:   # the test asserts which type
        return type(e).__name__
    return None


def sharded_rank(rank, rtk_tree, rtk_args, vi_tree, vi_args):
    """dp=2 x fp=2: the sharded and multihost solves, gathered."""
    lay, cfg, cap = rtk_args
    mesh = global_mesh(fp=2, device="cpu")
    out = dict(mesh=(mesh.size(0), mesh.size(1), mesh.mesh_dim_names),
               fp3=_error(lambda: global_mesh(fp=3, device="cpu")))
    probs = problem_from_numpy(rtk_tree, device="cpu")
    out["rtk"] = gather_rtk_results(
        mesh, sharded_rtk_solve(mesh, probs, lay, cfg, cap))
    placed = distribute_local_rtk_problems(mesh, dp_windows(mesh, probs))
    out["rtk_multihost"] = gather_rtk_results(
        mesh, multihost_rtk_solve(mesh, placed, lay, cfg, cap))
    out["rtk_dense"] = gather_rtk_results(mesh, _solve_one_rtk(
        placed, lay, cfg, cap, fp_group=mesh.get_group("fp"),
        use_blocks=False))
    cut = lambda p, n, dim: tree_map(lambda x: x.narrow(dim, 0, n), p)
    out["rtk_raises"] = dict(
        batch=_error(lambda: sharded_rtk_solve(
            mesh, cut(probs, 1, 0), lay, cfg, cap)),
        rows=_error(lambda: sharded_rtk_solve(mesh, probs._replace(
            **{k: cut(getattr(probs, k), 39, 1)
               for k in ("f_ids", "l_ids", "obs_xy", "obs_valid")}),
            lay, cfg, cap)),
        chains=_error(lambda: sharded_rtk_solve(mesh, probs._replace(
            st=cut(probs.st, 3, 1), hid0=cut(probs.hid0, 3, 1)),
            lay, cfg, cap)))

    vlay, vcfg = vi_args
    vprobs = vi_problem_from_numpy(vi_tree, device="cpu")
    out["vi"] = gather_vi_results(
        mesh, sharded_vi_solve(mesh, vprobs, vlay, vcfg))
    vplaced = distribute_local_problems(mesh, dp_windows(mesh, vprobs))
    out["vi_multihost"] = gather_vi_results(
        mesh, multihost_vi_solve(mesh, vplaced, vlay, vcfg))
    return out if rank == 0 else None


def world_one_rank(rank, rtk_tree, rtk_args):
    """fp=1 at world size 1 against the single-process batched solve."""
    lay, cfg, cap = rtk_args
    mesh = global_mesh(fp=1, device="cpu")
    probs = problem_from_numpy(rtk_tree, device="cpu")
    return dict(
        sharded=sharded_rtk_solve(mesh, probs, lay, cfg, cap),
        batched=batched_rtk_solve(probs, lay, cfg, cap, device="cpu"))


def failing_rank(rank, case):
    """Rank 1 raises.  ``case="blocked"``: rank 0 waits for it in a
    collective that never comes, until ``run_ranks`` stops it;
    ``case="later"``: rank 0 raises first, rank 1 half a second later."""
    import time

    import torch.distributed as dist
    if rank == 1:
        if case == "later":
            time.sleep(0.5)
        raise ValueError("rank 1 fails on purpose")
    if case == "later":
        raise ValueError("rank 0 fails first")
    dist.barrier()
