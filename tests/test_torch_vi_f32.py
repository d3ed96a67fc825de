"""The port's float32 VI solve against the JAX float32 VI solve on the same
inputs: the JAX generator's problem at the shape and solver configuration
of ``bench.py --vi`` (nf=8, nl=64, nobs=448, 16 IMU samples, 8 dogleg
iterations, landmark Schur, 120 kept reduced slots), cast to f32 after an
f64 synthesis as the bench does.

In f32 the reduced step factors the shifted system A + 1e-5·I (the JAX
solver's ``_chol_solve_scaled``), so 8 iterations leave errors of a few cm
in some windows.  The test holds the port to the reference window by
window; run as a script it prints the error statistics of both solves on
one problem, of the port's own generator, and of the port's solve with a
smaller shift or more iterations:

    PYTHONPATH=. python tests/test_torch_vi_f32.py --batch 128 --seed 0
"""

import argparse
import functools
import os
import time

import jax

if __name__ == "__main__":          # under pytest, tests/conftest.py does it
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map
from test_torch_jax_ref import per_window
from test_torch_jax_ref import to_numpy as _np

from rtk_visual_inertial_navigation_tpu.core.state import \
    TangentLayout as JLayout
from rtk_visual_inertial_navigation_tpu.parallel import \
    make_synthetic_windows as jax_make_synthetic_windows
from rtk_visual_inertial_navigation_tpu.parallel.mesh import \
    _solve_one as jax_solve_one
from rtk_visual_inertial_navigation_tpu.solver import gauss_newton as jgn
from rtk_visual_inertial_navigation_tpu_torch.core.state import \
    TangentLayout
from rtk_visual_inertial_navigation_tpu_torch.parallel import (
    batched_vi_solve, make_synthetic_windows, vi_problem_from_numpy)
from rtk_visual_inertial_navigation_tpu_torch.solver import \
    block_hessian as tbh
from rtk_visual_inertial_navigation_tpu_torch.solver import \
    gauss_newton as tgn

torch.set_num_threads(1)     # as the other port tests: one per worker

NF, NL, NOBS, NSAMP = 8, 64, 448, 16          # bench.py:277
KEEP = tuple(range(15 * NF))                   # bench.py:286-287
B = 8
# a window's frame-1+ error may differ from the reference's by this much,
# half the 1 cm the bench counts: f32 sums in another order perturb each
# step, and 8 slowly converging iterations carry the difference (1.1e-3 m
# at most over 128 windows of the script below)
ERR_TOL_M = 5e-3


def _frame_err(p, truth):
    """Per window: the largest frame-1+ position error (bench.py:301-304)."""
    return np.linalg.norm(np.asarray(p, np.float64) - truth,
                          axis=-1)[:, 1:].max(axis=1)


def jax_f32_solve(batch, seed):
    probs = jax_make_synthetic_windows(jax.random.PRNGKey(seed), batch, NF,
                                       NL, NOBS, NSAMP, jnp.float32)
    cfg = jgn.DoglegConfig(max_iters=8, schur_nl=NL, reduced_keep=KEEP)
    lay = JLayout(nf=NF, nl=NL, nb=1, nc=2)
    st, cost, nacc = per_window(lambda p: jax_solve_one(p, lay, cfg),
                                (probs,), batch)
    return probs, st, cost, nacc


def port_solve(probs, iters=8):
    cfg = tgn.DoglegConfig(max_iters=iters, schur_nl=NL, reduced_keep=KEEP)
    return batched_vi_solve(probs, TangentLayout(nf=NF, nl=NL, nb=1, nc=2),
                            cfg, device="cpu")


@pytest.fixture(scope="module")
def jax_f32_run():
    return jax_f32_solve(B, 0)


def test_port_f32_matches_jax_f32_bench_shape(jax_f32_run):
    probs, st_j, cost_j, nacc_j = jax_f32_run
    tp = vi_problem_from_numpy(_np(probs), device="cpu", dtype=torch.float32)
    st, cost, nacc = port_solve(tp)
    assert st.p.dtype == torch.float32
    truth = np.asarray(probs.truth.p, np.float64)
    err, err_j = _frame_err(st.p, truth), _frame_err(st_j.p, truth)
    assert np.isfinite(cost.numpy()).all()
    assert (nacc.numpy() >= 1).all()
    np.testing.assert_allclose(err, err_j, rtol=0, atol=ERR_TOL_M)
    np.testing.assert_allclose(st.p.numpy(), np.asarray(st_j.p), rtol=0,
                               atol=ERR_TOL_M)
    # the frames-1+ error is the f32 step's, not the data's: both solves
    # pull every window from its ~0.1 m perturbation to a few cm at most
    assert err.max() < 0.05 and err_j.max() < 0.05


def _report(tag, err, t):
    print(f"{tag}: max {err.max():.6f} m, frac windows > 1 cm "
          f"{(err > 0.01).mean():.4f}, median {np.median(err):.6f} m "
          f"({len(err)} windows, {t:.1f} s)", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.set_num_threads(os.cpu_count() or 1)

    t0 = time.time()
    probs, st_j, _, _ = jax_f32_solve(args.batch, args.seed)
    truth = np.asarray(probs.truth.p, np.float64)
    err_j = _frame_err(st_j.p, truth)
    _report("JAX f32 solve, JAX generator", err_j, time.time() - t0)
    tp = vi_problem_from_numpy(_np(probs), device="cpu", dtype=torch.float32)
    t0 = time.time()
    err = _frame_err(port_solve(tp)[0].p, truth)
    _report("port f32 solve, same problem", err, time.time() - t0)
    print(f"  largest per-window difference from JAX: "
          f"{np.abs(err - err_j).max():.3e} m", flush=True)

    p64 = make_synthetic_windows(args.seed, args.batch, NF, NL, NOBS, NSAMP,
                                 device="cpu")
    p32 = tree_map(lambda x: x.float() if x.is_floating_point() else x, p64)
    truth = p64.truth.p.numpy()
    t0 = time.time()
    _report("port f32 solve, port generator", _frame_err(
        port_solve(p32)[0].p, truth), time.time() - t0)
    # what the f32 error is made of: the shift of the f32 factorization,
    # not the refinement and not the data
    base = tgn._chol_solve_scaled
    for tag, kw, iters in (("16 iterations", {}, 16),
                           ("refine 8 times", dict(refine=8), 8),
                           ("shift 1e-7", dict(shift=1e-7), 8)):
        tbh._chol_solve_scaled = functools.partial(base, **kw)
        t0 = time.time()
        _report(f"  port f32 solve, port generator, {tag}", _frame_err(
            port_solve(p32, iters)[0].p, truth), time.time() - t0)
    tbh._chol_solve_scaled = base
    t0 = time.time()
    _report("  port f64 solve, port generator",
            _frame_err(port_solve(p64)[0].p, truth), time.time() - t0)


if __name__ == "__main__":
    main()
