"""The ported flagship slice end to end (float64, CPU, the shapes of
tests/test_parallel_rtk.py):

  - the JAX generator's problem through ``problem_from_numpy`` and the
    port's ``batched_rtk_solve(device="cpu")`` matches the JAX
    ``batched_rtk_solve`` at the tolerances of test_parallel_rtk.py:79-85;
  - the port's own generator (torch.Generator streams) is recovered to
    truth at the thresholds of test_parallel_rtk.py:43-63;
  - importing the port loads neither jax nor the JAX package.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rtk_visual_inertial_navigation_tpu.core.state import \
    TangentLayout as JLayout
from rtk_visual_inertial_navigation_tpu.parallel import (
    batched_rtk_solve as jax_batched_rtk_solve, make_synthetic_rtk_windows)
from rtk_visual_inertial_navigation_tpu.solver import \
    DoglegConfig as JDoglegConfig
from rtk_visual_inertial_navigation_tpu_torch.core.state import \
    TangentLayout
from rtk_visual_inertial_navigation_tpu_torch.parallel import problems_gnss
from rtk_visual_inertial_navigation_tpu_torch.solver.gauss_newton import \
    DoglegConfig

# tiny shapes: one intra-op thread beats oversubscribing the workers
torch.set_num_threads(1)

NF, NL, NOBS, NSAMP, CAP, NS, NB = 5, 12, 40, 6, 4, 6, 8
B = 2
LAY = TangentLayout(nf=NF, nl=NL, nb=NB, nc=2)


def _np(x):
    if hasattr(x, "_asdict"):
        return {k: _np(v) for k, v in x._asdict().items()}
    return np.asarray(x)


@pytest.fixture(scope="module")
def jax_run():
    probs = make_synthetic_rtk_windows(
        jax.random.PRNGKey(7), B, nf=NF, nl=NL, nobs=NOBS, nsamp=NSAMP,
        cap=CAP, ns=NS, nb=NB)
    lay = JLayout(nf=NF, nl=NL, nb=NB, nc=2)
    out = jax.jit(lambda p: jax_batched_rtk_solve(
        p, lay, JDoglegConfig(max_iters=4), CAP))(probs)
    return probs, out


def test_port_matches_jax_batched_rtk_solve(jax_run):
    probs, (win_j, hid_j, cost_j, _, X_j) = jax_run
    tp = problems_gnss.problem_from_numpy(_np(probs), device="cpu")
    win, hid, cost, _, X = problems_gnss.batched_rtk_solve(
        tp, LAY, DoglegConfig(max_iters=4), CAP, device="cpu")
    # costs converge to ~machine zero on exactly-consistent data; compare
    # with an absolute floor (test_parallel_rtk.py:79-85)
    np.testing.assert_allclose(cost.numpy(), np.asarray(cost_j), rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(win.p.numpy(), np.asarray(win_j.p),
                               atol=1e-8)
    np.testing.assert_allclose(win.phase_bias.numpy(),
                               np.asarray(win_j.phase_bias), atol=1e-8)
    np.testing.assert_allclose(X.numpy(), np.asarray(X_j), atol=1e-8)
    np.testing.assert_allclose(hid.p.numpy(), np.asarray(hid_j.p), atol=1e-8)


def test_port_generator_solve_recovers_truth():
    probs = problems_gnss.make_synthetic_rtk_windows(
        7, B, nf=NF, nl=NL, nobs=NOBS, nsamp=NSAMP, cap=CAP, ns=NS, nb=NB,
        device="cpu")
    win, hid, cost, nacc, X = problems_gnss.batched_rtk_solve(
        probs, LAY, DoglegConfig(max_iters=6), CAP, device="cpu")
    assert bool(torch.isfinite(cost).all())
    perr = (win.p - probs.truth.p).norm(dim=-1)
    assert perr.max() < 5e-3, perr.max()
    herr = (hid.p - probs.hid_truth.p).norm(dim=-1)
    assert herr.max() < 5e-3, herr.max()
    pberr = (win.phase_bias - probs.truth.phase_bias).abs()
    assert pberr[:, :NS].max() < 1e-2, pberr.max()
    cerr = (win.clk - probs.truth.clk).abs()
    assert cerr[..., [0, 12]].max() < 1e-2
    assert bool(torch.isfinite(X).all())
    pb_rows = probs.cov_cols[0]
    diag = X[0][pb_rows, torch.arange(NB)]
    assert bool((diag[:NS] > 0).all())


def test_entry_points_refuse_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        problems_gnss.make_synthetic_rtk_windows(0, 1, nf=3, nl=4, nobs=8,
                                                 nsamp=3, cap=2, ns=4, nb=4)


def test_port_imports_no_jax():
    # import every module of the port, then inspect sys.modules
    code = ("import importlib, pkgutil, sys\n"
            "import rtk_visual_inertial_navigation_tpu_torch as p\n"
            "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "p.__name__ + '.')]\n"
            "assert len(mods) > 20, mods\n"
            "[importlib.import_module(m) for m in mods]\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'rtk_visual_inertial_navigation_tpu')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=root, timeout=120)
    src = open(os.path.join(root, "chip_smoke.py")).read()
    assert "import jax" not in src
    assert "rtk_visual_inertial_navigation_tpu." not in src
