"""The port's dp x fp sharded solves and its multihost layer on
``torch.distributed`` against the JAX package's sharded solves (float64,
CPU).

Inputs are the JAX generators' problems at tests/test_parallel_rtk.py's
shapes (RTK) and tests/test_parallel.py's (VI).  The JAX references run
``sharded_rtk_solve`` / ``sharded_vi_solve`` on a (2, 2) mesh of the
conftest's virtual CPU devices; the port runs the same problems in one
4-process gloo group (dp=2 x fp=2, one thread per rank), started once for
the file, and gathers its results.  Tolerances are JAX's own
(tests/test_parallel_rtk.py:83-90, tests/test_parallel.py:39-40).
"""

import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from test_torch_jax_ref import CHEAP_XLA
from test_torch_jax_ref import to_numpy as _np
from torch_parallel_ranks import failing_rank, sharded_rank, world_one_rank

from rtk_visual_inertial_navigation_tpu.core.state import \
    TangentLayout as JLayout
from rtk_visual_inertial_navigation_tpu.parallel import \
    make_synthetic_rtk_windows as jax_make_rtk
from rtk_visual_inertial_navigation_tpu.parallel import \
    make_synthetic_windows as jax_make_vi
from rtk_visual_inertial_navigation_tpu.parallel import \
    sharded_rtk_solve as jax_sharded_rtk
from rtk_visual_inertial_navigation_tpu.parallel import \
    sharded_vi_solve as jax_sharded_vi
from rtk_visual_inertial_navigation_tpu.solver import \
    DoglegConfig as JDoglegConfig
from rtk_visual_inertial_navigation_tpu_torch.core.state import \
    TangentLayout
from rtk_visual_inertial_navigation_tpu_torch.parallel import \
    initialize_from_env
from rtk_visual_inertial_navigation_tpu_torch.parallel.dryrun import \
    dryrun_multichip
from rtk_visual_inertial_navigation_tpu_torch.parallel.multihost import \
    run_ranks
from rtk_visual_inertial_navigation_tpu_torch.solver.gauss_newton import \
    DoglegConfig

# RTK: tests/test_parallel_rtk.py:22-23, 77
NF, NL, NOBS, NSAMP, CAP, NS, NB = 5, 12, 40, 6, 4, 6, 8
B = 2
RTK_ARGS = (TangentLayout(nf=NF, nl=NL, nb=NB, nc=2),
            DoglegConfig(max_iters=4), CAP)
# VI: tests/test_parallel.py:13-15
VNF, VNL, VNOBS, VNSAMP = 4, 8, 24, 8
VB = 4
VI_ARGS = (TangentLayout(nf=VNF, nl=VNL, nb=1, nc=2),
           DoglegConfig(max_iters=4, schur_nl=VNL))


def _jax_sharded(fn, probs):
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "fp"))
    run = jax.jit(lambda p: fn(mesh, p)).lower(probs).compile(
        compiler_options=CHEAP_XLA)
    return jax.tree.map(np.asarray, run(probs))


@pytest.fixture(scope="module")
def problems():
    rtk = jax_make_rtk(jax.random.PRNGKey(7), B, nf=NF, nl=NL, nobs=NOBS,
                       nsamp=NSAMP, cap=CAP, ns=NS, nb=NB)
    vi = jax_make_vi(jax.random.PRNGKey(1), VB, VNF, VNL, VNOBS, VNSAMP)
    return rtk, vi


@pytest.fixture(scope="module")
def jax_ref(problems):
    rtk, vi = problems
    jlay = JLayout(nf=NF, nl=NL, nb=NB, nc=2)
    jrtk = _jax_sharded(lambda m, p: jax_sharded_rtk(
        m, p, jlay, JDoglegConfig(max_iters=4), CAP), rtk)
    vlay = JLayout(nf=VNF, nl=VNL, nb=1, nc=2)
    jvi = _jax_sharded(lambda m, p: jax_sharded_vi(
        m, p, vlay, JDoglegConfig(max_iters=4, schur_nl=VNL)), vi)
    return jrtk, jvi


@pytest.fixture(scope="module")
def port(problems):
    rtk, vi = problems
    out = run_ranks(sharded_rank, 4, (_np(rtk), RTK_ARGS, _np(vi), VI_ARGS),
                    device="cpu")
    return out[0]


def _check_rtk(got, ref):
    win, hid, cost, _, X = got
    jwin, jhid, jcost, _, jX = ref
    np.testing.assert_allclose(cost, jcost, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(win.p, jwin.p, atol=1e-8)
    np.testing.assert_allclose(win.phase_bias, jwin.phase_bias, atol=1e-8)
    np.testing.assert_allclose(X, jX, atol=1e-8)
    # every chain's hidden states come back from the peer that owns them
    np.testing.assert_allclose(hid.p, jhid.p, atol=1e-8)


def _check_vi(got, ref):
    state, cost, _ = got
    jstate, jcost, _ = ref
    np.testing.assert_allclose(cost, jcost, atol=1e-10)
    np.testing.assert_allclose(state.p, jstate.p, atol=1e-8)


def test_sharded_rtk_solve_matches_jax(port, jax_ref):
    _check_rtk(port["rtk"], jax_ref[0])


def test_multihost_rtk_solve_matches_jax(port, jax_ref):
    _check_rtk(port["rtk_multihost"], jax_ref[0])


def test_sharded_dense_rtk_solve_matches_jax(port, jax_ref):
    """The dense use_blocks=False oracle with its H summed over fp."""
    _check_rtk(port["rtk_dense"], jax_ref[0])


def test_sharded_vi_solve_matches_jax(port, jax_ref):
    _check_vi(port["vi"], jax_ref[1])


def test_multihost_vi_solve_matches_jax(port, jax_ref):
    _check_vi(port["vi_multihost"], jax_ref[1])


def test_mesh_and_shard_checks(port):
    assert port["mesh"] == (2, 2, ("dp", "fp"))
    # a world size fp does not divide, and a batch, rows or chains that
    # the mesh does not divide, raise before any collective
    assert port["fp3"] == "ValueError"
    assert port["rtk_raises"] == dict(batch="ValueError", rows="ValueError",
                                      chains="ValueError")


def test_world_size_one_matches_batched(problems):
    out = run_ranks(world_one_rank, 1, (_np(problems[0]), RTK_ARGS),
                    device="cpu")[0]
    flat = lambda t: jax.tree.leaves(t)
    for a, b in zip(flat(out["sharded"]), flat(out["batched"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_initialize_from_env_without_torchrun(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_from_env(device="cpu") is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("case", ["blocked", "later"])
def test_run_ranks_fails_on_a_rank_exception(case):
    """A rank's exception fails the call with its traceback, also where
    another rank's failure is seen first (a peer blocked in a collective
    fails when the failed rank's connection closes), and a blocked peer is
    stopped rather than left to the group's timeout."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        run_ranks(failing_rank, 2, (case,), device="cpu")
    assert "rank 1 fails on purpose" in str(err.value)
    if case == "later":
        assert "rank 0 fails first" in str(err.value)
    assert time.monotonic() - t0 < 60


def test_dryrun_multichip_cpu():
    out = dryrun_multichip(4, device="cpu")
    assert [r["mesh"] for r in out] == [(2, 2)] * 4
    assert max(r["max_pos_err_m"] for r in out) < 0.05
