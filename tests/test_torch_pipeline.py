"""The ported estimator pipeline (``bench.py --pipeline``) against the JAX
estimator, float64, on the CPU.

One RTK-VI replay with IMU-GNSS chains at the test tier's caps
(``chain_cap`` 8, ``max_chain_rows`` 256, as tests/test_pipeline_gnss.py)
goes through the JAX ``Estimator`` and through the port's
``Estimator(device="cpu")``, on the same simulated data.  5 s is the
shortest sequence in which a chain forms (t = 1.0 s), the integer fix
is reached (1.5 s) and the oldest frame is marginalized (5.0 s, once the
10-frame window is full).  Held:

  - every frame's position within POS_TOL_M of the JAX frame;
  - the same per-frame ``rtk_fixed`` sequence, the same ``_chain_stats``,
    and the same last fix: the same ambiguity slots fixed to the same
    integer differences (which equal the simulated double-differenced
    integers).  The reference satellite of the double differences may
    differ: ``choose_reference`` takes the argmin over candidates of the
    summed distance-to-integer of their pairwise differences, and on
    noiseless data after a fix every candidate sums to ~1e-9 cycles, so
    roundoff picks it.  A fix with another reference is the same set of
    constraints, so the fix is compared reference-free
    (``ambiguity.fix_differences``);
  - the JAX estimator's checkpoint at the replay's midpoint, loaded by the
    port's ``load_checkpoint`` and run to the end, ends where the JAX
    replay ends: frame positions within POS_TOL_M, the same fixes; and the
    port's checkpoint there, loaded by the JAX ``load_checkpoint``, does
    too (the JAX programs are compiled by then, so this costs no compile).
"""

import numpy as np
import pytest
import torch

from rtk_visual_inertial_navigation_tpu.config import \
    EstimatorConfig as JEstimatorConfig
from rtk_visual_inertial_navigation_tpu.pipeline import \
    Estimator as JEstimator
from rtk_visual_inertial_navigation_tpu.pipeline.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from rtk_visual_inertial_navigation_tpu.pipeline.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from rtk_visual_inertial_navigation_tpu.sim.synthetic import \
    gnss_epoch_of as jax_gnss_epoch_of
from rtk_visual_inertial_navigation_tpu_torch.ambiguity import \
    fix_differences
from rtk_visual_inertial_navigation_tpu_torch.config import EstimatorConfig
from rtk_visual_inertial_navigation_tpu_torch.ops import lie
from rtk_visual_inertial_navigation_tpu_torch.pipeline import (Estimator,
                                                             replay)
from rtk_visual_inertial_navigation_tpu_torch.pipeline.checkpoint import (
    load_checkpoint, save_checkpoint)
from rtk_visual_inertial_navigation_tpu_torch.sim import SimConfig, simulate
from rtk_visual_inertial_navigation_tpu_torch.sim.synthetic import \
    gnss_epoch_of

torch.set_num_threads(1)

DURATION = 5.0
# float64 on both sides: the two estimators differ by roundoff only (the
# same decisions on the same data)
POS_TOL_M = 1e-6
SIM = dict(duration=DURATION, imu_rate=200.0, cam_rate=2.0, gnss_rate=2.0,
           n_landmarks=60, n_sats=10, seed=0)


def _cfg_kw(sim):
    q_ic = lie.rot_to_quat(torch.from_numpy(sim.cfg.r_ic)).numpy()
    # tests/test_pipeline_gnss.py::test_rtk_vi_integer_fix's configuration
    return dict(
        nf=10, nl=48, nb=32, max_obs=256, imu_capacity=128, average_imu=40,
        qic=np.tile(q_ic, (2, 1)), tic=np.tile(sim.cfg.t_ic, (2, 1)),
        use_gnss=True, use_doppler=True, anchor_ecef=sim.anchor_ecef,
        enu_to_ecef=sim.enu_to_ecef, max_gnss_pr=160, max_gnss_cp=160,
        max_gnss_dopp=160, min_sats_per_epoch=6, initial_gnss_boost_epochs=5,
        chain_cap=8, max_chain_rows=256, use_rtk=True, use_rtd=True,
        use_n_resolve=True, min_fix_continuity=1, fix_continue_threshold=3)


def _count_margs(est):
    """Count calls of the estimator's _marginalize_oldest."""
    est.n_marg = 0
    inner = est._marginalize_oldest

    def counted():
        est.n_marg += 1
        inner()
    est._marginalize_oldest = counted
    return est


def _replay(est, sim, epoch_of, start=0, on_frame=None):
    """The bench's replay from IMU sample ``start``; ``on_frame(i)`` after
    every event.  Returns the per-event ``rtk_fixed`` flags."""
    fixed = []

    def on_event(i):
        fixed.append(bool(est.rtk_fixed))
        if on_frame is not None:
            on_frame(i)
    replay(est, sim, start=start, on_event=on_event, epoch_of=epoch_of)
    return fixed


def _one_solve_program(jest):
    """Let the JAX estimator export the LAMBDA covariance columns on every
    frame, so that it compiles one chains-solve program where it would
    compile two (~20 s).  Image frames never read the columns (only
    ``_integer_solve`` does, right after a GNSS frame's solve), so every
    state and decision is unchanged."""
    solve = jest._jit_solve_chains
    jest._jit_solve_chains = lambda want_cov=True: solve(True)
    return jest


@pytest.fixture(scope="module")
def replays(tmp_path_factory):
    # the port's simulator: the same arrays as the JAX simulator's to 1e-12
    # (test_torch_pipeline_modules.py), without its compiles
    sim = simulate(SimConfig(**SIM))
    kw = _cfg_kw(sim)
    # the checkpoint: after the events (GNSS epoch, then image) of the
    # middle camera frame's IMU sample; the last save there stands
    mid_i = int(sim.cam_idx[len(sim.cam_idx) // 2])
    tmp = tmp_path_factory.mktemp("ckpt")
    jpath, tpath = str(tmp / "jax_mid.npz"), str(tmp / "port_mid.npz")
    jest = _one_solve_program(_count_margs(JEstimator(JEstimatorConfig(**kw))))
    n_traj_mid = []

    def at_frame(est, save, path):
        def on_frame(i):
            if i == mid_i:
                save(est, path)
                n_traj_mid[:] = [len(est.trajectory)]
        return on_frame

    jfixed = _replay(jest, sim, jax_gnss_epoch_of,
                     on_frame=at_frame(jest, jax_save_checkpoint, jpath))
    test = _count_margs(Estimator(EstimatorConfig(**kw), device="cpu"))
    tfixed = _replay(test, sim, gnss_epoch_of,
                     on_frame=at_frame(test, save_checkpoint, tpath))
    resumed = load_checkpoint(Estimator(EstimatorConfig(**kw), device="cpu"),
                              jpath)
    rfixed = _replay(resumed, sim, gnss_epoch_of, start=mid_i + 1)
    jresumed = jax_load_checkpoint(
        _one_solve_program(JEstimator(JEstimatorConfig(**kw))), tpath)
    _replay(jresumed, sim, jax_gnss_epoch_of, start=mid_i + 1)
    return dict(sim=sim, jest=jest, test=test, resumed=resumed,
                jresumed=jresumed, jfixed=jfixed, tfixed=tfixed,
                rfixed=rfixed, n_mid=n_traj_mid[0])


def _positions(est):
    return np.stack([p for (_, p, _, _) in est.trajectory])


def test_replay_covers_chain_fix_and_marginalization(replays):
    jest, test = replays["jest"], replays["test"]
    assert jest._chain_stats["created"] > 0
    assert jest.n_marg > 0 and test.n_marg == jest.n_marg
    assert jest.rtk_fixed and test.rtk_fixed
    # the checkpoint sits before the marginalization: the resumed port
    # estimator runs it
    assert replays["n_mid"] < len(jest.trajectory)


def test_port_replay_matches_jax(replays):
    jest, test = replays["jest"], replays["test"]
    assert [t for t, *_ in test.trajectory] == \
        [t for t, *_ in jest.trajectory]
    np.testing.assert_allclose(_positions(test), _positions(jest),
                               rtol=0, atol=POS_TOL_M)
    assert replays["tfixed"] == replays["jfixed"]
    assert fix_differences(test._last_fix) == fix_differences(jest._last_fix)
    assert test._chain_stats == jest._chain_stats
    # the fixed double differences are the simulated integers
    sim, bias = replays["sim"], test.gnss.bias
    assert test._last_fix
    for slot_i, slot_r, n in test._last_fix:
        true_dd = (sim.rtk_ambiguities[bias.key[slot_i][1]]
                   - sim.rtk_ambiguities[bias.key[slot_r][1]])
        assert n == int(true_dd)


def test_port_resumes_jax_checkpoint(replays):
    jest, resumed = replays["jest"], replays["resumed"]
    n_mid = replays["n_mid"]
    tail = jest.trajectory[n_mid:]
    assert [t for t, *_ in resumed.trajectory] == [t for t, *_ in tail]
    np.testing.assert_allclose(_positions(resumed),
                               np.stack([p for (_, p, _, _) in tail]),
                               rtol=0, atol=POS_TOL_M)
    assert replays["rfixed"] == replays["jfixed"][-len(replays["rfixed"]):]
    assert fix_differences(resumed._last_fix) == \
        fix_differences(jest._last_fix)
    assert resumed.frame_count == jest.frame_count
    np.testing.assert_allclose(resumed.x.p, np.asarray(jest.x.p), rtol=0,
                               atol=POS_TOL_M)


def test_jax_resumes_port_checkpoint(replays):
    jest, jresumed = replays["jest"], replays["jresumed"]
    tail = jest.trajectory[replays["n_mid"]:]
    assert [t for t, *_ in jresumed.trajectory] == [t for t, *_ in tail]
    np.testing.assert_allclose(_positions(jresumed),
                               np.stack([p for (_, p, _, _) in tail]),
                               rtol=0, atol=POS_TOL_M)
    assert jresumed.rtk_fixed
    assert fix_differences(jresumed._last_fix) == \
        fix_differences(jest._last_fix)
