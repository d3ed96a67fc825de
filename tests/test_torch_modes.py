"""The estimator's navigation modes: the port's f64 replay against the JAX
estimator's, on the CPU, one case per mode.

The cases are ``pipeline.replay.MODE_CASES``: VI-only, inverse depth,
stereo with world points and with inverse depth, SPP-VI with chains off,
SPP-VI with carrier phase, RTD-VI, SPP correction, the magnetometer yaw,
and RTK-VI at the bench's chain caps (32 / 512; tests/test_torch_pipeline.py
holds RTK-VI at the test tier's 8 / 256).  Each uses its JAX test's
configuration on a 5 s sequence of the JAX simulator with the test's seed
(the JAX tests run 10 s, the magnetometer's 8 s; 5 s fills the window and
marginalizes its oldest frame).

For each case, ``tests/torch_mode_refs.py`` replays the sequence through
the JAX estimator in a process of its own (every JAX compile stays out of
the pytest worker) and writes the simulator's arrays with the result.
Those outputs are stored in ``tests/data/torch_modes/`` (recorded with
``python tests/torch_mode_refs.py --record``); a case uses its stored
file where the manifest matches this tree (the jax, jaxlib and numpy
versions, the JAX package's sources, the helper, the case's keyword
arguments) and otherwise runs the JAX replay live, printing why.  The
witness, ``test_mode_reference_is_current``, replays WITNESS live in
every run and holds the stored file to it.  The worker feeds the
simulator's arrays through the same event loop to the port's
``Estimator(device="cpu")`` in float64 and holds:

  - every frame's time, ``initialized``, ``frame_count``, the per-event
    ``rtk_fixed`` flags and the chain statistics equal to JAX's;
  - every frame's position within POS_TOL_M of JAX's;
  - the mode's own state against JAX's: the SPP clock and drift slots of
    the newest GNSS frame (spp, POS_TOL_M in m and m/s), the active float
    ambiguities differenced against the first (spp_cp, spp_correction,
    AMB_TOL_CYC), the attitude the initialization set (mag, ATT_TOL_RAD),
    the last fix as reference-free integer differences (rtk_full_caps);
  - the JAX test's bounds against the truth on the port's trajectory, so
    that the two do not agree on a wrong answer.
"""

import numpy as np
import pytest
import torch

from rtk_visual_inertial_navigation_tpu_torch.ambiguity import \
    fix_differences
from rtk_visual_inertial_navigation_tpu_torch.config import EstimatorConfig
from rtk_visual_inertial_navigation_tpu_torch.ops import lie
from rtk_visual_inertial_navigation_tpu_torch.pipeline import Estimator
from rtk_visual_inertial_navigation_tpu_torch.pipeline.replay import (
    MODE_CASES, mode_config_kwargs, mode_sim_kwargs, mode_truth,
    replay_mode)
from rtk_visual_inertial_navigation_tpu_torch.sim import SimConfig
from rtk_visual_inertial_navigation_tpu_torch.sim.synthetic import SimData

from torch_mode_refs import (DURATION, estimator_arrays, load_stored,
                             record_events, reference, run_reference,
                             stale_reason)

torch.set_num_threads(1)

# float64 on both sides: the same decisions, positions apart by roundoff
POS_TOL_M = 1e-6
AMB_TOL_CYC = 1e-6
ATT_TOL_RAD = 1e-6
# the stored JAX replay against a live one of the same tree and jax build
WITNESS = "vi"
WITNESS_TOL_M = 1e-9
WITNESS_FLOATS = ("traj_p", "x_clk", "phase_bias", "q_init")


def _sim_from(ref, case):
    """The port's ``SimData`` holding the JAX simulator's arrays."""
    fields = {k[4:]: v for k, v in ref.items() if k.startswith("sim_")}
    fields["clk_drift"] = float(fields["clk_drift"])
    return SimData(cfg=SimConfig(**mode_sim_kwargs(case, DURATION)),
                   **fields)


def _angle(q1, q0):
    return float(torch.linalg.norm(lie.quat_boxminus(
        torch.from_numpy(q1), torch.from_numpy(q0))))


def _active(arrs, kind):
    """{key: value} of the active phase-bias slots of ``kind``."""
    return {k: v for k, a, v in zip(arrs["bias_keys"], arrs["bias_active"],
                                    arrs["phase_bias"])
            if a and k.split(",")[0] == kind}


def _same_ambiguities(got, ref, kind):
    """The same active slots of ``kind``, their values differenced against
    the first slot's within AMB_TOL_CYC."""
    amb, jamb = _active(got, kind), _active(ref, kind)
    assert sorted(amb) == sorted(jamb)
    assert amb, f"no active {kind} ambiguity"
    keys = sorted(amb)
    np.testing.assert_allclose(
        [amb[k] - amb[keys[0]] for k in keys],
        [jamb[k] - jamb[keys[0]] for k in keys], rtol=0, atol=AMB_TOL_CYC)


def _same_spp_clock(got, ref):
    """The SPP clock and drift slots of the newest GNSS frame."""
    fc = int(got["frame_count"])
    gframes = np.flatnonzero(got["frame_is_gnss"][:fc])
    assert len(gframes), "the window should hold GNSS frames"
    np.testing.assert_array_equal(
        gframes, np.flatnonzero(ref["frame_is_gnss"][:fc]))
    # the GPS f0 SPP clock slot and the drift slot
    f = gframes[-1]
    np.testing.assert_allclose(got["x_clk"][f, [6, 12]],
                               ref["x_clk"][f, [6, 12]], rtol=0,
                               atol=POS_TOL_M)


def _same_initial_attitude(got, ref):
    assert _angle(got["q_init"], ref["q_init"]) <= ATT_TOL_RAD


def _same_fix(got, ref):
    assert got["fixed"][-1] and bool(len(got["last_fix"]))
    assert fix_differences(got["last_fix"]) == \
        fix_differences(ref["last_fix"])


# the mode's own state against JAX's
MODE_STATE = {
    "spp": _same_spp_clock,
    "spp_cp": lambda got, ref: _same_ambiguities(got, ref, "spp"),
    "spp_correction": lambda got, ref: _same_ambiguities(got, ref, "cor"),
    "mag": _same_initial_attitude,
    "rtk_full_caps": _same_fix,
}


@pytest.mark.parametrize("case", list(MODE_CASES))
def test_mode_matches_jax(case, tmp_path):
    ref = reference(case, str(tmp_path / f"{case}.npz"))
    sim = _sim_from(ref, case)
    est = Estimator(EstimatorConfig(**mode_config_kwargs(case, sim)),
                    device="cpu")
    on_event, extra = record_events(est)
    replay_mode(est, case, sim, on_event=on_event)
    got = dict(estimator_arrays(est), **extra())

    assert bool(ref["initialized"]) and bool(got["initialized"])
    assert int(got["frame_count"]) == int(ref["frame_count"])
    np.testing.assert_array_equal(got["traj_t"], ref["traj_t"])
    diff = np.abs(got["traj_p"] - ref["traj_p"]).max()
    print(f"{case}: {len(got['traj_t'])} frames, largest position "
          f"difference from JAX {diff:.3e} m")
    np.testing.assert_allclose(got["traj_p"], ref["traj_p"], rtol=0,
                               atol=POS_TOL_M)
    np.testing.assert_array_equal(got["fixed"], ref["fixed"])
    np.testing.assert_array_equal(got["chain_stats"], ref["chain_stats"])

    if case in MODE_STATE:
        MODE_STATE[case](got, ref)
    errs, fails = mode_truth(case, est, sim)
    print(f"{case}: against the truth {errs}")
    assert not fails, (fails, errs)


def test_mode_reference_is_current(tmp_path):
    """The stored reference of WITNESS stands for the JAX package as it
    runs now: its manifest matches, and a live JAX replay gives the same
    simulator arrays, frame times, flags, chain statistics and counts, and
    the estimator's float states (WITNESS_FLOATS) within WITNESS_TOL_M."""
    why = stale_reason(WITNESS)
    assert why is None, why
    stored = load_stored(WITNESS)
    live = run_reference(WITNESS, str(tmp_path / f"{WITNESS}.npz"))
    assert sorted(stored) == sorted(live)
    for k, v in live.items():
        if k in WITNESS_FLOATS:
            np.testing.assert_allclose(stored[k], v, rtol=0,
                                       atol=WITNESS_TOL_M, err_msg=k)
        else:
            np.testing.assert_array_equal(stored[k], v, err_msg=k)
    worst = max(float(np.abs(stored[k] - live[k]).max(initial=0.0))
                for k in WITNESS_FLOATS)
    print(f"{WITNESS}: stored against live, {len(live['traj_t'])} frames, "
          f"largest difference in {WITNESS_FLOATS} {worst:.3e}")
