"""The modules of the ported estimator pipeline against their JAX
counterparts, float64 on the CPU, on inputs made from numpy seeds.

Tolerances: the copies of numpy-only modules (GNSS preprocessing, LAMBDA
and double differences, the feature table, the host marginalization) are
held to equality or to 1e-12 relative; the torch rewrites of jnp code
(simulator geometry, triangulation, PnP, mag factors, preintegration
merging, chain truncation) to 1e-9 relative (roundoff of a few hundred
operations; f64 eps is 2.2e-16), the simulator to 1e-12 relative.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_jax_ref import cheap_jit

from rtk_visual_inertial_navigation_tpu import ambiguity as jamb
from rtk_visual_inertial_navigation_tpu.core.state import \
    WindowState as JWindowState
from rtk_visual_inertial_navigation_tpu.factors import inertial as jinertial
from rtk_visual_inertial_navigation_tpu.factors.inertial import \
    merge_preintegrations as jax_merge
from rtk_visual_inertial_navigation_tpu.factors.mag import \
    mag_factor_batch as jax_mag
from rtk_visual_inertial_navigation_tpu.factors.mag import \
    yaw_from_mag as jax_yaw_from_mag
from rtk_visual_inertial_navigation_tpu.factors.visual import \
    invdepth_projection_batch as jax_invdepth
from rtk_visual_inertial_navigation_tpu.frontend.features import \
    FeatureTable as JFeatureTable
from rtk_visual_inertial_navigation_tpu.frontend.pnp import \
    pnp_pose as jax_pnp
from rtk_visual_inertial_navigation_tpu.frontend.triangulation import \
    triangulate_landmarks as jax_tri
from rtk_visual_inertial_navigation_tpu.gnss.preprocess import \
    GnssPreprocessor as JGnssPreprocessor
from rtk_visual_inertial_navigation_tpu.pipeline import chains as jchains
from rtk_visual_inertial_navigation_tpu.preintegration import \
    Preintegrated as JPre
from rtk_visual_inertial_navigation_tpu.sim import SimConfig as JSimConfig
from rtk_visual_inertial_navigation_tpu.sim import simulate as jax_simulate
from rtk_visual_inertial_navigation_tpu.sim.synthetic import \
    gnss_epoch_of as jax_gnss_epoch_of
from rtk_visual_inertial_navigation_tpu.solver import chain as jchain
from rtk_visual_inertial_navigation_tpu.solver import \
    chain_factors as jchain_factors
from rtk_visual_inertial_navigation_tpu.solver import marginalization as jm
from rtk_visual_inertial_navigation_tpu_torch import ambiguity as tamb
from rtk_visual_inertial_navigation_tpu_torch.core.state import (
    TangentLayout, WindowState)
from rtk_visual_inertial_navigation_tpu_torch.factors.inertial import \
    merge_preintegrations
from rtk_visual_inertial_navigation_tpu_torch.factors.mag import (
    mag_factor_batch, yaw_from_mag)
from rtk_visual_inertial_navigation_tpu_torch.factors.robust import \
    cauchy_correct
from rtk_visual_inertial_navigation_tpu_torch.factors.visual import (
    invdepth_projection_batch, projection_factor_batch)
from rtk_visual_inertial_navigation_tpu_torch.frontend.features import \
    FeatureTable
from rtk_visual_inertial_navigation_tpu_torch.frontend.pnp import pnp_pose
from rtk_visual_inertial_navigation_tpu_torch.frontend.triangulation import \
    triangulate_landmarks
from rtk_visual_inertial_navigation_tpu_torch.gnss.preprocess import \
    GnssPreprocessor
from rtk_visual_inertial_navigation_tpu_torch.io.evaluate import \
    evaluate_trajectory
from rtk_visual_inertial_navigation_tpu_torch.ops import lie
from rtk_visual_inertial_navigation_tpu_torch.pipeline import chains as tchains
from rtk_visual_inertial_navigation_tpu_torch.preintegration.midpoint import (
    ImuNoise, preintegrate)
from rtk_visual_inertial_navigation_tpu_torch.sim import SimConfig, simulate
from rtk_visual_inertial_navigation_tpu_torch.sim.synthetic import \
    gnss_epoch_of
from rtk_visual_inertial_navigation_tpu_torch.solver import \
    marginalization as tm
from rtk_visual_inertial_navigation_tpu_torch.solver.gauss_newton import \
    assemble
from rtk_visual_inertial_navigation_tpu_torch.solver.structured import \
    projection_assemble

torch.set_num_threads(1)

T = torch.from_numpy
ROUNDOFF = 1e-9
SIM = dict(duration=2.0, imu_rate=200.0, cam_rate=4.0, gnss_rate=2.0,
           n_landmarks=30, n_sats=8, n_systems=2, dual_freq=True, seed=4,
           stereo=True, pix_noise=1e-3, pr_noise=0.3, cp_noise=0.01,
           dop_noise=0.05, acc_noise=0.01, gyr_noise=0.001, yaw0=0.3,
           p0=np.array([3.0, -2.0, 1.0]))


def _close(got, ref, rel, what="", normwise=False):
    """Elementwise |got − ref| ≤ rel·max(|ref|, 1), or with
    ``normwise=True`` ≤ rel·max(max|ref|, 1) (the products of a chain of
    Schur complements, whose small entries carry the large ones'
    roundoff)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if ref.dtype.kind in "biu":
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    scale = np.abs(ref).max(initial=0.0) if normwise else np.abs(ref)
    err = np.abs(got - ref) / np.maximum(scale, 1.0)
    assert not err.size or err.max() <= rel, (what, err.max())


@pytest.fixture(scope="module")
def jsim():
    return jax_simulate(JSimConfig(**SIM))


def test_simulate_matches_jax(jsim):
    sim = simulate(SimConfig(**SIM))
    for f in dataclasses.fields(jsim):
        if f.name == "cfg":
            continue
        _close(getattr(sim, f.name), getattr(jsim, f.name), 1e-12, f.name)


def test_gnss_preprocessor_matches_jax(jsim):
    kw = dict(use_rtk=True, use_rtd=True, use_spp_phase=True,
              use_doppler=True, initial_deweight_epochs=2)
    jpre = JGnssPreprocessor(jsim.anchor_ecef, 24, **kw)
    tpre = GnssPreprocessor(jsim.anchor_ecef, 24, **kw)
    # the same epochs (the JAX simulator's) through both
    for ei in range(len(jsim.gnss_t)):
        a = jpre.prepare(jax_gnss_epoch_of(jsim, ei))
        b = tpre.prepare(gnss_epoch_of(jsim, ei))
        for f in dataclasses.fields(a):
            x, y = getattr(b, f.name), getattr(a, f.name)
            if y is None:
                assert x is None, f.name
            else:
                _close(x, y, 1e-12, f.name)
    for k in ("active", "value", "continuity", "generation", "pinned"):
        _close(getattr(tpre.bias, k), getattr(jpre.bias, k), 0, k)
    assert tpre.bias.key == jpre.bias.key


def test_lambda_and_double_differences_match_jax():
    rng = np.random.default_rng(11)
    for n in (4, 6, 9):
        A = rng.normal(size=(n, n))
        Q = A @ A.T * 0.01 + np.eye(n) * 1e-3
        a = rng.integers(-20, 20, n) + rng.normal(0, 0.05, n)
        F0, s0 = jamb.lambda_ils(a, Q, m=2)
        F1, s1 = tamb.lambda_ils(a, Q, m=2)
        np.testing.assert_array_equal(F1, F0)
        _close(s1, s0, 1e-12, "s")
        for thr in (1.5, 3.0):
            assert tamb.partial_ratio_test(a, Q, F1, s1, thr) == \
                jamb.partial_ratio_test(a, Q, F0, s0, thr)
            assert tamb.ratio_test(s1, thr) == jamb.ratio_test(s0, thr)
        ref = tamb.choose_reference(a)
        assert ref == jamb.choose_reference(a)
        for gate in (0.2, 1.4):
            D1, m1 = tamb.double_difference(a, ref, gate)
            D0, m0 = jamb.double_difference(a, ref, gate)
            np.testing.assert_array_equal(D1, D0)
            np.testing.assert_array_equal(m1, m0)


def test_fix_differences_is_reference_free():
    # N = [3, -2, 7, 0] (slots 4-7) fixed against slot 5, then against 7
    N = {4: 3, 5: -2, 6: 7, 7: 0}
    by5 = [(s, 5, N[s] - N[5]) for s in (4, 6, 7)]
    by7 = [(s, 7, N[s] - N[7]) for s in (4, 5, 6)]
    d = tamb.fix_differences(by5)
    assert d == tamb.fix_differences(by7)
    assert d == {s: (4, N[s] - N[4]) for s in N}
    assert tamb.fix_differences(by5[:2] + [(7, 5, 1)]) != d


def test_feature_table_matches_jax(jsim):
    nl, nf = 24, 6
    ft, jft = FeatureTable(nl, nf), JFeatureTable(nl, nf)
    ids = np.arange(jsim.landmarks.shape[0])
    keys = ("obs_xy", "obs_mask", "active", "solved", "point", "feature_id")
    for fi in range(len(jsim.cam_t)):
        fidx = min(fi, nf - 1)
        vis = jsim.obs_valid[fi]
        vis_r = jsim.obs_valid_r[fi]
        for t in (ft, jft):
            t.add_frame(fidx, ids[vis], jsim.obs_xy[fi][vis], ids[vis_r],
                        jsim.obs_xy_r[fi][vis_r])
        assert ft.keyframe_decision(fidx) == jft.keyframe_decision(fidx)
        solve = jft.active & (jft.obs_mask.sum(1) >= 2)
        for t in (ft, jft):
            t.solved[solve] = True
            t.point[solve] = 1.0 + fi
        for stereo in (False, True):
            for a, b in zip(ft.observation_batch(64, stereo),
                            jft.observation_batch(64, stereo)):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(ft.invdepth_batch(64, stereo),
                            jft.invdepth_batch(64, stereo)):
                np.testing.assert_array_equal(a, b)
        if fidx == nf - 1:
            drop = 1 if fi % 2 else fidx - 1
            for t in (ft, jft):
                t.remove_frame(drop, nf - 1)
        if fi == 5:
            for t in (ft, jft):
                t.drop_slots(np.array([0, 3]))
        for k in keys:
            np.testing.assert_array_equal(getattr(ft, k), getattr(jft, k))
        assert [ft.host_frame(s) for s in range(nl)] == \
            [jft.host_frame(s) for s in range(nl)]


def _spd_info(rng, D, rank):
    J = rng.normal(size=(rank, D)) * rng.uniform(0.1, 30.0, D)
    return J.T @ J, J.T @ rng.normal(size=rank)


def test_marginalization_matches_jax():
    rng = np.random.default_rng(5)
    D = 24
    H, g = _spd_info(rng, D, 30)
    H[:, 20:] = 0.0
    H[20:, :] = 0.0          # a support-free tail, as unused prior slots
    g[20:] = 0.0
    mask = np.zeros(D, dtype=bool)
    mask[[1, 2, 7, 11, 12]] = True
    Hs0, gs0 = jm.masked_schur_np(H, g, mask)
    Hs1, gs1 = tm.masked_schur_np(H, g, mask)
    _close(Hs1, Hs0, 0, "H*")
    _close(gs1, gs0, 0, "g*")
    for a, b in zip(tm.marginalize_dense_np(H, g, mask, return_info=True),
                    jm.marginalize_dense_np(H, g, mask, return_info=True)):
        _close(a, b, 0, "marginalize_dense_np")
    J0, r0 = tm.prior_from_hessian_np(Hs1, gs1)
    _close(J0, jm.prior_from_hessian_np(Hs0, gs0)[0], 0, "J0")
    # the torch versions: eigenvector signs may differ, so the square root
    # is held through the information form it encodes
    Jt, rt = tm.marginalize_dense(T(H), T(g), T(mask))
    Jj, rj = jm.marginalize_dense(jnp.asarray(H), jnp.asarray(g),
                                  jnp.asarray(mask))
    Jj, rj = np.asarray(Jj), np.asarray(rj)
    _close((Jt.T @ Jt).numpy(), Jj.T @ Jj, ROUNDOFF, "J0ᵀJ0")
    _close((Jt.T @ rt).numpy(), Jj.T @ rj, ROUNDOFF, "J0ᵀr0")
    _close((Jt.T @ Jt).numpy(), Hs0, ROUNDOFF, "J0ᵀJ0 = H*")
    Jp, rp = tm.prior_from_hessian(T(Hs0), T(gs0))
    _close((Jp.T @ rp).numpy(), gs0, ROUNDOFF, "prior_from_hessian")


def _pre(rng, n=20, noise=ImuNoise(0.05, 0.005, 5e-4, 5e-5)):
    dts = np.full(n, 0.005)
    accs = rng.normal(size=(n, 3)) + np.array([0.0, 0.0, 9.81])
    gyrs = rng.normal(size=(n, 3)) * 0.3
    out = preintegrate(T(dts), T(accs), T(gyrs), torch.ones(n, dtype=bool),
                       T(rng.normal(size=3) * 0.01),
                       T(rng.normal(size=3) * 0.001), noise)
    return type(out)(*(x.numpy() for x in out))


def _state(rng, nf, nl, nb):
    q = rng.normal(size=(nf, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qic = rng.normal(size=(2, 4))
    qic /= np.linalg.norm(qic, axis=1, keepdims=True)
    return dict(p=rng.normal(size=(nf, 3)) * 3, q=q,
                v=rng.normal(size=(nf, 3)), ba=rng.normal(size=(nf, 3)) * .01,
                bg=rng.normal(size=(nf, 3)) * .001,
                clk=rng.normal(size=(nf, 13)),
                tic=rng.normal(size=(2, 3)) * 0.1,
                qic=qic, mag_bias=rng.normal(size=3) * 0.05,
                landmarks=rng.normal(size=(nl, 3)) * 10,
                phase_bias=rng.normal(size=nb))


def test_mag_and_merge_match_jax():
    rng = np.random.default_rng(7)
    nf = 5
    st = _state(rng, nf, 4, 3)
    fids = np.array([0, 2, 3, 4])
    mag = rng.normal(size=(4, 3))
    valid = np.array([True, True, False, True])
    ref = cheap_jit(jax_mag)(JWindowState(**st), fids, mag, valid)
    got = mag_factor_batch(
        WindowState(**{k: T(v)[None] for k, v in st.items()}),
        T(fids)[None], T(mag)[None], T(valid)[None])
    for k in ("res", "jac", "gidx"):
        _close(getattr(got, k)[0].numpy(), np.asarray(getattr(ref, k)),
               ROUNDOFF, k)
    acc, m = np.array([0.3, -0.2, 9.8]), np.array([0.1, 0.35, -0.25])
    _close(yaw_from_mag(T(acc), T(m)).numpy(),
           cheap_jit(jax_yaw_from_mag)(acc, m), ROUNDOFF,
           "yaw_from_mag")
    a, b = _pre(rng), _pre(rng)
    ref = cheap_jit(jax_merge)(JPre(*a), JPre(*b))
    got = merge_preintegrations(type(a)(*map(T, a)), type(b)(*map(T, b)))
    for x, y, name in zip(got, ref, a._fields):
        _close(x.numpy(), y, ROUNDOFF, name)


def test_invdepth_factors_match_jax():
    """Inverse-depth rows of all three kinds: mono cross-frame, stereo
    cross-frame and stereo same-frame."""
    rng = np.random.default_rng(6)
    nf, nl, nobs = 4, 6, 12
    st = _state(rng, nf, nl, 1)
    st["landmarks"][:, 0] = rng.uniform(0.05, 0.5, nl)
    host = rng.integers(0, nf, nobs)
    obs = rng.integers(0, nf, nobs)
    cam = rng.integers(0, 2, nobs)
    obs[cam == 0] = (host[cam == 0] + 1) % nf     # mono rows: two frames
    obs[:2] = host[:2]
    cam[:2] = 1                                   # stereo same-frame rows
    args = (host, obs, cam, rng.integers(0, nl, nobs),
            rng.normal(size=(nobs, 2)) * 0.3, rng.normal(size=(nobs, 2)) * .3,
            rng.uniform(size=nobs) < 0.8, np.array([0.1, 0.0, 0.2]))
    ref = cheap_jit(jax_invdepth)(JWindowState(**st), *args)
    got = invdepth_projection_batch(
        WindowState(**{k: T(v)[None] for k, v in st.items()}),
        *(T(a)[None] for a in args[:-1]), T(args[-1]))
    for k in ("res", "jac", "gidx"):
        _close(getattr(got, k)[0].numpy(), np.asarray(getattr(ref, k)),
               ROUNDOFF, k)


def test_triangulation_and_pnp_match_jax():
    rng = np.random.default_rng(3)
    nf, nl = 5, 16
    st = _state(rng, nf, nl, 1)
    lms = st["landmarks"]
    tic, qic = st["tic"][0], st["qic"][0]
    pbg = np.array([0.1, -0.05, 0.2])
    # observations: project each landmark through each frame, some masked
    from rtk_visual_inertial_navigation_tpu_torch.factors.visual import \
        project_world_point
    pc = project_world_point(T(st["p"])[None], T(st["q"])[None], T(tic),
                             T(qic), T(lms)[:, None, :], T(pbg)).numpy()
    xy = pc[..., :2] / pc[..., 2:] + rng.normal(0, 1e-3, (nl, nf, 2))
    mask = rng.uniform(size=(nl, nf)) < 0.7
    mask[0] = False
    mask[1, 1:] = False                           # one observation: not ok
    ref = cheap_jit(jax_tri)(st["p"], st["q"], tic, qic, xy, mask, pbg)
    got = triangulate_landmarks(*(T(a) for a in
                                  (st["p"], st["q"], tic, qic, xy, mask,
                                   pbg)))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    ok = np.asarray(ref[1])
    _close(got[0].numpy()[ok], np.asarray(ref[0])[ok], 1e-7, "points")

    f = 2
    valid = mask[:, f].copy()
    valid[2:10] = True
    args = (lms, xy[:, f], valid, st["p"][f] + 0.05,
            lie.quat_boxplus(T(st["q"][f]), T(np.array([0.01, -.02, .01])))
            .numpy(), tic, qic, pbg)
    ref = cheap_jit(jax_pnp)(*args)
    got = pnp_pose(*(T(a) for a in args))
    assert bool(got[2]) == bool(ref[2])
    _close(got[0].numpy(), ref[0], ROUNDOFF, "pnp p")
    _close(got[1].numpy(), ref[1], ROUNDOFF, "pnp q")


def _chain_rows(rng, n_states, nb, per_state=6):
    """Chain rows of the three kinds at states 1..n_states, realistic
    geometry (ranges ~2e7 m, reduced measurements ~m)."""
    k = n_states * per_state
    u = rng.normal(size=(k, 3))
    return dict(
        state_idx=np.repeat(np.arange(1, n_states + 1), per_state)
        .astype(np.int32),
        kind=np.tile(np.array([0, 1, 2], dtype=np.int32), k // 3),
        clk_slot=rng.integers(0, 12, k).astype(np.int32),
        pb_slot=rng.integers(0, nb, k).astype(np.int32),
        r0_unit=u / np.linalg.norm(u, axis=1, keepdims=True),
        r0=rng.uniform(2.0e7, 2.5e7, k), sat_xy=rng.normal(size=(k, 2)) * 1e7,
        sat_vel=rng.normal(size=(k, 3)) * 3e3, z=rng.normal(size=k),
        wavelength=np.full(k, 0.19), weight=rng.uniform(1.0, 10.0, k),
        gen=np.zeros(k, dtype=np.int64))


def _record(mod, rng, left, right, n_hidden, nb):
    st = _state(rng, n_hidden, 1, nb)
    pres = [_pre(rng) for _ in range(n_hidden + 1)]
    if mod is jchains:
        pres = [JPre(*p) for p in pres]
    return mod.ChainRecord(
        left=left, right=right, p=st["p"], q=st["q"], v=st["v"], ba=st["ba"],
        bg=st["bg"], clk=st["clk"], pres=pres,
        rows=_chain_rows(rng, n_hidden, nb),
        pinned_slots=np.array([1, 2]))


def _same_record(a, b):
    assert (a.left, a.right) == (b.left, b.right)
    for k in ("p", "q", "v", "ba", "bg", "clk", "pinned_slots"):
        _close(getattr(a, k), getattr(b, k), ROUNDOFF, k)
    assert a.rows.keys() == b.rows.keys()
    for k in a.rows:
        _close(a.rows[k], b.rows[k], 0, k)
    assert [p is None for p in a.pres] == [p is None for p in b.pres]
    assert len(a.mids) == len(b.mids)
    for ma, mb in zip(a.mids, b.mids):
        assert ma.keys() == mb.keys() and ma["k"] == mb["k"]
        for k in ma:
            _close(ma[k], mb[k], ROUNDOFF, f"mid {k}", normwise=True)


def test_chain_splice_and_truncate_match_jax(monkeypatch):
    # the JAX truncation calls these eagerly; compiled once they cost less
    monkeypatch.setattr(jinertial, "_single_imu", cheap_jit(
        jinertial._single_imu))
    monkeypatch.setattr(jinertial, "sqrt_info_of_cov", cheap_jit(
        jinertial.sqrt_info_of_cov))
    monkeypatch.setattr(jchain_factors, "_epoch_unaries", cheap_jit(
        jchain_factors._epoch_unaries, static_argnums=(4, 5)))
    monkeypatch.setattr(jchain, "condense_chain_tail", cheap_jit(
        jchain.condense_chain_tail))
    nb, target = 6, 4
    R_e = np.linalg.qr(np.random.default_rng(0).normal(size=(3, 3)))[0]
    pbg, g_world = np.array([0.1, 0.0, 0.2]), np.array([0.0, 0.0, 9.81])
    phase_bias = np.random.default_rng(1).normal(size=nb)
    out = {}
    for mod in (jchains, tchains):
        rng = np.random.default_rng(9)
        ends = {k: _state(rng, 3, 1, nb) for k in ("L", "R", "M")}
        end = lambda k, i: {f: ends[k][f][i] for f in ("p", "q", "v", "ba",
                                                      "bg")}
        rec = _record(mod, rng, 0, 2, 6, nb)              # 7 leaves
        t1 = mod.truncate_middle(rec, end("L", 0), end("R", 0), phase_bias,
                                 nb, R_e, pbg, g_world, target)
        right = _record(mod, rng, 2, 4, 2, nb)
        mid = {f: ends["M"][f][:1] for f in ("p", "q", "v", "ba", "bg")}
        mid["clk"] = ends["M"]["clk"][:1]
        spliced = mod.splice_records(t1, mid, right, None, None, 0, 4)
        # the spliced record carries t1's mid marginal; truncating again
        # folds it into the new one
        t2 = mod.truncate_middle(spliced, end("L", 1), end("R", 1),
                                 phase_bias, nb, R_e, pbg, g_world, target)
        out[mod] = (t1, spliced, t2)
    for a, b in zip(out[tchains], out[jchains]):
        _same_record(a, b)
    assert out[tchains][2].n_leaves == target


def test_chunked_preintegration_spans_the_whole_buffer():
    """A buffer longer than ``imu_capacity`` preintegrates in chunks that
    share their boundary sample, composed by merge_preintegrations: the
    deltas and sum_dt equal one pass over the whole buffer.  (The JAX
    estimator's chunks drop the boundary interval: ROADMAP queue 3.)  The
    Jacobian and covariance compose to first order only, so they are not
    compared."""
    from rtk_visual_inertial_navigation_tpu_torch.config import \
        EstimatorConfig
    from rtk_visual_inertial_navigation_tpu_torch.pipeline import Estimator
    rng = np.random.default_rng(8)
    n = 40
    t = np.cumsum(rng.uniform(0.004, 0.006, n))
    acc = rng.normal(size=(n, 3)) + np.array([0.0, 0.0, 9.81])
    gyr = rng.normal(size=(n, 3)) * 0.3
    out = {}
    for cap in (16, 64):
        est = Estimator(EstimatorConfig(nf=4, nl=4, nb=1, imu_capacity=cap),
                        device="cpu")
        est._imu_t, est._imu_acc, est._imu_gyr = list(t), list(acc), \
            list(gyr)
        out[cap] = est._preintegrate_buffer(0)
    one, chunked = out[64], out[16]
    _close(chunked.sum_dt, t[-1] - t[0], 1e-12, "sum_dt")
    for k in ("delta_p", "delta_q", "delta_v", "sum_dt", "gyr_i", "gyr_j"):
        _close(getattr(chunked, k), getattr(one, k), 1e-12, k)


def test_projection_assemble_matches_scatter_assemble():
    """The GPU assembles the estimator's projection rows with
    ``projection_assemble``; the CPU (and so the JAX comparison) with the
    scatter ``assemble``.  Same rows, same (H, g, cost)."""
    rng = np.random.default_rng(2)
    nf, nl, nobs = 4, 10, 40
    lay = TangentLayout(nf=nf, nl=nl, nb=3, nc=2)
    st = _state(rng, nf, nl, 3)
    st["landmarks"] = st["landmarks"] * 0.2 + np.array([0.0, 0.0, 8.0])
    state = WindowState(**{k: T(v)[None] for k, v in st.items()})
    f_ids = T(rng.integers(0, nf, nobs))[None]
    cam_ids = T(rng.integers(0, 2, nobs))[None]
    l_ids = T(rng.integers(0, nl, nobs))[None]
    xy = T(rng.normal(size=(nobs, 2)) * 0.3)[None]
    valid = T(rng.uniform(size=nobs) < 0.8)[None]
    fb = projection_factor_batch(state, f_ids, cam_ids, l_ids, xy, valid,
                                 T(np.array([0.1, 0.0, 0.2])))
    res, jac, _ = cauchy_correct(fb.res, fb.jac, 1.0)
    H0, g0, c0 = assemble([fb._replace(res=res, jac=jac)], lay.dim)
    H1, g1, c1 = projection_assemble(lay, f_ids, cam_ids, l_ids, res, jac)
    for a, b, name in ((H1, H0, "H"), (g1, g0, "g"), (c1, c0, "cost")):
        _close(a.numpy(), b.numpy(), 1e-12, name)


def test_evaluate_trajectory():
    rng = np.random.default_rng(0)
    t = np.arange(50) * 0.1
    gt = rng.normal(size=(50, 3))
    m = evaluate_trajectory(t, gt + np.array([0.0, 0.0, 0.3]), t, gt,
                            align=False)
    assert m.n_associated == 50
    np.testing.assert_allclose([m.mae_3d, m.height_rmse, m.plane_rmse],
                               [0.3, 0.3, 0.0], atol=1e-12)
    m = evaluate_trajectory(t, gt + 0.3, t, gt, align=True)
    np.testing.assert_allclose(m.mae_3d, 0.3 * np.sqrt(3), atol=1e-12)
    assert m.plane_rmse < 1e-12 and m.height_rmse < 1e-12
