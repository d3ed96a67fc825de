"""The port's image frontend (cameras, Shi-Tomasi + LK tracker, RANSAC and
``TrackerFrontend``) against the JAX package, on the CPU.

Tolerances, each stated where it is held:

  - cameras, float64: ``distort``, ``space_to_plane`` and
    ``lift_projective`` within 1e-12 relative (the same arithmetic in the
    same order; only libm's last bits may differ);
  - Shi-Tomasi response: float64 within 1e-12 of its largest value; float32
    within RESP_F32_RTOL of it (JAX sums the box filter in float32, the
    port in float64, rounding once);
  - ``select_features``: the same corners wherever the JAX response's gap
    between a pick and the best pixel it suppressed or beat is larger than
    that tolerance (every pick of these images; the rule is checked);
  - bilinear patches in float64 within 1e-12, off-image points included;
  - LK tracks within LK_PX_TOL pixels (float32 patch sums add in another
    order), the same ``ok`` flags;
  - RANSAC: the port's scoring of JAX's own hypotheses gives JAX's inlier
    mask (``jax.random`` streams cannot be reproduced in torch);
  - ``TrackerFrontend`` frame by frame, mono with ``GyroPredictor`` and
    stereo: the same ids, pixels within LK_PX_TOL, rays within RAY_TOL,
    with both frontends detecting on the JAX response (on these renders
    the response falls to its float32 noise floor before K corners are
    found, and there the picks are roundoff ties).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtk_visual_inertial_navigation_tpu.frontend import tracker as jtr
from rtk_visual_inertial_navigation_tpu.frontend import \
    tracker_frontend as jfe
from rtk_visual_inertial_navigation_tpu.models import cameras as jcam
from rtk_visual_inertial_navigation_tpu_torch.frontend import tracker as ttr
from rtk_visual_inertial_navigation_tpu_torch.frontend import \
    tracker_frontend as tfe
from rtk_visual_inertial_navigation_tpu_torch.models import cameras as tcam
from rtk_visual_inertial_navigation_tpu_torch.ops import lie
from rtk_visual_inertial_navigation_tpu_torch.sim import SimConfig, simulate

from test_frontend_robustness import _smooth_image, _two_view
from test_torch_jax_ref import cheap_jit
from test_tracker import make_texture, shift_image
from test_tracker_frontend import F, H, W, render, render_xy

torch.set_num_threads(1)

CAM_RTOL = 1e-12
RESP_F32_RTOL = 1e-6
LK_PX_TOL = 1e-4
RAY_TOL = 1e-6

CAMERAS = {
    "pinhole": dict(fx=460.0, fy=458.0, cx=376.0, cy=240.0, k1=-0.28,
                    k2=0.07, p1=2e-4, p2=1.8e-4),
    "pinhole_full": dict(fx=1015.0, fy=1014.6, cx=357.8, cy=217.3,
                         k1=-0.3949, k2=0.1500, k3=0.01, k4=-0.02,
                         k5=0.004, k6=0.001, p1=0.0042, p2=0.0041),
    "equidistant": dict(mu=380.0, mv=379.0, u0=376.0, v0=240.0, k2=0.01,
                        k3=-0.002, k4=0.0005, k5=-1e-4),
    "mei": dict(xi=0.9, gamma1=470.0, gamma2=469.0, u0=376.0, v0=240.0,
                k1=-0.1, k2=0.02, p1=5e-4, p2=-3e-4),
    "mei_xi1": dict(xi=1.0, gamma1=470.0, gamma2=469.0, u0=376.0, v0=240.0,
                    k1=-0.05, k2=0.01),
    "scaramuzza": dict(poly=(-250.0, 0.0, 9e-4, -2e-7, 6e-10),
                       inv_poly=tuple(np.linspace(300.0, -2.0, 20)
                                      * 0.5 ** np.arange(20)),
                       center_x=376.0, center_y=240.0, C=1.01, D=0.002,
                       E=-0.003),
}


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_camera_models_match_jax(name):
    model = name.replace("_xi1", "")
    jc = jcam.make_camera(model, **CAMERAS[name])
    tc = tcam.make_camera(model, **CAMERAS[name])
    assert type(tc).__name__ == type(jc).__name__
    rng = np.random.default_rng(11)
    # two leading dimensions, pixels over the 752x480 image, 3-D points in
    # front of the camera and, for the wide models, beside it
    uv = np.stack([rng.uniform(40, 712, (3, 40)),
                   rng.uniform(40, 440, (3, 40))], -1)
    pts = np.concatenate([rng.uniform(-1.5, 1.5, (3, 40, 2)),
                          rng.uniform(0.3, 4.0, (3, 40, 1))], -1)
    t = torch.from_numpy
    _close(tc.space_to_plane(t(pts)), jc.space_to_plane(jnp.asarray(pts)),
           CAM_RTOL)
    _close(tc.lift_projective(t(uv)), jc.lift_projective(jnp.asarray(uv)),
           CAM_RTOL)
    if hasattr(jc, "distort"):
        xy = pts[..., :2] / pts[..., 2:]
        _close(tc.distort(t(xy)), jc.distort(jnp.asarray(xy)), CAM_RTOL)
    if model in ("pinhole", "pinhole_full", "mei"):
        # a fixed iteration count other than the default
        _close(tc.lift_projective(t(uv), iters=3),
               jc.lift_projective(jnp.asarray(uv), iters=3), CAM_RTOL)
    # the singular-Jacobian guard: k1 < 0 folds the pinhole map at
    # r² = -1/(3 k1); a pixel there has |det| < 1e-12 on the first step
    fold = tcam.PinholeCamera(fx=1.0, fy=1.0, cx=0.0, cy=0.0, k1=-1.0 / 3.0)
    jfold = jcam.PinholeCamera(fx=1.0, fy=1.0, cx=0.0, cy=0.0, k1=-1.0 / 3.0)
    uvf = np.array([[2.0 / 3.0, 0.0], [0.3, 0.2]])
    _close(fold.lift_projective(t(uvf)),
           jfold.lift_projective(jnp.asarray(uvf)), CAM_RTOL)


YAMLS = {
    "pinhole": """model_type: PINHOLE
distortion_parameters:
 k1: -0.28
 k2: 0.07
 p1: 0.0002
 p2: 0.00018
projection_parameters:
 fx: 460.0
 fy: 458.0
 cx: 376.0
 cy: 240.0
""",
    "pinhole_full": """model_type: PINHOLE_FULL
camera_name: camera
image_width: 752
image_height: 480
distortion_parameters:
 k1: -0.39487217332971936
 k2: 0.14996535673985056
 p1: 0.004208275260446886
 p2: 0.004117903853456536
projection_parameters:
 fx: 1015.0025439725143
 fy: 1014.566094746851
 cx: 357.7725018103044
 cy: 217.2992298065791
""",
    "kannala_brandt": """model_type: KANNALA_BRANDT
projection_parameters:
 k2: 0.01
 k3: -0.002
 k4: 0.0005
 k5: -0.0001
 mu: 380.0
 mv: 379.0
 u0: 376.0
 v0: 240.0
""",
    "mei": """model_type: MEI
camera_name: "cam0"
mirror_parameters:
 xi: 0.9
distortion_parameters:
 k1: -0.1
 k2: 0.02
 p1: 0.0005
 p2: -0.0003
projection_parameters:
 gamma1: 470.0
 gamma2: 469.0
 u0: 376.0
 v0: 240.0
""",
    "scaramuzza": """model_type: SCARAMUZZA
poly_parameters:
 p0: -250.0
 p1: 0.0
 p2: 0.0009
 p3: -2e-07
 p4: 6e-10
inv_poly_parameters:
 p0: 300.0
 p1: 120.5
 p2: -3.25
affine_parameters:
 ac: 1.01
 ad: 0.002
 ae: -0.003
 cx: 376.0
 cy: 240.0
""",
}


@pytest.mark.parametrize("name", sorted(YAMLS))
def test_load_camera_yaml_matches_jax(tmp_path, name):
    path = tmp_path / f"{name}.yaml"
    path.write_text("%YAML:1.0\n---\n" + YAMLS[name])
    jc, tc = jcam.load_camera_yaml(path), tcam.load_camera_yaml(path)
    assert type(tc).__name__ == type(jc).__name__
    assert tuple(tc) == tuple(jc)


def test_make_camera_dispatch_matches_jax():
    for model, kw in (("pinhole", dict(fx=1, fy=1, cx=0, cy=0)),
                      ("PINHOLE_FULL", dict(fx=1, fy=1, cx=0, cy=0)),
                      ("fisheye", dict(mu=1, mv=1, u0=0, v0=0)),
                      ("kannala_brandt", dict(mu=1, mv=1, u0=0, v0=0)),
                      ("catadioptric", dict(xi=1.0, gamma1=1, gamma2=1,
                                            u0=0, v0=0)),
                      ("ocam", dict(poly=(0.0,) * 5, inv_poly=(0.0,) * 20,
                                    center_x=0.0, center_y=0.0))):
        assert type(tcam.make_camera(model, **kw)).__name__ == \
            type(jcam.make_camera(model, **kw)).__name__
    with pytest.raises(ValueError):
        tcam.make_camera("nope")


def _pick_gaps(resp, pts, ok, min_dist, border=8):
    """For each pick of JAX's greedy selection on ``resp``: how far its
    response lies above the best pixel it beat (the next-best pixel of the
    candidates left at its step).  A gap above the float32 tolerance means
    a roundoff of the response cannot change the pick."""
    r = resp.astype(float)
    Hh, Ww = r.shape
    yy, xx = np.mgrid[0:Hh, 0:Ww]
    inb = ((yy >= border) & (yy < Hh - border)
           & (xx >= border) & (xx < Ww - border))
    r = np.where(inb, r, -np.inf)
    gaps = []
    for (x, y), good in zip(pts.astype(int), ok):
        if not good:
            break
        best = r[y, x]
        r2 = r.copy()
        r2[y, x] = -np.inf
        gaps.append((best - r2.max()) / np.abs(resp).max())
        r = np.where((yy - y) ** 2 + (xx - x) ** 2 <= min_dist ** 2,
                     -np.inf, r)
    return np.asarray(gaps)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_response_and_selection_match_jax(dtype):
    img = make_texture(np.random.default_rng(0)).astype(dtype)
    rj = np.asarray(jtr.shi_tomasi_response(jnp.asarray(img)))
    rt = ttr.shi_tomasi_response(torch.from_numpy(img)).numpy()
    tol = 1e-12 if dtype == np.float64 else RESP_F32_RTOL
    np.testing.assert_allclose(rt, rj, rtol=0, atol=tol * np.abs(rj).max())

    # selection on each package's own response; held where JAX's gaps
    # exceed the response tolerance
    pj, oj = jtr.select_features(jnp.asarray(rj), k=30, min_dist=12)
    pt, ot = ttr.select_features(torch.from_numpy(rt), k=30, min_dist=12)
    pj, oj = np.asarray(pj), np.asarray(oj)
    gaps = _pick_gaps(rj, pj, oj, 12)
    assert oj.sum() >= 10 and gaps.min() > 2 * tol, gaps.min()
    np.testing.assert_array_equal(ot.numpy(), oj)
    np.testing.assert_array_equal(pt.numpy(), pj)

    # with a mask, on the same response
    mask = np.ones(rj.shape, bool)
    mask[30:80, 40:120] = False
    pm, om = jtr.select_features(jnp.asarray(rj), k=20, min_dist=8,
                                 border=5, mask=jnp.asarray(mask))
    qm, wm = ttr.select_features(torch.from_numpy(rj), k=20, min_dist=8,
                                 border=5, mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(qm.numpy(), np.asarray(pm))
    np.testing.assert_array_equal(wm.numpy(), np.asarray(om))


def test_bilinear_patch_matches_jax_off_image():
    """float64 image and points, centers on, near and off the image."""
    rng = np.random.default_rng(4)
    img = rng.normal(size=(37, 53))
    c = np.concatenate([rng.uniform(0, 52, (20, 2)),
                        [[-6.3, 5.2], [60.4, 40.7], [0.5, -0.5],
                         [52.0, 36.0], [-0.0, 0.0], [25.25, 18.75]]])
    patch = jax.vmap(lambda q: jtr._patch(jnp.asarray(img), q, 4))
    ref = np.asarray(patch(jnp.asarray(c)))
    got = ttr._patch(torch.from_numpy(img), torch.from_numpy(c), 4).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    # float32 image at float64 points: weights in float64, result float32
    ref32 = np.asarray(jax.vmap(lambda q: jtr._patch(
        jnp.asarray(img, jnp.float32), q, 4))(jnp.asarray(c)))
    got32 = ttr._patch(torch.from_numpy(img.astype(np.float32)),
                       torch.from_numpy(c), 4)
    assert got32.dtype == torch.float32
    np.testing.assert_array_equal(got32.numpy(), ref32)


def _pyramids(img0, img1, levels, dtype):
    jp = [jtr.build_pyramid(jnp.asarray(a.astype(dtype)), levels)
          for a in (img0, img1)]
    tp = [ttr.build_pyramid(torch.from_numpy(a.astype(dtype)), levels)
          for a in (img0, img1)]
    for a, b in zip(jp[0] + jp[1], tp[0] + tp[1]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    return jp, tp


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lk_matches_jax(dtype):
    """tests/test_tracker.py's translation and occlusion cases, and
    tests/test_frontend_robustness.py's guided large motion."""
    t = torch.from_numpy
    rng = np.random.default_rng(2)
    img0 = make_texture(rng)
    img1 = np.array(shift_image(img0, 2.0, 1.0))
    img1[40:80, 60:110] = 0.0
    (j0, j1), (t0, t1) = _pyramids(img0, img1, 3, dtype)
    pts, ok = jtr.select_features(jtr.shi_tomasi_response(
        jnp.asarray(img0)), k=30, min_dist=8)
    pts, ok = np.asarray(pts, np.float64), np.asarray(ok)
    for fn_j, fn_t in ((jtr.lk_track, ttr.lk_track),
                       (jtr.lk_track_fb, ttr.lk_track_fb)):
        nj, okj = fn_j(j0, j1, jnp.asarray(pts), jnp.asarray(ok), 9, 15)
        nt, okt = fn_t(t0, t1, t(pts), t(ok), 9, 15)
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
        np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0,
                                   atol=LK_PX_TOL)

    rng = np.random.default_rng(2)
    img0 = _smooth_image(rng)
    yy, xx = np.mgrid[0:96, 0:128].astype(float)
    from scipy import ndimage as ni
    img1 = ni.map_coordinates(img0, [yy + 13.0, xx + 21.0], order=1,
                              mode="nearest")
    (j0, j1), (t0, t1) = _pyramids(img0, img1, 3, dtype)
    pts = np.array([[40.0, 40.0], [70.0, 50.0], [90.0, 30.0]])
    guess = pts - [21.0, 13.0] + rng.normal(size=(3, 2))
    valid = np.ones(3, bool)
    nj, okj = jtr.lk_track(j0, j1, jnp.asarray(pts), jnp.asarray(valid),
                           win=9, iters=15, guess=jnp.asarray(guess))
    nt, okt = ttr.lk_track(t0, t1, t(pts), t(valid), win=9, iters=15,
                           guess=t(guess))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0,
                               atol=LK_PX_TOL)


def _jax_hypotheses(valid, n_hyp=128, seed=0):
    """The row indices jax.random.choice draws inside the JAX package's
    ``ransac_essential`` (tracker.py:202-206)."""
    K = len(valid)
    p = jnp.asarray(np.asarray(valid)).astype(jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    idx = jax.random.choice(jax.random.PRNGKey(seed), K, shape=(n_hyp, 8),
                            replace=True, p=p)
    return torch.from_numpy(np.array(idx)).long()


def test_ransac_scoring_of_jax_hypotheses_matches_jax():
    rng = np.random.default_rng(0)
    xy0, xy1 = _two_view(rng)
    n = len(xy0)
    bad = np.zeros(n, dtype=bool)
    bad[rng.choice(n, size=12, replace=False)] = True
    xy1[bad] += rng.uniform(0.05, 0.2, size=(12, 2)) \
        * rng.choice([-1, 1], size=(12, 2))
    valid = np.ones(n, bool)
    valid[[3, 17]] = False
    for seed in (0, 5):
        inl_j, ok_j = jtr.ransac_essential(
            jnp.asarray(xy0), jnp.asarray(xy1), jnp.asarray(valid),
            seed=seed)
        inl_t, ok_t = ttr.ransac_score(
            torch.from_numpy(xy0), torch.from_numpy(xy1),
            torch.from_numpy(valid), _jax_hypotheses(valid, seed=seed))
        assert bool(ok_t) and bool(ok_j)
        np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
        assert not (inl_t.numpy() & bad).any()
    # the port's own sampler: valid rows only, reproducible, and the gate
    # still rejects every planted outlier
    idx = ttr.ransac_hypotheses(valid, seed=3)
    assert idx.shape == (128, 8) and valid[idx.numpy()].all()
    assert torch.equal(idx, ttr.ransac_hypotheses(valid, seed=3))
    inl, ok = ttr.ransac_essential(torch.from_numpy(xy0),
                                   torch.from_numpy(xy1),
                                   torch.from_numpy(valid), seed=3)
    assert bool(ok) and not (inl.numpy() & bad).any()
    assert inl.numpy()[~bad & valid].mean() >= 0.85
    # below the minimal set the gate is off: the mask is the valid mask
    few = np.zeros(n, bool)
    few[:5] = True
    inl, ok = ttr.ransac_essential(torch.from_numpy(xy0),
                                   torch.from_numpy(xy1),
                                   torch.from_numpy(few))
    assert not bool(ok)
    np.testing.assert_array_equal(inl.numpy(), few)


@pytest.fixture
def jax_frontend(monkeypatch):
    """The JAX frontend with its detection and RANSAC steps compiled once
    each (cheap XLA options) instead of dispatched op by op, and the port's
    frontend drawing JAX's RANSAC hypotheses and detecting on JAX's
    response.  LK stays as the JAX frontend runs it, op by op: compiled
    whole, XLA sums the float32 patches in another order, and a track on
    the edge of the forward-backward test can flip."""
    sel = cheap_jit(lambda r, k, md, mask: jtr.select_features(
        r, k, md, mask=mask), static_argnums=(1, 2))
    monkeypatch.setattr(jfe, "select_features",
                        lambda r, k, md, mask: sel(r, k, md, mask))
    resp = cheap_jit(jtr.shi_tomasi_response)
    monkeypatch.setattr(jfe, "shi_tomasi_response", resp)
    # the corners are picked from JAX's response on both sides: where it
    # has fallen to the float32 noise floor, the last picks of the two
    # responses are ties that roundoff decides
    # (test_response_and_selection_match_jax holds the responses)
    monkeypatch.setattr(tfe, "shi_tomasi_response", lambda img: torch.tensor(
        np.asarray(resp(jnp.asarray(img.numpy())))))
    monkeypatch.setattr(jfe, "build_pyramid",
                        cheap_jit(jtr.build_pyramid, static_argnums=(1,)))
    ransac = cheap_jit(lambda a, b, v, th, seed: jtr.ransac_essential(
        a, b, v, th, seed=seed))
    monkeypatch.setattr(jfe, "ransac_essential",
                        lambda a, b, v, th, seed: ransac(a, b, v, th, seed))
    monkeypatch.setattr(tfe, "ransac_hypotheses", _jax_hypotheses)
    return jfe


def _same_frame(out_j, out_t, fe_j, fe_t):
    for ids_j, ids_t in zip(out_j[0::2], out_t[0::2]):
        np.testing.assert_array_equal(ids_t, ids_j)
    for xy_j, xy_t in zip(out_j[1::2], out_t[1::2]):
        np.testing.assert_allclose(xy_t, xy_j, rtol=0, atol=RAY_TOL)
    np.testing.assert_array_equal(fe_t.ok, fe_j.ok)
    np.testing.assert_array_equal(fe_t.ids, fe_j.ids)
    np.testing.assert_allclose(fe_t.pts, fe_j.pts, rtol=0, atol=LK_PX_TOL)


# frames 20-27 (t = 2.0-2.7 s, after the static lead): motion, lost
# tracks and refills
MONO_FRAMES = range(20, 28)


def test_tracker_frontend_mono_with_gyro_matches_jax(jax_frontend):
    """tests/test_tracker_frontend.py's rendered sequence (its wiring
    test's simulation, MONO_FRAMES) with GyroPredictor guesses."""
    sim = simulate(SimConfig(duration=2.8, imu_rate=200.0, cam_rate=10.0,
                             n_landmarks=50, n_sats=4, seed=5))
    q_ic = lie.rot_to_quat(torch.from_numpy(sim.cfg.r_ic)).numpy()
    fe_j = jax_frontend.TrackerFrontend(
        jcam.PinholeCamera(fx=F, fy=F, cx=W / 2, cy=H / 2), max_cnt=48,
        min_dist=10)
    fe_t = tfe.TrackerFrontend(
        tcam.PinholeCamera(fx=F, fy=F, cx=W / 2, cy=H / 2), max_cnt=48,
        min_dist=10, device="cpu")
    gp_j = jax_frontend.GyroPredictor(fe_j.cam, q_ic)
    gp_t = tfe.GyroPredictor(fe_t.cam, q_ic)
    n_first = None
    for i, t in enumerate(sim.imu_t):
        gp_j.feed_imu(t, sim.gyr[i])
        gp_t.feed_imu(t, sim.gyr[i])
        fi = np.searchsorted(sim.cam_idx, i)
        if fi in MONO_FRAMES and sim.cam_idx[fi] == i:
            guess_j, guess_t = gp_j.predict(fe_j), gp_t.predict(fe_t)
            assert guess_t.keys() == guess_j.keys()
            for k in guess_j:      # rotations of points LK_PX_TOL apart
                np.testing.assert_allclose(guess_t[k], guess_j[k], rtol=0,
                                           atol=LK_PX_TOL)
            img = render(sim, fi)
            out_j = fe_j.process(img, predicted=guess_j)
            out_t = fe_t.process(img, predicted=guess_t)
            _same_frame(out_j, out_t, fe_j, fe_t)
            n_first = n_first or fe_t._next_id
    print(f"ids: {n_first} after the first frame, {fe_t._next_id} in all")
    assert fe_t._frame_no == len(MONO_FRAMES) and fe_t._next_id > n_first


def test_tracker_frontend_stereo_matches_jax(jax_frontend):
    """tests/test_tracker_frontend.py::test_stereo_left_right_tracking's
    sequence."""
    sim = simulate(SimConfig(duration=2.0, imu_rate=100.0, cam_rate=4.0,
                             n_landmarks=40, n_sats=4, seed=9,
                             stereo=True, baseline=0.12))
    fe_j = jax_frontend.TrackerFrontend(
        jcam.PinholeCamera(fx=F, fy=F, cx=W / 2, cy=H / 2), max_cnt=48,
        min_dist=10)
    fe_t = tfe.TrackerFrontend(
        tcam.PinholeCamera(fx=F, fy=F, cx=W / 2, cy=H / 2), max_cnt=48,
        min_dist=10, device="cpu")
    n_right = 0
    for fi in range(6):
        left = render_xy(sim.obs_xy[fi], sim.obs_valid[fi])
        right = render_xy(sim.obs_xy_r[fi], sim.obs_valid_r[fi])
        out_j = fe_j.process(left, img_right=right)
        out_t = fe_t.process(left, img_right=right)
        assert len(out_t) == 4
        _same_frame(out_j, out_t, fe_j, fe_t)
        n_right += len(out_t[2])
    assert n_right >= 10


def test_refill_mask_matches_host_loop():
    """The frontend's batched suppression mask equals the JAX frontend's
    host loop over the live points (tracker_frontend.py:150-156),
    including points near and on the border and a fractional radius."""
    rng = np.random.default_rng(6)
    for min_dist in (10, 7.5):
        fe = tfe.TrackerFrontend(tcam.PinholeCamera(1.0, 1.0, 0.0, 0.0),
                                 max_cnt=30, min_dist=min_dist,
                                 device="cpu")
        fe.pts = np.concatenate([rng.uniform(-3, 70, (27, 2)),
                                 [[0.0, 0.0], [63.0, 47.0], [31.5, 20.25]]])
        fe.ok = rng.uniform(size=30) < 0.8
        Hh, Ww = 48, 64
        mask = np.ones((Hh, Ww), dtype=bool)
        yy, xx = np.mgrid[0:Hh, 0:Ww]
        for p in fe.pts[fe.ok]:
            mask &= ((yy - p[1]) ** 2 + (xx - p[0]) ** 2) > min_dist ** 2
        np.testing.assert_array_equal(fe._refill_mask(Hh, Ww).numpy(), mask)
