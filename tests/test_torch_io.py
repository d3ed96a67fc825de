"""The port's offline io path (bag writer and readers, the native C++
codec and reader, bag replay, result CSV, publisher, timing and stats,
the reference-YAML loader) against the JAX package, on the CPU.

Held, each at the tolerance stated where it is checked:

  - bag files: the port's ``sim_to_bag`` writes the same bytes as JAX's
    ('none' and 'bz2'), and the same ground-truth CSV text;
  - readers: the port's native and Python readers give JAX's messages
    (topic, type, time, body bytes); ``encode_mea``, ``decode_mea_blob`` and
    ``mea_to_epoch`` give the same bytes and values; the native
    ``encode_epoch`` / ``decode_epochs`` round-trip every field.  (The JAX
    package's own native build is not called: it writes its library next
    to its source without a lock, and other test files build it at the
    same time.)
  - bag replay: ``replay_bag`` into the port's float64 ``Estimator`` on the
    CPU matches JAX's ``replay_bag`` frame by frame: every frame within
    REPLAY_TOL_M, the last frames within POS_TOL_M; with a
    ``ResultWriter`` attached on both sides (the same number of rows,
    values within CSV_TOL);
  - ``ResultWriter`` text, ``ecef_to_geodetic_np``, the extrinsic YAML pair,
    ``Publisher`` arrays, ``StageTimer`` reports, ``RunningStats`` and
    ``print_statistics`` strings are equal for equal inputs;
  - ``load_reference_config`` gives JAX's fields for the five mode flags
    of the reference (flags and integers equal, arrays within 1e-12).
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtk_visual_inertial_navigation_tpu.config import \
    EstimatorConfig as JEstimatorConfig
from rtk_visual_inertial_navigation_tpu.io import bag_writer as jbw
from rtk_visual_inertial_navigation_tpu.io import config_compat as jcc
from rtk_visual_inertial_navigation_tpu.io import publish as jpub
from rtk_visual_inertial_navigation_tpu.io import reference_bag as jrb
from rtk_visual_inertial_navigation_tpu.io import writer as jw
from rtk_visual_inertial_navigation_tpu.pipeline import \
    Estimator as JEstimator
from rtk_visual_inertial_navigation_tpu.utils import stats as jstats
from rtk_visual_inertial_navigation_tpu.utils import timing as jtiming
from rtk_visual_inertial_navigation_tpu_torch import native as tnative
from rtk_visual_inertial_navigation_tpu_torch.config import EstimatorConfig
from rtk_visual_inertial_navigation_tpu_torch.io import bag_writer as tbw
from rtk_visual_inertial_navigation_tpu_torch.io import config_compat as tcc
from rtk_visual_inertial_navigation_tpu_torch.io import publish as tpub
from rtk_visual_inertial_navigation_tpu_torch.io import reference_bag as trb
from rtk_visual_inertial_navigation_tpu_torch.io import writer as tw
from rtk_visual_inertial_navigation_tpu_torch.ops import lie
from rtk_visual_inertial_navigation_tpu_torch.pipeline import Estimator
from rtk_visual_inertial_navigation_tpu_torch.sim import SimConfig, simulate
from rtk_visual_inertial_navigation_tpu_torch.utils import stats as tstats
from rtk_visual_inertial_navigation_tpu_torch.utils import timing as ttiming

from test_native import make_obs
from test_reference_bag import _write_bag

torch.set_num_threads(1)

# float64 on both sides: the two estimators differ by roundoff only.  On
# this noisy sequence the solves of the first GNSS frames (t = 1.0-2.0 s,
# 0.5-0.7 m from truth) amplify roundoff: the port against itself with the
# IMU scaled by (1 + 1e-15) moves those frames by up to 4.1e-6 m, and the
# port against JAX by up to 4.5e-6 m (measured on the CPU); from t = 2.0 s
# on both stay below 2e-9 m.  So every frame is held to REPLAY_TOL_M and
# the last LAST frames to POS_TOL_M.
REPLAY_TOL_M = 1e-5
POS_TOL_M = 1e-6
LAST = 4
CSV_TOL = 1e-4      # dead-reckoned rows from states REPLAY_TOL_M apart


@pytest.fixture(scope="module")
def sim():
    # tests/test_bag_writer.py:21-26, from the port's simulator
    return simulate(SimConfig(duration=3.0, imu_rate=100.0, cam_rate=2.0,
                              gnss_rate=2.0, n_landmarks=30, n_sats=8,
                              n_systems=2, seed=3, pr_noise=0.3,
                              cp_noise=0.005))


@pytest.fixture(scope="module")
def bags(sim, tmp_path_factory):
    """{compression: (JAX's bag, the port's bag)} of the same sim, and
    each side's ground-truth CSV."""
    d = tmp_path_factory.mktemp("bags")
    out = {}
    for comp in ("none", "bz2"):
        paths = []
        for side, mod in (("jax", jbw), ("port", tbw)):
            bag, gt = d / f"{side}_{comp}.bag", d / f"{side}_{comp}.csv"
            mod.sim_to_bag(sim, str(bag), str(gt), compression=comp,
                           prism_offset=[0.01, -0.02, 0.3])
            paths.append((bag, gt))
        out[comp] = paths
    return out


@pytest.mark.parametrize("comp", ["none", "bz2"])
def test_bag_files_are_byte_identical(bags, comp):
    (jbag, jgt), (tbag, tgt) = bags[comp]
    assert tbag.read_bytes() == jbag.read_bytes()
    assert tgt.read_text() == jgt.read_text()


@pytest.mark.parametrize("comp", ["none", "bz2"])
def test_readers_give_jax_messages(bags, comp):
    (jbag, _), (tbag, _) = bags[comp]
    ref = jrb.read_bag(str(jbag))
    for got in (trb.read_bag(str(tbag)), tnative.read_bag_native(str(tbag))):
        assert len(got) == len(ref) > 0
        for a, b in zip(got, ref):
            assert (a.topic, a.msg_type, a.raw) == (b.topic, b.msg_type,
                                                    b.raw)
            assert abs(a.t - b.t) < 1e-9
    # the decoded event streams are equal, GNSS epochs field by field
    ev_t = list(trb.iter_bag_events(str(tbag)))
    ev_j = list(jrb.iter_bag_events(str(jbag)))
    assert [e[0] for e in ev_t] == [e[0] for e in ev_j]
    for (kind, t1, p1), (_, t2, p2) in zip(ev_t, ev_j):
        assert t1 == t2
        if kind == "gnss":
            for f in dataclasses.fields(p2):
                np.testing.assert_array_equal(getattr(p1, f.name),
                                              getattr(p2, f.name))
        else:
            for a, b in zip(p1 if isinstance(p1, tuple) else (p1,),
                            p2 if isinstance(p2, tuple) else (p2,)):
                np.testing.assert_array_equal(a, b)


def test_garbage_bag_rejected_and_reference_bags(tmp_path):
    bad = tmp_path / "bad.bag"
    bad.write_bytes(b"not a bag at all")
    with pytest.raises(ValueError):
        tnative.read_bag_native(str(bad))
    with pytest.raises(ValueError):
        trb.read_bag(str(bad))
    # tests/test_reference_bag.py's hand-built bag: the same events
    for use_bz2 in (False, True):
        path = tmp_path / f"r_{use_bz2}.bag"
        _write_bag(path, use_bz2)
        a = list(trb.iter_bag_events(str(path)))
        b = list(jrb.iter_bag_events(str(path)))
        assert [e[0] for e in a] == [e[0] for e in b] == \
            ["imu", "gnss", "features", "gnss"]
        np.testing.assert_array_equal(a[3][2].slip, b[3][2].slip)


def test_mea_codecs_match_jax():
    rows = [dict(sat=5, sys=1, pr=2.3456789e7, cp=1.234e8,
                 dopp_cyc=-1234.5, pr_std=0.8, cp_std=0.01,
                 dopp_std_cyc=0.5, rtk_pr=12.5, rtk_cp=65.25,
                 pr0=2.345e7, sat_pos=[1e7, 2e7, 1.5e7],
                 sat_vel=[100.0, -200.0, 50.0], el=0.9,
                 rtk_slip=3, spp_slip=3, half_flag=10),
            dict(sat=9, sys=0, pr=[2.1e7, 2.1e7 + 3], cp=[1.1e8, 8.6e7],
                 sat_pos=[-1e7, 2e7, 1.2e7])]
    blob = tbw.encode_mea(100.25, [1.1e6, 2.2e6, 3.3e6], rows, 0.5)
    assert blob == jbw.encode_mea(100.25, [1.1e6, 2.2e6, 3.3e6], rows, 0.5)
    rec_t, rec_j = trb.decode_mea_blob(blob), jrb.decode_mea_blob(blob)
    assert rec_t.tobytes() == rec_j.tobytes()
    assert trb.decode_mea_blob(b"\x02\x00\x00\x00").tobytes() == \
        jrb.decode_mea_blob(b"\x02\x00\x00\x00").tobytes()
    for single in (True, False):
        ep_t = trb.mea_to_epoch(rec_t, single_freq=single)
        ep_j = jrb.mea_to_epoch(rec_j, single_freq=single)
        for f in dataclasses.fields(ep_j):
            np.testing.assert_array_equal(getattr(ep_t, f.name),
                                          getattr(ep_j, f.name))

    # the native wire codec (the JAX package's C++ source, built by the
    # port): tests/test_native.py's round trip, every field, both caps
    rng = np.random.default_rng(0)
    stream, truth = b"", []
    for e in range(4):
        obs = make_obs(rng, int(rng.integers(4, 20)))
        base = rng.normal(0, 1e6, 3)
        stream += tnative.encode_epoch(100.0 + e, base, 0.9, obs)
        truth.append((100.0 + e, base, obs))
    for max_obs in (64, 8):
        out = tnative.decode_epochs(stream, max_obs=max_obs)
        for e, (t, base, obs) in enumerate(truth):
            n = min(len(obs["sat"]), max_obs)
            assert out["ros_time"][e] == t and out["obs_count"][e] == n
            np.testing.assert_array_equal(out["base_xyz"][e], base)
            for k, v in obs.items():
                np.testing.assert_array_equal(out[k][e, :n], v[:n])
    with pytest.raises(ValueError):
        tnative.decode_epochs(stream[:-10])


def _replay_cfg(sim, cls):
    # tests/test_bag_writer.py::test_bag_replays_through_estimator's
    # configuration
    q_ic = lie.rot_to_quat(torch.from_numpy(sim.cfg.r_ic)).numpy()
    return cls(
        nf=8, nl=48, nb=32, max_obs=256, imu_capacity=64, average_imu=30,
        qic=np.tile(q_ic, (2, 1)), tic=np.tile(sim.cfg.t_ic, (2, 1)),
        use_gnss=True, use_doppler=True, min_sats_per_epoch=6,
        anchor_ecef=sim.anchor_ecef, enu_to_ecef=sim.enu_to_ecef,
        max_gnss_pr=128, max_gnss_cp=128, max_gnss_dopp=128,
        initial_gnss_boost_epochs=2)


def _csv(path):
    lines = path.read_text().strip().split("\n")
    return lines[0], np.asarray([[float(v) for v in ln.split(",")]
                                 for ln in lines[1:]])


def test_bag_replay_matches_jax(sim, bags, tmp_path):
    """The main3.cpp loop on the written bag, JAX's against the port's
    (float64, CPU), each with a ResultWriter attached."""
    bag = str(bags["bz2"][1][0])
    ests = {}
    for side, est, rb, w in (
            ("jax", JEstimator(_replay_cfg(sim, JEstimatorConfig)), jrb, jw),
            ("port", Estimator(_replay_cfg(sim, EstimatorConfig),
                               device="cpu"), trb, tw)):
        writer = w.ResultWriter(str(tmp_path / f"{side}.csv"),
                                anchor_ecef=sim.anchor_ecef,
                                enu_to_ecef=sim.enu_to_ecef)
        est.attach_writer(writer)
        rb.replay_bag(bag, est)
        writer.close()
        ests[side] = est
    ej, et = ests["jax"], ests["port"]
    assert et.initialized and et.frame_count >= 3
    assert len(et.trajectory) == len(ej.trajectory) > LAST
    for k, ((t1, p1, _, _), (t2, p2, _, _)) in enumerate(
            zip(et.trajectory, ej.trajectory)):
        assert t1 == t2
        tol = POS_TOL_M if k >= len(ej.trajectory) - LAST else REPLAY_TOL_M
        np.testing.assert_allclose(p1, p2, rtol=0, atol=tol)
    # the JAX test's own bound on the port's replay
    errs = [np.linalg.norm(p - sim.p[np.argmin(np.abs(sim.imu_t - t))])
            for (t, p, q, v) in et.trajectory]
    assert max(errs[-5:]) < 2.0, errs
    hj, rows_j = _csv(tmp_path / "jax.csv")
    ht, rows_t = _csv(tmp_path / "port.csv")
    assert ht == hj and rows_t.shape == rows_j.shape and len(rows_t) > 100
    np.testing.assert_allclose(rows_t, rows_j, rtol=0, atol=CSV_TOL)


def test_result_writer_and_geodetic_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    anchor = np.array([-2323932.39454, 5387298.51324, 2493096.51920])
    R_e = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    for anchor_kw in (dict(), dict(anchor_ecef=anchor, enu_to_ecef=R_e)):
        texts = []
        for mod in (jw, tw):
            w = mod.ResultWriter(str(tmp_path / "w.csv"), **anchor_kw)
            r = np.random.default_rng(2)
            for k in range(20):
                q = r.normal(size=4)
                w.write(k * 0.0025 + 1e3, r.normal(size=3),
                        q / np.linalg.norm(q), r.normal(size=3),
                        r.normal(size=3) * 1e-2,
                        r.normal(size=3) * 1e-3,
                        acc_w=r.normal(size=3) if k % 2 else None,
                        rtk_fix=k % 2, mag_yaw=0.1 * k, havegps=k % 3 == 0,
                        pbg=r.normal(size=3) if k % 3 else None)
            w.close()
            texts.append((tmp_path / "w.csv").read_text())
            assert w.rows == 20
        assert texts[1] == texts[0]
    for r in (anchor, [0.0, 0.0, 6.4e6], [0.0, 0.0, -6.4e6],
              [6378137.0, 1.0, 0.0]):
        np.testing.assert_array_equal(tw.ecef_to_geodetic_np(r),
                                      jw.ecef_to_geodetic_np(r))


def test_extrinsic_yaml_round_trip_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    tic = rng.normal(size=(2, 3)) * 0.1
    qic = rng.normal(size=(2, 4))
    qic /= np.linalg.norm(qic, axis=1, keepdims=True)
    qic *= np.sign(qic[:, :1])
    tw.save_extrinsic_yaml(str(tmp_path / "t.yaml"), tic, qic)
    jw.save_extrinsic_yaml(str(tmp_path / "j.yaml"), tic, qic)
    assert (tmp_path / "t.yaml").read_text() == \
        (tmp_path / "j.yaml").read_text()
    for name in ("t.yaml", "j.yaml"):
        tt, qt = tw.load_extrinsic_yaml(str(tmp_path / name))
        tj, qj = jw.load_extrinsic_yaml(str(tmp_path / name))
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_allclose(qt, qj, rtol=0, atol=1e-12)
        np.testing.assert_allclose(np.abs((qt * qic).sum(1)), 1.0,
                                   atol=1e-12)


def test_publisher_timer_and_stats_match_jax(tmp_path):
    pubs = []
    for mod in (jpub, tpub):
        pub = mod.Publisher()
        for k in range(10):
            pub.pub_odometry(k * 0.1, [k, 0, 0], [1, 0, 0, 0], [1, 0, 0])
            pub.pub_keyframe(k * 0.1, [k, 1, 0], [1, 0, 0, 0])
        pub.pub_point_cloud([3, 7], [[1.0, 2, 3], [4, 5, 6]])
        pub.pub_point_cloud([7, 1], [[0.5, 0, 0], [9, 9, 9]])
        # an estimator's newest frame and solved landmarks
        est = types.SimpleNamespace(
            frame_count=2, frame_times=[0.0, 1.5],
            x=types.SimpleNamespace(
                p=np.array([[0, 0, 0], [1, 2, 3.0]]),
                q=np.array([[1.0, 0, 0, 0], [0.5, 0.5, 0.5, 0.5]]),
                v=np.ones((2, 3)), landmarks=np.arange(12.0).reshape(4, 3)),
            features=types.SimpleNamespace(
                active=np.array([1, 1, 0, 1], bool),
                solved=np.array([1, 0, 1, 1], bool),
                feature_id=np.array([40, 41, 42, 43])))
        pub.pub_from_estimator(est)
        pub.save(str(tmp_path / f"{mod.__name__}.npz"))
        pubs.append(np.load(tmp_path / f"{mod.__name__}.npz"))
    assert sorted(pubs[1].files) == sorted(pubs[0].files)
    for k in pubs[0].files:
        np.testing.assert_array_equal(pubs[1][k], pubs[0][k])

    # StageTimer: the same report from the same totals; a stage syncs a
    # (CPU) tensor result without error
    timers = [jtiming.StageTimer(), ttiming.StageTimer()]
    for st in timers:
        for name, ms in (("solve", 12.5), ("solve", 7.25), ("io", 0.5)):
            st.total_ms[name] += ms
            st.count[name] += 1
    assert timers[1].report() == timers[0].report()
    assert timers[1].mean_ms("solve") == timers[0].mean_ms("solve")
    with timers[1].stage("x", sync={"a": [torch.ones(2)]}):
        pass
    assert timers[1].count["x"] == 1 and ttiming.TicToc().toc() >= 0
    with ttiming.device_trace(str(tmp_path / "trace.json")):
        torch.ones(4).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0

    rs = [jstats.RunningStats(), tstats.RunningStats()]
    for x in (1.0, 2.0, 3.5, 4.0):
        for r in rs:
            r.add(x)
    assert (rs[1].mean, rs[1].std) == (rs[0].mean, rs[0].std)

    q = np.array([0.9, 0.1, -0.2, 0.3])
    est = types.SimpleNamespace(
        frame_count=2, frame_times=[0.0, 12.25], rtk_fixed=True,
        last_solve=types.SimpleNamespace(cost=3.25e-4),
        x=types.SimpleNamespace(
            p=np.array([[0, 0, 0], [1.5, -2.25, 0.125]]),
            v=np.array([[0, 0, 0], [3.0, 4.0, 0.0]]),
            q=np.stack([np.array([1.0, 0, 0, 0]), q / np.linalg.norm(q)]),
            ba=np.full((2, 3), 1e-3), bg=np.full((2, 3), -2e-4)))
    assert tstats.print_statistics(est) == jstats.print_statistics(est)
    est.frame_count = 0
    assert tstats.print_statistics(est) == jstats.print_statistics(est)


MODE_FLAGS = {
    "rtk_visual_inertial_config.yaml": dict(
        USE_GNSS=1, USE_RTK=1, USE_RTD=1, USE_N_RESOLVE=1, USE_DOPPLER=1),
    "visual_inertial_config.yaml": dict(USE_GNSS=0),
    "spp_visual_inertial_config.yaml": dict(
        USE_GNSS=1, USE_SPP_CORRECTION=1, USE_DOPPLER=1),
    "spp_CP_visual_inertial_config.yaml": dict(
        USE_GNSS=1, USE_SPP_CORRECTION=1, USE_SPP_PHASE=1, USE_DOPPLER=1),
    "rtd_visual_inertial_config.yaml": dict(
        USE_GNSS=1, USE_RTD=1, USE_DOPPLER=1),
}


def _reference_yaml(flags: dict) -> str:
    """A reference-format (OpenCV FileStorage) mode YAML with the fields
    load_reference_config reads."""
    lines = ["%YAML:1.0", "---"]
    lines += [f"{k}: {v}" for k, v in flags.items()]
    lines += ["USE_IMU: 1", "USE_MAG_INIT_YAW: 1", "ESTIMATE_EXTRINSIC: 0",
              "acc_n: 0.05", "gyr_n: 0.004", "acc_w: 0.0004",
              "gyr_w: 2.0e-05", "g_norm: 9.7936", "MAX_NUM_ITERATIONS: 6",
              "MAX_TRUST_REGION_RADIUS: 1000.0", "AVERAGE_IMU: 400",
              "AVERAGE_IMAGE: 60", "FIX_CONTINUE_THRESHOLD: 40",
              "CARRIER_PHASE_CONTINUE_THRESHOLD: 10",
              "Phase_ALL_RESET_COUNT: 100",
              "ANCHOR_POINT: !!opencv-matrix", "   rows: 3", "   cols: 1",
              "   dt: d",
              "   data: [ -2323932.39454, 5387298.51324, 2493096.51920 ]",
              "Pbg: !!opencv-matrix", "   rows: 3", "   cols: 1", "   dt: d",
              "   data: [ -0.0051302024, 0.0091942546, 0.308739733 ]",
              "body_T_cam0: !!opencv-matrix", "   rows: 4", "   cols: 4",
              "   dt: d",
              "   data: [ 0.0, 0.0, 1.0, 0.05, -1.0, 0.0, 0.0, 0.01,",
              "           0.0, -1.0, 0.0, -0.02, 0.0, 0.0, 0.0, 1.0 ]"]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("name", sorted(MODE_FLAGS))
def test_load_reference_config_matches_jax(tmp_path, name):
    path = tmp_path / name
    path.write_text(_reference_yaml(MODE_FLAGS[name]))
    ct = tcc.load_reference_config(str(path), nf=9)
    cj = jcc.load_reference_config(str(path), nf=9)
    for f in dataclasses.fields(cj):
        a, b = getattr(ct, f.name), getattr(cj, f.name)
        if isinstance(b, (np.ndarray, jnp.ndarray)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=0, atol=1e-12, err_msg=f.name)
        elif isinstance(b, tuple):          # ImuNoise
            assert tuple(a) == tuple(b), f.name
        else:
            assert a == b, f.name
    assert ct.nf == 9 and ct.use_gnss == bool(MODE_FLAGS[name]["USE_GNSS"])
