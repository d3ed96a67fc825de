"""Checkpoint / resume for the sliding-window estimator.

The reference has none (state lives in RAM; restart = re-run the bag,
SURVEY.md §5.4).  Here the full estimator state — window pytree, prior,
preintegrations, feature table, GNSS bias table, frame bookkeeping — is a
flat dict of numpy arrays + a JSON-able header, written as one ``.npz``.
The format is the JAX package's (``_FMT_VERSION = 2``, the same keys and
leaf order), so a checkpoint written by either package resumes in the
other.
"""

from __future__ import annotations

import json

import numpy as np

from ..factors.priors import MargPrior
from ..gnss.preprocess import PreparedEpoch
from .chains import ChainRecord
from .estimator import Estimator

_FMT_VERSION = 2
_PREP_FIELDS = ("kind", "clk_slot", "pb_slot", "r0_unit", "r0", "sat_xy",
                "sat_vel", "z", "wavelength", "weight", "new_bias")
_MID_FIELDS = ("H", "g0", "p0", "q0", "v0", "ba0", "bg0", "pb0")


def save_checkpoint(est: Estimator, path: str):
    arrays: dict[str, np.ndarray] = {}

    def put_tree(prefix, tree):
        # a NamedTuple's fields in order, or a single array
        leaves = (list(tree) if isinstance(tree, tuple)
                  else [] if tree is None else [tree])
        for i, leaf in enumerate(leaves):
            arrays[f"{prefix}{i}"] = np.asarray(leaf)

    put_tree("x_", est.x)
    put_tree("priorJ_", est.prior.J)
    put_tree("priorR_", est.prior.r0)
    put_tree("priorx0_", est.prior.x0)
    put_tree("priorV_", est.prior.valid_rows)
    # information form must round-trip bit-identically (the live prior's H0
    # may come from the marginalization Schur complement, not J^T J)
    put_tree("priorH0_", est.prior.H0)
    put_tree("priorG0_", est.prior.g0)
    put_tree("priorC0_", est.prior.c0)
    pre_mask = [p is not None for p in est.pre]
    for k, p in enumerate(est.pre):
        if p is not None:
            put_tree(f"pre{k}_", p)

    ft = est.features
    arrays.update(
        ft_obs_xy=ft.obs_xy, ft_obs_mask=ft.obs_mask, ft_active=ft.active,
        ft_solved=ft.solved, ft_point=ft.point, ft_feature_id=ft.feature_id,
        frame_is_gnss=est.frame_is_gnss, frame_mag=est.frame_mag,
        frame_mag_valid=est.frame_mag_valid,
    )
    # per-frame prepared GNSS epochs (factor rows still in the window)
    gs_mask = []
    for f, prep in enumerate(est.gnss_store):
        gs_mask.append(prep is not None)
        if prep is None:
            continue
        for name in _PREP_FIELDS:
            arrays[f"gs{f}_{name}"] = np.asarray(getattr(prep, name))
        if prep.gen is not None:
            arrays[f"gs{f}_gen"] = np.asarray(prep.gen)
    header = {
        "version": _FMT_VERSION,
        "gs_mask": gs_mask,
        "gs_n_usable": [int(p.n_usable) for p in est.gnss_store
                        if p is not None],
        "frame_count": est.frame_count,
        "frame_times": est.frame_times,
        "initialized": est.initialized,
        "pre_mask": pre_mask,
        "rtk_fixed": bool(est.rtk_fixed),
        "fix_streak": est._fix_streak,
        "nofix_streak": est._nofix_streak,
        "imu_buf": [[t, a.tolist(), g.tolist()] for t, a, g in
                    zip(est._imu_t, est._imu_acc, est._imu_gyr)],
        # round-2 scalar state: first-fix latch, fix/outage timing, per-IMU
        # output bookkeeping (mirror is re-based on the next frame anyway)
        "gnss_initialized": bool(est._gnss_initialized),
        "last_fix_time": float(est._last_fix_time),
        "last_lambda_t": float(est._last_lambda_t),
        "last_gnss_frame_t": float(est._last_gnss_frame_t),
        "recent_frame_times": list(est._recent_frame_times),
        "mag_yaw": float(est.mag_yaw),
    }
    # condensed IMU-GNSS chains (full records, incl. mid-chain marginals)
    ch_meta = []
    for ci, c in enumerate(est.chains):
        for name in ("p", "q", "v", "ba", "bg", "clk"):
            arrays[f"ch{ci}_{name}"] = getattr(c, name)
        arrays[f"ch{ci}_pins"] = c.pinned_slots
        for k in c.rows:
            arrays[f"ch{ci}_rows_{k}"] = c.rows[k]
        ch_pre_mask = [p is not None for p in c.pres]
        for k, p in enumerate(c.pres):
            if p is not None:
                put_tree(f"ch{ci}pre{k}_", p)
        mid_meta = []
        for mi, md in enumerate(c.mids):
            for name in _MID_FIELDS:
                arrays[f"ch{ci}mid{mi}_{name}"] = np.asarray(md[name])
            mid_meta.append({"k": int(md["k"]), "c0": float(md["c0"])})
        ch_meta.append({"left": int(c.left), "right": int(c.right),
                        "pre_mask": ch_pre_mask, "mids": mid_meta,
                        "rows_keys": sorted(c.rows.keys())})
    header["chains"] = ch_meta
    header["chain_stats"] = {k: int(v)
                             for k, v in est._chain_stats.items()}
    header["host_time"] = est._host_time.tolist()
    if est.gnss is not None:
        b = est.gnss.bias
        arrays.update(bias_active=b.active, bias_value=b.value,
                      bias_cont=b.continuity, bias_seen=b.last_seen,
                      bias_sys=b.sys, bias_freq=b.freq,
                      bias_gen=b.generation, bias_pin=b.pinned)
        header["bias_keys"] = [list(k) if k else None for k in b.key]
        header["gnss_epoch_count"] = est.gnss.epoch_count
    arrays["header"] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_checkpoint(est: Estimator, path: str):
    """Restore into a freshly-constructed Estimator (same config)."""
    z = np.load(path, allow_pickle=False)
    header = json.loads(bytes(z["header"].tobytes()).decode())
    if header["version"] != _FMT_VERSION:
        raise ValueError(f"checkpoint version {header['version']}")

    def get_tree(prefix, template):
        # estimator state is host-resident numpy; template is a NamedTuple
        return type(template)(*(np.array(z[f"{prefix}{i}"])
                                for i in range(len(template))))

    est.x = get_tree("x_", est.x)
    est.prior = MargPrior(
        J=np.array(z["priorJ_0"]), r0=np.array(z["priorR_0"]),
        x0=get_tree("priorx0_", est.x), valid_rows=np.array(z["priorV_0"]),
        H0=(np.array(z["priorH0_0"]) if "priorH0_0" in z else None),
        g0=(np.array(z["priorG0_0"]) if "priorG0_0" in z else None),
        c0=(np.array(z["priorC0_0"]) if "priorC0_0" in z else None))
    est.pre = [None] * (est.cfg.nf - 1)
    for k, present in enumerate(header["pre_mask"]):
        if present:
            est.pre[k] = get_tree(f"pre{k}_", est._dummy_pre())

    ft = est.features
    ft.obs_xy = z["ft_obs_xy"].copy()
    ft.obs_mask = z["ft_obs_mask"].copy()
    ft.active = z["ft_active"].copy()
    ft.solved = z["ft_solved"].copy()
    ft.point = z["ft_point"].copy()
    ft.feature_id = z["ft_feature_id"].copy()
    ft._id_to_slot = {int(fid): int(s)
                      for s, fid in enumerate(ft.feature_id) if fid >= 0}
    est.frame_is_gnss = z["frame_is_gnss"].copy()
    est.frame_mag = z["frame_mag"].copy()
    est.frame_mag_valid = z["frame_mag_valid"].copy()
    est.gnss_store = [None] * est.cfg.nf
    usable = iter(header.get("gs_n_usable", []))
    for f, present in enumerate(header.get("gs_mask", [])):
        if present:
            fields = {name: z[f"gs{f}_{name}"].copy()
                      for name in _PREP_FIELDS}
            gen = (z[f"gs{f}_gen"].copy() if f"gs{f}_gen" in z else None)
            est.gnss_store[f] = PreparedEpoch(n_usable=next(usable),
                                              gen=gen, **fields)

    est.frame_count = header["frame_count"]
    est.frame_times = list(header["frame_times"])
    est.initialized = header["initialized"]
    est.rtk_fixed = header["rtk_fixed"]
    est._fix_streak = header["fix_streak"]
    est._nofix_streak = header["nofix_streak"]
    est._gnss_initialized = header.get(
        "gnss_initialized", est.initialized or not est.cfg.use_gnss)
    est._last_fix_time = header.get("last_fix_time", -np.inf)
    est._last_lambda_t = header.get("last_lambda_t", -np.inf)
    est._last_gnss_frame_t = header.get("last_gnss_frame_t", -np.inf)
    est._recent_frame_times = list(header.get("recent_frame_times", []))
    est.mag_yaw = header.get("mag_yaw", 0.0)
    est._imu_t = [b[0] for b in header["imu_buf"]]
    est._imu_acc = [np.asarray(b[1]) for b in header["imu_buf"]]
    est._imu_gyr = [np.asarray(b[2]) for b in header["imu_buf"]]

    est.chains = []
    for ci, cm in enumerate(header.get("chains", [])):
        pres = [get_tree(f"ch{ci}pre{k}_", est._dummy_pre()) if present
                else None for k, present in enumerate(cm["pre_mask"])]
        mids = []
        for mi, mm in enumerate(cm["mids"]):
            md = {name: z[f"ch{ci}mid{mi}_{name}"].copy()
                  for name in _MID_FIELDS}
            md["k"] = mm["k"]
            md["c0"] = mm["c0"]
            mids.append(md)
        est.chains.append(ChainRecord(
            left=cm["left"], right=cm["right"],
            p=z[f"ch{ci}_p"].copy(), q=z[f"ch{ci}_q"].copy(),
            v=z[f"ch{ci}_v"].copy(), ba=z[f"ch{ci}_ba"].copy(),
            bg=z[f"ch{ci}_bg"].copy(), clk=z[f"ch{ci}_clk"].copy(),
            pres=pres,
            rows={k: z[f"ch{ci}_rows_{k}"].copy()
                  for k in cm["rows_keys"]},
            pinned_slots=z[f"ch{ci}_pins"].copy(), mids=mids))
    est._chain_stats = {k: int(v) for k, v in
                        header.get("chain_stats", est._chain_stats).items()}
    if "host_time" in header:
        est._host_time = np.asarray(header["host_time"], dtype=float)

    if est.gnss is not None and "bias_active" in z:
        b = est.gnss.bias
        b.active = z["bias_active"].copy()
        b.value = z["bias_value"].copy()
        b.continuity = z["bias_cont"].copy()
        b.last_seen = z["bias_seen"].copy()
        b.sys = z["bias_sys"].copy()
        b.freq = z["bias_freq"].copy()
        if "bias_gen" in z:
            b.generation = z["bias_gen"].copy()
            b.pinned = z["bias_pin"].copy()
        b.key = [tuple(k) if k else None for k in header["bias_keys"]]
        b._map = {k: s for s, k in enumerate(b.key) if k is not None}
        est.gnss.epoch_count = header["gnss_epoch_count"]
    return est
