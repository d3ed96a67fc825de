"""The JAX estimator's replay of one navigation mode, in a process of its own.

    python tests/torch_mode_refs.py CASE OUT.npz [--step-dtype float32]
    python tests/torch_mode_refs.py --record

CASE names an entry of the port's ``pipeline.replay.MODE_CASES`` (the
configuration of a JAX pipeline test).  The process simulates the
sequence with the JAX simulator, replays it through the JAX ``Estimator``
with the JAX test's own event loop, on the CPU in float64 with JAX's
default compiler options, and writes OUT.npz: the simulator's arrays
(``sim_<field>``), every frame's time and position, ``initialized``,
``frame_count``, the attitude the initialization set,
the per-event ``rtk_fixed`` flags, the last integer fix, the chain
statistics, the clock states, the GNSS frame flags and the phase-bias
table (keys, active flags, values).  ``--step-dtype float32`` replays
with the f32 step instead (the configurations' own is f64) and prints the
JAX test's bounds against the truth (``pipeline.replay.mode_truth``).

``--record`` runs every case so, each in a process of its own, and
stores the results in ``tests/data/torch_modes/`` (``<case>.npz``,
compressed) with ``manifest.json``: the jax, jaxlib and numpy versions,
a SHA-256 over the JAX package's ``.py`` files and one over this file,
each case's simulator and configuration keyword arguments, ``DURATION``
and the command.  ``reference`` gives a test the stored result where the
manifest matches this tree and the installed versions, and otherwise
runs the case live and prints why.

``run_reference`` starts the process from a test.  The JAX estimator's
large XLA compiles then run in a fresh process, not in a long-lived
pytest worker, where this jax build's CPU compiler has aborted
(tools/run_suite.py:4-11).  A process that dies by a signal is run once
more.  Two substitutions
leave every state and decision as they are and save compiles: the VI
cases, which see no GNSS epoch and so form no chain, solve and
marginalize through the estimator's programs without the (all-zero)
chain contribution, and RTK-VI compiles one chains-solve program where it
would compile two.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from importlib import metadata

import numpy as np

TIMEOUT_S = 240
DURATION = 5.0
CHAIN_STATS = ("created", "merged", "died", "truncated")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_DIR = os.path.join(ROOT, "tests", "data", "torch_modes")
RECORD_COMMAND = "python tests/torch_mode_refs.py --record"
RECORD_JOBS = 3             # cases recorded at a time, ~2 cores each


def _sha256(paths) -> str:
    h = hashlib.sha256()
    for path in paths:
        h.update(os.path.relpath(path, ROOT).encode() + b"\0")
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def manifest() -> dict:
    """What the stored references were computed from: the installed jax,
    jaxlib and numpy, the JAX package's sources and this file (its event
    loop and substitutions), and each case's keyword arguments."""
    from rtk_visual_inertial_navigation_tpu_torch.pipeline.replay import (
        MODE_CASES, mode_sim_kwargs)
    pkg = os.path.join(ROOT, "rtk_visual_inertial_navigation_tpu")
    sources = sorted(os.path.join(d, f) for d, _, fs in os.walk(pkg)
                     for f in fs if f.endswith(".py"))
    cases = {}
    for name, case in MODE_CASES.items():
        kw = {k: v for k, v in dataclasses.asdict(case).items()
              if k != "truth"}
        kw["sim"] = mode_sim_kwargs(name, DURATION)
        cases[name] = kw
    # a JSON round trip, so that a fresh manifest compares equal to a
    # stored one (tuples become lists)
    return json.loads(json.dumps(dict(
        versions={m: metadata.version(m)
                  for m in ("jax", "jaxlib", "numpy")},
        jax_package_sha256=_sha256(sources),
        helper_sha256=_sha256([os.path.abspath(__file__)]),
        duration=DURATION, cases=cases, command=RECORD_COMMAND)))


def stale_reason(case: str):
    """Why the stored reference of ``case`` cannot stand for a live run
    on this tree, or None where it can."""
    path = os.path.join(REF_DIR, "manifest.json")
    if not os.path.exists(os.path.join(REF_DIR, f"{case}.npz")) \
            or not os.path.exists(path):
        return f"no stored reference in {os.path.relpath(REF_DIR, ROOT)}"
    with open(path) as f:
        stored = json.load(f)
    current = manifest()
    for key in ("versions", "jax_package_sha256", "helper_sha256",
                "duration"):
        if stored.get(key) != current[key]:
            return (f"{key} differs: stored {stored.get(key)}, now "
                    f"{current[key]}")
    if stored["cases"].get(case) != current["cases"][case]:
        return (f"the case's kwargs differ: stored "
                f"{stored['cases'].get(case)}, now {current['cases'][case]}")
    return None


def load_stored(case: str) -> dict:
    with np.load(os.path.join(REF_DIR, f"{case}.npz")) as z:
        return {k: z[k] for k in z.files}


def reference(case: str, out: str) -> dict:
    """The JAX replay of ``case``: the stored one where ``stale_reason``
    finds none, else a live run (``run_reference``) after printing why."""
    why = stale_reason(case)
    if why is None:
        return load_stored(case)
    print(f"{case}: running the JAX reference live ({why}; re-record "
          f"with `{RECORD_COMMAND}`)", flush=True)
    return run_reference(case, out)


def record() -> int:
    """Run every case live, RECORD_JOBS processes at a time, and store the
    results and the manifest in REF_DIR."""
    from rtk_visual_inertial_navigation_tpu_torch.pipeline.replay import \
        MODE_CASES
    os.makedirs(REF_DIR, exist_ok=True)
    stamp = manifest()

    def one(case):
        t0 = time.perf_counter()
        path = os.path.join(REF_DIR, f"{case}.npz")
        arrays = run_reference(case, path + ".live.npz")
        os.remove(path + ".live.npz")
        np.savez_compressed(path, **arrays)
        print(f"{case}: recorded in {time.perf_counter() - t0:.1f} s, "
              f"{os.path.getsize(path)} B", flush=True)

    with ThreadPoolExecutor(RECORD_JOBS) as pool:
        list(pool.map(one, MODE_CASES))
    with open(os.path.join(REF_DIR, "manifest.json"), "w") as f:
        json.dump(stamp, f, indent=1, sort_keys=True)
        f.write("\n")
    return 0


def run_reference(case: str, out: str, timeout: float = TIMEOUT_S) -> dict:
    """Run this module on ``case`` in a fresh Python process and return
    the arrays it wrote.  A death by a signal (XLA's compiler aborting) is
    reported and run once more; a second death, a non-zero exit or the
    timeout raises with the process's stderr."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1")
    # the test session's virtual devices are not wanted here
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, os.path.abspath(__file__), case, out]
    for attempt in (1, 2):
        try:
            proc = subprocess.run(cmd, env=env, capture_output=True,
                                  text=True, timeout=timeout)
        except subprocess.TimeoutExpired as e:
            raise RuntimeError(
                f"the JAX reference of {case} ran past {timeout} s; "
                f"stderr:\n{e.stderr}") from None
        if proc.returncode < 0 and attempt == 1:
            msg = (f"the JAX reference of {case} died by signal "
                   f"{-proc.returncode}; running it once more")
            print(msg, flush=True)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
            continue
        if proc.returncode != 0:
            raise RuntimeError(
                f"the JAX reference of {case} exited {proc.returncode} "
                f"(attempt {attempt}); stderr:\n{proc.stderr[-8000:]}")
        with np.load(out) as z:
            return {k: z[k] for k in z.files}


def one_solve_program(est):
    """Let the estimator export the LAMBDA covariance columns on every
    frame, so that it compiles one chains-solve program where it would
    compile two.  Image frames never read the columns (only
    ``_integer_solve`` does, right after a GNSS frame's solve), so every
    state and decision is unchanged."""
    solve = est._jit_solve_chains
    est._jit_solve_chains = lambda want_cov=True: solve(True)
    return est


def _no_chain_programs(est):
    """Let an estimator that never sees a GNSS epoch (the VI cases) solve
    and marginalize through the programs without the chain contribution.
    With no GNSS frame no chain ever forms, and the contribution of the
    empty chains is exact zeros; the two programs of the chain solve and
    its marginalization at the default caps (32 / 512) cost ~60 s of
    tracing and compiling here."""
    solve, marg = est._jit_solve, est._jit_marg

    def solve_chains(want_cov=True):
        run = solve(want_cov)

        def call(state, hid, st, prior, free, *rest):
            res, X = run(state, prior, free, *rest)
            return res._replace(state=(res.state, hid)), X
        return call

    def marg_chains():
        run = marg()

        def call(state, hid, st, prior, *rest):
            return run(state, prior, *rest)
        return call

    est._jit_solve_chains, est._jit_marg_chains = solve_chains, marg_chains
    return est


def _jax_replay(est, sim, case, offsets, gnss_epoch_of, on_event):
    """The JAX tests' event loops: tests/test_pipeline_vi.py:27-37 (VI),
    tests/test_pipeline_invdepth.py:19-33 (stereo),
    tests/test_pipeline_gnss.py:22-36 (GNSS), :149-160 (magnetometer) and
    :211-221 (SPP_P0 offsets)."""
    ids = np.arange(sim.landmarks.shape[0])
    cam_ptr, g_ptr = 0, 0
    for i, t in enumerate(sim.imu_t):
        est.process_imu(t, sim.acc[i], sim.gyr[i])
        if case.mag_every and i % case.mag_every == 0:
            est.process_mag(t, sim.mag[i])
        if case.gnss and g_ptr < len(sim.gnss_idx) \
                and sim.gnss_idx[g_ptr] == i:
            if offsets is None:
                est.process_gnss(gnss_epoch_of(sim, g_ptr))
            else:
                est.process_gnss(gnss_epoch_of(
                    sim, g_ptr, pr0=sim.pr[g_ptr] + offsets))
            g_ptr += 1
            on_event()
        if cam_ptr < len(sim.cam_idx) and sim.cam_idx[cam_ptr] == i:
            vis = sim.obs_valid[cam_ptr]
            if case.stereo:
                vis_r = sim.obs_valid_r[cam_ptr]
                est.process_image(t, ids[vis], sim.obs_xy[cam_ptr][vis],
                                  ids[vis_r], sim.obs_xy_r[cam_ptr][vis_r])
            else:
                est.process_image(t, ids[vis], sim.obs_xy[cam_ptr][vis])
            cam_ptr += 1
            on_event()


def estimator_arrays(est) -> dict:
    """What the test compares of a finished replay, as numpy arrays (the
    JAX and the port's estimators keep the same attributes)."""
    traj = est.trajectory
    bias = est.gnss.bias if est.gnss is not None else None
    keys = [] if bias is None else [
        "" if k is None else f"{k[0]},{k[1]},{k[2]}" for k in bias.key]
    return dict(
        traj_t=np.asarray([t for t, *_ in traj], dtype=np.float64),
        traj_p=np.asarray([p for _, p, _, _ in traj], dtype=np.float64),
        initialized=np.asarray(bool(est.initialized)),
        frame_count=np.asarray(int(est.frame_count)),
        x_clk=np.asarray(est.x.clk, dtype=np.float64),
        frame_is_gnss=np.asarray(est.frame_is_gnss, dtype=bool),
        phase_bias=np.asarray(est.x.phase_bias, dtype=np.float64),
        bias_keys=np.asarray(keys, dtype=str),
        bias_active=np.asarray(
            [] if bias is None else bias.active, dtype=bool),
        last_fix=np.asarray(est._last_fix, dtype=np.int64).reshape(-1, 3),
        chain_stats=np.asarray([est._chain_stats[k] for k in CHAIN_STATS],
                               dtype=np.int64))


def record_events(est):
    """Wrap ``est`` to keep the attitude its initialization set and the
    ``rtk_fixed`` flag after every event; returns (on_event, extra), where
    ``extra()`` gives them as arrays."""
    q_init = []
    inner = est._initialize

    def initialize(t):
        inner(t)
        q_init.append(np.asarray(est.x.q[0], dtype=np.float64))
    est._initialize = initialize
    fixed = []

    def on_event(*_):
        fixed.append(bool(est.rtk_fixed))

    def extra():
        return dict(q_init=q_init[0] if q_init else np.full(4, np.nan),
                    fixed=np.asarray(fixed, dtype=bool))
    return on_event, extra


def main(argv) -> int:
    import argparse
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    if argv == ["--record"]:
        return record()
    ap = argparse.ArgumentParser()
    ap.add_argument("case")
    ap.add_argument("out")
    ap.add_argument("--step-dtype", default="same")
    args = ap.parse_args(argv)
    case_name, out = args.case, args.out
    t0 = time.perf_counter()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from rtk_visual_inertial_navigation_tpu.config import EstimatorConfig
    from rtk_visual_inertial_navigation_tpu.pipeline import Estimator
    from rtk_visual_inertial_navigation_tpu.sim import SimConfig, simulate
    from rtk_visual_inertial_navigation_tpu.sim.synthetic import \
        gnss_epoch_of
    from rtk_visual_inertial_navigation_tpu_torch.pipeline.replay import (
        MODE_CASES, mode_config_kwargs, mode_pr0_offsets, mode_sim_kwargs,
        mode_truth)

    case = MODE_CASES[case_name]
    t1 = time.perf_counter()
    sim = simulate(SimConfig(**mode_sim_kwargs(case_name, DURATION)))
    t2 = time.perf_counter()
    cfg = EstimatorConfig(**mode_config_kwargs(
        case_name, sim, solve_step_dtype=args.step_dtype))
    est = Estimator(cfg)
    if cfg.use_gnss_chains and cfg.use_rtk and cfg.use_n_resolve:
        one_solve_program(est)
    if not case.gnss:
        _no_chain_programs(est)
    on_event, extra = record_events(est)
    _jax_replay(est, sim, case, mode_pr0_offsets(case_name, sim),
                gnss_epoch_of, on_event)
    t3 = time.perf_counter()
    print(f"{case_name}: imports {t1 - t0:.1f} s, simulation {t2 - t1:.1f} "
          f"s, JAX replay {t3 - t2:.1f} s", flush=True)
    if args.step_dtype != "same":
        print(f"{case_name} step {args.step_dtype}: bounds against the "
              f"truth {mode_truth(case_name, est, sim)}", flush=True)
    arrays = {f"sim_{k}": np.asarray(v) for k, v in vars(sim).items()
              if k != "cfg" and v is not None}
    arrays.update(estimator_arrays(est))
    arrays.update(extra())
    tmp = out + ".part.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
