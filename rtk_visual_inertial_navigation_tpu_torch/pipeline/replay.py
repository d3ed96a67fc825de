"""Drive an estimator through a simulated sequence, as ``bench.py
--pipeline`` and the JAX package's pipeline tests do."""

from __future__ import annotations

import numpy as np

from ..sim.synthetic import gnss_epoch_of


def replay(est, sim, start: int = 0, stop=None, on_event=None,
           epoch_of=gnss_epoch_of):
    """Feed IMU samples ``start..stop-1`` of ``sim`` to ``est`` in order;
    at a sample with a GNSS epoch, ``process_gnss`` it, then at a sample
    with a camera frame, ``process_image`` every landmark in view (the
    order of bench.py:67-80).  ``on_event(i)`` runs after each GNSS or image
    event at sample i.  ``epoch_of`` turns (sim, epoch index) into the
    estimator's ``GnssEpoch``.  Returns ``est``."""
    ids = np.arange(sim.landmarks.shape[0])
    stop = len(sim.imu_t) if stop is None else stop
    cam = int(np.searchsorted(sim.cam_idx, start))
    gps = int(np.searchsorted(sim.gnss_idx, start))
    for i in range(start, stop):
        t = sim.imu_t[i]
        est.process_imu(t, sim.acc[i], sim.gyr[i])
        if gps < len(sim.gnss_idx) and sim.gnss_idx[gps] == i:
            est.process_gnss(epoch_of(sim, gps))
            gps += 1
            if on_event is not None:
                on_event(i)
        if cam < len(sim.cam_idx) and sim.cam_idx[cam] == i:
            vis = sim.obs_valid[cam]
            est.process_image(t, ids[vis], sim.obs_xy[cam][vis])
            cam += 1
            if on_event is not None:
                on_event(i)
    return est
