"""GNSS factors, batched over windows and (epoch-frame, satellite,
frequency) rows.

  pseudorange     r = w·(Δρ(x) + clk − z')
  carrier phase   r = w·(Δρ(x) + clk − N·λ − z')
  doppler         r = w·(ê·(v − v_sat) + sag_rate + drift − z')

Large constants are pre-reduced on the host in float64:
ρ(x) = r0 + Δρ(x_e) + sag_loc(x_e) with x_e = R_e·p, and the measurement
arrives as z' = z − r0 − sag0, so the device only sees O(km) numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.state import WindowState, layout_of
from ..geodesy.earth import CLIGHT, OMGE
from .base import FactorBatch, block_indices, rowwise_res_jac, take_rows


class GnssObsBatch(NamedTuple):
    """Fixed-capacity per-observation arrays, leading dims (B, rows)."""

    frame_ids: torch.Tensor   # int window frame index
    clk_slot: torch.Tensor    # int clock slot within the frame [0,13)
    drift_slot: torch.Tensor  # int (doppler) clock-drift slot (12)
    pb_slot: torch.Tensor     # int phase-bias slot (carrier phase only)
    r0_unit: torch.Tensor     # (...,3) unit(anchor - sat) in ECEF
    r0: torch.Tensor          # |anchor - sat|
    sat_xy: torch.Tensor      # (...,2) sat x,y for the local Sagnac term
    sat_vel: torch.Tensor     # (...,3) sat velocity (doppler)
    z: torch.Tensor           # reduced measurement [m] (or [m/s])
    wavelength: torch.Tensor  # carrier wavelength [m]
    weight: torch.Tensor      # sqrt-information
    valid: torch.Tensor       # bool


def _ecef_local(p_enu, R_e):
    return (R_e @ p_enu[..., None])[..., 0]


def _rho_reduced(x_e, row):
    """Δρ(x) = ρ(anchor + x) − ρ(anchor): reduced range + local Sagnac."""
    proj = torch.sum(row.r0_unit * x_e, dim=-1)
    x2 = torch.sum(x_e * x_e, dim=-1)
    t = 2.0 * proj + x2 / row.r0
    delta = t / (1.0 + torch.sqrt(torch.clamp_min(1.0 + t / row.r0, 1e-12)))
    sag = OMGE * (row.sat_xy[..., 0] * x_e[..., 1]
                  - row.sat_xy[..., 1] * x_e[..., 0]) / CLIGHT
    return delta + sag


def _pr_res(t, row, R_e):
    """tangent = [pos3, clk1]."""
    b, p, clk = row
    x_e = _ecef_local(p + t[0:3], R_e)
    return (b.weight * (_rho_reduced(x_e, b) + clk + t[3] - b.z))[None]


def _cp_res(t, row, R_e):
    """tangent = [pos3, clk1, N1]."""
    b, p, clk, N = row
    x_e = _ecef_local(p + t[0:3], R_e)
    return (b.weight * (_rho_reduced(x_e, b) + clk + t[3]
                        - (N + t[4]) * b.wavelength - b.z))[None]


def _dopp_res(t, row, R_e):
    """tangent = [v3, drift1, pos3]."""
    b, p, v, drift = row
    x_e = _ecef_local(p + t[4:7], R_e)
    v_e = _ecef_local(v + t[0:3], R_e)
    # LOS unit: (d0 + x)/|d0 + x| built from reduced pieces
    num = b.r0_unit * b.r0 + x_e
    delta = _rho_reduced(x_e, b)
    e = num / (b.r0 + delta)
    rate = torch.sum(e * (v_e - b.sat_vel))
    sag = (OMGE / CLIGHT) * (
        b.sat_vel[1] * x_e[0] + b.sat_xy[1] * v_e[0]
        - b.sat_vel[0] * x_e[1] - b.sat_xy[0] * v_e[1])
    return (b.weight * (rate + sag + drift + t[3] - b.z))[None]


def _state_clk(state, frame_ids, slot):
    return take_rows(state.clk, frame_ids).gather(
        -1, slot[..., None])[..., 0]


def _masked(res, jac, gidx, valid):
    m = valid.to(res.dtype)
    return FactorBatch(res * m[..., None], jac * m[..., None, None], gidx,
                       valid)


def spp_pseudorange_batch(state: WindowState, batch: GnssObsBatch,
                          R_e) -> FactorBatch:
    """r = w·(Δρ(x) + clk − z');  tangent = [pos3, clk1]."""
    lay = layout_of(state)
    p = take_rows(state.p, batch.frame_ids)
    clk = _state_clk(state, batch.frame_ids, batch.clk_slot)
    res, jac = rowwise_res_jac(_pr_res, 4, (batch, p, clk), 2, (R_e,))
    gidx = torch.cat([
        block_indices(lay.pose_idx(batch.frame_ids), 3),
        block_indices(lay.clk_idx(batch.frame_ids, batch.clk_slot), 1),
    ], dim=-1)
    return _masked(res, jac, gidx, batch.valid)


def spp_carrier_phase_batch(state: WindowState, batch: GnssObsBatch,
                            R_e) -> FactorBatch:
    """r = w·(Δρ(x) + clk − N·λ − z');  tangent = [pos3, clk1, N1]."""
    lay = layout_of(state)
    p = take_rows(state.p, batch.frame_ids)
    clk = _state_clk(state, batch.frame_ids, batch.clk_slot)
    N = state.phase_bias.gather(-1, batch.pb_slot)
    res, jac = rowwise_res_jac(_cp_res, 5, (batch, p, clk, N), 2, (R_e,))
    gidx = torch.cat([
        block_indices(lay.pose_idx(batch.frame_ids), 3),
        block_indices(lay.clk_idx(batch.frame_ids, batch.clk_slot), 1),
        block_indices(lay.pb_idx(batch.pb_slot), 1),
    ], dim=-1)
    return _masked(res, jac, gidx, batch.valid)


def doppler_batch(state: WindowState, batch: GnssObsBatch,
                  R_e) -> FactorBatch:
    """r = w·(ê·(v − v_sat) + sag_rate + drift − z); tangent = [v3, drift1,
    pos3].  The LOS unit ê keeps its position dependence through the
    reduced range."""
    lay = layout_of(state)
    p = take_rows(state.p, batch.frame_ids)
    v = take_rows(state.v, batch.frame_ids)
    drift = _state_clk(state, batch.frame_ids, batch.drift_slot)
    res, jac = rowwise_res_jac(_dopp_res, 7, (batch, p, v, drift), 2, (R_e,))
    gidx = torch.cat([
        block_indices(lay.sb_idx(batch.frame_ids), 3),
        block_indices(lay.clk_idx(batch.frame_ids, batch.drift_slot), 1),
        block_indices(lay.pose_idx(batch.frame_ids), 3),
    ], dim=-1)
    return _masked(res, jac, gidx, batch.valid)
