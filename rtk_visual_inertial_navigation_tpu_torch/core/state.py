"""Window state containers and the global tangent-space layout.

The solver works in one flat *tangent* vector whose index layout is the
elimination ordering:

    [ landmarks (3·NL) | frames (15·NF: 6 pose ⊕ 9 speed-bias) |
      extrinsics (6·NC) | mag bias (3) | clocks (NCLK·NF) | phase biases (NB) ]

Landmarks come first (Schur group 0); phase biases last so the ambiguity
tail covariance falls out of the ordered elimination.  All dims are static
capacities.  Every tensor may carry leading batch dimensions; the layout
reads its sizes from the trailing ones.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import lie

# per-frame receiver-clock tangent slots: 0-5 RTK dtur per (sys,freq),
# 6-11 SPP dtgps per (sys,freq), 12 Doppler clock drift.
NCLOCK = 13
POSE_DIM = 6
SB_DIM = 9
FRAME_DIM = POSE_DIM + SB_DIM  # 15


class WindowState(NamedTuple):
    """All estimated quantities, fixed capacity, leading batch dims allowed."""

    p: torch.Tensor          # (..., NF, 3) antenna position, local frame
    q: torch.Tensor          # (..., NF, 4) body->world quaternion (wxyz)
    v: torch.Tensor          # (..., NF, 3) antenna velocity
    ba: torch.Tensor         # (..., NF, 3) accel bias
    bg: torch.Tensor         # (..., NF, 3) gyro bias
    clk: torch.Tensor        # (..., NF, NCLOCK) receiver clock states
    tic: torch.Tensor        # (..., NC, 3) camera-IMU translation
    qic: torch.Tensor        # (..., NC, 4) camera-IMU rotation
    mag_bias: torch.Tensor   # (..., 3) magnetometer bias
    landmarks: torch.Tensor  # (..., NL, 3) world points
    phase_bias: torch.Tensor  # (..., NB) carrier-phase ambiguities [cycle]

    @property
    def num_frames(self):
        return self.p.shape[-2]

    @property
    def num_landmarks(self):
        return self.landmarks.shape[-2]

    @staticmethod
    def zeros(nf: int, nl: int, nb: int, nc: int = 2, dtype=torch.float64,
              device=None, batch_shape=()):
        b = tuple(batch_shape)
        z = lambda *s: torch.zeros(b + s, dtype=dtype, device=device)
        return WindowState(
            p=z(nf, 3),
            q=lie.quat_identity(b + (nf,), dtype, device),
            v=z(nf, 3),
            ba=z(nf, 3),
            bg=z(nf, 3),
            clk=z(nf, NCLOCK),
            tic=z(nc, 3),
            qic=lie.quat_identity(b + (nc,), dtype, device),
            mag_bias=z(3),
            landmarks=z(nl, 3),
            phase_bias=z(nb),
        )


class TangentLayout(NamedTuple):
    """Static offsets of each group in the flat tangent vector."""

    nf: int
    nl: int
    nb: int
    nc: int

    @property
    def lm_off(self):
        return 0

    @property
    def frame_off(self):
        return 3 * self.nl

    @property
    def ext_off(self):
        return self.frame_off + FRAME_DIM * self.nf

    @property
    def mag_off(self):
        return self.ext_off + POSE_DIM * self.nc

    @property
    def clk_off(self):
        return self.mag_off + 3

    @property
    def pb_off(self):
        return self.clk_off + NCLOCK * self.nf

    @property
    def dim(self):
        return self.pb_off + self.nb

    # ---- index helpers (python ints or integer tensors both work) ----
    def lm_idx(self, l):
        return self.lm_off + 3 * l

    def pose_idx(self, f):
        return self.frame_off + FRAME_DIM * f

    def sb_idx(self, f):
        return self.frame_off + FRAME_DIM * f + POSE_DIM

    def ext_idx(self, c):
        return self.ext_off + POSE_DIM * c

    def clk_idx(self, f, slot=0):
        return self.clk_off + NCLOCK * f + slot

    def pb_idx(self, b):
        return self.pb_off + b


def layout_of(state: WindowState) -> TangentLayout:
    return TangentLayout(
        nf=state.p.shape[-2],
        nl=state.landmarks.shape[-2],
        nb=state.phase_bias.shape[-1],
        nc=state.tic.shape[-2],
    )


def retract_window(state: WindowState, dx: torch.Tensor) -> WindowState:
    """x ⊞ dx over the full window (right-multiplicative on quaternions);
    dx is (..., D) with the state's batch dims."""
    lay = layout_of(state)
    nf, nl, nb, nc = lay.nf, lay.nl, lay.nb, lay.nc
    b = dx.shape[:-1]
    d_lm = dx[..., lay.lm_off:lay.lm_off + 3 * nl].reshape(b + (nl, 3))
    d_fr = dx[..., lay.frame_off:lay.frame_off + FRAME_DIM * nf].reshape(
        b + (nf, FRAME_DIM))
    d_ext = dx[..., lay.ext_off:lay.ext_off + POSE_DIM * nc].reshape(
        b + (nc, POSE_DIM))
    d_mag = dx[..., lay.mag_off:lay.mag_off + 3]
    d_clk = dx[..., lay.clk_off:lay.clk_off + NCLOCK * nf].reshape(
        b + (nf, NCLOCK))
    d_pb = dx[..., lay.pb_off:lay.pb_off + nb]
    return WindowState(
        p=state.p + d_fr[..., 0:3],
        q=lie.quat_boxplus(state.q, d_fr[..., 3:6]),
        v=state.v + d_fr[..., 6:9],
        ba=state.ba + d_fr[..., 9:12],
        bg=state.bg + d_fr[..., 12:15],
        clk=state.clk + d_clk,
        tic=state.tic + d_ext[..., 0:3],
        qic=lie.quat_boxplus(state.qic, d_ext[..., 3:6]),
        mag_bias=state.mag_bias + d_mag,
        landmarks=state.landmarks + d_lm,
        phase_bias=state.phase_bias + d_pb,
    )


def window_boxminus(x1: WindowState, x0: WindowState) -> torch.Tensor:
    """Flat tangent t (..., D) with x0 ⊞ t = x1 (quaternion-aware)."""
    b = x0.phase_bias.shape[:-1]
    flat = lambda t: t.reshape(b + (-1,))
    d_fr = torch.cat(
        [
            x1.p - x0.p,
            lie.quat_boxminus(x1.q, x0.q),
            x1.v - x0.v,
            x1.ba - x0.ba,
            x1.bg - x0.bg,
        ],
        dim=-1,
    )
    d_ext = torch.cat([x1.tic - x0.tic, lie.quat_boxminus(x1.qic, x0.qic)],
                      dim=-1)
    return torch.cat(
        [
            flat(x1.landmarks - x0.landmarks),
            flat(d_fr),
            flat(d_ext),
            x1.mag_bias - x0.mag_bias,
            flat(x1.clk - x0.clk),
            x1.phase_bias - x0.phase_bias,
        ],
        dim=-1,
    )
