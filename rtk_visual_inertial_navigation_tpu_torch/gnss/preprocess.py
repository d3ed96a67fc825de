"""Host-side GNSS preprocessing: epochs -> fixed-capacity factor arrays.

Covers the semantics of SWFOptimization::GnssPreprocess
(rvi/swf/swf_gnss.cpp:265-499) as host numpy:
  - float64 pre-reduction of the large geometry (reference range r0 to the
    anchor, base range for RB-SD, Sagnac constant) so device factors only
    see O(km) values (see factors/gnss.py);
  - phase-bias slot allocation per (sat, freq, kind) with cycle-slip and
    staleness handling (PBtype semantics, common_function.h:58-70: slip
    counters, continuity count, 10 s staleness at swf_gnss.cpp:297-330);
  - elevation gating (AZELMIN = 25°) and epoch gating (≥ min sats,
    swf.cpp:732-742);
  - per-(sys,freq) textbook SPP weighting (swf_core.cpp:140-161) and the
    RTK varerr2 weighting (gnss_factor.cpp:98-103).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..geodesy import earth
from ..geodesy.earth import CLIGHT, OMGE

AZELMIN = np.deg2rad(25.0)
LTHRE = 15                   # carrier std gate scale (common_function.h:19)
STALENESS_S = 10.0           # bias forgotten after 10 s unseen
RTK_CLOCK_SLOT = 0           # base of RTK dtur slots [0..5]
SPP_CLOCK_SLOT = 6           # base of SPP dtgps slots [6..11]
DRIFT_SLOT = 12


@dataclass
class GnssEpoch:
    """One preprocessed epoch (all arrays length S = #sats in view)."""

    t: float
    sat_id: np.ndarray        # (S,) unique satellite numbers
    sys: np.ndarray           # (S,) 0/1/2
    freq: np.ndarray          # (S,) frequency index
    sat_pos: np.ndarray       # (S,3) ECEF
    sat_vel: np.ndarray       # (S,3)
    pr: np.ndarray            # (S,) rover pseudorange [m] (nan = missing)
    cp: np.ndarray            # (S,) rover carrier phase [cycle]
    dopp: np.ndarray          # (S,) doppler range-rate [m/s]
    rtk_pr: np.ndarray        # (S,) RB-SD pseudorange [m]
    rtk_cp: np.ndarray        # (S,) RB-SD carrier phase [cycle]
    pr_std: np.ndarray        # (S,)
    cp_std: np.ndarray        # (S,) [cycle]
    dopp_std: np.ndarray      # (S,)
    slip: np.ndarray          # (S,) bool receiver cycle-slip flag
    br_time_diff: float = 1.0  # rover-base age [s] (RTK weighting)
    pr0: Optional[np.ndarray] = None  # (S,) SPP_P0 correction channel [m]
    svh: Optional[np.ndarray] = None  # (S,) satellite health (0 = healthy)
    # per-satellite variance terms entering the textbook SPP weighting
    # (swf_core.cpp:147-155); zeros when absent
    ion_var: Optional[np.ndarray] = None   # (S,) [m^2]
    trop_var: Optional[np.ndarray] = None  # (S,) [m^2]
    sat_var: Optional[np.ndarray] = None   # (S,) [m^2]
    # RB-SD stds (mea_t RTK_Pstd/RTK_Lstd); fall back to the rover stds
    rtk_pr_std: Optional[np.ndarray] = None  # (S,) [m]
    rtk_cp_std: Optional[np.ndarray] = None  # (S,) [cycle]
    # half-cycle ambiguity flags (mea_t half_flag); the fix-set gate
    # requires bits 8 and 2 (rvi/swf/swf_gnss.cpp:112-114).  None = clear
    # (synthetic data without a half-cycle channel).
    half_flag: Optional[np.ndarray] = None   # (S,) uint bitmask


class PhaseBiasTable:
    """Slot allocator for carrier-phase ambiguities (PBtype linked lists ->
    fixed-capacity table)."""

    KINDS = ("rtk", "spp")

    def __init__(self, capacity: int):
        self.nb = capacity
        self.active = np.zeros(capacity, dtype=bool)
        self.key: list[Optional[tuple]] = [None] * capacity
        self.value = np.zeros(capacity)
        self.continuity = np.zeros(capacity, dtype=np.int64)
        self.last_seen = np.full(capacity, -np.inf)
        self.sys = np.zeros(capacity, dtype=np.int64)
        self.freq = np.zeros(capacity, dtype=np.int64)
        # allocation generation per slot: rows captured inside condensed
        # chains record the generation of the ambiguity they reference, so a
        # recycled slot (slip/staleness/eviction) invalidates stale chain
        # rows instead of corrupting the new ambiguity
        self.generation = np.zeros(capacity, dtype=np.int64)
        # pin counts: slots referenced by condensed chains must stay
        # allocated (the reference keeps PBtype states alive while factors
        # in the 500-epoch window reference them); a pinned slot can be
        # DETACHED from its (kind,sat,freq) key (slip/staleness) — future
        # observations go to a fresh slot — but remains an active parameter
        self.pinned = np.zeros(capacity, dtype=np.int64)
        self._map: dict[tuple, int] = {}

    def lookup(self, kind: str, sat: int, freq: int, t: float,
               slip: bool, sys: int = 0) -> tuple[int, bool]:
        """Return (slot, is_new). Allocates on slip / staleness / first see.

        is_new means the ambiguity value needs initialization from the
        current measurement residual (swf_gnss.cpp:432-499 new-bias init).
        """
        k = (kind, int(sat), int(freq))
        slot = self._map.get(k)
        avoid = -1
        if slot is not None:
            stale = (t - self.last_seen[slot]) > STALENESS_S
            if slip or stale:
                self._free(slot)
                avoid = slot  # a fresh ambiguity must get a DIFFERENT slot:
                # the marginalization prior may still hold columns for the
                # old one, and those are only purged once the old slot is
                # seen inactive by the estimator's prior-maintenance sweep
                slot = None
        if slot is None:
            slot = self._alloc(k, t, avoid=avoid)
            if slot < 0:
                return -1, False
            self.sys[slot] = sys
            self.freq[slot] = freq
            return slot, True
        self.last_seen[slot] = t
        self.continuity[slot] += 1
        return slot, False

    def _alloc(self, k, t, avoid: int = -1) -> int:
        free = [s for s in np.flatnonzero(~self.active) if s != avoid]
        if len(free) == 0:
            # evict the stalest UNPINNED slot (other than the avoided one)
            order = np.argsort(self.last_seen)
            slot = next((int(s) for s in order
                         if s != avoid and self.pinned[s] == 0), -1)
            if slot < 0:
                return -1
            self._free(slot)
            free = [s for s in np.flatnonzero(~self.active) if s != avoid]
            if len(free) == 0:
                return -1
        slot = int(free[0])
        self.active[slot] = True
        self.key[slot] = k
        self.value[slot] = 0.0
        self.continuity[slot] = 0
        self.last_seen[slot] = t
        self.generation[slot] += 1
        self._map[k] = slot
        return slot

    def _free(self, slot: int):
        k = self.key[slot]
        if k is not None:
            self._map.pop(k, None)
        self.key[slot] = None
        if self.pinned[slot] == 0:
            self.active[slot] = False

    def pin(self, slots):
        """Increment per entry (multiset — callers pass each slot once per
        reference they hold)."""
        for s in np.asarray(slots, dtype=int).ravel():
            if 0 <= s < self.nb:
                self.pinned[s] += 1

    def unpin(self, slots):
        for s in np.asarray(slots, dtype=int).ravel():
            if 0 <= s < self.nb and self.pinned[s] > 0:
                self.pinned[s] -= 1
                if self.pinned[s] == 0 and self.key[s] is None:
                    self.active[s] = False

    def reallocate(self, slot: int, t: float) -> int:
        """Force a cycle slip on an existing slot: free it and allocate a
        fresh one for the same (kind, sat, freq). Returns the new slot."""
        k = self.key[slot]
        if k is None:
            return -1
        sys = int(self.sys[slot])
        self._free(slot)
        new = self._alloc(k, t, avoid=slot)
        if new >= 0:
            self.sys[new] = sys
            self.freq[new] = k[2]
        return new

    def prune_stale(self, t: float) -> np.ndarray:
        """Free slots unseen for STALENESS_S; returns freed slot indices."""
        stale = self.active & ((t - self.last_seen) > STALENESS_S)
        for slot in np.flatnonzero(stale):
            self._free(slot)
        return np.flatnonzero(stale)


def spp_pr_weight(el, pr_std, ion_var=0.0, trop_var=0.0, sat_var=0.0,
                  boost: float = 1.0) -> np.ndarray:
    """SPP pseudorange istd (swf_core.cpp:147-155):
    sin²el / √(Pstd² + ion·0.125² + trop·0.7² + sat·0.35² + 1), ×10 for the
    first 100 rover epochs ("higher istd ... so the states converge faster
    under dogleg", swf_core.cpp:152-154)."""
    sinel = np.sin(np.maximum(el, 0.05))
    var = (pr_std ** 2 + ion_var * 0.125 ** 2 + trop_var * 0.7 ** 2
           + sat_var * 0.35 ** 2 + 1.0)
    return boost * sinel * sinel / np.sqrt(var)


def spp_cp_weight(el, cp_std_m, ion_var=0.0, trop_var=0.0, sat_var=0.0
                  ) -> np.ndarray:
    """SPP carrier-phase istd (swf_core.cpp:163-169): sin²el / √((Lstd·λ)² +
    iono/tropo/sat terms) — note: no +1, no startup boost."""
    sinel = np.sin(np.maximum(el, 0.05))
    var = (cp_std_m ** 2 + ion_var * 0.125 ** 2 + trop_var * 0.7 ** 2
           + sat_var * 0.35 ** 2)
    return sinel * sinel / np.sqrt(np.maximum(var, 1e-12))


def doppler_weight(el, dopp_std_m) -> np.ndarray:
    """Doppler istd = sin²el / (Dstd·λ) (swf_core.cpp:196-199); our
    measurements are already in m/s so the std arrives in m/s."""
    sinel = np.sin(np.maximum(el, 0.05))
    return sinel * sinel / np.maximum(dopp_std_m, 1e-6)


def rtk_weight(el: np.ndarray, mea_var: np.ndarray,
               br_time_diff: float) -> np.ndarray:
    """1/√varerr2 (gnss_factor.cpp:98-103)."""
    b = CLIGHT * 5e-12 * br_time_diff
    sinel = np.sin(np.maximum(el, 0.05))
    return 1.0 / np.sqrt(mea_var / sinel ** 2 + b * b)


@dataclass
class PreparedEpoch:
    """Factor-array slices for one epoch (to be scattered into the window's
    fixed-capacity GnssObsBatch arrays by the estimator)."""

    # rows share the layout of factors.gnss.GnssObsBatch minus frame id
    kind: np.ndarray        # (N,) 0=spp_pr 1=spp_cp 2=rtk_pr 3=rtk_cp 4=dopp
    clk_slot: np.ndarray
    pb_slot: np.ndarray
    r0_unit: np.ndarray
    r0: np.ndarray
    sat_xy: np.ndarray
    sat_vel: np.ndarray
    z: np.ndarray
    wavelength: np.ndarray
    weight: np.ndarray
    new_bias: np.ndarray    # (N,) bool: pb_slot needs value initialization
    n_usable: int           # healthy SPP sat count (epoch gating)
    gen: Optional[np.ndarray] = None  # (N,) bias-slot allocation generation
    # (N,) bool — RTK carrier rows admissible to the integer fix set:
    # RTK_Lstd <= 0.004*LTHRE cycles, el >= AZELMIN, half-cycle flags 8&2
    # set (UpdateNParameterHead, rvi/swf/swf_gnss.cpp:105-121)
    fixable: Optional[np.ndarray] = None


class GnssPreprocessor:
    """Converts raw epochs into device-ready factor rows."""

    def __init__(self, anchor_ecef: np.ndarray, nb_capacity: int,
                 use_rtk=False, use_rtd=False, use_spp_phase=False,
                 use_doppler=True, use_spp_correction=False,
                 initial_deweight_epochs: int = 100):
        self.anchor = np.asarray(anchor_ecef, dtype=np.float64)
        self.anchor_llh = np.asarray(earth.ecef_to_geodetic(self.anchor))
        self.bias = PhaseBiasTable(nb_capacity)
        self.use_rtk = use_rtk
        self.use_rtd = use_rtd
        self.use_spp_phase = use_spp_phase
        self.use_doppler = use_doppler
        self.use_spp_correction = use_spp_correction
        self.epoch_count = 0
        self.initial_deweight_epochs = initial_deweight_epochs

    def prepare(self, ep: GnssEpoch) -> PreparedEpoch:
        S = len(ep.sat_id)
        d0 = self.anchor[None, :] - ep.sat_pos              # (S,3) f64
        r0_plain = np.linalg.norm(d0, axis=-1)
        r0_unit = d0 / r0_plain[:, None]
        sag0 = OMGE * (ep.sat_pos[:, 0] * self.anchor[1]
                       - ep.sat_pos[:, 1] * self.anchor[0]) / CLIGHT
        r0 = r0_plain  # Sagnac handled additively: ρ = r0 + Δρ + sag0 + sag_loc
        el = np.asarray(earth.sat_azel(
            self.anchor_llh, -r0_unit))[..., 1]
        lam = earth.WAVELENGTHS[np.clip(ep.sys, 0, 2), np.clip(ep.freq, 0, 1)]

        healthy = (np.ones(S, dtype=bool) if ep.svh is None
                   else np.asarray(ep.svh) == 0)
        zv = np.zeros(S)
        ionv = zv if ep.ion_var is None else np.asarray(ep.ion_var)
        tropv = zv if ep.trop_var is None else np.asarray(ep.trop_var)
        satv = zv if ep.sat_var is None else np.asarray(ep.sat_var)
        vis = (el >= AZELMIN) & healthy
        usable = vis & np.isfinite(ep.pr)
        n_usable = int(usable.sum())
        self.epoch_count += 1
        boost = 10.0 if self.epoch_count <= self.initial_deweight_epochs \
            else 1.0
        have_base = self.use_rtk or self.use_rtd

        rtk_pstd = (ep.pr_std if ep.rtk_pr_std is None
                    else np.asarray(ep.rtk_pr_std))
        rtk_lstd = (ep.cp_std if ep.rtk_cp_std is None
                    else np.asarray(ep.rtk_cp_std))
        half = (np.full(S, 0xFF, dtype=np.int64) if ep.half_flag is None
                else np.asarray(ep.half_flag, dtype=np.int64))

        rows = {k: [] for k in ("kind", "clk_slot", "pb_slot", "r0_unit",
                                "r0", "sat_xy", "sat_vel", "z", "wavelength",
                                "weight", "new_bias", "gen", "fixable")}

        def add(kind, clk, pb, i, z, w, new_bias=False, fixable=False):
            rows["kind"].append(kind)
            rows["clk_slot"].append(clk)
            rows["pb_slot"].append(max(pb, 0))
            rows["gen"].append(int(self.bias.generation[pb]) if pb >= 0
                               else 0)
            rows["r0_unit"].append(r0_unit[i])
            rows["r0"].append(r0[i])
            rows["sat_xy"].append(ep.sat_pos[i, :2])
            rows["sat_vel"].append(ep.sat_vel[i])
            rows["z"].append(z)
            rows["wavelength"].append(lam[i])
            rows["weight"].append(w)
            rows["new_bias"].append(new_bias)
            rows["fixable"].append(fixable)

        for i in range(S):
            if not vis[i]:
                continue
            sysf = int(ep.sys[i]) * 2 + int(ep.freq[i])
            # --- SPP pseudorange: only without a base, frequency 0 only,
            # std gate (swf_core.cpp:140-146: SPP_P[0], Pstd<2, !have_base)
            if (np.isfinite(ep.pr[i]) and not have_base
                    and int(ep.freq[i]) == 0 and ep.pr_std[i] < 2.0):
                z = ep.pr[i] - r0[i] - sag0[i]
                w = spp_pr_weight(el[i], ep.pr_std[i], ionv[i], tropv[i],
                                  satv[i], boost=boost)
                add(0, SPP_CLOCK_SLOT + sysf, -1, i, z, w)
            # --- SPP carrier phase (f=0, swf_core.cpp:163-172) ---
            if (self.use_spp_phase and np.isfinite(ep.cp[i])
                    and int(ep.freq[i]) == 0):
                slot, new = self.bias.lookup("spp", ep.sat_id[i], ep.freq[i],
                                             ep.t, bool(ep.slip[i]),
                                             int(ep.sys[i]))
                if slot >= 0:
                    z = ep.cp[i] * lam[i] - r0[i] - sag0[i]
                    w = spp_cp_weight(el[i], ep.cp_std[i] * lam[i], ionv[i],
                                      tropv[i], satv[i])
                    add(1, SPP_CLOCK_SLOT + sysf, slot, i, z, w, new)
            # --- SPP pseudorange-correction channel (USE_SPP_CORRECTION,
            # swf_core.cpp:174-186: SppCarrierPhaseFactor reused with z =
            # SPP_P0 and its own per-sat bias estimating the correction) ---
            if (self.use_spp_correction
                    and getattr(ep, "pr0", None) is not None
                    and np.isfinite(ep.pr0[i])
                    and int(ep.freq[i]) == 0):
                slot, new = self.bias.lookup("cor", ep.sat_id[i], ep.freq[i],
                                             ep.t, bool(ep.slip[i]),
                                             int(ep.sys[i]))
                if slot >= 0:
                    z = ep.pr0[i] - r0[i] - sag0[i]
                    w = spp_cp_weight(el[i], ep.pr_std[i])
                    add(1, SPP_CLOCK_SLOT + sysf, slot, i, z, w, new)
            # --- RB-SD pseudorange (RTD, dual frequency; Pstd gate,
            # swf_core.cpp:127) ---
            if (self.use_rtd and np.isfinite(ep.rtk_pr[i])
                    and rtk_pstd[i] < 2.0):
                # z' = P_sd − (r0_rover − r_base): base==anchor ⇒ r0−r_base=0
                # (general base handled by passing true base ranges in)
                z = ep.rtk_pr[i]
                w = rtk_weight(np.asarray([el[i]]),
                               np.asarray([rtk_pstd[i] ** 2]),
                               ep.br_time_diff)[0]
                add(2, RTK_CLOCK_SLOT + sysf, -1, i, z, w)
            # --- RB-SD carrier phase (RTK, dual frequency) ---
            if self.use_rtk and np.isfinite(ep.rtk_cp[i]):
                slot, new = self.bias.lookup("rtk", ep.sat_id[i], ep.freq[i],
                                             ep.t, bool(ep.slip[i]),
                                             int(ep.sys[i]))
                if slot >= 0:
                    z = ep.rtk_cp[i] * lam[i]
                    w = rtk_weight(np.asarray([el[i]]),
                                   np.asarray([(rtk_lstd[i] * lam[i]) ** 2]),
                                   ep.br_time_diff)[0]
                    # fix-set admissibility (swf_gnss.cpp:110-114):
                    # RTK_Lstd <= 0.004*LTHRE [cyc], el >= AZELMIN (vis
                    # already enforces it), half-cycle bits 8 and 2 clear
                    fx = (rtk_lstd[i] <= 0.004 * LTHRE
                          and el[i] >= AZELMIN
                          and bool(half[i] & 8) and bool(half[i] & 2))
                    add(3, RTK_CLOCK_SLOT + sysf, slot, i, z, w, new,
                        fixable=fx)
            # --- Doppler (f=0, swf_core.cpp:190-203) ---
            if (self.use_doppler and np.isfinite(ep.dopp[i])
                    and int(ep.freq[i]) == 0):
                add(4, DRIFT_SLOT, -1, i, ep.dopp[i],
                    doppler_weight(el[i], ep.dopp_std[i]))

        out = {k: np.asarray(v) for k, v in rows.items()}
        if len(out["kind"]) == 0:
            out = {k: np.zeros((0, 3) if k in ("r0_unit", "sat_vel")
                               else ((0, 2) if k == "sat_xy" else (0,)))
                   for k in rows}
        return PreparedEpoch(n_usable=n_usable, **out)
