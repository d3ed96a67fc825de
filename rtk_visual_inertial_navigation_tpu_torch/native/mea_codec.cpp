// GNSS epoch wire-format codec (native runtime component).
//
// The reference ingests GNSS epochs by memcpy-ing a ROS ByteMultiArray
// straight into its in-memory `mea_t` struct (rvi/main3.cpp:154-168;
// struct at rvi/gnss/include/common_function.h:73-125), making the wire
// format compiler-layout-defined.  This codec defines an explicit packed
// little-endian format (magic "RVIG", version 1) carrying the same
// information — per-satellite SPP/RTK pseudorange, carrier phase, Doppler,
// stds, slip/half flags, satellite PVT, variance terms — and decodes a
// stream of epochs into struct-of-arrays buffers that the Python side wraps
// as numpy arrays (zero copies beyond the parse itself).
//
// Built as a plain shared library; bound via ctypes (no pybind11 in the
// image).

#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t kMagic = 0x47495652u;  // "RVIG" little-endian
constexpr uint32_t kVersion = 1;
constexpr int NFREQ = 2;

#pragma pack(push, 1)
struct WireObs {
  uint8_t sat;
  uint8_t sys;
  uint8_t svh;
  uint8_t rtk_slip[NFREQ];
  uint8_t spp_slip[NFREQ];
  uint8_t half_flag[NFREQ];
  double spp_p[NFREQ];
  double spp_l[NFREQ];
  double spp_d[NFREQ];
  double spp_pstd[NFREQ];
  double spp_lstd[NFREQ];
  double spp_dstd[NFREQ];
  double rtk_p[NFREQ];
  double rtk_l[NFREQ];
  double rtk_pstd[NFREQ];
  double rtk_lstd[NFREQ];
  double spp_p0[NFREQ];
  double sat_pos[3];
  double sat_vel[3];
  double el;
  double sat_var;
  double ion_var;
  double trop_var;
};

struct WireEpochHeader {
  uint32_t magic;
  uint32_t version;
  uint32_t obs_count;
  uint32_t reserved;
  double ros_time;
  double base_xyz[3];
  double br_time_diff;
};
#pragma pack(pop)

}  // namespace

extern "C" {

// Returns the number of epochs in the buffer, or -1 on format error.
long long mea_count_epochs(const uint8_t* buf, long long len) {
  long long off = 0;
  long long count = 0;
  while (off + (long long)sizeof(WireEpochHeader) <= len) {
    WireEpochHeader h;
    std::memcpy(&h, buf + off, sizeof(h));
    if (h.magic != kMagic || h.version != kVersion) return -1;
    off += sizeof(WireEpochHeader) +
           (long long)h.obs_count * sizeof(WireObs);
    if (off > len) return -1;
    ++count;
  }
  return (off == len) ? count : -1;
}

// Decode all epochs. Caller pre-allocates with capacities (n_epochs from
// mea_count_epochs, max_obs per epoch). Observations beyond max_obs are
// dropped (reference MAXOBS=64 analog). Per-(epoch,obs,freq) arrays are
// indexed [e*max_obs*2 + o*2 + f]. Returns 0 on success.
int mea_decode(const uint8_t* buf, long long len, int max_obs,
               // per-epoch
               double* ros_time, double* base_xyz, double* br_time_diff,
               int* obs_count,
               // per-(epoch,obs)
               int* sat, int* sys, int* svh, double* sat_pos,
               double* sat_vel, double* el, double* sat_var, double* ion_var,
               double* trop_var,
               // per-(epoch,obs,freq)
               double* spp_p, double* spp_l, double* spp_d, double* spp_pstd,
               double* spp_lstd, double* spp_dstd, double* rtk_p,
               double* rtk_l, double* rtk_pstd, double* rtk_lstd,
               double* spp_p0, int* rtk_slip, int* spp_slip, int* half_flag) {
  long long off = 0;
  long long e = 0;
  while (off + (long long)sizeof(WireEpochHeader) <= len) {
    WireEpochHeader h;
    std::memcpy(&h, buf + off, sizeof(h));
    if (h.magic != kMagic || h.version != kVersion) return -1;
    off += sizeof(WireEpochHeader);
    ros_time[e] = h.ros_time;
    std::memcpy(base_xyz + 3 * e, h.base_xyz, sizeof(h.base_xyz));
    br_time_diff[e] = h.br_time_diff;
    int kept = (int)h.obs_count < max_obs ? (int)h.obs_count : max_obs;
    obs_count[e] = kept;
    for (uint32_t o = 0; o < h.obs_count; ++o) {
      WireObs w;
      std::memcpy(&w, buf + off, sizeof(w));
      off += sizeof(WireObs);
      if ((int)o >= max_obs) continue;
      long long oe = e * max_obs + o;
      sat[oe] = w.sat;
      sys[oe] = w.sys;
      svh[oe] = w.svh;
      std::memcpy(sat_pos + 3 * oe, w.sat_pos, sizeof(w.sat_pos));
      std::memcpy(sat_vel + 3 * oe, w.sat_vel, sizeof(w.sat_vel));
      el[oe] = w.el;
      sat_var[oe] = w.sat_var;
      ion_var[oe] = w.ion_var;
      trop_var[oe] = w.trop_var;
      for (int f = 0; f < NFREQ; ++f) {
        long long k = (e * max_obs + o) * NFREQ + f;
        spp_p[k] = w.spp_p[f];
        spp_l[k] = w.spp_l[f];
        spp_d[k] = w.spp_d[f];
        spp_pstd[k] = w.spp_pstd[f];
        spp_lstd[k] = w.spp_lstd[f];
        spp_dstd[k] = w.spp_dstd[f];
        rtk_p[k] = w.rtk_p[f];
        rtk_l[k] = w.rtk_l[f];
        rtk_pstd[k] = w.rtk_pstd[f];
        rtk_lstd[k] = w.rtk_lstd[f];
        spp_p0[k] = w.spp_p0[f];
        rtk_slip[k] = w.rtk_slip[f];
        spp_slip[k] = w.spp_slip[f];
        half_flag[k] = w.half_flag[f];
      }
    }
    ++e;
  }
  return 0;
}

// Encode one epoch (for converters/tests). Returns bytes written or -1 if
// out_cap too small.
long long mea_encode_epoch(
    double ros_time, const double* base_xyz, double br_time_diff,
    int obs_count, const int* sat, const int* sys, const int* svh,
    const double* sat_pos, const double* sat_vel, const double* el,
    const double* sat_var, const double* ion_var, const double* trop_var,
    const double* spp_p, const double* spp_l, const double* spp_d,
    const double* spp_pstd, const double* spp_lstd, const double* spp_dstd,
    const double* rtk_p, const double* rtk_l, const double* rtk_pstd,
    const double* rtk_lstd, const double* spp_p0, const int* rtk_slip,
    const int* spp_slip, const int* half_flag,
    uint8_t* out, long long out_cap) {
  long long need = (long long)sizeof(WireEpochHeader) +
                   (long long)obs_count * sizeof(WireObs);
  if (need > out_cap) return -1;
  WireEpochHeader h;
  h.magic = kMagic;
  h.version = kVersion;
  h.obs_count = (uint32_t)obs_count;
  h.reserved = 0;
  h.ros_time = ros_time;
  std::memcpy(h.base_xyz, base_xyz, sizeof(h.base_xyz));
  h.br_time_diff = br_time_diff;
  long long off = 0;
  std::memcpy(out + off, &h, sizeof(h));
  off += sizeof(h);
  for (int o = 0; o < obs_count; ++o) {
    WireObs w;
    std::memset(&w, 0, sizeof(w));
    w.sat = (uint8_t)sat[o];
    w.sys = (uint8_t)sys[o];
    w.svh = (uint8_t)svh[o];
    std::memcpy(w.sat_pos, sat_pos + 3 * o, sizeof(w.sat_pos));
    std::memcpy(w.sat_vel, sat_vel + 3 * o, sizeof(w.sat_vel));
    w.el = el[o];
    w.sat_var = sat_var[o];
    w.ion_var = ion_var[o];
    w.trop_var = trop_var[o];
    for (int f = 0; f < NFREQ; ++f) {
      int k = o * NFREQ + f;
      w.spp_p[f] = spp_p[k];
      w.spp_l[f] = spp_l[k];
      w.spp_d[f] = spp_d[k];
      w.spp_pstd[f] = spp_pstd[k];
      w.spp_lstd[f] = spp_lstd[k];
      w.spp_dstd[f] = spp_dstd[k];
      w.rtk_p[f] = rtk_p[k];
      w.rtk_l[f] = rtk_l[k];
      w.rtk_pstd[f] = rtk_pstd[k];
      w.rtk_lstd[f] = rtk_lstd[k];
      w.spp_p0[f] = spp_p0[k];
      w.rtk_slip[f] = (uint8_t)rtk_slip[k];
      w.spp_slip[f] = (uint8_t)spp_slip[k];
      w.half_flag[f] = (uint8_t)half_flag[k];
    }
    std::memcpy(out + off, &w, sizeof(w));
    off += sizeof(w);
  }
  return off;
}

}  // extern "C"
