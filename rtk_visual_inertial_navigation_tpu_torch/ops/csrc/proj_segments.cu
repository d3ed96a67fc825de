// Projection linearization + Schur segment assembly for a batch of windows.
//
// Replaces the Pallas kernel rtk_visual_inertial_navigation_tpu/ops/
// pallas_proj.py::_proj_kernel (driven by proj_segments_pallas).  Per
// observation: gather the frame pose, landmark and camera extrinsic, form the
// analytic reprojection residual and its 2x(6+3) Jacobian (plus the 2x6
// extrinsic rows when want_ext), apply the optional Cauchy corrector, and
// sum the Gram blocks:
//   PP[f] += Jpᵀ Jp   PL[f,l] += Jpᵀ Jl   LL[l] += Jlᵀ Jl
//   PE[f,c] += Jpᵀ Je  EE[c] += Jeᵀ Je    LE[l,c] += Jeᵀ Jl
//   GP[f] += Jpᵀ r    GL[l] += Jlᵀ r     GE[c] += Jeᵀ r    cost += ρ/2
// Only the frame-diagonal PP blocks are formed: the solve never reads the
// off-diagonal (6nf)² entries.
//
// Bound: bytes.  At the flagship shape (B=32, nf=11, nl=352, nobs=2816) the
// kernel does ~0.5 kFLOP per observation, but it must write the dense
// (nf, nl, 6, 3) PL grid of every window, 8.9 MB of the 12.6 MB that the
// call must move in f32: the least time is that write at HBM rate.
//
// Design: every output element is written exactly once, by the block that
// owns it, with plain stores, so the outputs need no zero fill and no
// atomic touches them; every sum is taken in a fixed order, so the results
// are bitwise equal from run to run.  The wrapper's plan (built once per
// solve) lists each window's live rows (valid, every id in range) sorted
// by landmark and, within a landmark, by frame (the original order kept
// within a (landmark, frame) pair), and sorted by frame: each row as
// (row, frame, camera, landmark), one 16-byte load, with the offsets of
// each landmark's and each frame's rows.  Per window the grid holds:
//   - nf frame blocks.  Block f linearizes the frame's rows, kThreads at a
//     time, sums PP, GP, cost (and PE, EE, GE) over each warp by shuffles,
//     then over the warps in order in shared memory, and writes PP[b,f],
//     GP[b,f] (PE[b,f]).  The cost (EE, GE) sums over all frames: each
//     frame block writes its partial to a scratch row, and the last frame
//     block of the window to finish (a counter per window, reset by that
//     block) sums the rows in frame order;
//   - ceil(nl / L) landmark blocks.  A block linearizes the rows of its L
//     landmarks, kThreads at a time, and stages them in shared memory; the
//     first row of each run of equal (landmark, frame) adds the run's
//     Jpᵀ Jl into the tile's PL grid in shared memory, and one thread per
//     (landmark, entry) sums LL, GL (LE) over the landmark's rows; then the
//     block stores its whole PL/LL/GL/LE tile, zeros included.
// Each row is linearized twice, once in each kind of block: a variant that
// summed the frame blocks across the landmark tiles instead measured slower.
// The wrapper picks L (at most MAX_TILE = 16 of ops/pallas_proj.py, the
// fastest of 8, 16 and 32 on an H100) so that a block fits the device's
// opt-in shared memory; a shape for which even L = 1 does not fit raises.
//
// What holds it back (profile_proj.py, PERF.md): not the bytes.  Each
// block is a chain of dependent phases of ~1-2 µs each (index loads,
// gathers, linearize, warp or shared-memory sums, barriers, the tile
// store), and of the 1,056 blocks of the flagship call a tenth start more
// than 4 µs late, waiting for a free block slot on an SM.

#include <cuda_runtime.h>
#include <math.h>

namespace {

#ifdef PROJ_SEGMENTS_TIMELINE
// Built with -DPROJ_SEGMENTS_TIMELINE (profile_proj.py): thread 0 of each
// block stamps the global timer at its phase boundaries, for one launch
// of at most kTimelineBlocks blocks.
constexpr int kTimelineBlocks = 1 << 16, kMarks = 8;
__device__ unsigned long long g_timeline[kTimelineBlocks * kMarks];
#define MARK(k)                                                           \
  do {                                                                    \
    const long blk = (long)blockIdx.y * gridDim.x + blockIdx.x;           \
    if (threadIdx.x == 0 && blk < kTimelineBlocks) {                      \
      unsigned long long t;                                               \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));               \
      g_timeline[blk * kMarks + (k)] = t;                                 \
    }                                                                     \
  } while (0)
#else
#define MARK(k) \
  do {          \
  } while (0)
#endif

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// frame block sums: PP upper 21 | GP 6 | cost, then per camera (want_ext)
// PE 36 | EE upper 21 | GE 6; its partial for the window's last frame
// block: cost, then per camera (want_ext) EE upper 21 | GE 6
constexpr int kFrameE = 28, kCamE = 63, kCamP = 27;
// landmark block staging row of one observation: Jp0 6 | Jp1 6 | Jl0 3 |
// Jl1 3 | r0 r1 | Je0 6 | Je1 6 (the last two only when want_ext)
constexpr int kRow = 20, kRowExt = 32;
// LL 9 | GL 3 per landmark, then LE 18 per camera (want_ext)
constexpr int kLmE = 12;

template <typename T>
struct Args {
  const T *p, *lm, *q, *qic, *tic, *pbg, *xy;
  // the plan's rows (row, frame, camera, landmark), sorted
  const int4 *rows_l, *rows_f;
  const int *off_l, *off_f;
  int* counter;
  T *scratch, *PP, *PL, *PE, *EE, *LE, *LL, *GP, *GL, *GE, *cost;
  int nf, nl, nc, nobs, L, want_ext;
  T weight, cauchy_a;
};

// Linearized rows of one observation.
template <typename T>
struct Rows {
  T Jp0[6], Jp1[6], Jl0[3], Jl1[3], Je0[6], Je1[6], r0, r1, cost;
};

// index of (i, j), i <= j, in the row-major upper triangle of a 6x6 block
__device__ __forceinline__ int tri6(int i, int j) {
  return i * 6 - i * (i - 1) / 2 + (j - i);
}


template <typename T>
__device__ __forceinline__ void mat3vec(const T* A, const T* v, T* out) {
  for (int i = 0; i < 3; ++i)
    out[i] = A[3 * i] * v[0] + A[3 * i + 1] * v[1] + A[3 * i + 2] * v[2];
}

// Rᵀ of a unit quaternion (w, x, y, z), row-major.
template <typename T>
__device__ __forceinline__ void quat_to_rot_t(const T* q, T* Rt) {
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  Rt[0] = T(1) - T(2) * (y * y + z * z);
  Rt[1] = T(2) * (x * y + w * z);
  Rt[2] = T(2) * (x * z - w * y);
  Rt[3] = T(2) * (x * y - w * z);
  Rt[4] = T(1) - T(2) * (x * x + z * z);
  Rt[5] = T(2) * (y * z + w * x);
  Rt[6] = T(2) * (x * z + w * y);
  Rt[7] = T(2) * (y * z - w * x);
  Rt[8] = T(1) - T(2) * (x * x + y * y);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  // butterfly: every lane ends with the same, fixed-order sum
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Residual, Jacobian rows and cost of observation o (window b) of frame f,
// camera c and landmark l, Cauchy corrector applied.
template <typename T>
__device__ __forceinline__ void linearize(const Args<T>& a, int b, long o,
                                          int f, int c, int l, Rows<T>& w) {
  const T* pf = a.p + ((long)b * a.nf + f) * 3;
  const T* pl = a.lm + ((long)b * a.nl + l) * 3;
  const T* tc = a.tic + ((long)b * a.nc + c) * 3;
  T R[9], Rc[9];                                   // R(q_f)ᵀ, R(q_ic)ᵀ
  quat_to_rot_t(a.q + ((long)b * a.nf + f) * 4, R);
  quat_to_rot_t(a.qic + ((long)b * a.nc + c) * 4, Rc);

  T u[3] = {pl[0] - pf[0], pl[1] - pf[1], pl[2] - pf[2]};
  T pim[3], w3[3], Xc[3];
  mat3vec(R, u, pim);
  for (int i = 0; i < 3; ++i) w3[i] = pim[i] + a.pbg[i] - tc[i];
  mat3vec(Rc, w3, Xc);

  const T weight = a.weight;
  const T eps = T(1e-3);
  const T z = Xc[2];
  const bool clamped = fabs(z) < eps;
  const T zs = clamped ? (z < T(0) ? -eps : eps) : z;
  const T inv_z = T(1) / zs;
  const T zm = clamped ? T(0) : T(1);             // d(safe_z)/dz
  const T xh = Xc[0] * inv_z, yh = Xc[1] * inv_z;
  const long ob = (long)b * a.nobs + o;
  T r0 = weight * (xh - a.xy[2 * ob]);
  T r1 = weight * (yh - a.xy[2 * ob + 1]);
  const T az = weight * inv_z;
  const T c0 = -weight * xh * inv_z * zm;
  const T c1 = -weight * yh * inv_z * zm;

  // B1 = Rcᵀ Rᵀ, C = Rcᵀ [pim]x
  T B1[9], C[9];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      B1[3 * i + j] = Rc[3 * i] * R[j] + Rc[3 * i + 1] * R[3 + j] +
                      Rc[3 * i + 2] * R[6 + j];
    const T a0 = Rc[3 * i], a1 = Rc[3 * i + 1], a2 = Rc[3 * i + 2];
    C[3 * i] = a1 * pim[2] - a2 * pim[1];
    C[3 * i + 1] = -a0 * pim[2] + a2 * pim[0];
    C[3 * i + 2] = a0 * pim[1] - a1 * pim[0];
  }
  // rows of Pz @ M with Pz = [[az, 0, c0], [0, az, c1]]
  for (int j = 0; j < 3; ++j) {
    w.Jl0[j] = az * B1[j] + c0 * B1[6 + j];
    w.Jl1[j] = az * B1[3 + j] + c1 * B1[6 + j];
    w.Jp0[j] = -w.Jl0[j];
    w.Jp1[j] = -w.Jl1[j];
    w.Jp0[3 + j] = az * C[j] + c0 * C[6 + j];
    w.Jp1[3 + j] = az * C[3 + j] + c1 * C[6 + j];
  }
  for (int j = 0; j < 6; ++j) w.Je0[j] = w.Je1[j] = T(0);
  if (a.want_ext) {
    // [Xc]x row-major
    const T S[9] = {T(0), -Xc[2], Xc[1], Xc[2], T(0), -Xc[0],
                    -Xc[1], Xc[0], T(0)};
    for (int j = 0; j < 3; ++j) {
      w.Je0[j] = -(az * Rc[j] + c0 * Rc[6 + j]);
      w.Je1[j] = -(az * Rc[3 + j] + c1 * Rc[6 + j]);
      w.Je0[3 + j] = az * S[j] + c0 * S[6 + j];
      w.Je1[3 + j] = az * S[3 + j] + c1 * S[6 + j];
    }
  }

  const T s = r0 * r0 + r1 * r1;
  if (a.cauchy_a > T(0)) {
    const T a2 = a.cauchy_a * a.cauchy_a;
    const T wr = sqrt(T(1) / (T(1) + s / a2));
    w.cost = T(0.5) * a2 * log1p(s / a2);
    r0 *= wr;
    r1 *= wr;
    for (int i = 0; i < 6; ++i) {
      w.Jp0[i] *= wr; w.Jp1[i] *= wr; w.Je0[i] *= wr; w.Je1[i] *= wr;
    }
    for (int i = 0; i < 3; ++i) { w.Jl0[i] *= wr; w.Jl1[i] *= wr; }
  } else {
    w.cost = T(0.5) * s;
  }
  w.r0 = r0;
  w.r1 = r1;
}

// Shared memory of a frame block (elements of T, then one int) and of a
// landmark block (elements of T, then ints).
__host__ __device__ inline size_t frame_elems(int nc, int want_ext) {
  return (size_t)(kWarps + 1) * (kFrameE + (want_ext ? kCamE * nc : 0));
}
// frame stride of the PL tile in shared memory: odd, against bank conflicts
__host__ __device__ inline int pl_stride(int L) { return L * 18 + 1; }
__host__ __device__ inline size_t lm_elems(int nf, int nc, int want_ext,
                                           int L) {
  return (size_t)nf * pl_stride(L) +
         (size_t)L * (kLmE + (want_ext ? 18 * nc : 0)) +
         (size_t)kThreads * (want_ext ? kRowExt : kRow);
}

template <typename T>
size_t smem_bytes(int nf, int nc, int want_ext, int L) {
  const size_t fr = frame_elems(nc, want_ext) * sizeof(T) + sizeof(int);
  const size_t lm = lm_elems(nf, nc, want_ext, L) * sizeof(T) +
                    ((size_t)L + 1 + 3 * kThreads) * sizeof(int);
  return fr > lm ? fr : lm;
}

// Frame f of window b: PP[b,f], GP[b,f], PE[b,f] written; the cost (and
// EE/GE) partial goes to scratch row (b, f), and the window's last frame
// block to finish sums those rows in frame order.
template <typename T>
__device__ __forceinline__ void frame_block(const Args<T>& a, int b, int f,
                                            T* sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nf = a.nf, nc = a.nc, ext = a.want_ext;
  const int E = kFrameE + (ext ? kCamE * nc : 0);
  T* red = sm;                       // (kWarps, E) warp sums of a chunk
  T* acc = red + kWarps * E;         // (E,) sums over the chunks
  int* last = reinterpret_cast<int*>(acc + E);
  for (int k = tid; k < E; k += kThreads) acc[k] = T(0);
  // a frame without rows skips the loop and its barriers, and the stores
  // below read entries of acc that other warps zeroed
  __syncthreads();

  const int* off = a.off_f + (long)b * (nf + 1);
  const int s0 = off[f], s1 = off[f + 1];
  MARK(1);
  for (int cs = s0; cs < s1; cs += kThreads) {
    const bool live = cs + tid < s1;
    Rows<T> w;
    int c = -1;
    if (live) {
      const int4 r = a.rows_f[(long)b * a.nobs + cs + tid];
      c = r.z;
      linearize(a, b, r.x, f, c, r.w, w);
    }
    if (cs == s0) MARK(2);
    {
      int e = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = i; j < 6; ++j, ++e) {
          const T t = warp_sum(
              live ? w.Jp0[i] * w.Jp0[j] + w.Jp1[i] * w.Jp1[j] : T(0));
          if (lane == 0) red[warp * E + e] = t;
        }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const T t = warp_sum(live ? w.Jp0[i] * w.r0 + w.Jp1[i] * w.r1 : T(0));
        if (lane == 0) red[warp * E + 21 + i] = t;
      }
      const T t = warp_sum(live ? w.cost : T(0));
      if (lane == 0) red[warp * E + 27] = t;
    }
    if (cs == s0) MARK(3);
    for (int cc = 0; ext && cc < nc; ++cc) {
      const bool on = live && c == cc;
      T* r = red + warp * E + kFrameE + kCamE * cc;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const T t = warp_sum(
              on ? w.Jp0[i] * w.Je0[j] + w.Jp1[i] * w.Je1[j] : T(0));
          if (lane == 0) r[6 * i + j] = t;
        }
      int e = 36;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = i; j < 6; ++j, ++e) {
          const T t = warp_sum(
              on ? w.Je0[i] * w.Je0[j] + w.Je1[i] * w.Je1[j] : T(0));
          if (lane == 0) r[e] = t;
        }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const T t = warp_sum(on ? w.Je0[i] * w.r0 + w.Je1[i] * w.r1 : T(0));
        if (lane == 0) r[57 + i] = t;
      }
    }
    __syncthreads();
    for (int k = tid; k < E; k += kThreads) {
      T t = acc[k];
      for (int ww = 0; ww < kWarps; ++ww) t += red[ww * E + k];
      acc[k] = t;
    }
    __syncthreads();
  }

  MARK(4);
  const long bf = (long)b * nf + f;
  for (int k = tid; k < 36; k += kThreads) {
    const int i = k / 6, j = k % 6;
    a.PP[bf * 36 + k] = acc[i <= j ? tri6(i, j) : tri6(j, i)];
  }
  for (int k = tid; k < 6; k += kThreads) a.GP[bf * 6 + k] = acc[21 + k];
  for (int k = tid; k < nc * 36; k += kThreads)
    a.PE[bf * nc * 36 + k] =
        ext ? acc[kFrameE + kCamE * (k / 36) + k % 36] : T(0);
  const int EP = 1 + (ext ? kCamP * nc : 0);
  T* part = a.scratch + bf * EP;
  for (int k = tid; k < EP; k += kThreads)
    part[k] = k == 0 ? acc[27]
                     : acc[kFrameE + kCamE * ((k - 1) / kCamP) + 36 +
                           (k - 1) % kCamP];

  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(a.counter + b, 1) == nf - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  T* fin = red;                      // (EP,) sums in frame order
  for (int k = tid; k < EP; k += kThreads) {
    T t = T(0);
    for (int f0 = 0; f0 < nf; f0 += 8) {
      T x[8];                        // eight loads in flight
#pragma unroll
      for (int u = 0; u < 8; ++u)
        x[u] = f0 + u < nf
                   ? __ldcg(a.scratch + ((long)b * nf + f0 + u) * EP + k)
                   : T(0);
#pragma unroll
      for (int u = 0; u < 8; ++u) t += x[u];
    }
    fin[k] = t;
  }
  __syncthreads();
  if (tid == 0) {
    a.cost[b] = fin[0];
    a.counter[b] = 0;
  }
  for (int k = tid; k < nc * 36; k += kThreads) {
    const int i = (k % 36) / 6, j = k % 6;
    a.EE[(long)b * nc * 36 + k] =
        ext ? fin[1 + kCamP * (k / 36) + (i <= j ? tri6(i, j) : tri6(j, i))]
            : T(0);
  }
  for (int k = tid; k < nc * 6; k += kThreads)
    a.GE[(long)b * nc * 6 + k] =
        ext ? fin[1 + kCamP * (k / 6) + 21 + k % 6] : T(0);
}

// Landmarks [l0, l0 + L) of window b, l0 = L·tile: PL, LL, GL, LE written
// whole.
template <typename T>
__device__ __forceinline__ void landmark_block(const Args<T>& a, int b,
                                               int tile, T* sm) {
  const int tid = threadIdx.x;
  const int nf = a.nf, nl = a.nl, nc = a.nc, L = a.L, ext = a.want_ext;
  const int l0 = tile * L, nL = min(L, nl - l0);
  const int FS = pl_stride(L), RS = ext ? kRowExt : kRow;
  const int NE = kLmE + (ext ? 18 * nc : 0);
  T* PLt = sm;                               // (nf, FS): [f][ll][6][3]
  T* LMt = PLt + (size_t)nf * FS;            // (L, NE): LL 9 | GL 3 | LE
  T* stage = LMt + (size_t)L * NE;           // (kThreads, RS)
  int* offs = reinterpret_cast<int*>(stage + kThreads * RS);   // (L + 1,)
  int* sf = offs + L + 1;                    // frame of each staged row
  int* sc = sf + kThreads;                   // its camera
  int* sl = sc + kThreads;                   // its landmark, tile-local

  {
    // zero the PL/LL/GL/LE tile, 16 bytes a store
    const int n_el = nf * FS + L * NE, n16 = n_el * (int)sizeof(T) / 16;
    for (int k = tid; k < n16; k += kThreads)
      reinterpret_cast<float4*>(PLt)[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = n16 * 16 / (int)sizeof(T) + tid; k < n_el; k += kThreads)
      PLt[k] = T(0);
  }
  const int* off = a.off_l + (long)b * (nl + 1) + l0;
  for (int k = tid; k <= nL; k += kThreads) offs[k] = off[k];
  __syncthreads();

  const int s0 = offs[0], s1 = offs[nL];
  MARK(1);
  for (int cs = s0; cs < s1; cs += kThreads) {
    const int n = min(kThreads, s1 - cs);
    const bool live = tid < n;
    Rows<T> w;
    int f = -1, ll = -1;
    if (live) {
      const int4 r4 = a.rows_l[(long)b * a.nobs + cs + tid];
      f = r4.y;
      const int c = r4.z;
      ll = r4.w - l0;
      linearize(a, b, r4.x, f, c, r4.w, w);
      T* r = stage + tid * RS;
      for (int i = 0; i < 6; ++i) {
        r[i] = w.Jp0[i];
        r[6 + i] = w.Jp1[i];
      }
      for (int i = 0; i < 3; ++i) {
        r[12 + i] = w.Jl0[i];
        r[15 + i] = w.Jl1[i];
      }
      r[18] = w.r0;
      r[19] = w.r1;
      if (ext)
        for (int i = 0; i < 6; ++i) {
          r[20 + i] = w.Je0[i];
          r[26 + i] = w.Je1[i];
        }
      sf[tid] = f;
      sc[tid] = c;
      sl[tid] = ll;
    }
    if (cs == s0) MARK(2);
    __syncthreads();

    // PL: the first row of each run of equal (landmark, frame) in this
    // chunk adds the run's Jpᵀ Jl, rows in order
    if (live && (tid == 0 || sf[tid - 1] != f || sl[tid - 1] != ll)) {
      T sum[18];
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          sum[3 * i + j] = w.Jp0[i] * w.Jl0[j] + w.Jp1[i] * w.Jl1[j];
      for (int k = tid + 1; k < n && sf[k] == f && sl[k] == ll; ++k) {
        const T* r = stage + k * RS;
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j)
            sum[3 * i + j] += r[i] * r[12 + j] + r[6 + i] * r[15 + j];
      }
      T* d = PLt + (size_t)f * FS + ll * 18;
#pragma unroll
      for (int e = 0; e < 18; ++e) d[e] += sum[e];
    }

    if (cs == s0) MARK(3);
    // LL, GL (and LE): one (landmark, entry) per task, rows in order
    for (int task = tid; task < nL * NE; task += kThreads) {
      const int tl = task / NE, e = task - tl * NE;
      const int lo = max(offs[tl] - cs, 0), hi = min(offs[tl + 1] - cs, n);
      if (lo >= hi) continue;
      T t = LMt[task];
      if (e < kLmE) {
        // LL(i, j) = Jl0[i]·Jl0[j] + Jl1[i]·Jl1[j]; GL(i): r in place of Jl
        const int i = e < 9 ? e / 3 : e - 9;
        const int xa = e < 9 ? 12 + e % 3 : 18, xb = e < 9 ? 15 + e % 3 : 19;
        for (int k = lo; k < hi; ++k) {
          const T* r = stage + k * RS;
          t += r[12 + i] * r[xa] + r[15 + i] * r[xb];
        }
      } else {
        const int cc = (e - kLmE) / 18, m = (e - kLmE) % 18;
        const int i = m / 3, j = m % 3;
        for (int k = lo; k < hi; ++k) {
          if (sc[k] != cc) continue;
          const T* r = stage + k * RS;
          t += r[20 + i] * r[12 + j] + r[26 + i] * r[15 + j];
        }
      }
      LMt[task] = t;
    }
    if (cs == s0) MARK(4);
    __syncthreads();
  }

  MARK(5);
  // the whole tile, zeros included: contiguous runs
  for (int f = 0; f < nf; ++f) {
    T* dst = a.PL + (((long)b * nf + f) * nl + l0) * 18;
    const T* src = PLt + (size_t)f * FS;
    for (int k = tid; k < nL * 18; k += kThreads) dst[k] = src[k];
  }
  for (int k = tid; k < nL * 9; k += kThreads)
    a.LL[((long)b * nl + l0) * 9 + k] = LMt[(k / 9) * NE + k % 9];
  for (int k = tid; k < nL * 3; k += kThreads)
    a.GL[((long)b * nl + l0) * 3 + k] = LMt[(k / 3) * NE + 9 + k % 3];
  const int nce = nc * 18;
  for (int k = tid; k < nL * nce; k += kThreads)
    a.LE[((long)b * nl + l0) * nce + k] =
        ext ? LMt[(k / nce) * NE + kLmE + k % nce] : T(0);
}

// Blocks [0, nf) of each window are its frame blocks, the rest its
// landmark tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    proj_segments_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  MARK(0);
  if ((int)blockIdx.x < a.nf)
    frame_block(a, blockIdx.y, blockIdx.x, sm);
  else
    landmark_block(a, blockIdx.y, blockIdx.x - a.nf, sm);
  MARK(7);
}

// The device's opt-in shared memory per block, queried once per device.
int max_optin_smem(int* out) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && cached[dev] > 0) {
    *out = cached[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess && dev < 64) cached[dev] = *out;
  return (int)err;
}

template <typename T>
int launch(const void* const* ptr, int B, int nf, int nl, int nc, int nobs,
           int L, double weight, double cauchy_a, int want_ext,
           void* stream) {
  if (B <= 0) return 0;
  if (nf <= 0 || nl <= 0 || nc <= 0 || L <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  int max_optin = 0;
  int err = max_optin_smem(&max_optin);
  if (err != 0) return err;
  const size_t shm = smem_bytes<T>(nf, nc, want_ext, L);
  if (shm > (size_t)max_optin) return (int)cudaErrorInvalidValue;
  if (shm > 48 * 1024) {
    // above 48 KB dynamic shared memory must be opted into
    err = (int)cudaFuncSetAttribute(
        proj_segments_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (err != 0) return err;
  }
  Args<T> a;
  a.p = (const T*)ptr[0];
  a.lm = (const T*)ptr[1];
  a.q = (const T*)ptr[2];
  a.qic = (const T*)ptr[3];
  a.tic = (const T*)ptr[4];
  a.pbg = (const T*)ptr[5];
  a.xy = (const T*)ptr[6];
  a.rows_l = (const int4*)ptr[7];
  a.off_l = (const int*)ptr[8];
  a.rows_f = (const int4*)ptr[9];
  a.off_f = (const int*)ptr[10];
  a.counter = (int*)ptr[11];
  a.scratch = (T*)ptr[12];
  a.PP = (T*)ptr[13];
  a.PL = (T*)ptr[14];
  a.PE = (T*)ptr[15];
  a.EE = (T*)ptr[16];
  a.LE = (T*)ptr[17];
  a.LL = (T*)ptr[18];
  a.GP = (T*)ptr[19];
  a.GL = (T*)ptr[20];
  a.GE = (T*)ptr[21];
  a.cost = (T*)ptr[22];
  a.nf = nf;
  a.nl = nl;
  a.nc = nc;
  a.nobs = nobs;
  a.L = L;
  a.want_ext = want_ext;
  a.weight = (T)weight;
  a.cauchy_a = (T)cauchy_a;
  dim3 grid(nf + (nl + L - 1) / L, B);
  proj_segments_kernel<T><<<grid, kThreads, shm, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int pick_tile(int nf, int nc, int want_ext, int max_tile) {
  int max_optin = 0;
  if (max_optin_smem(&max_optin) != 0) return -1;
  for (int L = max_tile; L >= 1; L /= 2)
    if (smem_bytes<T>(nf, nc, want_ext, L) <= (size_t)max_optin) return L;
  return 0;
}

}  // namespace

extern "C" {

#ifdef PROJ_SEGMENTS_TIMELINE
// Copy the stamps of the first n blocks (n·8 uint64, blocks in launch order
// blockIdx.y · gridDim.x + blockIdx.x) to host memory.
int proj_segments_timeline(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_timeline,
                                   (size_t)n * kMarks * sizeof(long long));
}
#endif

// Landmark tile for this shape on the current device: the largest power of
// two L <= max_tile whose blocks fit its opt-in shared memory; 0 if none
// does, -1 if the device cannot be queried.
int proj_segments_tile(int nf, int nc, int want_ext, int elem_bytes,
                       int max_tile) {
  return elem_bytes == 8 ? pick_tile<double>(nf, nc, want_ext, max_tile)
                         : pick_tile<float>(nf, nc, want_ext, max_tile);
}

size_t proj_segments_smem_bytes(int nf, int nc, int want_ext, int elem_bytes,
                                int L) {
  return elem_bytes == 8 ? smem_bytes<double>(nf, nc, want_ext, L)
                         : smem_bytes<float>(nf, nc, want_ext, L);
}

// ptr (23 device pointers, in this order): p (B,nf,3), landmarks (B,nl,3),
// q (B,nf,4), qic (B,nc,4), tic (B,nc,3), pbg (3,), xy (B,nobs,2); the
// plan's rows_l (B,nobs,4), off_l (B,nl+1), rows_f (B,nobs,4),
// off_f (B,nf+1) int32 and counter (B,) int32, zero on entry and on
// return; scratch (B, nf, 1 + 27·nc·want_ext);
// outputs PP, PL, PE, EE, LE, LL, GP, GL, GE, cost.  Everything contiguous; the outputs need no
// initial value.  Returns a CUDA error code.
int proj_segments_f32(const void* const* ptr, int B, int nf, int nl, int nc,
                      int nobs, int L, double weight, double cauchy_a,
                      int want_ext, void* stream) {
  return launch<float>(ptr, B, nf, nl, nc, nobs, L, weight, cauchy_a,
                       want_ext, stream);
}

int proj_segments_f64(const void* const* ptr, int B, int nf, int nl, int nc,
                      int nobs, int L, double weight, double cauchy_a,
                      int want_ext, void* stream) {
  return launch<double>(ptr, B, nf, nl, nc, nobs, L, weight, cauchy_a,
                        want_ext, stream);
}

}  // extern "C"
