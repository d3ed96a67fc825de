// Batched triangular solves with a Cholesky factor: L Lᵀ x = b for (B, n, n)
// lower factors L and right-hand sides b (B, n, k), f32.
//
// Replaces the substitution half of the Pallas kernel rtk_visual_inertial_
// navigation_tpu/ops/pallas_chol_lanes.py::_lanes_kernel (forward L y = b,
// then back Lᵀ x = y, each dividing by L_jj), for k right-hand sides at once
// so that one factor (chol_lanes.cu) serves a solve and its refinements.
//
// Design for Hopper: one CTA per system and group of up to 16 columns,
// b in shared memory (row stride k|1 rounded up, odd).  Both substitutions
// are blocked by the factor's 32x32 tiles, 2·n/32 steps in all.  Each step
// reads one strip of L — forward: the 32 columns of the tile from its
// diagonal down; back: the tile's 32 rows up to its diagonal — into shared
// memory by cp.async, coalesced, the next step's strip in flight while this
// one is solved (two buffers).  Per step: each warp solves the diagonal
// tile for two columns at once in registers with shuffles (lane = row; the
// tile's row or column of L and 1/L_jj in registers), one barrier, then all
// threads update the rows not solved yet from the strip, each holding the
// tile's solved values of its column in registers, then the wait for the
// next strip and a barrier.  L is read once per solve.
//
// Bound: bytes (the lower triangle of L read, b read, x written; 2n²k FLOP
// is far below).  This kernel is held back by the 2·n/32 dependent steps
// per solve and by using one SM per system.

#include <cuda_runtime.h>

namespace {

#ifdef CHOL_LANES_TIMELINE
// Built with -DCHOL_LANES_TIMELINE (profile_chol.py): thread 0 of each CTA
// adds the clock cycles it spends in each phase (waits at barriers
// included) over all tiles, for one launch of at most kTimelineBlocks CTAs.
constexpr int kTimelineBlocks = 1 << 14, kPhases = 8;
__device__ long long g_timeline[kTimelineBlocks * kPhases];
#define PHASE_START long long t_last = clock64(), t_acc[kPhases] = {};
#define PHASE(p)                           \
  do {                                     \
    const long long t_now = clock64();     \
    t_acc[(p)] += t_now - t_last;          \
    t_last = t_now;                        \
  } while (0)
#define PHASE_END                                                        \
  if (threadIdx.x == 0 && blockIdx.x < kTimelineBlocks)                  \
    for (int p = 0; p < kPhases; ++p)                                    \
      g_timeline[blockIdx.x * kPhases + p] = t_acc[p];
#else
#define PHASE_START
#define PHASE(p) \
  do {           \
  } while (0)
#define PHASE_END
#endif

constexpr int NB = 32;
constexpr int KC = 16;            // right-hand sides per CTA
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Columns handled by one CTA rounded up to a power of two, and the row
// stride of b in shared memory.
__host__ __device__ inline int pow2_cols(int kc) {
  int p = 1;
  while (p < kc) p *= 2;
  return p;
}
__host__ __device__ inline int ld_of(int kp) { return kp + 1; }
// floats of one strip buffer: a forward strip (up to nt·32 rows × 33) or a
// back strip (32 rows × (nt·32 + 1))
__host__ __device__ inline int strip_floats(int nt) {
  return 33 * nt * NB + NB;
}

__device__ inline void cp_async4(float* dst, const float* src, bool read) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(read ? 4 : 0));
}

// Start copying the strip of step s (s < nt: forward tile s; else back tile
// 2nt-1-s) into W; elements outside the lower triangle are zero-filled.
__device__ inline void issue_strip(float* W, const float* Lg, int n, int nt,
                                   int s, int tid) {
  if (s >= 2 * nt) return;
  if (s < nt) {
    const int r0 = s * NB, nr = n - r0;
    for (int e = tid; e < nr * NB; e += kThreads) {
      const int r = e / NB, c = e % NB;
      const bool read = c <= r;
      cp_async4(W + r * 33 + c, read ? Lg + (size_t)(r0 + r) * n + r0 + c : Lg,
                read);
    }
  } else {
    const int t = 2 * nt - 1 - s, r0 = t * NB, w = r0 + NB;
    const int nr = min(NB, n - r0);
    for (int e = tid; e < nr * w; e += kThreads) {
      const int r = e / w, c = e % w;
      const bool read = c <= r0 + r;
      cp_async4(W + r * (w + 1) + c,
                read ? Lg + (size_t)(r0 + r) * n + c : Lg, read);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 2)
chol_lanes_solve_kernel(const float* __restrict__ L,
                        const float* __restrict__ b, float* __restrict__ x,
                        int n, int k) {
  PHASE_START
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t sys = blockIdx.x;
  const int q0 = blockIdx.y * KC;
  const int kc = min(KC, k - q0);
  const int kp = pow2_cols(kc), ld = ld_of(kp);
  const int nt = (n + NB - 1) / NB;
  const float* Lg = L + sys * n * n;
  extern __shared__ float sh[];
  float* Y = sh;                            // (nt·32) x ld, rows past n zero
  float* const W0 = Y + nt * NB * ld;       // two strip buffers
  float* const W1 = W0 + strip_floats(nt);

  issue_strip(W0, Lg, n, nt, 0, tid);
  for (int e = tid; e < nt * NB * kp; e += kThreads) {
    const int r = e / kp, q = e % kp;
    Y[r * ld + q] = (r < n && q < kc) ? b[(sys * n + r) * k + q0 + q] : 0.f;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  PHASE(0);

  // update mapping: thread = (row offset, column); rows step by rstep
  const int q = tid % kp, rstep = kThreads / kp;
  const bool qok = q < kc;

  for (int s = 0; s < 2 * nt; ++s) {
    float* W = (s & 1) ? W1 : W0;
    issue_strip((s & 1) ? W0 : W1, Lg, n, nt, s + 1, tid);
    const bool fwd = s < nt;
    const int t = fwd ? s : 2 * nt - 1 - s, r0 = t * NB;
    const int nr = min(NB, n - r0);       // real rows of this tile
    const int ws = fwd ? 33 : r0 + NB + 1;
    // ---- the diagonal tile: lane = row r0 + lane; warp w solves columns
    // w and w + 8 together (two independent chains); the tile's row or
    // column of L and 1/L_jj in registers, only ever indexed by constants
    float l[NB];
    float rinv = 1.f;
    if (lane < nr) {
      if (fwd) {
#pragma unroll
        for (int j = 0; j < NB; ++j) l[j] = W[lane * 33 + j];
        rinv = 1.f / W[lane * 33 + lane];
      } else {
#pragma unroll
        for (int j = 0; j < NB; ++j) l[j] = j < nr ? W[j * ws + r0 + lane] : 0.f;
        rinv = 1.f / W[lane * ws + r0 + lane];
      }
    } else {
#pragma unroll
      for (int j = 0; j < NB; ++j) l[j] = 0.f;
    }
    const int qa = warp, qb = warp + kThreads / 32;
    if (qa < kc) {
      const bool two = qb < kc;
      float va = Y[(r0 + lane) * ld + qa];
      float vb = two ? Y[(r0 + lane) * ld + qb] : 0.f;
      if (fwd) {
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          if (lane == j) { va *= rinv; vb *= rinv; }
          const float ya = __shfl_sync(kFull, va, j);
          const float yb = __shfl_sync(kFull, vb, j);
          if (lane > j) { va -= l[j] * ya; vb -= l[j] * yb; }
        }
      } else {
#pragma unroll
        for (int j = NB - 1; j >= 0; --j) {
          if (lane == j) { va *= rinv; vb *= rinv; }
          const float xa = __shfl_sync(kFull, va, j);
          const float xb = __shfl_sync(kFull, vb, j);
          if (lane < j) { va -= l[j] * xa; vb -= l[j] * xb; }
        }
      }
      Y[(r0 + lane) * ld + qa] = va;
      if (two) Y[(r0 + lane) * ld + qb] = vb;
    }
    PHASE(fwd ? 1 : 4);
    __syncthreads();
    PHASE(2);
    // ---- the rows not solved yet, from the strip: thread (row offset,
    // column q) holds the tile's 32 solved values of column q in registers
    if (qok) {
      float t32[NB];
#pragma unroll
      for (int m = 0; m < NB; ++m) t32[m] = Y[(r0 + m) * ld + q];
      if (fwd) {
        for (int i = NB + tid / kp; i < n - r0; i += rstep) {
          float acc = 0.f;
#pragma unroll
          for (int m = 0; m < NB; ++m) acc = fmaf(W[i * 33 + m], t32[m], acc);
          Y[(r0 + i) * ld + q] -= acc;
        }
      } else {
        for (int r = tid / kp; r < r0; r += rstep) {
          float acc = 0.f;
#pragma unroll
          for (int m = 0; m < NB; ++m)
            if (m < nr) acc = fmaf(W[m * ws + r], t32[m], acc);
          Y[r * ld + q] -= acc;
        }
      }
    }
    PHASE(fwd ? 3 : 5);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    PHASE(6);
  }

  for (int e = tid; e < n * kp; e += kThreads) {
    const int r = e / kp, qq = e % kp;
    if (qq < kc) x[(sys * n + r) * k + q0 + qq] = Y[r * ld + qq];
  }
  PHASE(7);
  PHASE_END
}

size_t smem_bytes(int n, int k) {
  const int kp = pow2_cols(k < KC ? k : KC);
  const int nt = (n + NB - 1) / NB;
  return ((size_t)nt * NB * ld_of(kp) + 2 * (size_t)strip_floats(nt)) *
         sizeof(float);
}

}  // namespace

extern "C" {

#ifdef CHOL_LANES_TIMELINE
// Copy the phase cycles of the first n CTAs (n·8 int64) to host memory.
int chol_lanes_solve_timeline(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_timeline,
                                   (size_t)n * kPhases * sizeof(long long));
}
#endif

size_t chol_lanes_solve_smem_bytes(int n, int k) { return smem_bytes(n, k); }

// L (B, n, n), b and x (B, n, k): contiguous f32 on the device.  Returns a
// CUDA error code (0 on success); an n whose strips and rows of b do not
// fit in shared memory is refused with cudaErrorInvalidValue.
int chol_lanes_solve_f32(const void* L, const void* b, void* x, int B, int n,
                         int k, void* stream) {
  if (B <= 0 || k <= 0) return 0;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t shm = smem_bytes(n, k);
  if (shm > (size_t)max_optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(chol_lanes_solve_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shm);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)B, (unsigned)((k + KC - 1) / KC));
  chol_lanes_solve_kernel<<<grid, kThreads, shm, (cudaStream_t)stream>>>(
      (const float*)L, (const float*)b, (float*)x, n, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
