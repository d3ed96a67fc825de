// Batched blocked Cholesky factor S = L Lᵀ of (B, n, n) f32 systems; L and
// a cholesky_ex-style info are written back.
//
// Replaces the factor half of the Pallas kernel rtk_visual_inertial_
// navigation_tpu/ops/pallas_chol_lanes.py::_lanes_kernel (which writes L
// into its aliased output A_out), with its semantics: the lower triangle of
// S is read, and the pivot of column j is taken as d_j = rsqrt(max(a, 1e-30))
// with L_jj = a·d_j and L_ij = A_ij·d_j, so a non-SPD input gives a finite
// factor.  info[b] is 0, or 1 + the first column whose pivot a was ≤ 0 or
// not finite (torch.linalg.cholesky_ex's convention).  The solves are the
// separate kernel chol_lanes_solve.cu.
//
// Design for Hopper: right-looking blocked Cholesky on 32x32 tiles.  One
// system is one thread-block cluster of C CTAs: the smallest C whose CTAs
// fit the shared memory, raised while every CTA keeps at least two tile
// rows and all B clusters stay resident at once (1 at B=256 n=120, 3 at
// B=32 n=339, 5 at B=1 n=327).  The lower tiles (i, j), j ≤ i, live
// in the shared memory of CTA i mod C (row stride 33, odd).  Per panel k:
//   (a) every CTA reads tile (k, k) from its owner (distributed shared
//       memory) and warp 0 factors it in registers (no block barrier
//       inside): a shuffle per pivot, the scaled column broadcast through
//       shared memory, keeping d_k;
//   (b) each CTA solves its own panel tiles (i, k), i > k, one thread per
//       row (L_ik = A_ik L_kk⁻ᵀ, scaled by d_k as the recurrence does; the
//       columns of L_kk come as broadcast 16-byte loads), and pushes each
//       solved row into the panel buffer of every CTA of the cluster
//       (remote stores, which do not wait);
//   (c) cluster barrier;
//   (d) each CTA applies the rank-32 update A_ij -= L_ik L_jkᵀ to its own
//       trailing tiles in exact f32 FFMA (no tensor cores, no TF32) from its
//       local panel buffer (transposed, so four rows are one 16-byte load):
//       a thread owns 4 rows × 1 column in each of up to four tiles of a row;
//   (e) cluster barrier (a block barrier when C = 1).
// While warp 0 factors a diagonal tile, warps 1-7 store the previous panel
// to L (a warp per row, coalesced) and the zeros right of it, so the global
// stores hide behind the pivot chain.  That is 2 cluster and 1 block barrier
// per 32 columns, where an unblocked column recurrence takes 2 block
// barriers per column.
//
// Bound: at the batch sizes of the solves (B=256 n=120, B=32 n=339) the
// bytes (the lower triangle of S read, of L written) and the n³/3 FLOP at
// the f32 peak are within 1.4x of each other.  What limits this kernel is
// the chain of n dependent pivots in warp 0 (a shuffle, rsqrt, a
// shared-memory broadcast and an FMA each) and the barriers between the
// phases.
// Everywhere, loads and shuffles are issued in batches before their first
// use: a value consumed right after its load stalls the warp for the whole
// latency, and those stalls, not the arithmetic, first made this kernel
// slow (profile_chol.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NB = 32;            // tile edge
constexpr int LDT = NB + 1;       // tile row stride in shared memory
constexpr int TILE = NB * LDT;    // floats per owned tile
constexpr int PTILE = NB * NB;    // floats per panel tile (transposed)
constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr unsigned kFull = 0xffffffffu;

#ifdef CHOL_LANES_TIMELINE
// Built with -DCHOL_LANES_TIMELINE (profile_chol.py): thread 0 of each CTA
// adds the clock cycles it spends in each phase (waits at barriers
// included) over all panels, for one launch of at most kTimelineBlocks CTAs.
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

__host__ __device__ inline int num_tiles(int n) { return (n + NB - 1) / NB; }

// First slot, among the tiles its owner keeps, of tile row i (rows are
// owned by rank i mod C; row i holds tiles j = 0..i).
__host__ __device__ inline int row_slot(int i, int C) {
  int s = 0;
  for (int r = i % C; r < i; r += C) s += r + 1;
  return s;
}

__host__ __device__ inline int owned_tiles(int rank, int C, int nt) {
  int s = 0;
  for (int r = rank; r < nt; r += C) s += r + 1;
  return s;
}

__host__ inline int max_owned_tiles(int C, int nt) {
  int m = 0;
  for (int r = 0; r < C; ++r) {
    const int s = owned_tiles(r, C, nt);
    m = s > m ? s : m;
  }
  return m;
}

// A_ij -= L_ik L_jkᵀ for the NQ tiles j0..j0+NQ-1 of owned row i.  Thread
// (warp, lane) owns rows 4·warp..+3 and column lane of each tile; Pt holds
// the panel transposed (Pt[t][m][r] = L_tk[r][m]).
template <int NQ>
__device__ inline void update_unit(float* T, const float* Pt, int i, int j0,
                                   int warp, int lane) {
  const int r0 = 4 * warp;
  float acc[4][NQ] = {};
  const float* Li = Pt + i * PTILE + r0;
  const float* Lj = Pt + j0 * PTILE + lane;
#pragma unroll 8
  for (int m = 0; m < NB; ++m) {
    const float4 li = *reinterpret_cast<const float4*>(Li + m * NB);
    float lj[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) lj[q] = Lj[q * PTILE + m * NB];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      acc[0][q] = fmaf(li.x, lj[q], acc[0][q]);
      acc[1][q] = fmaf(li.y, lj[q], acc[1][q]);
      acc[2][q] = fmaf(li.z, lj[q], acc[2][q]);
      acc[3][q] = fmaf(li.w, lj[q], acc[3][q]);
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int a = 0; a < 4; ++a)
      T[(j0 + q) * TILE + (r0 + a) * LDT + lane] -= acc[a][q];
}

__global__ void __launch_bounds__(kThreads, 2)
chol_lanes_factor_kernel(const float* __restrict__ S, float* __restrict__ L,
                         int* __restrict__ info, int n, int own_tiles) {
  PHASE_START
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t sys = blockIdx.x / C;
  const int nt = num_tiles(n);
  const float* Sg = S + sys * n * n;
  float* Lg = L + sys * n * n;

  extern __shared__ __align__(16) float sh[];
  float* Pt = sh;                       // panel column k, transposed tiles
  float* DkT = Pt + nt * PTILE;         // L_kk transposed, d_j on the diagonal
  float* colb = DkT + PTILE;            // column j of the diagonal tile
  float* own = colb + NB;               // this CTA's tiles
  float* Lkk = own + own_tiles * TILE;  // L_kk by rows, two panels' worth
  auto tile = [&](int i, int j) { return own + (row_slot(i, C) + j) * TILE; };
  auto sync_all = [&]() {
    if (C == 1) __syncthreads();
    else cluster.sync();
  };

  // ---- load the owned tiles: the lower triangle of S, zero elsewhere,
  // identity past n (coalesced, eight loads in flight per thread); L is
  // zero right of the diagonal tiles ----
  for (int i = rank; i < nt; i += C) {
    float* T = tile(i, 0);
    const int total = (i + 1) * NB * NB;
    for (int e0 = tid; e0 < total; e0 += 8 * kThreads) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kThreads;
        const int j = e / (NB * NB), r = (e / NB) % NB, c = e % NB;
        const int R = i * NB + r, Cc = j * NB + c;
        v[u] = (e < total && R < n && Cc <= R) ? Sg[(size_t)R * n + Cc]
                                                : (R == Cc ? 1.f : 0.f);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kThreads;
        if (e < total)
          T[(e / (NB * NB)) * TILE + ((e / NB) % NB) * LDT + e % NB] = v[u];
      }
    }
  }
  PHASE(0);
  sync_all();
  PHASE(7);

  // Global stores by warps 1-7 while warp 0 factors a diagonal tile: the
  // finished panel kk of this CTA's rows, a warp per row (coalesced), and
  // the zeros of L right of the diagonal tile in tile row kk.
  auto store_panel = [&](int kk, int w0, int nw) {
    auto put = [&](int i, const float* T) {
      for (int r = w0; r < NB && i * NB + r < n; r += nw)
        if (kk * NB + lane < n)
          Lg[(size_t)(i * NB + r) * n + kk * NB + lane] = T[r * LDT + lane];
    };
    if (kk % C == rank) {
      put(kk, Lkk + (kk & 1) * TILE);
      for (int r = w0; r < NB && kk * NB + r < n; r += nw)
        for (int Cc = (kk + 1) * NB + lane; Cc < n; Cc += 32)
          Lg[(size_t)(kk * NB + r) * n + Cc] = 0.f;
    }
    const int i1 = kk + 1 + (((rank - (kk + 1)) % C) + C) % C;
    for (int i = i1; i < nt; i += C) put(i, tile(i, kk));
  };

  int bad = 0;   // 1 + the first failed pivot (warp 0; equal in every CTA)
  for (int k = 0; k < nt; ++k) {
    // ---- (a) factor the diagonal tile: lane = row, the row in registers;
    // per column the pivot by one shuffle, the scaled column broadcast
    // through shared memory as 16-byte loads (31 shuffles per column made
    // the warp wait on the SM's shuffle rate), then all its updates; the
    // pivots' own chain runs on each lane's diagonal entry alone.
    // DkT[j][c] = L_kk[c][j] below the diagonal and d_j on it.
    if (warp == 0) {
      const float* Akk = cluster.map_shared_rank(tile(k, k), k % C);
      float r[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c)
        r[c] = (c <= lane) ? Akk[lane * LDT + c] : 0.f;
      // this lane's diagonal entry, updated from its own row only, so the
      // next pivot waits on no shared-memory broadcast (the same FMAs as
      // r[lane], so bitwise the same value)
      float dg = Akk[lane * LDT + lane];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float a = __shfl_sync(kFull, dg, j);
        if (bad == 0 && k * NB + j < n && !(a > 0.f && a < INFINITY))
          bad = k * NB + j + 1;
        const float d = rsqrtf(a < 1e-30f ? 1e-30f : a);   // NaN stays NaN
        r[j] = (lane >= j) ? r[j] * d : 0.f;
        DkT[j * NB + lane] = (lane == j) ? d : r[j];
        colb[lane] = r[j];
        __syncwarp();
        float lc[NB];
#pragma unroll
        for (int g = (j + 1) / 4; g < NB / 4; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(colb + 4 * g);
          lc[4 * g] = v.x; lc[4 * g + 1] = v.y;
          lc[4 * g + 2] = v.z; lc[4 * g + 3] = v.w;
        }
        __syncwarp();
        if (lane > j) dg -= r[j] * r[j];
#pragma unroll
        for (int c = j + 1; c < NB; ++c)
          if (lane >= c) r[c] -= r[j] * lc[c];
      }
#pragma unroll
      for (int c = 0; c < NB; ++c) Lkk[(k & 1) * TILE + lane * LDT + c] = r[c];
    } else if (k > 0) {
      store_panel(k - 1, warp - 1, kThreads / 32 - 1);
    }
    __syncthreads();
    PHASE(1);

    // ---- (b) panel solve of the owned tiles (i, k), i > k: one row each;
    // the row goes back to the tile and to the panel buffer of every CTA
    const int i0 = k + 1 + (((rank - (k + 1)) % C) + C) % C;
    const int npanel = i0 < nt ? (nt - i0 + C - 1) / C : 0;
    for (int w = tid; w < npanel * NB; w += kThreads) {
      const int i = i0 + (w / NB) * C, r = w % NB, R = i * NB + r;
      float* Arow = tile(i, k) + r * LDT;
      float x[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) x[c] = Arow[c];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        // column j of L_kk (and d_j) as broadcast 16-byte loads, all
        // issued before the updates use them
        float col[NB];
#pragma unroll
        for (int g = j / 4; g < NB / 4; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(DkT + j * NB + 4 * g);
          col[4 * g] = v.x; col[4 * g + 1] = v.y;
          col[4 * g + 2] = v.z; col[4 * g + 3] = v.w;
        }
        x[j] *= col[j];
#pragma unroll
        for (int c = j + 1; c < NB; ++c) x[c] -= x[j] * col[c];
      }
#pragma unroll
      for (int c = 0; c < NB; ++c) Arow[c] = x[c];
      for (int dst = 0; dst < C; ++dst) {
        float* Pd = cluster.map_shared_rank(Pt, dst) + i * PTILE + r;
#pragma unroll
        for (int c = 0; c < NB; ++c) Pd[c * NB] = x[c];
      }
    }
    PHASE(2);
    sync_all();
    PHASE(3);

    // ---- (d) trailing update of the owned tiles (i, j), k < j ≤ i, in
    // units of up to four tiles of a row
    for (int i = i0; i < nt; i += C) {
      float* T = tile(i, 0);
      for (int j0 = k + 1; j0 <= i; j0 += 4) {
        switch (i - j0) {
          case 0: update_unit<1>(T, Pt, i, j0, warp, lane); break;
          case 1: update_unit<2>(T, Pt, i, j0, warp, lane); break;
          case 2: update_unit<3>(T, Pt, i, j0, warp, lane); break;
          default: update_unit<4>(T, Pt, i, j0, warp, lane);
        }
      }
    }
    PHASE(4);
    sync_all();
    PHASE(5);
  }
  // the loop ended on a cluster barrier: no CTA leaves while another
  // still reads its shared memory
  store_panel(nt - 1, warp, kThreads / 32);
  PHASE(6);
  if (rank == 0 && tid == 0) info[sys] = bad;
  PHASE_END
}

// Bytes of dynamic shared memory one CTA of a C-CTA cluster needs.
size_t smem_bytes(int n, int C) {
  const int nt = num_tiles(n);
  return ((size_t)(nt + 1) * PTILE + NB +
          (size_t)(max_owned_tiles(C, nt) + 2) * TILE) * sizeof(float);
}

// Opt the kernel into the shared memory of a C-CTA cluster for n.
cudaError_t configure(int n, int C, size_t* shm) {
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *shm = smem_bytes(n, C);
  if (*shm > (size_t)max_optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(chol_lanes_factor_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*shm);
}

cudaLaunchConfig_t launch_config(int B, int C, size_t shm, void* stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = shm;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Can all B clusters of C CTAs be resident at once?
bool one_wave(int B, int n, int C) {
  size_t shm = 0;
  if (configure(n, C, &shm) != cudaSuccess) return false;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(B, C, shm, nullptr, attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, chol_lanes_factor_kernel,
                                     &cfg) != cudaSuccess)
    return false;
  return clusters >= B;
}

}  // namespace

extern "C" {

#ifdef CHOL_LANES_TIMELINE
// Copy the phase cycles of the first n CTAs (n·8 int64) to host memory.
int chol_lanes_factor_timeline(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_timeline,
                                   (size_t)n * kPhases * sizeof(long long));
}
#endif

size_t chol_lanes_factor_smem_bytes(int n, int cluster) {
  return smem_bytes(n, cluster);
}

// The cluster size the launcher takes for (B, n) on the current device:
// the smallest C ≤ 8 whose CTAs fit the opt-in shared memory, raised by one
// while every CTA still owns at least two tile rows and all B clusters of
// the larger size are resident at once (a second wave would double the
// time).  With fewer rows per CTA the cluster barriers cost more than the
// trailing update they split: one system at n=327 (11 tile rows) factors
// in the same time with 3 to 5 CTAs and 9 % slower with 8 (PERF.md).  0 if
// no cluster size fits.
int chol_lanes_factor_cluster(int B, int n) {
  int C = 1;
  size_t shm = 0;
  while (C <= kMaxCluster && configure(n, C, &shm) != cudaSuccess) ++C;
  if (C > kMaxCluster) return 0;
  while (C + 1 <= kMaxCluster && 2 * (C + 1) <= num_tiles(n) &&
         one_wave(B, n, C + 1))
    ++C;
  return C;
}

// S (B, n, n), L (B, n, n) contiguous f32, info (B,) int32, on the device.
// cluster: CTAs per system (1 to 8), or 0 for
// chol_lanes_factor_cluster's choice.  Returns a CUDA error code (0 on
// success); an n that no cluster size fits, or a cluster size whose CTAs
// do not fit, is refused with cudaErrorInvalidValue.
int chol_lanes_factor_f32(const void* S, void* L, void* info, int B, int n,
                          int cluster, void* stream) {
  if (B <= 0) return 0;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int C = cluster > 0 ? cluster : chol_lanes_factor_cluster(B, n);
  if (C < 1 || C > kMaxCluster) return (int)cudaErrorInvalidValue;
  size_t shm = 0;
  cudaError_t err = configure(n, C, &shm);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(B, C, shm, stream, attr);
  err = cudaLaunchKernelEx(&cfg, chol_lanes_factor_kernel, (const float*)S,
                           (float*)L, (int*)info, n,
                           max_owned_tiles(C, num_tiles(n)));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
