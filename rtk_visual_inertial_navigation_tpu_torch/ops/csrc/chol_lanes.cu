// Batched small SPD solve: Cholesky S = L Lᵀ of every system, then forward
// and back substitution; only x is written back.
//
// Replaces the Pallas kernel rtk_visual_inertial_navigation_tpu/ops/
// pallas_chol_lanes.py::_lanes_kernel (driven by chol_solve_lanes), with its
// semantics: f32 in and out, the pivot taken as a·rsqrt(max(a, 1e-30)) so a
// non-SPD input gives no NaN from the square root, the column recurrence
// (right-looking), then L y = b and Lᵀ x = y.  The TPU kernel's layout idioms
// are not carried over: no batch-in-lanes transpose, no padding of B to 128
// with identity systems, no n % 8 restriction.
//
// Design for Hopper: one thread block per system, the whole matrix in
// dynamic shared memory (row stride n|1, odd, so a warp walking a column
// hits 32 different banks).  Per column j: every thread reads the pivot,
// the scaled column goes to a shared vector, one barrier, then the column is
// written and the lower trailing triangle updated (one warp per row, lanes
// along the row), one barrier.  The substitutions are column-oriented (one
// barrier per column).  At n = 120 a block uses 59 KB of shared memory, so
// three blocks fit on an SM and a batch of 256 systems is resident at once.
//
// Bound: bytes, narrowly.  Each system reads the lower triangle of S (the
// 32-byte sectors its rows span: 960 of the 1800 of a full 120x120 matrix)
// and n floats of rhs, and writes n; the arithmetic (n³/3 + 2n² FLOP) takes
// about as long at f32 peak.  This simple kernel is latency-bound instead
// (2n + 2n barriers per system).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline int row_stride(int n) { return n | 1; }

__global__ void chol_lanes_kernel(const float* __restrict__ S,
                                  const float* __restrict__ rhs,
                                  float* __restrict__ x, int n) {
  extern __shared__ float sh[];
  const int ld = row_stride(n);
  float* A = sh;             // n x ld, lower triangle used
  float* col = A + n * ld;   // scaled column / y
  float* b = col + n;        // right-hand side, updated in place
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarp = blockDim.x >> 5;
  const size_t sys = blockIdx.x;
  const float* Sg = S + sys * n * n;

  for (int k = tid; k < n * n; k += blockDim.x) {
    const int r = k / n, c = k - r * n;
    if (c <= r) A[r * ld + c] = Sg[k];
  }
  for (int k = tid; k < n; k += blockDim.x) b[k] = rhs[sys * n + k];
  __syncthreads();

  // ---- factor: column j of L, then the rank-1 update of the trailing
  // lower triangle ----
  for (int j = 0; j < n; ++j) {
    const float d = rsqrtf(fmaxf(A[j * ld + j], 1e-30f));
    for (int i = j + tid; i < n; i += blockDim.x) col[i] = A[i * ld + j] * d;
    __syncthreads();
    for (int i = j + tid; i < n; i += blockDim.x) A[i * ld + j] = col[i];
    for (int r = j + 1 + warp; r < n; r += nwarp) {
      const float cr = col[r];
      for (int c = j + 1 + lane; c <= r; c += 32) A[r * ld + c] -= cr * col[c];
    }
    __syncthreads();
  }

  // ---- forward: L y = b, y kept in col ----
  for (int j = 0; j < n; ++j) {
    const float yj = b[j] / A[j * ld + j];
    for (int i = j + 1 + tid; i < n; i += blockDim.x) b[i] -= A[i * ld + j] * yj;
    if (tid == 0) col[j] = yj;
    __syncthreads();
  }

  // ---- backward: Lᵀ x = y (row j of L is column j of Lᵀ) ----
  float* xg = x + sys * n;
  for (int j = n - 1; j >= 0; --j) {
    const float xj = col[j] / A[j * ld + j];
    for (int i = tid; i < j; i += blockDim.x) col[i] -= A[j * ld + i] * xj;
    if (tid == 0) xg[j] = xj;
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Shared memory a block needs for an n x n system.
size_t chol_lanes_smem_bytes(int n) {
  return ((size_t)n * row_stride(n) + 2 * (size_t)n) * sizeof(float);
}

// S (B, n, n), rhs (B, n), x (B, n): contiguous f32 on the device.
// Returns a CUDA error code (0 on success); an n whose matrix does not fit
// in shared memory is refused with cudaErrorInvalidValue.
int chol_lanes_f32(const void* S, const void* rhs, void* x, int B, int n,
                   void* stream) {
  if (B <= 0) return 0;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t shm = chol_lanes_smem_bytes(n);
  if (shm > (size_t)max_optin) return (int)cudaErrorInvalidValue;
  // above 48 KB dynamic shared memory must be opted into
  err = cudaFuncSetAttribute(chol_lanes_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shm);
  if (err != cudaSuccess) return (int)err;
  chol_lanes_kernel<<<B, kThreads, shm, (cudaStream_t)stream>>>(
      (const float*)S, (const float*)rhs, (float*)x, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
