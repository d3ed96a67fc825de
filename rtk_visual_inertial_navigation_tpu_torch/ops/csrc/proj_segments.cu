// Projection linearization + Schur segment assembly for a batch of windows.
//
// Replaces the Pallas kernel rtk_visual_inertial_navigation_tpu/ops/
// pallas_proj.py::_proj_kernel (driven by proj_segments_pallas).  Per
// observation: gather the frame pose, landmark and camera extrinsic, form the
// analytic reprojection residual and its 2x(6+3) Jacobian (plus the 2x6
// extrinsic rows when want_ext), apply the optional Cauchy corrector, and
// accumulate the Gram blocks:
//   PP[f] += Jpᵀ Jp   PL[f,l] += Jpᵀ Jl   LL[l] += Jlᵀ Jl
//   PE[f,c] += Jpᵀ Je  EE[c] += Jeᵀ Je    LE[l,c] += Jeᵀ Jl
//   GP[f] += Jpᵀ r    GL[l] += Jlᵀ r     GE[c] += Jeᵀ r    cost += ρ/2
//
// Design for Hopper: one thread per observation with indexed loads (the TPU
// kernel's one-hot MXU gathers and expanded-basis Grams have no purpose
// here).  The per-frame and per-camera blocks (PP, GP, PE, EE, GE, cost),
// which every observation of a window hits, are summed in shared memory
// first and flushed with one global atomic per entry and block; the
// per-landmark blocks (PL, LL, GL, LE) are sparse and go straight to global
// atomics.  Only the frame-diagonal PP blocks are formed: the solve never
// reads the off-diagonal (6nf)² entries.
//
// Bound: bytes.  At the flagship shape the kernel does ~0.5 kFLOP per
// observation but must write the (nf, nl, 6, 3) PL grid of every window
// (~0.3 MB per window in f32), so the least time is the output write at HBM
// rate; the atomics' order makes sums nondeterministic at roundoff.
//
// Ids outside [0, n) and rows with valid == 0 contribute nothing.
// Outputs must be zero on entry (the wrapper allocates them with zeros).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

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
__global__ void proj_segments_kernel(
    const T* __restrict__ p, const T* __restrict__ lm,
    const T* __restrict__ q, const T* __restrict__ qic,
    const T* __restrict__ tic, const T* __restrict__ pbg,
    const long long* __restrict__ fid, const long long* __restrict__ cid,
    const long long* __restrict__ lid, const T* __restrict__ xy,
    const unsigned char* __restrict__ valid,
    T* __restrict__ PP, T* __restrict__ PL, T* __restrict__ PE,
    T* __restrict__ EE, T* __restrict__ LE, T* __restrict__ LL,
    T* __restrict__ GP, T* __restrict__ GL, T* __restrict__ GE,
    T* __restrict__ cost, int nf, int nl, int nc, int nobs, T weight,
    T cauchy_a, int want_ext) {
  extern __shared__ unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);
  // shared layout: PP nf*36 | GP nf*6 | cost 1 | PE nf*nc*36 | EE nc*36 |
  //                GE nc*6   (the last three only when want_ext)
  T* sPP = sh;
  T* sGP = sPP + nf * 36;
  T* sCost = sGP + nf * 6;
  T* sPE = sCost + 1;
  T* sEE = sPE + nf * nc * 36;
  T* sGE = sEE + nc * 36;
  const int n_sh = nf * 42 + 1 + (want_ext ? nf * nc * 36 + nc * 42 : 0);
  for (int k = threadIdx.x; k < n_sh; k += blockDim.x) sh[k] = T(0);
  __syncthreads();

  const int b = blockIdx.y;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  const long ob = (long)b * nobs + o;
  bool live = o < nobs;
  long long f = 0, c = 0, l = 0;
  if (live) {
    f = fid[ob];
    c = cid[ob];
    l = lid[ob];
    live = valid[ob] != 0 && f >= 0 && f < nf && c >= 0 && c < nc &&
           l >= 0 && l < nl;
  }
  if (live) {
    const T* pf = p + ((long)b * nf + f) * 3;
    const T* pl = lm + ((long)b * nl + l) * 3;
    const T* tc = tic + ((long)b * nc + c) * 3;
    T R[9], Rc[9];                                 // R(q_f)ᵀ, R(q_ic)ᵀ
    quat_to_rot_t(q + ((long)b * nf + f) * 4, R);
    quat_to_rot_t(qic + ((long)b * nc + c) * 4, Rc);

    T u[3] = {pl[0] - pf[0], pl[1] - pf[1], pl[2] - pf[2]};
    T pim[3], w3[3], Xc[3];
    mat3vec(R, u, pim);
    for (int i = 0; i < 3; ++i) w3[i] = pim[i] + pbg[i] - tc[i];
    mat3vec(Rc, w3, Xc);

    const T eps = T(1e-3);
    const T z = Xc[2];
    const bool clamped = fabs(z) < eps;
    const T zs = clamped ? (z < T(0) ? -eps : eps) : z;
    const T inv_z = T(1) / zs;
    const T zm = clamped ? T(0) : T(1);           // d(safe_z)/dz
    const T xh = Xc[0] * inv_z, yh = Xc[1] * inv_z;
    T r0 = weight * (xh - xy[2 * ob]);
    T r1 = weight * (yh - xy[2 * ob + 1]);
    const T a = weight * inv_z;
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
    // rows of Pz @ M with Pz = [[a, 0, c0], [0, a, c1]]
    T Jp0[6], Jp1[6], Jl0[3], Jl1[3], Je0[6] = {}, Je1[6] = {};
    for (int j = 0; j < 3; ++j) {
      Jl0[j] = a * B1[j] + c0 * B1[6 + j];
      Jl1[j] = a * B1[3 + j] + c1 * B1[6 + j];
      Jp0[j] = -Jl0[j];
      Jp1[j] = -Jl1[j];
      Jp0[3 + j] = a * C[j] + c0 * C[6 + j];
      Jp1[3 + j] = a * C[3 + j] + c1 * C[6 + j];
    }
    if (want_ext) {
      // [Xc]x row-major
      const T S[9] = {T(0), -Xc[2], Xc[1], Xc[2], T(0), -Xc[0],
                      -Xc[1], Xc[0], T(0)};
      for (int j = 0; j < 3; ++j) {
        Je0[j] = -(a * Rc[j] + c0 * Rc[6 + j]);
        Je1[j] = -(a * Rc[3 + j] + c1 * Rc[6 + j]);
        Je0[3 + j] = a * S[j] + c0 * S[6 + j];
        Je1[3 + j] = a * S[3 + j] + c1 * S[6 + j];
      }
    }

    const T s = r0 * r0 + r1 * r1;
    T cost_t;
    if (cauchy_a > T(0)) {
      const T a2 = cauchy_a * cauchy_a;
      const T wr = sqrt(T(1) / (T(1) + s / a2));
      cost_t = T(0.5) * a2 * log1p(s / a2);
      r0 *= wr;
      r1 *= wr;
      for (int i = 0; i < 6; ++i) {
        Jp0[i] *= wr; Jp1[i] *= wr; Je0[i] *= wr; Je1[i] *= wr;
      }
      for (int i = 0; i < 3; ++i) { Jl0[i] *= wr; Jl1[i] *= wr; }
    } else {
      cost_t = T(0.5) * s;
    }

    // per-frame blocks: shared memory
    T* sp = sPP + f * 36;
    for (int i = 0; i < 6; ++i) {
      for (int j = 0; j < 6; ++j)
        atomicAdd(sp + 6 * i + j, Jp0[i] * Jp0[j] + Jp1[i] * Jp1[j]);
      atomicAdd(sGP + f * 6 + i, Jp0[i] * r0 + Jp1[i] * r1);
    }
    atomicAdd(sCost, cost_t);
    // per-landmark blocks: global
    T* gpl = PL + (((long)b * nf + f) * nl + l) * 18;
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 3; ++j)
        atomicAdd(gpl + 3 * i + j, Jp0[i] * Jl0[j] + Jp1[i] * Jl1[j]);
    T* gll = LL + ((long)b * nl + l) * 9;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j)
        atomicAdd(gll + 3 * i + j, Jl0[i] * Jl0[j] + Jl1[i] * Jl1[j]);
      atomicAdd(GL + ((long)b * nl + l) * 3 + i, Jl0[i] * r0 + Jl1[i] * r1);
    }
    if (want_ext) {
      T* spe = sPE + (f * nc + c) * 36;
      T* see = sEE + c * 36;
      for (int i = 0; i < 6; ++i) {
        for (int j = 0; j < 6; ++j) {
          atomicAdd(spe + 6 * i + j, Jp0[i] * Je0[j] + Jp1[i] * Je1[j]);
          atomicAdd(see + 6 * i + j, Je0[i] * Je0[j] + Je1[i] * Je1[j]);
        }
        atomicAdd(sGE + c * 6 + i, Je0[i] * r0 + Je1[i] * r1);
      }
      T* gle = LE + (((long)b * nl + l) * nc + c) * 18;
      for (int i = 0; i < 6; ++i)
        for (int j = 0; j < 3; ++j)
          atomicAdd(gle + 3 * i + j, Je0[i] * Jl0[j] + Je1[i] * Jl1[j]);
    }
  }
  __syncthreads();

  // flush the block's shared partial sums
  for (int k = threadIdx.x; k < nf * 36; k += blockDim.x)
    if (sPP[k] != T(0)) atomicAdd(PP + (long)b * nf * 36 + k, sPP[k]);
  for (int k = threadIdx.x; k < nf * 6; k += blockDim.x)
    if (sGP[k] != T(0)) atomicAdd(GP + (long)b * nf * 6 + k, sGP[k]);
  if (threadIdx.x == 0 && sCost[0] != T(0)) atomicAdd(cost + b, sCost[0]);
  if (want_ext) {
    for (int k = threadIdx.x; k < nf * nc * 36; k += blockDim.x)
      if (sPE[k] != T(0)) atomicAdd(PE + (long)b * nf * nc * 36 + k, sPE[k]);
    for (int k = threadIdx.x; k < nc * 36; k += blockDim.x)
      if (sEE[k] != T(0)) atomicAdd(EE + (long)b * nc * 36 + k, sEE[k]);
    for (int k = threadIdx.x; k < nc * 6; k += blockDim.x)
      if (sGE[k] != T(0)) atomicAdd(GE + (long)b * nc * 6 + k, sGE[k]);
  }
}

template <typename T>
int launch(const void* p, const void* lm, const void* q, const void* qic,
           const void* tic, const void* pbg, const long long* fid,
           const long long* cid, const long long* lid, const void* xy,
           const unsigned char* valid, void* PP, void* PL, void* PE,
           void* EE, void* LE, void* LL, void* GP, void* GL, void* GE,
           void* cost, int B, int nf, int nl, int nc, int nobs, double weight,
           double cauchy_a, int want_ext, void* stream) {
  if (B <= 0 || nobs <= 0) return 0;
  const size_t n_sh = (size_t)nf * 42 + 1 +
                      (want_ext ? (size_t)nf * nc * 36 + (size_t)nc * 42 : 0);
  const size_t shm = n_sh * sizeof(T);
  if (shm > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid((nobs + kThreads - 1) / kThreads, B);
  proj_segments_kernel<T><<<grid, kThreads, shm, (cudaStream_t)stream>>>(
      (const T*)p, (const T*)lm, (const T*)q, (const T*)qic, (const T*)tic,
      (const T*)pbg, fid, cid, lid, (const T*)xy, valid, (T*)PP, (T*)PL, (T*)PE,
      (T*)EE, (T*)LE, (T*)LL, (T*)GP, (T*)GL, (T*)GE, (T*)cost, nf, nl, nc,
      nobs, (T)weight, (T)cauchy_a, want_ext);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int proj_segments_f32(const void* p, const void* lm, const void* q,
                      const void* qic, const void* tic, const void* pbg,
                      const long long* fid, const long long* cid,
                      const long long* lid, const void* xy,
                      const unsigned char* valid, void* PP, void* PL, void* PE,
                      void* EE, void* LE, void* LL, void* GP, void* GL,
                      void* GE, void* cost, int B, int nf, int nl, int nc,
                      int nobs, double weight, double cauchy_a, int want_ext,
                      void* stream) {
  return launch<float>(p, lm, q, qic, tic, pbg, fid, cid, lid, xy, valid, PP, PL,
                       PE, EE, LE, LL, GP, GL, GE, cost, B, nf, nl, nc, nobs,
                       weight, cauchy_a, want_ext, stream);
}

int proj_segments_f64(const void* p, const void* lm, const void* q,
                      const void* qic, const void* tic, const void* pbg,
                      const long long* fid, const long long* cid,
                      const long long* lid, const void* xy,
                      const unsigned char* valid, void* PP, void* PL, void* PE,
                      void* EE, void* LE, void* LL, void* GP, void* GL,
                      void* GE, void* cost, int B, int nf, int nl, int nc,
                      int nobs, double weight, double cauchy_a, int want_ext,
                      void* stream) {
  return launch<double>(p, lm, q, qic, tic, pbg, fid, cid, lid, xy, valid, PP, PL,
                        PE, EE, LE, LL, GP, GL, GE, cost, B, nf, nl, nc, nobs,
                        weight, cauchy_a, want_ext, stream);
}

}  // extern "C"
