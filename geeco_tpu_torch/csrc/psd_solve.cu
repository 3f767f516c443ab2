// Fused projected steepest-descent (PSD) contact solve for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel geeco_tpu/physics/solver_pallas.py
// ::_run_pallas (body _kernel, math _psd_loop :84-114).  Same computation:
// `iterations` steps of diagonally preconditioned projected steepest
// descent with the exact step size on the inequality rows of the contact
// dual, the weld rows already Schur-eliminated by the caller:
//
//   g = Aop f + b;  d = precond*g;  alpha = (g.d)/(d.Aop d) if d.Aop d > 1e-12
//   f <- project(f - alpha*d),  Aop v = J (X v) - A_IE (EEinv (A_IE^T v)) + R v
//
// project: elliptic cone over 4 groups of K contact rows (fn >= 0, the
// tangent pair clipped to the mu_t*fn disk, torsion clipped at mu_tor*fn,
// masked by con_act), limit rows >= 0 masked by lim_act, padding rows 0.
//
// Layout (env-major, contiguous float32): J [B][nI][nv], X [B][nv][nI],
// A_IE [B][nI][nE], EEinv [B][nE][nE], R/b/precond/f0/out [B][nI],
// mu_t/mu_tor/con_act [B][K], lim_act [B][2*nlim].  nE may be 0.
//
// Design (simple first): one block of 512 threads per env runs the whole
// loop; the B envs run in one launch.  Each iteration is a fixed sequence
// of block-wide phases separated by __syncthreads():
//   1. u = X v and w = A_IE^T v: one warp per output (nv + nE of them),
//      lanes stride over the nI rows (X rows are contiguous: coalesced),
//      then a warp-shuffle sum;
//   2. z = EEinv w: one thread per weld row;
//   3. y_i = J[i,:].u - A_IE[i,:].z + R_i v_i: one warp per row, lanes
//      over the nv columns (contiguous: coalesced), shuffle sums;
//   the operator runs on f (giving g, d) and then on d (giving the two dot
//   products, summed per warp, then across warps in a fixed order so every
//   thread computes the same alpha); 4. the projection, one thread per
//   contact owning its rows k, K+k, 2K+k, 3K+k, one per limit row.
// Where the operands live: the row vectors f, g, d, R, b, precond, the
// small A_IE and EEinv and u, w, z are staged in shared memory (~26 KB at
// nI=530, nE=6).  J and X (~165 KB per env at nI=530, nv=39) stay in device
// memory and are re-read 4 times per iteration: 64 envs hold ~10.6 MB of
// them, which the 50 MB L2 keeps resident across iterations.  Staging them
// in shared memory (they would fit at nI=530 but not on the clutter
// scenes), TMA, and several envs per block are later work.
// What bounds it: the work is ~4(nv+nE)nI FLOPs per operator application,
// two per iteration; ~195 KB of operands per env are read once.  The
// operation count binds (see chip_smoke.py), but this simple version is
// bound by latency: ~10 block barriers and ~2 dependent shuffle
// reductions per row per iteration, with one block on each of B SMs.
//
// Numerics: sums run in another order than the PyTorch twin
// psd_solve_reference (warp-strided partial sums, shuffle trees), so the
// two agree to a tolerance, not bit for bit.  The library is built with
// --fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same sum
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

struct Env {
  const float* J;      // [nI][nv]
  const float* X;      // [nv][nI]
  const float* aie;    // [nI][nE]   (shared)
  const float* ee;     // [nE][nE]   (shared)
  const float* R;      // [nI]       (shared)
  float* u;            // [nv]       (shared)
  float* w;            // [nE]       (shared)
  float* z;            // [nE]       (shared)
  int nI, nv, nE;
};

// Phases 1-2: u = X v, w = A_IE^T v, z = EEinv w (ends synchronised).
__device__ void op_columns(const Env& e, const float* v) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int c = warp; c < e.nv + e.nE; c += kWarps) {
    float s = 0.0f;
    if (c < e.nv) {
      const float* row = e.X + static_cast<long long>(c) * e.nI;
      for (int i = lane; i < e.nI; i += 32) s += row[i] * v[i];
    } else {
      const int k = c - e.nv;
      for (int i = lane; i < e.nI; i += 32) s += e.aie[i * e.nE + k] * v[i];
    }
    s = warp_sum(s);
    if (lane == 0) {
      if (c < e.nv) e.u[c] = s; else e.w[c - e.nv] = s;
    }
  }
  __syncthreads();
  if (e.nE > 0) {
    for (int r = threadIdx.x; r < e.nE; r += kThreads) {
      float s = 0.0f;
      for (int k = 0; k < e.nE; ++k) s += e.ee[r * e.nE + k] * e.w[k];
      e.z[r] = s;
    }
    __syncthreads();
  }
}

// Phase 3 for row i, by one warp: (Aop v)_i, the same value in every lane.
__device__ __forceinline__ float op_row(const Env& e, const float* v, int i) {
  const int lane = threadIdx.x & 31;
  const float* row = e.J + static_cast<long long>(i) * e.nv;
  float s = 0.0f;
  for (int k = lane; k < e.nv; k += 32) s += row[k] * e.u[k];
  s = warp_sum(s);
  if (e.nE > 0) {
    float t = 0.0f;
    for (int k = lane; k < e.nE; k += 32) t += e.aie[i * e.nE + k] * e.z[k];
    s = s - warp_sum(t);
  }
  return s + e.R[i] * v[i];
}

// f[:] <- project(f - alpha*d) (d == nullptr: project f in place).
__device__ void project(float* f, const float* d, float alpha,
                        const float* mu_t, const float* mu_tor,
                        const float* con_act, const float* lim_act, int nI,
                        int K, int nlim) {
  for (int k = threadIdx.x; k < K; k += kThreads) {
    float v[4];
    for (int q = 0; q < 4; ++q) {
      const int r = q * K + k;
      v[q] = d ? f[r] - alpha * d[r] : f[r];
    }
    const float ca = con_act[k];
    const float fn = fmaxf(v[0], 0.0f) * ca;
    const float t_norm = sqrtf(v[1] * v[1] + v[2] * v[2] + 1e-18f);
    const float scale = fminf(mu_t[k] * fn / t_norm, 1.0f);
    const float lim = mu_tor[k] * fn;
    f[k] = fn;
    f[K + k] = v[1] * scale * ca;
    f[2 * K + k] = v[2] * scale * ca;
    f[3 * K + k] = fminf(fmaxf(v[3], -lim), lim) * ca;
  }
  for (int j = threadIdx.x; j < 2 * nlim; j += kThreads) {
    const int r = 4 * K + j;
    const float v = d ? f[r] - alpha * d[r] : f[r];
    f[r] = fmaxf(v, 0.0f) * lim_act[j];
  }
  for (int r = 4 * K + 2 * nlim + threadIdx.x; r < nI; r += kThreads)
    f[r] = 0.0f;
}

__global__ void __launch_bounds__(kThreads)
psd_solve_kernel(const float* __restrict__ J, const float* __restrict__ X,
                 const float* __restrict__ A_IE,
                 const float* __restrict__ EEinv,
                 const float* __restrict__ R, const float* __restrict__ b,
                 const float* __restrict__ precond,
                 const float* __restrict__ f0,
                 const float* __restrict__ mu_t,
                 const float* __restrict__ mu_tor,
                 const float* __restrict__ con_act,
                 const float* __restrict__ lim_act, float* __restrict__ out,
                 int nI, int nv, int nE, int K, int nlim, int iterations) {
  extern __shared__ float smem[];
  const long long env = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float* f = smem;
  float* g = f + nI;
  float* d = g + nI;
  float* Rs = d + nI;
  float* bs = Rs + nI;
  float* pre = bs + nI;
  float* aie = pre + nI;            // [nI][nE]
  float* ee = aie + nI * nE;        // [nE][nE]
  float* u = ee + nE * nE;          // [nv]
  float* w = u + nv;                // [nE]
  float* z = w + nE;                // [nE]
  float* red = z + nE;              // [2][kWarps]

  const long long vo = env * nI;
  for (int i = threadIdx.x; i < nI; i += kThreads) {
    f[i] = f0[vo + i];
    Rs[i] = R[vo + i];
    bs[i] = b[vo + i];
    pre[i] = precond[vo + i];
  }
  for (int i = threadIdx.x; i < nI * nE; i += kThreads)
    aie[i] = A_IE[env * nI * nE + i];
  for (int i = threadIdx.x; i < nE * nE; i += kThreads)
    ee[i] = EEinv[env * nE * nE + i];
  const float* mt = mu_t + env * K;
  const float* mr = mu_tor + env * K;
  const float* ca = con_act + env * K;
  const float* la = lim_act + env * 2 * nlim;
  __syncthreads();
  project(f, nullptr, 0.0f, mt, mr, ca, la, nI, K, nlim);
  __syncthreads();

  const Env e{J + env * nI * nv, X + env * nv * nI, aie, ee, Rs, u, w, z,
              nI, nv, nE};
  for (int it = 0; it < iterations; ++it) {
    // g = Aop f + b, d = precond * g
    op_columns(e, f);
    for (int i = warp; i < nI; i += kWarps) {
      const float y = op_row(e, f, i);
      if (lane == 0) {
        const float gi = y + bs[i];
        g[i] = gi;
        d[i] = pre[i] * gi;
      }
    }
    __syncthreads();
    // Ad = Aop d, with the partial sums of g.d and d.Ad per warp
    op_columns(e, d);
    float num = 0.0f, den = 0.0f;
    for (int i = warp; i < nI; i += kWarps) {
      const float ad = op_row(e, d, i);
      num += g[i] * d[i];
      den += d[i] * ad;
    }
    if (lane == 0) {
      red[warp] = num;
      red[kWarps + warp] = den;
    }
    __syncthreads();
    num = 0.0f;
    den = 0.0f;
    for (int k = 0; k < kWarps; ++k) {
      num += red[k];
      den += red[kWarps + k];
    }
    const float alpha = den > 1e-12f ? num / fmaxf(den, 1e-12f) : 0.0f;
    project(f, d, alpha, mt, mr, ca, la, nI, K, nlim);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nI; i += kThreads) out[vo + i] = f[i];
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int psd_solve_f32(const float* J, const float* X,
                             const float* A_IE, const float* EEinv,
                             const float* R, const float* b,
                             const float* precond, const float* f0,
                             const float* mu_t, const float* mu_tor,
                             const float* con_act, const float* lim_act,
                             float* out, int B, int nI, int nv, int nE, int K,
                             int nlim, int iterations, void* stream) {
  if (B == 0 || nI == 0) return 0;
  const size_t smem = sizeof(float) *
      (6 * static_cast<size_t>(nI) + static_cast<size_t>(nI) * nE +
       static_cast<size_t>(nE) * nE + nv + 2 * nE + 2 * kWarps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        psd_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  psd_solve_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      J, X, A_IE, EEinv, R, b, precond, f0, mu_t, mu_tor, con_act, lim_act,
      out, nI, nv, nE, K, nlim, iterations);
  return static_cast<int>(cudaGetLastError());
}
