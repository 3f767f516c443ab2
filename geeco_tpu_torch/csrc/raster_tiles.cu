// Per-tile z-buffered triangle rasterizer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel geeco_tpu/render/rasterizer.py
// ::_raster_pallas_call (body :809-834).  Same computation: for each fine
// tile, a z-buffer over its K binned triangle slots in inverse-depth space.
// Slot k covers pixel (px, py) when its three affine edge functions
// A*px + B*py + C are all >= 0, and wins it when its interpolated inverse
// depth is larger than the buffer's.  Colour is the packed r*65536+g*256+b
// float (exact below 2^24), starting as sky; inverse depth starts at 0.
//
// Layout: coeffs [n_blocks = B*n_tiles][13][K] float32, tile-major, so one
// block reads its tile's whole slot list from contiguous memory (coalesced).
// Outputs izbuf, cbuf [n_blocks][tile*tile].
//
// Design (simple first): one block per (env, fine tile), one thread per
// pixel (256 at tile=16).  The tile's 13*K coefficients (~10 KB at K=192)
// are staged once in shared memory; every thread then loops over the K
// slots reading them as broadcasts, holding izbuf/cbuf in registers, and
// stores once at the end (consecutive threads, consecutive addresses).
// What bounds it: 4 affine forms (12 FLOPs) + compares per slot per pixel,
// i.e. ~16*K ALU ops per pixel against 13*K*4 bytes read per tile — it is
// bound by the ALU issue rate of the loop, not by memory.  Making it fast
// (several tiles per block, TMA staging, fused binning) is later work.
//
// Numerics: each affine form is evaluated as (a*px + b*py) + c with
// explicitly rounded multiplies and adds (no FMA contraction; the library
// is also built with --fmad=false), in the same order as the PyTorch twin
// raster_tiles_reference, so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kCoeffs = 13;

__device__ __forceinline__ float affine(float a, float b, float c, float px,
                                        float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

__global__ void raster_tiles_kernel(const float* __restrict__ coeffs,
                                    float* __restrict__ izbuf,
                                    float* __restrict__ cbuf, int K,
                                    int tile, float sky) {
  extern __shared__ float s[];  // [13][K]
  const long long blk = blockIdx.x;
  const float* src = coeffs + blk * kCoeffs * K;
  for (int i = threadIdx.x; i < kCoeffs * K; i += blockDim.x) s[i] = src[i];
  __syncthreads();

  const int npx = tile * tile;
  const int p = threadIdx.x;
  if (p >= npx) return;
  const float px = static_cast<float>(p % tile) + 0.5f;
  const float py = static_cast<float>(p / tile) + 0.5f;
  const float* a0 = s;
  const float* b0 = s + 1 * K;
  const float* c0 = s + 2 * K;
  const float* a1 = s + 3 * K;
  const float* b1 = s + 4 * K;
  const float* c1 = s + 5 * K;
  const float* a2 = s + 6 * K;
  const float* b2 = s + 7 * K;
  const float* c2 = s + 8 * K;
  const float* az = s + 9 * K;
  const float* bz = s + 10 * K;
  const float* cz = s + 11 * K;
  const float* col = s + 12 * K;

  float iz = 0.0f;
  float c = sky;
  for (int k = 0; k < K; ++k) {
    const float e0 = affine(a0[k], b0[k], c0[k], px, py);
    const float e1 = affine(a1[k], b1[k], c1[k], px, py);
    const float e2 = affine(a2[k], b2[k], c2[k], px, py);
    const float izv = affine(az[k], bz[k], cz[k], px, py);
    // (e0 >= 0 && e1 >= 0 && e2 >= 0) == (min(e0, e1, e2) >= 0), NaN included
    if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && izv > iz) {
      iz = izv;
      c = col[k];
    }
  }
  izbuf[blk * npx + p] = iz;
  cbuf[blk * npx + p] = c;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int raster_tiles_f32(const float* coeffs, float* izbuf,
                                float* cbuf, int n_blocks, int K, int tile,
                                float sky, void* stream) {
  if (n_blocks == 0) return 0;
  const size_t smem = static_cast<size_t>(kCoeffs) * K * sizeof(float);
  raster_tiles_kernel<<<n_blocks, tile * tile, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      coeffs, izbuf, cbuf, K, tile, sky);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* geeco_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
