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
// Layout: coeffs [n_blocks = B*n_tiles][13][K] float32, tile-major, rows
// A0,B0,C0, A1,B1,C1, A2,B2,C2, Az,Bz,Cz, colour.  Outputs izbuf, cbuf
// [n_blocks][tile*tile].  Any tile side >= 1: sides of 4, 8, 12 and 16
// take the patch kernel, every other side the general kernel (below).
//
// What bounds it on this card.  Tested against every slot, a pixel costs
// ~35 instructions per slot (13 scalar shared-memory loads, 16 rounded
// multiplies and adds, compares and selects): the earlier kernel was bound
// by the instruction rate, 5x over its operation count.  But a tile of a
// real frame holds few triangles that can touch it: most slots are empty
// (C0 = -1e30) and most of the others, binned by the bounding box over a
// 2x2-tile region, miss this tile.  Once those are skipped the loop is
// short, and the kernel is bound by reading the 13*K coefficients of every
// tile once from device memory.
//
// What the design does about it.
//  * One warp per tile, four tiles per block, no block barrier.  A warp
//    walks its tile's slots 32 at a time: lane j reads the 13 coefficients
//    of slot 32*c + j (each plane row a coalesced 128-byte read), and the
//    next chunk's loads start before this chunk is rasterized, so a
//    tile's loop overlaps its own next load and, with some 24 warps
//    resident on an SM, other tiles' loads.  No shared-memory staging of
//    the whole list, no copy engine: a chunk is 1.7 KB and is consumed by
//    the warp that loaded it.
//  * Cull while staging, order kept.  A slot is dropped when one of its
//    edge functions is negative at all four corner pixels of the tile: the
//    rounded a*px, b*py and sums are monotone in px and in py, so that edge
//    is negative at every pixel and the slot can win none.  Empty slots go
//    the same way.  The survivors are compacted by ballot and prefix count
//    into the warp's shared-memory chunk in slot order; ties go to the lower
//    slot as before (izv > iz is strict), so every pixel is bit for bit
//    what the loop over all K slots gives.
//  * Slot-major coefficients read as float4: one slot is 13 values padded
//    to 16, four LDS.128 broadcasts instead of 13 LDS.32.
//  * A patch of 4x2 pixels per lane: the coefficients are loaded once per
//    patch, and the rounded products a*px (one per column) and b*py (one per
//    row) are shared across it: ~18 instructions per pixel and slot.
//    Stores are float4, a row of the patch each.
//  * Every other tile side (10, 20, 32, ...) takes the general kernel: the
//    same warp per tile, the same staging and cull, but each lane holds
//    kGeneralPx pixels strided by 32 (pixel p = pass*256 + j*32 + lane,
//    masked past tile*tile), one coefficient load per slot shared by them,
//    and the tile is swept in passes of 32*kGeneralPx pixels, each pass
//    reading the slot list again (from L2 after the first).  It is the
//    simple form: no shared a*px products, scalar stores (coalesced across
//    the lanes).
//
// Numerics: each affine form is (a*px + b*py) + c with explicitly rounded
// multiplies and adds (__fmul_rn/__fadd_rn are never contracted; the
// library is also built with --fmad=false), in the same order as the
// PyTorch twin raster_tiles_reference, so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kCoeffs = 13;
constexpr int kSlotWords = 16;     // one compacted slot in shared memory
constexpr int kWarpsPerBlock = 4;  // tiles per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float affine(float a, float b, float c, float px,
                                        float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

// True when a*px + b*py + c < 0 at all four corner pixel centres (lo, hi).
__device__ __forceinline__ bool edge_misses(float a, float b, float c,
                                            float lo, float hi) {
  return affine(a, b, c, lo, lo) < 0.0f && affine(a, b, c, hi, lo) < 0.0f &&
         affine(a, b, c, lo, hi) < 0.0f && affine(a, b, c, hi, hi) < 0.0f;
}

// Stage the 32 slots k0..k0+31 of a tile (held in `cur`, loaded one chunk
// earlier), start loading the next 32 into `nxt`, and compact the slots
// that can touch the tile, in slot order, into the warp's shared chunk.
// Returns how many were kept.  Ends with __syncwarp(): the chunk is ready.
__device__ __forceinline__ int stage_chunk(const float* __restrict__ src,
                                           int K, int k0, int lane,
                                           float (&cur)[kCoeffs],
                                           float (&nxt)[kCoeffs],
                                           float* slots, float lo, float hi) {
#pragma unroll
  for (int q = 0; q < kCoeffs; ++q) cur[q] = nxt[q];
  const bool in = k0 + lane < K;
  {
    const int k = k0 + 32 + lane;
    const bool more = k < K;
#pragma unroll
    for (int q = 0; q < kCoeffs; ++q) nxt[q] = more ? src[q * K + k] : 0.0f;
  }
  const bool keep = in && !(edge_misses(cur[0], cur[1], cur[2], lo, hi) ||
                            edge_misses(cur[3], cur[4], cur[5], lo, hi) ||
                            edge_misses(cur[6], cur[7], cur[8], lo, hi));
  const unsigned kept = __ballot_sync(kFull, keep);
  if (keep) {
    float4* dst = reinterpret_cast<float4*>(
        slots + __popc(kept & ((1u << lane) - 1u)) * kSlotWords);
    dst[0] = make_float4(cur[0], cur[1], cur[2], cur[3]);
    dst[1] = make_float4(cur[4], cur[5], cur[6], cur[7]);
    dst[2] = make_float4(cur[8], cur[9], cur[10], cur[11]);
    dst[3] = make_float4(cur[12], 0.0f, 0.0f, 0.0f);
  }
  __syncwarp();
  return __popc(kept);
}

// The first chunk's loads, before the slot loop.
__device__ __forceinline__ void load_first(const float* __restrict__ src,
                                           int K, int lane,
                                           float (&nxt)[kCoeffs]) {
  const bool in = lane < K;
#pragma unroll
  for (int q = 0; q < kCoeffs; ++q) nxt[q] = in ? src[q * K + lane] : 0.0f;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
raster_tiles_kernel(const float* __restrict__ coeffs,
                    float* __restrict__ izbuf, float* __restrict__ cbuf,
                    int n_tiles, int K, int tile, float sky) {
  __shared__ __align__(16) float chunk[kWarpsPerBlock][32 * kSlotWords];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long t = static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
                      warp;
  if (t >= n_tiles) return;  // whole warps leave; there is no block barrier
  const float* src = coeffs + t * kCoeffs * K;
  float* slots = chunk[warp];

  // this lane's patch: columns x0..x0+3 of rows y0, y0+1
  const int patches_x = tile >> 2;
  const int x0 = (lane % patches_x) * 4;
  const int y0 = (lane / patches_x) * 2;
  const bool has_patch = y0 < tile;
  float px[4], py[2];
  for (int i = 0; i < 4; ++i) px[i] = static_cast<float>(x0 + i) + 0.5f;
  for (int i = 0; i < 2; ++i) py[i] = static_cast<float>(y0 + i) + 0.5f;
  const float lo = 0.5f;
  const float hi = static_cast<float>(tile) - 0.5f;

  float iz[2][4], col[2][4];
  for (int r = 0; r < 2; ++r)
    for (int i = 0; i < 4; ++i) {
      iz[r][i] = 0.0f;
      col[r][i] = sky;
    }

  float cur[kCoeffs], nxt[kCoeffs];
  load_first(src, K, lane, nxt);
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int n = stage_chunk(src, K, k0, lane, cur, nxt, slots, lo, hi);
    if (has_patch) {
      for (int s = 0; s < n; ++s) {
        const float4* q = reinterpret_cast<const float4*>(
            slots + s * kSlotWords);
        const float4 q0 = q[0], q1 = q[1], q2 = q[2];
        const float cs = q[3].x;
        // a*px per column and b*py per row, each rounded once
        float ax0[4], ax1[4], ax2[4], axz[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ax0[i] = __fmul_rn(q0.x, px[i]);
          ax1[i] = __fmul_rn(q0.w, px[i]);
          ax2[i] = __fmul_rn(q1.z, px[i]);
          axz[i] = __fmul_rn(q2.y, px[i]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float by0 = __fmul_rn(q0.y, py[r]);
          const float by1 = __fmul_rn(q1.x, py[r]);
          const float by2 = __fmul_rn(q1.w, py[r]);
          const float byz = __fmul_rn(q2.z, py[r]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float e0 = __fadd_rn(__fadd_rn(ax0[i], by0), q0.z);
            const float e1 = __fadd_rn(__fadd_rn(ax1[i], by1), q1.y);
            const float e2 = __fadd_rn(__fadd_rn(ax2[i], by2), q2.x);
            const float izv = __fadd_rn(__fadd_rn(axz[i], byz), q2.w);
            // (e0 >= 0 && e1 >= 0 && e2 >= 0) == (min(e0, e1, e2) >= 0) of
            // the twin, NaN included
            if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && izv > iz[r][i]) {
              iz[r][i] = izv;
              col[r][i] = cs;
            }
          }
        }
      }
    }
    __syncwarp();  // the chunk is free for the next 32 slots
  }
  if (has_patch) {
    const long long base = t * tile * tile;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long at = base + (y0 + r) * tile + x0;
      *reinterpret_cast<float4*>(izbuf + at) =
          make_float4(iz[r][0], iz[r][1], iz[r][2], iz[r][3]);
      *reinterpret_cast<float4*>(cbuf + at) =
          make_float4(col[r][0], col[r][1], col[r][2], col[r][3]);
    }
  }
}

constexpr int kGeneralPx = 8;   // pixels per lane and pass, general kernel

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
raster_tiles_general_kernel(const float* __restrict__ coeffs,
                            float* __restrict__ izbuf,
                            float* __restrict__ cbuf, int n_tiles, int K,
                            int tile, float sky) {
  __shared__ __align__(16) float chunk[kWarpsPerBlock][32 * kSlotWords];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long t = static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
                      warp;
  if (t >= n_tiles) return;  // whole warps leave; there is no block barrier
  const float* src = coeffs + t * kCoeffs * K;
  float* slots = chunk[warp];
  const int npx = tile * tile;
  const float lo = 0.5f;
  const float hi = static_cast<float>(tile) - 0.5f;
  const long long base = t * npx;

  for (int p0 = 0; p0 < npx; p0 += 32 * kGeneralPx) {
    float px[kGeneralPx], py[kGeneralPx], iz[kGeneralPx], col[kGeneralPx];
#pragma unroll
    for (int j = 0; j < kGeneralPx; ++j) {
      const int p = p0 + j * 32 + lane;
      px[j] = static_cast<float>(p % tile) + 0.5f;
      py[j] = static_cast<float>(p / tile) + 0.5f;
      iz[j] = 0.0f;
      col[j] = sky;
    }
    float cur[kCoeffs], nxt[kCoeffs];
    load_first(src, K, lane, nxt);
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int n = stage_chunk(src, K, k0, lane, cur, nxt, slots, lo, hi);
      for (int s = 0; s < n; ++s) {
        const float4* q = reinterpret_cast<const float4*>(
            slots + s * kSlotWords);
        const float4 q0 = q[0], q1 = q[1], q2 = q[2];
        const float cs = q[3].x;
#pragma unroll
        for (int j = 0; j < kGeneralPx; ++j) {
          const float e0 = affine(q0.x, q0.y, q0.z, px[j], py[j]);
          const float e1 = affine(q0.w, q1.x, q1.y, px[j], py[j]);
          const float e2 = affine(q1.z, q1.w, q2.x, px[j], py[j]);
          const float izv = affine(q2.y, q2.z, q2.w, px[j], py[j]);
          if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && izv > iz[j]) {
            iz[j] = izv;
            col[j] = cs;
          }
        }
      }
      __syncwarp();  // the chunk is free for the next 32 slots
    }
#pragma unroll
    for (int j = 0; j < kGeneralPx; ++j) {
      const int p = p0 + j * 32 + lane;
      if (p < npx) {
        izbuf[base + p] = iz[j];
        cbuf[base + p] = col[j];
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int raster_tiles_f32(const float* coeffs, float* izbuf,
                                float* cbuf, int n_blocks, int K, int tile,
                                float sky, void* stream) {
  if (tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
  const int grid = (n_blocks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile % 4 == 0 && tile <= 16)
    raster_tiles_kernel<<<grid, 32 * kWarpsPerBlock, 0, st>>>(
        coeffs, izbuf, cbuf, n_blocks, K, tile, sky);
  else
    raster_tiles_general_kernel<<<grid, 32 * kWarpsPerBlock, 0, st>>>(
        coeffs, izbuf, cbuf, n_blocks, K, tile, sky);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* geeco_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
