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
// [n_blocks][tile*tile].  Any tile side >= 1, cut into bands by the plan
// the caller passes (render/raster_kernel.py::subtile_plan).
//
// What bounds it on this card.  Tested against every slot, a pixel costs
// ~35 instructions per slot (13 scalar shared-memory loads, 16 rounded
// multiplies and adds, compares and selects): the first kernel was bound
// by the instruction rate, 5x over its operation count.  But a tile of a
// real frame holds few triangles that can touch it: most slots are empty
// (C0 = -1e30, at the end of the list as the binning emits it) and most of
// the others, binned by the bounding box over a 2x2-tile region, miss this
// tile.  Once those are skipped the loop is short: at tile sides up to 16
// the least the kernel must do is read coefficients from device memory
// (the first edge of every slot, all 13 rows of the chunks of 32 slots
// that reach a band); at larger sides a tile has more pixels per slot and
// the instructions of the slots that do touch it (~144 a slot for a warp's
// 256 pixels) and of staging them are the larger cost.
//
// What the design does about it.
//  * A band per warp, four warps per block, no block barrier.  A band is a
//    rectangle of at most 32 patches of 4x2 pixels, one patch per lane; the
//    plan cuts a tile into the fewest bands, then the least perimeter (the
//    slots that touch a band grow with its perimeter).  Sides 4, 8, 12 and
//    16 are one band that fills the tile exactly (the patch path).  A larger
//    side is several bands (tile 32: four of 16x16), so a warp never sweeps
//    its tile in passes and the grid has a warp for every 256 pixels or
//    fewer; the bands of one tile sit in one block and read the same
//    coefficients, the later ones from L1 or L2.  A smaller side that is no
//    multiple of 4 (1, 2, 3, 6, 10) is one band with idle lanes and masked
//    pixels: such sides are bound by reading the coefficients, which costs
//    the same however the lanes are filled, so two tiles are not packed into
//    one warp.
//  * One kernel for every side, held to 80 registers a thread (six blocks,
//    24 warps an SM).  A one-band side runs the banded code with one band;
//    a second instantiation for those sides, without the band arithmetic
//    and left at its own 87 registers, was 3-11% slower at sides 8 and 16
//    on an H100, so there is none.
//  * Chunks the band cannot use are never loaded.  A warp first reads only
//    the first edge (A0, B0, C0) of its tile's slots, 32 at a time, and
//    keeps a bit for each chunk of 32 in which some slot's first edge
//    reaches the band (the cull below would drop every slot of the other
//    chunks: this is its first term, computed the same way).  Empty slots
//    fail it, so a real tile loads all 13 rows of only its first chunks.
//  * A warp walks the kept chunks: lane j reads the 13 coefficients of slot
//    32*c + j (each plane row a coalesced 128-byte read, the 13 row
//    addresses one pointer stepped by K), and the next kept chunk's loads
//    start before this chunk is rasterized.  No shared-memory staging of
//    the whole list, no copy engine: a chunk is 1.7 KB and is consumed by
//    the warp that loaded it.
//  * Cull while staging, on the band's own corners, order kept.  A slot is
//    dropped when one of its edge functions is negative at all four corner
//    pixel centres of the band (clipped to the tile, so no pixel past the
//    tile's edge widens it): the rounded a*px, b*py and sums are monotone
//    in px and in py, so that edge is negative at every pixel of the band
//    and the slot can win none of them.  The twelve corner values are
//    combined with bitwise and/or (no branches).  The survivors are
//    compacted by ballot and prefix count into the warp's shared-memory
//    chunk in slot order; ties go to the lower slot as before (izv > iz is
//    strict), so every pixel is bit for bit what the loop over all K slots
//    gives.
//  * Slot-major coefficients read as float4: one slot is 13 values padded
//    to 16, four LDS.128 broadcasts instead of 13 LDS.32.
//  * A patch of 4x2 pixels per lane: the coefficients are loaded once per
//    patch, and the rounded products a*px (one per column) and b*py (one per
//    row) are shared across it: ~18 instructions per pixel and slot.
//    Pixels of a patch past the tile's edge are computed with the others
//    (the lanes run in step) and never stored.  Stores are a row of the
//    patch at a time: float4 where the side is a multiple of 4 (the row is
//    16-byte aligned and whole), float2 pairs where it is even (tile 10: a
//    row is 40 bytes), single floats otherwise.
//
// Numerics: each affine form is (a*px + b*py) + c with explicitly rounded
// multiplies and adds (__fmul_rn/__fadd_rn are never contracted; the
// library is also built with --fmad=false), in the same order as the
// PyTorch twin raster_tiles_reference, so the two agree bit for bit.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kCoeffs = 13;
constexpr int kSlotWords = 16;     // one compacted slot in shared memory
constexpr int kWarpsPerBlock = 4;  // bands per block
constexpr unsigned kFull = 0xffffffffu;

// The pixel-centre rectangle [x_lo, x_hi] x [y_lo, y_hi] a band covers.
struct Rect {
  float x_lo, x_hi, y_lo, y_hi;
};

// True when a*px + b*py + c < 0 at all four corners of r.
__device__ __forceinline__ bool edge_misses(float a, float b, float c,
                                            const Rect& r) {
  const float a_lo = __fmul_rn(a, r.x_lo), a_hi = __fmul_rn(a, r.x_hi);
  const float b_lo = __fmul_rn(b, r.y_lo), b_hi = __fmul_rn(b, r.y_hi);
  return (__fadd_rn(__fadd_rn(a_lo, b_lo), c) < 0.0f) &
         (__fadd_rn(__fadd_rn(a_hi, b_lo), c) < 0.0f) &
         (__fadd_rn(__fadd_rn(a_lo, b_hi), c) < 0.0f) &
         (__fadd_rn(__fadd_rn(a_hi, b_hi), c) < 0.0f);
}

// Start loading the 13 coefficients of slot k (0 past K) into v.
__device__ __forceinline__ void load_slot(const float* __restrict__ src,
                                          int K, int k,
                                          float (&v)[kCoeffs]) {
  const bool in = k < K;
  const float* p = src + k;
#pragma unroll
  for (int q = 0; q < kCoeffs; ++q, p += K) v[q] = in ? *p : 0.0f;
}

// Stage the 32 slots k0..k0+31 of a tile (held in `cur`, loaded one chunk
// earlier), start loading slot k_next into `nxt` (the lane's slot of the
// next chunk; K or more: none), and compact the slots that can touch the
// band `r`, in slot order, into the warp's shared chunk.  Returns how many
// were kept.  Ends with __syncwarp(): the chunk is ready.
__device__ __forceinline__ int stage_chunk(const float* __restrict__ src,
                                           int K, int k0, int k_next,
                                           int lane, float (&cur)[kCoeffs],
                                           float (&nxt)[kCoeffs],
                                           float* slots, const Rect& r) {
#pragma unroll
  for (int q = 0; q < kCoeffs; ++q) cur[q] = nxt[q];
  load_slot(src, K, k_next, nxt);
  const bool keep = (k0 + lane < K) &
                    !(edge_misses(cur[0], cur[1], cur[2], r) |
                      edge_misses(cur[3], cur[4], cur[5], r) |
                      edge_misses(cur[6], cur[7], cur[8], r));
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

#ifdef RASTER_PROFILE
// Built with -DRASTER_PROFILE (chip_smoke.py --raster-phases), lane 0 of
// warp w writes one record to g_profile[w] after its slot loop: its SM and
// the SM's clock (low 32 bits) at its start and at its end.
// raster_profile_read copies the records of the last launch out.
struct WarpRecord {
  unsigned sm, start, end;
};
constexpr int kProfileWarps = 1 << 17;
__device__ WarpRecord g_profile[kProfileWarps];
#endif

// Test the n compacted slots of the warp's chunk against the lane's 4x2
// patch at columns px[0..3], rows py[0..1], into iz/col.
__device__ __forceinline__ void raster_chunk(const float* slots, int n,
                                             const float (&px)[4],
                                             const float (&py)[2],
                                             float (&iz)[2][4],
                                             float (&col)[2][4]) {
  for (int s = 0; s < n; ++s) {
    const float4* q = reinterpret_cast<const float4*>(slots + s * kSlotWords);
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
        // (e0 >= 0 && e1 >= 0 && e2 >= 0) == (min(e0, e1, e2) >= 0) of the
        // twin, NaN included
        if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && izv > iz[r][i]) {
          iz[r][i] = izv;
          col[r][i] = cs;
        }
      }
    }
  }
}

// Warp w rasterizes band w % bands of tile w / bands.  A band is band_w x
// band_h pixels (band_w / 4 patches across, band_h / 2 down); the bands
// of a tile are laid out row-major, ceil(tile / band_w) across.  Held to
// 80 registers (six blocks, 24 warps an SM).
__global__ void __launch_bounds__(32 * kWarpsPerBlock, 6)
raster_tiles_kernel(const float* __restrict__ coeffs,
                    float* __restrict__ izbuf, float* __restrict__ cbuf,
                    int n_tiles, int K, int tile, int band_w, int band_h,
                    int bands, float sky) {
  __shared__ __align__(16) float chunk[kWarpsPerBlock][32 * kSlotWords];
#ifdef RASTER_PROFILE
  const unsigned clock_start = static_cast<unsigned>(clock64());
#endif
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * kWarpsPerBlock + warp;
  const int t = w / bands;
  if (t >= n_tiles) return;  // whole warps leave; there is no block barrier
  const float* src = coeffs + static_cast<long long>(t) * kCoeffs * K;
  float* slots = chunk[warp];

  // the band's first pixel and its pixel-centre rectangle, clipped to the
  // tile
  const int band = w - t * bands;
  const int bands_x = (tile + band_w - 1) / band_w;
  const int bx = (band % bands_x) * band_w;
  const int by = (band / bands_x) * band_h;
  const Rect rect = {static_cast<float>(bx) + 0.5f,
                     static_cast<float>(min(bx + band_w, tile)) - 0.5f,
                     static_cast<float>(by) + 0.5f,
                     static_cast<float>(min(by + band_h, tile)) - 0.5f};
  const int patches_x = band_w >> 2;
  // this lane's patch: columns x0..x0+3 of rows y0, y0+1
  const int x0 = bx + (lane % patches_x) * 4;
  const int y0 = by + (lane / patches_x) * 2;
  const bool has_patch =
      lane < patches_x * (band_h >> 1) && x0 < tile && y0 < tile;
  float px[4], py[2];
  for (int i = 0; i < 4; ++i) px[i] = static_cast<float>(x0 + i) + 0.5f;
  for (int i = 0; i < 2; ++i) py[i] = static_cast<float>(y0 + i) + 0.5f;

  float iz[2][4], col[2][4];
  for (int r = 0; r < 2; ++r)
    for (int i = 0; i < 4; ++i) {
      iz[r][i] = 0.0f;
      col[r][i] = sky;
    }

  float cur[kCoeffs], nxt[kCoeffs];
  for (int g = 0; g < K; g += 32 * 32) {  // groups of up to 32 chunks
    // bit c: chunk g/32 + c has a slot whose first edge reaches the band
    // (the other chunks' slots would all be culled: skip their loads)
    const int group_chunks = min(32, (K - g + 31) / 32);
    unsigned live = 0;
#pragma unroll 4
    for (int c = 0; c < group_chunks; ++c) {
      const int k = g + 32 * c + lane;
      const bool reach =
          k < K && !edge_misses(src[k], src[K + k], src[2 * K + k], rect);
      if (__any_sync(kFull, reach)) live |= 1u << c;
    }
    int c = __ffs(live) - 1;
    if (live) load_slot(src, K, g + 32 * c + lane, nxt);
    while (live) {
      live &= live - 1u;
      const int c_next = __ffs(live) - 1;
      const int n = stage_chunk(src, K, g + 32 * c,
                                live ? g + 32 * c_next + lane : K, lane, cur,
                                nxt, slots, rect);
      c = c_next;
      if (has_patch) raster_chunk(slots, n, px, py, iz, col);
      __syncwarp();  // the chunk is free for the next 32 slots
    }
  }
#ifdef RASTER_PROFILE
  if (lane == 0 && w < kProfileWarps) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_profile[w] = {sm, clock_start, static_cast<unsigned>(clock64())};
  }
#endif
  if (!has_patch) return;
  const long long base = static_cast<long long>(t) * tile * tile;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (y0 + r >= tile) break;  // odd sides: the second row
    const long long at = base + (y0 + r) * tile + x0;
    if ((tile & 3) == 0) {  // whole patch rows, 16-byte aligned
      *reinterpret_cast<float4*>(izbuf + at) =
          make_float4(iz[r][0], iz[r][1], iz[r][2], iz[r][3]);
      *reinterpret_cast<float4*>(cbuf + at) =
          make_float4(col[r][0], col[r][1], col[r][2], col[r][3]);
    } else if ((tile & 1) == 0) {  // pairs, 8-byte aligned, whole or past
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        if (x0 + i < tile) {
          *reinterpret_cast<float2*>(izbuf + at + i) =
              make_float2(iz[r][i], iz[r][i + 1]);
          *reinterpret_cast<float2*>(cbuf + at + i) =
              make_float2(col[r][i], col[r][i + 1]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (x0 + i < tile) {
          izbuf[at + i] = iz[r][i];
          cbuf[at + i] = col[r][i];
        }
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a plan that does not cut `tile` into bands of
// at most 32 whole patches.
extern "C" int raster_tiles_f32(const float* coeffs, float* izbuf,
                                float* cbuf, int n_blocks, int K, int tile,
                                int band_w, int band_h, int bands, float sky,
                                void* stream) {
  const bool plan_ok =
      tile >= 1 && band_w >= 4 && band_h >= 2 && band_w % 4 == 0 &&
      band_h % 2 == 0 && (band_w / 4) * (band_h / 2) <= 32 &&
      bands == ((tile + band_w - 1) / band_w) * ((tile + band_h - 1) / band_h);
  if (!plan_ok || n_blocks < 0 ||
      static_cast<long long>(n_blocks) * bands >
          INT_MAX - kWarpsPerBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
  const int grid = (n_blocks * bands + kWarpsPerBlock - 1) / kWarpsPerBlock;
  raster_tiles_kernel<<<grid, 32 * kWarpsPerBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      coeffs, izbuf, cbuf, n_blocks, K, tile, band_w, band_h, bands, sky);
  return static_cast<int>(cudaGetLastError());
}

#ifdef RASTER_PROFILE
// Copy the records of the last launch's first n_warps warps to host memory
// (3 words a warp, after the launch has finished); returns the CUDA error.
extern "C" int raster_profile_read(unsigned* dst, int n_warps) {
  if (n_warps < 0 || n_warps > kProfileWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyFromSymbol(
      dst, g_profile, static_cast<size_t>(n_warps) * sizeof(WarpRecord)));
}
#endif

extern "C" const char* geeco_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
