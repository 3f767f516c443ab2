// Fused projected steepest-descent (PSD) contact solve for Hopper (sm_90a).
//
// Runs the whole projected iteration of the contact dual in one launch, on
// the inequality rows, the weld rows already Schur-eliminated by the caller:
//
//   g = Aop f + b;  d = precond*g;  alpha = (g.d)/(d.Aop d) if d.Aop d > 1e-12
//   f <- project(f - alpha*d)
//
// in one of two forms, a constant of the build (PSD_FORM):
//  * 0, the TPU kernel's (geeco_tpu/physics/solver_pallas.py::_run_pallas,
//    body _kernel, math _psd_loop :84-114), which solver.solve's 'pallas'
//    method runs at 4 contact row groups (namespace psd):
//    Aop v = J (X v) - A_IE (EEinv (A_IE^T v)) + R v, f0 projected first;
//  * 1, solver.solve's own 'psd' iteration (solver._iterate, _apply and
//    _project), which solver._solve_rows runs on the card, its forces the
//    eager loop's bit for bit (namespace psdx, at the end of the file):
//    Aop v = (J u + R v) - A_IE (EEinv (J_E u)), u = X v, with 4 or 6 row
//    groups (PSD_NGRP: the rolling rows), every sum in the order of the
//    library routine the eager loop calls.
//
// Form 0 follows.  project: elliptic cone over 4 groups of K contact rows
// (fn >= 0, the tangent pair clipped to the mu_t*fn disk, torsion clipped
// at mu_tor*fn, masked by con_act), limit rows >= 0 masked by lim_act,
// padding rows 0.
//
// Layout (env-major, contiguous float32): J [B][nI][nv], X [B][nv][nI],
// A_IE [B][nI][nE], EEinv [B][nE][nE], R/b/precond/f0/out [B][nI],
// mu_t/mu_tor/con_act [B][K], lim_act [B][2*nlim].  nE may be 0.  (Form 1
// adds mu_roll [B][K] and J_E [B][nE][nv], and reads J transposed.)
//
// What bounds it on this card.  The work is small (~4(nv+nE)nI FLOPs per
// operator application, two per iteration) but it is a chain: 2*iterations
// dependent operator applications per env, each a matrix-vector product
// whose result every row needs before it can go on.  Device memory and the
// card's arithmetic rate never bind.  What binds is, per SM, the
// instructions a warp must run between two barriers (a few warps per
// scheduler, each instruction waiting on the one before) and, for u = X v,
// the shared-memory bandwidth: X is read once per operator application.
//
// What the design does about it.
//  * Built for one shape.  The library is compiled per (nI, nv, nE, K, nlim)
//    and launch plan, passed as -DPSD_* constants (utils/build.py::load_psd):
//    loop bounds and offsets are immediates, loops unroll, nothing spills.
//    The same source with the shapes as kernel arguments ran three times
//    the instructions and took 1.36x the time.
//  * Operands resident on the SM.  Everything is staged once, before the
//    loop, and device memory is not read again: thread l keeps row l of J in
//    registers for all iterations (JREG > 0: nv <= JREG, one row per thread)
//    or J lies in shared memory (JREG = 0); X, A_IE^T, EEinv and the row
//    vectors lie in shared memory.  [X; A_IE^T] is one matrix with rows
//    zero-padded to whole float4s, so a lane reads four rows' worth at once;
//    where the block is small enough to leave the registers (XREG: a
//    cluster's blocks at the pad2-cube2 shapes), each warp also keeps the
//    rows of [X; A_IE^T] it multiplies in its registers, and u = X v reads
//    nothing but v.
//    J in shared memory with one block per env arrives as a bulk
//    asynchronous copy (cp.async.bulk, completion on an mbarrier): the
//    16-byte-aligned body in one copy, the few words around it by threads
//    (an env's J starts at any 4-byte address: nI*nv*4 is no multiple of 16
//    at nI=530, nv=39).  X cannot: its rows (2,120 bytes at nI=530) are
//    neither aligned nor whole 16-byte units, and they are padded here.
//  * One thread per output row for y = J u - A_IE z + R v: nv + nE
//    multiply-adds against u, z broadcast from shared memory.  z = EEinv w
//    is computed by lanes 0..nE-1 of every warp and handed round by
//    shuffle, not in a phase of its own.  The association
//    A_IE (EEinv (A_IE^T v)) is the TPU kernel's: EEinv is never folded
//    into A_IE (the weld block is badly conditioned).
//  * u = X v and w = A_IE^T v: one warp per output, up to four outputs at a
//    time so that v is read once for them, the four shuffle sums
//    interleaved.
//  * Explicit fmaf in every dot product (the libraries are built with
//    --fmad=false for the rasterizer's sake; intrinsics are not affected).
//  * Five block barriers an iteration: after u/w of f; after the rows (g,
//    d); after u/w of d; after the two dot products (summed per warp, then
//    every thread adds the warps' partial sums in the same order, so that
//    every thread has the same alpha and a run is deterministic); after the
//    projection.
//  * A thread-block cluster of C blocks can split one env: block r owns
//    contacts [r*K/C, (r+1)*K/C) in all four row groups (so that the cone
//    projection stays local) and the same share of the limit and padding
//    rows, with those rows of J, A_IE and the row vectors and those columns
//    of X.  The partial u, w (nv + nE floats) and the two dot products are
//    stored into every block's shared memory (distributed shared memory)
//    with st.async, each store counted on the receiving block's mbarrier:
//    a block waits until the bytes of an exchange have landed, with no
//    fence and no cluster barrier (barrier.cluster with release and
//    acquire cost ~1,000 cycles an exchange here, against ~50 for a block
//    barrier).  The two u/w buffers alternate so that a block running
//    ahead never overwrites what a slower one still reads.  Cluster
//    launches need sm_90; the launch is refused elsewhere and the wrapper
//    raises.
//  * Shapes whose share fits no block's shared memory even in a cluster of
//    four run with J and X left in device memory (RESIDENT = false): slow,
//    but no shape is refused that the kernel without staging took.
//
// Shared-memory layout: psd::make_plan, mirrored by solver_pallas._smem_bytes
// (tests/test_torch_card_kernels.py holds the two against each other).
//
// Numerics: sums run in another order than the PyTorch twin
// psd_solve_reference (lane-strided partial sums, shuffle trees, fused
// multiply-adds; the step size by __fdividef and the tangent norm by
// rsqrtf, 2 ulp each), so the two agree to a tolerance, not bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

#if !defined(PSD_NI) || !defined(PSD_NV) || !defined(PSD_NE) ||        \
    !defined(PSD_K) || !defined(PSD_NLIM) || !defined(PSD_C) ||         \
    !defined(PSD_THREADS) || !defined(PSD_RESIDENT) ||                  \
    !defined(PSD_JREG) || !defined(PSD_XREG) || !defined(PSD_FORM)
#error "psd_solve.cu is built per shape: utils/build.py::load_psd sets PSD_*"
#endif
#if PSD_FORM == 1 &&                                                   \
    (!defined(PSD_NGRP) || !defined(PSD_GU) || !defined(PSD_WU) ||     \
     !defined(PSD_GJ) || !defined(PSD_WJ) || !defined(PSD_GW) ||       \
     !defined(PSD_WW) || !defined(PSD_GZ) || !defined(PSD_WZ) ||       \
     !defined(PSD_GA) || !defined(PSD_WA) || !defined(PSD_RW))
#error "form 1 is built with its row groups and summation orders"
#endif

// Built with -DPSD_PROFILE (kernel_probe.py --psd-phases), thread 0 of block 0
// counts the cycles of each phase of the loop and the kernel writes those
// counts, not the forces, to out[0..kPhases).
#ifdef PSD_PROFILE
#define PSD_TICK(i)                     \
  {                                     \
    const long long now = clock64();    \
    phase_cycles[i] += now - last_tick; \
    last_tick = now;                    \
  }
#else
#define PSD_TICK(i)
#endif

namespace psd {

// The shapes and the launch plan this library was built for
// (solver_pallas.build_spec): every loop bound and offset is a constant.
constexpr int nI = PSD_NI;        // inequality rows
constexpr int nv = PSD_NV;        // dofs
constexpr int nE = PSD_NE;        // weld rows (may be 0)
constexpr int K = PSD_K;          // contacts
constexpr int nlim = PSD_NLIM;    // joint limits (2 rows each)
constexpr int C = PSD_C;          // blocks per env, one cluster
constexpr int T = PSD_THREADS;    // threads per block
constexpr bool RESIDENT = PSD_RESIDENT != 0;  // J, X staged on the SM
constexpr int JREG = PSD_JREG;    // > 0: J's rows in JREG registers a thread
constexpr bool XREG = PSD_XREG != 0;  // a warp's rows of X in its registers
constexpr int W = T / 32;         // warps per block
constexpr int nout = nv + nE;     // outputs of u = X v, w = A_IE^T v
static_assert(C == 1 || C == 2 || C == 4, "cluster of 1, 2 or 4 blocks");
static_assert(T % 32 == 0 && T >= 32 && T <= 1024, "whole warps");
static_assert(nE <= 32, "z = EEinv w is computed by one warp's lanes");
static_assert(4 * K + 2 * nlim <= nI, "rows");
static_assert(JREG == 0 || (RESIDENT && nv <= JREG && JREG % 8 == 0),
              "J's rows in registers");
static_assert(!XREG || (RESIDENT && nout <= 4 * W),
              "X's rows in registers: four outputs a warp");

#ifdef PSD_PROFILE
// phases: u/w of f, barrier, rows (g, d), barrier, u/w of d, barrier, rows
// and dot products, barrier, step size + projection + barrier, loop head
constexpr int kPhases = 10;
#endif

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemMax = 227 * 1024;  // dynamic shared memory of one block

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
// first of the n items that rank r of c ranks owns
__host__ __device__ constexpr int share(int n, int r, int c) {
  return static_cast<int>(static_cast<long long>(n) * r / c);
}

// Word offsets of one block's arrays in dynamic shared memory (sized for
// the largest share of a cluster).
struct Plan {
  int Kl, tl, nl;  // the largest share: contacts, tail rows, rows
  int nlp;         // nl rounded up to whole float4s: the row stride
  int NU, NW, PW;  // u and w padded, and the two together
  int RW;          // the cluster's warps, padded: dot-product partials
  int o_f, o_g, o_d, o_R, o_b, o_pre, o_mut, o_mur, o_ca, o_la, o_ee, o_gidx,
      o_partA, o_partC, o_uw, o_red, o_J, o_X, o_aie, total;
};

__host__ __device__ constexpr Plan make_plan() {
  Plan p = {};
  p.Kl = (K + C - 1) / C;
  p.tl = (nI - 4 * K + C - 1) / C;
  p.nl = 4 * p.Kl + p.tl;
  p.nlp = round4(p.nl);
  p.NU = JREG > round4(nv) ? JREG : round4(nv);
  p.NW = nE == 0 ? 0 : (nE <= 8 ? 8 : round4(nE));
  p.PW = p.NU + p.NW;
  p.RW = round4(C * W);
  int o = 8;  // words 0-7: the staging mbarrier and the three exchanges'
  auto take = [&o](int n) { const int at = o; o += round4(n); return at; };
  p.o_f = take(p.nlp);
  p.o_g = take(p.nlp);
  p.o_d = take(p.nlp);
  p.o_R = take(p.nlp);
  p.o_b = take(p.nlp);
  p.o_pre = take(p.nlp);
  p.o_mut = take(p.Kl);
  p.o_mur = take(p.Kl);
  p.o_ca = take(p.Kl);
  p.o_la = take(p.tl);
  p.o_ee = take(nE * p.NW);  // rows zero-padded, as w is
  p.o_gidx = take(p.nlp);
  p.o_partA = take(C * p.PW);
  p.o_partC = take(C * p.PW);
  p.o_uw = take(p.PW);
  p.o_red = take(2 * p.RW);
  // J + 4: it starts at its source's offset within 16 bytes
  p.o_J = take(RESIDENT && JREG == 0 ? p.nl * nv + 4 : 0);
  p.o_X = take(RESIDENT ? nv * p.nlp : 0);
  p.o_aie = take(nE * p.nlp);  // right behind X: rows nv.. of [X; A_IE^T]
  p.total = o;
  return p;
}

constexpr Plan P = make_plan();
constexpr int S4 = P.nlp / 4;  // float4s in a row of [X; A_IE^T] and of v
constexpr int NIX = (S4 + 31) / 32;  // ... of them a lane

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same sum
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy n words to shared memory, all threads of the block together.  Where
// source and destination sit at the same offset within 16 bytes, thread 0
// sends the aligned body as one bulk asynchronous copy that completes on
// `mbar`; the other words go by threads.
__device__ void stage_words(float* dst, const float* src, int n,
                            uint32_t mbar) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  int head = 0, body = 0;
  if (((s ^ smem_addr(dst)) & 15) == 0) {
    head = min(n, static_cast<int>(((16 - (s & 15)) & 15) >> 2));
    body = (n - head) & ~3;
  }
  if (body > 0 && threadIdx.x == 0) {
    const uint32_t bytes = static_cast<uint32_t>(body) * 4u;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(mbar),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst + head)),
        "l"(src + head), "r"(bytes), "r"(mbar)
        : "memory");
  }
  for (int i = threadIdx.x; i < head; i += T) dst[i] = src[i];
  for (int i = head + body + threadIdx.x; i < n; i += T) dst[i] = src[i];
}

// Wait for the phase of `mbar` with this parity; bytes that never land trap
// instead of hanging the card.
__device__ __forceinline__ void wait_phase(uint32_t mbar, uint32_t parity) {
  for (int spin = 0; spin < (1 << 22); ++spin) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(mbar), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}

__device__ __forceinline__ void mbar_init(uint32_t mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(mbar), "r"(1)
               : "memory");
}

// The one arrival of a phase, with the bytes that phase waits for.
__device__ __forceinline__ void mbar_expect(uint32_t mbar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(mbar),
               "r"(bytes)
               : "memory");
}

// One float into block `rank` of the cluster at this block's shared address
// `addr`, counted on that block's mbarrier at `mbar`: the store needs no
// fence, the receiver sees it when its barrier's phase completes.
__device__ __forceinline__ void send_float(uint32_t addr, uint32_t mbar,
                                           int rank, float value) {
  uint32_t raddr, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(raddr)
               : "r"(addr), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rbar)
               : "r"(mbar), "r"(rank));
  asm volatile(
      "st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], "
      "%1, [%2];\n" ::"r"(raddr),
      "r"(__float_as_uint(value)), "r"(rbar)
      : "memory");
}

// One block's view of its share of an env.
struct Ctx {
  const float* Jrow;  // J rows: shared [nloc][nv], or the env's J in device
                      // memory
  const float* XA;    // [X; A_IE^T] in shared memory, [nout][nlp],
                      // zero-padded rows (RESIDENT)
  const float* Xenv;  // the env's X in device memory, [nv][nI]
  const int* gidx;    // local row -> row of the env
  const float* aieT;  // [nE][nlp]
  const float* ee;    // [nE][NW]
  const float* R;
  int nloc, rank;
};

// acc[j] += sum_i row_j[i] . v[i] over the S4 float4s of a row, lane by
// lane, for NJ rows `step` float4s apart: every load of a round starts
// before the first multiply-add that needs one.
template <int NJ>
__device__ __forceinline__ void dot_rows(const float4* r4, int step,
                                         const float4* v4, int lane,
                                         float (&acc)[4]) {
  for (int i = lane; i < S4; i += 32) {
    const float4 a = v4[i];
    float4 x[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) x[j] = r4[j * step + i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc[j] = fmaf(x[j].x, a.x, acc[j]);
      acc[j] = fmaf(x[j].y, a.y, acc[j]);
      acc[j] = fmaf(x[j].z, a.z, acc[j]);
      acc[j] = fmaf(x[j].w, a.w, acc[j]);
    }
  }
}

// This warp's rows of [X; A_IE^T] (outputs warp, warp + W, ..), the
// float4s lane, lane + 32, .. of each: zero past the last output and row.
struct RowRegs {
  float4 x[XREG ? 4 : 1][XREG ? NIX : 1];
};

// Partial u = X v and w = A_IE^T v over this block's rows, written to slot
// `rank` of `part` in every block of the cluster (there counted on the
// mbarrier `bar`).  One warp per output, up to four outputs (W apart) at a
// time; with XREG the warp's rows are in `xr` and only v is read.
__device__ __forceinline__ void columns_pass(const Ctx& c, const float* v,
                                             float* part, uint32_t bar,
                                             const RowRegs& xr) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o0 = warp; o0 < nout; o0 += 4 * W) {
    const int nj = 1 + (o0 + W < nout) + (o0 + 2 * W < nout) +
                   (o0 + 3 * W < nout);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (XREG) {
      const float4* v4 = reinterpret_cast<const float4*>(v);
#pragma unroll
      for (int m = 0; m < NIX; ++m) {
        const int i = lane + 32 * m;
        const float4 a = i < S4 ? v4[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j] = fmaf(xr.x[j][m].x, a.x, acc[j]);
          acc[j] = fmaf(xr.x[j][m].y, a.y, acc[j]);
          acc[j] = fmaf(xr.x[j][m].z, a.z, acc[j]);
          acc[j] = fmaf(xr.x[j][m].w, a.w, acc[j]);
        }
      }
    } else if (RESIDENT) {
      const float4* v4 = reinterpret_cast<const float4*>(v);
      const float4* r4 = reinterpret_cast<const float4*>(c.XA) + o0 * S4;
      switch (nj) {
        case 4: dot_rows<4>(r4, W * S4, v4, lane, acc); break;
        case 3: dot_rows<3>(r4, W * S4, v4, lane, acc); break;
        case 2: dot_rows<2>(r4, W * S4, v4, lane, acc); break;
        default: dot_rows<1>(r4, W * S4, v4, lane, acc); break;
      }
    } else {
      for (int l = lane; l < c.nloc; l += 32) {
        const float vl = v[l];
        const int gl = c.gidx[l];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = o0 + j * W;
          if (j < nj)
            acc[j] = fmaf(o < nv ? c.Xenv[static_cast<long long>(o) * nI + gl]
                                 : c.aieT[(o - nv) * P.nlp + l],
                          vl, acc[j]);
        }
      }
    }
    // the four sums together: their shuffles overlap
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      float t[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) t[j] = __shfl_xor_sync(kFull, acc[j], m);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += t[j];
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = o0 + j * W;
        if (j < nj) {
          const int at = c.rank * P.PW + (o < nv ? o : P.NU + o - nv);
          if constexpr (C == 1) {
            part[at] = acc[j];
          } else {
            for (int r = 0; r < C; ++r)
              send_float(smem_addr(part + at), bar, r, acc[j]);
          }
        }
      }
    }
  }
}

// Every block of the cluster has come this far (with one block: every
// thread of it).
__device__ __forceinline__ void cluster_sync() {
  if constexpr (C > 1) {
    asm volatile(
        "barrier.cluster.arrive.release.aligned;\n"
        "barrier.cluster.wait.acquire.aligned;\n" ::
            : "memory");
  } else {
    __syncthreads();
  }
}

// Exchange `use` of the iterations on `bar` is complete: all `bytes` that
// the cluster's blocks send this block have landed (with one block: every
// thread has stored).  Thread 0 then arms the barrier for the next use: no
// block can send for it before this block has sent on, and it sends on
// only after all its threads have passed here.
__device__ __forceinline__ void exchange_wait(uint32_t bar, int use,
                                              uint32_t bytes) {
  if constexpr (C > 1) {
    wait_phase(bar, use & 1);
    if (threadIdx.x == 0) mbar_expect(bar, bytes);
  } else {
    __syncthreads();
  }
}

// u, w after the exchange: the one block's own slot, or the slots' sum in
// rank order (ends synchronised).
__device__ __forceinline__ const float* gather_uw(const float* part,
                                                  float* uw) {
  if constexpr (C == 1) {
    return part;
  } else {
    for (int t = threadIdx.x; t < P.PW; t += T) {
      float s = 0.0f;
      for (int r = 0; r < C; ++r) s += part[r * P.PW + t];
      uw[t] = s;
    }
    __syncthreads();
    return uw;
  }
}

// (Aop v)_l for this thread's local row l (row jrow of c.Jrow), given u, w
// of v.  Every lane of the warp calls it (the z values travel by shuffle);
// `active` lanes have a row.
__device__ __forceinline__ float row_apply(
    const Ctx& c, const float* uw, const float* v, int l, int jrow,
    bool active, const float (&jr)[JREG > 0 ? JREG : 1]) {
  const int lane = threadIdx.x & 31;
  // z = EEinv w, one entry per lane (EEinv's rows and w are zero-padded)
  float zl = 0.0f;
  if (lane < nE) {
    const float4* w4 = reinterpret_cast<const float4*>(uw + P.NU);
    const float4* e4 = reinterpret_cast<const float4*>(c.ee + lane * P.NW);
    float z1 = 0.0f;
#pragma unroll
    for (int j = 0; j < P.NW / 4; ++j) {
      const float4 e = e4[j];
      const float4 w = w4[j];
      zl = fmaf(e.x, w.x, zl);
      z1 = fmaf(e.y, w.y, z1);
      zl = fmaf(e.z, w.z, zl);
      z1 = fmaf(e.w, w.w, z1);
    }
    zl += z1;
  }
  float y = 0.0f, y1 = 0.0f;
  if (JREG > 0) {
    // u is zero from nv to JREG, and so is this thread's row
    const float4* u4 = reinterpret_cast<const float4*>(uw);
#pragma unroll
    for (int k4 = 0; k4 < JREG / 4; k4 += 2) {
      const float4 u = u4[k4];
      const float4 t = u4[k4 + 1];
      y = fmaf(jr[4 * k4 + 0], u.x, y);
      y1 = fmaf(jr[4 * k4 + 4], t.x, y1);
      y = fmaf(jr[4 * k4 + 1], u.y, y);
      y1 = fmaf(jr[4 * k4 + 5], t.y, y1);
      y = fmaf(jr[4 * k4 + 2], u.z, y);
      y1 = fmaf(jr[4 * k4 + 6], t.z, y1);
      y = fmaf(jr[4 * k4 + 3], u.w, y);
      y1 = fmaf(jr[4 * k4 + 7], t.w, y1);
    }
  } else if (active) {
    const float* row = c.Jrow + static_cast<long long>(jrow) * nv;
#pragma unroll 8
    for (int k = 0; k + 1 < nv; k += 2) {
      y = fmaf(row[k], uw[k], y);
      y1 = fmaf(row[k + 1], uw[k + 1], y1);
    }
    if (nv % 2) y = fmaf(row[nv - 1], uw[nv - 1], y);
  }
  y += y1;
  // all of this row's A_IE first, then the shuffles: nothing waits in turn
  float a[nE > 0 ? nE : 1];
#pragma unroll
  for (int j = 0; j < nE; ++j) a[j] = active ? c.aieT[j * P.nlp + l] : 0.0f;
#pragma unroll
  for (int j = 0; j < nE; ++j) y = fmaf(-a[j], __shfl_sync(kFull, zl, j), y);
  return active ? fmaf(c.R[l], v[l], y) : 0.0f;
}

// f[:] <- project(f - alpha*d) over this block's rows (d == nullptr: project
// f in place).  Local rows: 4 groups of Kl contacts, then tl tail rows of
// which the first n_lim_local are limit rows.
__device__ void project(float* f, const float* d, float alpha,
                        const float* mu_t, const float* mu_tor,
                        const float* con_act, const float* lim_act, int Kl,
                        int tl, int n_lim_local) {
  for (int k = threadIdx.x; k < Kl; k += T) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = q * Kl + k;
      v[q] = d ? fmaf(-alpha, d[r], f[r]) : f[r];
    }
    const float ca = con_act[k];
    const float fn = fmaxf(v[0], 0.0f) * ca;
    const float scale = fminf(
        mu_t[k] * fn * rsqrtf(v[1] * v[1] + v[2] * v[2] + 1e-18f), 1.0f);
    const float lim = mu_tor[k] * fn;
    f[k] = fn;
    f[Kl + k] = v[1] * scale * ca;
    f[2 * Kl + k] = v[2] * scale * ca;
    f[3 * Kl + k] = fminf(fmaxf(v[3], -lim), lim) * ca;
  }
  for (int j = threadIdx.x; j < tl; j += T) {
    const int r = 4 * Kl + j;
    const float v = d ? fmaf(-alpha, d[r], f[r]) : f[r];
    f[r] = j < n_lim_local ? fmaxf(v, 0.0f) * lim_act[j] : 0.0f;
  }
}

#if PSD_FORM == 0
__global__ void __launch_bounds__(T)
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
                 int iterations) {
  extern __shared__ __align__(16) float smem[];
  const int rank =
      C > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const long long env = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // this block's share: contacts [k0, k0 + Kl) of each of the four groups,
  // then tail rows [t0, t0 + tl) (limit rows first, then padding)
  constexpr int tail = nI - 4 * K;
  const int k0 = share(K, rank, C);
  const int Kl = share(K, rank + 1, C) - k0;
  const int t0 = share(tail, rank, C);
  const int tl = share(tail, rank + 1, C) - t0;
  const int nloc = 4 * Kl + tl;
  const int n_lim_local = max(0, min(tl, 2 * nlim - t0));

  float* f = smem + P.o_f;
  float* g = smem + P.o_g;
  float* d = smem + P.o_d;
  float* Rs = smem + P.o_R;
  float* bs = smem + P.o_b;
  float* pre = smem + P.o_pre;
  float* mt = smem + P.o_mut;
  float* mr = smem + P.o_mur;
  float* ca = smem + P.o_ca;
  float* la = smem + P.o_la;
  float* aieT = smem + P.o_aie;
  float* ee = smem + P.o_ee;
  int* gidx = reinterpret_cast<int*>(smem + P.o_gidx);
  float* partA = smem + P.o_partA;
  float* partC = smem + P.o_partC;
  float* uw = smem + P.o_uw;
  float* red = smem + P.o_red;

  // ---- staging: everything this block needs, once
  const float* Jenv = J + env * nI * nv;
  const float* Xenv = X + env * nv * nI;
  const uint32_t mbar = smem_addr(smem);
  // the three exchanges of an iteration: u/w of f, u/w of d, the dot products
  const uint32_t barA = mbar + 8, barC = mbar + 16, barD = mbar + 24;
  constexpr uint32_t uw_bytes = 4u * C * nout, dot_bytes = 4u * C * W * 2;
  constexpr bool bulk = RESIDENT && JREG == 0 && C == 1;
  if ((bulk || C > 1) && tid == 0) {
    mbar_init(mbar);
    mbar_init(barA);
    mbar_init(barC);
    mbar_init(barD);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  // every pad word that a float4 read may touch is zero: v, u, w, the rows
  // of [X; A_IE^T] (J in shared memory has no pad and may arrive by bulk
  // copy: left out)
  for (int i = 8 + tid; i < P.total; i += T)
    if (i < P.o_J || i >= P.o_X) smem[i] = 0.0f;
  __syncthreads();
  for (int l = tid; l < nloc; l += T)
    gidx[l] = l < 4 * Kl ? (l / Kl) * K + k0 + l % Kl
                         : 4 * K + t0 + (l - 4 * Kl);
  __syncthreads();

  // J in shared memory starts at the offset within 16 bytes that its
  // source has, so that one block's whole J is one bulk copy
  float* Js = smem + P.o_J + ((reinterpret_cast<uintptr_t>(Jenv) >> 2) & 3);
  float* Xs = smem + P.o_X;
  if (bulk) {
    stage_words(Js, Jenv, nI * nv, mbar);
    if (tid == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(mbar)
                   : "memory");
  } else if (RESIDENT && JREG == 0) {
    for (int i = tid; i < nloc * nv; i += T) {
      const int l = i / nv;
      Js[i] = Jenv[static_cast<long long>(gidx[l]) * nv + (i - l * nv)];
    }
  }
  if (RESIDENT) {
    for (int i = tid; i < nv * nloc; i += T) {
      const int c = i / nloc;
      const int l = i - c * nloc;
      Xs[c * P.nlp + l] = Xenv[static_cast<long long>(c) * nI + gidx[l]];
    }
  }
  const long long vo = env * nI;
  for (int l = tid; l < nloc; l += T) {
    const int gi = gidx[l];
    f[l] = f0[vo + gi];
    Rs[l] = R[vo + gi];
    bs[l] = b[vo + gi];
    pre[l] = precond[vo + gi];
  }
  constexpr int nE1 = nE > 0 ? nE : 1;  // a divisor (the loops are empty)
  for (int i = tid; i < nloc * nE; i += T) {
    const int l = i / nE1;
    const int j = i - l * nE;
    aieT[j * P.nlp + l] = A_IE[(vo + gidx[l]) * nE + j];
  }
  for (int i = tid; i < nE * nE; i += T)
    ee[(i / nE1) * P.NW + i % nE1] = EEinv[env * nE * nE + i];
  for (int k = tid; k < Kl; k += T) {
    mt[k] = mu_t[env * K + k0 + k];
    mr[k] = mu_tor[env * K + k0 + k];
    ca[k] = con_act[env * K + k0 + k];
  }
  for (int j = tid; j < n_lim_local; j += T)
    la[j] = lim_act[env * 2 * nlim + t0 + j];

  // this thread's row of J, in registers for the whole loop
  float jr[JREG > 0 ? JREG : 1];
  if (JREG > 0) {
    const bool mine = tid < nloc;
    const float* row = Jenv + static_cast<long long>(mine ? gidx[tid] : 0) * nv;
#pragma unroll
    for (int k = 0; k < JREG; ++k) jr[k] = mine && k < nv ? row[k] : 0.0f;
  }
  if (bulk) wait_phase(mbar, 0);
  __syncthreads();
  // this warp's rows of [X; A_IE^T], in registers for the whole loop
  RowRegs xr;
  if (XREG) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int m = 0; m < NIX; ++m) {
        const int o = warp + j * W;
        const int i = lane + 32 * m;
        xr.x[j][m] = o < nout && i < S4
                         ? reinterpret_cast<const float4*>(Xs)[o * S4 + i]
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  }
  project(f, nullptr, 0.0f, mt, mr, ca, la, Kl, tl, n_lim_local);
  // every block of the cluster is running, has cleared its buffers and
  // set up its barriers
  cluster_sync();
  if (C > 1 && tid == 0) {
    mbar_expect(barA, uw_bytes);
    mbar_expect(barC, uw_bytes);
    mbar_expect(barD, dot_bytes);
  }

  const Ctx c = {RESIDENT ? Js : Jenv, Xs, Xenv, gidx, aieT, ee, Rs, nloc,
                 rank};

#ifdef PSD_PROFILE
  long long phase_cycles[kPhases] = {};
  long long last_tick = clock64();
#endif
  for (int it = 0; it < iterations; ++it) {
    PSD_TICK(9)
    // g = Aop f + b, d = precond * g
    columns_pass(c, f, partA, barA, xr);
    PSD_TICK(0)
    exchange_wait(barA, it, uw_bytes);
    PSD_TICK(1)
    const float* u = gather_uw(partA, uw);
    for (int lb = warp * 32; lb < nloc; lb += T) {
      const int l = lb + lane;
      const bool active = l < nloc;
      const int jrow = RESIDENT || !active ? l : gidx[l];
      const float y = row_apply(c, u, f, l, jrow, active, jr);
      if (active) {
        const float gi = y + bs[l];
        g[l] = gi;
        d[l] = pre[l] * gi;
      }
    }
    PSD_TICK(2)
    __syncthreads();
    PSD_TICK(3)
    // Ad = Aop d, with this thread's share of g.d and d.Ad
    columns_pass(c, d, partC, barC, xr);
    PSD_TICK(4)
    exchange_wait(barC, it, uw_bytes);
    PSD_TICK(5)
    u = gather_uw(partC, uw);
    float num = 0.0f, den = 0.0f;
    for (int lb = warp * 32; lb < nloc; lb += T) {
      const int l = lb + lane;
      const bool active = l < nloc;
      const int jrow = RESIDENT || !active ? l : gidx[l];
      const float ad = row_apply(c, u, d, l, jrow, active, jr);
      if (active) {
        num = fmaf(g[l], d[l], num);
        den = fmaf(d[l], ad, den);
      }
    }
    num = warp_sum(num);
    den = warp_sum(den);
    if (lane == 0) {
      if constexpr (C == 1) {
        red[warp] = num;
        red[P.RW + warp] = den;
      } else {
        for (int r = 0; r < C; ++r) {
          send_float(smem_addr(red + rank * W + warp), barD, r, num);
          send_float(smem_addr(red + P.RW + rank * W + warp), barD, r, den);
        }
      }
    }
    PSD_TICK(6)
    exchange_wait(barD, it, dot_bytes);
    PSD_TICK(7)
    // every thread adds all the partial sums in the same order (the unused
    // ones are zero)
    num = 0.0f;
    den = 0.0f;
    float num1 = 0.0f, den1 = 0.0f;
#pragma unroll
    for (int j = 0; j < P.RW / 4; ++j) {
      const float4 a = reinterpret_cast<const float4*>(red)[j];
      const float4 e = reinterpret_cast<const float4*>(red + P.RW)[j];
      num += a.x + a.y;
      num1 += a.z + a.w;
      den += e.x + e.y;
      den1 += e.z + e.w;
    }
    num += num1;
    den += den1;
    const float alpha =
        den > 1e-12f ? __fdividef(num, fmaxf(den, 1e-12f)) : 0.0f;
    project(f, d, alpha, mt, mr, ca, la, Kl, tl, n_lim_local);
    __syncthreads();
    PSD_TICK(8)
  }
  for (int l = tid; l < nloc; l += T) out[vo + gidx[l]] = f[l];
#ifdef PSD_PROFILE
  __syncthreads();
  if (blockIdx.x == 0 && tid == 0)
    for (int i = 0; i < kPhases; ++i)
      out[i] = static_cast<float>(phase_cycles[i]);
#endif
  // no block leaves while another may still write into its shared memory
  if (C > 1) cluster_sync();
}
#endif

}  // namespace psd

#if PSD_FORM == 1
// Form 1: solver.solve's 'psd' iteration, its forces the eager loop's bit
// for bit (solver._solve_rows holds it to them at an operands' layout's
// first solve, and raises where they differ).
//
// Why bit for bit.  At some steps of a production episode a control step
// amplifies a float32 rounding of the solve to 1e-4 in qpos in most envs
// (a qvel one ulp off does as much), so a solve that sums in any other
// order leaves the eager step's state; the loop's own orders do not.
//
// One block holds one env, every row of it, with X, A_IE, J_E, EEinv and
// the row vectors in shared memory; J, transposed, fills what shared
// memory is left (19 of 39 dofs at pad2-cube2's shapes) and the rest is
// read from device memory (a warp's rows read one line a dof).  Each
// product of the loop is summed as the library routine the eager loop
// calls (torch.bmm) sums it,
// as solver_pallas.library_orders read it and PSD_G* / PSD_W* pass it: G
// chains, chain g over the chunks g, g + G, .. of W terms, its first
// product rounded and the rest fused, the G chain sums halved pairwise.
// The two dot products are summed as torch's vectorized row reduction
// sums a row (row_sum) with PSD_RW threads a row, which it takes by the
// batch (on the H100: 128 below 8 rows, 64 below 16, 32 from 16 on).  Every elementwise operation is the eager loop's:
// f - alpha*d as a product then a difference, the tangent norm by sqrtf,
// the step size and the cone's scale by IEEE division.  Threads run the
// rows (one each) and the chains of u = X v; there is no cluster: the
// chains of u span every row.
namespace psdx {
using psd::nI;
using psd::nv;
using psd::nE;
using psd::K;
using psd::nlim;
using psd::T;
using psd::kFull;
using psd::round4;
constexpr int NG = PSD_NGRP;     // contact row groups: 4, or 6 (rolling)
static_assert(NG == 4 || NG == 6, "4 contact row groups, or 6");
static_assert(NG * K + 2 * nlim <= nI, "rows");
constexpr int GU = PSD_GU, WU = PSD_WU;  // u = X v, over the nI rows
constexpr int GJ = PSD_GJ, WJ = PSD_WJ;  // J u, over the nv dofs
constexpr int GW = PSD_GW, WW = PSD_WW;  // w = J_E u, over the nv dofs
constexpr int GZ = PSD_GZ, WZ = PSD_WZ;  // z = EEinv w, over the nE rows
constexpr int GA = PSD_GA, WA = PSD_WA;  // A_IE z, over the nE rows
constexpr int RW = PSD_RW;       // the threads of a row sum (row_sum)
static_assert(RW >= 32 && RW <= T && (RW & (RW - 1)) == 0,
              "a row sum's threads: whole warps of the block, a power of two");
constexpr int nlp = round4(nI);
static_assert(nE > 0, "form 1 has weld rows");
static_assert((GU & (GU - 1)) == 0 && (GJ & (GJ - 1)) == 0 &&
                  (GW & (GW - 1)) == 0 && (GZ & (GZ - 1)) == 0 &&
                  (GA & (GA - 1)) == 0,
              "chain sums are halved pairwise: powers of two");

// Word offsets in dynamic shared memory; the first NJS dofs of Jᵀ fill
// what the rest leaves of a block's shared memory.
struct Plan {
  int o_X, o_A, o_f, o_g, o_d, o_ad, o_R, o_b, o_pre, o_prod, o_je, o_ee,
      o_u, o_up, o_w, o_z, o_mut, o_mur, o_mro, o_ca, o_la, o_red, o_rs, o_J,
      njs, total;
};

__host__ __device__ constexpr Plan make_plan() {
  Plan p = {};
  int o = 0;
  auto take = [&o](int n) { const int at = o; o += round4(n); return at; };
  p.o_X = take(nv * nlp);   // X [nv][nlp]
  p.o_A = take(nI * nE);    // A_IE [nI][nE]
  p.o_f = take(nlp);
  p.o_g = take(nlp);
  p.o_d = take(nlp);
  p.o_ad = take(nlp);
  p.o_R = take(nlp);
  p.o_b = take(nlp);
  p.o_pre = take(nlp);
  p.o_prod = take(nlp);     // the products a dot product sums
  p.o_je = take(nE * nv);
  p.o_ee = take(nE * nE);
  p.o_u = take(nv);
  p.o_up = take(GU * nv);   // the chains' sums of u
  p.o_w = take(nE);
  p.o_z = take(nE);
  p.o_mut = take(K);
  p.o_mur = take(K);
  p.o_mro = take(K);
  p.o_ca = take(K);
  p.o_la = take(2 * nlim);
  p.o_red = take(2);
  p.o_rs = take(RW);        // a row sum's threads' partial sums
  const int room = (psd::kSmemMax / 4 - o) / nlp;
  p.njs = room < 0 ? 0 : (room < nv ? room : nv);
  p.o_J = take(p.njs * nlp);  // Jᵀ's first njs dofs [njs][nlp]
  p.total = o;
  return p;
}

constexpr Plan P = make_plan();
constexpr int NJS = P.njs;

// f[:] <- project(f - alpha*d) as solver._project takes it: NG groups of K
// contacts (fn >= 0, the tangent pair clipped to the mu_t*fn disk,
// torsion at mu_tor*fn, the rolling rows at mu_roll*fn, masked by con_act),
// then the limit rows >= 0 masked by lim_act, then padding rows 0.
__device__ void project(float* f, const float* d, float alpha,
                        const float* mu_t, const float* mu_tor,
                        const float* mu_roll, const float* con_act,
                        const float* lim_act) {
  for (int k = threadIdx.x; k < K; k += T) {
    float v[NG];
#pragma unroll
    for (int q = 0; q < NG; ++q) v[q] = f[q * K + k] - alpha * d[q * K + k];
    const float ca = con_act[k];
    const float fn = fmaxf(v[0], 0.0f) * ca;
    const float tn = sqrtf(v[1] * v[1] + v[2] * v[2] + 1e-18f);
    const float scale = fminf(mu_t[k] * fn / tn, 1.0f);
    const float lim = mu_tor[k] * fn;
    f[k] = fn;
    f[K + k] = v[1] * scale * ca;
    f[2 * K + k] = v[2] * scale * ca;
    f[3 * K + k] = fminf(fmaxf(v[3], -lim), lim) * ca;
    if constexpr (NG == 6) {
      const float lr = mu_roll[k] * fn;
      f[4 * K + k] = fminf(fmaxf(v[4], -lr), lr) * ca;
      f[5 * K + k] = fminf(fmaxf(v[5], -lr), lr) * ca;
    }
  }
  for (int j = threadIdx.x; j < nI - NG * K; j += T) {
    const int r = NG * K + j;
    const float v = f[r] - alpha * d[r];
    f[r] = j < 2 * nlim ? fmaxf(v, 0.0f) * lim_act[j] : 0.0f;
  }
}

// sum over k < N of a(k) * x[k] in the order of G chains of W-term chunks
// (the namespace's comment); a(k) is read where the loop needs it
template <int N, int G, int W, typename Ak>
__device__ __forceinline__ float ordered_dot(Ak a, const float* x) {
  float p[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    p[g] = 0.0f;
    bool first = true;
#pragma unroll
    for (int c = g; c * W < N; c += G) {
#pragma unroll
      for (int j = c * W; j < (N < c * W + W ? N : c * W + W); ++j) {
        p[g] = first ? a(j) * x[j] : fmaf(a(j), x[j], p[g]);
        first = false;
      }
    }
  }
#pragma unroll
  for (int h = G / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int i = 0; i < h; ++i) p[i] = p[i] + p[i + h];
  }
  return p[0];
}

// The sum of x[0..nI) as torch's vectorized row reduction takes it, for a
// row that starts `shift` floats past a 16-byte boundary: RW threads, each
// with four accumulators over float4s RW apart (the head before the
// boundary and the tail after the last whole float4 into threads' first
// accumulators), the accumulators added in turn, the threads' sums halved
// through shared memory (`buf`, RW floats) down to one warp, and that
// warp's by shuffles 16, 8, 4, 2, 1 apart.  Called by threads 0..RW-1
// alone, which meet at named barrier 1; thread 0 returns the sum.
__device__ float row_sum(const float* x, int shift, float* buf) {
  const int t = threadIdx.x;
  int end = nI, base = 0;
  float a0 = 0.0f;
  if (shift > 0) {
    end += shift;
    if (t >= shift && t < 4) a0 = a0 + x[t - shift];
    end -= 4;
    base = 4 - shift;
  }
  float a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (int i = t; i * 4 + 3 < end; i += RW) {
    const float* q = x + base + 4 * i;
    a0 = a0 + q[0];
    a1 = a1 + q[1];
    a2 = a2 + q[2];
    a3 = a3 + q[3];
  }
  const int tail = end - end % 4;
  if (tail + t < end) a0 = a0 + x[base + tail + t];
  float s = ((a0 + a1) + a2) + a3;
  if constexpr (RW > 32) {
    buf[t] = s;
#pragma unroll
    for (int off = RW / 2; off >= 32; off >>= 1) {
      asm volatile("bar.sync 1, %0;\n" ::"r"(RW) : "memory");
      if (t < off) {
        s = s + buf[t + off];
        buf[t] = s;
      }
    }
  }
  if (t < 32) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s = s + __shfl_down_sync(kFull, s, off);
  }
  return s;
}

struct Env {
  float* sm;
  const float* JT;  // this env's J transposed, in device memory [nv][nI]:
                    // a warp's rows read one line a dof (the first NJS
                    // dofs are in shared memory)
};

// out = (J u + R v) - A_IE (EEinv (J_E u)), u = X v, as solver._apply
// takes it, each sum in its library's order.  Ends with each thread's rows
// of out written (rows l = threadIdx.x + k T), and no barrier.
__device__ void apply(const Env& e, const float* v, float* out) {
  float* sm = e.sm;
  const float* X = sm + P.o_X;
  float* up = sm + P.o_up;
  float* u = sm + P.o_u;
  float* w = sm + P.o_w;
  float* z = sm + P.o_z;
  const int tid = threadIdx.x;
  // u's chains: chain g of output o over the chunks g, g + GU, .. of WU rows
  for (int t = tid; t < nv * GU; t += T) {
    const int o = t % nv, g = t / nv;
    const float* xo = X + o * nlp;
    float acc = 0.0f;
    if (g * WU < nI) {
      acc = xo[g * WU] * v[g * WU];
      for (int c = g; c * WU < nI; c += GU) {
        const int lo = c * WU;
        if (lo + WU <= nI) {   // a whole chunk: its loads ahead of the chain
#pragma unroll
          for (int j = 0; j < WU; ++j)
            if (c != g || j > 0) acc = fmaf(xo[lo + j], v[lo + j], acc);
        } else {
          for (int j = (c == g ? lo + 1 : lo); j < nI; ++j)
            acc = fmaf(xo[j], v[j], acc);
        }
      }
    }
    up[g * nv + o] = acc;
  }
  __syncthreads();
  for (int o = tid; o < nv; o += T) {
    float p[GU];
#pragma unroll
    for (int g = 0; g < GU; ++g) p[g] = up[g * nv + o];
#pragma unroll
    for (int h = GU / 2; h > 0; h >>= 1) {
#pragma unroll
      for (int i = 0; i < h; ++i) p[i] = p[i] + p[i + h];
    }
    u[o] = p[0];
  }
  __syncthreads();
  if (tid < 32) {         // w and z in one warp
    if (tid < nE) {
      const float* je = sm + P.o_je + tid * nv;
      w[tid] = ordered_dot<nv, GW, WW>([je](int k) { return je[k]; }, u);
    }
    __syncwarp();
    if (tid < nE) {
      const float* ee = sm + P.o_ee + tid * nE;
      z[tid] = ordered_dot<nE, GZ, WZ>([ee](int k) { return ee[k]; }, w);
    }
  }
  __syncthreads();
  const float* A = sm + P.o_A;
  const float* R = sm + P.o_R;
  const float* Js = sm + P.o_J;
  for (int l = tid; l < nI; l += T) {
    const float* jt = e.JT + l;
    const float* js = Js + l;
    const float ju = ordered_dot<nv, GJ, WJ>(
        [jt, js](int k) { return k < NJS ? js[k * nlp] : jt[k * nI]; }, u);
    const float* al = A + l * nE;
    const float s = ordered_dot<nE, GA, WA>([al](int k) { return al[k]; }, z);
    out[l] = (ju + R[l] * v[l]) - s;
  }
}

__global__ void __launch_bounds__(T)
psd_solve_kernel(const float* __restrict__ J, const float* __restrict__ X,
                 const float* __restrict__ A_IE,
                 const float* __restrict__ EEinv,
                 const float* __restrict__ R, const float* __restrict__ b,
                 const float* __restrict__ precond,
                 const float* __restrict__ f0,
                 const float* __restrict__ mu_t,
                 const float* __restrict__ mu_tor,
                 const float* __restrict__ con_act,
                 const float* __restrict__ lim_act,
                 const float* __restrict__ mu_roll,
                 const float* __restrict__ J_E, float* __restrict__ out,
                 int iterations) {
  extern __shared__ __align__(16) float sm[];
  const long long env = blockIdx.x;
  const int tid = threadIdx.x;
  float* f = sm + P.o_f;
  float* g = sm + P.o_g;
  float* d = sm + P.o_d;
  float* ad = sm + P.o_ad;
  float* Rs = sm + P.o_R;
  float* bs = sm + P.o_b;
  float* pre = sm + P.o_pre;
  float* prod = sm + P.o_prod;
  float* mt = sm + P.o_mut;
  float* mr = sm + P.o_mur;
  float* mro = sm + P.o_mro;
  float* ca = sm + P.o_ca;
  float* la = sm + P.o_la;
  float* red = sm + P.o_red;
  float* rs = sm + P.o_rs;
  const float* Xenv = X + env * nv * nI;
  for (int i = tid; i < nv * nI; i += T) {
    const int o = i / nI;
    sm[P.o_X + o * nlp + (i - o * nI)] = Xenv[i];
  }
  for (int i = tid; i < nI * nE; i += T) sm[P.o_A + i] = A_IE[env * nI * nE + i];
  const float* JTenv = J + env * nv * nI;  // form 1's J is Jᵀ [B][nv][nI]
  for (int i = tid; i < NJS * nI; i += T) {
    const int k = i / nI;
    sm[P.o_J + k * nlp + (i - k * nI)] = JTenv[i];
  }
  for (int i = tid; i < nE * nv; i += T) sm[P.o_je + i] = J_E[env * nE * nv + i];
  for (int i = tid; i < nE * nE; i += T) sm[P.o_ee + i] = EEinv[env * nE * nE + i];
  const long long vo = env * nI;
  for (int l = tid; l < nI; l += T) {
    f[l] = f0[vo + l];
    Rs[l] = R[vo + l];
    bs[l] = b[vo + l];
    pre[l] = precond[vo + l];
  }
  for (int k = tid; k < K; k += T) {
    mt[k] = mu_t[env * K + k];
    mr[k] = mu_tor[env * K + k];
    ca[k] = con_act[env * K + k];
    if constexpr (NG == 6) mro[k] = mu_roll[env * K + k];
  }
  for (int j = tid; j < 2 * nlim; j += T) la[j] = lim_act[env * 2 * nlim + j];
  __syncthreads();
  const Env e = {sm, JTenv};
  // the eager loop's products g*d and d*Ad are rows of a [B, nI] tensor:
  // this env's row starts (env * nI) floats into a 16-byte aligned buffer
  const int shift = static_cast<int>((env * nI) % 4);
  for (int it = 0; it < iterations; ++it) {
    apply(e, f, g);
    for (int l = tid; l < nI; l += T) {
      const float gi = g[l] + bs[l];
      const float di = pre[l] * gi;
      g[l] = gi;
      d[l] = di;
      prod[l] = gi * di;
    }
    __syncthreads();
    if (tid < RW) {
      const float num = row_sum(prod, shift, rs);
      if (tid == 0) red[0] = num;
    }
    apply(e, d, ad);   // its first barrier comes after the sum read prod
    for (int l = tid; l < nI; l += T) prod[l] = d[l] * ad[l];
    __syncthreads();
    if (tid < RW) {
      const float den = row_sum(prod, shift, rs);
      if (tid == 0) red[1] = den;
    }
    __syncthreads();
    const float num = red[0], den = red[1];
    const float alpha = den > 1e-12f ? num / fmaxf(den, 1e-12f) : 0.0f;
    project(f, d, alpha, mt, mr, mro, ca, la);
    __syncthreads();
  }
  for (int l = tid; l < nI; l += T) out[vo + l] = f[l];
}

}  // namespace psdx
#endif

// Bytes of dynamic shared memory one block needs.
extern "C" int psd_solve_smem_bytes() {
#if PSD_FORM == 1
  return 4 * psdx::P.total;
#else
  return 4 * psd::P.total;
#endif
}

// Launch B envs on `stream` (form 0: C blocks of T threads each as one
// cluster; form 1: one block an env); returns the CUDA error (0 =
// launched).  mu_roll and J_E are read by form 1 only.
extern "C" int psd_solve_f32(const float* J, const float* X,
                             const float* A_IE, const float* EEinv,
                             const float* R, const float* b,
                             const float* precond, const float* f0,
                             const float* mu_t, const float* mu_tor,
                             const float* con_act, const float* lim_act,
                             const float* mu_roll, const float* J_E,
                             float* out, int B, int iterations,
                             void* stream) {
  if (B == 0 || psd::nI == 0) return 0;
#if PSD_FORM == 1
  constexpr size_t smem = 4 * static_cast<size_t>(psdx::P.total);
  if (smem > psd::kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      psdx::psd_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  psdx::psd_solve_kernel<<<B, psd::T, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      J, X, A_IE, EEinv, R, b, precond, f0, mu_t, mu_tor, con_act, lim_act,
      mu_roll, J_E, out, iterations);
  return static_cast<int>(cudaGetLastError());
#else
  (void)mu_roll;
  (void)J_E;
  constexpr size_t smem = 4 * static_cast<size_t>(psd::P.total);
  if (smem > psd::kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      psd::psd_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * psd::C);
  cfg.blockDim = dim3(psd::T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = psd::C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, psd::psd_solve_kernel, J, X, A_IE, EEinv, R,
                           b, precond, f0, mu_t, mu_tor, con_act, lim_act,
                           out, iterations);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
#endif
}

extern "C" const char* psd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
