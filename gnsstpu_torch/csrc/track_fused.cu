// K1 on Hopper: fused single-code DLL / FLL-assisted-PLL tracker.
//
// Replaces the TPU Pallas kernel gnsstpu/ops/track_kernel.py
// (track_chunk_fused :274, body _make_kernel :82, pallas_call :364). One
// launch tracks all n_blocks code periods (1 ms blocks for GPS L1 C/A,
// GLONASS L1/L2 OF and BeiDou B1I) of C channels. Per channel and block it
// computes what the Pallas kernel computes:
//   * block length ceil((code_length - rem) / step) clipped to [1, blkp],
//     in IEEE f32 (the reference's sample_pos bookkeeping must stay exact);
//   * carrier NCO step carrbase + rint(carr_delta * 2^32/fs), uint32 wrap;
//   * E/P/L rows of the 1/64-chip phase-row table, rint((rem + off) * 64);
//   * the exact-u32 factored LO, k = 64a + r: cos/sin of the coarse angle
//     (phase + a*64*step) and of the fine angle (r*step), each taken from
//     the int32 view of the u32 phase, combined by the angle-sum products
//     (the scan engine's nco.lo_iq_factored numerics; no per-sample
//     sincosf);
//   * carrier wipeoff and the six accumulators IE..QL;
//   * atan2 FLL + Costas PLL (carr_nco += k1 e - k2 e_old - k3 f), the
//     normalized E-L envelope DLL with carrier aiding, and the rem / pos /
//     phase advance. With fll_atan the FLL is the sign-flip-invariant
//     two-quadrant one, atan2(cross * sign(dot), |dot|) (TrackConfig
//     fll_disc "atan", the scan engines' form): BeiDou D1's NH(20) code
//     flips the symbol every 1 ms block, which the atan2 form reads as a
//     frequency error. The Pallas kernel has the atan2 form only.
//
// Design: a latency-first chain, one CTA of 256 threads per channel (no
// cluster). The tap table is int8 [C, R, bp], bp = blkp rounded up to 128
// lanes (zeros past blkp); every tap is +-1, so a product is the sample's
// value with its sign flipped by the tap's sign bit, which is exact. Per
// block b:
//   1. the last four warps each start one bulk copy (TMA, cp.async.bulk)
//      of block b + 1 onto one mbarrier, into the other half of a double
//      buffer in dynamic shared memory: the window from the
//      16-byte-aligned sample at or below pos_{b+1} = pos_b + blk_b (an
//      offset of 0 or 1 sample), and the E, P and L tap rows (rem_{b+1}
//      does not depend on block b's accumulators). A window that reaches
//      past the chunk is written by its warp's lanes instead, with zeros
//      outside it;
//   2. every thread waits on block b's mbarrier (its copies landed during
//      block b - 1); lane l of warp w takes the sample pairs (2c, 2c + 1),
//      c = 32 w + l + 256 q, two steps q per iteration with all their loads
//      in flight: a lane's two fine angles stay the same for the whole
//      block, a warp's step shares one coarse angle, and each warp stops
//      after its own last pair;
//   3. a transposed butterfly of warp shuffles and one CTA barrier; warps
//      0-2 each sum the warps' partials (lane j takes accumulator j, in
//      warp order; no atomics, so two launches on the same inputs are
//      bit-identical);
//   4. the loop update, its discriminators side by side: warp 0 the FLL's
//      (atan2f), warp 1 the PLL's (IEEE division, atanf), warp 2 the DLL's
//      (two sqrtf, a division), joined by a named barrier. Thread 0 runs
//      the carrier filter and hands the next LO phase and step to warps
//      1-4 (a second named barrier), which compute the next block's LO
//      angles (64 fine + one coarse angle per 64 samples of the longest
//      block, one sincosf per thread at GPS rates) while thread 0 runs the
//      code filter and the next geometry and publishes it;
//   5. a second CTA barrier starts the next block.
// Where the two buffers do not fit in shared memory (blkp above ~10,000
// samples), the pairs past the buffered W samples are read from global
// memory in step 2; no blkp up to MAX_BLKP is refused.
//
// What bounds it on an H100: not bytes (the chunk once, one byte per tap,
// ~6 KB of rows per block and channel that stay in L2) nor operations (18
// per sample against 67 TFLOP/s of f32), but the latency of one block's
// dependency chain, since block b+1's length and carrier step wait for
// block b's accumulators: the products, the reduction, the serial loop
// update and two barriers. The design takes the loads off that chain (the
// data lands during the previous block; starting a bulk copy holds its
// warp for a few hundred ns whatever its size, so the four copies go to
// four warps), runs the independent parts of the update and the LO angles
// side by side, and keeps the rest short. Within the chain the products
// are bound by the SM's instruction issue (one SM per channel). With 12
// channels on 12 of 132 SMs there is no SM to spare a block for; more
// channels per launch cost no extra time per block up to 132.
//
// Two instances of one template: the main path's, and one (STAMPS) that
// adds clock64() time per phase, summed over blocks, for chip_smoke.py:
// thread 0's chain, and beside it the window warp's copy start and the LO
// angles.
//
// Numerics: build WITHOUT --use_fast_math (fast math changes the division
// and sinf/cosf, and blksize / sample_pos stop being exact) and with
// -fmad=false, so every multiply-add rounds twice as in the plain PyTorch
// twin (gnsstpu_torch/ops/track_kernel.py::track_chunk_fused_ref). Only
// the order in which the accumulators are summed differs from it.
// Rounding is half-to-even (__float2int_rn), as jnp.round and torch.round.

#include "cluster_track.cuh"

namespace {

constexpr int NF = 16;          // float state lanes (finit / ffin)
constexpr int NOUT = 16;        // output lanes per block and channel
constexpr int NACC = 6;         // accumulators
constexpr int FINE = ctrack::FINE;
constexpr int THREADS = 256;    // per CTA, one CTA per channel
constexpr int NWARPS = THREADS / 32;
// Stamp phases (STAMPS instance), summed over blocks, in SM cycles. Off
// the chain: the window's warp starting its copy, and the LO angles on
// the first angle thread. The chain, thread 0's: the wait on the prefetch
// (with reading the published geometry), products, reduction, loop update,
// and the closing barrier (with what of the angles outlasts the update).
constexpr int NPHASE = 7;
enum {
  P_ISSUE = 0, P_ANGLES, P_WAIT, P_PRODUCTS, P_REDUCE, P_UPDATE, P_BARRIER
};

// Float-state lanes (reference _F_*).
enum {
  F_REM = 0, F_CODE_DELTA, F_CARR_DELTA, F_CARR_NCO, F_OLD_CARR_ERR,
  F_CODE_NCO, F_OLD_CODE_ERR, F_IP_PREV, F_QP_PREV, F_DOPPLER_BASIS,
  F_INV_AID
};

struct Params {
  long long n_samples;
  int n_blocks, C, R, blkp;
  int plane;                    // tap-row stride, plane_stride(blkp)
  int W;                        // samples per buffer half (multiple of 16)
  int n_coarse;                 // coarse angles of the longest block
  float code_length, base_code_step, inv_fs, nco_scale, ph;
  float row_off[3];             // (-spacing, 0, +spacing) + span_chips
  float ang_scale, inv_pi, inv_2pi;
  float k1, k2, k3, c_dll_p, c_dll_i;
  int fll_atan;                 // 1: atan2(cross * sign(dot), |dot|)
};

struct Geometry {
  float step;
  int blk;
  uint32_t cstep;
  int row[3];
};

// What every thread needs of block b, and where block b + 1 starts.
struct Geo {
  int blk, pos, row[3];
  uint32_t ph, cstep;
  int next_pos, next_row[3];
};

// E/P/L tap rows for a block starting at code remainder rem.
__device__ __forceinline__ void tap_rows(float rem, const Params& p,
                                         int (&row)[3]) {
  for (int j = 0; j < 3; ++j) {
    const int r = __float2int_rn((rem + p.row_off[j]) * p.ph);
    row[j] = min(max(r, 0), p.R - 1);
  }
}

// Block geometry from the float state (thread 0 only).
__device__ Geometry geometry(const float* st, uint32_t cbase,
                             const Params& p) {
  Geometry g;
  g.step = p.base_code_step + st[F_CODE_DELTA] * p.inv_fs;
  const float blkf = ceilf((p.code_length - st[F_REM]) / g.step);
  g.blk = min(max(__float2int_rz(blkf), 1), p.blkp);
  g.cstep = cbase + (uint32_t)__float2int_rn(st[F_CARR_DELTA] * p.nco_scale);
  tap_rows(st[F_REM], p, g.row);
  return g;
}

// The code remainder after block g (the loop update's rem).
__device__ __forceinline__ float rem_after(const float* st,
                                           const Geometry& g,
                                           const Params& p) {
  return st[F_REM] + (float)g.blk * g.step - p.code_length;
}

// Block g's geometry and the next block's cursor and rows, which do not
// depend on block g's accumulators (thread 0 only).
__device__ __forceinline__ Geo publish(const float* st, const Geometry& g,
                                       int pos, uint32_t ph,
                                       const Params& p) {
  Geo s;
  s.blk = g.blk;
  s.pos = pos;
  for (int j = 0; j < 3; ++j) s.row[j] = g.row[j];
  s.ph = ph;
  s.cstep = g.cstep;
  s.next_pos = pos + g.blk;
  tap_rows(rem_after(st, g, p), p, s.next_row);
  return s;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// An mbarrier that completes a phase after n arrivals and their bytes.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk copy global -> shared (16-byte aligned, a multiple of 16 bytes)
// that completes its bytes on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Chunk index of the 16-byte-aligned sample at or below chunk index pos:
// pos - off, off in {0, 1}. par: the parity of the chunk's base address in
// 8-byte samples.
__device__ __forceinline__ int window_offset(int pos, int par) {
  return (pos + par) & 1;
}

// One buffer half: the window (W samples from the aligned start), then the
// three tap rows (W lanes each).
struct Half {
  float4* win;
  int8_t* rows;
};

// Start piece q of block (pos, row)'s copies into half h, by the 32
// lanes of one warp: q = 0 the window (W samples from the 16-byte-aligned
// sample at or below pos), q = 1..3 the E/P/L tap row (W taps). Lane 0
// arrives on bar with the piece's bytes and starts one bulk copy (TMA);
// bar completes its phase after the four pieces' arrivals and bytes. A
// window that reaches outside the chunk is written by the warp's lanes
// instead, zeros outside it (the CTA barriers between this call and the
// block's products order those writes), and each lane then fences its
// writes (generic proxy) before any later bulk copy (async proxy) into the
// same half; the CTA barriers in between order the fence before it. A
// bulk copy over what the threads only read needs no fence: the CTA
// barriers between those reads and this call order them.
__device__ __forceinline__ void prefetch(const Half& h, int q, uint64_t* bar,
                                         const float2* __restrict__ chunk,
                                         const int8_t* tabc, int pos,
                                         const int (&row)[3], int par,
                                         const Params& p) {
  const int lane = threadIdx.x & 31;
  if (q > 0) {
    if (lane == 0) {
      mbar_expect(bar, (uint32_t)p.W);
      const int r = q == 1 ? row[0] : q == 2 ? row[1] : row[2];
      bulk_copy(h.rows + (q - 1) * p.W, tabc + (size_t)r * p.plane,
                (uint32_t)p.W, bar);
    }
    return;
  }
  const long long a = (long long)pos - window_offset(pos, par);
  const bool inside = a >= 0 && a + p.W <= p.n_samples;
  if (!inside) {
    float2* w = reinterpret_cast<float2*>(h.win);
    for (int i = lane; i < p.W; i += 32) {
      const long long si = a + i;
      w[i] = si >= 0 && si < p.n_samples ? chunk[si] : make_float2(0.f, 0.f);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (lane == 0) {
    const uint32_t wbytes = inside ? 8u * (uint32_t)p.W : 0u;
    mbar_expect(bar, wbytes);
    if (inside) bulk_copy(h.win, chunk + a, wbytes, bar);
  }
}

// LO angles of a block, by NT threads (t: the calling thread's index
// among them): (cos, sin) of the 64 fine angles (r * step) and of the na
// coarse angles (phase + a * 64 * step), each from the int32 view of the
// u32 phase; one sincosf per thread while 64 + na <= NT, the same code on
// every lane.
template <int NT>
__device__ __forceinline__ void block_angles(float2* fine, float2* coarse,
                                             int na, uint32_t ph,
                                             uint32_t cs, float ang_scale,
                                             int t) {
  for (int i = t; i < FINE + na; i += NT) {
    const uint32_t k = i < FINE ? (uint32_t)i * cs
                                : ph + (uint32_t)(i - FINE) * (cs * 64u);
    float sn, co;
    sincosf(__int2float_rn((int32_t)k) * ang_scale, &sn, &co);
    if (i < FINE)
      fine[i] = make_float2(co, sn);
    else
      coarse[i - FINE] = make_float2(co, sn);
  }
}

// Named CTA barrier id over n threads (whole warps, converged): sync waits
// for all n, arrive only signals. Either orders the calling thread's
// earlier shared-memory writes before the waiters' later reads.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// v times a +-1 tap whose sign bit is bit 31 of s: v with its sign flipped,
// the exact product; (s & 0x80000000) ^ v in one lop3 (left to itself the
// compiler masks once and xors twice per tap: one instruction more per
// tap and sample).
__device__ __forceinline__ float by_tap(float v, uint32_t s) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;"
      : "=r"(r)
      : "r"(s), "n"(0x80000000u), "r"(__float_as_uint(v)));
  return __uint_as_float(r);
}

// acc += the baseband of one sample x (coarse angle cc, fine angle f)
// times its three taps (sign bits in bit 31 of t0, t1, t2).
__device__ __forceinline__ void accumulate(float (&acc)[NACC], float2 x,
                                           float2 cc, float2 f, uint32_t t0,
                                           uint32_t t1, uint32_t t2) {
  const float lo_c = cc.x * f.x - cc.y * f.y;
  const float lo_s = cc.y * f.x + cc.x * f.y;
  const float bi = x.x * lo_c + x.y * lo_s;
  const float bq = x.y * lo_c - x.x * lo_s;
  acc[0] += by_tap(bi, t0);
  acc[1] += by_tap(bq, t0);
  acc[2] += by_tap(bi, t1);
  acc[3] += by_tap(bq, t1);
  acc[4] += by_tap(bi, t2);
  acc[5] += by_tap(bq, t2);
}

// Pair c of a block: its samples k = 2c and 2c + 1 (x0, x1) and their
// taps, byte 0 (k) and byte 1 (k + 1) of tE, tP, tL.
struct Pair {
  float2 x0, x1;
  uint32_t tE, tP, tL;
};

// Pair c from the buffer half: the window starts off (0 or 1) samples
// before the block, so sample k is window sample k + off; the rows start at
// the block.
__device__ __forceinline__ Pair buffered_pair(const Half& h, int W, int off,
                                              int c) {
  const float2* w = reinterpret_cast<const float2*>(h.win) + 2 * c + off;
  const int8_t* r = h.rows + 2 * c;
  Pair q;
  q.x0 = w[0];
  q.x1 = w[1];
  q.tE = *reinterpret_cast<const uint16_t*>(r);
  q.tP = *reinterpret_cast<const uint16_t*>(r + W);
  q.tL = *reinterpret_cast<const uint16_t*>(r + 2 * W);
  return q;
}

// Pair c from global memory (past the buffer), zeros outside the chunk.
__device__ __forceinline__ Pair global_pair(const float2* __restrict__ chunk,
                                            const int8_t* tabc,
                                            const Geo& geo, const Params& p,
                                            int c) {
  const long long i0 = (long long)geo.pos + 2 * c;
  const int k0 = min(2 * c, p.blkp - 1), k1 = min(2 * c + 1, p.blkp - 1);
  Pair q;
  q.x0 = i0 < p.n_samples ? __ldg(chunk + i0) : make_float2(0.f, 0.f);
  q.x1 = i0 + 1 < p.n_samples ? __ldg(chunk + i0 + 1) : make_float2(0.f, 0.f);
  uint32_t t[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int8_t* row = tabc + (size_t)geo.row[j] * p.plane;
    t[j] = (uint32_t)(uint8_t)__ldg(row + k0)
           | (uint32_t)(uint8_t)__ldg(row + k1) << 8;
  }
  q.tE = t[0];
  q.tP = t[1];
  q.tL = t[2];
  return q;
}

// acc += pair c's products (cc: the pair's 64-sample group's coarse angle;
// f0, f1: the fine angles of its two samples); samples at or past blk, or
// of a pair that is not ok, count as zero.
__device__ __forceinline__ void pair_products(float (&acc)[NACC], Pair q,
                                              bool ok, int c, int blk,
                                              float2 cc, float2 f0,
                                              float2 f1) {
  if (!ok || 2 * c >= blk) q.x0 = make_float2(0.f, 0.f);
  if (!ok || 2 * c + 1 >= blk) q.x1 = make_float2(0.f, 0.f);
  accumulate(acc, q.x0, cc, f0, q.tE << 24, q.tP << 24, q.tL << 24);
  accumulate(acc, q.x1, cc, f1, q.tE << 16, q.tP << 16, q.tL << 16);
}

// Products of block geo whose window starts off samples before it: pair c
// = base + lane of a warp's step, so a lane's two fine angles stay the
// same for the whole block and a warp's step shares one coarse angle. The
// pairs the buffer holds, SUB CTA steps (STEP pairs each) per iteration
// with all their loads in flight together (a third step is mostly masked
// at GPS block lengths, and masked steps cost issue slots all the same),
// then the rest from global memory.
__device__ __forceinline__ void products(float (&acc)[NACC], const Half& h,
                                         int off, const float2* fine,
                                         const float2* coarse,
                                         const float2* __restrict__ chunk,
                                         const int8_t* tabc, const Geo& geo,
                                         const Params& p) {
  constexpr int STEP = THREADS;                  // pairs per CTA step
  constexpr int SUB = 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int blk = geo.blk;
  const int n_pairs = (blk + 1) >> 1;
  // Pairs inside the buffer: window samples 2c + 1 + off < W.
  const int n_in = min(n_pairs, (p.W - off) >> 1);
  const float2 f0 = fine[2 * lane], f1 = fine[2 * lane + 1];
#pragma unroll 1
  for (int base = warp * 32; base < n_in; base += SUB * STEP) {
    Pair q[SUB];
    float2 cc[SUB];
#pragma unroll
    for (int u = 0; u < SUB; ++u) {
      const int c = base + u * STEP + lane;
      q[u] = buffered_pair(h, p.W, off, c < n_in ? c : 0);
      cc[u] = coarse[min((base + u * STEP) >> 5, p.n_coarse - 1)];
    }
#pragma unroll
    for (int u = 0; u < SUB; ++u) {
      const int c = base + u * STEP + lane;
      pair_products(acc, q[u], c < n_in, c, blk, cc[u], f0, f1);
    }
  }
  // Past the buffer: from the warp's first step that reaches n_in.
  const int k0 = max(0, (n_in - 31 - warp * 32 + STEP - 1) / STEP);
#pragma unroll 1
  for (int base = warp * 32 + k0 * STEP; base < n_pairs; base += STEP) {
    const int c = base + lane;
    const bool ok = c >= n_in && c < n_pairs;
    pair_products(acc, global_pair(chunk, tabc, geo, p, ok ? c : 0), ok, c,
                  blk, coarse[min(base >> 5, p.n_coarse - 1)], f0, f1);
  }
}

// Dynamic shared memory: two window halves (W samples each), two row
// halves (3 W int8 each), the 64 fine and n_coarse coarse (cos, sin).
__host__ __device__ inline size_t win_bytes(int W) {
  return (size_t)8 * W;
}
__host__ __device__ inline size_t rows_bytes(int W) {
  return ((size_t)3 * W + 127) / 128 * 128;
}
__host__ __device__ inline size_t smem_bytes(int W, int n_coarse) {
  return 2 * win_bytes(W) + 2 * rows_bytes(W)
         + (size_t)(FINE + n_coarse) * 8;
}

template <bool STAMPS>
__global__ void __launch_bounds__(THREADS, 1)
track_fused_kernel(const float2* __restrict__ chunk,
                   const int8_t* __restrict__ tab,
                   const int* __restrict__ pos0,
                   const float* __restrict__ finit,
                   const long long* __restrict__ cinit,
                   const long long* __restrict__ carrbase,
                   float* __restrict__ out, float* __restrict__ ffin,
                   int* __restrict__ pos_out,
                   long long* __restrict__ cph_out,
                   long long* __restrict__ stamps, Params p) {
  // Roles after the reduction: warp 0 the FLL discriminator and thread 0's
  // filters and geometry; warps 1 and 2 the PLL's and the DLL's
  // discriminators; warps 1..ANG the LO angles.
  constexpr int ANG = 4;
  // The last four warps start a block's four copies, one each.
  constexpr int COPY0 = NWARPS - 4;
  // Named barriers (0 is __syncthreads), each warp 0's with: the PLL's
  // and the DLL's discriminators (warps 1, 2), the next LO phase and step
  // (the angle warps).
  constexpr int BAR_ERR = 1, BAR_LO = 2;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(128) unsigned char s_dyn[];
  const size_t wb = win_bytes(p.W), rb = rows_bytes(p.W);
  auto half = [&](int h) {
    return Half{reinterpret_cast<float4*>(s_dyn + h * wb),
                reinterpret_cast<int8_t*>(s_dyn + 2 * wb + h * rb)};
  };
  float2* s_fine = reinterpret_cast<float2*>(s_dyn + 2 * wb + 2 * rb);
  float2* s_coarse = s_fine + FINE;
  __shared__ float s_part[NWARPS][NACC];
  __shared__ float s_err[2];                    // carr_err, code_err
  __shared__ uint32_t s_lo[2];                  // next LO phase, step
  __shared__ Geo s_geo;
  __shared__ __align__(8) uint64_t s_full[2];   // one mbarrier per half

  const int8_t* tabc = tab + (size_t)c * p.R * p.plane;
  const int par = (int)((reinterpret_cast<uintptr_t>(chunk) >> 3) & 1);

  // Loop-filter state and cursors live in thread 0's registers.
  float st[NF];
  uint32_t ph = 0, cbase = 0;
  int pos = 0;
  Geometry g;
  long long cyc[NPHASE] = {};
  long long t0 = 0;
  auto stamp = [&](int phase) {
    if (STAMPS && tid == 0) {
      const long long t = clock64();
      cyc[phase] += t - t0;
      t0 = t;
    }
  };
  if (tid == 0) {
    mbar_init(&s_full[0], 4);
    mbar_init(&s_full[1], 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < NF; ++i) st[i] = finit[c * NF + i];
    ph = (uint32_t)cinit[c];
    cbase = (uint32_t)carrbase[c];
    pos = pos0[c];
    g = geometry(st, cbase, p);
    s_geo = publish(st, g, pos, ph, p);
  }
  __syncthreads();
  // Block 0's copies and LO angles (all coarse angles of the longest
  // block, as in the loop).
  if (p.n_blocks > 0) {
    const Geo geo = s_geo;
    if (warp >= COPY0)
      prefetch(half(0), warp - COPY0, &s_full[0], chunk, tabc, geo.pos,
               geo.row, par, p);
    block_angles<THREADS>(s_fine, s_coarse, p.n_coarse, geo.ph, geo.cstep,
                          p.ang_scale, tid);
  }
  __syncthreads();
  if (STAMPS && tid == 0) t0 = clock64();

  for (int b = 0; b < p.n_blocks; ++b) {
    const int cur = b & 1;
    const Geo geo = s_geo;
    // 1. Block b + 1's copies, into the other half (last read by block
    //    b - 1, before its first barrier), by the last four warps.
    if (warp >= COPY0 && b + 1 < p.n_blocks) {
      long long ti = 0;
      if (STAMPS && tid == COPY0 * 32) ti = clock64();
      prefetch(half(cur ^ 1), warp - COPY0, &s_full[cur ^ 1], chunk, tabc,
               geo.next_pos, geo.next_row, par, p);
      if (STAMPS && tid == COPY0 * 32) cyc[P_ISSUE] += clock64() - ti;
    }
    // 2. Block b's window and rows (the half's (b / 2)-th fill).
    mbar_wait(&s_full[cur], (uint32_t)(b >> 1) & 1u);
    stamp(P_WAIT);

    float acc[NACC] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    products(acc, half(cur), window_offset(geo.pos, par), s_fine,
                      s_coarse, chunk, tabc, geo, p);
    stamp(P_PRODUCTS);

    // 3. Reduction: a transposed butterfly (at each of the first three
    //    levels a lane keeps half of its values and adds its partner's
    //    copy of them; acc j ends in lanes 4j..4j+3 after 9 shuffles),
    //    then warps 0-2 each over the warps (the same sums in the same
    //    order).
    {
      float v8[8] = {acc[0], acc[1], acc[2], acc[3], acc[4], acc[5], 0.f,
                     0.f};
#pragma unroll
      for (int hw = 4; hw >= 1; hw >>= 1) {
        const bool up = lane & (4 * hw);
#pragma unroll
        for (int i = 0; i < hw; ++i) {
          const float mine = up ? v8[i + hw] : v8[i];
          const float give = up ? v8[i] : v8[i + hw];
          v8[i] = mine + __shfl_xor_sync(0xffffffffu, give, 4 * hw);
        }
      }
      v8[0] += __shfl_xor_sync(0xffffffffu, v8[0], 2);
      v8[0] += __shfl_xor_sync(0xffffffffu, v8[0], 1);
      if ((lane & 3) == 0 && (lane >> 2) < NACC)
        s_part[warp][lane >> 2] = v8[0];
    }
    __syncthreads();
    float v[NACC] = {};
    if (warp < 3) {
      float tot = 0.f;
      if (lane < NACC)
        for (int w = 0; w < NWARPS; ++w) tot += s_part[w][lane];
#pragma unroll
      for (int j = 0; j < NACC; ++j) v[j] = __shfl_sync(0xffffffffu, tot, j);
    }
    const float ie = v[0], qe = v[1], ip = v[2], qp = v[3], il = v[4],
                ql = v[5];

    // 4. The loop update, its three discriminators side by side.
    if (warp == 0) {
      stamp(P_REDUCE);
      float freq_err = 0.f;
      if (lane == 0) {
        const float ip_prev = st[F_IP_PREV], qp_prev = st[F_QP_PREV];
        const float cross = ip * qp_prev - ip_prev * qp;
        const float dot = ip * ip_prev + qp * qp_prev;
        const float flip = !p.fll_atan ? 1.f
                           : (dot > 0.f ? 1.f : (dot < 0.f ? -1.f : 0.f));
        freq_err = atan2f(cross * flip, fabsf(dot)) * p.inv_pi;
      }
      __syncwarp();
      bar_sync(BAR_ERR, 96);
      float carr_err = 0.f, carr_nco = 0.f, carr_delta = 0.f;
      if (lane == 0) {
        carr_err = s_err[0];
        carr_nco = st[F_CARR_NCO] + p.k1 * carr_err
                   - p.k2 * st[F_OLD_CARR_ERR] - p.k3 * freq_err;
        carr_delta = st[F_DOPPLER_BASIS] + carr_nco;
        // The next block's LO phase and step for the angle warps: the
        // step by geometry()'s own operations, ahead of it.
        s_lo[0] = ph + (uint32_t)g.blk * g.cstep;
        s_lo[1] = cbase + (uint32_t)__float2int_rn(carr_delta * p.nco_scale);
      }
      __syncwarp();
      bar_arrive(BAR_LO, 32 * (1 + ANG));
      if (lane == 0) {
        const float code_err = s_err[1];
        const float code_nco = st[F_CODE_NCO]
                               + p.c_dll_p * (code_err - st[F_OLD_CODE_ERR])
                               + code_err * p.c_dll_i;
        const float code_delta = -code_nco + carr_delta * st[F_INV_AID];
        const float rem = rem_after(st, g, p);

        // Output lanes in the reference's O_* order (IE..QL, carr_doppler,
        // code_freq_delta, rem, blksize, DLL disc / filt, PLL disc / filt).
        float4* o = reinterpret_cast<float4*>(out + ((size_t)b * p.C + c)
                                                        * NOUT);
        o[0] = make_float4(ie, qe, ip, qp);
        o[1] = make_float4(il, ql, carr_delta, code_delta);
        o[2] = make_float4(rem, (float)g.blk, code_err, code_nco);
        o[3] = make_float4(carr_err, carr_nco, 0.f, 0.f);

        st[F_REM] = rem;
        st[F_CODE_DELTA] = code_delta;
        st[F_CARR_DELTA] = carr_delta;
        st[F_CARR_NCO] = carr_nco;
        st[F_OLD_CARR_ERR] = carr_err;
        st[F_CODE_NCO] = code_nco;
        st[F_OLD_CODE_ERR] = code_err;
        st[F_IP_PREV] = ip;
        st[F_QP_PREV] = qp;
        ph += (uint32_t)g.blk * g.cstep;
        pos += g.blk;

        g = geometry(st, cbase, p);
        s_geo = publish(st, g, pos, ph, p);
      }
      __syncwarp();
      stamp(P_UPDATE);
    } else if (warp <= ANG) {
      if (warp == 1) {
        if (lane == 0) {
          const float denom = fabsf(ip) < 1e-10f ? 1e-10f : ip;
          s_err[0] = atanf(qp / denom) * p.inv_2pi;
        }
        __syncwarp();
        bar_arrive(BAR_ERR, 96);
      } else if (warp == 2) {
        if (lane == 0) {
          const float e_env = sqrtf(ie * ie + qe * qe);
          const float l_env = sqrtf(il * il + ql * ql);
          s_err[1] = (e_env - l_env) / fmaxf(e_env + l_env, 1e-10f);
        }
        __syncwarp();
        bar_arrive(BAR_ERR, 96);
      }
      // 5. The next block's LO angles (all coarse angles of the longest
      //    block: its length is not known yet), beside thread 0's DLL
      //    filter and geometry.
      bar_sync(BAR_LO, 32 * (1 + ANG));
      if (b + 1 < p.n_blocks) {
        long long ta = 0;
        if (STAMPS && tid == 32) ta = clock64();
        block_angles<32 * ANG>(s_fine, s_coarse, p.n_coarse, s_lo[0],
                               s_lo[1], p.ang_scale, tid - 32);
        if (STAMPS && tid == 32) cyc[P_ANGLES] += clock64() - ta;
      }
    }
    // 6. The next block's geometry and angles are published.
    __syncthreads();
    stamp(P_BARRIER);
  }

  if (tid == 0) {
    for (int i = 0; i < NF; ++i) ffin[c * NF + i] = st[i];
    pos_out[c] = pos;
    cph_out[c] = (long long)ph;
  }
  if (STAMPS)
    for (int i = 0; i < NPHASE; ++i) {
      const bool mine = i == P_ISSUE    ? tid == COPY0 * 32
                        : i == P_ANGLES ? tid == 32
                                        : tid == 0;
      if (mine) stamps[c * NPHASE + i] = cyc[i];
    }
}

// Samples per buffer half: blkp rounded up to 16, or as many (a multiple
// of 128) as the card's shared memory holds for two halves beside the
// kernel's static shared memory. Returns 0 on an error.
int buffered_samples(const void* fn, int blkp, int n_coarse,
                     cudaError_t* err) {
  int dev = 0, optin = 0;
  cudaFuncAttributes a;
  if ((*err = cudaGetDevice(&dev)) != cudaSuccess) return 0;
  if ((*err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return 0;
  if ((*err = cudaFuncGetAttributes(&a, fn)) != cudaSuccess) return 0;
  const size_t room = (size_t)optin - a.sharedSizeBytes;
  int W = (blkp + 15) / 16 * 16;
  if (smem_bytes(W, n_coarse) > room) W = W / 128 * 128;
  while (W >= 128 && smem_bytes(W, n_coarse) > room) W -= 128;
  if (W < 16) {
    *err = cudaErrorInvalidValue;
    return 0;
  }
  return W;
}

// Dynamic shared bytes of a launch at this blkp (and W), after opting the
// kernel in to them.
cudaError_t prepare(const void* fn, int blkp, int* W, size_t* bytes) {
  const int n_coarse = (blkp + FINE - 1) / FINE;
  cudaError_t err = cudaSuccess;
  *W = buffered_samples(fn, blkp, n_coarse, &err);
  if (err != cudaSuccess) return err;
  *bytes = smem_bytes(*W, n_coarse);
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

}  // namespace

// stamps: null for the main path's instance; else int64 [C, 7] receives
// the STAMPS instance's cycles per phase, summed over blocks (P_* order:
// the window warp's and the first angle thread's, then thread 0's chain).
// start_event: null, or a CUDA event recorded on the stream just before
// the launch, after the host's preparation (a timing event pair's start).
extern "C" int track_chunk_fused_cuda(
    const float* chunk, long long n_samples, const int8_t* tab,
    const int* pos0, const float* finit, const long long* cinit,
    const long long* carrbase, float* out, float* ffin, int* pos_out,
    long long* cph_out, long long* stamps, int C, int n_blocks, int R,
    int blkp, int code_length, float base_code_step, float inv_fs,
    float nco_scale, float ph, float row_off_e, float row_off_p,
    float row_off_l, float ang_scale, float inv_pi, float inv_2pi, float k1,
    float k2, float k3, float c_dll_p, float c_dll_i, int fll_atan,
    void* stream, void* start_event) {
  const void* fn = stamps ? (const void*)&track_fused_kernel<true>
                          : (const void*)&track_fused_kernel<false>;
  if (blkp < 1 || blkp > ctrack::MAX_BLKP || R < 1 || C < 0 || n_blocks < 0)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  Params p;
  size_t bytes = 0;
  cudaError_t err = prepare(fn, blkp, &p.W, &bytes);
  if (err != cudaSuccess) return (int)err;
  p.n_samples = n_samples;
  p.n_blocks = n_blocks;
  p.C = C;
  p.R = R;
  p.blkp = blkp;
  p.plane = ctrack::plane_stride(blkp);
  p.n_coarse = (blkp + FINE - 1) / FINE;
  p.code_length = (float)code_length;
  p.base_code_step = base_code_step;
  p.inv_fs = inv_fs;
  p.nco_scale = nco_scale;
  p.ph = ph;
  p.row_off[0] = row_off_e;
  p.row_off[1] = row_off_p;
  p.row_off[2] = row_off_l;
  p.ang_scale = ang_scale;
  p.inv_pi = inv_pi;
  p.inv_2pi = inv_2pi;
  p.k1 = k1;
  p.k2 = k2;
  p.k3 = k3;
  p.c_dll_p = c_dll_p;
  p.c_dll_i = c_dll_i;
  p.fll_atan = fll_atan;
  const float2* x = reinterpret_cast<const float2*>(chunk);
  void* args[] = {(void*)&x,      (void*)&tab,     (void*)&pos0,
                  (void*)&finit,  (void*)&cinit,   (void*)&carrbase,
                  (void*)&out,    (void*)&ffin,    (void*)&pos_out,
                  (void*)&cph_out, (void*)&stamps, (void*)&p};
  if (start_event != nullptr) {
    err = cudaEventRecord((cudaEvent_t)start_event, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaLaunchKernel(fn, dim3((unsigned)C), dim3((unsigned)THREADS),
                         args, bytes, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// What the main path's instance uses at this blkp and how many of its CTAs
// an SM holds at once: info = {registers, static shared bytes, local
// bytes, threads per CTA, dynamic shared bytes,
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, buffered samples W}.
extern "C" int track_fused_info(int blkp, int* info) {
  const void* fn = (const void*)&track_fused_kernel<false>;
  if (blkp < 1 || blkp > ctrack::MAX_BLKP)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  int W = 0;
  size_t bytes = 0;
  if ((err = prepare(fn, blkp, &W, &bytes)) != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                      bytes);
  if (err != cudaSuccess) return (int)err;
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = (int)a.localSizeBytes;
  info[3] = THREADS;
  info[4] = (int)bytes;
  info[5] = per_sm;
  info[6] = W;
  return 0;
}

extern "C" const char* track_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
