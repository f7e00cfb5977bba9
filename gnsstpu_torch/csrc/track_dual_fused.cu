// K3 on Hopper: fused GLONASS L3OC dual-code (pilot + data) tracker.
//
// Replaces the TPU Pallas kernel gnsstpu/ops/track_kernel.py
// (track_chunk_dual_fused :608, body _make_dual_kernel :403, pallas_call
// :687). One launch tracks all n_blocks code periods (1 ms L3OC blocks,
// ~24,000 samples at 24 Msps) of C channels. Per channel and block it
// computes what the Pallas kernel computes:
//   * block length ceil((code_length - rem) / step) clipped to [1, blkp],
//     in IEEE f32 (the sample_pos bookkeeping must stay exact);
//   * carrier NCO step carrbase + rint(carr_delta * 2^32/fs), uint32 wrap;
//   * one tap row per block, rint((rem + span) * ph) clipped to [0, R-1]
//     (round half to even); the row holds six planes, pilot E/P/L and data
//     E/P/L, with the E/L spacing baked in, so there is no per-tap row
//     offset (unlike K1);
//   * the exact-u32 factored LO, k = 64a + r (64 fine x ceil(blkp/64)
//     coarse sincosf from the int32 view of the u32 phase, combined by the
//     angle-sum products), as K1 and K2;
//   * carrier wipeoff of samples [pos, pos + blk), zeros past the chunk's
//     end (the reference pads the chunk with 256 zero samples), and the
//     twelve accumulators I/Q x {pilot, data} x {E, P, L};
//   * the L3 loop wiring: a Costas PLL atan(Q_P / I_P) on the pilot prompt,
//     the flip-invariant 2-quadrant FLL atan(cross / dot) over consecutive
//     pilot prompts (with the TPU body's 1e-30 guard), the DLL on the
//     normalized pilot E-L envelopes with the code clock aided by
//     carrier / 117.5; then the rem / pos / phase advance.
//
// Design. As K1 and K2: one CUDA block per channel loops over the blocks
// in order (the TPU's sequential grid axis), the loop-filter state lives in
// thread 0's registers, and thread 0 hands the next block's geometry to the
// other threads through shared memory. 512 threads stride over the
// ~24,000-sample block (~47 samples each), keeping twelve register partial
// sums, reduced by warp shuffles and then through a 12 x 16 shared array.
// The tap table is int8 [C, R, 6, blkp]: the taps are exactly +-1, so each
// is widened to f32 before it multiplies the baseband sample and no
// product changes; each plane's row is contiguous, so a warp's loads are
// coalesced. At 24 Msps (R = 80, blkp = 24,002) that is 11.5 MB per
// channel against 61.6 MB in the TPU's f32 [.., 8, BP] layout. Rows are
// plain loads. The TPU's one-block-ahead row DMA, its aligned-slice + roll
// window, the "expand" matmul, channel tiling and the _atan polynomial
// were Mosaic mechanics and are not carried over.
//
// What bounds it on an H100: each channel is a sequential chain of
// n_blocks reductions with three barriers and a serial loop-filter update
// on one thread per block, and 12 channels keep only 12 of the 132 SMs
// busy. So latency and occupancy bound it, not bytes (the chunk once plus
// ~144 KB of tap rows per block and channel) or FLOPs (36 per sample and
// channel against 67 TFLOP/s of f32).
//
// Numerics: build WITHOUT --use_fast_math and with -fmad=false, so the
// block geometry rounds as in the plain PyTorch twin
// (gnsstpu_torch/ops/track_kernel.py::track_chunk_dual_fused_ref).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NF = 16;          // float state lanes (finit / ffin)
constexpr int NOUT = 24;        // output lanes per block and channel
constexpr int NACC = 12;        // accumulators
constexpr int NPLANE = 6;       // tap planes per row
constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int FINE = 64;        // LO factor b: k = 64 a + r
constexpr int MAX_COARSE = 512; // coarse angles: blkp <= 32768
constexpr int NCONST = 14;      // f32 constants (track_kernel.DUAL_CONSTS)

// Float-state lanes (reference _F_*).
enum {
  F_REM = 0, F_CODE_DELTA, F_CARR_DELTA, F_CARR_NCO, F_OLD_CARR_ERR,
  F_CODE_NCO, F_OLD_CODE_ERR, F_IP_PREV, F_QP_PREV, F_DOPPLER_BASIS,
  F_INV_AID
};
// Output lanes (reference OD_*); 0..11 are the accumulators.
enum {
  OD_CARR_DOPPLER = 12, OD_CODE_FREQ_DELTA, OD_REM, OD_BLKSIZE,
  OD_DLL_DISC, OD_PLL_DISC
};

struct Params {
  long long n_samples;
  int n_blocks, C, R, blkp;
  // In the order of gnsstpu_torch.ops.track_kernel.DUAL_CONSTS.
  float code_length, base_code_step, inv_fs, nco_scale, ph, span,
      ang_scale, inv_pi, inv_2pi, k1, k2, k3, c_dll_p, c_dll_i;
};

struct Geometry {
  float step;
  int blk;
  uint32_t cstep;
  int row;
};

// Block geometry from the float state (thread 0 only).
__device__ Geometry geometry(const float* st, uint32_t cbase,
                             const Params& p) {
  Geometry g;
  g.step = p.base_code_step + st[F_CODE_DELTA] * p.inv_fs;
  const float blkf = ceilf((p.code_length - st[F_REM]) / g.step);
  g.blk = min(max(__float2int_rz(blkf), 1), p.blkp);
  g.cstep = cbase + (uint32_t)__float2int_rn(st[F_CARR_DELTA] * p.nco_scale);
  const int r = __float2int_rn((st[F_REM] + p.span) * p.ph);
  g.row = min(max(r, 0), p.R - 1);
  return g;
}

__global__ void __launch_bounds__(THREADS)
track_dual_fused_kernel(const float2* __restrict__ chunk,
                        const int8_t* __restrict__ tab,
                        const int* __restrict__ pos0,
                        const float* __restrict__ finit,
                        const long long* __restrict__ cinit,
                        const long long* __restrict__ carrbase,
                        float* __restrict__ out, float* __restrict__ ffin,
                        int* __restrict__ pos_out,
                        long long* __restrict__ cph_out, Params p) {
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  __shared__ float s_ca[MAX_COARSE], s_sa[MAX_COARSE];
  __shared__ float s_cr[FINE], s_sr[FINE];
  __shared__ float s_part[NACC][NWARPS];
  __shared__ int s_blk, s_pos, s_row;
  __shared__ uint32_t s_ph, s_cstep;

  const size_t plane = (size_t)p.blkp;
  const int8_t* tabc = tab + (size_t)c * p.R * NPLANE * plane;
  const int n_coarse = (p.blkp + FINE - 1) / FINE;

  // Loop-filter state and cursors live in thread 0's registers.
  float st[NF];
  uint32_t ph = 0, cbase = 0;
  int pos = 0;
  Geometry g;
  if (tid == 0) {
    for (int i = 0; i < NF; ++i) st[i] = finit[c * NF + i];
    ph = (uint32_t)cinit[c];
    cbase = (uint32_t)carrbase[c];
    pos = pos0[c];
    g = geometry(st, cbase, p);
    s_blk = g.blk;
    s_pos = pos;
    s_ph = ph;
    s_cstep = g.cstep;
    s_row = g.row;
  }
  __syncthreads();

  for (int b = 0; b < p.n_blocks; ++b) {
    const int blk = s_blk;
    const int pb = s_pos;
    const uint32_t phb = s_ph;
    const uint32_t cs = s_cstep;
    const int8_t* row = tabc + (size_t)s_row * NPLANE * plane;

    // Factored LO: 64 fine + n_coarse coarse angles, one sincos each.
    for (int i = tid; i < FINE + n_coarse; i += THREADS) {
      float s, co;
      if (i < FINE) {
        const uint32_t kr = (uint32_t)i * cs;
        sincosf(__int2float_rn((int32_t)kr) * p.ang_scale, &s, &co);
        s_cr[i] = co;
        s_sr[i] = s;
      } else {
        const int a = i - FINE;
        const uint32_t ka = phb + (uint32_t)a * (cs * 64u);
        sincosf(__int2float_rn((int32_t)ka) * p.ang_scale, &s, &co);
        s_ca[a] = co;
        s_sa[a] = s;
      }
    }
    __syncthreads();

    float acc[NACC];
#pragma unroll
    for (int j = 0; j < NACC; ++j) acc[j] = 0.f;
    for (int k = tid; k < blk; k += THREADS) {
      const long long si = (long long)pb + k;
      float2 x = make_float2(0.f, 0.f);
      if (si >= 0 && si < p.n_samples) x = chunk[si];
      const int a = k >> 6, r = k & 63;
      const float lo_c = s_ca[a] * s_cr[r] - s_sa[a] * s_sr[r];
      const float lo_s = s_sa[a] * s_cr[r] + s_ca[a] * s_sr[r];
      const float bi = x.x * lo_c + x.y * lo_s;
      const float bq = x.y * lo_c - x.x * lo_s;
#pragma unroll
      for (int j = 0; j < NPLANE; ++j) {
        const float t = (float)row[j * plane + k];
        acc[2 * j] += t * bi;
        acc[2 * j + 1] += t * bq;
      }
    }
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[j] += __shfl_down_sync(0xffffffffu, acc[j], off);
      if (lane == 0) s_part[j][warp] = acc[j];
    }
    __syncthreads();

    if (tid == 0) {
      float v[NACC];
      for (int j = 0; j < NACC; ++j) {
        float s = 0.f;
        for (int w = 0; w < NWARPS; ++w) s += s_part[j][w];
        v[j] = s;
      }
      const float ie = v[0], qe = v[1], ip = v[2], qp = v[3], il = v[4],
                  ql = v[5];
      const float ip_prev = st[F_IP_PREV], qp_prev = st[F_QP_PREV];
      const float cross = ip * qp_prev - ip_prev * qp;
      const float dot = ip * ip_prev + qp * qp_prev;
      const float safe = fabsf(dot) < 1e-30f ? (dot < 0.f ? -1e-30f : 1e-30f)
                                             : dot;
      const float freq_err = atanf(cross / safe) * p.inv_pi;
      const float denom = fabsf(ip) < 1e-10f ? 1e-10f : ip;
      const float carr_err = atanf(qp / denom) * p.inv_2pi;
      const float carr_nco = st[F_CARR_NCO] + p.k1 * carr_err
                             - p.k2 * st[F_OLD_CARR_ERR] - p.k3 * freq_err;
      const float carr_delta = st[F_DOPPLER_BASIS] + carr_nco;
      const float e_env = sqrtf(ie * ie + qe * qe);
      const float l_env = sqrtf(il * il + ql * ql);
      const float code_err = (e_env - l_env) / fmaxf(e_env + l_env, 1e-10f);
      const float code_nco = st[F_CODE_NCO]
                             + p.c_dll_p * (code_err - st[F_OLD_CODE_ERR])
                             + code_err * p.c_dll_i;
      const float code_delta = -code_nco + carr_delta * st[F_INV_AID];
      const float bsf = (float)g.blk;
      const float rem = st[F_REM] + bsf * g.step - p.code_length;

      float* o = out + ((size_t)b * p.C + c) * NOUT;
      for (int j = 0; j < NACC; ++j) o[j] = v[j];
      o[OD_CARR_DOPPLER] = carr_delta;
      o[OD_CODE_FREQ_DELTA] = code_delta;
      o[OD_REM] = rem;
      o[OD_BLKSIZE] = bsf;
      o[OD_DLL_DISC] = code_err;
      o[OD_PLL_DISC] = carr_err;
      for (int j = OD_PLL_DISC + 1; j < NOUT; ++j) o[j] = 0.f;

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
      s_blk = g.blk;
      s_pos = pos;
      s_ph = ph;
      s_cstep = g.cstep;
      s_row = g.row;
    }
    __syncthreads();
  }

  if (tid == 0) {
    for (int i = 0; i < NF; ++i) ffin[c * NF + i] = st[i];
    pos_out[c] = pos;
    cph_out[c] = (long long)ph;
  }
}

}  // namespace

extern "C" int track_chunk_dual_fused_cuda(
    const float* chunk, long long n_samples, const int8_t* tab,
    const int* pos0, const float* finit, const long long* cinit,
    const long long* carrbase, float* out, float* ffin, int* pos_out,
    long long* cph_out, int C, int n_blocks, int R, int blkp,
    const float* consts, int n_consts, void* stream) {
  if (n_consts != NCONST || blkp < 1 || blkp > MAX_COARSE * FINE || R < 1 ||
      C < 0 || n_blocks < 0)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  Params p;
  p.n_samples = n_samples;
  p.n_blocks = n_blocks;
  p.C = C;
  p.R = R;
  p.blkp = blkp;
  float* dst[NCONST] = {
      &p.code_length, &p.base_code_step, &p.inv_fs, &p.nco_scale, &p.ph,
      &p.span, &p.ang_scale, &p.inv_pi, &p.inv_2pi, &p.k1, &p.k2, &p.k3,
      &p.c_dll_p, &p.c_dll_i};
  for (int i = 0; i < NCONST; ++i) *dst[i] = consts[i];
  track_dual_fused_kernel<<<C, THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(chunk), tab, pos0, finit, cinit,
      carrbase, out, ffin, pos_out, cph_out, p);
  return (int)cudaGetLastError();
}

extern "C" const char* track_dual_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
