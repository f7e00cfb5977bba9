// K1 on Hopper: fused single-code DLL / FLL-assisted-PLL tracker.
//
// Replaces the TPU Pallas kernel gnsstpu/ops/track_kernel.py
// (track_chunk_fused :274, body _make_kernel :82). One launch tracks all
// n_blocks code periods (1 ms blocks for GPS L1 C/A) of C channels. Per
// channel and block it computes what the Pallas kernel computes:
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
//     phase advance.
//
// Design. One CUDA block per channel loops over the blocks in order: that
// loop replaces the TPU's sequential grid axis, and the loop-filter state
// stays in thread 0's registers. The 256 threads stride over the ~2050
// samples of a block, each keeping six partial sums, then a warp-shuffle +
// shared-memory reduction gives the six accumulators; thread 0 runs the
// discriminators and loop filters, publishes the next block's geometry in
// shared memory, and a __syncthreads() starts the next block. The window is
// read at the channel's cursor directly (no aligned-slice + roll, no
// "expand" matmul, no channel tiling or padding: those were Mosaic
// workarounds), and atan2f/atanf replace the reference's polynomial _atan.
//
// What bounds it on an H100: each channel is a sequential chain of n_blocks
// small reductions (about 41 KB read per block: 3 table rows + 2050 I/Q
// pairs), so latency and occupancy bound it, not bytes or FLOPs: 12
// channels occupy 12 of the 132 SMs, and every block pays two barriers and
// a serial loop-filter update on one thread. More channels per launch fill
// more SMs at no extra time per block.
//
// Numerics: build WITHOUT --use_fast_math (fast math changes the division
// and sinf/cosf, and blksize / sample_pos stop being exact) and with
// -fmad=false, so every multiply-add rounds twice as in the plain PyTorch
// twin (gnsstpu_torch/ops/track_kernel.py::track_chunk_fused_ref).
// Rounding is half-to-even (__float2int_rn), as jnp.round and torch.round.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NF = 16;          // float state lanes (finit / ffin)
constexpr int NOUT = 16;        // output lanes per block and channel
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int FINE = 64;        // LO factor b: k = 64 a + r
constexpr int MAX_COARSE = 64;  // coarse angles: blkp <= 4096

// Float-state lanes (reference _F_*).
enum {
  F_REM = 0, F_CODE_DELTA, F_CARR_DELTA, F_CARR_NCO, F_OLD_CARR_ERR,
  F_CODE_NCO, F_OLD_CODE_ERR, F_IP_PREV, F_QP_PREV, F_DOPPLER_BASIS,
  F_INV_AID
};
// Output lanes (reference O_*).
enum {
  O_IE = 0, O_QE, O_IP, O_QP, O_IL, O_QL, O_CARR_DOPPLER,
  O_CODE_FREQ_DELTA, O_REM, O_BLKSIZE, O_DLL_DISC, O_DLL_FILT, O_PLL_DISC,
  O_PLL_FILT
};

struct Params {
  long long n_samples;
  int n_blocks, C, R, blkp;
  float code_length, base_code_step, inv_fs, nco_scale, ph;
  float row_off[3];             // (-spacing, 0, +spacing) + span_chips
  float ang_scale, inv_pi, inv_2pi;
  float k1, k2, k3, c_dll_p, c_dll_i;
};

struct Geometry {
  float step;
  int blk;
  uint32_t cstep;
  int row[3];
};

// Block geometry from the float state (thread 0 only).
__device__ Geometry geometry(const float* st, uint32_t cbase,
                             const Params& p) {
  Geometry g;
  g.step = p.base_code_step + st[F_CODE_DELTA] * p.inv_fs;
  const float blkf = ceilf((p.code_length - st[F_REM]) / g.step);
  g.blk = min(max(__float2int_rz(blkf), 1), p.blkp);
  g.cstep = cbase + (uint32_t)__float2int_rn(st[F_CARR_DELTA] * p.nco_scale);
  for (int j = 0; j < 3; ++j) {
    const int r = __float2int_rn((st[F_REM] + p.row_off[j]) * p.ph);
    g.row[j] = min(max(r, 0), p.R - 1);
  }
  return g;
}

__global__ void __launch_bounds__(THREADS)
track_fused_kernel(const float2* __restrict__ chunk,
                   const float* __restrict__ tab,
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
  __shared__ float s_part[6][NWARPS];
  __shared__ int s_blk, s_pos, s_row[3];
  __shared__ uint32_t s_ph, s_cstep;

  const float* tabc = tab + (size_t)c * p.R * p.blkp;
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
    for (int j = 0; j < 3; ++j) s_row[j] = g.row[j];
  }
  __syncthreads();

  for (int b = 0; b < p.n_blocks; ++b) {
    const int blk = s_blk;
    const int pb = s_pos;
    const uint32_t phb = s_ph;
    const uint32_t cs = s_cstep;
    const float* erow = tabc + (size_t)s_row[0] * p.blkp;
    const float* prow = tabc + (size_t)s_row[1] * p.blkp;
    const float* lrow = tabc + (size_t)s_row[2] * p.blkp;

    // Factored LO: 64 fine + n_coarse coarse angles, one sincos each.
    if (tid < FINE) {
      const uint32_t kr = (uint32_t)tid * cs;
      const float ar = __int2float_rn((int32_t)kr) * p.ang_scale;
      float s, co;
      sincosf(ar, &s, &co);
      s_cr[tid] = co;
      s_sr[tid] = s;
    } else if (tid < FINE + n_coarse) {
      const int a = tid - FINE;
      const uint32_t ka = phb + (uint32_t)a * (cs * 64u);
      const float aa = __int2float_rn((int32_t)ka) * p.ang_scale;
      float s, co;
      sincosf(aa, &s, &co);
      s_ca[a] = co;
      s_sa[a] = s;
    }
    __syncthreads();

    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = tid; k < blk; k += THREADS) {
      const long long si = (long long)pb + k;
      float2 x = make_float2(0.f, 0.f);
      if (si >= 0 && si < p.n_samples) x = chunk[si];
      const int a = k >> 6, r = k & 63;
      const float lo_c = s_ca[a] * s_cr[r] - s_sa[a] * s_sr[r];
      const float lo_s = s_sa[a] * s_cr[r] + s_ca[a] * s_sr[r];
      const float bi = x.x * lo_c + x.y * lo_s;
      const float bq = x.y * lo_c - x.x * lo_s;
      const float e = erow[k], pr = prow[k], l = lrow[k];
      acc[0] += e * bi;
      acc[1] += e * bq;
      acc[2] += pr * bi;
      acc[3] += pr * bq;
      acc[4] += l * bi;
      acc[5] += l * bq;
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[j] += __shfl_down_sync(0xffffffffu, acc[j], off);
      if (lane == 0) s_part[j][warp] = acc[j];
    }
    __syncthreads();

    if (tid == 0) {
      float v[6];
      for (int j = 0; j < 6; ++j) {
        float s = 0.f;
        for (int w = 0; w < NWARPS; ++w) s += s_part[j][w];
        v[j] = s;
      }
      const float ie = v[0], qe = v[1], ip = v[2], qp = v[3], il = v[4],
                  ql = v[5];
      const float ip_prev = st[F_IP_PREV], qp_prev = st[F_QP_PREV];
      const float cross = ip * qp_prev - ip_prev * qp;
      const float dot = fabsf(ip * ip_prev + qp * qp_prev);
      const float freq_err = atan2f(cross, dot) * p.inv_pi;
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
      const float rem = st[F_REM] + (float)g.blk * g.step - p.code_length;

      float* o = out + ((size_t)b * p.C + c) * NOUT;
      o[O_IE] = ie; o[O_QE] = qe; o[O_IP] = ip; o[O_QP] = qp;
      o[O_IL] = il; o[O_QL] = ql;
      o[O_CARR_DOPPLER] = carr_delta;
      o[O_CODE_FREQ_DELTA] = code_delta;
      o[O_REM] = rem;
      o[O_BLKSIZE] = (float)g.blk;
      o[O_DLL_DISC] = code_err;
      o[O_DLL_FILT] = code_nco;
      o[O_PLL_DISC] = carr_err;
      o[O_PLL_FILT] = carr_nco;
      o[14] = 0.f;
      o[15] = 0.f;

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
      for (int j = 0; j < 3; ++j) s_row[j] = g.row[j];
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

extern "C" int track_chunk_fused_cuda(
    const float* chunk, long long n_samples, const float* tab,
    const int* pos0, const float* finit, const long long* cinit,
    const long long* carrbase, float* out, float* ffin, int* pos_out,
    long long* cph_out, int C, int n_blocks, int R, int blkp,
    int code_length, float base_code_step, float inv_fs, float nco_scale,
    float ph, float row_off_e, float row_off_p, float row_off_l,
    float ang_scale, float inv_pi, float inv_2pi, float k1, float k2,
    float k3, float c_dll_p, float c_dll_i, void* stream) {
  if (blkp < 1 || blkp > MAX_COARSE * FINE || R < 1 || C < 0 ||
      n_blocks < 0)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  Params p;
  p.n_samples = n_samples;
  p.n_blocks = n_blocks;
  p.C = C;
  p.R = R;
  p.blkp = blkp;
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
  track_fused_kernel<<<C, THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(chunk), tab, pos0, finit, cinit,
      carrbase, out, ffin, pos_out, cph_out, p);
  return (int)cudaGetLastError();
}

extern "C" const char* track_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
