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
//   * the exact-u32 factored LO, k = 64a + r (sincosf of the int32 view of
//     the u32 phase, combined by the angle-sum products), as K1 and K2;
//   * carrier wipeoff of samples [pos, pos + blk), zeros past the chunk's
//     end (the reference pads the chunk with 256 zero samples), and the
//     twelve accumulators I/Q x {pilot, data} x {E, P, L};
//   * the L3 loop wiring: a Costas PLL atan(Q_P / I_P) on the pilot prompt,
//     the flip-invariant 2-quadrant FLL atan(cross / dot) over consecutive
//     pilot prompts (with the TPU body's 1e-30 guard), the DLL on the
//     normalized pilot E-L envelopes with the code clock aided by
//     carrier / 117.5; then the rem / pos / phase advance.
//
// Design: the cluster skeleton of cluster_track.cuh. Each channel is a
// cluster of N CTAs (N = 8 at C = 12: 96 SMs), each CTA owns S samples of
// the block (3,008 at N = 8, one 16-sample step for 188 of its 256
// threads), and per step a thread issues six 16-byte tap loads (the six
// int8 planes of the block's row) and sixteen 8-byte sample loads before
// its first product. The tap table is int8 [C, R, 6, bp], bp = blkp
// rounded up to 128 (24,064 at 24 Msps; lanes past blkp hold 0); the taps
// are exactly +-1, widened to f32 before they multiply the baseband
// sample, so no product changes. Partial sums and the next block's
// geometry cross the cluster through distributed shared memory.
//
// What bounds it on an H100: not bytes (the chunk once plus ~144 KB of
// tap rows per block and channel, which stay in L2) nor operations (24
// per sample and channel: 6 for the LO, 6 for the wipeoff and, every tap
// being +-1, one signed add per accumulator, against 67 TFLOP/s of f32),
// but the chain of blocks inside a channel: per block one L2 round trip
// for the tap rows, one device-memory round trip for the chunk, two
// cluster barriers and the leader's serial loop update. One CTA per
// channel would keep 12 of 132 SMs busy at C = 12 and walk the block in 47
// dependent load steps of 512 threads, each step one sample and six
// one-byte taps; the cluster makes it one step deep on 8 SMs per channel.
//
// Numerics: build WITHOUT --use_fast_math and with -fmad=false, so the
// block geometry rounds as in the plain PyTorch twin
// (gnsstpu_torch/ops/track_kernel.py::track_chunk_dual_fused_ref). Only
// the order in which the accumulators are summed differs from it.

#include "cluster_track.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int NF = 16;          // float state lanes (finit / ffin)
constexpr int NOUT = 24;        // output lanes per block and channel
constexpr int NACC = 12;        // accumulators
constexpr int NPLANE = 6;       // tap planes per row
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
  int n_blocks, C, R, blkp, plane, N, S;
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

// What every CTA of the cluster needs of a block.
struct Geo {
  int blk, pos, row;
  uint32_t ph, cstep;
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

__global__ void __launch_bounds__(ctrack::THREADS, 1)
track_dual_fused_kernel(const float2* __restrict__ chunk,
                        const int8_t* __restrict__ tab,
                        const int* __restrict__ pos0,
                        const float* __restrict__ finit,
                        const long long* __restrict__ cinit,
                        const long long* __restrict__ carrbase,
                        float* __restrict__ out, float* __restrict__ ffin,
                        int* __restrict__ pos_out,
                        long long* __restrict__ cph_out, Params p) {
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const bool leader = rank == 0;
  const int c = blockIdx.x / p.N;
  const int tid = threadIdx.x;

  __shared__ ctrack::Angles s_ang;
  __shared__ float s_part[ctrack::NWARPS][NACC];
  __shared__ float s_red[ctrack::MAX_N][NACC];
  __shared__ Geo s_geo;

  const size_t plane = (size_t)p.plane;
  const int8_t* tabc = tab + (size_t)c * p.R * NPLANE * plane;
  const int lo = rank * p.S;

  // Loop-filter state and cursors live in thread 0's registers; only the
  // leader's copy advances. Every CTA derives the first block's geometry
  // itself.
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
    s_geo = Geo{g.blk, pos, g.row, ph, g.cstep};
  }
  cl.sync();  // every CTA has started and holds its geometry

  for (int b = 0; b < p.n_blocks; ++b) {
    const Geo geo = s_geo;
    const int hi = min(lo + p.S, geo.blk);
    const int a0 = lo / ctrack::FINE;
    ctrack::lo_angles(s_ang, lo, hi, geo.ph, geo.cstep, p.ang_scale);
    const int8_t* row = tabc + (size_t)geo.row * NPLANE * plane;

    float acc[NACC];
#pragma unroll
    for (int j = 0; j < NACC; ++j) acc[j] = 0.f;
    for (int k0 = lo + tid * ctrack::VEC; k0 < hi;
         k0 += ctrack::THREADS * ctrack::VEC) {
      uint4 t[NPLANE];
#pragma unroll
      for (int j = 0; j < NPLANE; ++j)
        t[j] = ctrack::load_taps(row + j * plane + k0);
      float bi[ctrack::VEC], bq[ctrack::VEC];
      ctrack::baseband16(chunk, p.n_samples, geo.pos, k0, hi, s_ang, a0, bi,
                         bq);
#pragma unroll
      for (int e = 0; e < ctrack::VEC; ++e) {
#pragma unroll
        for (int j = 0; j < NPLANE; ++j) {
          const float tj = ctrack::tap(t[j], e);
          acc[2 * j] += tj * bi[e];
          acc[2 * j + 1] += tj * bq[e];
        }
      }
    }
    ctrack::reduce_to_leader<NACC>(acc, s_part, s_red, cl);

    if (leader && tid < 32) {
      float v[NACC];
      ctrack::leader_totals<NACC>(s_red, p.N, v);
      if (tid == 0) {
        const float ie = v[0], qe = v[1], ip = v[2], qp = v[3], il = v[4],
                    ql = v[5];
        const float ip_prev = st[F_IP_PREV], qp_prev = st[F_QP_PREV];
        const float cross = ip * qp_prev - ip_prev * qp;
        const float dot = ip * ip_prev + qp * qp_prev;
        const float safe = fabsf(dot) < 1e-30f
                               ? (dot < 0.f ? -1e-30f : 1e-30f)
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
        ctrack::broadcast(cl, &s_geo, Geo{g.blk, pos, g.row, ph, g.cstep},
                          p.N);
      }
    }
    cl.sync();  // the next block's geometry is in every CTA
  }

  if (leader && tid == 0) {
    for (int i = 0; i < NF; ++i) ffin[c * NF + i] = st[i];
    pos_out[c] = pos;
    cph_out[c] = (long long)ph;
  }
}

}  // namespace

// start_event: null, or a CUDA event recorded on the stream just before
// the launch, after the host's preparation (a timing event pair's start).
extern "C" int track_chunk_dual_fused_cuda(
    const float* chunk, long long n_samples, const int8_t* tab,
    const int* pos0, const float* finit, const long long* cinit,
    const long long* carrbase, float* out, float* ffin, int* pos_out,
    long long* cph_out, int C, int n_blocks, int R, int blkp,
    int N, const float* consts, int n_consts, void* stream,
    void* start_event) {
  if (n_consts != NCONST || blkp < 1 || blkp > ctrack::MAX_BLKP || N < 1 ||
      N > ctrack::MAX_N || R < 1 || C < 0 || n_blocks < 0)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  Params p;
  p.n_samples = n_samples;
  p.n_blocks = n_blocks;
  p.C = C;
  p.R = R;
  p.blkp = blkp;
  p.plane = ctrack::plane_stride(blkp);
  p.N = N;
  p.S = ctrack::slice_len(blkp, N);
  float* dst[NCONST] = {
      &p.code_length, &p.base_code_step, &p.inv_fs, &p.nco_scale, &p.ph,
      &p.span, &p.ang_scale, &p.inv_pi, &p.inv_2pi, &p.k1, &p.k2, &p.k3,
      &p.c_dll_p, &p.c_dll_i};
  for (int i = 0; i < NCONST; ++i) *dst[i] = consts[i];
  if (start_event != nullptr) {
    const cudaError_t err =
        cudaEventRecord((cudaEvent_t)start_event, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return ctrack::launch_clusters(
      track_dual_fused_kernel, C, N, (cudaStream_t)stream,
      reinterpret_cast<const float2*>(chunk), tab, pos0, finit, cinit,
      carrbase, out, ffin, pos_out, cph_out, p);
}

extern "C" int track_dual_fused_cluster_info(int C, int N, int* info) {
  return ctrack::cluster_info(track_dual_fused_kernel, C, N, info);
}

extern "C" const char* track_dual_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
