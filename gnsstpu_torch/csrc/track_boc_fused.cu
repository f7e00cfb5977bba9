// K2 on Hopper: fused Galileo E1B BOC(1,1) double-estimator tracker.
//
// Replaces the TPU Pallas kernel gnsstpu/ops/track_kernel.py
// (track_chunk_boc_fused :938, body _make_boc_kernel :725, pallas_call
// :1025). One launch tracks all n_blocks code periods (4 ms E1B blocks) of
// C channels. Per channel and block it computes what the Pallas kernel
// computes:
//   * block length ceil((code_length - rem) / step_c) clipped to
//     [1, blkp], in IEEE f32 (the sample_pos bookkeeping must stay exact);
//   * carrier NCO step carrbase + rint(carr_delta * 2^32/fs), uint32 wrap;
//   * two tap-row selections, one per estimator: the primary-code row
//     rint((rem + span_code) * ph_code) of the channel's ctab, and the
//     meandr row rint((rem_sub + span_sub) * ph_sub) of the shared stab,
//     each row holding the E/P/L planes;
//   * the exact-u32 factored LO, k = 64a + r (sincosf of the int32 view of
//     the u32 phase, combined by the angle-sum products), as K1;
//   * carrier wipeoff and the ten accumulators I/Q x {E_P, P_E, P_P, P_L,
//     L_P} (subcarrier tap x code tap);
//   * the three loops: FLL-assisted PLL on P_P (the FLL error
//     atan(cross / dot) with the 1e-30 guard, as the TPU body), the DLL on
//     the normalized |P_E| - |P_L| aided by carrier / 1540, the SLL on
//     |E_P| - |L_P| aided by carrier / 770; then the rem / rem_sub / pos /
//     phase advance.
//
// Design: the cluster skeleton of cluster_track.cuh. Each channel is a
// cluster of N CTAs (N = 8 at C = 12: 96 SMs), each CTA owns S samples of
// the 4 ms block (2,112 at N = 8, one 16-sample step for 132 of its 256
// threads), and per step a thread issues six 16-byte tap loads (the E/P/L
// planes of the code row and of the meandr row) and sixteen 8-byte sample
// loads before its first product. Both tables are int8 with the plane
// stride padded to 128 lanes (lanes past blkp hold 0): ctab [C, Rc, 3, bp]
// and stab [Rs, 3, bp]. Every tap is +-1, so each is widened to f32 and
// the products sub x code are those of f32 tables; the narrowing cuts the
// tap bytes per block fourfold. Partial sums and the next block's
// geometry cross the cluster through distributed shared memory.
//
// What bounds it on an H100: not bytes (the chunk once plus ~100 KB of
// tap rows per block and channel, which stay in L2) nor operations (22
// per sample and channel: 6 for the LO, 6 for the wipeoff and one signed
// add per accumulator, the sub x code products being sign flips, against
// 67 TFLOP/s of f32), but the chain of blocks inside a channel: per block
// one L2 round trip for the tap rows, one device-memory round trip for the
// chunk, two cluster barriers and the leader's serial loop update. One
// CTA per channel would keep 12 of 132 SMs busy at C = 12 and walk the
// block in 33 dependent load steps of 512 threads; the cluster makes it
// one step deep on 8 SMs per channel.
//
// Numerics: build WITHOUT --use_fast_math and with -fmad=false, so the
// block geometry rounds as in the plain PyTorch twin
// (gnsstpu_torch/ops/track_kernel.py::track_chunk_boc_fused_ref);
// rounding is half-to-even (__float2int_rn), as jnp.round / torch.round.
// Only the order in which the accumulators are summed differs from it.

#include "cluster_track.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int NF = 16;          // float state lanes (finit / ffin)
constexpr int NOUT = 24;        // output lanes per block and channel
constexpr int NACC = 10;        // accumulators
constexpr int NCONST = 20;      // f32 constants (track_kernel.BOC_CONSTS)

// Float-state lanes (reference _F_*).
enum {
  F_REM = 0, F_CODE_DELTA, F_CARR_DELTA, F_CARR_NCO, F_OLD_CARR_ERR,
  F_CODE_NCO, F_OLD_CODE_ERR, F_IP_PREV, F_QP_PREV, F_DOPPLER_BASIS,
  F_INV_AID, F_REM_SUB, F_SUB_DELTA, F_SLL_NCO, F_OLD_SLL_ERR,
  F_INV_AID_SUB
};
// Output lanes (reference OB_*); 0..9 are the accumulators.
enum {
  OB_CARR_DOPPLER = 10, OB_CODE_FREQ_DELTA, OB_SUB_FREQ_DELTA, OB_REM,
  OB_REM_SUB, OB_BLKSIZE, OB_DLL_DISC, OB_SLL_DISC, OB_PLL_DISC
};

struct Params {
  long long n_samples;
  int n_blocks, C, Rc, Rs, blkp, plane, N, S;
  // In the order of gnsstpu_torch.ops.track_kernel.BOC_CONSTS.
  float code_length, sub_length, base_code_step, base_sub_step, inv_fs,
      nco_scale, ph_code, ph_sub, span_code, span_sub, ang_scale, inv_pi,
      inv_2pi, k1, k2, k3, c_dll_p, c_dll_i, c_sll_p, c_sll_i;
};

struct Geometry {
  float step_c, step_s;
  int blk;
  uint32_t cstep;
  int row_c, row_s;
};

// What every CTA of the cluster needs of a block.
struct Geo {
  int blk, pos, row_c, row_s;
  uint32_t ph, cstep;
};

// Block geometry from the float state (thread 0 only).
__device__ Geometry geometry(const float* st, uint32_t cbase,
                             const Params& p) {
  Geometry g;
  g.step_c = p.base_code_step + st[F_CODE_DELTA] * p.inv_fs;
  g.step_s = p.base_sub_step + st[F_SUB_DELTA] * p.inv_fs;
  const float blkf = ceilf((p.code_length - st[F_REM]) / g.step_c);
  g.blk = min(max(__float2int_rz(blkf), 1), p.blkp);
  g.cstep = cbase + (uint32_t)__float2int_rn(st[F_CARR_DELTA] * p.nco_scale);
  const int rc = __float2int_rn((st[F_REM] + p.span_code) * p.ph_code);
  g.row_c = min(max(rc, 0), p.Rc - 1);
  const int rs = __float2int_rn((st[F_REM_SUB] + p.span_sub) * p.ph_sub);
  g.row_s = min(max(rs, 0), p.Rs - 1);
  return g;
}

__device__ __forceinline__ float env_err(float ie, float qe, float il,
                                         float ql) {
  const float e_env = sqrtf(ie * ie + qe * qe);
  const float l_env = sqrtf(il * il + ql * ql);
  return (e_env - l_env) / fmaxf(e_env + l_env, 1e-10f);
}

__global__ void __launch_bounds__(ctrack::THREADS, 1)
track_boc_fused_kernel(const float2* __restrict__ chunk,
                       const int8_t* __restrict__ ctab,
                       const int8_t* __restrict__ stab,
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
  const int8_t* ctabc = ctab + (size_t)c * p.Rc * 3 * plane;
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
    s_geo = Geo{g.blk, pos, g.row_c, g.row_s, ph, g.cstep};
  }
  cl.sync();  // every CTA has started and holds its geometry

  for (int b = 0; b < p.n_blocks; ++b) {
    const Geo geo = s_geo;
    const int hi = min(lo + p.S, geo.blk);
    const int a0 = lo / ctrack::FINE;
    ctrack::lo_angles(s_ang, lo, hi, geo.ph, geo.cstep, p.ang_scale);
    const int8_t* crow = ctabc + (size_t)geo.row_c * 3 * plane;
    const int8_t* srow = stab + (size_t)geo.row_s * 3 * plane;

    float acc[NACC];
#pragma unroll
    for (int j = 0; j < NACC; ++j) acc[j] = 0.f;
    for (int k0 = lo + tid * ctrack::VEC; k0 < hi;
         k0 += ctrack::THREADS * ctrack::VEC) {
      uint4 code[3], sub[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        code[j] = ctrack::load_taps(crow + j * plane + k0);
        sub[j] = ctrack::load_taps(srow + j * plane + k0);
      }
      float bi[ctrack::VEC], bq[ctrack::VEC];
      ctrack::baseband16(chunk, p.n_samples, geo.pos, k0, hi, s_ang, a0, bi,
                         bq);
#pragma unroll
      for (int e = 0; e < ctrack::VEC; ++e) {
        const float code_e = ctrack::tap(code[0], e),
                    code_p = ctrack::tap(code[1], e),
                    code_l = ctrack::tap(code[2], e);
        const float sub_e = ctrack::tap(sub[0], e),
                    sub_p = ctrack::tap(sub[1], e),
                    sub_l = ctrack::tap(sub[2], e);
        const float t[5] = {sub_e * code_p, sub_p * code_e, sub_p * code_p,
                            sub_p * code_l, sub_l * code_p};
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          acc[2 * j] += t[j] * bi[e];
          acc[2 * j + 1] += t[j] * bq[e];
        }
      }
    }
    ctrack::reduce_to_leader<NACC>(acc, s_part, s_red, cl);

    if (leader && tid < 32) {
      float v[NACC];
      ctrack::leader_totals<NACC>(s_red, p.N, v);
      if (tid == 0) {
        const float iep = v[0], qep = v[1], ipe = v[2], qpe = v[3],
                    ipp = v[4], qpp = v[5], ipl = v[6], qpl = v[7],
                    ilp = v[8], qlp = v[9];
        const float ip_prev = st[F_IP_PREV], qp_prev = st[F_QP_PREV];
        const float cross = ipp * qp_prev - ip_prev * qpp;
        const float dot = ipp * ip_prev + qpp * qp_prev;
        const float safe = fabsf(dot) < 1e-30f
                               ? (dot < 0.f ? -1e-30f : 1e-30f)
                               : dot;
        const float freq_err = atanf(cross / safe) * p.inv_pi;
        const float denom = fabsf(ipp) < 1e-10f ? 1e-10f : ipp;
        const float carr_err = atanf(qpp / denom) * p.inv_2pi;
        const float carr_nco = st[F_CARR_NCO] + p.k1 * carr_err
                               - p.k2 * st[F_OLD_CARR_ERR] - p.k3 * freq_err;
        const float carr_delta = st[F_DOPPLER_BASIS] + carr_nco;
        const float code_err = env_err(ipe, qpe, ipl, qpl);
        const float code_nco = st[F_CODE_NCO]
                               + p.c_dll_p * (code_err - st[F_OLD_CODE_ERR])
                               + code_err * p.c_dll_i;
        const float code_delta = -code_nco + carr_delta * st[F_INV_AID];
        const float sll_err = env_err(iep, qep, ilp, qlp);
        const float sll_nco = st[F_SLL_NCO]
                              + p.c_sll_p * (sll_err - st[F_OLD_SLL_ERR])
                              + sll_err * p.c_sll_i;
        const float sub_delta = -sll_nco + carr_delta * st[F_INV_AID_SUB];
        const float bsf = (float)g.blk;
        const float rem = st[F_REM] + bsf * g.step_c - p.code_length;
        const float rem_s = st[F_REM_SUB] + bsf * g.step_s - p.sub_length;

        float* o = out + ((size_t)b * p.C + c) * NOUT;
        for (int j = 0; j < NACC; ++j) o[j] = v[j];
        o[OB_CARR_DOPPLER] = carr_delta;
        o[OB_CODE_FREQ_DELTA] = code_delta;
        o[OB_SUB_FREQ_DELTA] = sub_delta;
        o[OB_REM] = rem;
        o[OB_REM_SUB] = rem_s;
        o[OB_BLKSIZE] = bsf;
        o[OB_DLL_DISC] = code_err;
        o[OB_SLL_DISC] = sll_err;
        o[OB_PLL_DISC] = carr_err;
        for (int j = OB_PLL_DISC + 1; j < NOUT; ++j) o[j] = 0.f;

        st[F_REM] = rem;
        st[F_REM_SUB] = rem_s;
        st[F_CODE_DELTA] = code_delta;
        st[F_SUB_DELTA] = sub_delta;
        st[F_CARR_DELTA] = carr_delta;
        st[F_CARR_NCO] = carr_nco;
        st[F_OLD_CARR_ERR] = carr_err;
        st[F_CODE_NCO] = code_nco;
        st[F_OLD_CODE_ERR] = code_err;
        st[F_SLL_NCO] = sll_nco;
        st[F_OLD_SLL_ERR] = sll_err;
        st[F_IP_PREV] = ipp;
        st[F_QP_PREV] = qpp;
        ph += (uint32_t)g.blk * g.cstep;
        pos += g.blk;

        g = geometry(st, cbase, p);
        ctrack::broadcast(cl, &s_geo,
                          Geo{g.blk, pos, g.row_c, g.row_s, ph, g.cstep},
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
extern "C" int track_chunk_boc_fused_cuda(
    const float* chunk, long long n_samples, const int8_t* ctab,
    const int8_t* stab, const int* pos0, const float* finit,
    const long long* cinit, const long long* carrbase, float* out,
    float* ffin, int* pos_out, long long* cph_out, int C, int n_blocks,
    int Rc, int Rs, int blkp, int N, const float* consts, int n_consts,
    void* stream, void* start_event) {
  if (n_consts != NCONST || blkp < 1 || blkp > ctrack::MAX_BLKP || N < 1 ||
      N > ctrack::MAX_N || Rc < 1 || Rs < 1 || C < 0 || n_blocks < 0)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  Params p;
  p.n_samples = n_samples;
  p.n_blocks = n_blocks;
  p.C = C;
  p.Rc = Rc;
  p.Rs = Rs;
  p.blkp = blkp;
  p.plane = ctrack::plane_stride(blkp);
  p.N = N;
  p.S = ctrack::slice_len(blkp, N);
  float* dst[NCONST] = {
      &p.code_length, &p.sub_length, &p.base_code_step, &p.base_sub_step,
      &p.inv_fs, &p.nco_scale, &p.ph_code, &p.ph_sub, &p.span_code,
      &p.span_sub, &p.ang_scale, &p.inv_pi, &p.inv_2pi, &p.k1, &p.k2,
      &p.k3, &p.c_dll_p, &p.c_dll_i, &p.c_sll_p, &p.c_sll_i};
  for (int i = 0; i < NCONST; ++i) *dst[i] = consts[i];
  if (start_event != nullptr) {
    const cudaError_t err =
        cudaEventRecord((cudaEvent_t)start_event, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return ctrack::launch_clusters(
      track_boc_fused_kernel, C, N, (cudaStream_t)stream,
      reinterpret_cast<const float2*>(chunk), ctab, stab, pos0, finit,
      cinit, carrbase, out, ffin, pos_out, cph_out, p);
}

extern "C" int track_boc_fused_cluster_info(int C, int N, int* info) {
  return ctrack::cluster_info(track_boc_fused_kernel, C, N, info);
}

extern "C" const char* track_boc_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
