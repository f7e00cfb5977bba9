// The live receiver's per-epoch lock summary and readback packing, one
// launch per supervision epoch (gnsstpu_torch/ops/summary_kernel.py).
//
// Replaces no Pallas kernel. gnsstpu computes this summary with XLA ops
// that jit fuses (gnsstpu/runtime/manager.py ChannelManager._make_summarize
// :877, its `summarize` over gnsstpu/tracking/lock.py assess_device :90,
// and `pack` :917). The port ran the same function as plain PyTorch: 63
// ops an epoch and 10 more a superepoch to stack and cat the readback,
// each a kernel of 1.5-2.5 us on an H100 for ~0.2 MB of work in all. A
// traced window of the live GPS receiver (C = 12 channels, E = 500 blocks
// an epoch) showed ~1.5 s of such small kernels beside K1's 4.3 s. This
// kernel does the whole epoch in one launch and writes straight into
// epoch slot k of the superepoch's readback buffer.
//
// Per channel c, over the epoch's E blocks of the EpochObs lanes (each an
// [E, C] view read through its own two strides, so K1's strided output
// needs no copy), it computes assess_device's stats in IEEE f32:
//   * NWPR C/N0 over the first g = E / m groups of m blocks:
//     mu = mean_g(NP / max(WP, 1e-30)), NP = (sum |I|)^2 + (sum Q)^2,
//     WP = sum(I^2 + Q^2); 10 log10(max((mu - 1) / max(m - mu, 1e-6),
//     1e-10) / t_int);
//   * PLL lock mean(I^2 - Q^2) / max(mean(I^2 + Q^2), 1e-30) and code lock
//     mean|P| / max(mean(|E| + |L|), 1e-30), over all E blocks;
//   * locked = cn0 > cn0_drop and pll > pll_min;
// and the stream lanes, bit for bit as the plain version rounds them:
//   * compact: the prompts times f32(1/spc) rounded to f16 (to nearest,
//     ties to even), rem as rint(rem * 65535) clamped to [0, 65535] in a
//     u16, blksize - spc as i16, Doppler as f32;
//   * f32: ip, qp, rem, f32(blksize), Doppler (+ ip2, qp2).
// The layouts (ops/summary_kernel.py, ChannelManager._decode_readback):
//   compact  pp f16 [K,E,C,P] | rem u16 [K,E,C] | blkd i16 [K,E,C]
//            | dopp f32 [K,E,C] | st f32 [K,C,4], P = 2 (+2 data prompts);
//   f32      streams f32 [K,E,C,5(+2)] and st f32 [K,C,4].
//
// Design: one CTA of 128 threads per channel. Channels are independent,
// so C CTAs run side by side on C SMs and each channel's reductions stay
// inside its CTA: a fixed tree in shared memory, with no atomics and no
// second pass, so two launches on the same inputs are bit-identical. In
// one pass a thread takes blocks e = tid, tid + 128, ...: it writes their
// stream lanes and sums the PLL and code-lock terms; it also takes NWPR
// groups j = tid, tid + 128, ..., summing each group's m blocks in order
// with the loads of up to 32 blocks in flight. One tree then reduces the
// five sums (NWPR ratios, NBD, NBP, |P|, |E| + |L|), and thread 0 writes
// the channel's stats.
//
// What bounds it on an H100: neither bytes (at C = 12 x E = 500, 9 lanes
// of 4 bytes read and 12 bytes written a block and channel, ~0.29 MB:
// 0.09 us at 3.35 TB/s) nor operations, but one launch and the latency of
// a few dependent rounds of loads and one reduction. Keeping it to one
// launch per epoch is the design's point.
//
// Numerics: build without --use_fast_math and with -fmad=false
// (ops/cuda_build.py), so every product and sum rounds as in the plain
// version; only the order of the stats' sums differs from it.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;    // per CTA, one CTA per channel
constexpr int NSUM = 5;         // NWPR ratios, NBD, NBP, |P|, |E| + |L|
constexpr int MCHUNK = 32;      // NWPR blocks whose loads go out together
// Input lanes, in the order the wrapper passes their pointers and strides.
enum { L_IE = 0, L_QE, L_IP, L_QP, L_IL, L_QL, L_REM, L_DOPP, L_IP2, L_QP2,
       NF };

struct Params {
  const float* f[NF];           // f32 lanes (ip2 / qp2 null if not dual)
  long long fs_e[NF], fs_c[NF]; // their strides (elements) along E and C
  const int* blk;               // blksize, int32
  long long blk_e, blk_c;
  int E, C, m, k, dual, spc;
  float scale, t_int, cn0_drop, pll_min;
  // compact: the four stream regions; f32: streams only.
  __half* pp;
  uint16_t* rem;
  int16_t* blkd;
  float* dopp;
  float* streams;
  float* st;                    // stats [K, C, 4] (either layout)
};

__device__ __forceinline__ float ld(const Params& p, int lane, int e, int c) {
  return __ldg(p.f[lane] + e * p.fs_e[lane] + c * p.fs_c[lane]);
}

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

template <bool COMPACT>
__global__ void __launch_bounds__(THREADS)
epoch_summary_kernel(const Params p) {
  __shared__ float red[NSUM][THREADS];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int E = p.E, C = p.C;
  float nbd = 0.f, nbp = 0.f, pmag = 0.f, el = 0.f;

  for (int e = tid; e < E; e += THREADS) {
    const float ie = ld(p, L_IE, e, c), qe = ld(p, L_QE, e, c);
    const float ip = ld(p, L_IP, e, c), qp = ld(p, L_QP, e, c);
    const float il = ld(p, L_IL, e, c), ql = ld(p, L_QL, e, c);
    const float rem = ld(p, L_REM, e, c), dopp = ld(p, L_DOPP, e, c);
    const int blk = __ldg(p.blk + e * p.blk_e + c * p.blk_c);
    const float i2 = ip * ip, q2 = qp * qp;
    nbd += i2 - q2;
    nbp += i2 + q2;
    pmag += sqrtf(i2 + q2);
    el += sqrtf(ie * ie + qe * qe) + sqrtf(il * il + ql * ql);

    const long long row = ((long long)p.k * E + e) * C + c;  // [K, E, C]
    if (COMPACT) {
      const int P = p.dual ? 4 : 2;
      __half2* pp = reinterpret_cast<__half2*>(p.pp + row * P);
      pp[0] = __halves2half2(__float2half_rn(ip * p.scale),
                             __float2half_rn(qp * p.scale));
      if (p.dual) {
        const float ip2 = ld(p, L_IP2, e, c), qp2 = ld(p, L_QP2, e, c);
        pp[1] = __halves2half2(__float2half_rn(ip2 * p.scale),
                               __float2half_rn(qp2 * p.scale));
      }
      const float r = fminf(fmaxf(rintf(rem * 65535.0f), 0.0f), 65535.0f);
      p.rem[row] = (uint16_t)(int)r;
      p.blkd[row] = (int16_t)(blk - p.spc);
      p.dopp[row] = dopp;
    } else {
      const int L = p.dual ? 7 : 5;
      float* s = p.streams + row * L;
      s[0] = ip;
      s[1] = qp;
      s[2] = rem;
      s[3] = (float)blk;
      s[4] = dopp;
      if (p.dual) {
        s[5] = ld(p, L_IP2, e, c);
        s[6] = ld(p, L_QP2, e, c);
      }
    }
  }

  // NWPR: group j's m blocks summed in order, MCHUNK loads at a time.
  const int m = p.m, g = E / m;
  float ratios = 0.f;
  for (int j = tid; j < g; j += THREADS) {
    float ii = 0.f, qq = 0.f, wp = 0.f;
    for (int b = 0; b < m; b += MCHUNK) {
      float iv[MCHUNK], qv[MCHUNK];
#pragma unroll
      for (int i = 0; i < MCHUNK; ++i) {
        if (b + i < m) {
          iv[i] = ld(p, L_IP, j * m + b + i, c);
          qv[i] = ld(p, L_QP, j * m + b + i, c);
        }
      }
#pragma unroll
      for (int i = 0; i < MCHUNK; ++i) {
        if (b + i < m) {
          ii += fabsf(iv[i]);
          qq += qv[i];
          wp += iv[i] * iv[i] + qv[i] * qv[i];
        }
      }
    }
    ratios += (ii * ii + qq * qq) / clamp_min(wp, 1e-30f);
  }

  red[0][tid] = ratios;
  red[1][tid] = nbd;
  red[2][tid] = nbp;
  red[3][tid] = pmag;
  red[4][tid] = el;
  __syncthreads();
#pragma unroll
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int q = 0; q < NSUM; ++q) red[q][tid] += red[q][tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const float fe = (float)E;
    const float mu = red[0][0] / (float)g;
    const float ratio = clamp_min(
        (mu - 1.0f) / clamp_min((float)m - mu, 1e-6f), 1e-10f);
    const float cn0 = 10.0f * log10f(ratio / p.t_int);
    const float pll = (red[1][0] / fe) / clamp_min(red[2][0] / fe, 1e-30f);
    const float code = (red[3][0] / fe) / clamp_min(red[4][0] / fe, 1e-30f);
    float* st = p.st + ((long long)p.k * C + c) * 4;
    st[0] = cn0;
    st[1] = pll;
    st[2] = code;
    st[3] = (cn0 > p.cn0_drop && pll > p.pll_min) ? 1.0f : 0.0f;
  }
}

}  // namespace

// One launch: epoch slot k of a K-epoch readback. f / f_strides: the NF
// f32 lanes' pointers and their (E, C) strides, interleaved; ip2 / qp2
// null when the engine has no data component. compact != 0: out_pp,
// out_rem, out_blkd, out_dopp are the compact regions' starts and
// out_streams is unused; else out_streams is streams [K, E, C, 5(+2)].
// out_st: stats [K, C, 4]. Returns a cudaError_t (0 on success).
extern "C" int epoch_summary_cuda(
    const void* const* f, const long long* f_strides, const int* blk,
    long long blk_e, long long blk_c, int E, int C, int m, int K, int k,
    int spc, float scale, float t_int, float cn0_drop, float pll_min,
    int compact, void* out_pp, void* out_rem, void* out_blkd,
    void* out_dopp, void* out_streams, void* out_st, void* stream) {
  if (E < 1 || C < 0 || m < 1 || m > E || K < 1 || k < 0 || k >= K)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  Params p;
  for (int i = 0; i < NF; ++i) {
    p.f[i] = static_cast<const float*>(f[i]);
    p.fs_e[i] = f_strides[2 * i];
    p.fs_c[i] = f_strides[2 * i + 1];
  }
  p.dual = (p.f[L_IP2] != nullptr && p.f[L_QP2] != nullptr) ? 1 : 0;
  if (!p.dual) {                // never read; keep the pointers valid
    for (int i = L_IP2; i <= L_QP2; ++i) {
      p.f[i] = p.f[L_IP];
      p.fs_e[i] = p.fs_e[L_IP];
      p.fs_c[i] = p.fs_c[L_IP];
    }
  }
  p.blk = blk;
  p.blk_e = blk_e;
  p.blk_c = blk_c;
  p.E = E;
  p.C = C;
  p.m = m;
  p.k = k;
  p.spc = spc;
  p.scale = scale;
  p.t_int = t_int;
  p.cn0_drop = cn0_drop;
  p.pll_min = pll_min;
  p.pp = static_cast<__half*>(out_pp);
  p.rem = static_cast<uint16_t*>(out_rem);
  p.blkd = static_cast<int16_t*>(out_blkd);
  p.dopp = static_cast<float*>(out_dopp);
  p.streams = static_cast<float*>(out_streams);
  p.st = static_cast<float*>(out_st);
  const void* fn = compact ? (const void*)&epoch_summary_kernel<true>
                           : (const void*)&epoch_summary_kernel<false>;
  void* args[] = {(void*)&p};
  cudaError_t err = cudaLaunchKernel(fn, dim3((unsigned)C),
                                     dim3((unsigned)THREADS), args, 0,
                                     (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// What the kernel uses: info = {registers, static shared bytes, local
// bytes, threads per CTA} of the compact instance.
extern "C" int epoch_summary_info(int* info) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, (const void*)&epoch_summary_kernel<true>);
  if (err != cudaSuccess) return (int)err;
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = (int)a.localSizeBytes;
  info[3] = THREADS;
  return 0;
}

extern "C" const char* epoch_summary_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
