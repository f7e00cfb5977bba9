// The thread-block-cluster skeleton shared by the port's block trackers
// (K2 track_boc_fused.cu, K3 track_dual_fused.cu).
//
// A tracker's channels are independent, but inside a channel every code
// period (block) waits for the previous block's loop update. So the unit of
// parallel work is one block of one channel, and it is spread across a
// cluster of N CTAs (grid C x N, cluster dims (N, 1, 1)):
//   * CTA i of a cluster owns the block-relative samples
//     [i S, (i + 1) S) of [0, blk), S = round_up(ceil(blkp / N), 16), so
//     the split does not depend on blk;
//   * each thread takes 16 consecutive samples per step: one 16-byte load
//     per int8 tap plane (plane stride padded to a multiple of 128) and the
//     16 float2 samples, all issued before the first product;
//   * the factored LO (k = 64 a + r) needs the 64 fine angles and only the
//     coarse angles of the CTA's own slice, one sincosf per thread;
//   * the reduction is warp shuffles, then warp 0 over the CTA's warps
//     (lane j takes accumulator j), then warp 0 writes the CTA's partial
//     sums into slot [rank] of the leader CTA's shared memory (DSMEM);
//     after a cluster barrier the leader sums the N slots in rank order.
//     No atomics: two launches on the same inputs are bit-identical;
//   * the leader's thread 0 runs the loop filters and the next block's
//     geometry, writes that geometry into every CTA's shared memory
//     (DSMEM), and a second cluster barrier releases the next block.
// The host side picks N (gnsstpu_torch/ops/track_kernel.py::
// cluster_split); the C entry points derive S (slice_len) and the
// tap-plane stride (plane_stride) from blkp and N themselves. K1
// (track_fused.cu, one CTA per channel, no cluster) shares plane_stride,
// FINE and MAX_BLKP.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace ctrack {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int VEC = 16;                       // samples per thread and step
constexpr int FINE = 64;                      // LO factor b: k = 64 a + r
constexpr int MAX_N = 8;                      // CTAs per cluster (portable)
constexpr int MAX_BLKP = 32768;
constexpr int MAX_COARSE = MAX_BLKP / FINE + 2;  // coarse angles of a slice

// Tap-plane stride: blkp rounded up to a multiple of 128 lanes.
__host__ __device__ inline int plane_stride(int blkp) {
  return (blkp + 127) / 128 * 128;
}

// Samples per CTA: ceil(blkp / N) rounded up to a multiple of VEC.
__host__ __device__ inline int slice_len(int blkp, int N) {
  return ((blkp + N - 1) / N + VEC - 1) / VEC * VEC;
}

// LO angles of one block for one CTA: cos / sin of the 64 fine angles
// (r * step) and of the coarse angles (phase + a * 64 * step) of the
// slice's a-range, each from the int32 view of the u32 phase.
struct __align__(16) Angles {
  float cr[FINE], sr[FINE];
  float ca[MAX_COARSE], sa[MAX_COARSE];
};

// Fills s for block-relative samples [lo, hi) and ends with a CTA barrier.
__device__ __forceinline__ void lo_angles(Angles& s, int lo, int hi,
                                          uint32_t ph, uint32_t cs,
                                          float ang_scale) {
  const int a0 = lo / FINE;
  const int na = hi > lo ? (hi - 1) / FINE - a0 + 1 : 0;
  for (int i = threadIdx.x; i < FINE + na; i += THREADS) {
    float sn, co;
    if (i < FINE) {
      const uint32_t kr = (uint32_t)i * cs;
      sincosf(__int2float_rn((int32_t)kr) * ang_scale, &sn, &co);
      s.cr[i] = co;
      s.sr[i] = sn;
    } else {
      const uint32_t a = (uint32_t)(a0 + i - FINE);
      const uint32_t ka = ph + a * (cs * 64u);
      sincosf(__int2float_rn((int32_t)ka) * ang_scale, &sn, &co);
      s.ca[i - FINE] = co;
      s.sa[i - FINE] = sn;
    }
  }
  __syncthreads();
}

// 16 int8 taps of one plane (16-byte aligned).
__device__ __forceinline__ uint4 load_taps(const int8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Tap e (0..15, a compile-time index after unrolling) widened to f32.
__device__ __forceinline__ float tap(const uint4& t, int e) {
  const uint32_t w = e < 4 ? t.x : e < 8 ? t.y : e < 12 ? t.z : t.w;
  return __int2float_rn((int)(int8_t)(w >> (8 * (e & 3))));
}

// Baseband of the 16 samples k0..k0+15 of a block starting at chunk index
// pos: carrier wipeoff with the factored LO; samples at or past hi, or
// outside the chunk, read as zero. k0 is a multiple of VEC, so the 16
// samples share one coarse angle.
__device__ __forceinline__ void baseband16(const float2* __restrict__ chunk,
                                           long long n_samples, int pos,
                                           int k0, int hi, const Angles& s,
                                           int a0, float (&bi)[VEC],
                                           float (&bq)[VEC]) {
  float2 x[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const long long si = (long long)pos + k0 + e;
    x[e] = make_float2(0.f, 0.f);
    if (k0 + e < hi && si >= 0 && si < n_samples) x[e] = __ldg(chunk + si);
  }
  const int ai = k0 / FINE - a0;
  const float ca = s.ca[ai], sa = s.sa[ai];
  const float4* cr4 = reinterpret_cast<const float4*>(s.cr + (k0 & 63));
  const float4* sr4 = reinterpret_cast<const float4*>(s.sr + (k0 & 63));
#pragma unroll
  for (int q = 0; q < VEC / 4; ++q) {
    const float4 c4 = cr4[q], s4 = sr4[q];
    const float cr[4] = {c4.x, c4.y, c4.z, c4.w};
    const float sr[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = 4 * q + u;
      const float lo_c = ca * cr[u] - sa * sr[u];
      const float lo_s = sa * cr[u] + ca * sr[u];
      bi[e] = x[e].x * lo_c + x[e].y * lo_s;
      bq[e] = x[e].y * lo_c - x[e].x * lo_s;
    }
  }
}

// Stages 1-3 of the reduction: warp shuffles, warp 0 over the CTA's warps,
// then the CTA's NACC sums into slot [rank] of the leader's s_red; ends
// with the cluster barrier after which the leader may read s_red.
template <int NACC>
__device__ __forceinline__ void reduce_to_leader(float (&acc)[NACC],
                                                 float (*s_part)[NACC],
                                                 float (*s_red)[NACC],
                                                 cg::cluster_group& cl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[j] += __shfl_down_sync(0xffffffffu, acc[j], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) s_part[warp][j] = acc[j];
  }
  __syncthreads();
  if (warp == 0 && lane < NACC) {
    float v = 0.f;
    for (int w = 0; w < NWARPS; ++w) v += s_part[w][lane];
    float* slot = cl.map_shared_rank(&s_red[0][0], 0);
    slot[cl.block_rank() * NACC + lane] = v;
  }
  cl.sync();
}

// The leader's totals: lane j of warp 0 sums accumulator j over the N
// slots in rank order; every lane of the warp gets all NACC totals.
template <int NACC>
__device__ __forceinline__ void leader_totals(float (*s_red)[NACC],
                                              int N, float (&v)[NACC]) {
  const int lane = threadIdx.x & 31;
  float t = 0.f;
  if (lane < NACC)
    for (int r = 0; r < N; ++r) t += s_red[r][lane];
#pragma unroll
  for (int j = 0; j < NACC; ++j) v[j] = __shfl_sync(0xffffffffu, t, j);
}

// The leader writes the next block's geometry into every CTA's s_geo.
template <class Geo>
__device__ __forceinline__ void broadcast(cg::cluster_group& cl, Geo* s_geo,
                                          const Geo& g, int N) {
  for (int r = 0; r < N; ++r) *cl.map_shared_rank(s_geo, r) = g;
}

inline cudaLaunchConfig_t cluster_config(int C, int N, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * N), 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launches C clusters of N CTAs on the stream; returns the launch error.
template <typename... KArgs, typename... Args>
inline int launch_clusters(void (*kernel)(KArgs...), int C, int N,
                           cudaStream_t stream, Args&&... args) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(C, N, stream, attr);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// What the compiled kernel uses and how many of its clusters fit at once:
// info = {registers, static shared bytes, local bytes, threads per CTA,
// dynamic shared bytes, cudaOccupancyMaxActiveClusters}.
template <typename... KArgs>
inline int cluster_info(void (*kernel)(KArgs...), int C, int N, int* info) {
  if (N < 1 || N > MAX_N || C < 1) return (int)cudaErrorInvalidValue;
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(C, N, 0, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return (int)err;
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = (int)a.localSizeBytes;
  info[3] = THREADS;
  info[4] = (int)cfg.dynamicSmemBytes;
  info[5] = clusters;
  return 0;
}

}  // namespace ctrack
