// Register-tiled 1x1 products on the CUDA cores, shared by conv_chw.cu
// (conv1x1_kernel) and resize.cu (the fused 1x1 chain).
//
// A block holds a run of P pixels of one image in shared memory, channel
// major ([c][P] in T), and a stage's weights as f32 [cin][cpad] (cpad a
// multiple of 4, zero past the stage's output channels). A thread
// accumulates CO output channels x PX consecutive pixels in registers:
// for each input channel one PX-wide vector read of its pixels and CO / 4
// float4 reads of the weights (the same address for every lane of a warp,
// a broadcast), then CO x PX multiply-adds with mac<T>. So every output
// sums its input channels from zero in ascending order, each product and
// sum rounded as the plain twins round them (decoder_common.cuh): the
// tile does not change the bits.

#pragma once

#include "decoder_common.cuh"
#include "tc_common.cuh"

namespace segtpu {

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf16_pack(float lo, float hi) {
  return (uint32_t)f32_to_bf16_bits(lo) | ((uint32_t)f32_to_bf16_bits(hi) << 16);
}

// N consecutive values at p (aligned to 16 bytes, or to N * sizeof(T)
// when that is less) as f32, by 16-byte loads where N allows.
template <int N>
__device__ __forceinline__ void load_px(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 a = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = a.x; v[4 * i + 1] = a.y; v[4 * i + 2] = a.z; v[4 * i + 3] = a.w;
    }
  } else {
    static_assert(N == 2, "2 or a multiple of 4 values");
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  }
}
template <int N>
__device__ __forceinline__ void load_px(const __nv_bfloat16* p,
                                        float (&v)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 a = reinterpret_cast<const uint4*>(p)[i];
      float* w = v + 8 * i;
      w[0] = bf16_lo(a.x); w[1] = bf16_hi(a.x); w[2] = bf16_lo(a.y);
      w[3] = bf16_hi(a.y); w[4] = bf16_lo(a.z); w[5] = bf16_hi(a.z);
      w[6] = bf16_lo(a.w); w[7] = bf16_hi(a.w);
    }
  } else if constexpr (N == 4) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    v[0] = bf16_lo(a.x); v[1] = bf16_hi(a.x);
    v[2] = bf16_lo(a.y); v[3] = bf16_hi(a.y);
  } else {
    static_assert(N == 2, "2, 4 or a multiple of 8 values");
    const uint32_t a = *reinterpret_cast<const uint32_t*>(p);
    v[0] = bf16_lo(a); v[1] = bf16_hi(a);
  }
}

// v rounded to T, stored as N consecutive values at p (aligned as for
// load_px) by 16-byte stores where N allows.
template <int N>
__device__ __forceinline__ void store_px(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
    static_assert(N == 2, "2 or a multiple of 4 values");
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}
template <int N>
__device__ __forceinline__ void store_px(__nv_bfloat16* p,
                                         const float (&v)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const float* w = v + 8 * i;
      reinterpret_cast<uint4*>(p)[i] =
          make_uint4(bf16_pack(w[0], w[1]), bf16_pack(w[2], w[3]),
                     bf16_pack(w[4], w[5]), bf16_pack(w[6], w[7]));
    }
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(bf16_pack(v[0], v[1]), bf16_pack(v[2], v[3]));
  } else {
    static_assert(N == 2, "2, 4 or a multiple of 8 values");
    *reinterpret_cast<uint32_t*>(p) = bf16_pack(v[0], v[1]);
  }
}

// acc[o][k] += sum_{c < n} w[c * wstride + o] * x[c * xstride + k], c
// ascending: x points at the thread's first pixel in shared memory, w at
// its first output channel.
template <typename T, int CO, int PX>
__device__ __forceinline__ void tile_fma(float (&acc)[CO][PX], const T* x,
                                         int xstride, const float* w,
                                         int wstride, int n) {
#pragma unroll 2
  for (int c = 0; c < n; ++c) {
    float v[PX];
    load_px<PX>(x + c * xstride, v);
    const float4* wp = reinterpret_cast<const float4*>(w + c * wstride);
#pragma unroll
    for (int q = 0; q < CO / 4; ++q) {
      const float4 wv = wp[q];
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        acc[4 * q + 0][k] = mac<T>(acc[4 * q + 0][k], wv.x, v[k]);
        acc[4 * q + 1][k] = mac<T>(acc[4 * q + 1][k], wv.y, v[k]);
        acc[4 * q + 2][k] = mac<T>(acc[4 * q + 2][k], wv.z, v[k]);
        acc[4 * q + 3][k] = mac<T>(acc[4 * q + 3][k], wv.w, v[k]);
      }
    }
  }
}

template <int CO, int PX>
__device__ __forceinline__ void zero(float (&acc)[CO][PX]) {
#pragma unroll
  for (int o = 0; o < CO; ++o)
#pragma unroll
    for (int k = 0; k < PX; ++k) acc[o][k] = 0.f;
}

// Starts copying channels [0, cc) of pixels [p0, p0 + n) of src (a
// [C][hw] image, already offset to its first channel) into dst [cc][P],
// pixels n..P-1 zero. vec: 16-byte cp.async (hw, p0 and n multiples of
// 16 / sizeof(T), src 16-byte aligned), to be committed and waited for by
// the caller; else plain loads and stores, visible after the next barrier.
// NT: the block's threads.
template <typename T>
__device__ __forceinline__ void stage_px(T* dst, int P, const T* src,
                                         long long hw, long long p0, int n,
                                         int cc, bool vec, int NT) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int per = P / E;
    for (int i = threadIdx.x; i < cc * per; i += NT) {
      const int c = i / per, e = (i - c * per) * E;
      const bool in = e < n;
      cp_async16(dst + c * P + e, in ? src + c * hw + p0 + e : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < cc * P; i += NT) {
      const int c = i / P, e = i - c * P;
      dst[i] = e < n ? src[c * hw + p0 + e] : from_f32<T>(0.f);
    }
  }
}

// w_s[c * cpad + o] = w[(co0 + o) * cin + c] as f32 for co0 + o < cout,
// else 0 (c < cin, o < cpad); w is [cout][cin] in T.
template <typename T>
__device__ __forceinline__ void stage_weights(float* w_s, int cpad,
                                              const T* w, int cin, int co0,
                                              int cout, int NT) {
  for (int i = threadIdx.x; i < cin * cpad; i += NT) {
    const int o = i / cin, c = i - o * cin;
    w_s[c * cpad + o] =
        co0 + o < cout ? to_f32(w[(size_t)(co0 + o) * cin + c]) : 0.f;
  }
}

// Blocks along x of a persistent grid: as many as can be resident on the
// card at once (each walks items blockIdx.x, + gridDim.x, ...), shared
// with `gy` blocks along y, at most `items`; 0 on a CUDA error.
template <typename Kern>
inline int resident_blocks(Kern kernel, int threads, int smem,
                           long long items, int gy) {
  int dev = 0, sms = 0, per = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads,
                                                    smem) != cudaSuccess)
    return 0;
  const long long want = ((long long)(per > 0 ? per : 1) * sms + gy - 1) / gy;
  return (int)(want < items ? want : items);
}

}  // namespace segtpu
