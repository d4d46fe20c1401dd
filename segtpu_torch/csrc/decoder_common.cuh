// Helpers shared by the decoder kernels (pointwise.cu, cell.cu, resize.cu).
//
// Rounding conventions, as the plain PyTorch twins compute (kernels/
// chw_ops.py, kernels/resize_chw.py): every product and every sum is
// rounded once. With bf16 operands (T = __nv_bfloat16) a product is exact in
// f32, so one fused multiply-add rounds the same way; with f32 operands the
// product and the sum are rounded separately.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace segtpu {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T and back: the storage rounding of an intermediate.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// s + w * x, product and sum each rounded once (see the note above).
template <typename T>
__device__ __forceinline__ float mac(float s, float w, float x) {
  return __fadd_rn(s, __fmul_rn(w, x));
}
template <>
__device__ __forceinline__ float mac<__nv_bfloat16>(float s, float w, float x) {
  return fmaf(w, x, s);
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) return fminf(fmaxf(v, 0.f), 6.f);
  return v;
}

constexpr int kMaxSrc = 4;     // sources of a multi-source 1x1 product
constexpr int kMaxStage = 4;   // stages of a 1x1 chain
constexpr int kCOB = 16;       // output channels a thread accumulates at once

// A chain of 1x1 convolutions over the pixels of one image, channel-major
// [C, HW] planes: stage 0 reads the channels of every source in turn (a
// multi-source product is a product over their concatenation), stage s > 0
// the output of stage s - 1. Each stage is act(sum_c w[o, c] * in[c] + b[o])
// with the sum over c ascending from zero; every stage but the last is
// rounded to T (the storage rounding of the two-kernel form it replaces).
struct PwChain {
  const void* src[kMaxSrc];
  int src_c[kMaxSrc];
  int nsrc;
  const void* w[kMaxStage];    // [cout, cin] in T
  const float* b[kMaxStage];   // [cout] f32
  int cin[kMaxStage], cout[kMaxStage], act[kMaxStage];
  int nst;
  int cmax;                    // widest intermediate (stages 0..nst-2)
};

// Runs the chain for pixel p of image b, one thread per pixel, TP threads
// per block; every thread of the block takes part (``valid`` false for a
// pixel past the image: it loads and stores nothing). smem holds two
// [cmax][TP] ping-pong buffers, each thread using its own column, then the
// [cin][kCOB] f32 weights of the current group of output channels (a
// stage's widest input times kCOB floats), read as float4 broadcasts. The
// last stage's f32 result (activated, not rounded) is handed to
// sink(o, value).
template <typename T, int TP, typename Sink>
__device__ __forceinline__ void pw_chain_pixel(const PwChain& ch, int b,
                                               long long hw, long long p,
                                               bool valid, float* smem,
                                               Sink sink) {
  const int tid = threadIdx.x;
  float* wsm = smem + 2 * ch.cmax * TP;
  for (int s = 0; s < ch.nst; ++s) {
    const T* w = static_cast<const T*>(ch.w[s]);
    const int cin = ch.cin[s], cout = ch.cout[s];
    const float* in = smem + ((s + 1) & 1) * ch.cmax * TP;
    float* outb = smem + (s & 1) * ch.cmax * TP;
    const bool last = s == ch.nst - 1;
    for (int co0 = 0; co0 < cout; co0 += kCOB) {
      __syncthreads();
      for (int i = tid; i < cin * kCOB; i += TP) {
        const int o = i % kCOB, ci = i / kCOB;
        wsm[i] = co0 + o < cout ? to_f32(w[(size_t)(co0 + o) * cin + ci]) : 0.f;
      }
      __syncthreads();
      if (!valid) continue;
      float acc[kCOB];
#pragma unroll
      for (int o = 0; o < kCOB; ++o) acc[o] = 0.f;
      int ci = 0;
      for (int j = 0; j < (s == 0 ? ch.nsrc : 1); ++j) {
        const T* x = s == 0 ? static_cast<const T*>(ch.src[j]) +
                                  (size_t)b * ch.src_c[j] * hw + p
                            : nullptr;
        const int cj = s == 0 ? ch.src_c[j] : cin;
        for (int c = 0; c < cj; ++c, ++ci) {
          const float v = s == 0 ? to_f32(x[(size_t)c * hw]) : in[c * TP + tid];
          const float4* wp = reinterpret_cast<const float4*>(wsm + ci * kCOB);
#pragma unroll
          for (int q = 0; q < kCOB / 4; ++q) {
            const float4 wv = wp[q];
            acc[4 * q + 0] = mac<T>(acc[4 * q + 0], wv.x, v);
            acc[4 * q + 1] = mac<T>(acc[4 * q + 1], wv.y, v);
            acc[4 * q + 2] = mac<T>(acc[4 * q + 2], wv.z, v);
            acc[4 * q + 3] = mac<T>(acc[4 * q + 3], wv.w, v);
          }
        }
      }
#pragma unroll
      for (int o = 0; o < kCOB; ++o) {
        const int co = co0 + o;
        if (co >= cout) break;
        const float y = activate(acc[o] + ch.b[s][co], ch.act[s]);
        if (last)
          sink(co, y);
        else
          outb[co * TP + tid] = round_to<T>(y);
      }
    }
  }
}

// Shared-memory floats pw_chain_pixel needs beyond its two buffers.
inline int pw_chain_weight_floats(const PwChain& ch) {
  int cin = 0;
  for (int s = 0; s < ch.nst; ++s) cin = cin > ch.cin[s] ? cin : ch.cin[s];
  return cin * kCOB;
}

// Opts a kernel into more than 48 KB of dynamic shared memory when asked.
template <typename Kern>
inline int set_smem(Kern kernel, int smem) {
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace segtpu
