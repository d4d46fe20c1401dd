// Folded-BatchNorm k x k convolution (dense or depthwise) with fused
// activation and adds, CUDA C++ for sm_90a.
//
// Replaces: segtpu/kernels/chw_ops.py::conv_chw (the Pallas TPU kernels
// _conv_kernel/_conv_body for k > 1 and _pw_kernel for k = 1).
//
// Function: x [B, C, H, W] (bf16 or f32) -> out [B, Cout, H, W], x's dtype,
//   out = act(sum_{c, ky, kx} w[co, c, ky, kx] * x[c, y + oy(ky), x + ox(kx)]
//             + bias[co]) (+ add[b, co, y, x]) (+ vec[b, co])
// with tap offsets dilation * (t - k / 2) (k = 2 reads {-d, 0}) and zero
// padding; k in {1, 2, 3, 5}, any dilation; act none / relu / relu6.
// Dense: the weight is OIHW in x's dtype, products are exact in f32 (bf16
// operands) and accumulate in f32. Depthwise: the weight is [C, 1, k, k]
// f32 and the upcast input is multiplied in f32. bias, vec and the sum are
// f32; one rounding at the store, as the TPU kernel. Sums run over input
// channels, then taps (row-major), from zero, each product and add rounded
// once: the order of the plain twin (kernels/chw_ops.py), which this kernel
// matches bit for bit.
//
// Bound on the H100: on the main path this is the s2d stem, k = 2, 12 ->
// 32 channels at 8 x 512 x 1024: 101 MB read + 268 MB written (0.11 ms at
// 3.35 TB/s) and 12.9 GFLOP of products (0.013 ms at the bf16 tensor-core
// rate, 0.19 ms in f32 on the CUDA cores this version uses).
// Design (simple first version): a block owns an 8 x 32 output tile of one
// image and a group of COB output channels (dense) or CC channels
// (depthwise). It stages a chunk of input channels, tile plus halo, in
// shared memory as f32 with the zero padding written in, and (dense) the
// chunk's weights as [c][tap][COB] f32, so that one thread per output pixel
// reads one input value per tap and a 4-wide weight vector broadcast to the
// warp for every 4 output channels it accumulates in registers. Every input
// value staged is reused COB times. Tensor cores are a later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 8, kTW = 32, kThreads = kTH * kTW;
constexpr int kSmemBudget = 48 * 1024;      // bytes per block we aim for
constexpr int kSmemMax = 227 * 1024;        // opt-in maximum on the H100

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// s + w * x with the product and the sum each rounded once, as the plain
// PyTorch twin computes it. With bf16 operands (T = __nv_bfloat16) the
// product is exact in f32, so one fused multiply-add rounds the same way.
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

struct ConvArgs {
  const void* x;
  const void* w;
  const float* bias;
  const void* add;     // optional [B, Cout, H, W] in x's dtype
  const float* vec;    // optional [B, Cout] f32
  void* out;
  int B, C, Cout, H, W, dil, act;
  int CC;              // input channels staged per step
  int G;               // channel groups per image (grid.z = B * G)
};

// The epilogue of one output value: bias, activation, adds, one rounding.
template <typename T>
__device__ __forceinline__ void store_out(const ConvArgs& a, float s, int b,
                                          int co, int gy, int gx) {
  float y = activate(s + a.bias[co], a.act);
  const size_t o = (((size_t)b * a.Cout + co) * a.H + gy) * a.W + gx;
  if (a.add) y += to_f32(static_cast<const T*>(a.add)[o]);
  if (a.vec) y += a.vec[(size_t)b * a.Cout + co];
  static_cast<T*>(a.out)[o] = from_f32<T>(y);
}

// Stage channels [c0, c0 + cc) of the input tile plus halo as f32, zero
// outside the image. Window origin: (tile row - lo, tile col - lo).
template <typename T>
__device__ __forceinline__ void stage_x(const ConvArgs& a, const T* x,
                                        float* x_s, int c0, int cc, int SH,
                                        int SW, int lo) {
  const int y0 = blockIdx.y * kTH - lo, x0 = blockIdx.x * kTW - lo;
  const int n = cc * SH * SW;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int c = i / (SH * SW), r = i - c * (SH * SW);
    const int sy = r / SW, sx = r - sy * SW;
    const int gy = y0 + sy, gx = x0 + sx;
    float v = 0.f;
    if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W)
      v = to_f32(x[((size_t)(c0 + c) * a.H + gy) * a.W + gx]);
    x_s[i] = v;
  }
}

template <typename T, int K, int COB>
__global__ void __launch_bounds__(kThreads)
    conv_dense_kernel(ConvArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int KK = K * K;
  const int dil = a.dil, lo = dil * (K / 2);
  const int SH = kTH + dil * (K - 1), SW = kTW + dil * (K - 1);
  float* w_s = smem;                       // [CC][KK][COB]
  float* x_s = smem + a.CC * KK * COB;     // [CC][SH][SW]
  const int tx = threadIdx.x % kTW, ty = threadIdx.x / kTW;
  const int b = blockIdx.z / a.G, co0 = (blockIdx.z % a.G) * COB;
  const int gy = blockIdx.y * kTH + ty, gx = blockIdx.x * kTW + tx;
  const T* x = static_cast<const T*>(a.x) + (size_t)b * a.C * a.H * a.W;
  const T* w = static_cast<const T*>(a.w);

  float acc[COB];
#pragma unroll
  for (int o = 0; o < COB; ++o) acc[o] = 0.f;

  for (int c0 = 0; c0 < a.C; c0 += a.CC) {
    const int cc = min(a.CC, a.C - c0);
    __syncthreads();
    stage_x(a, x, x_s, c0, cc, SH, SW, lo);
    for (int i = threadIdx.x; i < cc * KK * COB; i += kThreads) {
      const int o = i % COB, ct = i / COB, c = ct / KK, t = ct - c * KK;
      const int co = co0 + o;
      w_s[i] = co < a.Cout
                   ? to_f32(w[((size_t)co * a.C + c0 + c) * KK + t])
                   : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < cc; ++c) {
      const float* xc = x_s + (c * SH + ty) * SW + tx;
#pragma unroll
      for (int t = 0; t < KK; ++t) {
        const float v = xc[(t / K) * dil * SW + (t % K) * dil];
        const float4* wp =
            reinterpret_cast<const float4*>(w_s + (c * KK + t) * COB);
#pragma unroll
        for (int o = 0; o < COB / 4; ++o) {
          const float4 wv = wp[o];
          acc[4 * o + 0] = mac<T>(acc[4 * o + 0], wv.x, v);
          acc[4 * o + 1] = mac<T>(acc[4 * o + 1], wv.y, v);
          acc[4 * o + 2] = mac<T>(acc[4 * o + 2], wv.z, v);
          acc[4 * o + 3] = mac<T>(acc[4 * o + 3], wv.w, v);
        }
      }
    }
  }
  if (gy < a.H && gx < a.W) {
#pragma unroll
    for (int o = 0; o < COB; ++o)
      if (co0 + o < a.Cout) store_out<T>(a, acc[o], b, co0 + o, gy, gx);
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    conv_depthwise_kernel(ConvArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int KK = K * K;
  const int dil = a.dil, lo = dil * (K / 2);
  const int SH = kTH + dil * (K - 1), SW = kTW + dil * (K - 1);
  const int c0 = (blockIdx.z % a.G) * a.CC, cc = min(a.CC, a.C - c0);
  float* w_s = smem;                               // [CC][KK]
  float* x_s = smem + ((a.CC * KK + 3) & ~3);      // [CC][SH][SW]
  const int tx = threadIdx.x % kTW, ty = threadIdx.x / kTW;
  const int b = blockIdx.z / a.G;
  const int gy = blockIdx.y * kTH + ty, gx = blockIdx.x * kTW + tx;
  const T* x = static_cast<const T*>(a.x) + (size_t)b * a.C * a.H * a.W;
  const float* w = static_cast<const float*>(a.w);

  stage_x(a, x, x_s, c0, cc, SH, SW, lo);
  for (int i = threadIdx.x; i < cc * KK; i += kThreads)
    w_s[i] = w[(size_t)c0 * KK + i];
  __syncthreads();
  if (gy >= a.H || gx >= a.W) return;
  for (int c = 0; c < cc; ++c) {
    const float* xc = x_s + (c * SH + ty) * SW + tx;
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < KK; ++t)
      s = mac<float>(s, w_s[c * KK + t],
                     xc[(t / K) * dil * SW + (t % K) * dil]);
    store_out<T>(a, s, b, c0 + c, gy, gx);
  }
}

template <typename Kern>
int launch(Kern kernel, const ConvArgs& a, int smem, cudaStream_t s) {
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.W + kTW - 1) / kTW, (a.H + kTH - 1) / kTH, a.B * a.G);
  kernel<<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int K>
int run_dense(ConvArgs a, cudaStream_t s) {
  const int span = (kTH + a.dil * (K - 1)) * (kTW + a.dil * (K - 1));
  // COB output channels per block: each thread keeps COB sums
  const int cob = a.Cout >= 32 ? 32 : (a.Cout > 8 ? 16 : 8);
  const int per_c = 4 * (span + K * K * cob);
  a.CC = max(1, min(a.C, kSmemBudget / per_c));
  a.G = (a.Cout + cob - 1) / cob;
  const int smem = a.CC * per_c;
  if (cob == 32) return launch(conv_dense_kernel<T, K, 32>, a, smem, s);
  if (cob == 16) return launch(conv_dense_kernel<T, K, 16>, a, smem, s);
  return launch(conv_dense_kernel<T, K, 8>, a, smem, s);
}

template <typename T, int K>
int run_depthwise(ConvArgs a, cudaStream_t s) {
  const int span = (kTH + a.dil * (K - 1)) * (kTW + a.dil * (K - 1));
  const int per_c = 4 * (span + K * K);
  a.CC = max(1, min(a.C, kSmemBudget / per_c));
  a.G = (a.C + a.CC - 1) / a.CC;
  const int smem = 4 * ((a.CC * K * K + 3) & ~3) + 4 * a.CC * span;
  return launch(conv_depthwise_kernel<T, K>, a, smem, s);
}

template <typename T>
int run(const ConvArgs& a, int k, int depthwise, cudaStream_t s) {
  switch (k) {
    case 1: return depthwise ? run_depthwise<T, 1>(a, s) : run_dense<T, 1>(a, s);
    case 2: return depthwise ? run_depthwise<T, 2>(a, s) : run_dense<T, 2>(a, s);
    case 3: return depthwise ? run_depthwise<T, 3>(a, s) : run_dense<T, 3>(a, s);
    case 5: return depthwise ? run_depthwise<T, 5>(a, s) : run_dense<T, 5>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// w: dense OIHW [Cout, C, k, k] in x's dtype, or depthwise [C, 1, k, k]
// f32; bias f32 [Cout]; add (x's dtype) and vec (f32 [B, Cout]) may be null.
extern "C" int segtpu_conv_chw(const void* x, const void* w, const float* bias,
                               const void* add, const float* vec, void* out,
                               int B, int C, int Cout, int H, int W, int k,
                               int dilation, int depthwise, int act, int bf16,
                               void* stream) {
  ConvArgs a{x, w, bias, add, vec, out, B, C, Cout, H, W, dilation, act, 0, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(a, k, depthwise, s)
              : run<float>(a, k, depthwise, s);
}
