// Fused MobileNet-v2 inverted residual, stride 1 and stride 2, with
// BatchNorm folded into the weights, CUDA C++ for sm_90a.
//
// Replaces: segtpu/kernels/chw_ops.py::inv_res_chw (Pallas TPU kernel
// _invres_kernel) and chw_ops.py::inv_res_s2_chw (_invres_s2_kernel).
//
// Function: x [B, Cin, H, W] (bf16 or f32) -> out [B, Cout, H/S, W/S]:
//   mid = relu6(w_exp . x + b_exp)  in f32, never rounded (mid = x upcast
//         when there is no expand), zero outside the image: the zero
//         padding of the depthwise input, so a border reads 0, not
//         relu6(b_exp);
//   d   = relu6(dw3x3_S(mid) + b_dw)  in f32 (f32 weights), rounded to the
//         compute dtype once (torch pad=1: output (i, j) reads rows
//         S*i-1..S*i+1, columns S*j-1..S*j+1);
//   out = round(w_proj . d + b_proj (+ x when residual)), the product
//         accumulated in f32 on compute-dtype operands.
// Every sum runs from zero in ascending order (expand over Cin, depthwise
// over the taps row-major, project over Cmid, chunk after chunk), each
// product and add rounded once: the plain twin's order
// (kernels/chw_ops.py), which this kernel matches bit for bit.
// The TPU kernels' row-split planes, quadrant split and 0/1 permutation
// dots only moved bytes into the TPU's lane layout and are not carried
// over: the kernel reads the plain [B, C, H, W] tensor.
//
// Bound on the H100: each block moves its input once and its output once
// (the expanded tensor never leaves the SM), so the 17 blocks of the arch0
// encoder at 8 x 1024 x 2048 move ~1.3 GB (~0.4 ms at 3.35 TB/s) but do
// ~180 GFLOP of products (~0.18 ms on bf16 tensor cores, ~2.7 ms in f32 on
// the CUDA cores this version uses): the arithmetic is the floor.
// Design (simple first version): one block of 256 threads per (image,
// TH x TW output tile). It stages the input window (the tile's receptive
// field) for all Cin channels in shared memory once, then walks the mid
// channels in chunks of MC:
//   1. expand the chunk over the whole window into f32 shared memory,
//      bias, relu6, out-of-image mask (each thread a 4 x 4 register tile
//      of (mid channel, window pixel), a 4-wide weight vector broadcast);
//   2. depthwise 3x3 at stride S from that window, bias, relu6, rounded;
//   3. the chunk's project product into an f32 [Cout, TH*TW] accumulator
//      in shared memory (4 x 4 register tiles of (out channel, pixel)).
// The host picks TH, TW and MC per block shape (the accumulator is what
// bounds the tile at Cout = 320). The window overlap of neighbouring tiles
// is recomputed (the 1-pixel halo), the cost of keeping mid on chip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemMax = 227 * 1024;

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

__device__ __forceinline__ float relu6(float v) {
  return fminf(fmaxf(v, 0.f), 6.f);
}

// four consecutive values as f32 (16-byte or 8-byte aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

struct InvResArgs {
  const void* x;
  const void* wexp;    // [Cmid, Cin] compute dtype, null: no expand
  const float* bexp;
  const float* wdw;    // [Cmid, 9] f32
  const float* bdw;
  const void* wproj;   // [Cout, Cmid] compute dtype
  const float* bproj;
  void* out;
  int B, Cin, Cmid, Cout, H, W, Ho, Wo, TH, TW, MC, residual;
};

// Shared memory layout (floats, then the input window in T); the Python
// side (kernels/chw_ops.py::inv_res_smem) computes the same size.
template <typename T>
__host__ __device__ inline size_t smem_bytes(int Cin, int MC, int Cout,
                                             int P, int WINP) {
  return 4 * (size_t)(Cout * P + MC * P + MC * WINP + Cin * MC + MC * Cout +
                      round4(9 * MC) + 2 * MC) +
         sizeof(T) * (size_t)Cin * WINP;
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads) inv_res_kernel(InvResArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int TH = a.TH, TW = a.TW, MC = a.MC;
  const int Cin = a.Cin, Cout = a.Cout, P = TH * TW;
  const int WH = S * TH + 3 - S, WW = S * TW + 3 - S;
  const int WIN = WH * WW, WINP = round4(WIN);
  float* acc_s = smem;                    // [Cout][P]  project sums
  float* d_s = acc_s + Cout * P;          // [MC][P]    rounded dw output
  float* mid_s = d_s + MC * P;            // [MC][WINP] expanded window
  float* we_s = mid_s + MC * WINP;        // [Cin][MC]  expand weights
  float* wp_s = we_s + Cin * MC;          // [MC][Cout] project weights
  float* wdw_s = wp_s + MC * Cout;        // [MC][9]
  float* be_s = wdw_s + round4(9 * MC);   // [MC]
  float* bd_s = be_s + MC;                // [MC]
  T* x_s = reinterpret_cast<T*>(bd_s + MC);  // [Cin][WINP]

  const int tid = threadIdx.x, b = blockIdx.z;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const int iy0 = S * oy0 - 1, ix0 = S * ox0 - 1;  // window origin
  const T* x = static_cast<const T*>(a.x) + (size_t)b * Cin * a.H * a.W;
  const T* wexp = static_cast<const T*>(a.wexp);
  const T* wproj = static_cast<const T*>(a.wproj);

  for (int i = tid; i < Cin * WINP; i += kThreads) {
    const int c = i / WINP, p = i - c * WINP;
    const int wy = p / WW, wx = p - wy * WW;
    const int gy = iy0 + wy, gx = ix0 + wx;
    T v = from_f32<T>(0.f);
    if (p < WIN && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W)
      v = x[((size_t)c * a.H + gy) * a.W + gx];
    x_s[i] = v;
  }
  for (int i = tid; i < Cout * P; i += kThreads) acc_s[i] = 0.f;

  for (int m0 = 0; m0 < a.Cmid; m0 += MC) {
    __syncthreads();  // x_s staged / the previous chunk's project is done
    if (wexp)
      for (int i = tid; i < Cin * MC; i += kThreads) {
        const int ci = i / MC, m = i - ci * MC;
        we_s[i] = to_f32(wexp[(size_t)(m0 + m) * Cin + ci]);
      }
    for (int i = tid; i < MC * Cout; i += kThreads) {
      const int m = i / Cout, co = i - m * Cout;
      wp_s[i] = to_f32(wproj[(size_t)co * a.Cmid + m0 + m]);
    }
    for (int i = tid; i < 9 * MC; i += kThreads)
      wdw_s[i] = a.wdw[(size_t)m0 * 9 + i];
    for (int i = tid; i < MC; i += kThreads) {
      be_s[i] = wexp ? a.bexp[m0 + i] : 0.f;
      bd_s[i] = a.bdw[m0 + i];
    }
    __syncthreads();

    // 1. mid over the window, f32, zero outside the image
    if (wexp) {
      const int nq = WINP / 4;
      for (int it = tid; it < (MC / 4) * nq; it += kThreads) {
        const int mq = it / nq, pq = it - mq * nq;
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        const T* xp = x_s + 4 * pq;
        const float* wq = we_s + 4 * mq;
        for (int ci = 0; ci < Cin; ++ci) {
          const float4 xv = load4(xp + ci * WINP);
          const float4 wv = load4(wq + ci * MC);
          const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
          const float ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = mac<T>(s[i][j], ws[i], xs[j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = 4 * pq + j, wy = p / WW, wx = p - wy * WW;
          const int gy = iy0 + wy, gx = ix0 + wx;
          const bool in =
              p < WIN && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mid_s[(4 * mq + i) * WINP + p] =
                in ? relu6(s[i][j] + be_s[4 * mq + i]) : 0.f;
        }
      }
    } else {
      for (int i = tid; i < MC * WINP; i += kThreads)
        mid_s[i] = to_f32(x_s[m0 * WINP + i]);
    }
    __syncthreads();

    // 2. depthwise 3x3, stride S, f32; bias, relu6, one rounding
    for (int it = tid; it < MC * P; it += kThreads) {
      const int m = it / P, p = it - m * P;
      const int oy = p / TW, ox = p - oy * TW;
      const float* mp = mid_s + m * WINP + S * oy * WW + S * ox;
      const float* wk = wdw_s + 9 * m;
      float s = 0.f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
          s = mac<float>(s, wk[3 * ky + kx], mp[ky * WW + kx]);
      d_s[it] = to_f32(from_f32<T>(relu6(s + bd_s[m])));
    }
    __syncthreads();

    // 3. project the chunk into the f32 accumulator
    const int np = P / 4;
    for (int it = tid; it < (Cout / 4) * np; it += kThreads) {
      const int cq = it / np, pq = it - cq * np;
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = load4(acc_s + (4 * cq + i) * P + 4 * pq);
        s[i][0] = v.x; s[i][1] = v.y; s[i][2] = v.z; s[i][3] = v.w;
      }
      for (int m = 0; m < MC; ++m) {
        const float4 dv = load4(d_s + m * P + 4 * pq);
        const float4 wv = load4(wp_s + m * Cout + 4 * cq);
        const float ds[4] = {dv.x, dv.y, dv.z, dv.w};
        const float ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = mac<T>(s[i][j], ws[i], ds[j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(acc_s + (4 * cq + i) * P + 4 * pq) =
            make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
  }
  __syncthreads();

  // + bias, + residual (the input upcast), one rounding
  T* out = static_cast<T*>(a.out) + (size_t)b * Cout * a.Ho * a.Wo;
  for (int i = tid; i < Cout * P; i += kThreads) {
    const int co = i / P, p = i - co * P;
    const int oy = p / TW, ox = p - oy * TW;
    const int gy = oy0 + oy, gx = ox0 + ox;
    if (gy < a.Ho && gx < a.Wo) {
      float y = acc_s[i] + a.bproj[co];
      if (a.residual) y += to_f32(x_s[co * WINP + (oy + 1) * WW + ox + 1]);
      out[((size_t)co * a.Ho + gy) * a.Wo + gx] = from_f32<T>(y);
    }
  }
}

template <typename T, int S>
int launch(const InvResArgs& a, cudaStream_t s) {
  const int WINP = round4((S * a.TH + 3 - S) * (S * a.TW + 3 - S));
  const size_t smem =
      smem_bytes<T>(a.Cin, a.MC, a.Cout, a.TH * a.TW, WINP);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        inv_res_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.Wo + a.TW - 1) / a.TW, (a.Ho + a.TH - 1) / a.TH, a.B);
  inv_res_kernel<T, S><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// TH x TW is the output tile (TW % 4 == 0), MC the mid-channel chunk
// (MC % 4 == 0, Cmid % MC == 0); Cout % 4 == 0. wexp/bexp null: no expand.
extern "C" int segtpu_inv_res(const void* x, const void* wexp,
                              const float* bexp, const float* wdw,
                              const float* bdw, const void* wproj,
                              const float* bproj, void* out, int B, int Cin,
                              int Cmid, int Cout, int H, int W, int stride,
                              int TH, int TW, int MC, int residual, int bf16,
                              void* stream) {
  if (TW % 4 || MC % 4 || Cmid % MC || Cout % 4 || (stride != 1 && stride != 2) ||
      (!wexp && Cmid != Cin) || (residual && (stride != 1 || Cin != Cout)))
    return (int)cudaErrorInvalidValue;
  InvResArgs a{x,   wexp, bexp, wdw, bdw,       wproj,     bproj, out, B, Cin,
               Cmid, Cout, H,   W,   H / stride, W / stride, TH,   TW,  MC,
               residual};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return stride == 1 ? launch<__nv_bfloat16, 1>(a, s)
                       : launch<__nv_bfloat16, 2>(a, s);
  return stride == 1 ? launch<float, 1>(a, s) : launch<float, 2>(a, s);
}
