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
// encoder at 8 x 1024 x 2048 move ~1.3 GB (~0.4 ms at 3.35 TB/s) and do
// ~166 GFLOP of products (~0.17 ms on bf16 tensor cores, ~2.8 ms in f32 on
// the CUDA cores) and ~14 GFLOP of f32 depthwise taps (~0.2 ms).
//
// inv_res_kernel (CUDA cores; f32, and bf16 on every serving path): one
// block of 256 threads per (image, TH x TW output tile). It stages the
// input window (the tile's receptive field) for all Cin channels in
// shared memory once, then walks the mid channels in chunks of MC:
//   1. expand the chunk over the whole window into f32 shared memory,
//      bias, relu6, out-of-image mask (each thread a 4 x 4 register tile
//      of (mid channel, window pixel), a 4-wide weight vector broadcast);
//   2. depthwise 3x3 at stride S from that window, bias, relu6, rounded;
//   3. the chunk's project product into an f32 [Cout, TH*TW] accumulator
//      in shared memory (4 x 4 register tiles of (out channel, pixel)).
// Every sum in the twin's order: the two agree bit for bit. The host picks
// TH, TW and MC per block shape (kernels/chw_ops.py::inv_res_tile).
//
// inv_res_tc_kernel (tensor cores, bf16): the same tile and chunk walk,
// with both products as mma.sync m16n8k16 bf16 x bf16 -> f32. Every operand
// is already exact bf16 (x, the weights, the rounded depthwise output), so
// the products are exact and only the order of the f32 sums differs from
// the twin's: it is (16 channels at a time, ascending, chunk after chunk)
// for every pixel wherever it sits in a tile, a shard's rows or a batch,
// so the kernel's results do not depend on the plan.
// - Staging: the input window, from an 8-aligned image column so that
//   16-byte cp.async copies land it ([32 channels][rows][staged cols]),
//   is copied channel-innermost into xt [window pixel][Cin16 + 8] (Cin
//   padded to 16 with zero channels, 24 -> 32): the expand's A operand,
//   any pixel a row of plain ldmatrix.
// - Expand: M = window pixels (padded to 16), N = the chunk's MC mid
//   channels, K = Cin16; weights packed by the caller ([Cmid][Cin16],
//   chw_ops.pack_weights) and staged per chunk. The f32 fragments get the
//   bias, relu6 and the out-of-image mask (zero: the depthwise input's
//   padding) and go to f32 mid [MC][rows][cols], never rounded. The
//   block without an expand (t = 1) runs the same product on an identity
//   (x itself, exactly), without bias or relu6.
// - Depthwise: f32 on the CUDA cores in the twin's tap order, a thread 4
//   outputs of one channel (vector reads of its window rows; lanes on
//   consecutive channels, each channel's plane 4 mod 16 floats, so reads
//   and stores spread over the banks), bias, relu6, rounded once into d
//   [pixel][MC + 8]: the project's A operand.
// - Project: M = tile pixels, N = Cout padded to 16, K = the chunk; the
//   accumulators stay in registers across all chunks. The 8 warps split
//   the tile into WM x WN parts of MT m16 tiles and NT16 n16 tiles (the
//   plan: 16 NT16 WN = Cout16, 16 MT WM = TH TW, WM WN = 8), so Cout 320
//   is four warps of 80 channels over 64 or 32 pixels.
// - Each chunk's project weights are fetched while its expand runs and
//   the next chunk's expand and depthwise weights while its depthwise
//   runs; then + bias, + residual (the input from xt), one rounding.
// The host plans TH, TW, MC, MT and NT16 (chw_ops.inv_res_tc_plan) and
// passes the shared bytes its mirror of the layout counts
// (chw_ops.inv_res_tc_smem); the entry checks them against its own. Its
// wrapper is chw_ops.inv_res_tc_chw, which no serving path calls: through
// the encoder this kernel's sum order moves the served masks further from
// the twins' than the slice checks allow, so the encoder's bf16 blocks run
// inv_res_kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

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


// ------------------------------------------- bf16: tensor cores (mma.sync)

namespace tc {

using namespace segtpu;

constexpr int kRC = 32;   // input channels per staged raw window

struct TcArgs {
  const uint16_t* x;       // [B, Cin, H, W] bf16
  const uint16_t* wexp;    // packed [Cmid][Cin16] bf16, null: no expand
  const float* bexp;       // [Cmid]
  const float* wdw;        // [Cmid, 9] f32
  const float* bdw;        // [Cmid]
  const uint16_t* wproj;   // packed [r8(Cout)][Cmid] bf16
  const float* bproj;      // [Cout]
  uint16_t* out;           // [B, Cout, Ho, Wo]
  int B, Cin, Cmid, Cout, H, W, Ho, Wo, TH, TW, MC, WN, residual;
};

// Sizes of a tile: window rows and columns (and their count, padded to
// 16), staged columns, the f32 window's row pitch and plane, padded
// channel counts and pitches.
struct Geo {
  int wh, ww, win, win16, swa, wwp, plane, cin16, cinp, cout16, dp, p;
};
__host__ __device__ inline Geo geo(int S, int Cin, int Cout, int TH, int TW,
                                   int MC) {
  Geo g;
  g.wh = S * TH + 3 - S;
  g.ww = S * TW + 3 - S;
  g.win = g.wh * g.ww;
  g.win16 = r16(g.win);
  g.swa = r8(7 + g.ww);
  g.wwp = round4(g.ww);
  // a channel's plane: 4 mod 16 floats, so that lanes on consecutive
  // channels read and write distinct banks
  g.plane = ((g.wh * g.wwp + 11) & ~15) + 4;
  g.cin16 = r16(Cin);
  g.cinp = g.cin16 + 8;
  g.cout16 = r16(Cout);
  g.dp = MC + 8;
  g.p = TH * TW;
  return g;
}

// Shared memory (chw_ops.inv_res_tc_smem): two buffers of the chunk's f32
// depthwise weights [r4(9 MC)], expand bias [MC] and depthwise bias [MC];
// then f32 mid [MC][plane] (rows of wwp) with bf16 d [P][MC + 8] behind
// it, the raw window [32][wh][swa] (bf16) over both; bf16 xt [win16][Cin16
// + 8], the chunk's expand weights [MC][Cin16 + 8] (an identity without an
// expand) and project weights [Cout16][MC + 8].
struct Layout {
  float* small;
  float* mid;
  uint16_t *d, *raw, *xt, *we, *wp;
  int nsmall;
};
__host__ __device__ inline int layout(const Geo& g, int MC,
                                      unsigned char* base, Layout* l) {
  const int nsmall = round4(9 * MC) + 2 * MC;
  const int small = 4 * 2 * nsmall;
  const int mid = 4 * MC * g.plane, d = 2 * g.p * g.dp;
  const int raw = 2 * (g.cin16 < kRC ? g.cin16 : kRC) * g.wh * g.swa;
  const int u = mid + d > raw ? mid + d : raw;
  const int xt = 2 * g.win16 * g.cinp;
  const int we = 2 * MC * g.cinp;
  if (l) {
    l->small = reinterpret_cast<float*>(base);
    l->mid = reinterpret_cast<float*>(base + small);
    l->d = reinterpret_cast<uint16_t*>(base + small + mid);
    l->raw = reinterpret_cast<uint16_t*>(base + small);
    l->xt = reinterpret_cast<uint16_t*>(base + small + u);
    l->we = reinterpret_cast<uint16_t*>(base + small + u + xt);
    l->wp = reinterpret_cast<uint16_t*>(base + small + u + xt + we);
    l->nsmall = nsmall;
  }
  return small + u + xt + we + 2 * g.cout16 * g.dp;
}

// 4 bytes global -> shared, asynchronously.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// raw[c][sy][sx] = x[c0 + c][y0 + sy][ax0 + sx] for c < rc, zero outside
// the image and past Cin; 16-byte cp.async copies when W and x allow
// (ax0 is 8-aligned, so a group of 8 columns is wholly in or out).
__device__ __forceinline__ void stage_raw(const uint16_t* x, int Cin, int c0,
                                          int rc, int H, int W, int y0,
                                          int ax0, int wh, int swa, bool vec,
                                          uint16_t* raw) {
  if (vec) {
    const int q = swa / 8, n = rc * wh * q;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int j = i % q, r = i / q, sy = r % wh, c = r / wh;
      const int gy = y0 + sy, gx = ax0 + 8 * j;
      const bool ok = c0 + c < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16(raw + 8 * i,
                 ok ? x + ((size_t)(c0 + c) * H + gy) * W + gx : x,
                 ok ? 16 : 0);
    }
  } else {
    const int n = rc * wh * swa;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int sx = i % swa, r = i / swa, sy = r % wh, c = r / wh;
      const int gy = y0 + sy, gx = ax0 + sx;
      uint16_t v = 0;
      if (c0 + c < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = __ldg(x + ((size_t)(c0 + c) * H + gy) * W + gx);
      raw[i] = v;
    }
  }
}

// The expand of one m16 tile of window pixels and 16 NE mid channels from
// n0: f32 fragments, + bias, relu6, zero outside the image, into mid.
// Without an expand the weights are an identity and the products x
// itself, exactly: no bias, no relu6.
template <int NE>
__device__ __forceinline__ void expand_unit(const Layout& l, const Geo& g,
                                            int mt, int n0, const float* be,
                                            bool expand, int iy0, int ix0,
                                            int H, int W) {
  const int lane = threadIdx.x % 32;
  float acc[2 * NE][4];
#pragma unroll
  for (int i = 0; i < 2 * NE; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;
  for (int kk = 0; kk < g.cin16 / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, l.xt + (16 * mt + (lane & 15)) * g.cinp + 16 * kk +
                    (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NE; ++j) {
      uint32_t bf[4];
      ldsm_x4(bf, l.we + (n0 + 16 * j + (lane & 7) + ((lane >> 4) << 3)) *
                             g.cinp +
                      16 * kk + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * j], af, bf[0], bf[1]);
      mma_bf16(acc[2 * j + 1], af, bf[2], bf[3]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = 16 * mt + (lane >> 2) + 8 * h;
    if (p >= g.win) continue;
    const int wy = p / g.ww, wx = p - wy * g.ww;
    const int gy = iy0 + wy, gx = ix0 + wx;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    float* mp = l.mid + wy * g.wwp + wx;
#pragma unroll
    for (int nt = 0; nt < 2 * NE; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = n0 + 8 * nt + 2 * (lane & 3) + e;
        const float v = acc[nt][2 * h + e];
        mp[m * g.plane] = !in ? 0.f : expand ? relu6(v + be[m]) : v;
      }
  }
}

// Depthwise 3x3 at stride S of one channel's f32 window, 4 outputs of a
// tile row from window column 4 S j: the twin's tap order (row-major,
// product and sum each rounded), + bias, relu6, one rounding into d.
template <int S>
__device__ __forceinline__ void dw_four(const float* mp, int wwp,
                                        const float* wk, float bias,
                                        uint16_t* dp, int pitch) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const float* row = mp + ky * wwp;
    float v[4 * S + 2];
    const float4 a = *reinterpret_cast<const float4*>(row);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    if (S == 1) {
      const float2 b = *reinterpret_cast<const float2*>(row + 4);
      v[4] = b.x; v[5] = b.y;
    } else {
      const float4 b = *reinterpret_cast<const float4*>(row + 4);
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      v[8] = row[8];
    }
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const float w = wk[3 * ky + kx];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        s[u] = __fadd_rn(s[u], __fmul_rn(w, v[S * u + kx]));
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
    dp[u * pitch] = f32_to_bf16_bits(relu6(s[u] + bias));
}

template <int S, int MT, int NT16>
__global__ void __launch_bounds__(kThreads, MT * NT16 <= 5 ? 2 : 1)
    inv_res_tc_kernel(const __grid_constant__ TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int MC = a.MC, TH = a.TH, TW = a.TW;
  const Geo g = geo(S, a.Cin, a.Cout, TH, TW, MC);
  const bool expand = a.wexp != nullptr;
  Layout l;
  layout(g, MC, smem, &l);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const int iy0 = S * oy0 - 1, ix0 = S * ox0 - 1;
  const int ax0 = ix0 & ~7, off = ix0 - ax0;   // 8-aligned staged columns
  const uint16_t* x = a.x + (size_t)b * a.Cin * a.H * a.W;
  const bool vec =
      a.W % 8 == 0 && (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;
  const int nchunk = a.Cmid / MC;

  // chunk c's expand weights and f32 depthwise weights and biases
  auto fetch_small = [&](int c) {
    const int m0 = c * MC;
    const int q = g.cin16 / 8;
    for (int i = tid; i < MC * q; i += kThreads) {
      const int r = i / q, j = i - r * q;
      if (expand) {
        cp_async16(l.we + r * g.cinp + 8 * j,
                   a.wexp + (size_t)(m0 + r) * g.cin16 + 8 * j, 16);
      } else {   // row r picks input channel m0 + r (bf16 1.0 = 0x3f80)
        uint16_t* w = l.we + r * g.cinp + 8 * j;
        for (int e = 0; e < 8; ++e) w[e] = 8 * j + e == m0 + r ? 0x3f80 : 0;
      }
    }
    float* sm = l.small + (c & 1) * l.nsmall;
    for (int i = tid; i < 9 * MC; i += kThreads)
      cp_async4(sm + i, a.wdw + (size_t)m0 * 9 + i);
    float* be = sm + round4(9 * MC);
    for (int i = tid; i < MC; i += kThreads) {
      if (expand) cp_async4(be + i, a.bexp + m0 + i);
      cp_async4(be + MC + i, a.bdw + m0 + i);
    }
  };
  // chunk c's project weights, rows past r8(Cout) zero
  auto fetch_wp = [&](int c) {
    const int q = MC / 8, np = r8(a.Cout);
    for (int i = tid; i < g.cout16 * q; i += kThreads) {
      const int co = i / q, j = i - co * q;
      const bool ok = co < np;
      cp_async16(l.wp + co * g.dp + 8 * j,
                 ok ? a.wproj + (size_t)co * a.Cmid + c * MC + 8 * j
                    : a.wproj,
                 ok ? 16 : 0);
    }
  };

  fetch_small(0);
  // the input window, kRC channels at a time, channel-innermost into xt
  const int rc = g.cin16 < kRC ? g.cin16 : kRC;
  for (int c0 = 0; c0 < g.cin16; c0 += rc) {
    stage_raw(x, a.Cin, c0, rc, a.H, a.W, iy0, ax0, g.wh, g.swa, vec, l.raw);
    cp_async_wait_all();
    __syncthreads();
    const int cs = g.wh * g.swa;
    for (int i = tid; i < (rc / 8) * g.win16; i += kThreads) {
      const int q = i / g.win16, p = i - q * g.win16;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (p < g.win) {
        const int wy = p / g.ww, wx = p - wy * g.ww;
        const uint16_t* s = l.raw + 8 * q * cs + wy * g.swa + off + wx;
        v.x = s[0] | ((uint32_t)s[cs] << 16);
        v.y = s[2 * cs] | ((uint32_t)s[3 * cs] << 16);
        v.z = s[4 * cs] | ((uint32_t)s[5 * cs] << 16);
        v.w = s[6 * cs] | ((uint32_t)s[7 * cs] << 16);
      }
      *reinterpret_cast<uint4*>(l.xt + p * g.cinp + c0 + 8 * q) = v;
    }
    __syncthreads();
  }

  float acc[MT][2 * NT16][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2 * NT16; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
  const int wn = warp % a.WN, wm = warp / a.WN;
  // runs of 4 outputs in a tile row: a power of 2
  const int runs = TW / 4, lr = __ffs(runs) - 1;

  for (int c = 0; c < nchunk; ++c) {
    cp_async_wait_all();
    __syncthreads();   // chunk c's expand weights landed, project c-1 done
    fetch_wp(c);
    cp_async_commit();
    const float* wdw = l.small + (c & 1) * l.nsmall;
    const float* be = wdw + round4(9 * MC);
    const float* bd = be + MC;

    // 1. mid over the window, f32, zero outside the image
    {
      const int npass = (MC + 31) / 32, units = (g.win16 / 16) * npass;
      for (int u = warp; u < units; u += kThreads / 32) {
        const int mt = u / npass, n0 = 32 * (u - mt * npass);
        if (n0 + 32 <= MC)
          expand_unit<2>(l, g, mt, n0, be, expand, iy0, ix0, a.H, a.W);
        else
          expand_unit<1>(l, g, mt, n0, be, expand, iy0, ix0, a.H, a.W);
      }
    }
    __syncthreads();   // mid is complete; the expand weights are free
    if (c + 1 < nchunk) fetch_small(c + 1);
    cp_async_commit();

    // 2. depthwise 3x3 at stride S, f32; bias, relu6, one rounding;
    //    lanes on consecutive channels of one run of 4 outputs
    for (int it = tid; it < MC * TH * runs; it += kThreads) {
      const int r = it / MC, m = it - r * MC;
      const int oy = r >> lr, j = r & (runs - 1);
      dw_four<S>(l.mid + m * g.plane + S * oy * g.wwp + 4 * S * j, g.wwp,
                 wdw + 9 * m, bd[m], l.d + (oy * TW + 4 * j) * g.dp + m,
                 g.dp);
    }
    cp_async_wait<1>();
    __syncthreads();   // d is complete; chunk c's project weights landed

    // 3. the chunk's project products into the register accumulators
    for (int kk = 0; kk < MC / 16; ++kk) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(af[mt], l.d + ((wm * MT + mt) * 16 + (lane & 15)) * g.dp +
                            16 * kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT16; ++j) {
        uint32_t bf[4];
        ldsm_x4(bf, l.wp + ((wn * NT16 + j) * 16 + (lane & 7) +
                            ((lane >> 4) << 3)) * g.dp +
                        16 * kk + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * j], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * j + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }

  // + bias, + residual (the input upcast), one rounding
  uint16_t* out = a.out + (size_t)b * a.Cout * a.Ho * a.Wo;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = (wm * MT + mt) * 16 + (lane >> 2) + 8 * h;
      const int oy = q / TW, ox = q - oy * TW;
      const int gy = oy0 + oy, gx = ox0 + ox;
      if (gy >= a.Ho || gx >= a.Wo) continue;
      const uint16_t* xr = l.xt + ((oy + 1) * g.ww + ox + 1) * g.cinp;
#pragma unroll
      for (int nt = 0; nt < 2 * NT16; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = (wn * NT16) * 16 + 8 * nt + 2 * (lane & 3) + e;
          if (co >= a.Cout) continue;
          float y = acc[mt][nt][2 * h + e] + __ldg(a.bproj + co);
          if (a.residual) y += bf16_bits_to_f32(xr[co]);
          out[((size_t)co * a.Ho + gy) * a.Wo + gx] = f32_to_bf16_bits(y);
        }
    }
}

template <int S, int MT, int NT16>
int launch_tc(const TcArgs& a, int smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        inv_res_tc_kernel<S, MT, NT16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.Wo + a.TW - 1) / a.TW, (a.Ho + a.TH - 1) / a.TH, a.B);
  inv_res_tc_kernel<S, MT, NT16><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int S, int MT>
int launch_nt(const TcArgs& a, int nt16, int smem, cudaStream_t s) {
  switch (nt16) {
    case 1: return launch_tc<S, MT, 1>(a, smem, s);
    case 2: return launch_tc<S, MT, 2>(a, smem, s);
    case 3: return launch_tc<S, MT, 3>(a, smem, s);
    case 4: return launch_tc<S, MT, 4>(a, smem, s);
    case 5: return launch_tc<S, MT, 5>(a, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int S>
int launch_mt(const TcArgs& a, int mt, int nt16, int smem, cudaStream_t s) {
  return mt == 1 ? launch_nt<S, 1>(a, nt16, smem, s)
                 : launch_nt<S, 2>(a, nt16, smem, s);
}

}  // namespace tc

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

// The bf16 tensor-core kernel. x, wexp, wproj bf16; wexp/wproj packed by
// chw_ops.pack_weights ([Cmid][Cin16], [r8(Cout)][Cmid]); wexp/bexp null:
// no expand. TH x TW output tile (TW % 4 == 0), MC mid channels a chunk
// (MC % 16 == 0, Cmid % MC == 0), MT m16 and NT16 n16 tiles a warp with
// WN = Cout16 / (16 NT16) warps across Cout and 8 / WN across the tile's
// pixels (TH TW = 16 MT 8 / WN); smem must be the layout's byte count
// (chw_ops.inv_res_tc_plan and inv_res_tc_smem). Returns the cudaError_t
// of the launch (0 = ok).
extern "C" int segtpu_inv_res_tc(const void* x, const void* wexp,
                                 const float* bexp, const float* wdw,
                                 const float* bdw, const void* wproj,
                                 const float* bproj, void* out, int B,
                                 int Cin, int Cmid, int Cout, int H, int W,
                                 int stride, int TH, int TW, int MC, int MT,
                                 int NT16, int residual, int smem,
                                 void* stream) {
  const int c16 = segtpu::r16(Cout);
  const int WN = NT16 > 0 && c16 % (16 * NT16) == 0 ? c16 / (16 * NT16) : 0;
  if ((stride != 1 && stride != 2) || TH < 1 || TW < 4 || TW % 4 ||
      MC < 16 || MC % 16 || Cmid % MC || (MT != 1 && MT != 2) || NT16 < 1 ||
      NT16 > 5 || (WN != 1 && WN != 2 && WN != 4 && WN != 8) ||
      TH * TW != 16 * MT * (8 / WN) || (!wexp && Cmid != Cin) ||
      (residual && (stride != 1 || Cin != Cout)) ||
      (reinterpret_cast<uintptr_t>(wexp) | reinterpret_cast<uintptr_t>(wproj)) &
          15)
    return (int)cudaErrorInvalidValue;
  const tc::Geo g = tc::geo(stride, Cin, Cout, TH, TW, MC);
  if (tc::layout(g, MC, nullptr, nullptr) != smem ||
      smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  tc::TcArgs a{static_cast<const uint16_t*>(x),
               static_cast<const uint16_t*>(wexp),
               bexp,
               wdw,
               bdw,
               static_cast<const uint16_t*>(wproj),
               bproj,
               static_cast<uint16_t*>(out),
               B, Cin, Cmid, Cout, H, W, H / stride, W / stride, TH, TW, MC,
               WN, residual};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return stride == 1 ? tc::launch_mt<1>(a, MT, NT16, smem, s)
                     : tc::launch_mt<2>(a, MT, NT16, smem, s);
}
