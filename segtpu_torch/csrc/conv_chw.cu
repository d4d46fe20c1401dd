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
// once: the order of the plain twin (kernels/chw_ops.py), which every
// kernel here matches bit for bit.
//
// Bound on the H100, bytes for both forms on the main path. The s2d stem,
// k = 2, 12 -> 32 channels at 8 x 512 x 1024: 101 MB read + 268 MB written
// (0.11 ms at 3.35 TB/s) and 6.44 G multiply-adds (0.013 ms at the bf16
// tensor-core rate; 0.217 ms as f32 FMAs at the 59.5 TFLOP/s measured on
// the card, the floor of a design that keeps the twin's sum order).
// The decoder's three 1x1s (48 -> 48 at 8 x 64 x 128 and 8 x 128 x 256,
// 48 -> 19 at 8 x 256 x 512): 203 MB (0.061 ms) and 1.71 G multiply-adds
// (0.058 ms at the 59.5 TFLOP/s f32 FMA rate measured on the card).
//
// k = 3, 5 and dilated k = 2 dense, and every depthwise form
// (conv_dense_kernel, conv_depthwise_kernel), a simple first version:
// a block owns an 8 x 32 output tile of one image and a group of COB output
// channels (dense) or CC channels (depthwise). It stages a chunk of input
// channels, tile plus halo, in shared memory as f32 with the zero padding
// written in, and (dense) the chunk's weights as [c][tap][COB] f32, so that
// one thread per output pixel reads one input value per tap and a 4-wide
// weight vector broadcast to the warp for every 4 output channels it
// accumulates in registers. Every input value staged is reused COB times.
//
// k = 2 dense at dilation 1, the stem (conv_k2_kernel): the multiply-adds
// bound it, so every instruction beside them counts. A block takes up to
// eight channel groups (all 32 channels of the stem) over row segments of S = 32 *
// PX * np pixels of one image (two segments of 512 a stem row). One warp
// per group of CO channels and segment part, each thread a register tile
// of CO channels x PX consecutive pixels (8 x 8 for the stem: 256
// multiply-adds per input channel against two 16-byte reads of its two
// input rows, two shuffles for the pixel left of its tile and eight
// 16-byte weight broadcasts). The block is persistent: its f32 weights
// [c][tap][channel] and biases are staged once, then it walks items (an
// output row segment) blockIdx.x, + gridDim.x, ... of all images, each
// item's input chunks of kc channels one step of a ring of four buffers
// filled by 16-byte cp.async in x's dtype, three steps ahead across items:
// rows y - 1 and y of the chunk, the segment plus one 16-byte chunk of
// halo on its left, zero outside the image. The epilogue stores PX pixels
// of a channel as one 16-byte store. stem_plan (kernels/chw_ops.py) picks
// (CO, PX, ng, np, kc) and the C entry checks it against conv_k2_smem. A
// width that is not a multiple of 8, or a plane that is not 16-byte
// aligned, takes scalar loads and stores, cut at the ragged right edge.
//
// k = 1 dense (conv1x1_kernel): no halo, so a block takes up to 96 output
// channels (all of Cout 19 and 48) over runs of 32 * PX pixels of one image
// and reads every input byte once. One warp per group of CO channels,
// each thread a register tile of CO channels x PX pixels (pw_tile.cuh; the
// plan's 12 x 4 is within 2 % of the fastest tile at both path shapes).
// The block is persistent: its weights and biases are staged once, then
// it walks runs blockIdx.x, + gridDim.x, ... of all images, each run's
// input chunks of kc channels one step of a ring of four buffers filled by
// 16-byte cp.async, three steps ahead across runs; the epilogue stores PX
// pixels at a time. conv1x1_plan (kernels/chw_ops.py) picks (CO, PX, ng,
// kc) and the C entry checks it against conv1x1_smem. A channel plane that
// is not 16-byte aligned takes scalar loads and stores.

#include "pw_tile.cuh"

using namespace segtpu;

namespace {

constexpr int kTH = 8, kTW = 32, kThreads = kTH * kTW;
constexpr int kSmemBudget = 48 * 1024;      // bytes per block we aim for
constexpr int kSmemMax = 227 * 1024;        // opt-in maximum on the H100

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

// ---------------------------------------------------------------- k = 1

constexpr int k1Lanes = 32;     // pixel threads of a channel group: a warp
constexpr int k1MaxGroups = 8;  // channel groups (warps) of a block
constexpr int k1Stages = 4;     // chunk buffers: three in flight, one read

// The plan of a k = 1 dense launch (kernels/chw_ops.py conv1x1_plan): CO
// channels x PX pixels a thread, ng channel groups of one warp each (a
// block's ng * CO channels over runs of P = 32 * PX pixels), kc input
// channels a staged chunk, `groups` blocks along Cout, `smem` bytes; vec:
// the 16-byte path.
struct Plan1x1 {
  int co, px, ng, kc, groups, smem, vec;
};

// Shared bytes of a plan: the f32 weights [C][ng * CO] and bias [ng * CO],
// then k1Stages chunks [kc][P] of the input in T.
inline int conv1x1_smem(int C, const Plan1x1& p, int elt) {
  return 4 * (C + 1) * p.ng * p.co + k1Stages * p.kc * k1Lanes * p.px * elt;
}

// The epilogue of a thread's tile at pixels [q, q + min(PX, left)) of
// image b: bias, activation, + add, + vec, one rounding (store_out's
// order), PX pixels a store on the vector path. bias: the thread's CO
// biases (shared memory).
template <typename T, int CO, int PX>
__device__ __forceinline__ void store_1x1(const ConvArgs& a,
                                          const float (&acc)[CO][PX],
                                          const float* bias, int b,
                                          long long hw, long long q, int left,
                                          int cg, bool vec) {
  const T* add = static_cast<const T*>(a.add);
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int j = 0; j < CO; ++j) {
    const int co = cg + j;
    if (co < a.Cout) {
      const size_t o = ((size_t)b * a.Cout + co) * hw + q;
      const float vv = a.vec ? a.vec[(size_t)b * a.Cout + co] : 0.f;
      float y[PX];
#pragma unroll
      for (int k = 0; k < PX; ++k) y[k] = activate(acc[j][k] + bias[j], a.act);
      if (vec) {              // hw % 8 == 0: the PX pixels are all in
        if (add) {
          float av[PX];
          load_px<PX>(add + o, av);
#pragma unroll
          for (int k = 0; k < PX; ++k) y[k] += av[k];
        }
        if (a.vec) {
#pragma unroll
          for (int k = 0; k < PX; ++k) y[k] += vv;
        }
        store_px<PX>(out + o, y);
      } else {
#pragma unroll
        for (int k = 0; k < PX; ++k) {
          if (k < left) {
            float v = y[k];
            if (add) v += to_f32(add[o + k]);
            if (a.vec) v += vv;
            out[o + k] = from_f32<T>(v);
          }
        }
      }
    }
  }
}

// A persistent block: its channel group's weights and biases staged once,
// then the runs blockIdx.x, + gridDim.x, ... of all images (items), each
// run's input chunks one step of a ring of k1Stages buffers that never
// drains between runs.
template <typename T, int CO, int PX>
__global__ void __launch_bounds__(k1Lanes * k1MaxGroups)
    conv1x1_kernel(ConvArgs a, Plan1x1 p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int P = k1Lanes * PX;
  const int nt = k1Lanes * p.ng, cpb = p.ng * CO;
  float* w_s = smem;                                     // [C][cpb]
  float* b_s = smem + a.C * cpb;                         // [cpb]
  T* x_s = reinterpret_cast<T*>(b_s + cpb);              // ring [kc][P]
  const int g = threadIdx.x / k1Lanes, pix = (threadIdx.x % k1Lanes) * PX;
  const int co0 = blockIdx.y * cpb, cg = co0 + g * CO;
  const bool vec = p.vec != 0, busy = cg < a.Cout;   // busy: warp-uniform
  const long long hw = (long long)a.H * a.W;
  const int runs = (int)((hw + P - 1) / P), items = a.B * runs;
  const int nch = (a.C + p.kc - 1) / p.kc;
  const int mine = items > (int)blockIdx.x
                       ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int steps = mine * nch;
  const T* x = static_cast<const T*>(a.x);

  // step s: chunk s % nch of the block's run s / nch, into buffer s % k1Stages
  auto issue = [&](int s) {
    if (s < steps) {
      const int item = blockIdx.x + (s / nch) * gridDim.x, k = s % nch;
      const int b = item / runs;
      const long long p0 = (long long)(item - b * runs) * P;
      stage_px<T>(x_s + (s % k1Stages) * p.kc * P, P,
                  x + ((size_t)b * a.C + k * p.kc) * hw, hw, p0,
                  (int)min((long long)P, hw - p0),
                  min(p.kc, a.C - k * p.kc), vec, nt);
    }
    cp_async_commit();
  };
  for (int s = 0; s < k1Stages - 1; ++s) issue(s);
  stage_weights<T>(w_s, cpb, static_cast<const T*>(a.w), a.C, co0, a.Cout,
                   nt);
  for (int i = threadIdx.x; i < cpb; i += nt)
    b_s[i] = co0 + i < a.Cout ? a.bias[co0 + i] : 0.f;
  float acc[CO][PX];
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<k1Stages - 2>();    // step s has landed
    __syncthreads();                  // ... for every thread; s - 1 is read
    issue(s + k1Stages - 1);
    const int k = s % nch;
    if (k == 0) zero(acc);
    if (busy)
      tile_fma<T, CO, PX>(acc, x_s + (s % k1Stages) * p.kc * P + pix, P,
                          w_s + k * p.kc * cpb + g * CO, cpb,
                          min(p.kc, a.C - k * p.kc));
    if (k == nch - 1) {
      const int item = blockIdx.x + (s / nch) * gridDim.x;
      const int b = item / runs;
      const long long q = (long long)(item - b * runs) * P + pix;
      if (busy && q < hw)
        store_1x1<T, CO, PX>(a, acc, b_s + g * CO, b, hw, q,
                             (int)min((long long)PX, hw - q), cg, vec);
    }
  }
}

template <typename T, int CO, int PX>
int launch1x1(const ConvArgs& a, const Plan1x1& p, cudaStream_t s) {
  const auto kern = conv1x1_kernel<T, CO, PX>;
  int rc = set_smem(kern, p.smem);
  if (rc) return rc;
  const long long hw = (long long)a.H * a.W, P = k1Lanes * PX;
  const int nt = k1Lanes * p.ng;
  const int gx = resident_blocks(kern, nt, p.smem, a.B * ((hw + P - 1) / P),
                                 p.groups);
  if (gx < 1) return (int)cudaErrorInvalidValue;
  kern<<<dim3(gx, p.groups), nt, p.smem, s>>>(a, p);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// A plan this source has a layout for, or cudaErrorInvalidValue.
template <typename T>
int run_1x1(const ConvArgs& a, const Plan1x1& p, cudaStream_t s) {
  const int cpb = p.ng * p.co;
  const bool ok =
      p.ng >= 1 && p.ng <= k1MaxGroups && p.kc >= 1 && p.kc <= a.C &&
      p.groups >= 1 && p.groups * cpb >= a.Cout &&
      (p.groups - 1) * cpb < a.Cout &&
      p.smem == conv1x1_smem(a.C, p, (int)sizeof(T)) &&
      (!p.vec || ((long long)a.H * a.W % (p.px > 8 ? p.px : 8) == 0 &&
                  aligned16(a.x) &&
                  aligned16(a.out) && (!a.add || aligned16(a.add))));
  if (!ok) return (int)cudaErrorInvalidValue;
  switch (p.co * 100 + p.px) {
    case 2002: return launch1x1<T, 20, 2>(a, p, s);
    case 1204: return launch1x1<T, 12, 4>(a, p, s);
    case 1604: return launch1x1<T, 16, 4>(a, p, s);
    case 808: return launch1x1<T, 8, 8>(a, p, s);
    case 416: return launch1x1<T, 4, 16>(a, p, s);
    case 1208: return launch1x1<T, 12, 8>(a, p, s);
    case 408: return launch1x1<T, 4, 8>(a, p, s);
    case 804: return launch1x1<T, 8, 4>(a, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- k = 2

constexpr int k2Lanes = 32;     // pixel threads of a warp
constexpr int k2MaxWarps = 8;   // channel groups x segment parts of a block
constexpr int k2Stages = 4;     // chunk buffers: three in flight, one read

// The plan of a dense k = 2 launch at dilation 1 (kernels/chw_ops.py
// stem_plan): CO channels x PX pixels a thread, ng channel groups x np
// segment parts, one warp each (a block's ng * CO channels over row
// segments of S = np * 32 * PX pixels), kc input channels a staged chunk,
// `groups` blocks along Cout, `smem` bytes; vec: the 16-byte path.
struct PlanK2 {
  int co, px, ng, np, kc, groups, smem, vec;
};

// Elements of a staged row: one 16-byte chunk of halo, then the segment.
inline int k2_row(const PlanK2& p, int elt) {
  return 16 / elt + p.np * k2Lanes * p.px;
}

// Shared bytes of a plan: the f32 weights [C][4][ng * CO] and bias
// [ng * CO], then k2Stages chunks [kc][2][k2_row] of the input in T.
inline int conv_k2_smem(int C, const PlanK2& p, int elt) {
  return 4 * (4 * C + 1) * p.ng * p.co +
         k2Stages * p.kc * 2 * k2_row(p, elt) * elt;
}

// Starts copying input rows y - 1 and y of channels [0, cc) of src (one
// image's [C][H][W], offset to the chunk's first channel), columns
// [x0 - E, x0 - E + SR), into dst [cc][2][SR], zero outside the image (E:
// the elements of 16 bytes). One warp per staged row. vec: 16-byte
// cp.async (W a multiple of 8, src 16-byte aligned, x0 a multiple of E),
// to be committed and waited for by the caller; else plain loads and
// stores, visible after the next barrier.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int SR, const T* src,
                                           int H, int W, int y, int x0,
                                           int cc, bool vec, int NT) {
  constexpr int E = 16 / sizeof(T);
  const int lane = threadIdx.x % k2Lanes;
  for (int row = threadIdx.x / k2Lanes; row < 2 * cc; row += NT / k2Lanes) {
    const int gy = y - 1 + (row & 1);
    const long long base = ((long long)(row >> 1) * H + gy) * W;
    T* d = dst + row * SR;
    if (vec) {
      for (int j = lane * E; j < SR; j += k2Lanes * E) {
        const int gx = x0 - E + j;
        const bool in = gy >= 0 && gx >= 0 && gx < W;
        cp_async16(d + j, in ? src + base + gx : src, in ? 16 : 0);
      }
    } else {
      for (int j = lane; j < SR; j += k2Lanes) {
        const int gx = x0 - E + j;
        d[j] = gy >= 0 && gx >= 0 && gx < W ? src[base + gx]
                                             : from_f32<T>(0.f);
      }
    }
  }
}

// acc[o][k] += w[o] * (LEFT ? the pixel left of k : pixel k) of one input
// row; v holds the row at the thread's PX pixels, left the one before them.
template <typename T, int CO, int PX, bool LEFT>
__device__ __forceinline__ void k2_tap(float (&acc)[CO][PX], const float* w,
                                       float left, const float (&v)[PX]) {
  const float4* wp = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int q = 0; q < CO / 4; ++q) {
    const float4 wv = wp[q];
#pragma unroll
    for (int k = 0; k < PX; ++k) {
      const float xv = LEFT ? (k == 0 ? left : v[k > 0 ? k - 1 : 0]) : v[k];
      acc[4 * q + 0][k] = mac<T>(acc[4 * q + 0][k], wv.x, xv);
      acc[4 * q + 1][k] = mac<T>(acc[4 * q + 1][k], wv.y, xv);
      acc[4 * q + 2][k] = mac<T>(acc[4 * q + 2][k], wv.z, xv);
      acc[4 * q + 3][k] = mac<T>(acc[4 * q + 3][k], wv.w, xv);
    }
  }
}

// A persistent block: its channel group's weights and biases staged once,
// then the items blockIdx.x, + gridDim.x, ... (item: image b, output row
// y, segment x0 = seg * S; seg fastest), each item's input chunks one step
// of a ring of k2Stages buffers that never drains between items. For each
// input channel of a chunk, ascending, the four taps (-1, -1), (-1, 0),
// (0, -1), (0, 0) in turn: the twin's order.
template <typename T, int CO, int PX>
__global__ void __launch_bounds__(k2Lanes * k2MaxWarps, 2)
    conv_k2_kernel(ConvArgs a, PlanK2 p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int E = 16 / sizeof(T);
  const int S = p.np * k2Lanes * PX, SR = E + S, slot = p.kc * 2 * SR;
  const int nt = k2Lanes * p.ng * p.np, cpb = p.ng * CO;
  float* w_s = smem;                                     // [C][4][cpb]
  float* b_s = smem + 4 * a.C * cpb;                     // [cpb]
  T* x_s = reinterpret_cast<T*>(b_s + cpb);              // ring [kc][2][SR]
  const int warp = threadIdx.x / k2Lanes, lane = threadIdx.x % k2Lanes;
  const int g = warp % p.ng;
  const int pix = (warp / p.ng) * k2Lanes * PX + lane * PX;
  const int co0 = blockIdx.y * cpb, cg = co0 + g * CO;
  const bool vec = p.vec != 0, busy = cg < a.Cout;   // busy: warp-uniform
  const long long hw = (long long)a.H * a.W;
  const int nseg = (a.W + S - 1) / S, items = a.B * a.H * nseg;
  const int nch = (a.C + p.kc - 1) / p.kc;
  const int mine = items > (int)blockIdx.x
                       ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int steps = mine * nch;
  const T* x = static_cast<const T*>(a.x);

  // step s: chunk s % nch of the block's item s / nch
  auto item_of = [&](int s, int& b, int& y, int& x0) {
    const int item = blockIdx.x + (s / nch) * gridDim.x;
    const int row = item / nseg;
    x0 = (item - row * nseg) * S;
    b = row / a.H;
    y = row - b * a.H;
  };
  auto issue = [&](int s) {
    if (s < steps) {
      int b, y, x0;
      item_of(s, b, y, x0);
      const int k = s % nch;
      stage_rows<T>(x_s + (s % k2Stages) * slot, SR,
                    x + ((size_t)b * a.C + k * p.kc) * hw, a.H, a.W, y, x0,
                    min(p.kc, a.C - k * p.kc), vec, nt);
    }
    cp_async_commit();
  };
  for (int s = 0; s < k2Stages - 1; ++s) issue(s);
  const T* w = static_cast<const T*>(a.w);
  for (int i = threadIdx.x; i < 4 * a.C * cpb; i += nt) {
    const int o = i % cpb, ct = i / cpb;          // ct = c * 4 + tap
    w_s[i] = co0 + o < a.Cout ? to_f32(w[(size_t)(co0 + o) * 4 * a.C + ct])
                              : 0.f;
  }
  for (int i = threadIdx.x; i < cpb; i += nt)
    b_s[i] = co0 + i < a.Cout ? a.bias[co0 + i] : 0.f;
  float acc[CO][PX];
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<k2Stages - 2>();    // step s has landed
    __syncthreads();                  // ... for every thread; s - 1 is read
    issue(s + k2Stages - 1);
    const int k = s % nch;
    if (k == 0) zero(acc);
    if (busy) {
      const T* xs = x_s + (s % k2Stages) * slot + E + pix;
      const float* wk = w_s + 4 * k * p.kc * cpb + g * CO;
      const int cc = min(p.kc, a.C - k * p.kc);
      for (int c = 0; c < cc; ++c) {
        const T* r0 = xs + 2 * c * SR;     // row y - 1; row y is r0 + SR
        float u[PX], v[PX];
        load_px<PX>(r0, u);
        load_px<PX>(r0 + SR, v);
        // the pixel left of the tile: the next lane's last, or staged
        float ul = __shfl_up_sync(0xffffffffu, u[PX - 1], 1);
        float vl = __shfl_up_sync(0xffffffffu, v[PX - 1], 1);
        if (lane == 0) {
          ul = to_f32(r0[-1]);
          vl = to_f32(r0[SR - 1]);
        }
        const float* wc = wk + 4 * c * cpb;
        k2_tap<T, CO, PX, true>(acc, wc, ul, u);
        k2_tap<T, CO, PX, false>(acc, wc + cpb, 0.f, u);
        k2_tap<T, CO, PX, true>(acc, wc + 2 * cpb, vl, v);
        k2_tap<T, CO, PX, false>(acc, wc + 3 * cpb, 0.f, v);
      }
    }
    if (k == nch - 1 && busy) {
      int b, y, x0;
      item_of(s, b, y, x0);
      const int q = x0 + pix;
      if (q < a.W)
        store_1x1<T, CO, PX>(a, acc, b_s + g * CO, b, hw,
                             (long long)y * a.W + q, min(PX, a.W - q), cg,
                             vec);
    }
  }
}

template <typename T, int CO, int PX>
int launch_k2(const ConvArgs& a, const PlanK2& p, cudaStream_t s) {
  const auto kern = conv_k2_kernel<T, CO, PX>;
  int rc = set_smem(kern, p.smem);
  if (rc) return rc;
  const int S = p.np * k2Lanes * PX, nt = k2Lanes * p.ng * p.np;
  const long long items = (long long)a.B * a.H * ((a.W + S - 1) / S);
  const int gx = resident_blocks(kern, nt, p.smem, items, p.groups);
  if (gx < 1) return (int)cudaErrorInvalidValue;
  kern<<<dim3(gx, p.groups), nt, p.smem, s>>>(a, p);
  return (int)cudaGetLastError();
}

// A plan this source has a layout for, or cudaErrorInvalidValue.
template <typename T>
int run_k2(const ConvArgs& a, const PlanK2& p, cudaStream_t s) {
  const int cpb = p.ng * p.co;
  const bool ok =
      p.ng >= 1 && p.np >= 1 && p.ng * p.np <= k2MaxWarps && p.kc >= 1 &&
      p.kc <= a.C && p.groups >= 1 && p.groups * cpb >= a.Cout &&
      (p.groups - 1) * cpb < a.Cout &&
      p.smem == conv_k2_smem(a.C, p, (int)sizeof(T)) &&
      (!p.vec || (a.W % (p.px > 8 ? p.px : 8) == 0 && aligned16(a.x) &&
                  aligned16(a.out) && (!a.add || aligned16(a.add))));
  if (!ok) return (int)cudaErrorInvalidValue;
  switch (p.co * 100 + p.px) {
    case 808: return launch_k2<T, 8, 8>(a, p, s);
    case 1604: return launch_k2<T, 16, 4>(a, p, s);
    case 416: return launch_k2<T, 4, 16>(a, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int run(const ConvArgs& a, int k, int depthwise, const Plan1x1& p,
        const PlanK2& p2, cudaStream_t s) {
  switch (k) {
    case 1: return depthwise ? run_depthwise<T, 1>(a, s) : run_1x1<T>(a, p, s);
    case 2:
      if (depthwise) return run_depthwise<T, 2>(a, s);
      return a.dil == 1 ? run_k2<T>(a, p2, s) : run_dense<T, 2>(a, s);
    case 3: return depthwise ? run_depthwise<T, 3>(a, s) : run_dense<T, 3>(a, s);
    case 5: return depthwise ? run_depthwise<T, 5>(a, s) : run_dense<T, 5>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// w: dense OIHW [Cout, C, k, k] in x's dtype, or depthwise [C, 1, k, k]
// f32; bias f32 [Cout]; add (x's dtype) and vec (f32 [B, Cout]) may be null.
// plan: for k = 1 dense, the 7 ints (co, px, ng, kc, groups, smem, vec) of
// conv1x1_plan and the vector path; for k = 2 dense at dilation 1, the 8
// ints (co, px, ng, np, kc, groups, smem, vec) of stem_plan and the vector
// path; ignored (may be null) otherwise.
extern "C" int segtpu_conv_chw(const void* x, const void* w, const float* bias,
                               const void* add, const float* vec, void* out,
                               int B, int C, int Cout, int H, int W, int k,
                               int dilation, int depthwise, int act, int bf16,
                               const int* plan, void* stream) {
  ConvArgs a{x, w, bias, add, vec, out, B, C, Cout, H, W, dilation, act, 0, 1};
  Plan1x1 p{};
  PlanK2 p2{};
  if (k == 1 && !depthwise) {
    if (!plan) return (int)cudaErrorInvalidValue;
    p = Plan1x1{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6]};
  }
  if (k == 2 && !depthwise && dilation == 1) {
    if (!plan) return (int)cudaErrorInvalidValue;
    p2 = PlanK2{plan[0], plan[1], plan[2], plan[3],
                plan[4], plan[5], plan[6], plan[7]};
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(a, k, depthwise, p, p2, s)
              : run<float>(a, k, depthwise, p, p2, s);
}
