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
// At depthwise rate D (inv_res_kernel<T, 1, RP, 2>: the blocks that an
// output stride 16 encoder runs in place of stride 2, slim's output_stride
// rule) output (i, j) reads rows i-D, i, i+D and columns j-D, j, j+D, zero
// padding D: the window grows by D on each side and the taps stand D
// apart; the order of every sum is the same. A rate-1 launch is
// inv_res_kernel<T, S, RP, 1>, whose code is the rate-less kernel's.
// Every sum runs from zero in ascending order (expand over Cin, depthwise
// over the taps row-major, project over Cmid, chunk after chunk), each
// product and add rounded once: the plain twin's order
// (kernels/chw_ops.py), which inv_res_kernel matches bit for bit.
// The TPU kernels' row-split planes, quadrant split and 0/1 permutation
// dots only moved bytes into the TPU's lane layout and are not carried
// over: the kernels read the plain [B, C, H, W] tensor.
//
// Bound on the H100: each block moves its input once and its output once
// (the expanded tensor never leaves the SM), so the 17 blocks of the arch0
// encoder at 8 x 1024 x 2048 move ~1.3 GB (~0.4 ms at 3.35 TB/s) and do
// ~166 GFLOP of products (~0.17 ms on bf16 tensor cores; ~2.8 ms as f32
// multiply-adds on the CUDA cores, the bound of a kernel that keeps the
// twin's order) and ~14 GFLOP of f32 depthwise taps (~0.2 ms).
//
// inv_res_kernel (CUDA cores; bf16 and f32, every serving path): the
// products are f32 multiply-adds (one fmaf a product in bf16, where the
// product is exact; a rounded multiply and a rounded add in f32), so the
// bound is the rate at which the SM issues them; what holds the kernel
// back is latency between its phases more than that rate (PERF.md), so its
// design keeps many warps on each SM and loads in flight:
// - Persistent blocks of NT threads (up to 512: two or more blocks, or 16
//   warps, on an SM), each taking (image, TH x TW output tile) tiles in
//   turn. A tile's input window (its receptive field) lives in shared
//   memory in the compute dtype, xs [Cin][wh][wwp] (rows padded to 4; bf16
//   halves it), staged by 4-value vector loads shifted into place; with
//   prefetch (pf) the window sits 3 columns on (image column ix0 - 3 is
//   4-aligned) and the next tile's rows come by cp.async beside each
//   chunk's weights, into a second window, while this tile computes.
// - The mid channels are walked in chunks of MC. Chunk c:
//   1. expand: mid [MC][wh][wwp] f32 = relu6(we . xs + b_exp), zero
//      outside the image (a per-quad mask). A thread holds an 8 x 4
//      register tile (8 mid channels x 4 window pixels): per input channel
//      one quad of pixels (lanes on consecutive quads) and two float4 of
//      weights (the same for the warp: a broadcast), for 32 fmaf. Without
//      an expand (t = 1) the depthwise reads xs itself.
//   2. depthwise 3x3 at stride S: a thread 4 columns of two tile rows,
//      each window row read once, the twin's tap order, + bias, relu6, one
//      rounding into d [MC][TH*TW] f32.
//   3. project: a thread's RP x 4 register tile (RP output channels x 4
//      pixels: one float4 of d and RP/4 float4 of weights per mid channel)
//      accumulates in registers across every chunk; the block's NT =
//      ceil(Cout / RP) * TH * TW / 4 threads cover all of Cout.
// - Weights come packed by the caller as f32 [Cin][Cmid] and [Cmid][Cout]
//   (chw_ops.pack_inv_res: the compute dtype's values, transposed once),
//   so each chunk's weights are contiguous rows fetched by 16-byte
//   cp.async: the project weights while the chunk's expand runs, the next
//   chunk's expand and depthwise weights while its depthwise and project
//   run. Three barriers a chunk.
// - Epilogue: + bias, + residual (the input, from xs), one rounding,
//   stores of 4 consecutive pixels.
// The host plans TH, TW, MC, RP and pf (chw_ops.inv_res_plan) and passes
// the shared bytes its mirror of the layout counts (chw_ops.inv_res_smem);
// the entry checks them against its own count.
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

#include "pw_tile.cuh"
#include "tc_common.cuh"

namespace {

using namespace segtpu;

constexpr int kThreads = 256;
constexpr int kSmemMax = 227 * 1024;

__device__ __forceinline__ float relu6(float v) {
  return fminf(fmaxf(v, 0.f), 6.f);
}

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// 4 bytes global -> shared, asynchronously.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// ------------------------------------------------ CUDA cores (bf16, f32)

namespace cc {

constexpr int kRE = 8;       // mid channels of an expand thread tile
constexpr int kTaps = 12;    // a mid channel's row of small weights: 9
                             // taps, the depthwise bias, two zeros
constexpr int kSmall = 13;   // a chunk's small weights a mid channel:
                             // [MC][kTaps], then [MC] expand biases
constexpr int kStageBatch = 8;   // window loads a thread keeps in flight
constexpr int kShift = 3;    // window column 0's column in a prefetched
                             // window (image column ix0 - 3 is 4-aligned)

// Most threads of a block of the RP instantiation: 512 where a thread's
// RP x 4 project tile leaves it within 128 registers (RP <= 12), else 256
// (up to 255 registers).
__host__ __device__ constexpr int max_threads(int RP) {
  return RP <= 12 ? 512 : 256;
}

struct Args {
  const void* x;        // [B, Cin, H, W] compute dtype T
  const float* wexp;    // [Cin][Cmid] f32 (T's values), null: no expand
  const float* bexp;    // [Cmid]
  const float* wdw;     // [Cmid][9]
  const float* bdw;     // [Cmid]
  const float* wproj;   // [Cmid][Cout] f32 (T's values)
  const float* bproj;   // [Cout]
  void* out;            // [B, Cout, Ho, Wo] T
  int B, Cin, Cmid, Cout, H, W, Ho, Wo, TH, TW, MC, residual, pf;
};

// Sizes of a plan: the window's rows and columns (the tile's receptive
// field at stride S and depthwise rate D: S*TH + 2D + 1 - S rows), the
// column its column 0 sits at (xo: kShift for a prefetched window, else
// 0), the row pitch
// (xo + columns, rounded to 4), its plane, the tile's pixels, the expand
// weights' pitch (MC rounded to 8), the project's channel groups and
// their padded channel count, its pixel groups, the block's threads.
struct Geo {
  int wh, ww, xo, wwp, xp, p, mce, ncg, coutp, npg, nt;
};
__host__ __device__ inline Geo geo(int S, int Cout, int TH, int TW, int MC,
                                   int RP, int pf, int D = 1) {
  Geo g;
  g.wh = S * TH + 2 * D + 1 - S;
  g.ww = S * TW + 2 * D + 1 - S;
  g.xo = pf ? kShift : 0;
  g.wwp = round4(g.xo + g.ww);
  g.xp = g.wh * g.wwp;
  g.p = TH * TW;
  g.mce = (MC + kRE - 1) / kRE * kRE;
  g.ncg = (Cout + RP - 1) / RP;
  g.coutp = g.ncg * RP;
  g.npg = g.p / 4;
  g.nt = g.ncg * g.npg;
  return g;
}

// Bytes of a window [Cin][xp] in T, rounded to 16.
__host__ __device__ inline int xs_bytes(const Geo& g, int Cin, int esize) {
  return (Cin * g.xp * esize + 15) & ~15;
}

// Shared memory (chw_ops.inv_res_smem): the window xs [Cin][xp] in T (two
// of them with prefetch: the tile's and the next one's); then f32: with an
// expand, mid [MC][xp] and the chunk's expand weights [Cin][mce]; the
// depthwise output d [MC][p]; the chunk's project weights [MC][coutp]; two
// buffers of the chunk's small weights [13 MC]; then an int a window quad,
// its in-image mask [xp / 4].
__host__ __device__ inline int smem_bytes(const Geo& g, int Cin, int MC,
                                          bool expand, int esize, int pf) {
  return (1 + pf) * xs_bytes(g, Cin, esize) +
         4 * ((expand ? MC * g.xp + Cin * g.mce : 0) + MC * g.p +
              MC * g.coutp + 2 * kSmall * MC + g.xp / 4);
}

// Four consecutive values as f32: 16 bytes of f32, or 8 of bf16.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 u = *reinterpret_cast<const float2*>(p);
  a = u.x;
  b = u.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a,
                                      float& b) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  a = bf16_lo(u);
  b = bf16_hi(u);
}
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The 4S + 2D values of a depthwise window row that 4 outputs at stride S
// and rate D read (3S + 2D + 1 of them used), from row[XO] on; row is
// 16-byte (f32) or 8-byte (bf16) aligned, and XO is 0 or kShift (rate 1
// only: a dilated block is never prefetched).
template <int S, int D, int XO, typename P>
__device__ __forceinline__ void dw_row(const P* row,
                                       float (&v)[4 * S + 2 * D]) {
  static_assert(D == 1 || (D == 2 && S == 1 && XO == 0),
                "rate 2 is instantiated at stride 1 without prefetch");
  if constexpr (D == 2) {   // 8 values: two aligned quads
    const float4 a = load4(row), b = load4(row + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else if constexpr (XO == 0) {
    const float4 a = load4(row);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    if constexpr (S == 1) {
      load2(row + 4, v[4], v[5]);
    } else {
      const float4 b = load4(row + 4);
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      v[8] = load1(row + 8);
    }
  } else {   // columns 3.., from the aligned quads at 4 (and 8)
    v[0] = load1(row + 3);
    const float4 a = load4(row + 4);
    v[1] = a.x; v[2] = a.y; v[3] = a.z; v[4] = a.w;
    if constexpr (S == 1) {
      v[5] = load1(row + 8);
    } else {
      const float4 b = load4(row + 8);
      v[5] = b.x; v[6] = b.y; v[7] = b.z; v[8] = b.w;
    }
  }
}

// The depthwise sums of R x 4 outputs (R tile rows, 4 columns) from their
// window rows at src (pitch wwp), each window row read once: every output
// takes its taps (rows and columns D apart) in the twin's order
// (row-major, as y ascends), each product and add rounded.
template <int S, int D, int R, int XO, typename P>
__device__ __forceinline__ void dw_quads(const P* src, int wwp,
                                         const float (&w)[9],
                                         float (&s)[R][4]) {
#pragma unroll
  for (int y = 0; y < S * (R - 1) + 2 * D + 1; ++y) {
    float v[4 * S + 2 * D];
    dw_row<S, D, XO>(src + y * wwp, v);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int dy = y - S * r;
      if (dy < 0 || dy > 2 * D || dy % D) continue;
      const int ky = dy / D;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          s[r][u] = __fadd_rn(s[r][u],
                              __fmul_rn(w[3 * ky + kx], v[S * u + D * kx]));
    }
  }
}

// The depthwise phase of a chunk: d[m][pixel] = round(relu6(dw3x3_S(
// planes[m]) + bias)) for its MC mid channels, each item R tile rows x 4
// columns of one channel (items quad-fastest, a thread stepping by the
// block's threads without dividing); the small weights at sm
// ([MC][kTaps]: 9 taps, the bias).
template <typename T, int S, int D, int R, int XO, typename P>
__device__ __forceinline__ void dw_phase(const P* planes, const Geo& g,
                                         const float* sm, float* d, int MC,
                                         int TW, int lr, int tid) {
  const int nq = g.p / (4 * R);   // items a mid channel
  const int dm = g.nt / nq, dq = g.nt - dm * nq;
  for (int m = tid / nq, q = tid - (tid / nq) * nq; m < MC;) {
    const int oy = (q >> lr) * R, j = q & ((1 << lr) - 1);
    const float* wk = sm + m * kTaps;
    const float4 k0 = *reinterpret_cast<const float4*>(wk);
    const float4 k1 = *reinterpret_cast<const float4*>(wk + 4);
    const float2 k2 = *reinterpret_cast<const float2*>(wk + 8);
    const float w[9] = {k0.x, k0.y, k0.z, k0.w, k1.x,
                        k1.y, k1.z, k1.w, k2.x};
    float s[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) s[r][u] = 0.f;
    dw_quads<S, D, R, XO>(planes + m * g.xp + S * oy * g.wwp + 4 * S * j,
                       g.wwp, w, s);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float o[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) o[u] = round_to<T>(relu6(s[r][u] + k2.y));
      *reinterpret_cast<float4*>(d + m * g.p + (oy + r) * TW + 4 * j) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
    m += dm;
    q += dq;
    if (q >= nq) {
      q -= nq;
      ++m;
    }
  }
}

// The depthwise phase with the tile's row pairing (two rows an item where
// the tile's rows pair up) and the window's column shift (rate 1 only).
template <typename T, int S, int D, typename P>
__device__ __forceinline__ void dw_chunk(const P* planes, const Geo& g,
                                         const float* sm, float* d, int MC,
                                         int TH, int TW, int lr, int tid) {
  if constexpr (D > 1) {
    if (TH % 2 == 0)
      dw_phase<T, S, D, 2, 0>(planes, g, sm, d, MC, TW, lr, tid);
    else
      dw_phase<T, S, D, 1, 0>(planes, g, sm, d, MC, TW, lr, tid);
  } else if (TH % 2 == 0) {
    if (g.xo)
      dw_phase<T, S, D, 2, kShift>(planes, g, sm, d, MC, TW, lr, tid);
    else
      dw_phase<T, S, D, 2, 0>(planes, g, sm, d, MC, TW, lr, tid);
  } else {
    if (g.xo)
      dw_phase<T, S, D, 1, kShift>(planes, g, sm, d, MC, TW, lr, tid);
    else
      dw_phase<T, S, D, 1, 0>(planes, g, sm, d, MC, TW, lr, tid);
  }
}

// Window staging: 4 values from element `off` (0..3) of the 8 consecutive
// values of two 4-value chunks, as T's bits.
__device__ __forceinline__ uint2 shift4(uint2 a, uint2 b, int off) {
  const int sh = (off & 1) * 16;
  const uint32_t w0 = off & 2 ? a.y : a.x, w1 = off & 2 ? b.x : a.y,
                 w2 = off & 2 ? b.y : b.x;
  return make_uint2(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh));
}
__device__ __forceinline__ float4 shift4(float4 a, float4 b, int off) {
  switch (off) {
    case 0: return a;
    case 1: return make_float4(a.y, a.z, a.w, b.x);
    case 2: return make_float4(a.z, a.w, b.x, b.y);
    default: return make_float4(a.w, b.x, b.y, b.z);
  }
}
template <typename T> struct Quad;   // 4 values of T as one load or store
template <> struct Quad<float> { using type = float4; };
template <> struct Quad<__nv_bfloat16> { using type = uint2; };
__device__ __forceinline__ float4 pack4(const float (&e)[4]) {
  return make_float4(e[0], e[1], e[2], e[3]);
}
__device__ __forceinline__ uint2 pack4(const __nv_bfloat16 (&e)[4]) {
  return make_uint2(__bfloat16_as_ushort(e[0]) |
                        (uint32_t)__bfloat16_as_ushort(e[1]) << 16,
                    __bfloat16_as_ushort(e[2]) |
                        (uint32_t)__bfloat16_as_ushort(e[3]) << 16);
}

// 4 values of T (8 or 16 bytes) global -> shared, asynchronously; zeros
// when !ok.
__device__ __forceinline__ void cp_async_quad(float* dst, const float* src,
                                              bool ok) {
  cp_async16(dst, src, ok ? 16 : 0);
}
__device__ __forceinline__ void cp_async_quad(__nv_bfloat16* dst,
                                              const __nv_bfloat16* src,
                                              bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 8 : 0));
}

// A tile of the launch: its image and its output origin.
struct Tile {
  int b, oy0, ox0;
};
__device__ __forceinline__ Tile tile_of(int t, int TH, int TW, int ntx,
                                        int nty) {
  const int tx = t % ntx, r = t / ntx;
  return Tile{r / nty, (r % nty) * TH, tx * TW};
}

// Persistent blocks: block i takes tiles i, i + gridDim.x, ... of the
// (image, TH x TW output tile) grid, x fastest. Depthwise rate D: 1, or 2
// at stride 1 (the dilated blocks of an output stride 16 encoder).
template <typename T, int S, int RP, int D>
__global__ void __launch_bounds__(max_threads(RP))
    inv_res_kernel(const __grid_constant__ Args a) {
  using Q = typename Quad<T>::type;
  extern __shared__ __align__(16) unsigned char cc_smem[];
  const int Cin = a.Cin, MC = a.MC, TH = a.TH, TW = a.TW;
  const Geo g = geo(S, a.Cout, TH, TW, MC, RP, a.pf, D);
  const bool expand = a.wexp != nullptr;
  const int xsb = xs_bytes(g, Cin, sizeof(T));
  T* xs0 = reinterpret_cast<T*>(cc_smem);
  float* mid = reinterpret_cast<float*>(cc_smem + (1 + a.pf) * xsb);
  float* we = mid + (expand ? MC * g.xp : 0);
  float* d = we + (expand ? Cin * g.mce : 0);
  float* wp = d + MC * g.p;
  float* small = wp + MC * g.coutp;
  int* qmask = reinterpret_cast<int*>(small + 2 * kSmall * MC);
  const int tid = threadIdx.x, nt = g.nt;
  const int nchunk = a.Cmid / MC;
  const int ntx = (a.Wo + TW - 1) / TW, nty = (a.Ho + TH - 1) / TH;
  const int ntiles = a.B * nty * ntx;
  const T* xb = static_cast<const T*>(a.x);

  // chunk c's expand weights (zero past MC) into we, and small weights
  // into buffer k & 1
  auto fetch_we = [&](int c, int k) {
    const int m0 = c * MC;
    if (expand) {
      const int q = g.mce / 4;
      for (int i = tid; i < Cin * q; i += nt) {
        const int ci = i / q, j = 4 * (i - ci * q);
        const bool ok = j < MC;
        cp_async16(we + ci * g.mce + j,
                   ok ? a.wexp + (size_t)ci * a.Cmid + m0 + j : a.wexp,
                   ok ? 16 : 0);
      }
    }
    float* sm = small + (k & 1) * kSmall * MC;
    for (int i = tid; i < kTaps * MC; i += nt) {
      const int m = i / kTaps, e = i - m * kTaps;
      if (e < 10)
        cp_async4(sm + i, e < 9 ? a.wdw + (size_t)(m0 + m) * 9 + e
                                : a.bdw + m0 + m);
      else
        sm[i] = 0.f;
    }
    if (expand)
      for (int i = tid; i < MC / 4; i += nt)
        cp_async16(sm + kTaps * MC + 4 * i, a.bexp + m0 + 4 * i, 16);
  };
  // chunk c's project weights, channels past Cout zero
  auto fetch_wp = [&](int c) {
    const int q = g.coutp / 4;
    for (int i = tid; i < MC * q; i += nt) {
      const int m = i / q, j = 4 * (i - m * q);
      const bool ok = j < a.Cout;
      cp_async16(wp + m * g.coutp + j,
                 ok ? a.wproj + (size_t)(c * MC + m) * a.Cout + j : a.wproj,
                 ok ? 16 : 0);
    }
  };
  // Prefetch (pf): rows [r0, r1) of tile tl's window into xw by cp.async,
  // 4-value chunks from the 4-aligned image column ix0 - kShift (whole
  // chunks in or out of the image: W % 4 == 0), zeros outside the image.
  const int nk = g.wwp / 4;
  auto prefetch_rows = [&](const Tile& tl, T* xw, int r0, int r1) {
    const int iy0 = S * tl.oy0 - D, ax = S * tl.ox0 - D - kShift;
    const T* x = xb + (size_t)tl.b * Cin * a.H * a.W;
    for (int i = r0 * nk + tid; i < r1 * nk; i += nt) {
      const int r = i / nk, k = i - r * nk;
      const int c = r / g.wh, wy = r - c * g.wh;
      const int gy = iy0 + wy, gx = ax + 4 * k;
      const bool ok = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      cp_async_quad(xw + c * g.xp + wy * g.wwp + 4 * k,
                    ok ? x + ((size_t)c * a.H + gy) * a.W + gx : xb, ok);
    }
  };
  const int rows = Cin * g.wh;   // window rows of a tile

  int it = 0, kc = 0;   // tiles done, chunks done (the small buffers' turn)
  if (a.pf && blockIdx.x < ntiles) {
    prefetch_rows(tile_of(blockIdx.x, TH, TW, ntx, nty), xs0, 0, rows);
  }
  if (blockIdx.x < ntiles) fetch_we(0, 0);
  cp_async_commit();

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++it) {
    const Tile tl = tile_of(t, TH, TW, ntx, nty);
    const int tn = t + gridDim.x;   // this block's next tile
    const Tile tln = tile_of(tn, TH, TW, ntx, nty);
    T* xs = xs0 + (a.pf ? (it & 1) * (xsb / (int)sizeof(T)) : 0);
    T* xn = xs0 + (a.pf ? ((it + 1) & 1) * (xsb / (int)sizeof(T)) : 0);
    const int oy0 = tl.oy0, ox0 = tl.ox0;
    const int iy0 = S * oy0 - D, ix0 = S * ox0 - D;   // window origin
    const T* x = xb + (size_t)tl.b * Cin * a.H * a.W;

    // without prefetch: the window in T, zero outside the image: item (c,
    // wy, k) is the quad xs[c][wy][4k..4k+3], image columns ix0 + 4k..,
    // taken from the two 4-value chunks at the 4-aligned columns ax4 + 4k
    // and ax4 + 4k + 4 (each wholly in or out of the image when W allows
    // vector loads); a thread keeps kStageBatch items in flight and steps
    // its indices without dividing
    if (!a.pf) {
      const int ax4 = ix0 & ~3, off = ix0 - ax4;
      const int n = rows * nk;
      const bool vec = a.W % 4 == 0 &&
                       (reinterpret_cast<uintptr_t>(a.x) &
                        (4 * sizeof(T) - 1)) == 0;
      const int dr = nt / nk, dk = nt - dr * nk;   // a step of nt items
      const int dc = dr / g.wh, dwy = dr - dc * g.wh;
      int k = tid % nk, wy = (tid / nk) % g.wh, c = tid / nk / g.wh;
      for (int i0 = tid; i0 < n; i0 += kStageBatch * nt) {
        Q v[kStageBatch];
        int at[kStageBatch];
#pragma unroll
        for (int u = 0; u < kStageBatch; ++u) {
          const int gy = iy0 + wy, gx = ax4 + 4 * k;
          const bool live = i0 + u * nt < n;
          const bool row = live && gy >= 0 && gy < a.H;
          const T* src = x + ((long long)c * a.H + gy) * a.W + gx;
          if (vec) {
            Q lo{}, hi{};
            if (row && gx >= 0 && gx < a.W)
              lo = *reinterpret_cast<const Q*>(src);
            if (row && off && gx + 4 >= 0 && gx + 4 < a.W)
              hi = *reinterpret_cast<const Q*>(src + 4);
            v[u] = shift4(lo, hi, off);
          } else {
            T e[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = gx + off + j;
              e[j] = row && col >= 0 && col < a.W ? src[off + j]
                                                  : from_f32<T>(0.f);
            }
            v[u] = pack4(e);
          }
          at[u] = live ? c * g.xp + wy * g.wwp + 4 * k : -1;
          k += dk;
          wy += dwy;
          c += dc;
          if (k >= nk) {
            k -= nk;
            ++wy;
          }
          if (wy >= g.wh) {
            wy -= g.wh;
            ++c;
          }
        }
#pragma unroll
        for (int u = 0; u < kStageBatch; ++u)
          if (at[u] >= 0) *reinterpret_cast<Q*>(xs + at[u]) = v[u];
      }
    }

    // each window quad's in-image mask (bit j: column 4 q + j, image
    // column ix0 - xo + 4 q + j)
    const int nq = g.xp / 4;
    for (int q = tid; q < nq; q += nt) {
      const int wy = (4 * q) / g.wwp, wx = 4 * q - wy * g.wwp;
      const int gy = iy0 + wy;
      int mk = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gx = ix0 - g.xo + wx + j;
        mk |= (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W) << j;
      }
      qmask[q] = mk;
    }

    float acc[RP][4];
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
    const int cg = tid / g.npg, pg = tid - cg * g.npg;   // project item
    // the expand's items (mid group, window quad): a thread's first and
    // its step, quad fastest; a tile row holds TW / 4 = 2^lr quads
    const int nmg = g.mce / kRE, lr = __ffs(TW / 4) - 1;
    const int e_mg = tid / nq, e_q = tid - e_mg * nq;
    const int e_dmg = nt / nq, e_dq = nt - e_dmg * nq;

    for (int c = 0; c < nchunk; ++c, ++kc) {
      cp_async_wait_all();
      __syncthreads();   // chunk c's expand and small weights (and the
                         // window) landed; chunk c-1's project is done
      fetch_wp(c);
      cp_async_commit();
      const float* sm = small + (kc & 1) * kSmall * MC;

      // 1. mid over the window, f32, zero outside the image
      if (expand) {
        for (int mg = e_mg, q = e_q; mg < nmg;) {
          float s[kRE][4];
#pragma unroll
          for (int i = 0; i < kRE; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
          const T* xq = xs + 4 * q;
          const float* wq = we + kRE * mg;
#pragma unroll 4
          for (int ci = 0; ci < Cin; ++ci) {
            const float4 xv = load4(xq + ci * g.xp);
            const float xv4[4] = {xv.x, xv.y, xv.z, xv.w};
            const float4 w0 =
                *reinterpret_cast<const float4*>(wq + ci * g.mce);
            const float4 w1 =
                *reinterpret_cast<const float4*>(wq + ci * g.mce + 4);
            const float wv[kRE] = {w0.x, w0.y, w0.z, w0.w,
                                   w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int i = 0; i < kRE; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                s[i][j] = mac<T>(s[i][j], wv[i], xv4[j]);
          }
          const int mk = qmask[q];
          const float* be = sm + kTaps * MC + kRE * mg;
#pragma unroll
          for (int i = 0; i < kRE; ++i) {
            const int m = kRE * mg + i;
            if (m < MC) {
              float o[4];
#pragma unroll
              for (int j = 0; j < 4; ++j) o[j] = relu6(s[i][j] + be[i]);
              if (mk != 15) {   // a quad that reaches past the image
#pragma unroll
                for (int j = 0; j < 4; ++j) o[j] = mk >> j & 1 ? o[j] : 0.f;
              }
              *reinterpret_cast<float4*>(mid + m * g.xp + 4 * q) =
                  make_float4(o[0], o[1], o[2], o[3]);
            }
          }
          mg += e_dmg;
          q += e_dq;
          if (q >= nq) {
            q -= nq;
            ++mg;
          }
        }
      }
      __syncthreads();   // mid is complete; the expand weights are free
      // the next chunk's (or the next tile's first chunk's) expand and
      // small weights, and with prefetch this chunk's share of the next
      // tile's window
      if (c + 1 < nchunk)
        fetch_we(c + 1, kc + 1);
      else if (tn < ntiles)
        fetch_we(0, kc + 1);
      if (a.pf && tn < ntiles)
        prefetch_rows(tln, xn, rows * c / nchunk, rows * (c + 1) / nchunk);
      cp_async_commit();

      // 2. depthwise 3x3 at stride S, f32; bias, relu6, one rounding. The
      //    input is mid, or without an expand the window itself.
      if (expand)
        dw_chunk<T, S, D>(mid, g, sm, d, MC, TH, TW, lr, tid);
      else
        dw_chunk<T, S, D>(xs + (size_t)c * MC * g.xp, g, sm, d, MC, TH, TW,
                          lr, tid);
      cp_async_wait<1>();
      __syncthreads();   // d is complete; chunk c's project weights landed

      // 3. the chunk's project products into the register accumulators
      {
        const float* dq = d + 4 * pg;
        const float* wq = wp + RP * cg;
#pragma unroll 2
        for (int m = 0; m < MC; ++m) {
          const float4 v = *reinterpret_cast<const float4*>(dq + m * g.p);
          const float dv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int q = 0; q < RP / 4; ++q) {
            const float4 w =
                *reinterpret_cast<const float4*>(wq + m * g.coutp + 4 * q);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              acc[4 * q][k] = mac<T>(acc[4 * q][k], w.x, dv[k]);
              acc[4 * q + 1][k] = mac<T>(acc[4 * q + 1][k], w.y, dv[k]);
              acc[4 * q + 2][k] = mac<T>(acc[4 * q + 2][k], w.z, dv[k]);
              acc[4 * q + 3][k] = mac<T>(acc[4 * q + 3][k], w.w, dv[k]);
            }
          }
        }
      }
    }

    // + bias, + residual (the input, from the window), one rounding
    T* out = static_cast<T*>(a.out) + (size_t)tl.b * a.Cout * a.Ho * a.Wo;
    const bool vec_out =
        a.Wo % 4 == 0 && (reinterpret_cast<uintptr_t>(a.out) & 15) == 0;
    {
      const int p = 4 * pg, oy = p >> (lr + 2), ox = p - oy * TW;
      const int gy = oy0 + oy, gx = ox0 + ox;
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        const int co = RP * cg + i;
        if (gy < a.Ho && gx < a.Wo && co < a.Cout) {
          const float bias = __ldg(a.bproj + co);
          float y[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) y[e] = acc[i][e] + bias;
          if (a.residual) {
            const T* xr =
                xs + co * g.xp + (oy + D) * g.wwp + g.xo + ox + D;
#pragma unroll
            for (int e = 0; e < 4; ++e) y[e] += to_f32(xr[e]);
          }
          T* o = out + ((size_t)co * a.Ho + gy) * a.Wo + gx;
          if (vec_out) {
            store_px<4>(o, y);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (gx + e < a.Wo) o[e] = from_f32<T>(y[e]);
          }
        }
      }
    }
    __syncthreads();   // the window and the mask are free for the next tile
  }
}

template <typename T, int S, int RP, int D>
int launch(const Args& a, const Geo& g, int smem, cudaStream_t s) {
  if (g.nt > max_threads(RP)) return (int)cudaErrorInvalidValue;
  const auto kern = inv_res_kernel<T, S, RP, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long tiles = (long long)a.B * ((a.Ho + a.TH - 1) / a.TH) *
                          ((a.Wo + a.TW - 1) / a.TW);
  const int grid = resident_blocks(kern, g.nt, smem, tiles, 1);
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  kern<<<grid, g.nt, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The project tiles RP x 4 instantiated (chw_ops.INV_RES_TILES): RP 4, 8,
// 12 and 20 in bf16, 4 and 8 in f32.
template <typename T, int S, int D = 1>
int launch_tile(const Args& a, const Geo& g, int rp, int smem,
                cudaStream_t s) {
  if (rp == 4) return launch<T, S, 4, D>(a, g, smem, s);
  if (rp == 8) return launch<T, S, 8, D>(a, g, smem, s);
  if constexpr (sizeof(T) == 2) {
    if (rp == 12) return launch<T, S, 12, D>(a, g, smem, s);
    if (rp == 20) return launch<T, S, 20, D>(a, g, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace cc

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

// The CUDA-core kernel, bf16 (bf16 != 0) or f32. wexp and wproj packed by
// chw_ops.pack_inv_res (f32 [Cin][Cmid] and [Cmid][Cout], the compute
// dtype's values; 16-byte aligned, as bexp); wexp/bexp null: no expand.
// TH x TW output tile (TW a power of 2, >= 4), MC mid channels a chunk
// (MC % 4 == 0, Cmid % MC == 0), RP x 4 a thread's project tile (an RP
// instantiated), ceil(Cout / RP) TH TW / 4 threads (at most 512 for RP <=
// 12, else 256); pf 1: each block prefetches its next tile's window while
// it computes the current one (W % 4 == 0, x aligned to 4 values); smem
// must be the layout's byte count (chw_ops.inv_res_plan, inv_res_smem);
// rate: the depthwise rate, 1, or 2 at stride 1 without prefetch (the
// window grows by the rate on each side, the taps stand rate apart).
// Returns the cudaError_t of the launch (0 = ok).
extern "C" int segtpu_inv_res(const void* x, const float* wexp,
                              const float* bexp, const float* wdw,
                              const float* bdw, const float* wproj,
                              const float* bproj, void* out, int B, int Cin,
                              int Cmid, int Cout, int H, int W, int stride,
                              int TH, int TW, int MC, int RP, int pf,
                              int residual, int bf16, int smem, int rate,
                              void* stream) {
  const int esize = bf16 ? 2 : 4;
  if ((rate != 1 && (rate != 2 || stride != 1 || pf)) ||
      (stride != 1 && stride != 2) || TH < 1 || TW < 4 || TW & (TW - 1) ||
      MC < 4 || MC % 4 || Cmid % MC || Cout % 4 || RP < 4 || RP % 4 ||
      (pf != 0 && pf != 1) ||
      (pf && (W % 4 || reinterpret_cast<uintptr_t>(x) % (4 * esize))) ||
      (!wexp && Cmid != Cin) || (residual && (stride != 1 || Cin != Cout)) ||
      (reinterpret_cast<uintptr_t>(wexp) | reinterpret_cast<uintptr_t>(wproj) |
       reinterpret_cast<uintptr_t>(bexp)) &
          15)
    return (int)cudaErrorInvalidValue;
  const cc::Geo g = cc::geo(stride, Cout, TH, TW, MC, RP, pf, rate);
  if (cc::smem_bytes(g, Cin, MC, wexp != nullptr, esize, pf) != smem ||
      smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const cc::Args a{x,   wexp, bexp,       wdw,        bdw, wproj, bproj,
                   out, B,    Cin,        Cmid,       Cout, H,    W,
                   H / stride, W / stride, TH,        TW,   MC,   residual,
                   pf};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rate == 2)
    return bf16 ? cc::launch_tile<__nv_bfloat16, 1, 2>(a, g, RP, smem, s)
                : cc::launch_tile<float, 1, 2>(a, g, RP, smem, s);
  if (bf16)
    return stride == 1
               ? cc::launch_tile<__nv_bfloat16, 1>(a, g, RP, smem, s)
               : cc::launch_tile<__nv_bfloat16, 2>(a, g, RP, smem, s);
  return stride == 1 ? cc::launch_tile<float, 1>(a, g, RP, smem, s)
                     : cc::launch_tile<float, 2>(a, g, RP, smem, s);
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
