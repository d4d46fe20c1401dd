// The f32 floor experiment's two kernels, CUDA C++ for sm_90a.
//
// Replaces: scripts/exp_vpu_floor.py — _fma_kernel (bench_peak), and
// _tap_kernel (bench_taploop) with its variant _tap_kernel_roll
// (bench_taploop_roll), which computes the same function with the dx shift
// done by a rotate; on the H100 both are this one tap-sum kernel.
//
// fma_peak: x f32 [n] -> out f32 [n]. Per element, n_acc independent chains
//   acc_i = x * (1 + 0.125 i), then `reps` times acc_i = fma(acc_i,
//   1 + 0.0625 i, x), then out = acc_0 + acc_1 + ... in order. The fused
//   multiply-add (one rounding) is the instruction whose rate the experiment
//   measures, so the chains use fmaf; the plain PyTorch version computes
//   acc * c + x with two roundings, and the two agree to a relative 1e-5,
//   not bit for bit (every chain is x times a positive constant, so there
//   is no cancellation to magnify the rounding).
//   Bound on the H100: operations. At 64 x 48 x 8192 and 256 FMAs an
//   element it does 12.9 GFLOP (0.19 ms at 67 TFLOP/s) and moves 201 MB
//   (0.06 ms at 3.35 TB/s).
//   Design: one thread per element; its n_acc chains (a template argument,
//   so they live in registers) are the independent instructions a warp
//   scheduler interleaves to hide the FMA latency.
//
// dw_tap_sum: x bf16 [G, C, halo + P + halo], w f32 [k*k, C] -> out f32
//   [G, C, P], the depthwise tap loop of the production kernels
//   (segtpu/kernels/chw_ops.py::_dw_tap_sum) on a halo'd flat tile of rows
//   of width `w`:
//     out[p] = sum over dx ascending of  mask(p, dx) * part(dx),
//     part(dx) = sum over the taps with that dx, in tap order (ky
//                ascending), of w[j] * f32(x[halo + dy * w + dx + p]),
//     mask(p, dx) = 1 if 0 <= p % w + dx < w else 0, applied as a multiply
//                   when dx != 0.
//   Each sum starts from its first term; every product and sum is rounded
//   separately (__fmul_rn, __fadd_rn: nothing may contract into an fma), in
//   the order of the plain version, so the two agree bit for bit. Where
//   p % w + dx leaves the row, the flat read takes the neighbouring row's
//   pixel and the mask multiplies the partial by 0: the zero keeps the
//   partial's sign (-0.0 shows in the output), so the read is kept. Taps
//   with |dx| >= w are dropped, as _taps drops them.
//   Bound on the H100: memory at k = 3 (at C = 48, 16 tiles of 64 x 512 it
//   reads 71 MB of bf16 and writes 101 MB of f32, 0.05 ms); the f32
//   instructions at k >= 5. Nothing fuses, so each product, sum and mask
//   multiply is one instruction, issued at half the measured fmaf rate
//   (~29.8 G a ms): at k = 7 ~2.6 G of them, 0.087 ms, over its 0.047 ms of
//   bytes; at k = 5 the two are about equal.
//   Design (dw_tap_kernel): persistent blocks walk items, a strip of s
//   flat outputs of one (g, c) plane each, blockIdx.x, + gridDim.x, ...
//   For each item the block stages the flat span its taps reach, lo
//   elements before the strip and hi after it (tap_margin: the reach
//   rounded up to 8, plus 8 for the vector reads), by 16-byte cp.async into
//   one of two buffers, with the channel's k*k weights beside it, while the
//   other buffer's item computes. The span sits so that a strip's first
//   output lies at a multiple of 8 elements, so the centre row of every
//   thread's 8 outputs is one 16-byte vector. A thread takes 8 consecutive
//   outputs and writes them as two float4 stores; it multiplies by the
//   mask only where a tap may leave the row (a partial kept is the twin's
//   times 1, the same bits). k = 3, 5, 7 at the
//   vocabulary's dilations (1; 3 and 6 for the dilated sep convs) are
//   compiled (taps_fixed): the weights in registers, and for each row dy the
//   thread reads the row's window (its 8 outputs and the widest dx either
//   side) as aligned 16-byte vectors once and takes every dx of the row from
//   registers, so the loads per output are ~(k rows x 3 vectors) / 8. Any
//   other k <= 15, dilation or width (taps_any) reads two vectors a tap and
//   shifts them by the tap's offset mod 8, the same for every thread of the
//   block (a uniform switch), with the weights in shared memory. A plan
//   from Python (kernels/vpu_floor.py tap_plan) sets the strip, the block's
//   threads and the compiled form; the entry checks its margins and shared
//   bytes against its own layout. The v1 form, one thread an output with
//   k*k scalar 2-byte loads, stays as dw_tap_sum_v1_kernel, launched only
//   by the probe entry segtpu_dw_tap_sum_v1.

#include "pw_tile.cuh"

using namespace segtpu;

template <int NACC>
__global__ void fma_peak_kernel(const float* __restrict__ x,
                                float* __restrict__ out, long long n,
                                int reps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xv = x[i];
  float acc[NACC];
#pragma unroll
  for (int a = 0; a < NACC; ++a) acc[a] = __fmul_rn(xv, 1.0f + 0.125f * a);
  // unrolled by 8, so the loop's own counter and branch take a small share
  // of the issue slots the FMAs compete for
#pragma unroll 8
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int a = 0; a < NACC; ++a)
      acc[a] = __fmaf_rn(acc[a], 1.0f + 0.0625f * a, xv);
  }
  float s = acc[0];
#pragma unroll
  for (int a = 1; a < NACC; ++a) s = __fadd_rn(s, acc[a]);
  out[i] = s;
}

namespace {

constexpr int kMaxTaps = 15 * 15;
constexpr int kTapV = 8;               // outputs a thread computes at once
constexpr int kTapMaxThreads = 256;

// The plan of a tap launch (kernels/vpu_floor.py tap_plan, tap_args):
// strips of s flat outputs (a multiple of 8), nt threads a block, lo and hi
// elements staged before and after a strip, the compiled form (kt, dt; 0 0
// for taps_any), smem bytes; vin: 16-byte cp.async staging; vout: float4
// stores.
struct TapPlan {
  int s, nt, lo, hi, kt, dt, smem, vin, vout;
};

// The elements staged on each side of a strip: the kept taps' reach (the
// deepest dy rows and the widest kept |dx|) rounded up to 8, plus 8 for
// the slack of the 16-byte vector reads.
__host__ __device__ inline int tap_margin(int k, int dil, int w) {
  const int half = k / 2;
  int rx = 0;
  for (int kx = 0; kx < k; ++kx) {
    const int dx = dil * (kx > half ? kx - half : half - kx);
    if (dx < w && dx > rx) rx = dx;
  }
  return r8(dil * half * w + rx) + 8;
}

// Bytes of one of the two buffers: the span in bf16, then the k*k f32
// weights, each rounded up to 16 bytes.
__host__ __device__ inline int tap_buffer_bytes(const TapPlan& p, int k) {
  return r16(2 * (p.lo + p.s + p.hi)) + r16(4 * k * k);
}
inline int tap_smem(const TapPlan& p, int k) {
  return 2 * tap_buffer_bytes(p, k);
}

// The 8 bf16 values from element M of the 16 in a, b, as f32.
template <int M>
__device__ __forceinline__ void shifted8(const uint4& a, const uint4& b,
                                         float (&v)[kTapV]) {
  const uint32_t u[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < kTapV; ++i)
    v[i] = (M + i) & 1 ? bf16_hi(u[(M + i) >> 1]) : bf16_lo(u[(M + i) >> 1]);
}

// The compiled form: KT x KT taps at dilation DT, every dx kept (DT *
// (KT / 2) < w), w % 8 == 0. buf: the staged span, e: the element of the
// thread's first output, wr: the weights [ky * KT + kx], col0: the first
// output's column.
template <int KT, int DT>
__device__ __forceinline__ void taps_fixed(const __nv_bfloat16* buf, int e,
                                           int w, const float (&wr)[KT * KT],
                                           int col0, float (&acc)[kTapV]) {
  constexpr int H = KT / 2, RX = DT * H;      // RX: the widest |dx|
  constexpr int A8 = (RX + 7) / 8 * 8;        // the window from e - A8
  constexpr int NW = kTapV + 2 * RX;          // window values used
  constexpr int NV = (A8 - RX + NW + 7) / 8;  // 16-byte vectors read
  constexpr int O = A8 - RX;                  // win[0]'s place in them
  float part[KT][kTapV];
#pragma unroll
  for (int ky = 0; ky < KT; ++ky) {
    const uint4* v =
        reinterpret_cast<const uint4*>(buf + e + DT * (ky - H) * w - A8);
    uint32_t u[4 * NV];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const uint4 t = v[q];
      u[4 * q] = t.x; u[4 * q + 1] = t.y; u[4 * q + 2] = t.z;
      u[4 * q + 3] = t.w;
    }
    float win[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint32_t pair = u[(O + j) >> 1];
      win[j] = (O + j) & 1 ? bf16_hi(pair) : bf16_lo(pair);
    }
#pragma unroll
    for (int kx = 0; kx < KT; ++kx)
#pragma unroll
      for (int i = 0; i < kTapV; ++i) {
        const float term = __fmul_rn(wr[ky * KT + kx], win[i + DT * kx]);
        part[kx][i] = ky == 0 ? term : __fadd_rn(part[kx][i], term);
      }
  }
  // the mask: output i's tap dx leaves the row where col0 + i + dx < 0 or
  // >= w. col0 and w are multiples of 8, so with L = col0 / 8 and R =
  // (w - col0) / 8 (>= 1) the tap stays in the row where L >= ceil((-dx -
  // i) / 8), resp. R >= ceil((dx + i + 1) / 8): compile-time thresholds,
  // none where the need is at most 0 resp. 1 (always met). A kept partial
  // is the twin's times 1 (the same bits: the card's products and sums give
  // only the canonical NaN); a masked one is multiplied by 0, keeping its
  // sign.
  const int L = col0 >> 3, R = (w - col0) >> 3;
#pragma unroll
  for (int kx = 0; kx < KT; ++kx) {
    const int dx = DT * (kx - H);
#pragma unroll
    for (int i = 0; i < kTapV; ++i) {
      float v = part[kx][i];
      const int need_l = (-dx - i + 7) >> 3, need_r = (dx + i + 8) >> 3;
      if (dx < 0 && need_l > 0 && L < need_l) v = __fmul_rn(v, 0.f);
      if (dx > 0 && need_r > 1 && R < need_r) v = __fmul_rn(v, 0.f);
      acc[i] = kx == 0 ? v : __fadd_rn(acc[i], v);
    }
  }
}

// Any k <= 15, dilation and width: the kept dx ascending, for each the
// taps' rows ky ascending, each tap's 8 values read as two aligned vectors
// and shifted by the tap's offset mod 8 (the same for every thread: the
// span puts every first output at a multiple of 8). ws: the weights in
// shared memory; p0: the first output's flat index.
__device__ __forceinline__ void taps_any(const __nv_bfloat16* buf, int e,
                                         int w, const float* ws, int k,
                                         int dil, int p0,
                                         float (&acc)[kTapV]) {
  const int half = k / 2;
  int col[kTapV];
#pragma unroll
  for (int i = 0; i < kTapV; ++i) col[i] = (p0 + i) % w;
  bool have = false;
  for (int kx = 0; kx < k; ++kx) {
    const int dx = dil * (kx - half);
    if (dx >= w || -dx >= w) continue;
    float part[kTapV];
    for (int ky = 0; ky < k; ++ky) {
      const int t = e + dil * (ky - half) * w + dx;
      const uint4* v = reinterpret_cast<const uint4*>(buf + (t & ~7));
      const uint4 a = v[0], b = v[1];
      float x[kTapV];
      switch (t & 7) {
        case 0: shifted8<0>(a, b, x); break;
        case 1: shifted8<1>(a, b, x); break;
        case 2: shifted8<2>(a, b, x); break;
        case 3: shifted8<3>(a, b, x); break;
        case 4: shifted8<4>(a, b, x); break;
        case 5: shifted8<5>(a, b, x); break;
        case 6: shifted8<6>(a, b, x); break;
        default: shifted8<7>(a, b, x); break;
      }
      const float wgt = ws[ky * k + kx];
#pragma unroll
      for (int i = 0; i < kTapV; ++i) {
        const float term = __fmul_rn(wgt, x[i]);
        part[i] = ky == 0 ? term : __fadd_rn(part[i], term);
      }
    }
#pragma unroll
    for (int i = 0; i < kTapV; ++i) {
      if (col[i] + dx < 0 || col[i] + dx >= w)
        part[i] = __fmul_rn(part[i], 0.f);
      acc[i] = have ? __fadd_rn(acc[i], part[i]) : part[i];
    }
    have = true;
  }
}

// Starts staging item `item` into buffer `slot`: the span [halo + s0 - lo,
// halo + s0 + s + hi) of its plane (zero outside the plane) and its
// channel's weights; commits a group whether or not there is an item.
__device__ __forceinline__ void stage_tap(
    const TapPlan& p, long long item, long long items, int slot,
    unsigned char* smem, const __nv_bfloat16* x, const float* wt, int C,
    int P, int halo, int k, int nstrip) {
  if (item < items) {
    const long long plane = item / nstrip;
    const int s0 = (int)(item - plane * nstrip) * p.s;
    const int c = (int)(plane % C), T = P + 2 * halo;
    unsigned char* base = smem + slot * tap_buffer_bytes(p, k);
    __nv_bfloat16* buf = reinterpret_cast<__nv_bfloat16*>(base);
    float* ws = reinterpret_cast<float*>(base + r16(2 * (p.lo + p.s + p.hi)));
    const __nv_bfloat16* xp = x + plane * T;
    const int q0 = halo + s0 - p.lo, span = p.lo + p.s + p.hi;
    if (p.vin) {
      for (int i = threadIdx.x; i < span / 8; i += blockDim.x) {
        const int q = q0 + 8 * i;
        const bool in = q >= 0 && q + 8 <= T;
        cp_async16(buf + 8 * i, in ? xp + q : x, in ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < span; i += blockDim.x) {
        const int q = q0 + i;
        buf[i] = q >= 0 && q < T ? xp[q] : __float2bfloat16_rn(0.f);
      }
    }
    for (int j = threadIdx.x; j < k * k; j += blockDim.x)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_addr(ws + j)),
                   "l"(wt + (size_t)j * C + c));
  }
  cp_async_commit();
}

// KT, DT > 0: the compiled form; 0, 0: taps_any.
template <int KT, int DT>
__global__ void __launch_bounds__(kTapMaxThreads)
    dw_tap_kernel(const __nv_bfloat16* __restrict__ x,
                  const float* __restrict__ wt, float* __restrict__ out,
                  int G, int C, int P, int w, int halo, int k, int dil,
                  TapPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nstrip = (P + p.s - 1) / p.s;
  const long long items = (long long)G * C * nstrip;
  const int steps =
      items > blockIdx.x ? (int)((items - 1 - blockIdx.x) / gridDim.x) + 1 : 0;
  const int wofs = r16(2 * (p.lo + p.s + p.hi));
  stage_tap(p, blockIdx.x, items, 0, smem, x, wt, C, P, halo, k, nstrip);
  for (int s = 0; s < steps; ++s) {
    const long long item = blockIdx.x + (long long)s * gridDim.x;
    cp_async_wait<0>();       // item s has landed
    __syncthreads();          // ... for every thread; item s - 1 is done
    stage_tap(p, item + gridDim.x, items, (s + 1) & 1, smem, x, wt, C, P,
              halo, k, nstrip);
    const unsigned char* base = smem + (s & 1) * tap_buffer_bytes(p, k);
    const __nv_bfloat16* buf = reinterpret_cast<const __nv_bfloat16*>(base);
    const float* ws = reinterpret_cast<const float*>(base + wofs);
    const long long plane = item / nstrip;
    const int s0 = (int)(item - plane * nstrip) * p.s;
    const int ngrp = (min(p.s, P - s0) + kTapV - 1) / kTapV;
    float* op = out + plane * P;
    float wr[KT > 0 ? KT * KT : 1];
    if constexpr (KT > 0) {
#pragma unroll
      for (int j = 0; j < KT * KT; ++j) wr[j] = ws[j];
    }
    for (int grp = threadIdx.x; grp < ngrp; grp += blockDim.x) {
      const int p0 = s0 + kTapV * grp, e = p.lo + kTapV * grp;
      float acc[kTapV];
      if constexpr (KT > 0)
        taps_fixed<KT, DT>(buf, e, w, wr, p0 % w, acc);
      else
        taps_any(buf, e, w, ws, k, dil, p0, acc);
      float* o = op + p0;
      if (p.vout && p0 + kTapV <= P) {
        reinterpret_cast<float4*>(o)[0] =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
        reinterpret_cast<float4*>(o)[1] =
            make_float4(acc[4], acc[5], acc[6], acc[7]);
      } else {
#pragma unroll
        for (int i = 0; i < kTapV; ++i)
          if (p0 + i < P) o[i] = acc[i];
      }
    }
  }
}

// The v1 form, kept for A/B timing only (segtpu_dw_tap_sum_v1): one
// thread per output pixel and channel, a block 256 pixels of one channel of
// one tile, the channel's weights in shared memory, k*k scalar 2-byte
// loads a thread. KT > 0: k compiled; 0: k at run time.
template <int KT>
__global__ void dw_tap_sum_v1_kernel(const __nv_bfloat16* __restrict__ x,
                                     const float* __restrict__ wt,
                                     float* __restrict__ out, int C, int P,
                                     int row_w, int halo, int k_rt, int dil) {
  const int k = KT > 0 ? KT : k_rt;
  __shared__ float ws[kMaxTaps];
  const int ch = blockIdx.y;
  const int g = blockIdx.z;
  for (int j = threadIdx.x; j < k * k; j += blockDim.x) ws[j] = wt[j * C + ch];
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const long long plane = (long long)(g * C + ch);
  const __nv_bfloat16* xs = x + plane * (P + 2 * halo) + halo + p;
  const int col = p % row_w;
  const int half = k / 2;
  float acc = 0.f;
  bool have_acc = false;
#pragma unroll
  for (int kx = 0; kx < k; ++kx) {
    const int dx = dil * (kx - half);
    if (dx >= row_w || -dx >= row_w) continue;
    float part = 0.f;
#pragma unroll
    for (int ky = 0; ky < k; ++ky) {
      const int dy = dil * (ky - half);
      const float term =
          __fmul_rn(ws[ky * k + kx], __bfloat162float(xs[dy * row_w + dx]));
      part = ky == 0 ? term : __fadd_rn(part, term);
    }
    if (dx != 0)
      part = __fmul_rn(part, (col + dx >= 0 && col + dx < row_w) ? 1.f : 0.f);
    acc = have_acc ? __fadd_rn(acc, part) : part;
    have_acc = true;
  }
  out[plane * P + p] = acc;
}

template <int KT, int DT>
int launch_tap(const TapPlan& p, long long items, cudaStream_t s,
               const __nv_bfloat16* x, const float* wt, float* out, int G,
               int C, int P, int w, int halo, int k, int dil) {
  auto* kern = dw_tap_kernel<KT, DT>;
  const int rc = set_smem(kern, p.smem);
  if (rc) return rc;
  const int gx = resident_blocks(kern, p.nt, p.smem, items, 1);
  if (gx < 1) return (int)cudaErrorInvalidValue;
  kern<<<gx, p.nt, p.smem, s>>>(x, wt, out, G, C, P, w, halo, k, dil, p);
  return (int)cudaGetLastError();
}

// The (k, dilation) pairs compiled into taps_fixed.
inline bool tap_compiled(int kt, int dt) {
  return (dt == 1 && (kt == 3 || kt == 5 || kt == 7)) ||
         (kt == 3 && dt == 3) || (kt == 5 && dt == 6);
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int segtpu_fma_peak(const void* x, void* out, long long n,
                               int n_acc, int reps, void* stream) {
  const dim3 block(256);
  const dim3 grid((unsigned)((n + 255) / 256));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  switch (n_acc) {
    case 1: fma_peak_kernel<1><<<grid, block, 0, s>>>(xi, o, n, reps); break;
    case 2: fma_peak_kernel<2><<<grid, block, 0, s>>>(xi, o, n, reps); break;
    case 4: fma_peak_kernel<4><<<grid, block, 0, s>>>(xi, o, n, reps); break;
    case 8: fma_peak_kernel<8><<<grid, block, 0, s>>>(xi, o, n, reps); break;
    case 16: fma_peak_kernel<16><<<grid, block, 0, s>>>(xi, o, n, reps); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// plan: the 9 ints (s, nt, lo, hi, kt, dt, smem, vin, vout) of tap_plan and
// tap_args, rejected when they do not fit this source's layout.
extern "C" int segtpu_dw_tap_sum(const void* x, const void* wt, void* out,
                                 int G, int C, int P, int row_w, int halo,
                                 int k, int dil, const int* plan,
                                 void* stream) {
  if (!plan || k < 1 || k * k > kMaxTaps || dil < 1 || row_w < 1 ||
      G < 1 || C < 1 || P < 1 || P % row_w)
    return (int)cudaErrorInvalidValue;
  const TapPlan p{plan[0], plan[1], plan[2], plan[3], plan[4],
                  plan[5], plan[6], plan[7], plan[8]};
  const int margin = tap_margin(k, dil, row_w), T = P + 2 * halo;
  const bool fixed = p.kt > 0 || p.dt > 0;
  const bool ok =
      p.s >= kTapV && p.s % kTapV == 0 && p.nt >= 32 && p.nt % 32 == 0 &&
      p.nt <= kTapMaxThreads && p.lo == margin && p.hi == margin &&
      p.smem == tap_smem(p, k) && halo >= 0 &&
      (!fixed || (p.kt == k && p.dt == dil && tap_compiled(k, dil) &&
                  row_w % 8 == 0 && dil * (k / 2) < row_w)) &&
      (!p.vin || (T % 8 == 0 && halo % 8 == 0 &&
                  (reinterpret_cast<uintptr_t>(x) & 15) == 0)) &&
      (!p.vout ||
       (P % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0));
  if (!ok) return (int)cudaErrorInvalidValue;
  const long long items = (long long)G * C * ((P + p.s - 1) / p.s);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const __nv_bfloat16*>(x);
  const auto* wi = static_cast<const float*>(wt);
  float* o = static_cast<float*>(out);
#define SEGTPU_TAP(KT, DT)                                                   \
  if (p.kt == KT && p.dt == DT)                                              \
    return launch_tap<KT, DT>(p, items, s, xi, wi, o, G, C, P, row_w, halo, \
                              k, dil);
  SEGTPU_TAP(3, 1)
  SEGTPU_TAP(5, 1)
  SEGTPU_TAP(7, 1)
  SEGTPU_TAP(3, 3)
  SEGTPU_TAP(5, 6)
#undef SEGTPU_TAP
  return launch_tap<0, 0>(p, items, s, xi, wi, o, G, C, P, row_w, halo, k,
                          dil);
}

// The v1 kernel (dw_tap_sum_v1_kernel), for A/B timing only; the
// wrapper never launches it.
extern "C" int segtpu_dw_tap_sum_v1(const void* x, const void* wt, void* out,
                                    int G, int C, int P, int row_w, int halo,
                                    int k, int dil, void* stream) {
  if (k * k > kMaxTaps) return (int)cudaErrorInvalidValue;
  const dim3 block(256);
  const dim3 grid((P + 255) / 256, C, G);
  auto* kernel = k == 3   ? dw_tap_sum_v1_kernel<3>
                 : k == 5 ? dw_tap_sum_v1_kernel<5>
                 : k == 7 ? dw_tap_sum_v1_kernel<7>
                          : dw_tap_sum_v1_kernel<0>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(wt),
      static_cast<float*>(out), C, P, row_w, halo, k, dil);
  return (int)cudaGetLastError();
}
