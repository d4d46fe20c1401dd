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
//   separately, in the order of the plain version, so the two agree bit for
//   bit. Taps with |dx| >= w are dropped, as _taps drops them.
//   Bound on the H100: memory. At C = 48, k = 3, 16 tiles of 64 x 512 it
//   reads 69 MB of bf16 and writes 101 MB of f32 (0.05 ms) for 0.45 GFLOP.
//   Design (simple first version): one thread per output pixel and
//   channel; a block covers 256 pixels of one channel of one tile and keeps
//   that channel's k*k weights in shared memory. The k*k reads of a thread
//   overlap its neighbours' and hit L1. k = 3, 5, 7 are compiled apart with
//   their tap loops unrolled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int kMaxTaps = 15 * 15;

// KT > 0: the window k as a compile-time constant, so the tap loops unroll
// and a thread issues all its loads before its first product; KT = 0 takes
// k at run time.
template <int KT>
__global__ void dw_tap_sum_kernel(const __nv_bfloat16* __restrict__ x,
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

extern "C" int segtpu_dw_tap_sum(const void* x, const void* wt, void* out,
                                 int G, int C, int P, int row_w, int halo,
                                 int k, int dil, void* stream) {
  if (k * k > kMaxTaps) return (int)cudaErrorInvalidValue;
  const dim3 block(256);
  const dim3 grid((P + 255) / 256, C, G);
  auto* kernel = k == 3   ? dw_tap_sum_kernel<3>
                 : k == 5 ? dw_tap_sum_kernel<5>
                 : k == 7 ? dw_tap_sum_kernel<7>
                          : dw_tap_sum_kernel<0>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(wt),
      static_cast<float*>(out), C, P, row_w, halo, k, dil);
  return (int)cudaGetLastError();
}
