// Classifier-fused upsample + argmax tail, CUDA C++ for sm_90a.
//
// Replaces: scripts/exp_tail_flat.py::_kernel (build_flat_tail), the
// experiment's tail that applies the 1x1 classifier itself instead of
// reading logits that a separate classifier kernel wrote.
//
// Function: feat bf16 [B, C, h, w] (w a multiple of 8), classifier wclf bf16 [K, C] and bias
// bclf f32 [K] -> uint8 mask [B, Ho, Wo], rounding where the TPU kernel
// rounds:
//   logits_k = bf16(sum_c wclf[k, c] * feat[c] + bclf[k]), the sum in f32
//              from zero in channel order (each product is exact in f32);
//   H pass:    t = bf16(a0 * L[r0, x] + a1 * L[r1, x]) with the H weights
//              rounded to bf16;
//   W pass:    v = b0 * t[y, c0] + b1 * t[y, c1] in f32 with the W weights
//              rounded to bf16 (the production tail keeps them in f32);
//   argmax:    the first class initialises, then strict >, so ties go to
//              the lower class.
// Every product of the H and W passes is of two bf16 values, so exact in
// f32, and each pass rounds once: the plain PyTorch version gives the same
// bits. The 2-tap tables are _interp_matrix's entries (r0 <= r1,
// nondecreasing along the output), cropped to Ho x Wo.
//
// Bound on the H100: memory. At 8 x 48 x 256 x 512 -> 8 x 1024 x 2048 with
// K = 19 it reads 101 MB of features and writes 17 MB of mask (0.035 ms at
// 3.35 TB/s); the classifier's 1.9 GFLOP are bf16 products (0.002 ms on the
// tensor cores) and the two passes and the argmax ~1.5 GFLOP of f32
// (0.023 ms at 67 TFLOP/s).
// Design: a block owns a TH x TW tile of the output and stages the feature
// band the tile reads (all C channels, the rows and columns its taps reach)
// in shared memory once, by 16-byte cp.async copies, so the whole band's
// reads are in flight together. Three phases, each over all K classes, with a barrier
// between them:
//   A. the classifier at every band pixel: a thread takes a pixel and a
//      chunk of KC classes, reads each feature value once for the chunk and
//      keeps KC independent sums in registers (the weights, transposed to
//      [C][K], arrive as float4 broadcasts); the bf16 logits of all classes
//      go to shared memory;
//   B. the H pass of every class into shared memory, over the feature band,
//      which phase A no longer needs (a warp per output row, its taps read
//      once for all classes);
//   C. the W pass and the running argmax: a thread owns TH*TW/THREADS
//      pixels and walks the classes in order, (max, class) in registers.
// Neither the logits nor the upsampled planes reach global memory.
// Neighbouring tiles recompute the band rows and columns they share (~55 %
// more classifier work at a 4x upsample and a 16 x 256 tile; the
// classifier is the cheapest phase). The products are on the CUDA
// cores: a product of two bf16 values is exact in f32, so fmaf(a, b, c)
// rounds exactly as c + a * b with the product and the sum rounded apart,
// which is what the plain version computes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int TH = 16;       // output rows of a tile
constexpr int TW = 256;      // output columns of a tile
constexpr int THREADS = 256;
constexpr int PER_THREAD = TH * TW / THREADS;
constexpr int KC = 8;        // classes a thread sums at once in phase A
constexpr int WARPS = THREADS / 32;

// Columns of a staged feature row: the band from the multiple of 8 below
// its first column, in whole 16-byte chunks, so every copy is aligned.
__host__ __device__ inline int feat_band_c(int band_c) {
  return (band_c + 14) & ~7;
}

__device__ __forceinline__ float bf(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}

__global__ void __launch_bounds__(THREADS)
clf_upsample_argmax_kernel(const __nv_bfloat16* __restrict__ feat,
                           const __nv_bfloat16* __restrict__ wclf,
                           const float* __restrict__ bclf,
                           uint8_t* __restrict__ out, int C, int K, int h,
                           int w, int ho, int wo, int band_r, int band_c,
                           const int* __restrict__ rows,
                           const float* __restrict__ rw,
                           const int* __restrict__ cols,
                           const float* __restrict__ cw) {
  extern __shared__ __align__(16) unsigned char smem[];
  // [C][KP] f32 weights (KP = K rounded up to KC), [K][band] bf16 logits
  // (padded to 16 bytes), then one region that holds first the
  // [C][band_r][fband_c] bf16 features and then the [K][TH][band_c] bf16
  // H-pass rows
  const int KP = (K + KC - 1) / KC * KC;
  const int band = band_r * band_c;
  const int fband_c = feat_band_c(band_c), fband = band_r * fband_c;
  float* ws = reinterpret_cast<float*>(smem);
  __nv_bfloat16* ls = reinterpret_cast<__nv_bfloat16*>(ws + C * KP);
  __nv_bfloat16* fs = ls + (K * band + 7) / 8 * 8;
  __nv_bfloat16* ts = fs;

  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, b = blockIdx.z;
  const int nx = min(TW, wo - x0), ny = min(TH, ho - y0);
  const int r_lo = rows[y0], r_n = rows[ho + y0 + ny - 1] - r_lo + 1;
  const int c_lo = cols[x0], c_n = cols[wo + x0 + nx - 1] - c_lo + 1;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // the feature band by 16-byte cp.async copies spread over all threads,
  // from the column c_al (c_lo rounded down to a multiple of 8; w is one,
  // so every copy is aligned and none passes the row's end): no thread
  // waits on a load before it issues the next, so the whole band is in
  // flight at once
  const int c_al = c_lo & ~7, sh = c_lo - c_al;
  const int chunks = (c_n + sh + 7) / 8;
  const __nv_bfloat16* fb = feat + (size_t)b * C * h * w + c_al;
  const unsigned fs_s = (unsigned)__cvta_generic_to_shared(fs);
  for (int e = tid; e < C * r_n * chunks; e += THREADS) {
    const int cr = e / chunks, q = e - cr * chunks;
    const int c = cr / r_n, r = cr - c * r_n;
    const __nv_bfloat16* src = fb + ((size_t)c * h + r_lo + r) * w + 8 * q;
    const unsigned dst = fs_s + 2 * (c * fband + r * fband_c + 8 * q);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 ::"r"(dst), "l"(src));
  }
  for (int e = tid; e < C * KP; e += THREADS) {
    const int c = e / KP, k = e % KP;
    ws[e] = k < K ? bf(wclf[k * C + c]) : 0.f;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // A: logits of every class at every band pixel, summed from zero in
  // channel order
  const int n_chunks = KP / KC;
  for (int e = tid; e < r_n * c_n * n_chunks; e += THREADS) {
    const int px = e % (r_n * c_n), k0 = e / (r_n * c_n) * KC;
    const int py = px / c_n, pc = px - py * c_n;
    const int off = py * band_c + pc, foff = py * fband_c + pc + sh;
    float acc[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) acc[j] = 0.f;
    for (int c = 0; c < C; ++c) {
      const float f = bf(fs[c * fband + foff]);
      const float4 w0 = *reinterpret_cast<const float4*>(ws + c * KP + k0);
      const float4 w1 = *reinterpret_cast<const float4*>(ws + c * KP + k0 + 4);
      acc[0] = __fmaf_rn(w0.x, f, acc[0]);
      acc[1] = __fmaf_rn(w0.y, f, acc[1]);
      acc[2] = __fmaf_rn(w0.z, f, acc[2]);
      acc[3] = __fmaf_rn(w0.w, f, acc[3]);
      acc[4] = __fmaf_rn(w1.x, f, acc[4]);
      acc[5] = __fmaf_rn(w1.y, f, acc[5]);
      acc[6] = __fmaf_rn(w1.z, f, acc[6]);
      acc[7] = __fmaf_rn(w1.w, f, acc[7]);
    }
#pragma unroll
    for (int j = 0; j < KC; ++j)
      if (k0 + j < K)
        ls[(k0 + j) * band + off] =
            __float2bfloat16_rn(__fadd_rn(acc[j], bclf[k0 + j]));
  }
  __syncthreads();

  // B: the H pass of every class (over the feature band, now free): a warp
  // takes one output row at a time, reads its taps once and walks the
  // classes, its lanes the band columns
  for (int y = warp; y < ny; y += WARPS) {
    const int gy = y0 + y;
    const float a0 = rw[gy], a1 = rw[ho + gy];
    const int o0 = (rows[gy] - r_lo) * band_c;
    const int o1 = (rows[ho + gy] - r_lo) * band_c;
    for (int k = 0; k < K; ++k) {
      const __nv_bfloat16* l = ls + k * band;
      __nv_bfloat16* t = ts + (k * TH + y) * band_c;
      for (int q = lane; q < c_n; q += 32)
        t[q] = __float2bfloat16_rn(
            __fmaf_rn(a1, bf(l[o1 + q]), __fmul_rn(a0, bf(l[o0 + q]))));
    }
  }
  __syncthreads();

  // C: the W pass and the running argmax, classes in order; the thread's
  // pixels are independent, so their loads overlap
  const int ox = tid % TW;
  if (ox >= nx) return;
  const int c0 = cols[x0 + ox] - c_lo, c1 = cols[wo + x0 + ox] - c_lo;
  const float b0 = cw[x0 + ox], b1 = cw[wo + x0 + ox];
  const int y_first = tid / TW;
  float best[PER_THREAD] = {};
  int arg[PER_THREAD] = {};
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int m = 0; m < PER_THREAD; ++m) {
      const int y = y_first + m * (THREADS / TW);
      if (y >= ny) break;
      const __nv_bfloat16* t = ts + (k * TH + y) * band_c;
      const float v = __fmaf_rn(b1, bf(t[c1]), __fmul_rn(b0, bf(t[c0])));
      if (k == 0 || v > best[m]) {
        best[m] = v;
        arg[m] = k;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < PER_THREAD; ++m) {
    const int y = y_first + m * (THREADS / TW);
    if (y >= ny) break;
    out[((size_t)b * ho + y0 + y) * wo + x0 + ox] = (uint8_t)arg[m];
  }
}

// Shared memory of one block, in bytes (see the kernel's layout).
static long long smem_bytes(int C, int K, int band_r, int band_c) {
  const long long kp = (K + KC - 1) / KC * KC;
  const long long band = (long long)band_r * band_c;
  const long long feats = (long long)C * band_r * feat_band_c(band_c);
  const long long region = feats > (long long)K * TH * band_c
                               ? feats : (long long)K * TH * band_c;
  return C * kp * 4 + ((K * band + 7) / 8 * 8 + region) * 2;
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// rows/rw are [2, ho] and cols/cw [2, wo] tap tables (low tap, then high).
extern "C" int segtpu_clf_upsample_argmax(
    const void* feat, const void* wclf, const void* bclf, void* out, int B,
    int C, int K, int h, int w, int ho, int wo, int band_r, int band_c,
    const int* rows, const float* rw, const int* cols, const float* cw,
    void* stream) {
  const long long smem = smem_bytes(C, K, band_r, band_c);
  if (smem > 227 * 1024 || K > 256 || w % 8 ||
      reinterpret_cast<uintptr_t>(feat) % 16)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        clf_upsample_argmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((wo + TW - 1) / TW, (ho + TH - 1) / TH, B);
  clf_upsample_argmax_kernel<<<grid, THREADS, (size_t)smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(feat),
      static_cast<const __nv_bfloat16*>(wclf), static_cast<const float*>(bclf),
      static_cast<uint8_t*>(out), C, K, h, w, ho, wo, band_r, band_c, rows, rw,
      cols, cw);
  return (int)cudaGetLastError();
}
