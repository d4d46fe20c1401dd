// Fused bilinear upsample + class argmax tail, CUDA C++ for sm_90a.
//
// Replaces: segtpu/kernels/upsample_argmax.py::upsample_argmax (the banded
// Pallas TPU kernel _kernel via _ua_core, 4-D channel-first form), its
// W-first form upsample_argmax_flat and its H-sharded form
// upsample_argmax_sharded (each further down, with its own kernel).
//
// Function: logits [B, K, h, w] (bf16 or f32) -> uint8 mask [B, Ho, Wo],
//   mask = argmax_k bilinear_upsample(logits, (grid_h, grid_w))[:, k, :Ho, :Wo]
// with the TPU kernel's operation order:
//   H pass first: t(c) = a0 * x[r0, c] + a1 * x[r1, c] at the two input
//     columns the output column reads. In bf16 mode the H weights are
//     bf16-rounded and t is rounded to bf16 (the TPU kernel's bf16 dot
//     operands and its bf16 cast of the H-pass result).
//   W pass: v = b0 * t(c0) + b1 * t(c1) with the f32 W weights, in f32.
//   argmax: strict > from -inf, so ties go to the lower class.
// The 2-tap tables (r0, r1, a0, a1 per output row; c0, c1, b0, b1 per
// output column) hold _interp_matrix's float32 entries, cropped to Ho/Wo;
// a merged single entry (r0 == r1) has a1 = 0. Every product and sum is
// rounded separately (no FMA contraction), as in the plain PyTorch version.
// The full-resolution logits never reach global memory.
//
// Bound on the H100: at 8 x 19 x 256 x 512 bf16 -> 8 x 1024 x 2048 it
// must read 40 MB and write 17 MB (~17 us at 3.35 TB/s) and do ~1.5 GFLOP
// of f32 arithmetic even with the H pass shared across output columns
// (~23 us at 67 TFLOP/s), so the arithmetic is the tighter floor.
// Design (simple first version): one thread per output pixel; it loops
// over the K classes, reads the 2 x 2 input taps of each class plane and
// keeps (best, idx) in registers, then writes one byte. A warp covers 32
// neighbouring output columns, which share ~9 input columns: the tap reads
// hit L1/L2 (the whole logit tensor is 40 MB, within the 50 MB L2), so DRAM
// traffic stays near the floor. The thread recomputes the H pass for each
// output column it owns (4x redundant at a 4x upsample), which is the first
// thing a tuning pass would share through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T, bool BF16>
__global__ void upsample_argmax_kernel(
    const T* __restrict__ x, uint8_t* __restrict__ out, int K, int h, int w,
    int ho, int wo, const int* __restrict__ rows, const float* __restrict__ rw,
    const int* __restrict__ cols, const float* __restrict__ cw) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y;
  const int b = blockIdx.z;
  if (ox >= wo) return;
  // tables: rows/rw are [2, ho] (low tap, high tap); cols/cw are [2, wo]
  const int r0 = rows[oy], r1 = rows[ho + oy];
  const float a0 = rw[oy], a1 = rw[ho + oy];
  const int c0 = cols[ox], c1 = cols[wo + ox];
  const float b0 = cw[ox], b1 = cw[wo + ox];

  const size_t hw = (size_t)h * w;
  const T* p = x + (size_t)b * K * hw;
  const size_t o00 = (size_t)r0 * w + c0, o01 = (size_t)r0 * w + c1;
  const size_t o10 = (size_t)r1 * w + c0, o11 = (size_t)r1 * w + c1;

  float best = -INFINITY;
  int idx = 0;
  for (int k = 0; k < K; ++k) {
    const T* pk = p + (size_t)k * hw;
    float t0 = __fadd_rn(__fmul_rn(a0, load_f32(pk + o00)),
                         __fmul_rn(a1, load_f32(pk + o10)));
    float t1 = __fadd_rn(__fmul_rn(a0, load_f32(pk + o01)),
                         __fmul_rn(a1, load_f32(pk + o11)));
    if (BF16) {
      t0 = __bfloat162float(__float2bfloat16_rn(t0));
      t1 = __bfloat162float(__float2bfloat16_rn(t1));
    }
    const float v = __fadd_rn(__fmul_rn(t0, b0), __fmul_rn(t1, b1));
    if (v > best) {
      best = v;
      idx = k;
    }
  }
  out[((size_t)b * ho + oy) * wo + ox] = (uint8_t)idx;
}

// The W-first order of segtpu/kernels/upsample_argmax.py::
// upsample_argmax_flat (Pallas _kernel_flat, which the JAX engine runs for
// decoder widths of at most 128): the W pass first on both input rows,
//   z(r) = b0 * x[r, c0] + b1 * x[r, c1]
// with the W weights bf16-rounded in bf16 mode (the TPU kernel's bf16 dot
// operands; bf16 products are exact, so its f32 accumulation rounds once)
// and z kept in f32, then the H pass v = a0 * z(r0) + a1 * z(r1) with the f32
// H weights, then the same argmax. The TPU kernel's flat [B, K, h * w] input
// is the same memory as the contiguous [B, K, h, w] tensor here.
template <typename T>
__global__ void upsample_argmax_flat_kernel(
    const T* __restrict__ x, uint8_t* __restrict__ out, int K, int h, int w,
    int ho, int wo, const int* __restrict__ rows, const float* __restrict__ rw,
    const int* __restrict__ cols, const float* __restrict__ cw) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y;
  const int b = blockIdx.z;
  if (ox >= wo) return;
  const int r0 = rows[oy], r1 = rows[ho + oy];
  const float a0 = rw[oy], a1 = rw[ho + oy];
  const int c0 = cols[ox], c1 = cols[wo + ox];
  const float b0 = cw[ox], b1 = cw[wo + ox];

  const size_t hw = (size_t)h * w;
  const T* p = x + (size_t)b * K * hw;
  const size_t o00 = (size_t)r0 * w + c0, o01 = (size_t)r0 * w + c1;
  const size_t o10 = (size_t)r1 * w + c0, o11 = (size_t)r1 * w + c1;

  float best = -INFINITY;
  int idx = 0;
  for (int k = 0; k < K; ++k) {
    const T* pk = p + (size_t)k * hw;
    const float z0 = __fadd_rn(__fmul_rn(b0, load_f32(pk + o00)),
                               __fmul_rn(b1, load_f32(pk + o01)));
    const float z1 = __fadd_rn(__fmul_rn(b0, load_f32(pk + o10)),
                               __fmul_rn(b1, load_f32(pk + o11)));
    const float v = __fadd_rn(__fmul_rn(a0, z0), __fmul_rn(a1, z1));
    if (v > best) {
      best = v;
      idx = k;
    }
  }
  out[((size_t)b * ho + oy) * wo + ox] = (uint8_t)idx;
}

// The H-sharded tail of segtpu/kernels/upsample_argmax.py::
// upsample_argmax_sharded (the TPU version all-gathers the stride-4 logits
// and selects per-shard stacked bands by axis_index; here a shard keeps its
// own rows). One shard of an H-sharded frame: x is a WINDOW of logit rows
// [B, K, hwin, w], whose first row is global input row `in_row0` (negative
// for the first shard's zero halo row), and the kernel writes global output
// rows [out_row0, out_row0 + rows_out) of the (H, wo) mask into out
// [B, rows_out, wo]. rows/rw are the row tables of the WHOLE frame, [2, H]:
// output row out_row0 + oy reads input rows rows[.] - in_row0 of the
// window, with the unsharded kernel's weights and arithmetic (H pass, bf16
// rounding in bf16 mode, f32 W pass, strict-greater argmax), so every row
// has the bits of upsample_argmax_kernel's row. The caller checks that the
// window holds every row the taps name; a tap never points outside the
// image, so a mesh-end halo row is never read.
// Bound on the H100 at n = 4 shards of 8 x 19 x 256 x 512 bf16: per shard
// 10 MB of logits in and 4 MB of mask out (~4.4 us at 3.35 TB/s) against
// ~0.4 GFLOP of f32 interpolation (~5.8 us at 67 TFLOP/s): operations.
// Design: as upsample_argmax_kernel, one thread per output pixel looping
// over the classes with (best, idx) in registers.
template <typename T, bool BF16>
__global__ void upsample_argmax_sharded_kernel(
    const T* __restrict__ x, uint8_t* __restrict__ out, int K, int hwin, int w,
    int rows_out, int wo, int H, int in_row0, int out_row0,
    const int* __restrict__ rows, const float* __restrict__ rw,
    const int* __restrict__ cols, const float* __restrict__ cw) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y;
  const int b = blockIdx.z;
  if (ox >= wo) return;
  const int gy = out_row0 + oy;                 // row of the whole mask
  const int r0 = rows[gy] - in_row0, r1 = rows[H + gy] - in_row0;
  const float a0 = rw[gy], a1 = rw[H + gy];
  const int c0 = cols[ox], c1 = cols[wo + ox];
  const float b0 = cw[ox], b1 = cw[wo + ox];

  const size_t hw = (size_t)hwin * w;
  const T* p = x + (size_t)b * K * hw;
  const size_t o00 = (size_t)r0 * w + c0, o01 = (size_t)r0 * w + c1;
  const size_t o10 = (size_t)r1 * w + c0, o11 = (size_t)r1 * w + c1;

  float best = -INFINITY;
  int idx = 0;
  for (int k = 0; k < K; ++k) {
    const T* pk = p + (size_t)k * hw;
    float t0 = __fadd_rn(__fmul_rn(a0, load_f32(pk + o00)),
                         __fmul_rn(a1, load_f32(pk + o10)));
    float t1 = __fadd_rn(__fmul_rn(a0, load_f32(pk + o01)),
                         __fmul_rn(a1, load_f32(pk + o11)));
    if (BF16) {
      t0 = __bfloat162float(__float2bfloat16_rn(t0));
      t1 = __bfloat162float(__float2bfloat16_rn(t1));
    }
    const float v = __fadd_rn(__fmul_rn(t0, b0), __fmul_rn(t1, b1));
    if (v > best) {
      best = v;
      idx = k;
    }
  }
  out[((size_t)b * rows_out + oy) * wo + ox] = (uint8_t)idx;
}

// Launches one shard's tail on `stream`; returns the cudaError_t of the
// launch (0 = ok). rows/rw are [2, H] (the whole frame's row tables, H weights
// bf16-rounded by the caller in bf16 mode), cols/cw [2, wo].
extern "C" int segtpu_upsample_argmax_sharded(
    const void* logits, void* out, int B, int K, int hwin, int w, int rows_out,
    int wo, int H, int in_row0, int out_row0, int in_bf16, const int* rows,
    const float* rw, const int* cols, const float* cw, void* stream) {
  if (out_row0 < 0 || out_row0 + rows_out > H) return (int)cudaErrorInvalidValue;
  const dim3 block(256);
  const dim3 grid((wo + 255) / 256, rows_out, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (in_bf16)
    upsample_argmax_sharded_kernel<__nv_bfloat16, true><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), o, K, hwin, w, rows_out, wo,
        H, in_row0, out_row0, rows, rw, cols, cw);
  else
    upsample_argmax_sharded_kernel<float, false><<<grid, block, 0, s>>>(
        static_cast<const float*>(logits), o, K, hwin, w, rows_out, wo, H,
        in_row0, out_row0, rows, rw, cols, cw);
  return (int)cudaGetLastError();
}

// Launches the W-first kernel; arguments as segtpu_upsample_argmax, with the
// W weights (cw) bf16-rounded by the caller in bf16 mode.
extern "C" int segtpu_upsample_argmax_flat(
    const void* logits, void* out, int B, int K, int h, int w, int ho, int wo,
    int in_bf16, const int* rows, const float* rw, const int* cols,
    const float* cw, void* stream) {
  const dim3 block(256);
  const dim3 grid((wo + 255) / 256, ho, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (in_bf16)
    upsample_argmax_flat_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), o, K, h, w, ho, wo, rows,
        rw, cols, cw);
  else
    upsample_argmax_flat_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(logits), o, K, h, w, ho, wo, rows, rw, cols,
        cw);
  return (int)cudaGetLastError();
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int segtpu_upsample_argmax(const void* logits, void* out, int B,
                                      int K, int h, int w, int ho, int wo,
                                      int in_bf16, const int* rows,
                                      const float* rw, const int* cols,
                                      const float* cw, void* stream) {
  const dim3 block(256);
  const dim3 grid((wo + 255) / 256, ho, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (in_bf16)
    upsample_argmax_kernel<__nv_bfloat16, true><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), o, K, h, w, ho, wo, rows,
        rw, cols, cw);
  else
    upsample_argmax_kernel<float, false><<<grid, block, 0, s>>>(
        static_cast<const float*>(logits), o, K, h, w, ho, wo, rows, rw, cols,
        cw);
  return (int)cudaGetLastError();
}
