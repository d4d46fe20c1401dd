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
// (~23 us at 67 TFLOP/s), so the arithmetic is the tighter floor; the W
// pass and the argmax alone are ~2.5 G lane instructions (~0.09 ms at the
// card's issue rate).
// Design (upsample_argmax_kernel): a persistent block walks items of one
// image: a band of br output rows x a segment of sw output columns (4 x
// 256 on the main path). For each chunk of kc classes (all 19 on the main
// path) it stages the input rows the band's taps name (from the first
// row's low tap, nr of them) x the input columns the segment's taps name
// (from the first column's low tap aligned down to 8, nc of them) with
// 16-byte cp.async into one of two buffers, the next step's while this
// one computes. Then the H pass once per (class, output row, input
// column) into shared memory as f32 (bf16-rounded in bf16 mode), lanes
// over (class, 8 columns) with 16-byte reads, so the ~4 output columns
// that share an input column share its H pass. Then each thread takes 8
// consecutive output columns of one row, its W taps in registers, loops
// over the chunk's classes with (best, idx) per pixel in registers, and
// after the last chunk writes its 8 class bytes as one 8-byte store. A
// half-warp covers 128 columns of one row, the two halves of a warp two
// rows, whose H-pass rows sit an odd number of words apart (pitch nc + 1),
// so the W pass's shared-memory reads of the two halves fall in other
// banks. The W pass and the argmax (~10 instructions a pixel and class)
// take most of the time. tail_plan (kernels/upsample_argmax.py) derives
// (br, sw, nr, nc, kc) from the tables and the C entry checks them
// against tail_smem. Widths that are not a multiple of 8 (16 bytes of
// logits, or the 8-byte store) take scalar loads and stores, cut at the
// ragged right edge. The arithmetic of every output is the per-pixel
// kernel's it replaced, so the masks keep its bits and the plain twin's.

#include "pw_tile.cuh"

#include <math.h>

using namespace segtpu;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

namespace {

constexpr int kTailPX = 8;              // output columns a thread
constexpr int kTailMaxThreads = 256;

// The plan of a tail launch (kernels/upsample_argmax.py tail_plan): bands
// of br output rows x segments of sw output columns; nr input rows and nc
// input columns staged (the most any band or segment of the geometry
// names), kc classes a chunk; smem bytes; vin: 16-byte loads of the
// logits; vout: 8-byte stores of the mask.
struct TailPlan {
  int br, sw, nr, nc, kc, smem, vin, vout;
};

// Floats between two H-pass rows: odd (see the design note above).
inline __host__ __device__ int tail_pitch(int nc) { return nc + 1; }

inline int tail_threads(const TailPlan& p) { return p.br * p.sw / kTailPX; }

// Shared bytes of a plan: two buffers of staged logits [kc][nr][nc] in T,
// then the H pass [kc][br][tail_pitch] in f32.
inline __host__ __device__ int tail_staged_bytes(const TailPlan& p, int elt) {
  return (p.kc * p.nr * p.nc * elt + 15) & ~15;
}
inline int tail_smem(const TailPlan& p, int elt) {
  return 2 * tail_staged_bytes(p, elt) + 4 * p.kc * p.br * tail_pitch(p.nc);
}

// A persistent block walks the items blockIdx.x, + gridDim.x, ... (item:
// image b, band, segment; segment fastest), each item's chunks of classes
// one step; step s + 1's logits are staged into the other buffer while
// step s computes.
template <typename T, bool BF16>
__global__ void __launch_bounds__(kTailMaxThreads, 2)
    upsample_argmax_kernel(const T* __restrict__ x, uint8_t* __restrict__ out,
                           int B, int K, int h, int w, int ho, int wo,
                           const int* __restrict__ rows,
                           const float* __restrict__ rw,
                           const int* __restrict__ cols,
                           const float* __restrict__ cw, TailPlan p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int E = 16 / sizeof(T);
  const int staged = tail_staged_bytes(p, sizeof(T));
  float* t_s = smem + 2 * staged / 4;                 // [kc][br][pitch]
  const int pitch = tail_pitch(p.nc);
  const int nt = blockDim.x, nw = nt / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nseg = (wo + p.sw - 1) / p.sw, nband = (ho + p.br - 1) / p.br;
  const int items = B * nband * nseg, nch = (K + p.kc - 1) / p.kc;
  const int mine = items > (int)blockIdx.x
                       ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int steps = mine * nch;
  // tables: rows/rw are [2, ho] (low tap, high tap); cols/cw are [2, wo]
  auto item_of = [&](int s, int& b, int& oy0, int& ox0) {
    const int item = blockIdx.x + (s / nch) * gridDim.x;
    const int rest = item / nseg, band = rest % nband;
    ox0 = (item - rest * nseg) * p.sw;
    oy0 = band * p.br;
    b = rest / nband;
  };
  // stage step s's classes: rows from the band's first low tap, columns
  // from the segment's first low tap aligned down to 8, zero outside the
  // image, one warp per staged row
  auto issue = [&](int s) {
    if (s < steps) {
      int b, oy0, ox0;
      item_of(s, b, oy0, ox0);
      const int k0 = (s % nch) * p.kc, kc = min(p.kc, K - k0);
      const int r_lo = rows[oy0], c_lo = cols[ox0] & ~7;
      const T* xb = x + ((size_t)b * K + k0) * h * w;
      T* buf = reinterpret_cast<T*>(smem + (s & 1) * staged / 4);
      const int nchunk = p.nc / E;               // 16-byte chunks a row
      for (int q = threadIdx.x; q < kc * p.nr * nchunk; q += nt) {
        const int rr = q / nchunk, j = (q - rr * nchunk) * E;
        const int kk = rr / p.nr, gr = r_lo + rr - kk * p.nr;
        const bool in = gr < h && c_lo + j < w;
        const T* src = xb + ((size_t)kk * h + (in ? gr : 0)) * w + c_lo + j;
        if (p.vin) {
          cp_async16(buf + rr * p.nc + j, in ? src : x, in ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e)
            buf[rr * p.nc + j + e] =
                in && c_lo + j + e < w ? src[e] : from_f32<T>(0.f);
        }
      }
    }
    cp_async_commit();
  };

  // this thread's W pass: row `row` of the band, 8 columns from ox0 + col
  const int half = threadIdx.x / 16, row = half % p.br;
  const int col = (half / p.br) * 16 * kTailPX + (threadIdx.x % 16) * kTailPX;
  int j0[kTailPX], j1[kTailPX];
  float b0[kTailPX], b1[kTailPX], best[kTailPX];
  uint32_t idx[kTailPX];
  // H-pass work of this warp: rows warp % br, + nw, ...; a row's (class,
  // 8 columns) pairs split between the `share` warps of the row
  const int n8 = p.nc / 8, share = nw > p.br ? nw / p.br : 1;

  issue(0);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<0>();       // step s has landed
    __syncthreads();          // ... for every thread; step s - 1 is done
    issue(s + 1);
    int b, oy0, ox0;
    item_of(s, b, oy0, ox0);
    const int k0 = (s % nch) * p.kc, kc = min(p.kc, K - k0);
    const int r_lo = rows[oy0], c_lo = cols[ox0] & ~7;
    const int nrow = min(p.br, ho - oy0), ox = ox0 + col;
    if (k0 == 0) {
#pragma unroll
      for (int i = 0; i < kTailPX; ++i) {
        const bool in = ox + i < wo;
        j0[i] = in ? row * pitch + cols[ox + i] - c_lo : 0;
        j1[i] = in ? row * pitch + cols[wo + ox + i] - c_lo : 0;
        b0[i] = in ? cw[ox + i] : 0.f;
        b1[i] = in ? cw[wo + ox + i] : 0.f;
        best[i] = -INFINITY;
        idx[i] = 0;
      }
    }
    // H pass once per (class, output row, input column):
    // t = a0 * x[r0] + a1 * x[r1], rounded to bf16 in bf16 mode
    const T* buf = reinterpret_cast<const T*>(smem + (s & 1) * staged / 4);
    for (int r = warp % p.br; r < nrow; r += nw) {
      const int gy = oy0 + r;
      const T* x0 = buf + (rows[gy] - r_lo) * p.nc;
      const T* x1 = buf + (rows[ho + gy] - r_lo) * p.nc;
      const float a0 = rw[gy], a1 = rw[ho + gy];
      // lanes over (class, 8 input columns), shared by the warps of a row
      for (int q = (warp / p.br) * 32 + lane; q < kc * n8; q += 32 * share) {
        const int kk = q / n8, j = (q - kk * n8) * 8;
        const int o = kk * p.nr * p.nc + j;
        float u[8], v[8];
        load_px<8>(x0 + o, u);
        load_px<8>(x1 + o, v);
        float* t = t_s + (kk * p.br + r) * pitch + j;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float tv = __fadd_rn(__fmul_rn(a0, u[e]), __fmul_rn(a1, v[e]));
          t[e] = BF16 ? round_to<__nv_bfloat16>(tv) : tv;
        }
      }
    }
    __syncthreads();
    // W pass and the running argmax: strict >, ties to the lower class,
    // by selects (a branch a pixel diverges on random logits); fmaxf
    // keeps best as the strict update would (a NaN v never wins)
    for (int kk = 0; kk < kc; ++kk) {
      const float* t = t_s + kk * p.br * pitch;
#pragma unroll
      for (int i = 0; i < kTailPX; ++i) {
        const float v = __fadd_rn(__fmul_rn(t[j0[i]], b0[i]),
                                  __fmul_rn(t[j1[i]], b1[i]));
        idx[i] = v > best[i] ? k0 + kk : idx[i];
        best[i] = fmaxf(best[i], v);
      }
    }
    if (k0 + kc < K || oy0 + row >= ho || ox >= wo) continue;
    uint8_t* o = out + ((size_t)b * ho + oy0 + row) * wo + ox;
    if (p.vout && ox + kTailPX <= wo) {
      *reinterpret_cast<uint2*>(o) =
          make_uint2(idx[0] | idx[1] << 8 | idx[2] << 16 | idx[3] << 24,
                     idx[4] | idx[5] << 8 | idx[6] << 16 | idx[7] << 24);
    } else {
#pragma unroll
      for (int i = 0; i < kTailPX; ++i)
        if (ox + i < wo) o[i] = (uint8_t)idx[i];
    }
  }
}

}  // namespace

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
// Design: the first version of upsample_argmax_kernel, one thread per
// output pixel looping over the classes with (best, idx) in registers.
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

// A persistent grid of `kern`: as many blocks as fit on the card at once,
// at most one an item.
template <typename Kern, typename... Args>
int launch_tail(Kern kern, const TailPlan& p, long long items,
                cudaStream_t s, Args... args) {
  const int rc = set_smem(kern, p.smem);
  if (rc) return rc;
  const int gx = resident_blocks(kern, tail_threads(p), p.smem, items, 1);
  if (gx < 1) return (int)cudaErrorInvalidValue;
  kern<<<gx, tail_threads(p), p.smem, s>>>(args...);
  return (int)cudaGetLastError();
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// rows/rw [2, ho] (H weights bf16-rounded by the caller in bf16 mode),
// cols/cw [2, wo]; plan: the 8 ints (br, sw, nr, nc, kc, smem, vin, vout)
// of tail_plan and the vector paths, rejected when they do not fit this
// source's layout.
extern "C" int segtpu_upsample_argmax(const void* logits, void* out, int B,
                                      int K, int h, int w, int ho, int wo,
                                      int in_bf16, const int* rows,
                                      const float* rw, const int* cols,
                                      const float* cw, const int* plan,
                                      void* stream) {
  if (!plan) return (int)cudaErrorInvalidValue;
  const TailPlan p{plan[0], plan[1], plan[2], plan[3],
                   plan[4], plan[5], plan[6], plan[7]};
  const int elt = in_bf16 ? 2 : 4;
  const bool ok =
      B >= 1 && p.br >= 2 && p.br % 2 == 0 && p.sw >= 16 * kTailPX &&
      p.sw % (16 * kTailPX) == 0 && tail_threads(p) <= kTailMaxThreads &&
      p.nr >= 1 && p.nc >= 8 && p.nc % 8 == 0 && p.kc >= 1 && p.kc <= K &&
      p.smem == tail_smem(p, elt) &&
      (!p.vin || (w % (16 / elt) == 0 &&
                  (reinterpret_cast<uintptr_t>(logits) & 15) == 0)) &&
      (!p.vout || (wo % 8 == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0));
  if (!ok) return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * ((ho + p.br - 1) / p.br) *
                          ((wo + p.sw - 1) / p.sw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (in_bf16)
    return launch_tail(upsample_argmax_kernel<__nv_bfloat16, true>, p, items,
                       s, static_cast<const __nv_bfloat16*>(logits), o, B, K,
                       h, w, ho, wo, rows, rw, cols, cw, p);
  return launch_tail(upsample_argmax_kernel<float, false>, p, items, s,
                     static_cast<const float*>(logits), o, B, K, h, w, ho, wo,
                     rows, rw, cols, cw, p);
}
