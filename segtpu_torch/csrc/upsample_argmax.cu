// Fused bilinear upsample + class argmax tail, CUDA C++ for sm_90a.
//
// Replaces: segtpu/kernels/upsample_argmax.py::upsample_argmax (the banded
// Pallas TPU kernel _kernel via _ua_core, 4-D channel-first form), its
// H-sharded form upsample_argmax_sharded (the same kernel and entry on a
// shard's window of rows, with the shard's row tables) and its W-first
// form upsample_argmax_flat (upsample_argmax_flat_kernel, further down).
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
// card's issue rate). A shard of the H-sharded tail at n = 4 does a
// quarter of it.
// Design (upsample_argmax_kernel): a persistent block walks items of one
// image: a band of br output rows x a segment of sw output columns (4 x
// 256 on the main path). For each chunk of kc classes (all 19 on the main
// path) it stages the input rows the band's taps name (from the first
// row's low tap, nr of them) x the input columns the segment's taps name
// (from the first column's low tap aligned down to 8, nc of them) with
// 16-byte cp.async into one of two buffers, the next step's while this
// one computes (stage_step). Then the H pass once per (class, output row,
// input column) into shared memory as f32 (bf16-rounded in bf16 mode),
// lanes over (class, 8 columns) with 16-byte reads, so the ~4 output
// columns that share an input column share its H pass. Then each thread
// takes 8 consecutive output columns of one row, its W taps in registers,
// loops over the chunk's classes with (best, idx) per pixel in registers,
// and after the last chunk writes its 8 class bytes as one 8-byte store.
// A half-warp covers 128 columns of one row, the two halves of a warp two
// rows, whose H-pass rows sit an odd number of words apart (pitch nc + 1),
// so the W pass's shared-memory reads of the two halves fall in other
// banks. The W pass and the argmax (~10 instructions a pixel and class)
// take most of the time. tail_plan (kernels/upsample_argmax.py) derives
// (br, sw, nr, nc, kc) from the tables and the C entry checks them
// against tail_smem. Widths that are not a multiple of 8 (16 bytes of
// logits, or the 8-byte store) take scalar loads and stores, cut at the
// ragged right edge. The arithmetic of every output is the per-pixel
// kernel's it replaced, so the masks keep its bits and the plain twin's.
// A shard of an H-sharded frame is this launch on its window of logit rows
// (h = the window's rows, Ho = the shard's mask rows) with row tables of
// the shard's rows, shifted to the window: the same weights and order, so
// its rows are the unsharded kernel's.

#include "pw_tile.cuh"

#include <math.h>

using namespace segtpu;

namespace {

constexpr int kTailPX = 8;              // output columns a thread, H-first
constexpr int kTailMaxThreads = 256;
constexpr int kFlatPX = 4;              // output columns a thread, W-first
constexpr int kFlatBR = 4;              // output rows of a W-first band
constexpr int kFlatMaxThreads = 256;

// The plan of a tail launch (kernels/upsample_argmax.py tail_plan and
// flat_plan): bands of br output rows x segments of sw output columns; nr
// input rows and nc input columns staged (the most any band or segment of
// the geometry names), kc classes a chunk; smem bytes; vin: 16-byte loads
// of the logits; vout: the vector mask store (8 bytes H-first, 4 W-first).
struct TailPlan {
  int br, sw, nr, nc, kc, smem, vin, vout;
};

// Floats between two H-pass rows: odd (see the design note above).
inline __host__ __device__ int tail_pitch(int nc) { return nc + 1; }

inline int tail_threads(const TailPlan& p) { return p.br * p.sw / kTailPX; }
inline int flat_threads(const TailPlan& p) { return p.sw / kFlatPX; }

// Shared bytes of a plan: two buffers of staged logits [kc][nr][nc] in T,
// then (H-first only) the H pass [kc][br][tail_pitch] in f32.
inline __host__ __device__ int tail_staged_bytes(const TailPlan& p, int elt) {
  return (p.kc * p.nr * p.nc * elt + 15) & ~15;
}
inline int tail_smem(const TailPlan& p, int elt) {
  return 2 * tail_staged_bytes(p, elt) + 4 * p.kc * p.br * tail_pitch(p.nc);
}
inline int flat_smem(const TailPlan& p, int elt) {
  return 2 * tail_staged_bytes(p, elt);
}

// The walk of a persistent block: items blockIdx.x, + gridDim.x, ...
// (item: image b, band, segment; segment fastest), each item's chunks of
// classes one step each.
struct TailWalk {
  int nseg, nband, nch, steps;
  __device__ TailWalk(const TailPlan& p, int B, int K, int ho, int wo) {
    nseg = (wo + p.sw - 1) / p.sw;
    nband = (ho + p.br - 1) / p.br;
    nch = (K + p.kc - 1) / p.kc;
    const int items = B * nband * nseg;
    const int mine = items > (int)blockIdx.x
                         ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                         : 0;
    steps = mine * nch;
  }
  // step s's image, first output row and column, first class
  __device__ void at(int s, const TailPlan& p, int& b, int& oy0, int& ox0,
                     int& k0) const {
    const int item = blockIdx.x + (s / nch) * gridDim.x;
    const int rest = item / nseg;
    ox0 = (item - rest * nseg) * p.sw;
    oy0 = (rest % nband) * p.br;
    b = rest / nband;
    k0 = (s % nch) * p.kc;
  }
};

// Starts staging step s's classes into buffer s & 1 (buffers of `staged`
// bytes from smem): rows from the band's first low tap, columns from the
// segment's first low tap aligned down to 8, zero outside the image;
// commits a group whether or not there is a step s.
template <typename T>
__device__ __forceinline__ void stage_step(
    const TailWalk& walk, const TailPlan& p, int s, float* smem, int staged,
    const T* x, int K, int h, int w, const int* rows, const int* cols) {
  if (s < walk.steps) {
    constexpr int E = 16 / sizeof(T);
    int b, oy0, ox0, k0;
    walk.at(s, p, b, oy0, ox0, k0);
    const int kc = min(p.kc, K - k0);
    const int r_lo = rows[oy0], c_lo = cols[ox0] & ~7;
    const T* xb = x + ((size_t)b * K + k0) * h * w;
    T* buf = reinterpret_cast<T*>(smem + (s & 1) * staged / 4);
    const int nchunk = p.nc / E;               // 16-byte chunks a row
    for (int q = threadIdx.x; q < kc * p.nr * nchunk; q += blockDim.x) {
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
}

// step s + 1's logits are staged into the other buffer while step s
// computes.
template <typename T, bool BF16>
__global__ void __launch_bounds__(kTailMaxThreads, 2)
    upsample_argmax_kernel(const T* __restrict__ x, uint8_t* __restrict__ out,
                           int B, int K, int h, int w, int ho, int wo,
                           const int* __restrict__ rows,
                           const float* __restrict__ rw,
                           const int* __restrict__ cols,
                           const float* __restrict__ cw, TailPlan p) {
  extern __shared__ __align__(16) float smem[];
  const int staged = tail_staged_bytes(p, sizeof(T));
  float* t_s = smem + 2 * staged / 4;                 // [kc][br][pitch]
  const int pitch = tail_pitch(p.nc);
  const int nw = blockDim.x / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const TailWalk walk(p, B, K, ho, wo);
  // tables: rows/rw are [2, ho] (low tap, high tap); cols/cw are [2, wo]

  // this thread's W pass: row `row` of the band, 8 columns from ox0 + col
  const int half = threadIdx.x / 16, row = half % p.br;
  const int col = (half / p.br) * 16 * kTailPX + (threadIdx.x % 16) * kTailPX;
  int j0[kTailPX], j1[kTailPX];
  float b0[kTailPX], b1[kTailPX], best[kTailPX];
  uint32_t idx[kTailPX];
  // H-pass work of this warp: rows warp % br, + nw, ...; a row's (class,
  // 8 columns) pairs split between the `share` warps of the row
  const int n8 = p.nc / 8, share = nw > p.br ? nw / p.br : 1;

  stage_step(walk, p, 0, smem, staged, x, K, h, w, rows, cols);
  for (int s = 0; s < walk.steps; ++s) {
    cp_async_wait<0>();       // step s has landed
    __syncthreads();          // ... for every thread; step s - 1 is done
    stage_step(walk, p, s + 1, smem, staged, x, K, h, w, rows, cols);
    int b, oy0, ox0, k0;
    walk.at(s, p, b, oy0, ox0, k0);
    const int kc = min(p.kc, K - k0);
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

// The W pass of one staged input row xr at a thread's kFlatPX output
// columns: z = b0 * x[c0] + b1 * x[c1] (bf16 products are exact, so in
// bf16 mode only the sum rounds).
template <typename T>
__device__ __forceinline__ void flat_w_pass(const T* xr,
                                            const int (&j0)[kFlatPX],
                                            const int (&j1)[kFlatPX],
                                            const float (&b0)[kFlatPX],
                                            const float (&b1)[kFlatPX],
                                            float (&z)[kFlatPX]) {
#pragma unroll
  for (int c = 0; c < kFlatPX; ++c)
    z[c] = __fadd_rn(__fmul_rn(b0[c], to_f32(xr[j0[c]])),
                     __fmul_rn(b1[c], to_f32(xr[j1[c]])));
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
// Bound on the H100 at G2's 8 x 19 x 128 x 128 bf16 -> 8 x 512 x 512: 5 MB
// in and 2 MB out (~2.1 us at 3.35 TB/s) against ~0.15 GFLOP of f32
// interpolation (~2.2 us at 67 TFLOP/s): operations; the H pass and the
// argmax, ~6 instructions a pixel and class, are ~0.24 G lane
// instructions (~8 us at the card's issue rate).
// Design: upsample_argmax_kernel's walk and staging (a persistent block,
// items of a band of kFlatBR output rows x a segment of sw output columns,
// each chunk of kc classes staged by cp.async into one of two buffers while
// the other computes), with the passes in the other order and no shared
// H-pass buffer: a thread takes kFlatPX consecutive output columns over all
// kFlatBR rows of the band, its W taps, the band's H taps and (best, idx)
// of its kFlatBR x kFlatPX pixels in registers. For each class it walks the
// band's rows keeping the W pass of two staged input rows in registers (za
// of row ra, zb of row rb): a row's low tap that is not ra is rb (moved
// over) or new (its W pass computed), and so for the high tap and rb. The
// band's taps are monotone, so each staged row's W pass is computed once a
// class (0.75 an output row at x4, where a W pass a tap would be two), the
// tests of ra and rb are the same for every thread (no divergence), and no
// barrier separates the passes. The vector store writes a row's 4 class
// bytes at once. Bands of 4 rows were faster than of 8 at G2's shape (more
// blocks an SM; stem_tail_probe.py --tiles).
template <typename T>
__global__ void __launch_bounds__(kFlatMaxThreads)
    upsample_argmax_flat_kernel(const T* __restrict__ x,
                                uint8_t* __restrict__ out, int B, int K, int h,
                                int w, int ho, int wo,
                                const int* __restrict__ rows,
                                const float* __restrict__ rw,
                                const int* __restrict__ cols,
                                const float* __restrict__ cw, TailPlan p) {
  extern __shared__ __align__(16) float smem[];
  const int staged = tail_staged_bytes(p, sizeof(T));
  const TailWalk walk(p, B, K, ho, wo);
  const int col = threadIdx.x * kFlatPX;
  int j0[kFlatPX], j1[kFlatPX], i0[kFlatBR], i1[kFlatBR];
  float b0[kFlatPX], b1[kFlatPX], a0[kFlatBR], a1[kFlatBR];
  float best[kFlatBR][kFlatPX];
  uint32_t idx[kFlatBR][kFlatPX];

  stage_step(walk, p, 0, smem, staged, x, K, h, w, rows, cols);
  for (int s = 0; s < walk.steps; ++s) {
    cp_async_wait<0>();       // step s has landed
    __syncthreads();          // ... for every thread; step s - 1 is done
    stage_step(walk, p, s + 1, smem, staged, x, K, h, w, rows, cols);
    int b, oy0, ox0, k0;
    walk.at(s, p, b, oy0, ox0, k0);
    const int kc = min(p.kc, K - k0);
    const int nrow = min(kFlatBR, ho - oy0), ox = ox0 + col;
    if (k0 == 0) {
      const int r_lo = rows[oy0], c_lo = cols[ox0] & ~7;
#pragma unroll
      for (int c = 0; c < kFlatPX; ++c) {
        const bool in = ox + c < wo;
        j0[c] = in ? cols[ox + c] - c_lo : 0;
        j1[c] = in ? cols[wo + ox + c] - c_lo : 0;
        b0[c] = in ? cw[ox + c] : 0.f;
        b1[c] = in ? cw[wo + ox + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kFlatBR; ++r) {
        const bool in = r < nrow;
        i0[r] = in ? (rows[oy0 + r] - r_lo) * p.nc : 0;
        i1[r] = in ? (rows[ho + oy0 + r] - r_lo) * p.nc : 0;
        a0[r] = in ? rw[oy0 + r] : 0.f;
        a1[r] = in ? rw[ho + oy0 + r] : 0.f;
#pragma unroll
        for (int c = 0; c < kFlatPX; ++c) {
          best[r][c] = -INFINITY;
          idx[r][c] = 0;
        }
      }
    }
    const T* buf = reinterpret_cast<const T*>(smem + (s & 1) * staged / 4);
    for (int kk = 0; kk < kc; ++kk) {
      const T* xk = buf + kk * p.nr * p.nc;
      const uint32_t k = k0 + kk;
      int ra = -1, rb = -1;          // staged rows (times nc) in za, zb
      float za[kFlatPX], zb[kFlatPX];
#pragma unroll
      for (int r = 0; r < kFlatBR; ++r) {
        if (r >= nrow) break;
        if (i0[r] != ra) {
          if (i0[r] == rb) {
#pragma unroll
            for (int c = 0; c < kFlatPX; ++c) za[c] = zb[c];
          } else {
            flat_w_pass(xk + i0[r], j0, j1, b0, b1, za);
          }
          ra = i0[r];
        }
        if (i1[r] != rb) {
          if (i1[r] == ra) {
#pragma unroll
            for (int c = 0; c < kFlatPX; ++c) zb[c] = za[c];
          } else {
            flat_w_pass(xk + i1[r], j0, j1, b0, b1, zb);
          }
          rb = i1[r];
        }
        // H pass and the running argmax, as upsample_argmax_kernel's
#pragma unroll
        for (int c = 0; c < kFlatPX; ++c) {
          const float v = __fadd_rn(__fmul_rn(a0[r], za[c]),
                                    __fmul_rn(a1[r], zb[c]));
          idx[r][c] = v > best[r][c] ? k : idx[r][c];
          best[r][c] = fmaxf(best[r][c], v);
        }
      }
    }
    if (k0 + kc < K || ox >= wo) continue;
#pragma unroll
    for (int r = 0; r < kFlatBR; ++r) {
      if (r >= nrow) break;
      uint8_t* o = out + ((size_t)b * ho + oy0 + r) * wo + ox;
      if (p.vout && ox + kFlatPX <= wo) {
        *reinterpret_cast<uint32_t*>(o) = idx[r][0] | idx[r][1] << 8 |
                                          idx[r][2] << 16 | idx[r][3] << 24;
      } else {
#pragma unroll
        for (int c = 0; c < kFlatPX; ++c)
          if (ox + c < wo) o[c] = (uint8_t)idx[r][c];
      }
    }
  }
}

}  // namespace

// A persistent grid of `kern`: as many blocks of `threads` as fit on the
// card at once, at most one an item.
template <typename Kern, typename... Args>
int launch_tail(Kern kern, const TailPlan& p, int threads, long long items,
                cudaStream_t s, Args... args) {
  const int rc = set_smem(kern, p.smem);
  if (rc) return rc;
  const int gx = resident_blocks(kern, threads, p.smem, items, 1);
  if (gx < 1) return (int)cudaErrorInvalidValue;
  kern<<<gx, threads, p.smem, s>>>(args...);
  return (int)cudaGetLastError();
}

// The checks both entries make of a plan's shared fields and vector paths;
// `store`: the bytes of the vector mask store.
static bool plan_fits(const TailPlan& p, int B, int K, int w, int wo,
                      int elt, int store, const void* logits,
                      const void* out) {
  return B >= 1 && p.nr >= 1 && p.nc >= 8 && p.nc % 8 == 0 && p.kc >= 1 &&
         p.kc <= K &&
         (!p.vin || (w % (16 / elt) == 0 &&
                     (reinterpret_cast<uintptr_t>(logits) & 15) == 0)) &&
         (!p.vout || (wo % store == 0 &&
                      (reinterpret_cast<uintptr_t>(out) & (store - 1)) == 0));
}

static long long tail_items(const TailPlan& p, int B, int ho, int wo) {
  return (long long)B * ((ho + p.br - 1) / p.br) * ((wo + p.sw - 1) / p.sw);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// rows/rw [2, ho] (H weights bf16-rounded by the caller in bf16 mode),
// cols/cw [2, wo]; plan: the 8 ints (br, sw, nr, nc, kc, smem, vin, vout)
// of tail_plan and the vector paths, rejected when they do not fit this
// source's layout. A shard of an H-sharded frame passes its window of
// logit rows as h and its mask rows as ho, with its rows' tables.
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
      plan_fits(p, B, K, w, wo, elt, 8, logits, out) && p.br >= 2 &&
      p.br % 2 == 0 && p.sw >= 16 * kTailPX && p.sw % (16 * kTailPX) == 0 &&
      tail_threads(p) <= kTailMaxThreads && p.smem == tail_smem(p, elt);
  if (!ok) return (int)cudaErrorInvalidValue;
  const long long items = tail_items(p, B, ho, wo);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (in_bf16)
    return launch_tail(upsample_argmax_kernel<__nv_bfloat16, true>, p,
                       tail_threads(p), items, s,
                       static_cast<const __nv_bfloat16*>(logits), o, B, K,
                       h, w, ho, wo, rows, rw, cols, cw, p);
  return launch_tail(upsample_argmax_kernel<float, false>, p, tail_threads(p),
                     items, s, static_cast<const float*>(logits), o, B, K, h,
                     w, ho, wo, rows, rw, cols, cw, p);
}

// Launches the W-first kernel; arguments as segtpu_upsample_argmax, with the
// W weights (cw) bf16-rounded by the caller in bf16 mode and the plan of
// flat_plan (br kFlatBR; sw a multiple of 128, at most 1024; smem
// flat_smem; vout: 4-byte mask stores).
extern "C" int segtpu_upsample_argmax_flat(
    const void* logits, void* out, int B, int K, int h, int w, int ho, int wo,
    int in_bf16, const int* rows, const float* rw, const int* cols,
    const float* cw, const int* plan, void* stream) {
  if (!plan) return (int)cudaErrorInvalidValue;
  const TailPlan p{plan[0], plan[1], plan[2], plan[3],
                   plan[4], plan[5], plan[6], plan[7]};
  const int elt = in_bf16 ? 2 : 4;
  const bool ok = plan_fits(p, B, K, w, wo, elt, kFlatPX, logits, out) &&
                  p.br == kFlatBR &&
                  p.sw % (32 * kFlatPX) == 0 && p.sw >= 32 * kFlatPX &&
                  flat_threads(p) <= kFlatMaxThreads &&
                  p.smem == flat_smem(p, elt);
  if (!ok) return (int)cudaErrorInvalidValue;
  const long long items = tail_items(p, B, ho, wo);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (in_bf16)
    return launch_tail(upsample_argmax_flat_kernel<__nv_bfloat16>, p,
                       flat_threads(p), items, s,
                       static_cast<const __nv_bfloat16*>(logits), o, B, K, h,
                       w, ho, wo, rows, rw, cols, cw, p);
  return launch_tail(upsample_argmax_flat_kernel<float>, p, flat_threads(p),
                     items, s, static_cast<const float*>(logits), o, B, K, h,
                     w, ho, wo, rows, rw, cols, cw, p);
}
