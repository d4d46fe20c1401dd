// Bilinear upsample of a channel-first tensor with a fused add or 1x1
// chain, CUDA C++ for sm_90a.
//
// Replaces: segtpu/kernels/resize_chw.py::resize_chw_pallas (the Pallas TPU
// kernel _kernel: banded H interpolation on row views, W interpolation as an
// MXU product, optional acc and acc_stages).
//
// Function: x [B, C, h, w] (bf16 or f32) -> out [B, C, OH, OW] in x's dtype,
//   out = bilinear(x, (OH, OW)) (+ add) (+ chain(raw))
// computed in f32 and rounded once. The 2-tap tables (r0, r1, a0, a1 per
// output row; c0, c1, b0, b1 per output column) hold _interp_matrix's float32
// entries (a merged single entry has a1 = 0), and the order is the TPU
// kernel's: the H pass first at the two input columns the output reads,
//   t(c) = a0 * x[r0, c] + a1 * x[r1, c],
// then the W pass v = b0 * t(c0) + b1 * t(c1), every product and sum rounded
// once. `add` [B, C, OH, OW] in x's dtype is added in f32. `chain` is the
// aggregate cell's identity branch deferred into this kernel: a raw tap
// [B, C0, OH, OW] through a chain of 1x1 stages (the pw_chain_chw
// function: each stage act(sum_c w[o, c] * in[c] + b[o]) over c ascending
// from zero, every stage rounded to the dtype), then added in f32. The
// plain twin (kernels/resize_chw.py) computes the same bits.
//
// Bound on the H100. The arch0 1024 x 2048 b8 decoder makes three calls,
// each with a chain (adapt to 48 channels, then the 48 -> 48 aggregate):
// 32 x 64 -> 64 x 128 (raw 96 channels), 64 x 128 -> 128 x 256 (raw 32),
// 128 x 256 -> 256 x 512 (raw 24). Together they move 245 MB (0.073 ms at
// 3.35 TB/s) and do 5.1 G multiply-adds in the chains (0.17 ms at the
// 59.5 TFLOP/s f32 FMA rate measured on the card; the last call alone 3.6 G,
// 0.12 ms): the chains' multiply-adds bound them, on the CUDA cores, where
// the twins' sum order keeps their bits.
// Design: a tile is up to 256 output pixels of one image, R whole rows or
// a segment of S columns of one row (a contiguous run of the flat output),
// for a chunk of CB channels (all of them on the path). A block of 8 warps
// is persistent: it stages the f32 weights of every chain stage once, then
// walks tiles blockIdx.x, + gridDim.x, ... of all images:
// 1. the H pass: t for every row of the tile, every channel and the ncol
//    input columns the tile's W taps read, once, into f32 shared memory
//    [R][CB][ncol] (input rows through the row tables alone, so a shard's
//    row window with its band of the tables is the whole call; 16-byte loads
//    when w % 8 == 0, two items a thread in flight);
// 2. the chain: the raw tap's pixels in chunks of KC channels, a ring of
//    three buffers filled by 16-byte cp.async two steps ahead across tiles;
//    each stage a register-tiled 1x1 (pw_tile.cuh: 4 channel groups of 64
//    threads, 12 channels x 4 pixels a thread), its rounded output in
//    shared memory [cout][256] for the next stage;
// 3. per pass of 48 channels: the last stage in registers, the W pass for
//    the same 12 channels x 4 pixels, + add or + the chain, one rounding,
//    stores (and add's loads) 4 pixels wide when OW % 8 == 0.
// The 256 x 512 call runs at about 3.5 times its f32 FMA floor (PERF.md):
// the phases between the multiply-adds (the H pass's global loads, the
// stage and W-pass epilogues, the barriers between them) are not hidden
// by the two blocks an SM that 128 registers a thread allow, at which the
// kernel already spills.
// resize_plan (kernels/resize_chw.py) picks (R, S, ncol, CB, KC) and the C
// entry checks its shared bytes against layout(). Scalar loads and stores
// take any other width.

#include "pw_tile.cuh"

using namespace segtpu;

namespace {

constexpr int kThreads = 256;
constexpr int kNG = 4, kCO = 12, kPX = 4;     // channel groups, a thread's tile
constexpr int kTPX = kThreads / kNG;          // pixel threads of a group
constexpr int kPass = kNG * kCO;              // channels of one pass
constexpr int kTile = kTPX * kPX;             // pixels of a tile
constexpr int kStages = 3;                    // raw chunk buffers
constexpr int kBatch = 2;                     // H-pass items a thread loads at once

struct ResizeArgs {
  const void* x;
  void* out;
  int B, C, h, w, OH, OW;
  const int* rows;     // [2, OH]
  const float* rw;     // [2, OH]
  const int* cols;     // [2, OW]
  const float* cw;     // [2, OW]
  const void* add;     // optional [B, C, OH, OW]
  int R, S, ncol, CB, KC, vec;   // the plan
};

struct Chain {
  const void* raw;     // [B, raw_c, OH, OW], or null
  int raw_c, nst;
  const void* w[kMaxStage];    // [cout, cin] in T
  const float* b[kMaxStage];   // [cout] f32
  int cin[kMaxStage], cout[kMaxStage], act[kMaxStage];
};

// Byte offsets in shared memory: each stage's f32 weights [cin][cpad] (the
// last stage's for the block's CB channels), the H pass [R][CB][ncol] f32,
// one or two stage outputs [cmax][kTile] in T, kStages raw chunks
// [KC][kTile].
struct Layout {
  int w[kMaxStage], cpad[kMaxStage];
  int h, mid[2], raw, total;
};

__host__ __device__ inline int r_pass(int v) {
  return (v + kPass - 1) / kPass * kPass;
}

inline Layout layout(const ResizeArgs& a, const Chain& ch, int elt) {
  Layout L{};
  int off = 0, cmax = 0;
  for (int s = 0; s < ch.nst; ++s) {
    L.cpad[s] = r_pass(s == ch.nst - 1 ? a.CB : ch.cout[s]);
    L.w[s] = off;
    off += 4 * ch.cin[s] * L.cpad[s];
    if (s < ch.nst - 1 && ch.cout[s] > cmax) cmax = ch.cout[s];
  }
  L.h = off;
  off += (4 * a.R * a.CB * a.ncol + 15) & ~15;
  const int nmid = ch.nst >= 3 ? 2 : ch.nst - 1;
  L.mid[0] = off;
  off += nmid >= 1 ? elt * cmax * kTile : 0;
  L.mid[1] = off;
  off += nmid >= 2 ? elt * cmax * kTile : 0;
  L.raw = off;
  off += ch.nst ? kStages * a.KC * kTile * elt : 0;
  L.total = off;
  return L;
}

// One tile: image b, R whole rows from oy0 (S == OW) or S columns of row
// oy0 from ox0; its n pixels are the flat run [p0, p0 + n) of the image.
struct Tile {
  int b, oy0, ox0, nrows, n;
  long long p0;
};

struct Geo {
  int R, S, OH, OW;
};

__device__ __forceinline__ Tile tile_of(Geo a, int tiles, int item) {
  Tile t;
  t.b = item / tiles;
  const int i = item - t.b * tiles;
  if (a.S == a.OW) {
    t.oy0 = i * a.R;
    t.ox0 = 0;
    t.nrows = min(a.R, a.OH - t.oy0);
    t.n = t.nrows * a.OW;
  } else {
    const int segs = (a.OW + a.S - 1) / a.S;
    t.oy0 = i / segs;
    t.ox0 = (i - t.oy0 * segs) * a.S;
    t.nrows = 1;
    t.n = min(a.S, a.OW - t.ox0);
  }
  t.p0 = (long long)t.oy0 * a.OW + t.ox0;
  return t;
}

// The raw tap's chunks, a ring of kStages buffers over the block's steps:
// step s is chunk s % nch of pass (s / nch) % passes of the block's tile
// s / (nch * passes). It never drains between tiles, so a tile's first
// chunks fly during the previous tile's later stages.
template <typename T>
struct RawRing {
  const T* raw;
  T* buf;
  int raw_c, KC, tiles, nch, per_tile, steps;
  Geo geo;
  long long ohw;
  bool vec;

  __device__ __forceinline__ void issue(int s) const {
    if (s < steps) {
      const int item = blockIdx.x + (s / per_tile) * gridDim.x;
      const int k = s % nch;
      const Tile t = tile_of(geo, tiles, item);
      stage_px<T>(buf + (s % kStages) * KC * kTile, kTile,
                  raw + ((size_t)t.b * raw_c + k * KC) * ohw, ohw, t.p0, t.n,
                  min(KC, raw_c - k * KC), vec, kThreads);
    }
    cp_async_commit();
  }

  // acc = the raw tap's product with stage 0's weights w_s [raw_c][cpad]
  // at the thread's channels (w_s offset to them): the next nch steps from
  // s. All threads take part; each step's barrier also orders the
  // block's shared-memory work before it.
  __device__ __forceinline__ void product(float (&acc)[kCO][kPX], int& s,
                                          const float* w_s, int cpad,
                                          bool busy, int pix) const {
    zero(acc);
    for (int k = 0; k < nch; ++k, ++s) {
      cp_async_wait<kStages - 2>();    // step s has landed
      __syncthreads();                 // ... for every thread; s - 1 is read
      issue(s + kStages - 1);
      if (busy)
        tile_fma<T, kCO, kPX>(acc, buf + (s % kStages) * KC * kTile + pix,
                              kTile, w_s + k * KC * cpad, cpad,
                              min(KC, raw_c - k * KC));
    }
  }
};

// The H pass of a tile: hb[r][c][j] = t at input column lo + j of tile row
// r for the block's channels, kBatch items a thread loaded at once.
template <typename T>
__device__ __forceinline__ void h_pass(const ResizeArgs& a, const Tile& t,
                                       int cb0, int cbn, int lo, float* hb,
                                       bool vec) {
  constexpr int V = 8;
  const size_t plane = (size_t)a.h * a.w;
  const T* x = static_cast<const T*>(a.x) + ((size_t)t.b * a.C + cb0) * plane;
  const int step = vec ? V : 1, nj = a.ncol / step;
  const int total = t.nrows * cbn * nj;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kThreads) {
    float u[kBatch][V], v[kBatch][V], a0[kBatch], a1[kBatch];
    int dst[kBatch];
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      const int i = i0 + m * kThreads;
      const int j = i % nj, rc = i / nj, c = rc % cbn, r = rc / cbn;
      const int col = lo + j * step;
      dst[m] = -1;
      if (i < total && col < a.w) {
        const int oy = t.oy0 + r;
        const int r0 = a.rows[oy], r1 = a.rows[a.OH + oy];
        a0[m] = a.rw[oy];
        a1[m] = a.rw[a.OH + oy];
        const T* x0 = x + c * plane + (size_t)r0 * a.w + col;
        const T* x1 = x + c * plane + (size_t)r1 * a.w + col;
        if (vec) {        // w % 8 == 0: the 8 columns are all in
          load_px<V>(x0, u[m]);
          load_px<V>(x1, v[m]);
        } else {
          u[m][0] = to_f32(x0[0]);
          v[m][0] = to_f32(x1[0]);
        }
        dst[m] = (r * a.CB + c) * a.ncol + j * step;
      }
    }
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      if (dst[m] < 0) continue;
      float* d = hb + dst[m];
      if (vec) {
#pragma unroll
        for (int q = 0; q < V; ++q)
          u[m][q] = __fadd_rn(__fmul_rn(a0[m], u[m][q]),
                              __fmul_rn(a1[m], v[m][q]));
        reinterpret_cast<float4*>(d)[0] =
            make_float4(u[m][0], u[m][1], u[m][2], u[m][3]);
        reinterpret_cast<float4*>(d)[1] =
            make_float4(u[m][4], u[m][5], u[m][6], u[m][7]);
      } else {
        d[0] = __fadd_rn(__fmul_rn(a0[m], u[m][0]), __fmul_rn(a1[m], v[m][0]));
      }
    }
  }
}

// A persistent block: the weights of every stage staged once, then the
// tiles blockIdx.x, + gridDim.x, ... of all images, each through 1. the H
// pass, 2. the chain's stages but the last, 3. per pass of 48 channels the
// last stage, the W pass, the adds and the stores.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    resize_kernel(ResizeArgs a, Chain ch, Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = threadIdx.x / kTPX, pix = (threadIdx.x - g * kTPX) * kPX;
  const int cb0 = blockIdx.y * a.CB, cbn = min(a.CB, a.C - cb0);
  const bool vec = a.vec != 0;
  const long long ohw = (long long)a.OH * a.OW;
  const int tiles = a.S == a.OW ? (a.OH + a.R - 1) / a.R
                                : a.OH * ((a.OW + a.S - 1) / a.S);
  const int items = a.B * tiles;
  const int mine = items > (int)blockIdx.x
                       ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int ls = ch.nst - 1;
  // the stage that reads the raw tap runs this many passes a tile
  const int raw_passes = ch.nst > 1 ? L.cpad[0] / kPass
                                    : (cbn + kPass - 1) / kPass;
  const int nch = ch.nst ? (ch.raw_c + a.KC - 1) / a.KC : 0;
  const Geo geo{a.R, a.S, a.OH, a.OW};
  const RawRing<T> ring{static_cast<const T*>(ch.raw),
                        reinterpret_cast<T*>(smem + L.raw),
                        ch.raw_c,
                        a.KC,
                        tiles,
                        nch,
                        nch * raw_passes,
                        ch.nst ? mine * nch * raw_passes : 0,
                        geo,
                        ohw,
                        vec};
  for (int s = 0; s < kStages - 1; ++s)
    if (ch.nst) ring.issue(s);
  for (int s = 0; s < ch.nst; ++s) {
    const bool last = s == ls;
    stage_weights<T>(reinterpret_cast<float*>(smem + L.w[s]), L.cpad[s],
                     static_cast<const T*>(ch.w[s]), ch.cin[s],
                     last ? cb0 : 0, last ? cb0 + cbn : ch.cout[s], kThreads);
  }
  float* hb = reinterpret_cast<float*>(smem + L.h);
  const T* add = static_cast<const T*>(a.add);
  T* out = static_cast<T*>(a.out);
  const T* last_in =
      ls > 0 ? reinterpret_cast<const T*>(smem + L.mid[(ls + 1) & 1]) : nullptr;
  float acc[kCO][kPX];
  int step = 0;

  for (int it = 0; it < mine; ++it) {
    const Tile t = tile_of(geo, tiles, blockIdx.x + it * gridDim.x);
    const int lo = a.cols[t.ox0] & ~7;
    __syncthreads();    // the previous tile's reads of hb are done
    // 1. the H pass
    h_pass<T>(a, t, cb0, cbn, lo, hb, vec);

    // 2. the chain's stages but the last, each output rounded to T
    for (int s = 0; s < ls; ++s) {
      const float* ws = reinterpret_cast<const float*>(smem + L.w[s]);
      T* dst = reinterpret_cast<T*>(smem + L.mid[s & 1]);
      const T* src = reinterpret_cast<const T*>(smem + L.mid[(s + 1) & 1]);
      for (int q = 0; q < L.cpad[s]; q += kPass) {
        const int co = q + g * kCO;
        const bool busy = co < ch.cout[s];
        if (s == 0) {
          ring.product(acc, step, ws + co, L.cpad[s], busy, pix);
        } else {
          zero(acc);
          if (busy)
            tile_fma<T, kCO, kPX>(acc, src + pix, kTile, ws + co, L.cpad[s],
                                  ch.cin[s]);
        }
#pragma unroll
        for (int j = 0; j < kCO; ++j) {
          if (co + j < ch.cout[s]) {
            const float bias = ch.b[s][co + j];
            float y[kPX];
#pragma unroll
            for (int k = 0; k < kPX; ++k)
              y[k] = activate(acc[j][k] + bias, ch.act[s]);
            store_px<kPX>(dst + (co + j) * kTile + pix, y);
          }
        }
      }
      __syncthreads();
    }
    __syncthreads();    // the H pass, when no stage ran

    // 3. per pass: the last stage, the W pass, the adds, the stores
    for (int q = 0; q < cbn; q += kPass) {
      const int cl = q + g * kCO;
      const bool busy = cl < cbn;
      if (ch.nst) {
        const float* ws = reinterpret_cast<const float*>(smem + L.w[ls]) + cl;
        if (ls == 0) {
          ring.product(acc, step, ws, L.cpad[ls], busy, pix);
        } else {
          zero(acc);
          if (busy)
            tile_fma<T, kCO, kPX>(acc, last_in + pix, kTile, ws, L.cpad[ls],
                                  ch.cin[ls]);
        }
      }
      if (!busy || pix >= t.n) continue;
      // the W taps of the thread's pixels: tile row, columns from lo
      int hr[kPX], hc0[kPX], hc1[kPX];
      float b0[kPX], b1[kPX];
#pragma unroll
      for (int k = 0; k < kPX; ++k) {
        const int f = min(pix + k, t.n - 1), r = f / a.S;
        const int ox = t.ox0 + f - r * a.S;
        hr[k] = r;
        hc0[k] = a.cols[ox] - lo;
        hc1[k] = a.cols[a.OW + ox] - lo;
        b0[k] = a.cw[ox];
        b1[k] = a.cw[a.OW + ox];
      }
#pragma unroll
      for (int j = 0; j < kCO; ++j) {
        const int c = cl + j;
        if (c < cbn) {
          float v[kPX];
#pragma unroll
          for (int k = 0; k < kPX; ++k) {
            const float* hrow = hb + (hr[k] * a.CB + c) * a.ncol;
            v[k] = __fadd_rn(__fmul_rn(b0[k], hrow[hc0[k]]),
                             __fmul_rn(b1[k], hrow[hc1[k]]));
          }
          const size_t o = ((size_t)t.b * a.C + cb0 + c) * ohw + t.p0 + pix;
          float av[kPX];
          if (add && vec) load_px<kPX>(add + o, av);
          const float bias = ch.nst ? ch.b[ls][cb0 + c] : 0.f;
#pragma unroll
          for (int k = 0; k < kPX; ++k) {
            if (add)
              v[k] = __fadd_rn(v[k], vec ? av[k]
                                         : (pix + k < t.n ? to_f32(add[o + k])
                                                          : 0.f));
            if (ch.nst)
              v[k] = __fadd_rn(v[k], round_to<T>(activate(acc[j][k] + bias,
                                                           ch.act[ls])));
          }
          if (vec) {            // OW % 8 == 0: the 4 pixels are all in
            store_px<kPX>(out + o, v);
          } else {
#pragma unroll
            for (int k = 0; k < kPX; ++k)
              if (pix + k < t.n) out[o + k] = from_f32<T>(v[k]);
          }
        }
      }
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int run(const ResizeArgs& a, const Chain& ch, int smem,
        cudaStream_t s) {
  const int elt = (int)sizeof(T);
  const Layout L = layout(a, ch, elt);
  const long long ohw = (long long)a.OH * a.OW;
  // the plan must be one this source has a layout for
  const bool ok =
      a.S == min(a.OW, kTile) && a.R >= 1 && a.R * a.S <= kTile &&
      (a.R == 1 || a.S == a.OW) && a.ncol >= 8 && a.ncol % 8 == 0 &&
      a.CB >= 1 && a.CB <= a.C && (!ch.nst || (a.KC >= 1 && a.KC <= ch.raw_c)) &&
      smem == L.total &&
      (!a.vec || (a.OW % 8 == 0 && a.w % 8 == 0 && ohw % 8 == 0 &&
                  aligned16(a.x) && aligned16(a.out) &&
                  (!a.add || aligned16(a.add)) &&
                  (!ch.raw || aligned16(ch.raw))));
  if (!ok) return (int)cudaErrorInvalidValue;
  const int rc = set_smem(resize_kernel<T>, smem);
  if (rc) return rc;
  const long long tiles =
      a.S == a.OW ? (a.OH + a.R - 1) / a.R
                  : (long long)a.OH * ((a.OW + a.S - 1) / a.S);
  const int gy = (a.C + a.CB - 1) / a.CB;
  const int gx = resident_blocks(resize_kernel<T>, kThreads, smem,
                                 a.B * tiles, gy);
  if (gx < 1 || a.B * tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  resize_kernel<T><<<dim3(gx, gy), kThreads, smem, s>>>(a, ch, L);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// add may be null. nst = 0 means no chain; otherwise raw [B, raw_c, OH, OW]
// goes through nst 1x1 stages (w [cout, cin] in x's dtype, b f32, act codes
// 0 none, 1 relu, 2 relu6) whose last output has C channels. plan: the 7
// ints (R, S, ncol, CB, KC, smem, vec) of resize_plan and the vector path.
extern "C" int segtpu_resize(const void* x, void* out, int B, int C, int h,
                             int w, int OH, int OW, const int* rows,
                             const float* rw, const int* cols, const float* cw,
                             const void* add, const void* raw, int raw_c,
                             const void* const* sw, const float* const* sb,
                             const int* scin, const int* scout,
                             const int* sact, int nst, int bf16,
                             const int* plan, void* stream) {
  if (nst < 0 || nst > kMaxStage || (nst > 0 && scout[nst - 1] != C) ||
      (nst > 0 && scin[0] != raw_c))
    return (int)cudaErrorInvalidValue;
  for (int i = 1; i < nst; ++i)
    if (scin[i] != scout[i - 1]) return (int)cudaErrorInvalidValue;
  ResizeArgs a{x,       out,     B,       C,       h,       w,
               OH,      OW,      rows,    rw,      cols,    cw,
               add,     plan[0], plan[1], plan[2], plan[3], plan[4],
               plan[6]};
  Chain ch{};
  ch.raw = nst ? raw : nullptr;
  ch.raw_c = nst ? raw_c : 0;
  ch.nst = nst;
  for (int i = 0; i < nst; ++i) {
    ch.w[i] = sw[i];
    ch.b[i] = sb[i];
    ch.cin[i] = scin[i];
    ch.cout[i] = scout[i];
    ch.act[i] = sact[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(a, ch, plan[5], s)
              : run<float>(a, ch, plan[5], s);
}
