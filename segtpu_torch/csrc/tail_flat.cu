// Classifier-fused upsample + argmax tail, CUDA C++ for sm_90a.
//
// Replaces: scripts/exp_tail_flat.py::_kernel (build_flat_tail), the
// experiment's tail that applies the 1x1 classifier itself instead of
// reading logits that a separate classifier kernel wrote.
//
// Function: feat bf16 [B, C, h, w] (w a multiple of 8), classifier wclf
// bf16 [K, C] and bias bclf f32 [K] -> uint8 mask [B, Ho, Wo], rounding
// where the TPU kernel rounds:
//   logits_k = bf16(sum_c wclf[k, c] * feat[c] + bclf[k]), the sum in f32
//              from zero in channel order (each product is exact in f32);
//   H pass:    t = bf16(a0 * L[r0, x] + a1 * L[r1, x]) with the H weights
//              rounded to bf16;
//   W pass:    v = b0 * t[y, c0] + b1 * t[y, c1] in f32 with the W weights
//              rounded to bf16 (the production tail keeps them in f32);
//   argmax:    strict > from -inf, so ties go to the lower class.
// Every product of the H and W passes is of two bf16 values, so exact in
// f32, and each pass rounds once: the plain PyTorch version gives the same
// bits. The 2-tap tables are _interp_matrix's entries (r0 <= r1,
// nondecreasing along the output), cropped to Ho x Wo; a merged single
// entry has r0 == r1 and a1 = 0.
//
// Bound on the H100: memory. At 8 x 48 x 256 x 512 -> 8 x 1024 x 2048 with
// K = 19 it reads 101 MB of features and writes 17 MB of mask (0.035 ms at
// 3.35 TB/s); the classifier's 0.96 G multiply-adds (~0.032 ms at the
// measured fmaf rate on the CUDA cores, which keep the channel order), the
// H pass and the W pass with the argmax (~2.5 G lane instructions) are the
// work a CUDA-core design issues.
// Design (clf_tail_kernel): the H-first tail's walk (upsample_argmax.cu) with
// the classifier in front of it. Items are bands of br output rows x
// segments of sw output columns of one image; a column (image, segment)
// is walked band after band, and a persistent block takes a contiguous run
// of the (column, band) sequence (its share of all steps, to within one),
// so it walks down a segment and keeps the logit rows it has: each input
// row's logits are computed once a column, again only at the first band of
// the block's run. A step g:
//   1. the features of step g + 2's new rows (those of its band's taps not
//      yet classified, all C channels, the segment's nc input columns from
//      the first column's low tap aligned down to 8) start staging by
//      16-byte cp.async into one of two buffers;
//   2. for each chunk of kc classes: the H pass once per (class, output
//      row, input column) from a ring of nr bf16 logit rows (row r in slot
//      r % nr, all K classes) into f32 shared memory (odd pitch, lanes over
//      consecutive columns, each lane's loads of kHB columns issued before
//      its stores), then the W pass and the running argmax: each
//      thread 8 consecutive output columns of one row, its W taps (loaded
//      once a segment) and (best, idx) in registers, classes in order.
//      Both passes multiply bf16 values by bf16 weights, so their products
//      are exact and one fmaf a sum rounds as the twin;
//   3. beside the last chunk's W pass (no barrier between them), the
//      classifier of step g + 1's new rows, whose features landed during
//      step g - 1, into the ring slots no band from step g + 1 on reads:
//      a thread takes 4 columns x 4 classes, for each channel in order one
//      8-byte read of the features and one float4 broadcast of the f32
//      [C][K] weights, 16 fmaf (a product of two bf16 values is exact, so
//      fmaf rounds as the twin's add); + bias, rounded to bf16;
//   4. one 8-byte mask store a thread.
// So a step has two barriers (one more a further chunk of classes), and
// the classifier's long channel chains overlap the other warps' W pass.
// clf_tail_plan (kernels/tail_flat.py) derives (br, sw, nr, nc, kc) from
// the tables; the C entry checks its shared bytes against ClfLayout. The
// v1 form (a 16 x 256 tile a block, its whole feature band staged before
// any arithmetic) stays as v1::clf_upsample_argmax_kernel, launched only by
// the probe entry segtpu_clf_upsample_argmax_v1.

#include "pw_tile.cuh"

#include <math.h>

using namespace segtpu;

namespace {

constexpr int kPX = 8;              // output columns a thread
constexpr int kCK = 4;              // classes a classifier unit
constexpr int kCPX = 4;             // columns a classifier unit
constexpr int kHB = 5;              // columns a lane's H-pass batch
constexpr int kClfMaxThreads = 512;

// The plan of a launch (kernels/tail_flat.py clf_tail_plan, clf_tail_args):
// bands of br output rows x segments of sw output columns; nr input rows
// (the most a band's taps name) and nc input columns (a multiple of 8)
// staged; kc classes a chunk of the H and W passes; smem bytes; vout: the
// 8-byte mask store.
struct ClfPlan {
  int br, sw, nr, nc, kc, smem, vout;
};

// Floats between two H-pass rows: odd, so the W pass's two half-warps,
// on two rows, read other banks.
inline __host__ __device__ int clf_pitch(int nc) { return nc + 1; }
inline __host__ __device__ int clf_kp(int K) {
  return (K + kCK - 1) / kCK * kCK;
}
inline int clf_threads(const ClfPlan& p) { return p.br * p.sw / kPX; }

// Byte offsets of a block's regions: the weights f32 [C][kp] at 0, the bias
// f32 [kp], the logit ring bf16 [K][nr][nc], two feature buffers bf16
// [C][nr][nc] of fbuf bytes each, the H pass f32 [kc][br][pitch].
struct ClfLayout {
  int bias, ring, feat, fbuf, t, total;
  __host__ __device__ ClfLayout(const ClfPlan& p, int C, int K) {
    const int kp = clf_kp(K);
    bias = r16(4 * C * kp);
    ring = bias + r16(4 * kp);
    feat = ring + r16(2 * K * p.nr * p.nc);
    fbuf = r16(2 * C * p.nr * p.nc);
    t = feat + 2 * fbuf;
    total = t + 4 * p.kc * p.br * clf_pitch(p.nc);
  }
};

// The walk of a persistent block: steps [first, last) of the sequence of
// (column, band), a column being (image, segment), bands fastest.
struct ClfWalk {
  int nseg, nband, first, last;
  __device__ ClfWalk(const ClfPlan& p, int B, int ho, int wo) {
    nseg = (wo + p.sw - 1) / p.sw;
    nband = (ho + p.br - 1) / p.br;
    const long long total = (long long)B * nseg * nband;
    first = (int)(total * blockIdx.x / gridDim.x);
    last = (int)(total * (blockIdx.x + 1) / gridDim.x);
  }
  // step g's image, band, first output row and column
  __device__ void at(int g, const ClfPlan& p, int& b, int& band, int& oy0,
                     int& ox0) const {
    const int col = g / nband;
    band = g - col * nband;
    oy0 = band * p.br;
    ox0 = col % nseg * p.sw;
    b = col / nseg;
  }
  // the input rows [lo, hi] step g classifies: its band's taps (the first
  // row's low tap to the last row's high one), less those its block's
  // previous step, the band above, classified (none on the block's first
  // step or a column's first band)
  __device__ void new_rows(int g, int band, int oy0, int br, int ho,
                           const int* rows, int& lo, int& hi) const {
    lo = rows[oy0];
    hi = rows[ho + min(oy0 + br, ho) - 1];
    if (g != first && band != 0) lo = max(lo, rows[ho + oy0 - 1] + 1);
  }
};

// Starts staging step g's new feature rows into fb (zero past the image's
// width); commits a group whether or not there is a step g.
__device__ __forceinline__ void stage_features(
    const ClfWalk& walk, const ClfPlan& p, int g, unsigned char* fb,
    const __nv_bfloat16* feat, int C, int h, int w, int ho, const int* rows,
    const int* cols) {
  if (g < walk.last) {
    int b, band, oy0, ox0, lo, hi;
    walk.at(g, p, b, band, oy0, ox0);
    walk.new_rows(g, band, oy0, p.br, ho, rows, lo, hi);
    const int cnt = hi - lo + 1, c_lo = cols[ox0] & ~7, n8 = p.nc / 8;
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(fb);
    const __nv_bfloat16* src = feat + (size_t)b * C * h * w + c_lo;
    for (int q = threadIdx.x; q < C * cnt * n8; q += blockDim.x) {
      const int cr = q / n8, j = (q - cr * n8) * 8;
      const int c = cr / cnt, r = cr - c * cnt;
      const bool in = c_lo + j < w;
      cp_async16(dst + (c * p.nr + r) * p.nc + j,
                 in ? src + ((size_t)c * h + lo + r) * w + j : feat,
                 in ? 16 : 0);
    }
  }
  cp_async_commit();
}

// The classifier of cnt staged rows (fs [C][nr][nc], rows lo ...) into the
// ring: a unit is kCPX columns x kCK classes (enough units for every
// thread at the plans' sizes), summed from zero in channel order, + bias,
// rounded to bf16.
__device__ __forceinline__ void classify(const ClfPlan& p, int cnt, int lo,
                                         const __nv_bfloat16* fs,
                                         const float* ws, const float* bias,
                                         __nv_bfloat16* ring, int C, int K) {
  const int n4 = p.nc / kCPX, kp = clf_kp(K), per = cnt * n4;
  for (int u = threadIdx.x; u < per * (kp / kCK); u += blockDim.x) {
    const int kq = u / per, rest = u - kq * per;
    const int r = rest / n4, j = (rest - r * n4) * kCPX;
    const __nv_bfloat16* f = fs + r * p.nc + j;
    const float* wv = ws + kCK * kq;
    float acc[kCK][kCPX];
#pragma unroll
    for (int kk = 0; kk < kCK; ++kk)
#pragma unroll
      for (int i = 0; i < kCPX; ++i) acc[kk][i] = 0.f;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      float x[kCPX];
      load_px<kCPX>(f + c * p.nr * p.nc, x);
      const float4 wq = *reinterpret_cast<const float4*>(wv + c * kp);
#pragma unroll
      for (int i = 0; i < kCPX; ++i) {
        acc[0][i] = __fmaf_rn(wq.x, x[i], acc[0][i]);
        acc[1][i] = __fmaf_rn(wq.y, x[i], acc[1][i]);
        acc[2][i] = __fmaf_rn(wq.z, x[i], acc[2][i]);
        acc[3][i] = __fmaf_rn(wq.w, x[i], acc[3][i]);
      }
    }
    const int slot = (lo + r) % p.nr;
#pragma unroll
    for (int kk = 0; kk < kCK; ++kk) {
      const int k = kCK * kq + kk;
      if (k >= K) break;
      float v[kCPX];
#pragma unroll
      for (int i = 0; i < kCPX; ++i) v[i] = __fadd_rn(acc[kk][i], bias[k]);
      store_px<kCPX>(ring + ((size_t)k * p.nr + slot) * p.nc + j, v);
    }
  }
}

__global__ void __launch_bounds__(kClfMaxThreads)
    clf_tail_kernel(const __nv_bfloat16* __restrict__ feat,
                    const __nv_bfloat16* __restrict__ wclf,
                    const float* __restrict__ bclf, uint8_t* __restrict__ out,
                    int B, int C, int K, int h, int w, int ho, int wo,
                    const int* __restrict__ rows, const float* __restrict__ rw,
                    const int* __restrict__ cols,
                    const float* __restrict__ cw, ClfPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ClfLayout L(p, C, K);
  float* ws = reinterpret_cast<float*>(smem);
  float* bias = reinterpret_cast<float*>(smem + L.bias);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + L.ring);
  float* ts = reinterpret_cast<float*>(smem + L.t);
  const int kp = clf_kp(K), pitch = clf_pitch(p.nc);
  const ClfWalk walk(p, B, ho, wo);
  // tables: rows/rw are [2, ho] (low tap, high tap); cols/cw are [2, wo]

  // the classifier's weights, transposed to f32 [C][kp], and its bias,
  // zero past K (visible after the first step's barrier)
  for (int e = threadIdx.x; e < C * kp; e += blockDim.x) {
    const int c = e / kp, k = e - c * kp;
    ws[e] = k < K ? __bfloat162float(wclf[(size_t)k * C + c]) : 0.f;
  }
  for (int k = threadIdx.x; k < kp; k += blockDim.x)
    bias[k] = k < K ? bclf[k] : 0.f;

  // this thread's W pass: row `row` of the band, 8 columns from ox0 + col
  const int half = threadIdx.x / 16, row = half % p.br;
  const int col = (half / p.br) * 16 * kPX + (threadIdx.x % 16) * kPX;
  int j0[kPX], j1[kPX];
  float b0[kPX], b1[kPX], best[kPX];
  uint32_t idx[kPX];
  // H-pass work of this warp: rows warp % br, + nw, ...; a row's classes
  // split between the `share` warps of the row
  const int nw = blockDim.x / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32, share = nw > p.br ? nw / p.br : 1;

  // feature buffer i of two
  auto fbuf = [&](int i) { return smem + L.feat + i * L.fbuf; };
  // classify step g's new rows from feature buffer i (none past the walk)
  auto classify_step = [&](int g, int i) {
    if (g >= walk.last) return;
    int b, band, oy0, ox0, lo, hi;
    walk.at(g, p, b, band, oy0, ox0);
    walk.new_rows(g, band, oy0, p.br, ho, rows, lo, hi);
    classify(p, hi - lo + 1, lo,
             reinterpret_cast<const __nv_bfloat16*>(fbuf(i)), ws, bias, ring,
             C, K);
  };
  // the first step's features, classified before the walk; the second's
  // staged meanwhile
  stage_features(walk, p, walk.first, fbuf(0), feat, C, h, w, ho, rows,
                 cols);
  cp_async_wait<0>();
  __syncthreads();            // the weights and the first features are in
  stage_features(walk, p, walk.first + 1, fbuf(1), feat, C, h, w, ho, rows,
                 cols);
  classify_step(walk.first, 0);
  int tab_ox0 = -1;       // the segment whose W taps the registers hold
  for (int g = walk.first; g < walk.last; ++g) {
    const int s = g - walk.first;
    cp_async_wait<0>();       // step g + 1's features have landed
    __syncthreads();          // ... for every thread; the ring holds step
                              // g's rows; step g - 1 is done
    // step g + 2's features into the buffer step g's classifier read
    stage_features(walk, p, g + 2, fbuf(s & 1), feat, C, h, w, ho, rows,
                   cols);
    int b, band, oy0, ox0;
    walk.at(g, p, b, band, oy0, ox0);
    const int c_lo = cols[ox0] & ~7, nrow = min(p.br, ho - oy0);
    const int ox = ox0 + col;
    if (ox0 != tab_ox0) {   // a new segment: its W taps (the same each band)
      tab_ox0 = ox0;
#pragma unroll
      for (int i = 0; i < kPX; ++i) {
        const bool in = ox + i < wo;
        j0[i] = in ? row * pitch + cols[ox + i] - c_lo : 0;
        j1[i] = in ? row * pitch + cols[wo + ox + i] - c_lo : 0;
        b0[i] = in ? cw[ox + i] : 0.f;
        b1[i] = in ? cw[wo + ox + i] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kPX; ++i) {
      best[i] = -INFINITY;
      idx[i] = 0;
    }
    for (int k0 = 0; k0 < K; k0 += p.kc) {
      const int kc = min(p.kc, K - k0);
      // H pass once per (class, output row, input column):
      // t = bf16(a0 * L[r0] + a1 * L[r1]); both products are of bf16
      // values, exact in f32, so one fmaf rounds as the twin's sum
      for (int y = warp % p.br; y < nrow; y += nw) {
        const int gy = oy0 + y;
        const int o0 = rows[gy] % p.nr * p.nc;
        const int o1 = rows[ho + gy] % p.nr * p.nc;
        const float a0 = rw[gy], a1 = rw[ho + gy];
        for (int kk = warp / p.br % share; kk < kc; kk += share) {
          const __nv_bfloat16* l = ring + (size_t)(k0 + kk) * p.nr * p.nc;
          float* t = ts + (kk * p.br + y) * pitch;
          // kHB columns a lane, their loads issued before any store (a
          // store to t may alias the ring for the compiler, so a load after
          // it would wait for it)
          for (int j = lane; j < p.nc; j += 32 * kHB) {
            float u[kHB], v[kHB];
#pragma unroll
            for (int m = 0; m < kHB; ++m) {
              const int jj = min(j + 32 * m, p.nc - 1);
              u[m] = to_f32(l[o0 + jj]);
              v[m] = to_f32(l[o1 + jj]);
            }
#pragma unroll
            for (int m = 0; m < kHB; ++m)
              if (j + 32 * m < p.nc)
                t[j + 32 * m] = round_to<__nv_bfloat16>(
                    __fmaf_rn(a1, v[m], __fmul_rn(a0, u[m])));
          }
        }
      }
      __syncthreads();
      // W pass and the running argmax (exact products again, one fmaf):
      // strict >, ties to the lower class, by selects; fmaxf keeps best
      // as the strict update would
#pragma unroll 2
      for (int kk = 0; kk < kc; ++kk) {
        const float* t = ts + kk * p.br * pitch;
#pragma unroll
        for (int i = 0; i < kPX; ++i) {
          const float v =
              __fmaf_rn(t[j1[i]], b1[i], __fmul_rn(t[j0[i]], b0[i]));
          idx[i] = v > best[i] ? k0 + kk : idx[i];
          best[i] = fmaxf(best[i], v);
        }
      }
      if (k0 + kc < K) {
        __syncthreads();      // the next chunk's H pass
      } else {
        // the next step's classifier beside the last chunk's W pass: it
        // writes ring slots whose rows no band from step g + 1 on reads,
        // and every H pass of step g is done
        classify_step(g + 1, (s + 1) & 1);
      }
    }
    if (row >= nrow || ox >= wo) continue;
    uint8_t* o = out + ((size_t)b * ho + oy0 + row) * wo + ox;
    if (p.vout && ox + kPX <= wo) {
      *reinterpret_cast<uint2*>(o) =
          make_uint2(idx[0] | idx[1] << 8 | idx[2] << 16 | idx[3] << 24,
                     idx[4] | idx[5] << 8 | idx[6] << 16 | idx[7] << 24);
    } else {
#pragma unroll
      for (int i = 0; i < kPX; ++i)
        if (ox + i < wo) o[i] = (uint8_t)idx[i];
    }
  }
}

}  // namespace

// The v1 form, kept for A/B timing only (segtpu_clf_upsample_argmax_v1):
// a block owns a TH x TW tile of the output and stages the feature band the
// tile reads (all C channels) by 16-byte cp.async, waits for all of it,
// then A. the classifier at every band pixel into shared memory, B. the H
// pass of every class over the feature band, C. the W pass and the running
// argmax, with a barrier between them. Neighbouring tiles recompute the
// band rows and columns they share.
namespace v1 {

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

}  // namespace v1

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// rows/rw are [2, ho] and cols/cw [2, wo] tap tables (low tap, then high;
// weights bf16-rounded); plan: the 7 ints (br, sw, nr, nc, kc, smem, vout)
// of clf_tail_plan and clf_tail_args, rejected when they do not fit this
// source's layout.
extern "C" int segtpu_clf_upsample_argmax(
    const void* feat, const void* wclf, const void* bclf, void* out, int B,
    int C, int K, int h, int w, int ho, int wo, const int* rows,
    const float* rw, const int* cols, const float* cw, const int* plan,
    void* stream) {
  if (!plan) return (int)cudaErrorInvalidValue;
  const ClfPlan p{plan[0], plan[1], plan[2], plan[3],
                  plan[4], plan[5], plan[6]};
  const bool ok =
      B >= 1 && C >= 1 && K >= 1 && K <= 256 && h >= 1 && w >= 8 &&
      w % 8 == 0 && ho >= 1 && wo >= 1 &&
      (reinterpret_cast<uintptr_t>(feat) & 15) == 0 && p.br >= 2 &&
      p.br % 2 == 0 && p.sw >= 16 * kPX && p.sw % (16 * kPX) == 0 &&
      clf_threads(p) <= kClfMaxThreads && p.nr >= 1 && p.nc >= 8 &&
      p.nc % 8 == 0 && p.kc >= 1 && p.kc <= K &&
      p.smem == ClfLayout(p, C, K).total &&
      (!p.vout ||
       (wo % kPX == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0));
  const long long steps = (long long)B * ((wo + p.sw - 1) / p.sw) *
                          ((ho + p.br - 1) / p.br);
  if (!ok || steps >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int rc = set_smem(clf_tail_kernel, p.smem);
  if (rc) return rc;
  const int gx = resident_blocks(clf_tail_kernel, clf_threads(p), p.smem,
                                 steps, 1);
  if (gx < 1) return (int)cudaErrorInvalidValue;
  clf_tail_kernel<<<gx, clf_threads(p), p.smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(feat),
      static_cast<const __nv_bfloat16*>(wclf), static_cast<const float*>(bclf),
      static_cast<uint8_t*>(out), B, C, K, h, w, ho, wo, rows, rw, cols, cw,
      p);
  return (int)cudaGetLastError();
}

// The v1 kernel, for A/B timing only; the wrapper never launches it.
// Returns the cudaError_t of the launch (0 = ok).
// rows/rw are [2, ho] and cols/cw [2, wo] tap tables (low tap, then high).
extern "C" int segtpu_clf_upsample_argmax_v1(
    const void* feat, const void* wclf, const void* bclf, void* out, int B,
    int C, int K, int h, int w, int ho, int wo, int band_r, int band_c,
    const int* rows, const float* rw, const int* cols, const float* cw,
    void* stream) {
  const long long smem = v1::smem_bytes(C, K, band_r, band_c);
  if (smem > 227 * 1024 || K > 256 || w % 8 ||
      reinterpret_cast<uintptr_t>(feat) % 16)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        v1::clf_upsample_argmax_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((wo + v1::TW - 1) / v1::TW, (ho + v1::TH - 1) / v1::TH, B);
  v1::clf_upsample_argmax_kernel<<<grid, v1::THREADS, (size_t)smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(feat),
      static_cast<const __nv_bfloat16*>(wclf), static_cast<const float*>(bclf),
      static_cast<uint8_t*>(out), C, K, h, w, ho, wo, band_r, band_c, rows, rw,
      cols, cw);
  return (int)cudaGetLastError();
}
