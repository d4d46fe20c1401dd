// One node of a NAS decoder cell — up to two branches, each a dense conv,
// a separable conv, a skip or nothing, summed — with BatchNorm folded, CUDA
// C++ for sm_90a; and the cell's collect sum.
//
// Replaces: segtpu/kernels/chw_ops.py::sep_conv_chw (Pallas _sep_kernel),
// ::pair_op_chw (_pair_kernel) and ::cell_op_chw (_cell_kernel). The TPU's
// cell kernel computes every node of a cell per row tile in VMEM, growing
// each intermediate by its consumers' halo rows; on this card the halos of
// the arch0 cell (13 rows and columns around node 1, for the dilation-6 5x5
// and dilation-3 3x3 convs that read it) would not fit a tile's shared
// memory, so cell_op_chw launches a node kernel once per node, each node's
// output stored in the compute dtype (the rounding the TPU kernel applies to
// every intermediate), and collect_kernel for a sum of several outputs.
//
// Function of a node: branches over [B, Cin_i, H, W] sources (bf16 or f32)
// -> out [B, Cout, H, W] in their dtype,
//   out = round(sum_i branch_i (+ add) (+ vec[b, co]))
// in f32, where a branch is
//   conv (k x k, dilation d, zero padding): relu(sum_{c, t} w * x + b);
//   sep: mid = round(relu(sum_t wdw * x + bdw)) per channel in f32 (taps
//     row-major, each product and sum rounded), then relu(sum_c wpw * mid
//     + bpw);
//   skip: x; none: nothing.
// Dense and pointwise weights are in the dtype, depthwise weights and all
// biases f32. sep_conv_chw is one sep branch with add/vec, pair_op_chw two
// conv/sep branches, a fused cell node up to two branches plus vec (a global
// average pool branch's vector).
//
// Bound on the H100: bytes. At 48 channels and 8 x 256 x 512 a node reads
// one or two [8, 48, 256, 512] bf16 sources (100 MB each) and writes one:
// 0.06-0.09 ms at 3.35 TB/s; its dense 3x3 products (43 GFLOP) take 0.04 ms
// on the bf16 tensor cores, 0.7 ms on the CUDA cores' ~60 TFLOP/s.
//
// f32 (node_kernel, CUDA cores): a block owns an 8 x 32 output tile and every
// output channel, one thread per pixel, 16 output channels at a time in
// registers; the sums run channels outer, taps inner, from zero, one rounded
// multiply and add each, as the plain twin (kernels/chw_ops.py) does: the
// two agree bit for bit.
//
// bf16 (node_tc_kernel, tensor cores): the same 8 x 32 tile, 8 warps, one
// tile row of 32 pixels each; up to 64 output channels per launch.
// - Dense and 1x1 products are mma.sync m16n8k16 bf16 x bf16 -> f32, an
//   implicit GEMM over the tile: M = pixels, N = Cout padded to 16, K = Cin
//   (padded to 16) x taps. Every operand is already exact bf16 (inputs,
//   weights, the rounded depthwise output), so products are exact and only
//   the order of the f32 sum differs from the twin's; that order is fixed,
//   (16 channels, tap row, tap column), for every pixel wherever it sits in a
//   tile, a shard's window or a batch, so kernel results do not depend on
//   the tiling. The twin is then matched to a tolerance, not bit for bit.
// - Weights arrive packed by the wrapper ([k*k][Np][Kc], zero padded,
//   chw_ops.pack_weights); a window of cc input channels (tile plus halo,
//   8-aligned columns) is staged once for all output channels with 16-byte
//   cp.async copies, then copied channel-innermost ([rows][cols][cc + 8]),
//   so every tap shift is a whole-pixel offset and each ldmatrix row of 8
//   channels is 16-byte aligned and conflict-free. Wide halos (dilation 12)
//   stage one tap row at a time with cc = 16, which keeps the sum order.
// - Separable branches: the depthwise half stays on the CUDA cores in f32,
//   one thread per pixel and four channels at a time (four independent
//   chains), in the twin's tap order and rounding, its weights in shared
//   memory. It reads the staged bf16 window while the next chunk of
//   channels fills a second one, and writes its rounded result as the 1x1
//   product's A operand ([pixel][channel], bf16).
// - Each branch's relu(acc + b) goes to an f32 [Cout][pixels] buffer at the
//   top of shared memory (the second branch adds to it; the branch that
//   stages more runs first, so the buffer only shares the block with the
//   smaller one); a last pass adds skips, add and vec in the twin's order,
//   rounds once and stores coalesced NCHW rows.
// - The channel chunk cc and the tap rows per window (kyg) come from the
//   wrapper's plan (chw_ops.node_plan), which mirrors the layout below and
//   fits two blocks per SM where it can; the entry checks the two agree.

#include "decoder_common.cuh"
#include "tc_common.cuh"

using namespace segtpu;

namespace {

// ---------------------------------------------- f32: CUDA-core FMAs

constexpr int kTH = 8, kTW = 32, kThreads = kTH * kTW;

enum { kNone = 0, kConv = 1, kSep = 2, kSkip = 3 };

struct Branch {
  int kind;
  const void* x;       // [B, cin, H, W]
  int cin, k, dil;
  const void* w;       // conv [Cout, cin, k, k] or sep pw [Cout, cin], dtype
  const float* b;      // [Cout]
  const float* wdw;    // sep: [cin, k, k] f32
  const float* bdw;    // sep: [cin] f32
};

struct NodeArgs {
  Branch br[2];
  int nbr;
  const void* add;     // optional [B, Cout, H, W] in the dtype
  const float* vec;    // optional [B, Cout] f32
  void* out;
  int Cout, H, W;
  int CC;              // input channels per staged window
  int cmid;            // channels of each sep branch's buffer
  int nsep;            // sep branches
  int wfloats;         // shared floats of the staged weights
};

// Stage channels [c0, c0 + cc) of image x's tile plus halo as f32, zero
// outside the image. Window origin: (tile row - lo, tile col - lo).
template <typename T>
__device__ __forceinline__ void stage(const T* x, int c0, int cc, int H, int W,
                                      int SH, int SW, int lo, float* win) {
  const int y0 = blockIdx.y * kTH - lo, x0 = blockIdx.x * kTW - lo;
  const int n = cc * SH * SW;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int c = i / (SH * SW), r = i - c * (SH * SW);
    const int sy = r / SW, sx = r - sy * SW;
    const int gy = y0 + sy, gx = x0 + sx;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = to_f32(x[((size_t)(c0 + c) * H + gy) * W + gx]);
    win[i] = v;
  }
}

// Dense conv: add output channels [co0, co0 + 16) of the tile's pixel to acc.
// acc[o] += w * x for 16 outputs from a float4-packed [16] weight vector.
template <typename T>
__device__ __forceinline__ void mac16(float (&acc)[kCOB], const float* wv16,
                                      float v) {
  const float4* wp = reinterpret_cast<const float4*>(wv16);
#pragma unroll
  for (int q = 0; q < kCOB / 4; ++q) {
    const float4 wv = wp[q];
    acc[4 * q + 0] = mac<T>(acc[4 * q + 0], wv.x, v);
    acc[4 * q + 1] = mac<T>(acc[4 * q + 1], wv.y, v);
    acc[4 * q + 2] = mac<T>(acc[4 * q + 2], wv.z, v);
    acc[4 * q + 3] = mac<T>(acc[4 * q + 3], wv.w, v);
  }
}

// Dense conv: add output channels [co0, co0 + 16) of the tile's pixel to
// acc. Each chunk of input channels is staged with its weights, f32
// [cc][KK][16] (zero past Cout).
template <typename T, int K>
__device__ void conv_group(const NodeArgs& a, const Branch& br, int bi,
                           int co0, float* win, float* wsm,
                           float (&acc)[kCOB]) {
  constexpr int KK = K * K;
  const int dil = br.dil, lo = dil * (K / 2);
  const int SH = kTH + dil * (K - 1), SW = kTW + dil * (K - 1);
  const int tx = threadIdx.x % kTW, ty = threadIdx.x / kTW;
  const T* x = static_cast<const T*>(br.x) + (size_t)bi * br.cin * a.H * a.W;
  const T* w = static_cast<const T*>(br.w);
  for (int c0 = 0; c0 < br.cin; c0 += a.CC) {
    const int cc = min(a.CC, br.cin - c0);
    __syncthreads();
    stage(x, c0, cc, a.H, a.W, SH, SW, lo, win);
    for (int i = threadIdx.x; i < cc * KK * kCOB; i += kThreads) {
      const int o = i % kCOB, ct = i / kCOB, c = ct / KK, t = ct - c * KK;
      const int co = co0 + o;
      wsm[i] = co < a.Cout ? to_f32(w[((size_t)co * br.cin + c0 + c) * KK + t])
                           : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < cc; ++c) {
      const float* xc = win + (c * SH + ty) * SW + tx;
#pragma unroll
      for (int t = 0; t < KK; ++t)
        mac16<T>(acc, wsm + (c * KK + t) * kCOB,
                 xc[(t / K) * dil * SW + (t % K) * dil]);
    }
  }
}

// Separable conv, depthwise half: mid[c][pixel] for every input channel.
template <typename T, int K>
__device__ void sep_mid(const NodeArgs& a, const Branch& br, int bi,
                        float* win, float* wsm, float* mid) {
  constexpr int KK = K * K;
  const int dil = br.dil, lo = dil * (K / 2);
  const int SH = kTH + dil * (K - 1), SW = kTW + dil * (K - 1);
  const int tx = threadIdx.x % kTW, ty = threadIdx.x / kTW;
  const T* x = static_cast<const T*>(br.x) + (size_t)bi * br.cin * a.H * a.W;
  for (int c0 = 0; c0 < br.cin; c0 += a.CC) {
    const int cc = min(a.CC, br.cin - c0);
    __syncthreads();
    stage(x, c0, cc, a.H, a.W, SH, SW, lo, win);
    for (int i = threadIdx.x; i < cc * KK; i += kThreads)
      wsm[i] = br.wdw[(size_t)c0 * KK + i];
    __syncthreads();
    for (int c = 0; c < cc; ++c) {
      const float* xc = win + (c * SH + ty) * SW + tx;
      const float* wc = wsm + c * KK;
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < KK; ++t)
        s = mac<float>(s, wc[t], xc[(t / K) * dil * SW + (t % K) * dil]);
      mid[(c0 + c) * kThreads + threadIdx.x] =
          round_to<T>(fmaxf(s + br.bdw[c0 + c], 0.f));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) node_kernel(NodeArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* mid = smem;                                 // [n sep][cmid][256]
  float* wsm = mid + a.nsep * a.cmid * kThreads;     // staged weights
  float* win = wsm + a.wfloats;                      // [CC][SH][SW]
  const int tid = threadIdx.x;
  const int tx = tid % kTW, ty = tid / kTW;
  const int bi = blockIdx.z;
  const int gy = blockIdx.y * kTH + ty, gx = blockIdx.x * kTW + tx;
  const bool inside = gy < a.H && gx < a.W;
  // the depthwise half of every sep branch, each into its own buffer
  for (int i = 0, j = 0; i < a.nbr; ++i) {
    const Branch& br = a.br[i];
    if (br.kind != kSep) continue;
    float* m = mid + (j++) * a.cmid * kThreads;
    if (br.k == 1) sep_mid<T, 1>(a, br, bi, win, wsm, m);
    else if (br.k == 3) sep_mid<T, 3>(a, br, bi, win, wsm, m);
    else sep_mid<T, 5>(a, br, bi, win, wsm, m);
  }
  T* out = static_cast<T*>(a.out);
  for (int co0 = 0; co0 < a.Cout; co0 += kCOB) {
    float tot[kCOB];
    bool any = false;
    for (int i = 0, j = 0; i < a.nbr; ++i) {
      const Branch& br = a.br[i];
      if (br.kind == kNone) continue;
      float acc[kCOB];
#pragma unroll
      for (int o = 0; o < kCOB; ++o) acc[o] = 0.f;
      if (br.kind == kConv) {
        if (br.k == 1) conv_group<T, 1>(a, br, bi, co0, win, wsm, acc);
        else if (br.k == 3) conv_group<T, 3>(a, br, bi, co0, win, wsm, acc);
        else conv_group<T, 5>(a, br, bi, co0, win, wsm, acc);
      } else if (br.kind == kSep) {
        // the 1x1 half: this group's weights as f32 [cin][16]
        const float* m = mid + (j++) * a.cmid * kThreads;
        const T* w = static_cast<const T*>(br.w);
        __syncthreads();
        for (int q = tid; q < br.cin * kCOB; q += kThreads) {
          const int o = q % kCOB, ci = q / kCOB;
          wsm[q] = co0 + o < a.Cout ? to_f32(w[(size_t)(co0 + o) * br.cin + ci])
                                    : 0.f;
        }
        __syncthreads();
        for (int ci = 0; ci < br.cin; ++ci)
          mac16<T>(acc, wsm + ci * kCOB, m[ci * kThreads + tid]);
      }
#pragma unroll
      for (int o = 0; o < kCOB; ++o) {
        const int co = min(co0 + o, a.Cout - 1);
        float y;
        if (br.kind == kSkip)
          y = inside ? to_f32(static_cast<const T*>(br.x)[
                           (((size_t)bi * br.cin + co) * a.H + gy) * a.W + gx])
                     : 0.f;
        else
          y = fmaxf(acc[o] + br.b[co], 0.f);
        tot[o] = any ? tot[o] + y : y;
      }
      any = true;
    }
    if (!inside) continue;
#pragma unroll
    for (int o = 0; o < kCOB; ++o) {
      const int co = co0 + o;
      if (co >= a.Cout) break;
      const size_t i = (((size_t)bi * a.Cout + co) * a.H + gy) * a.W + gx;
      float v = any ? tot[o] : 0.f;
      if (a.add) v = v + to_f32(static_cast<const T*>(a.add)[i]);
      if (a.vec) v = v + a.vec[(size_t)bi * a.Cout + co];
      out[i] = from_f32<T>(v);
    }
  }
}

constexpr int kMaxCollect = 8;
struct Entries {
  const void* p[kMaxCollect];
};

// out = (((e0 + e1) + e2) + ...), each sum rounded to the dtype.
template <typename T>
__global__ void collect_kernel(Entries e, int n, T* out, long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float v = to_f32(static_cast<const T*>(e.p[0])[i]);
  for (int j = 1; j < n; ++j)
    v = round_to<T>(v + to_f32(static_cast<const T*>(e.p[j])[i]));
  out[i] = from_f32<T>(v);
}

template <typename T>
int run_node(NodeArgs a, int B, cudaStream_t s) {
  int span = 0, cin = 1, kk = 1;
  for (int i = 0; i < a.nbr; ++i) {
    const Branch& br = a.br[i];
    if (br.kind == kConv || br.kind == kSep) {
      if (br.k != 1 && br.k != 3 && br.k != 5) return (int)cudaErrorInvalidValue;
      const int e = br.dil * (br.k - 1);
      span = max(span, (kTH + e) * (kTW + e));
      cin = max(cin, br.cin);
      kk = max(kk, br.k * br.k);
    }
  }
  // stage up to ~16 KB of input window per step, with its weights
  a.CC = span ? max(1, min(cin, (16 * 1024) / (4 * span))) : 0;
  a.wfloats = max(a.CC * kk * kCOB, cin * kCOB);
  const int smem = 4 * (a.nsep * a.cmid * kThreads + a.wfloats + a.CC * span);
  const int rc = set_smem(node_kernel<T>, smem);
  if (rc) return rc;
  const dim3 grid((a.W + kTW - 1) / kTW, (a.H + kTH - 1) / kTH, B);
  node_kernel<T><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}


// ------------------------------------------- bf16: tensor cores (mma.sync)

namespace tc {

constexpr int kM = kTH * kTW;     // pixels of a tile
constexpr int kNG = 64;           // output channels per launch
constexpr int kOP = kM + 4;       // pitch (floats) of the branch-sum buffer

struct TcBranch {
  int kind;
  const uint16_t* x;   // [B, cin, H, W] bf16
  int cin, k, dil;
  const uint16_t* w;   // conv [k*k][Np][Kc], sep 1x1 [Np][Kc]: packed bf16
  const float* b;      // [Cout]
  const float* wdw;    // sep: [cin, k, k] f32
  const float* bdw;    // sep: [cin] f32
  int cc;              // input channels per staged window
  int kyg;             // conv: tap rows per staged window (k, or 1)
};

struct TcNode {
  TcBranch br[2];
  int nbr, nacc;       // branches, of which conv or sep
  const uint16_t* add;
  const float* vec;
  uint16_t* out;
  int Cout, Np, H, W;
  int n0;              // first output channel of this launch
  int smem;            // bytes of shared memory; the branch sums at the top
};

// A staged window: rows, columns, staged columns (a multiple of 8 from an
// 8-aligned image column) and the window's first column within them.
struct Win {
  int sh, sw, swa, off;
};
constexpr __host__ __device__ Win window(int k, int dil, int kyg) {
  return Win{kTH + dil * (kyg - 1), kTW + dil * (k - 1),
             r8((8 - dil * (k / 2) % 8) % 8 + kTW + dil * (k - 1)),
             (8 - dil * (k / 2) % 8) % 8};
}

inline __host__ __device__ int r4(int v) { return (v + 3) & ~3; }

// Shared bytes of one branch (chw_ops.node_branch_smem):
//   sep: mid [kM][Kc + 8], 1x1 weights [n16][Kc + 8] (bf16), depthwise
//        weights [cin * k * k] and biases [cin] (f32, each padded to 4),
//        two windows [cc][sh][swa] (bf16), one filling while the other is
//        read;
//   conv: window [cc][sh][swa], its channel-innermost copy [sh][sw][cc + 8],
//         two buffers of weights [kyg * k][n16][cc + 8]; all bf16.
inline int branch_bytes(int kind, int cin, int k, int dil, int cc, int kyg,
                        int n16) {
  if (kind == kSep) {
    const int kp = r16(cin) + 8;
    const Win w = window(k, dil, k);
    return 2 * (kM * kp + n16 * kp + 2 * cc * w.sh * w.swa) +
           4 * (r4(cin * k * k) + r4(cin));
  }
  if (kind == kConv) {
    const Win w = window(k, dil, kyg);
    return 2 * (cc * w.sh * w.swa + w.sh * w.sw * (cc + 8) +
                2 * kyg * k * n16 * (cc + 8));
  }
  return 0;
}
inline __host__ __device__ int osm_bytes(int n16) { return 4 * n16 * kOP; }

// raw[c][sy][sx] = x[c0 + c][y0 + sy][ax0 + sx] for c < ncc, zero outside
// the image and past cin; 16-byte cp.async copies when W and x allow.
__device__ __forceinline__ void stage_window(const uint16_t* x, int cin,
                                             int c0, int ncc, int H, int W,
                                             int y0, int ax0, int sh, int swa,
                                             bool vec, uint16_t* raw) {
  if (vec) {
    const int q = swa / 8, n = ncc * sh * q;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int j = i % q, r = i / q, sy = r % sh, c = r / sh;
      const int gy = y0 + sy, gx = ax0 + 8 * j;
      const bool ok = c0 + c < cin && gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16(raw + 8 * i,
                 ok ? x + ((size_t)(c0 + c) * H + gy) * W + gx : x,
                 ok ? 16 : 0);
    }
  } else {
    const int n = ncc * sh * swa;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int sx = i % swa, r = i / swa, sy = r % sh, c = r / sh;
      const int gy = y0 + sy, gx = ax0 + sx;
      uint16_t v = 0;
      if (c0 + c < cin && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = __ldg(x + ((size_t)(c0 + c) * H + gy) * W + gx);
      raw[i] = v;
    }
  }
}

// Dense conv branch: acc += its products for this warp's 32 pixels. Its
// windows (cc channels, kyg tap rows each) are staged in turn; each one's
// copies start before the products of the one before, with the
// weights in two buffers.
template <int NT16, int K>
__device__ __forceinline__ void conv_tc(const TcNode& a, const TcBranch& br,
                                        int bi, bool vec, uint16_t* st,
                                        float (&acc)[2][2 * NT16][4]) {
  constexpr int N16 = 16 * NT16;
  const int dil = br.dil, cc = br.cc, kyg = br.kyg, cp = cc + 8;
  const Win win = window(K, dil, kyg);
  const int wsize = kyg * K * N16 * cp;
  uint16_t* raw = st;                              // [cc][sh][swa]
  uint16_t* trn = raw + cc * win.sh * win.swa;     // [sh][sw][cp]
  uint16_t* wch0 = trn + win.sh * win.sw * cp;     // 2 x [kyg * K][N16][cp]
  uint16_t* wch1 = wch0 + wsize;
  const int kc = r16(br.cin), lo = dil * (K / 2);
  const int y0 = blockIdx.y * kTH - lo;
  const int ax0 = blockIdx.x * kTW - lo - win.off;
  const uint16_t* x = br.x + (size_t)bi * br.cin * a.H * a.W;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cs = win.sh * win.swa, nky = K / kyg;
  const int rounds = (kc + cc - 1) / cc * nky;
  // window r: channels c0 = (r / nky) cc .., tap rows ky0 = (r % nky) kyg ..
  auto fetch = [&](int r, uint16_t* wch) {
    const int c0 = r / nky * cc, ky0 = r % nky * kyg;
    const int q = min(cc, kc - c0) / 8;
    stage_window(x, br.cin, c0, 8 * q, a.H, a.W, y0 + ky0 * dil, ax0, win.sh,
                 win.swa, vec, raw);
    for (int i = tid; i < kyg * K * N16 * q; i += kThreads) {
      const int j = i % q, t = i / q, n = t % N16, tl = t / N16;
      const int co = a.n0 + n;
      const bool ok = co < a.Np;
      cp_async16(wch + (tl * N16 + n) * cp + 8 * j,
                 ok ? br.w + ((size_t)(ky0 * K + tl) * a.Np + co) * kc + c0 +
                          8 * j
                    : br.w,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };
  __syncthreads();
  fetch(0, wch0);
  for (int r = 0; r < rounds; ++r) {
    const int q = min(cc, kc - r / nky * cc) / 8;
    uint16_t* wch = r & 1 ? wch1 : wch0;
    cp_async_wait<0>();
    __syncthreads();
    // channel-innermost copy: trn[sy][sx][c] = raw[c][sy][off + sx]
    for (int i = tid; i < q * win.sh * win.sw; i += kThreads) {
      const int sx = i % win.sw, t = i / win.sw, sy = t % win.sh;
      const int g = t / win.sh;
      const uint16_t* s = raw + (8 * g) * cs + sy * win.swa + win.off + sx;
      uint4 v;
      v.x = s[0] | ((uint32_t)s[cs] << 16);
      v.y = s[2 * cs] | ((uint32_t)s[3 * cs] << 16);
      v.z = s[4 * cs] | ((uint32_t)s[5 * cs] << 16);
      v.w = s[6 * cs] | ((uint32_t)s[7 * cs] << 16);
      *reinterpret_cast<uint4*>(trn + (sy * win.sw + sx) * cp + 8 * g) = v;
    }
    __syncthreads();
    if (r + 1 < rounds) fetch(r + 1, r & 1 ? wch0 : wch1);
    // (16 channels, tap row, tap column): the same order for every pixel
    for (int c16 = 0; c16 < q / 2; ++c16)
      for (int kr = 0; kr < kyg; ++kr) {
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          uint32_t bf[NT16][4];
#pragma unroll
          for (int j = 0; j < NT16; ++j)
            ldsm_x4(bf[j], wch + ((kr * K + kx) * N16 + 16 * j + (lane & 7) +
                                  ((lane >> 4) << 3)) * cp +
                               16 * c16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            uint32_t af[4];
            ldsm_x4(af, trn + ((warp + kr * dil) * win.sw + 16 * mt +
                               (lane & 15) + kx * dil) * cp +
                            16 * c16 + (lane >> 4) * 8);
#pragma unroll
            for (int j = 0; j < NT16; ++j) {
              mma_bf16(acc[mt][2 * j], af, bf[j][0], bf[j][1]);
              mma_bf16(acc[mt][2 * j + 1], af, bf[j][2], bf[j][3]);
            }
          }
        }
      }
  }
}

// Depthwise taps of ``NC`` channels of one pixel, each its own f32 chain in
// the twin's tap order (row-major, product and sum each rounded), then
// round(relu(s + bdw)) into mid; x points at the first channel's window
// row of this pixel. DIL > 0 compiles the dilation in (and with it the
// window's pitch, so every tap's offset is a constant); DIL = 0 reads it
// from dil, swa and cs.
template <int K, int NC, int DIL>
__device__ __forceinline__ void dw_taps(const uint16_t* x, int cs, int dil,
                                        int swa, const float* w,
                                        const float* b, uint16_t* mid) {
  constexpr int KK = K * K;
  if constexpr (DIL > 0) {
    constexpr Win win = window(K, DIL, K);
    dil = DIL;
    swa = win.swa;
    cs = win.sh * win.swa;
  }
  float s[NC];
#pragma unroll
  for (int u = 0; u < NC; ++u) s[u] = 0.f;
#pragma unroll
  for (int t = 0; t < KK; ++t) {
    const int o = (t / K) * dil * swa + (t % K) * dil;
#pragma unroll
    for (int u = 0; u < NC; ++u)
      s[u] = __fadd_rn(s[u], __fmul_rn(w[u * KK + t],
                                       bf16_bits_to_f32(x[u * cs + o])));
  }
#pragma unroll
  for (int u = 0; u < NC; u += 2) {
    const uint32_t lo = f32_to_bf16_bits(fmaxf(s[u] + b[u], 0.f));
    if (u + 1 < NC)
      *reinterpret_cast<uint32_t*>(mid + u) =
          lo | ((uint32_t)f32_to_bf16_bits(fmaxf(s[u + 1] + b[u + 1], 0.f))
                << 16);
    else
      mid[u] = (uint16_t)lo;
  }
}

// The depthwise half of a chunk of ncc channels, four at a time.
template <int K, int DIL>
__device__ __forceinline__ void dw_chunk(const uint16_t* xp, int ncc, int cs,
                                         int dil, int swa, const float* w,
                                         const float* b, uint16_t* mp) {
  int c = 0;
  for (; c + 4 <= ncc; c += 4)
    dw_taps<K, 4, DIL>(xp + c * cs, cs, dil, swa, w + c * K * K, b + c,
                       mp + c);
  for (; c < ncc; ++c)
    dw_taps<K, 1, DIL>(xp + c * cs, cs, dil, swa, w + c * K * K, b + c,
                       mp + c);
}

// Separable conv branch: depthwise on the CUDA cores into mid, then acc +=
// the 1x1 products for this warp's 32 pixels.
template <int NT16, int K>
__device__ __forceinline__ void sep_tc(const TcNode& a, const TcBranch& br,
                                       int bi, bool vec, uint16_t* st,
                                       float (&acc)[2][2 * NT16][4]) {
  constexpr int N16 = 16 * NT16, KK = K * K;
  const int dil = br.dil, cin = br.cin, kc = r16(cin), kp = kc + 8;
  const Win win = window(K, dil, K);
  uint16_t* mid = st;                                  // [kM][kp]
  uint16_t* wpw = mid + kM * kp;                       // [N16][kp]
  float* wdw = reinterpret_cast<float*>(wpw + N16 * kp);   // [cin * KK]
  float* bdw = wdw + r4(cin * KK);                     // [cin]
  uint16_t* raw0 = reinterpret_cast<uint16_t*>(bdw + r4(cin));  // 2 x
  uint16_t* raw1 = raw0 + br.cc * win.sh * win.swa;          // [cc][sh][swa]
  const int lo = dil * (K / 2);
  const int y0 = blockIdx.y * kTH - lo;
  const int ax0 = blockIdx.x * kTW - lo - win.off;
  const uint16_t* x = br.x + (size_t)bi * cin * a.H * a.W;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cs = win.sh * win.swa;
  __syncthreads();
  const int q = kc / 8;
  for (int i = tid; i < N16 * q; i += kThreads) {
    const int j = i % q, n = i / q, co = a.n0 + n;
    const bool ok = co < a.Np;
    cp_async16(wpw + n * kp + 8 * j,
               ok ? br.w + (size_t)co * kc + 8 * j : br.w, ok ? 16 : 0);
  }
  for (int i = tid; i < cin * KK; i += kThreads) wdw[i] = __ldg(br.wdw + i);
  for (int i = tid; i < cin; i += kThreads) bdw[i] = __ldg(br.bdw + i);
  for (int c = cin; c < kc; ++c) mid[tid * kp + c] = 0;
  stage_window(x, cin, 0, min(br.cc, cin), a.H, a.W, y0, ax0, win.sh, win.swa,
               vec, raw0);
  cp_async_commit();
  for (int c0 = 0, r = 0; c0 < cin; c0 += br.cc, ++r) {
    const int ncc = min(br.cc, cin - c0);
    uint16_t* raw = r & 1 ? raw1 : raw0;
    // the next chunk fills the other window while this one is read
    if (c0 + br.cc < cin) {
      stage_window(x, cin, c0 + br.cc, min(br.cc, cin - c0 - br.cc), a.H, a.W,
                   y0, ax0, win.sh, win.swa, vec, r & 1 ? raw0 : raw1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // four channels at a time (cc is a multiple of 4 but for cin < 4);
    // the op vocabulary's dilations compiled in
    const uint16_t* xp = raw + warp * win.swa + win.off + lane;
    uint16_t* mp = mid + tid * kp + c0;
    const float* wc = wdw + c0 * KK;
    if (K == 3 && dil == 1)
      dw_chunk<K, 1>(xp, ncc, cs, dil, win.swa, wc, bdw + c0, mp);
    else if (K == 3 && dil == 3)
      dw_chunk<K, 3>(xp, ncc, cs, dil, win.swa, wc, bdw + c0, mp);
    else if (K == 5 && dil == 1)
      dw_chunk<K, 1>(xp, ncc, cs, dil, win.swa, wc, bdw + c0, mp);
    else if (K == 5 && dil == 6)
      dw_chunk<K, 6>(xp, ncc, cs, dil, win.swa, wc, bdw + c0, mp);
    else
      dw_chunk<K, 0>(xp, ncc, cs, dil, win.swa, wc, bdw + c0, mp);
    __syncthreads();      // this window is read before it fills again
  }
  for (int c16 = 0; c16 < kc / 16; ++c16) {
    uint32_t bf[NT16][4];
#pragma unroll
    for (int j = 0; j < NT16; ++j)
      ldsm_x4(bf[j], wpw + (16 * j + (lane & 7) + ((lane >> 4) << 3)) * kp +
                         16 * c16 + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      uint32_t af[4];
      ldsm_x4(af, mid + (warp * 32 + 16 * mt + (lane & 15)) * kp + 16 * c16 +
                      (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT16; ++j) {
        mma_bf16(acc[mt][2 * j], af, bf[j][0], bf[j][1]);
        mma_bf16(acc[mt][2 * j + 1], af, bf[j][2], bf[j][3]);
      }
    }
  }
}

template <int NT16>
__global__ void __launch_bounds__(kThreads, 2)
    node_tc_kernel(const __grid_constant__ TcNode a) {
  constexpr int N16 = 16 * NT16;
  extern __shared__ __align__(16) unsigned char smem[];
  // [N16][kOP] f32 branch sums at the top, written once a branch's
  // products are done: over the first branch's staging, below the second's
  // (the entry runs the branch that stages more first)
  float* osm = reinterpret_cast<float*>(smem + a.smem - osm_bytes(N16));
  uint16_t* st = reinterpret_cast<uint16_t*>(smem);
  const int bi = blockIdx.z, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  int done = 0;
  for (int i = 0; i < a.nbr; ++i) {
    const TcBranch& br = a.br[i];
    if (br.kind != kConv && br.kind != kSep) continue;
    const bool vec = a.W % 8 == 0 &&
                     (reinterpret_cast<uintptr_t>(br.x) & 15) == 0;
    float acc[2][2 * NT16][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2 * NT16; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
    if (br.kind == kConv) {
      if (br.k == 1) conv_tc<NT16, 1>(a, br, bi, vec, st, acc);
      else if (br.k == 3) conv_tc<NT16, 3>(a, br, bi, vec, st, acc);
      else conv_tc<NT16, 5>(a, br, bi, vec, st, acc);
    } else {
      if (br.k == 1) sep_tc<NT16, 1>(a, br, bi, vec, st, acc);
      else if (br.k == 3) sep_tc<NT16, 3>(a, br, bi, vec, st, acc);
      else sep_tc<NT16, 5>(a, br, bi, vec, st, acc);
    }
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < 2 * NT16; ++nt) {
      const int n = 8 * nt + 2 * (lane & 3), co = a.n0 + n;
      const float b0 = co < a.Cout ? __ldg(br.b + co) : 0.f;
      const float b1 = co + 1 < a.Cout ? __ldg(br.b + co + 1) : 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = warp * 32 + 16 * mt + (lane >> 2) + 8 * (r >> 1);
          const float y = fmaxf(acc[mt][nt][r] + (r & 1 ? b1 : b0), 0.f);
          float& o = osm[(n + (r & 1)) * kOP + p];
          o = done ? o + y : y;
        }
    }
    ++done;
  }
  __syncthreads();
  // branch sum (+ skips) (+ add) (+ vec), one rounding, coalesced rows of
  // four pixels a thread
  const int ng = min(kNG, a.Cout - a.n0);
  const bool vec4 = a.W % 4 == 0;
  const size_t hw = (size_t)a.H * a.W;
  for (int i = tid; i < ng * (kM / 4); i += kThreads) {
    const int n = i / (kM / 4), p = 4 * (i % (kM / 4));
    const int gy = blockIdx.y * kTH + p / kTW, gx = blockIdx.x * kTW + p % kTW;
    if (gy >= a.H || gx >= a.W) continue;
    const int co = a.n0 + n;
    const size_t pix = (size_t)gy * a.W + gx;
    const size_t o = ((size_t)bi * a.Cout + co) * hw + pix;
    const int ne = min(4, a.W - gx);
    const bool v4 = vec4 && ne == 4;
    float v[4];
    bool any = done > 0;
    if (any) {
      const float4 s = *reinterpret_cast<const float4*>(osm + n * kOP + p);
      v[0] = s.x, v[1] = s.y, v[2] = s.z, v[3] = s.w;
    }
    union {
      uint2 u;
      uint16_t h[4];
    } e = {};
    for (int j = 0; j < a.nbr; ++j) {
      const TcBranch& br = a.br[j];
      if (br.kind != kSkip) continue;
      const uint16_t* xs = br.x + ((size_t)bi * br.cin + co) * hw + pix;
      if (v4) {
        e.u = __ldg(reinterpret_cast<const uint2*>(xs));
      } else {
        for (int u = 0; u < ne; ++u) e.h[u] = __ldg(xs + u);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float xv = bf16_bits_to_f32(e.h[u]);
        v[u] = any ? v[u] + xv : xv;
      }
      any = true;
    }
    if (!any) v[0] = v[1] = v[2] = v[3] = 0.f;
    if (a.add) {
      if (v4) {
        e.u = __ldg(reinterpret_cast<const uint2*>(a.add + o));
      } else {
        for (int u = 0; u < ne; ++u) e.h[u] = __ldg(a.add + o + u);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = v[u] + bf16_bits_to_f32(e.h[u]);
    }
    if (a.vec) {
      const float vv = __ldg(a.vec + (size_t)bi * a.Cout + co);
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = v[u] + vv;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) e.h[u] = f32_to_bf16_bits(v[u]);
    if (v4) {
      *reinterpret_cast<uint2*>(a.out + o) = e.u;
    } else {
      for (int u = 0; u < ne; ++u) a.out[o + u] = e.h[u];
    }
  }
}

template <int NT16>
int launch_tc(const TcNode& a, int B, int smem, cudaStream_t s) {
  const int rc = set_smem(node_tc_kernel<NT16>, smem);
  if (rc) return rc;
  const dim3 grid((a.W + kTW - 1) / kTW, (a.H + kTH - 1) / kTH, B);
  node_tc_kernel<NT16><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// Checks the wrapper's plan against the layout above and launches one
// node_tc_kernel per group of 64 output channels.
int run_node_tc(TcNode a, int B, int smem, cudaStream_t s) {
  const int n16 = r16(min(a.Cout, kNG));
  int bytes[2] = {0, 0};
  for (int i = 0; i < a.nbr; ++i) {
    const TcBranch& br = a.br[i];
    if (br.kind != kConv && br.kind != kSep) continue;
    if (br.k != 1 && br.k != 3 && br.k != 5) return (int)cudaErrorInvalidValue;
    if (br.cc < 1 || (br.kind == kConv &&
                      (br.cc % 16 || (br.kyg != br.k && br.kyg != 1) ||
                       (br.kyg != br.k && br.cc != 16))))
      return (int)cudaErrorInvalidValue;
    bytes[i] = branch_bytes(br.kind, br.cin, br.k, br.dil, br.cc, br.kyg, n16);
  }
  // two conv/sep branches: the one that stages more runs first (the sum of
  // two is the same either way), the sums beside the second one's staging
  if (a.nacc == 2 && bytes[1] > bytes[0]) {
    const TcBranch t = a.br[0];
    a.br[0] = a.br[1];
    a.br[1] = t;
  }
  const int big = max(bytes[0], bytes[1]), small = min(bytes[0], bytes[1]);
  const int need = a.nacc == 2 ? max(big, small + osm_bytes(n16))
                   : a.nacc   ? max(big, osm_bytes(n16))
                              : 0;
  if (need != smem) return (int)cudaErrorInvalidValue;
  a.smem = smem;
  for (a.n0 = 0; a.n0 < a.Cout; a.n0 += kNG) {
    const int nt16 = (min(kNG, a.Cout - a.n0) + 15) / 16;
    const int rc = nt16 == 1   ? launch_tc<1>(a, B, smem, s)
                   : nt16 == 2 ? launch_tc<2>(a, B, smem, s)
                   : nt16 == 3 ? launch_tc<3>(a, B, smem, s)
                               : launch_tc<4>(a, B, smem, s);
    if (rc) return rc;
  }
  return 0;
}

}  // namespace tc

}  // namespace

// Launches one node on `stream`; returns the cudaError_t (0 = ok). Branch i
// (i < nbr <= 2): kind[i] 0 none / 1 conv / 2 sep / 3 skip, source x[i] with
// cin[i] channels, kernel size k[i] in {1, 3, 5}, dilation dil[i], weights
// as in Branch (f32) or TcBranch (bf16: w packed by chw_ops.pack_weights).
// bf16 only: cc[i], kyg[i] and smem are chw_ops.node_plan's. add (dtype)
// and vec (f32 [B, Cout]) may be null.
extern "C" int segtpu_cell_node(int nbr, const int* kind, const void* const* x,
                                const int* cin, const int* k, const int* dil,
                                const void* const* w, const float* const* b,
                                const float* const* wdw,
                                const float* const* bdw, const int* cc,
                                const int* kyg, const void* add,
                                const float* vec, void* out, int B, int Cout,
                                int H, int W, int bf16, int smem,
                                void* stream) {
  if (nbr < 1 || nbr > 2) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nbr; ++i)
    if (kind[i] == kSkip && cin[i] != Cout) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    tc::TcNode a{};
    a.nbr = nbr;
    for (int i = 0; i < nbr; ++i) {
      a.br[i] = tc::TcBranch{kind[i], static_cast<const uint16_t*>(x[i]),
                             cin[i], k[i], dil[i],
                             static_cast<const uint16_t*>(w[i]), b[i], wdw[i],
                             bdw[i], cc[i], kyg[i]};
      a.nacc += kind[i] == kConv || kind[i] == kSep;
    }
    a.add = static_cast<const uint16_t*>(add);
    a.vec = vec;
    a.out = static_cast<uint16_t*>(out);
    a.Cout = Cout;
    a.Np = r8(Cout);
    a.H = H;
    a.W = W;
    return tc::run_node_tc(a, B, smem, s);
  }
  NodeArgs a{};
  a.nbr = nbr;
  a.cmid = 0;
  a.nsep = 0;
  for (int i = 0; i < nbr; ++i) {
    a.br[i] = Branch{kind[i], x[i], cin[i], k[i], dil[i], w[i], b[i], wdw[i],
                     bdw[i]};
    if (kind[i] == kSep) {
      a.nsep += 1;
      a.cmid = max(a.cmid, cin[i]);
    }
  }
  a.add = add;
  a.vec = vec;
  a.out = out;
  a.Cout = Cout;
  a.H = H;
  a.W = W;
  return run_node<float>(a, B, s);
}

// ents: n (<= 8) host-held device pointers to [count] tensors in the dtype.
extern "C" int segtpu_cell_collect(const void* const* ents, int n, void* out,
                                   long long count, int bf16, void* stream) {
  if (n < 1 || n > kMaxCollect) return (int)cudaErrorInvalidValue;
  Entries e{};
  for (int j = 0; j < n; ++j) e.p[j] = ents[j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)((count + 255) / 256);
  if (bf16)
    collect_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        e, n, static_cast<__nv_bfloat16*>(out), count);
  else
    collect_kernel<float><<<grid, 256, 0, s>>>(e, n, static_cast<float*>(out),
                                               count);
  return (int)cudaGetLastError();
}
