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
// memory, so cell_op_chw launches node_kernel once per node, each node's
// output stored in the compute dtype (the rounding the TPU kernel applies to
// every intermediate), and collect_kernel for a sum of several outputs.
//
// Function of node_kernel: branches over [B, Cin_i, H, W] sources (bf16 or
// f32) -> out [B, Cout, H, W] in their dtype,
//   out = round(sum_i branch_i (+ add) (+ vec[b, co]))
// in f32, where a branch is
//   conv (k x k, dilation d, zero padding): relu(sum_{c, t} w * x + b),
//     channels outer, taps row-major inner, from zero;
//   sep: mid = round(relu(sum_t wdw * x + bdw)) per channel in f32 (taps
//     row-major), then relu(sum_c wpw * mid + bpw);
//   skip: x; none: nothing.
// Dense and pointwise weights are in the dtype, depthwise weights and all
// biases f32. sep_conv_chw is one sep branch with add/vec, pair_op_chw two
// conv/sep branches, a fused cell node up to two branches plus vec (a global
// average pool branch's vector). The plain twins (kernels/chw_ops.py) compute
// the same sums in the same order and agree bit for bit.
//
// Bound on the H100: at 48 channels and 8 x 256 x 512 a dense 3x3 conv
// does 43 GFLOP of products (0.04 ms at the bf16 tensor-core rate) and a
// node moves ~0.2 GB (0.06 ms), so the cells are bound by bytes on tensor
// cores and by arithmetic on the CUDA cores this version uses.
// Design (simple first version): a block owns an 8 x 32 output tile of one
// image and every output channel; one thread per pixel. For a conv branch it
// stages chunks of input channels (tile plus halo, zero padding written in)
// with their weights for 16 output channels in shared memory, and each
// thread accumulates those 16 in registers from float4 weight broadcasts,
// restaging per group of 16; for a sep branch it first writes the rounded
// depthwise output of every channel of its pixel to shared memory, then runs
// the 1x1 product from there. The loop over groups of 16 output channels
// is outermost, so each group's branch sum stays in registers.

#include "decoder_common.cuh"

using namespace segtpu;

namespace {

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

}  // namespace

// Launches one node on `stream`; returns the cudaError_t (0 = ok). Branch i
// (i < nbr <= 2): kind[i] 0 none / 1 conv / 2 sep / 3 skip, source x[i] with
// cin[i] channels, kernel size k[i] in {1, 3, 5}, dilation dil[i], weights
// as in Branch. add (dtype) and vec (f32 [B, Cout]) may be null.
extern "C" int segtpu_cell_node(int nbr, const int* kind, const void* const* x,
                                const int* cin, const int* k, const int* dil,
                                const void* const* w, const float* const* b,
                                const float* const* wdw,
                                const float* const* bdw, const void* add,
                                const float* vec, void* out, int B, int Cout,
                                int H, int W, int bf16, void* stream) {
  if (nbr < 1 || nbr > 2) return (int)cudaErrorInvalidValue;
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
    if (kind[i] == kSkip && cin[i] != Cout) return (int)cudaErrorInvalidValue;
  }
  a.add = add;
  a.vec = vec;
  a.out = out;
  a.Cout = Cout;
  a.H = H;
  a.W = W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? run_node<__nv_bfloat16>(a, B, s) : run_node<float>(a, B, s);
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
