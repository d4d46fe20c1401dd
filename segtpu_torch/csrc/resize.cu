// Bilinear upsample of a channel-first tensor with a fused add, CUDA C++ for
// sm_90a.
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
// [B, C0, OH, OW] through a chain of 1x1 stages (decoder_common.cuh, the
// pw_chain_chw function, every stage rounded to the dtype), then added in
// f32. The plain twin (kernels/resize_chw.py) computes the same bits.
//
// Bound on the H100: bytes. At the arch0 1024 x 2048 b8 decoder the one
// launch on the path upsamples 8 x 48 x 128 x 256 to 256 x 512 with the
// stride-4 tap (24 channels) through its adapt and aggregate 1x1s: it reads
// 25 + 50 MB and writes 101 MB (~53 us at 3.35 TB/s).
// Design (simple first version): one thread per output pixel, 128 per
// block. With a chain the thread first runs it on its pixel's raw channels
// (its column of shared memory holds the stages' outputs, as in
// pointwise.cu), then loops over channels reading the 2 x 2 input taps —
// neighbouring output pixels share them, so those reads hit L1/L2.

#include "decoder_common.cuh"

using namespace segtpu;

namespace {

constexpr int kTP = 128;

struct ResizeArgs {
  const void* x;
  void* out;
  int C, h, w, OH, OW;
  const int* rows;     // [2, OH]
  const float* rw;     // [2, OH]
  const int* cols;     // [2, OW]
  const float* cw;     // [2, OW]
  const void* add;     // optional [B, C, OH, OW]
  int has_chain;
  int chain_w;         // shared floats of the chain's weights
};

template <typename T>
__global__ void __launch_bounds__(kTP)
    resize_kernel(ResizeArgs a, PwChain ch) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y, tid = threadIdx.x;
  const long long ohw = (long long)a.OH * a.OW;
  const long long p = (long long)blockIdx.x * kTP + tid;
  // [C][kTP] chain output, after the chain's buffers and weights
  float* res = smem + 2 * ch.cmax * kTP + a.chain_w;
  if (a.has_chain)
    pw_chain_pixel<T, kTP>(ch, b, ohw, p, p < ohw, smem, [&](int co, float y) {
      res[co * kTP + tid] = round_to<T>(y);
    });
  if (p >= ohw) return;
  const int oy = (int)(p / a.OW), ox = (int)(p - (long long)oy * a.OW);
  const int r0 = a.rows[oy], r1 = a.rows[a.OH + oy];
  const float a0 = a.rw[oy], a1 = a.rw[a.OH + oy];
  const int c0 = a.cols[ox], c1 = a.cols[a.OW + ox];
  const float b0 = a.cw[ox], b1 = a.cw[a.OW + ox];
  const size_t hw = (size_t)a.h * a.w;
  const size_t o00 = (size_t)r0 * a.w + c0, o01 = (size_t)r0 * a.w + c1;
  const size_t o10 = (size_t)r1 * a.w + c0, o11 = (size_t)r1 * a.w + c1;
  const T* x = static_cast<const T*>(a.x) + (size_t)b * a.C * hw;
  const T* add = a.add ? static_cast<const T*>(a.add) + (size_t)b * a.C * ohw + p
                       : nullptr;
  T* out = static_cast<T*>(a.out) + (size_t)b * a.C * ohw + p;
  for (int c = 0; c < a.C; ++c) {
    const T* xc = x + (size_t)c * hw;
    const float t0 = __fadd_rn(__fmul_rn(a0, to_f32(xc[o00])),
                               __fmul_rn(a1, to_f32(xc[o10])));
    const float t1 = __fadd_rn(__fmul_rn(a0, to_f32(xc[o01])),
                               __fmul_rn(a1, to_f32(xc[o11])));
    float v = __fadd_rn(__fmul_rn(b0, t0), __fmul_rn(b1, t1));
    if (add) v = __fadd_rn(v, to_f32(add[(size_t)c * ohw]));
    if (a.has_chain) v = __fadd_rn(v, res[c * kTP + tid]);
    out[(size_t)c * ohw] = from_f32<T>(v);
  }
}

template <typename T>
int run(const ResizeArgs& a, const PwChain& ch, int B, cudaStream_t s) {
  const int smem = a.has_chain ? 4 * ((2 * ch.cmax + a.C) * kTP + a.chain_w)
                               : 0;
  const int rc = set_smem(resize_kernel<T>, smem);
  if (rc) return rc;
  const long long ohw = (long long)a.OH * a.OW;
  const dim3 grid((unsigned)((ohw + kTP - 1) / kTP), B);
  resize_kernel<T><<<grid, kTP, smem, s>>>(a, ch);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// add may be null. nst = 0 means no chain; otherwise raw [B, raw_c, OH, OW]
// goes through nst 1x1 stages (w [cout, cin] in x's dtype, b f32, act codes
// as pointwise.cu) whose last output has C channels.
extern "C" int segtpu_resize(const void* x, void* out, int B, int C, int h,
                             int w, int OH, int OW, const int* rows,
                             const float* rw, const int* cols, const float* cw,
                             const void* add, const void* raw, int raw_c,
                             const void* const* sw, const float* const* sb,
                             const int* scin, const int* scout,
                             const int* sact, int nst, int bf16,
                             void* stream) {
  if (nst < 0 || nst > kMaxStage || (nst > 0 && scout[nst - 1] != C))
    return (int)cudaErrorInvalidValue;
  ResizeArgs a{x, out, C, h, w, OH, OW, rows, rw, cols, cw, add, nst > 0, 0};
  PwChain ch{};
  ch.src[0] = raw;
  ch.src_c[0] = raw_c;
  ch.nsrc = 1;
  ch.nst = nst;
  ch.cmax = 0;
  for (int i = 0; i < nst; ++i) {
    ch.w[i] = sw[i];
    ch.b[i] = sb[i];
    ch.cin[i] = scin[i];
    ch.cout[i] = scout[i];
    ch.act[i] = sact[i];
    if (i < nst - 1 && scout[i] > ch.cmax) ch.cmax = scout[i];
  }
  a.chain_w = pw_chain_weight_floats(ch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(a, ch, B, s) : run<float>(a, ch, B, s);
}
