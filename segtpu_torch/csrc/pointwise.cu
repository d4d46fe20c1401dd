// Chained and multi-source 1x1 convolutions with BatchNorm folded, CUDA C++
// for sm_90a.
//
// Replaces: segtpu/kernels/chw_ops.py::pw_chain_chw (Pallas _pw_chain_kernel)
// and ::pw_multi_chw (_pw_multi_kernel).
//
// Function: one chain of 1x1 stages over sources of shape [B, C_j, H, W]
// (bf16 or f32) -> out [B, Cn, H, W] in the sources' dtype (see PwChain in
// decoder_common.cuh):
//   pw_chain_chw: one source, n stages; stage i = act_i(w_i @ y + b_i), every
//     stage but the last rounded to the dtype (the storage rounding of the
//     two-kernel form), e.g. the decoder's adapt -> aggregate pair on a tap;
//   pw_multi_chw: n sources, one stage, = conv1x1(concat(sources)) without
//     the concatenated tensor, e.g. the decoder head's classifier.
// Products take dtype operands (exact in f32 for bf16) and sum in f32 over
// input channels ascending from zero; bias and activation in f32; one
// rounding at the store. The plain twin (kernels/chw_ops.py) sums in the
// same order, and the two agree bit for bit.
//
// Bound on the H100: bytes. At the arch0 1024 x 2048 b8 decoder the chain
// on the stride-4 tap reads 8 x 24 x 256 x 512 bf16 and writes 8 x 48 x 256
// x 512 (0.15 GB, ~45 us at 3.35 TB/s) for 1.2 GFLOP of products.
// Design (simple first version): one thread per pixel, 128 pixels per block.
// The thread reads its pixel's input channels (coalesced across the warp),
// keeps 16 output sums in registers per pass over the inputs, and passes
// intermediates between stages through its own column of two shared-memory
// buffers, so no intermediate reaches global memory. The block stages each
// group's weights in shared memory and reads them as float4 broadcasts.

#include "decoder_common.cuh"

using namespace segtpu;

namespace {

constexpr int kTP = 128;

template <typename T>
__global__ void __launch_bounds__(kTP)
    pointwise_kernel(PwChain ch, void* out, long long hw) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const long long p = (long long)blockIdx.x * kTP + threadIdx.x;
  const int cn = ch.cout[ch.nst - 1];
  T* o = static_cast<T*>(out) + (size_t)b * cn * hw + p;
  pw_chain_pixel<T, kTP>(ch, b, hw, p, p < hw, smem, [&](int co, float y) {
    o[(size_t)co * hw] = from_f32<T>(y);
  });
}

template <typename T>
int run(const PwChain& ch, void* out, int B, long long hw, cudaStream_t s) {
  const int smem = 4 * (2 * ch.cmax * kTP + pw_chain_weight_floats(ch));
  const int rc = set_smem(pointwise_kernel<T>, smem);
  if (rc) return rc;
  const dim3 grid((unsigned)((hw + kTP - 1) / kTP), B);
  pointwise_kernel<T><<<grid, kTP, smem, s>>>(ch, out, hw);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// src/src_c: nsrc source pointers [B, src_c, H, W] and their channels;
// w/b/cin/cout/act: nst stages, w [cout, cin] in the sources' dtype, b f32,
// act 0 none / 1 relu / 2 relu6. A chain of more than one stage takes one
// source.
extern "C" int segtpu_pointwise(const void* const* src, const int* src_c,
                                int nsrc, const void* const* w,
                                const float* const* b, const int* cin,
                                const int* cout, const int* act, int nst,
                                void* out, int B, long long hw, int bf16,
                                void* stream) {
  if (nsrc < 1 || nsrc > kMaxSrc || nst < 1 || nst > kMaxStage ||
      (nst > 1 && nsrc != 1))
    return (int)cudaErrorInvalidValue;
  PwChain ch{};
  for (int j = 0; j < nsrc; ++j) {
    ch.src[j] = src[j];
    ch.src_c[j] = src_c[j];
  }
  ch.nsrc = nsrc;
  ch.cmax = 0;
  for (int i = 0; i < nst; ++i) {
    ch.w[i] = w[i];
    ch.b[i] = b[i];
    ch.cin[i] = cin[i];
    ch.cout[i] = cout[i];
    ch.act[i] = act[i];
    if (i < nst - 1 && cout[i] > ch.cmax) ch.cmax = cout[i];
  }
  ch.nst = nst;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(ch, out, B, hw, s)
              : run<float>(ch, out, B, hw, s);
}
