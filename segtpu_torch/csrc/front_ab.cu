// Two rounding and layout variants of the normalize + space-to-depth
// front, CUDA C++ for sm_90a (the production front is csrc/front.cu).
//
// Replaces: scripts/exp_front_kernel.py::_front_kernel (build_fused_front)
// and scripts/ab_normalize.py::_s2d_kernel (v_pallas). The TPU kernels read
// the image pair-blocked or row-flat and shuffle bytes with permutation
// matmuls; those are free views and lane layouts of the same bytes, so
// both kernels here read the uint8 [N, H, W, 3] image directly.
//
// front_single_round: -> bf16 [N, 12, H/2, W/2], channel c of output pixel
//   (i, j) reading image pixel (2i + dy, 2j + dx, rgb), c = dy*6 + dx*3 + rgb:
//     out = bf16_rne(f32(u8) * s[c] + b[c]),  s = bf16(IMG_SCALE / std),
//     b = f32(-mean / std)
//   with ONE rounding to bf16 (the production front rounds the product to
//   bf16 first and adds a bf16 bias). The product of a u8 value and a bf16
//   scale is exact in f32, so it is one f32 add and one round.
// normalize_s2d_nhwc: -> bf16 [N, H/2, W/2, 12] (channels last), same
//   channel order, out = bf16_rne((f32(u8) - m[c]) * r[c]) with the
//   experiment's own constants m = f32(mean * 255), r = f32(1 / (std * 255)).
// Both are bit-identical to their plain PyTorch versions and to the TPU
// kernels.
//
// Bound on the H100: memory. At 8 x 1024 x 2048 each reads 50 MB and
// writes 101 MB (0.045 ms at 3.35 TB/s) for 0.1 GFLOP.
// Design: one thread per output pixel (one 2 x 2 patch) reads its two
// 6-byte runs. The planar kernel writes one bf16 to each of the 12 planes
// (a warp's stores to a plane are one 64-byte segment); the channels-last
// kernel writes its 12 values as three 8-byte stores, so a warp writes one
// contiguous 768-byte run. The constants travel in the parameter space.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

struct AbConsts {
  float a[12];  // single round: bf16 scale;  nhwc: mean * 255
  float b[12];  // single round: f32 bias;    nhwc: 1 / (std * 255)
};

__device__ __forceinline__ void load_patch(const uint8_t* __restrict__ img,
                                           int n, int i, int j, int w2,
                                           int h2, float (&px)[12]) {
  const size_t row_bytes = (size_t)w2 * 6;  // W * 3
  const uint8_t* r0 =
      img + ((size_t)n * 2 * h2 + 2 * (size_t)i) * row_bytes + 6 * (size_t)j;
  const uint8_t* r1 = r0 + row_bytes;
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    px[q] = (float)r0[q];
    px[6 + q] = (float)r1[q];
  }
}

__global__ void front_single_round_kernel(const uint8_t* __restrict__ img,
                                          __nv_bfloat16* __restrict__ out,
                                          int h2, int w2, AbConsts k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  const int n = blockIdx.z;
  if (j >= w2) return;
  float px[12];
  load_patch(img, n, i, j, w2, h2, px);
  const size_t plane = (size_t)h2 * w2;
  __nv_bfloat16* o = out + (size_t)n * 12 * plane + (size_t)i * w2 + j;
#pragma unroll
  for (int c = 0; c < 12; ++c)
    o[c * plane] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(px[c], k.a[c]), k.b[c]));
}

__global__ void normalize_s2d_nhwc_kernel(const uint8_t* __restrict__ img,
                                          __nv_bfloat16* __restrict__ out,
                                          int h2, int w2, AbConsts k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  const int n = blockIdx.z;
  if (j >= w2) return;
  float px[12];
  load_patch(img, n, i, j, w2, h2, px);
  __align__(8) __nv_bfloat16 v[12];
#pragma unroll
  for (int c = 0; c < 12; ++c)
    v[c] = __float2bfloat16_rn(__fmul_rn(__fsub_rn(px[c], k.a[c]), k.b[c]));
  // 24 bytes per pixel: 8-byte aligned, so three 8-byte stores
  uint2* o = reinterpret_cast<uint2*>(
      out + (((size_t)n * h2 + i) * w2 + j) * 12);
  const uint2* src = reinterpret_cast<const uint2*>(v);
  o[0] = src[0];
  o[1] = src[1];
  o[2] = src[2];
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// nhwc = 0: front_single_round; 1: normalize_s2d_nhwc.
extern "C" int segtpu_front_ab(const void* img, void* out, int n, int h2,
                               int w2, int nhwc, const AbConsts* consts,
                               void* stream) {
  const dim3 block(256);
  const dim3 grid((w2 + 255) / 256, h2, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(img);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (nhwc)
    normalize_s2d_nhwc_kernel<<<grid, block, 0, s>>>(src, o, h2, w2, *consts);
  else
    front_single_round_kernel<<<grid, block, 0, s>>>(src, o, h2, w2, *consts);
  return (int)cudaGetLastError();
}
