// Fused normalize + 2x2 space-to-depth front, CUDA C++ for sm_90a.
//
// Replaces: segtpu/kernels/front.py::normalize_s2d_front (the Pallas TPU
// kernel _front_kernel), which turns the uint8 image into the 12
// normalized space-to-depth planes the s2d stem reads.
//
// Function: uint8 [N, H, W, 3] (contiguous HWC bytes) -> [N, 12, Hp/2, Wp/2]
// in bf16 or f32. Channel c of output pixel (i, j) reads image pixel
// (2i + dy, 2j + dx, rgb) with dy = c / 6, dx = (c % 6) / 3, rgb = c % 3,
// i.e. byte 6j + c % 6 of image row 2i + dy. Outputs with i >= H/2 or
// j >= W/2 are the zero pad-to-stride margin.
//   bf16: y = bf16_rne(f32(u8) * s[c]) with s[c] = bf16(IMG_SCALE / std[c]),
//         out = bf16_rne(f32(y) + b[c]) with b[c] = bf16(-mean[c] / std[c])
//         — the TPU kernel's rounding order (one rounded product, then a
//         bf16 bias add), so the result is bit-identical to it.
//   f32:  out = (f32(u8) * IMG_SCALE - mean[c]) / std[c], every step
//         rounded (no contraction into FMA), as the plain PyTorch version.
//
// Bound on the H100: memory. At 8 x 1024 x 2048 it reads 50 MB and writes
// 101 MB (bf16) for ~0.2 GFLOP, so the floor is ~45 us at 3.35 TB/s; the
// arithmetic is negligible.
// Design: one thread per output pixel (one 2x2 patch): it reads its two
// 6-byte runs (a warp reads two contiguous 192-byte runs) and writes one
// element to each of the 12 planes, so a warp's stores to a plane are one
// contiguous 64-byte (bf16) or 128-byte (f32) segment. The constants travel
// in the kernel's parameter space. No shared memory: there is no reuse to
// stage. Wider vector loads and stores are left for a later tuning pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

struct FrontConsts {
  float scale[12];  // bf16 path: bf16(IMG_SCALE / std[c]) as f32
  float bias[12];   // bf16 path: bf16(-mean[c] / std[c]) as f32
  float mean[12];   // f32 path
  float stdv[12];   // f32 path
  float img_scale;  // f32 path: f32(1 / 255)
};

template <bool BF16>
__global__ void front_kernel(const uint8_t* __restrict__ img,
                             void* __restrict__ out, int h2, int w2, int hp2,
                             int wp2, FrontConsts k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  const int n = blockIdx.z;
  if (j >= wp2) return;
  const size_t plane = (size_t)hp2 * wp2;
  const size_t obase = (size_t)n * 12 * plane + (size_t)i * wp2 + j;
  const bool inside = i < h2 && j < w2;

  uint8_t px[12];
  if (inside) {
    const size_t row_bytes = (size_t)w2 * 6;  // W * 3
    const uint8_t* r0 =
        img + ((size_t)n * 2 * h2 + 2 * (size_t)i) * row_bytes + 6 * (size_t)j;
    const uint8_t* r1 = r0 + row_bytes;
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      px[q] = r0[q];
      px[6 + q] = r1[q];
    }
  }

#pragma unroll
  for (int c = 0; c < 12; ++c) {
    const float v = inside ? (float)px[c] : 0.f;
    if (BF16) {
      __nv_bfloat16 r = __float2bfloat16_rn(0.f);
      if (inside) {
        const __nv_bfloat16 y = __float2bfloat16_rn(__fmul_rn(v, k.scale[c]));
        r = __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), k.bias[c]));
      }
      static_cast<__nv_bfloat16*>(out)[obase + c * plane] = r;
    } else {
      float r = 0.f;
      if (inside)
        r = __fdiv_rn(__fsub_rn(__fmul_rn(v, k.img_scale), k.mean[c]),
                      k.stdv[c]);
      static_cast<float*>(out)[obase + c * plane] = r;
    }
  }
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int segtpu_front(const void* img, void* out, int n, int h2, int w2,
                            int hp2, int wp2, int out_bf16,
                            const FrontConsts* consts, void* stream) {
  const dim3 block(256);
  const dim3 grid((wp2 + 255) / 256, hp2, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(img);
  if (out_bf16)
    front_kernel<true><<<grid, block, 0, s>>>(src, out, h2, w2, hp2, wp2,
                                              *consts);
  else
    front_kernel<false><<<grid, block, 0, s>>>(src, out, h2, w2, hp2, wp2,
                                               *consts);
  return (int)cudaGetLastError();
}
