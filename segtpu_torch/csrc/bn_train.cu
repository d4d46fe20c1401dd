// Train-mode BatchNorm with the activation that follows it, forward and
// backward, CUDA C++ for sm_90a (kernels/bn_train.py bn_act_train, a
// torch.autograd.Function).
//
// Replaces no TPU kernel: the JAX package leaves train BatchNorm
// (segtpu/core/layers.py bn_apply, train=True) to XLA's fusion. The port
// wrote it out in PyTorch (core/layers.py bn_train): six full-size passes
// forward and the activation a seventh, and autograd's backward of that
// chain about nineteen. These four kernels take its place on a CUDA tensor.
//
// x is NCHW-contiguous [N, C, H, W], f32 or bf16; the arithmetic is f32 and
// every output that x's shape has is in x's dtype, as bn_train gives.
//   stats       moments of each channel's N*H*W values (Welford)
//   normalize   mean, biased var, invstd = rsqrt(var + eps), the running
//               buffers moved in place (var unbiased by n / (n - 1)),
//               out = act(x * inv + shift), inv = invstd * scale,
//               shift = bias - mean * inv
//   grad_stats  sums of g and g * x_hat, g = dy where the activation passes
//               its gradient (torch.clamp's rule: 0 <= z, and z <= 6 for
//               relu6, z as the output dtype rounds it), x_hat = (x - mean)
//               * invstd
//   grad_input  dscale = sum(g x_hat), dbias = sum(g),
//               dx = scale * invstd * (g - sum(g) / n - x_hat sum(g x_hat) / n)
//
// Bound on the H100: bytes. 3 passes forward (stats reads x; normalize
// reads x and writes out) and 5 backward (grad_stats reads dy and x;
// grad_input reads both and writes dx), 12.09 GB a pass at arch0's b64
// 512x512 train step with aux heads (94 BatchNorms, f32): 96.7 GB, 28.8 ms
// at 3.35 TB/s, for a few f32 operations an element.
// Design: the activation is fused into the normalize pass, the statistics
// take one read (Welford moments merged by Chan's rule, never
// E[y^2] - E[y]^2, which loses its bits where mean^2 >> var), and no
// intermediate reaches device memory: the backward recomputes z and x_hat
// from x and the saved mean and invstd. Every kernel runs on a (C, P) grid
// of 256-thread blocks; block (c, p) sweeps a contiguous range of channel
// c's values with 16-byte loads where H*W allows (a scalar loop otherwise),
// four loads in flight a thread. Partials go to scratch [*, C, P] and the
// next kernel combines them in a fixed order (each thread a strided run,
// then warp shuffles, then shared memory), so the results are
// deterministic and nothing uses atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v as the dtype T rounds it, back in f32
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return to_f(from_f<T>(v));
}

// V consecutive elements: one 16-byte load where V * sizeof(T) is 16
template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = to_f(e[k]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = to_f(p[k]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < V; ++k) e[k] = from_f<T>(v[k]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = from_f<T>(v[k]);
  }
}

struct Geo {
  int c;           // channels
  uint32_t hwv;    // vectors of one (n, c) plane: H*W / V
  uint32_t total;  // vectors of one channel: N * hwv
  uint32_t chunk;  // vectors block (c, p) sweeps, from p * chunk
  int act;         // 0 none, 1 relu, 2 relu6
};

// element offset of channel c's vector iv
template <int V>
__device__ __forceinline__ size_t offset(const Geo& g, int c, uint32_t iv) {
  const uint32_t n = iv / g.hwv;
  return (((size_t)n * g.c + c) * g.hwv + (iv - n * g.hwv)) * V;
}

__device__ __forceinline__ float activate(float z, int act) {
  if (act == 1) return z < 0.f ? 0.f : z;
  if (act == 2) return z < 0.f ? 0.f : (z > 6.f ? 6.f : z);
  return z;
}

// dy where the activation passes the gradient at its rounded input zr
__device__ __forceinline__ float passed(float dy, float zr, int act) {
  if (act == 1) return zr >= 0.f ? dy : 0.f;
  if (act == 2) return (zr >= 0.f && zr <= 6.f) ? dy : 0.f;
  return dy;
}

// the same expression, with no contraction, in normalize and the backward
__device__ __forceinline__ float affine(float x, float inv, float shift) {
  return __fadd_rn(__fmul_rn(x, inv), shift);
}

struct Moments {
  float n, mean, m2;
};

// Chan's rule; an empty side leaves the other as it is
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  const float n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float fb = b.n / n;
  return {n, a.mean + d * fb, a.m2 + b.m2 + d * d * a.n * fb};
}

template <int V>
__device__ __forceinline__ Moments moments(const float (&v)[V]) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) s += v[k];
  const float m = s * (1.f / V);
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) q += (v[k] - m) * (v[k] - m);
  return {(float)V, m, q};
}

__device__ __forceinline__ Moments shfl_down(Moments m, int off) {
  return {__shfl_down_sync(~0u, m.n, off), __shfl_down_sync(~0u, m.mean, off),
          __shfl_down_sync(~0u, m.m2, off)};
}

// the block's moments, merged in a fixed order, at every thread
__device__ Moments block_moments(Moments m) {
  __shared__ Moments warp_part[kWarps];
  __shared__ Moments result;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = merge(m, shfl_down(m, off));
  if (lane == 0) warp_part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? warp_part[lane] : Moments{0.f, 0.f, 0.f};
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1)
      m = merge(m, shfl_down(m, off));
    if (lane == 0) result = m;
  }
  __syncthreads();
  return result;
}

// the block's sums of (a, b), added in a fixed order, at every thread
__device__ float2 block_sums(float2 s) {
  __shared__ float2 warp_part[kWarps];
  __shared__ float2 result;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s.x += __shfl_down_sync(~0u, s.x, off);
    s.y += __shfl_down_sync(~0u, s.y, off);
  }
  if (lane == 0) warp_part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? warp_part[lane] : make_float2(0.f, 0.f);
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      s.x += __shfl_down_sync(~0u, s.x, off);
      s.y += __shfl_down_sync(~0u, s.y, off);
    }
    if (lane == 0) result = s;
  }
  __syncthreads();
  return result;
}

// scratch [k, C, P]: partial k of block (c, p)
__device__ __forceinline__ size_t part_at(int k, int c, int p) {
  return ((size_t)k * gridDim.x + c) * gridDim.y + p;
}

// The vectors of block (c, p), kUnroll of them at once: load(u, iv) for
// each that exists, then body(u, iv) for each, so the loads are in flight
// together.
template <typename Load, typename Body>
__device__ __forceinline__ void sweep(const Geo& g, Load load_u, Body body_u) {
  const uint32_t lo = blockIdx.y * g.chunk;
  const uint32_t hi = min(lo + g.chunk, g.total);
  for (uint32_t i0 = lo + threadIdx.x; i0 < hi; i0 += kThreads * kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t iv = i0 + u * kThreads;
      if (iv < hi) load_u(u, iv);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t iv = i0 + u * kThreads;
      if (iv < hi) body_u(u, iv);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const T* __restrict__ x, float* __restrict__ part, Geo g) {
  const int c = blockIdx.x;
  Moments m{0.f, 0.f, 0.f};
  float v[kUnroll][V];
  sweep(
      g, [&](int u, uint32_t iv) { load<T, V>(x + offset<V>(g, c, iv), v[u]); },
      [&](int u, uint32_t) { m = merge(m, moments<V>(v[u])); });
  m = block_moments(m);
  if (threadIdx.x == 0) {
    part[part_at(0, c, blockIdx.y)] = m.n;
    part[part_at(1, c, blockIdx.y)] = m.mean;
    part[part_at(2, c, blockIdx.y)] = m.m2;
  }
}

struct Consts {
  float count;     // N*H*W
  float eps;
  float keep;      // 1 - momentum
  float momentum;
  float unbias;    // n / (n - 1)
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) normalize_kernel(
    const T* __restrict__ x, T* __restrict__ out,
    const float* __restrict__ part, const float* __restrict__ scale,
    const float* __restrict__ bias, float* __restrict__ run_mean,
    float* __restrict__ run_var, float* __restrict__ save_mean,
    float* __restrict__ save_invstd, Geo g, Consts k) {
  const int c = blockIdx.x;
  Moments m{0.f, 0.f, 0.f};
  for (int q = threadIdx.x; q < (int)gridDim.y; q += kThreads)
    m = merge(m, Moments{part[part_at(0, c, q)], part[part_at(1, c, q)],
                         part[part_at(2, c, q)]});
  m = block_moments(m);
  const float var = m.m2 / k.count;
  const float invstd = rsqrtf(var + k.eps);
  const float inv = __fmul_rn(invstd, scale[c]);
  const float shift = __fsub_rn(bias[c], __fmul_rn(m.mean, inv));
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    save_mean[c] = m.mean;
    save_invstd[c] = invstd;
    run_mean[c] = k.keep * run_mean[c] + k.momentum * m.mean;
    run_var[c] = k.keep * run_var[c] + k.momentum * (var * k.unbias);
  }
  float v[kUnroll][V];
  sweep(
      g, [&](int u, uint32_t iv) { load<T, V>(x + offset<V>(g, c, iv), v[u]); },
      [&](int u, uint32_t iv) {
        float o[V];
#pragma unroll
        for (int e = 0; e < V; ++e)
          o[e] = activate(affine(v[u][e], inv, shift), g.act);
        store<T, V>(out + offset<V>(g, c, iv), o);
      });
}

// per channel: (mean, invstd, inv, shift) as normalize computed them
struct Channel {
  float mean, invstd, inv, shift;
};

__device__ __forceinline__ Channel channel(int c, const float* save_mean,
                                           const float* save_invstd,
                                           const float* scale,
                                           const float* bias) {
  const float mean = save_mean[c], invstd = save_invstd[c];
  const float inv = __fmul_rn(invstd, scale[c]);
  return {mean, invstd, inv, __fsub_rn(bias[c], __fmul_rn(mean, inv))};
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) grad_stats_kernel(
    const T* __restrict__ dy, const T* __restrict__ x,
    const float* __restrict__ save_mean, const float* __restrict__ save_invstd,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ part, Geo g) {
  const int c = blockIdx.x;
  const Channel ch = channel(c, save_mean, save_invstd, scale, bias);
  float2 s = make_float2(0.f, 0.f);
  float vd[kUnroll][V], vx[kUnroll][V];
  const auto load_both = [&](int u, uint32_t iv) {
    const size_t at = offset<V>(g, c, iv);
    load<T, V>(dy + at, vd[u]);
    load<T, V>(x + at, vx[u]);
  };
  sweep(g, load_both, [&](int u, uint32_t) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float zr = rounded<T>(affine(vx[u][e], ch.inv, ch.shift));
      const float gk = passed(vd[u][e], zr, g.act);
      s.x += gk;
      s.y += gk * ((vx[u][e] - ch.mean) * ch.invstd);
    }
  });
  s = block_sums(s);
  if (threadIdx.x == 0) {
    part[part_at(0, c, blockIdx.y)] = s.x;
    part[part_at(1, c, blockIdx.y)] = s.y;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) grad_input_kernel(
    const T* __restrict__ dy, const T* __restrict__ x,
    const float* __restrict__ part, const float* __restrict__ save_mean,
    const float* __restrict__ save_invstd, const float* __restrict__ scale,
    const float* __restrict__ bias, T* __restrict__ dx,
    float* __restrict__ dscale, float* __restrict__ dbias, Geo g,
    float count) {
  const int c = blockIdx.x;
  float2 s = make_float2(0.f, 0.f);
  for (int q = threadIdx.x; q < (int)gridDim.y; q += kThreads) {
    s.x += part[part_at(0, c, q)];
    s.y += part[part_at(1, c, q)];
  }
  s = block_sums(s);
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    dscale[c] = s.y;
    dbias[c] = s.x;
  }
  const Channel ch = channel(c, save_mean, save_invstd, scale, bias);
  const float a = s.x / count, b = s.y / count;
  float vd[kUnroll][V], vx[kUnroll][V];
  const auto load_both = [&](int u, uint32_t iv) {
    const size_t at = offset<V>(g, c, iv);
    load<T, V>(dy + at, vd[u]);
    load<T, V>(x + at, vx[u]);
  };
  sweep(g, load_both, [&](int u, uint32_t iv) {
    float o[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float zr = rounded<T>(affine(vx[u][e], ch.inv, ch.shift));
      const float gk = passed(vd[u][e], zr, g.act);
      const float xhat = (vx[u][e] - ch.mean) * ch.invstd;
      o[e] = ch.inv * (gk - a - xhat * b);
    }
    store<T, V>(dx + offset<V>(g, c, iv), o);
  });
}

// The geometry of the entries' ints, or false when they do not hold
// together: dtype 0 f32, 1 bf16; vec 1 for 16-byte vectors (H*W a multiple
// of them), 0 for single elements; blocks * chunk covering the channel.
template <typename T, int V>
bool geometry(int n, int c, int hw, int blocks, int chunk, int act, Geo* g) {
  if (n < 1 || c < 1 || hw < 1 || hw % V || blocks < 1 || blocks > 65535 ||
      chunk < 1 || act < 0 || act > 2)
    return false;
  const uint64_t total = (uint64_t)n * (hw / V);
  if (total >= (1u << 31) || (uint64_t)blocks * chunk < total ||
      (uint64_t)(blocks - 1) * chunk >= total)
    return false;
  *g = Geo{c, (uint32_t)(hw / V), (uint32_t)total, (uint32_t)chunk, act};
  return true;
}

template <typename T, int V>
int launch_stats(const void* x, float* part, int n, int c, int hw,
                 int blocks, int chunk, cudaStream_t s) {
  Geo g;
  if (!geometry<T, V>(n, c, hw, blocks, chunk, 0, &g))
    return (int)cudaErrorInvalidValue;
  stats_kernel<T, V><<<dim3(c, blocks), kThreads, 0, s>>>(
      static_cast<const T*>(x), part, g);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_normalize(const void* x, void* out, const float* part,
                     const float* scale, const float* bias, float* run_mean,
                     float* run_var, float* save_mean, float* save_invstd,
                     int n, int c, int hw, int blocks, int chunk, int act,
                     Consts k, cudaStream_t s) {
  Geo g;
  if (!geometry<T, V>(n, c, hw, blocks, chunk, act, &g))
    return (int)cudaErrorInvalidValue;
  normalize_kernel<T, V><<<dim3(c, blocks), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), part, scale, bias,
      run_mean, run_var, save_mean, save_invstd, g, k);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_grad_stats(const void* dy, const void* x, const float* save_mean,
                      const float* save_invstd, const float* scale,
                      const float* bias, float* part, int n, int c, int hw,
                      int blocks, int chunk, int act, cudaStream_t s) {
  Geo g;
  if (!geometry<T, V>(n, c, hw, blocks, chunk, act, &g))
    return (int)cudaErrorInvalidValue;
  grad_stats_kernel<T, V><<<dim3(c, blocks), kThreads, 0, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), save_mean,
      save_invstd, scale, bias, part, g);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_grad_input(const void* dy, const void* x, const float* part,
                      const float* save_mean, const float* save_invstd,
                      const float* scale, const float* bias, void* dx,
                      float* dscale, float* dbias, int n, int c, int hw,
                      int blocks, int chunk, int act, float count,
                      cudaStream_t s) {
  Geo g;
  if (!geometry<T, V>(n, c, hw, blocks, chunk, act, &g))
    return (int)cudaErrorInvalidValue;
  grad_input_kernel<T, V><<<dim3(c, blocks), kThreads, 0, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), part, save_mean,
      save_invstd, scale, bias, static_cast<T*>(dx), dscale, dbias, g, count);
  return (int)cudaGetLastError();
}

}  // namespace

// F<T, V>(...) for dtype (0 f32, 1 bf16) and vec (1: 16-byte vectors)
#define SEGTPU_BN_DISPATCH(F, dtype, vec, ...)                        \
  ((dtype) == 0 ? ((vec) ? F<float, 4>(__VA_ARGS__)                   \
                         : F<float, 1>(__VA_ARGS__))                  \
   : (dtype) == 1 ? ((vec) ? F<__nv_bfloat16, 8>(__VA_ARGS__)         \
                           : F<__nv_bfloat16, 1>(__VA_ARGS__))        \
                  : (int)cudaErrorInvalidValue)

// Each entry launches one kernel on `stream` and returns its cudaError_t
// (0 = ok; cudaErrorInvalidValue for ints that do not hold together).

extern "C" int segtpu_bn_stats(const void* x, float* part, int n, int c,
                               int hw, int dtype, int vec, int blocks,
                               int chunk, void* stream) {
  return SEGTPU_BN_DISPATCH(launch_stats, dtype, vec, x, part, n, c, hw,
                            blocks, chunk, static_cast<cudaStream_t>(stream));
}

extern "C" int segtpu_bn_normalize(
    const void* x, void* out, const float* part, const float* scale,
    const float* bias, float* run_mean, float* run_var, float* save_mean,
    float* save_invstd, int n, int c, int hw, int dtype, int vec, int blocks,
    int chunk, int act, float count, float eps, float momentum, float unbias,
    void* stream) {
  const Consts k{count, eps, 1.f - momentum, momentum, unbias};
  return SEGTPU_BN_DISPATCH(launch_normalize, dtype, vec, x, out, part, scale,
                            bias, run_mean, run_var, save_mean, save_invstd, n,
                            c, hw, blocks, chunk, act, k,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int segtpu_bn_grad_stats(const void* dy, const void* x,
                                    const float* save_mean,
                                    const float* save_invstd,
                                    const float* scale, const float* bias,
                                    float* part, int n, int c, int hw,
                                    int dtype, int vec, int blocks, int chunk,
                                    int act, void* stream) {
  return SEGTPU_BN_DISPATCH(launch_grad_stats, dtype, vec, dy, x, save_mean,
                            save_invstd, scale, bias, part, n, c, hw, blocks,
                            chunk, act, static_cast<cudaStream_t>(stream));
}

extern "C" int segtpu_bn_grad_input(
    const void* dy, const void* x, const float* part, const float* save_mean,
    const float* save_invstd, const float* scale, const float* bias, void* dx,
    float* dscale, float* dbias, int n, int c, int hw, int dtype, int vec,
    int blocks, int chunk, int act, float count, void* stream) {
  return SEGTPU_BN_DISPATCH(launch_grad_input, dtype, vec, dy, x, part,
                            save_mean, save_invstd, scale, bias, dx, dscale,
                            dbias, n, c, hw, blocks, chunk, act, count,
                            static_cast<cudaStream_t>(stream));
}
