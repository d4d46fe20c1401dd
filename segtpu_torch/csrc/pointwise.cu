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
// Products take dtype operands (exact in f32 for bf16) and sum in f32;
// bias and activation in f32; one rounding at the store.
//
// Bound on the H100: bytes. The arch0 b8 1024 x 2048 chain reads the
// stride-32 tap, [8, 320, 32, 64] bf16 (10.5 MB), and writes [8, 48, 32,
// 64] (1.6 MB): 0.0036 ms at 3.35 TB/s, for 0.35 GFLOP of products. G2's
// b8 512 x 512 classifier reads two [8, 48, 128, 128] sources (25.2 MB)
// and writes [8, 19, 128, 128] (5.0 MB): 0.0090 ms.
//
// f32 (pointwise_kernel, CUDA cores): one thread per pixel, 128 pixels per
// block, 16 output sums in registers per pass over the inputs, the sums
// over input channels ascending from zero, as the plain twin
// (kernels/chw_ops.py) computes them: the two agree bit for bit.
//
// bf16 (pw_tc_kernel, tensor cores): a plain GEMM per block of 128 pixels
// (contiguous in each NCHW plane), 4 warps of 32 pixels: M = pixels, K = the
// sources' concatenated channels (padded to 16), N = Cout padded to 16 (19
// -> 32 for the classifier; the packed weights pad it to 24), mma.sync
// m16n8k16 bf16 x bf16 -> f32. Stage 0's input arrives channel-major
// ([k][pixel], 16-byte cp.async copies of each plane's run of pixels) and
// is read with transposing ldmatrix; its weights, packed by the wrapper
// ([Np][Kp], chw_ops.pack_weights), are staged once per block alongside, in
// chunks of kc channels (chw_ops.pw_plan). Every stage but the last is
// rounded to bf16 into shared memory as the next stage's A operand
// ([pixel][channel]); it never reaches global memory. The last stage goes
// back through shared memory as coalesced NCHW rows. The f32 sum runs over
// 16-channel steps in ascending order for every pixel, so a pixel's result
// does not depend on its block; against the twin's order it differs by the
// f32 rounding of the sum, so the two are matched to a tolerance.

#include "decoder_common.cuh"
#include "tc_common.cuh"

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

// ------------------------------------------- bf16: tensor cores (mma.sync)

namespace tc {

constexpr int kNG = 64;           // output channels per pass
constexpr int kAP = kTP + 8;      // pitch of [k][pixel] buffers

struct TcChain {
  const uint16_t* src[kMaxSrc];
  int src_c[kMaxSrc];
  int nsrc;
  const uint16_t* w[kMaxStage];   // packed [Np][Kp] bf16, zero padded
  const float* b[kMaxStage];      // [cout] f32
  int cin[kMaxStage], cout[kMaxStage], act[kMaxStage];
  int nst;
  int kc;       // stage-0 input channels per staged chunk
  int wcols;    // columns of the weight buffer
  int cmax16;   // widest intermediate, padded to 16 (0: one stage)
  int nw, no;   // rows of the weight and output buffers
};

// Shared memory (chw_ops.pw_smem), bf16: stage-0 input [kc][kAP], weights
// [nw][wcols + 8], two intermediates [kTP][cmax16 + 8], output [no][kAP].
struct Layout {
  uint16_t *a0, *wb, *inter[2], *os;
};
inline __host__ __device__ int layout(const TcChain& ch, unsigned char* base,
                                      Layout* l) {
  const int a0 = ch.kc * kAP, wb = ch.nw * (ch.wcols + 8);
  const int in = ch.cmax16 ? kTP * (ch.cmax16 + 8) : 0;
  if (l) {
    l->a0 = reinterpret_cast<uint16_t*>(base);
    l->wb = l->a0 + a0;
    l->inter[0] = l->wb + wb;
    l->inter[1] = l->inter[0] + in;
    l->os = l->inter[1] + in;
  }
  return 2 * (a0 + wb + 2 * in + ch.no * kAP);
}

// Stage s, output channels [n0, n0 + 16 NT16), for this block's pixels.
template <int NT16>
__device__ __forceinline__ void pw_stage(const TcChain& ch, const Layout& l,
                                         int s, int n0, int b, long long hw,
                                         long long p0, bool vec,
                                         uint16_t* out) {
  constexpr int N16 = 16 * NT16;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cin = ch.cin[s], cout = ch.cout[s], kp = r16(cin), np = r8(cout);
  const uint16_t* w = ch.w[s];
  const int wp = ch.wcols + 8;
  float acc[2][2 * NT16][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2 * NT16; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
  const int kstep = s == 0 ? ch.kc : kp;
  for (int k0 = 0; k0 < kp; k0 += kstep) {
    const int nk = min(kstep, kp - k0);
    __syncthreads();
    if (s == 0) {
      // rows k0 .. k0 + nk of the concatenated sources, kTP pixels each
      for (int i = tid; i < nk * (kTP / 8); i += kTP) {
        const int j = i % (kTP / 8), k = i / (kTP / 8);
        int c = k0 + k, js = 0;
        while (js < ch.nsrc - 1 && c >= ch.src_c[js]) c -= ch.src_c[js++];
        const bool in_c = c < ch.src_c[js];
        const uint16_t* plane =
            ch.src[js] + ((size_t)b * ch.src_c[js] + c) * hw;
        uint16_t* dst = l.a0 + k * kAP + 8 * j;
        const long long p = p0 + 8 * j;
        if (vec) {
          const bool ok = in_c && p < hw;
          cp_async16(dst, ok ? plane + p : ch.src[0], ok ? 16 : 0);
        } else {
          for (int e = 0; e < 8; ++e)
            dst[e] = in_c && p + e < hw ? __ldg(plane + p + e) : 0;
        }
      }
    }
    for (int i = tid; i < N16 * (nk / 8); i += kTP) {
      const int j = i % (nk / 8), n = i / (nk / 8), co = n0 + n;
      const bool ok = co < np;
      cp_async16(l.wb + n * wp + 8 * j,
                 ok ? w + (size_t)co * kp + k0 + 8 * j : w, ok ? 16 : 0);
    }
    cp_async_wait_all();
    __syncthreads();
    const uint16_t* in = s & 1 ? l.inter[0] : l.inter[1];
    const int ip = ch.cmax16 + 8;
    for (int kk = 0; kk < nk / 16; ++kk) {
      uint32_t bf[NT16][4];
#pragma unroll
      for (int j = 0; j < NT16; ++j)
        ldsm_x4(bf[j], l.wb + (16 * j + (lane & 7) + ((lane >> 4) << 3)) * wp +
                           16 * kk + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t af[4];
        const int m = warp * 32 + 16 * mt;
        if (s == 0)
          ldsm_x4_t(af, l.a0 + (16 * kk + (lane & 7) + ((lane >> 4) << 3)) *
                                   kAP +
                              m + ((lane >> 3) & 1) * 8);
        else
          ldsm_x4(af, in + (m + (lane & 15)) * ip + k0 + 16 * kk +
                          (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < NT16; ++j) {
          mma_bf16(acc[mt][2 * j], af, bf[j][0], bf[j][1]);
          mma_bf16(acc[mt][2 * j + 1], af, bf[j][2], bf[j][3]);
        }
      }
    }
  }
  const bool last = s == ch.nst - 1;
  const int act = ch.act[s];
  uint16_t* inter = s & 1 ? l.inter[1] : l.inter[0];
  const int ip = ch.cmax16 + 8;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2 * NT16; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = warp * 32 + 16 * mt + (lane >> 2) + 8 * h;
        const int n = 8 * nt + 2 * (lane & 3), co = n0 + n;
        const float b0 = co < cout ? __ldg(ch.b[s] + co) : 0.f;
        const float b1 = co + 1 < cout ? __ldg(ch.b[s] + co + 1) : 0.f;
        const uint16_t y0 =
            f32_to_bf16_bits(activate(acc[mt][nt][2 * h] + b0, act));
        const uint16_t y1 =
            f32_to_bf16_bits(activate(acc[mt][nt][2 * h + 1] + b1, act));
        if (last) {
          l.os[n * kAP + m] = y0;
          l.os[(n + 1) * kAP + m] = y1;
        } else {
          *reinterpret_cast<uint32_t*>(inter + m * ip + co) =
              y0 | ((uint32_t)y1 << 16);
        }
      }
  if (!last) return;
  __syncthreads();
  const int ng = min(N16, cout - n0);
  for (int i = tid; i < ng * kTP; i += kTP) {
    const int n = i / kTP, p = i % kTP;
    if (p0 + p < hw)
      out[((size_t)b * cout + n0 + n) * hw + p0 + p] = l.os[n * kAP + p];
  }
}

__global__ void __launch_bounds__(kTP)
    pw_tc_kernel(const __grid_constant__ TcChain ch, uint16_t* out,
                 long long hw) {
  extern __shared__ __align__(16) unsigned char smem[];
  Layout l;
  layout(ch, smem, &l);
  const int b = blockIdx.y;
  const long long p0 = (long long)blockIdx.x * kTP;
  bool vec = hw % 8 == 0;
  for (int j = 0; j < ch.nsrc; ++j)
    vec = vec && (reinterpret_cast<uintptr_t>(ch.src[j]) & 15) == 0;
  for (int s = 0; s < ch.nst; ++s)
    for (int n0 = 0; n0 < ch.cout[s]; n0 += kNG) {
      const int nt16 = (min(kNG, ch.cout[s] - n0) + 15) / 16;
      if (nt16 == 1) pw_stage<1>(ch, l, s, n0, b, hw, p0, vec, out);
      else if (nt16 == 2) pw_stage<2>(ch, l, s, n0, b, hw, p0, vec, out);
      else if (nt16 == 3) pw_stage<3>(ch, l, s, n0, b, hw, p0, vec, out);
      else pw_stage<4>(ch, l, s, n0, b, hw, p0, vec, out);
    }
}

// Completes the wrapper's plan (kc, smem from chw_ops.pw_plan), checks the
// two agree and launches.
int run_tc(TcChain ch, uint16_t* out, int B, long long hw, int smem,
           cudaStream_t s) {
  if (ch.kc < 16 || ch.kc % 16) return (int)cudaErrorInvalidValue;
  ch.wcols = ch.kc;
  ch.cmax16 = 0;
  ch.nw = 0;
  for (int i = 0; i < ch.nst; ++i) {
    if (i > 0) ch.wcols = max(ch.wcols, r16(ch.cin[i]));
    if (i < ch.nst - 1) ch.cmax16 = max(ch.cmax16, r16(ch.cout[i]));
    ch.nw = max(ch.nw, min(kNG, r16(ch.cout[i])));
  }
  ch.no = min(kNG, r16(ch.cout[ch.nst - 1]));
  if (layout(ch, nullptr, nullptr) != smem) return (int)cudaErrorInvalidValue;
  const int rc = set_smem(pw_tc_kernel, smem);
  if (rc) return rc;
  const dim3 grid((unsigned)((hw + kTP - 1) / kTP), B);
  pw_tc_kernel<<<grid, kTP, smem, s>>>(ch, out, hw);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// src/src_c: nsrc source pointers [B, src_c, H, W] and their channels;
// w/b/cin/cout/act: nst stages, b f32, act 0 none / 1 relu / 2 relu6; w
// [cout, cin] in the sources' dtype (f32), or packed by
// chw_ops.pack_weights (bf16, which also takes chw_ops.pw_plan's kc and
// smem). A chain of more than one stage takes one source.
extern "C" int segtpu_pointwise(const void* const* src, const int* src_c,
                                int nsrc, const void* const* w,
                                const float* const* b, const int* cin,
                                const int* cout, const int* act, int nst,
                                void* out, int B, long long hw, int bf16,
                                int kc, int smem, void* stream) {
  if (nsrc < 1 || nsrc > kMaxSrc || nst < 1 || nst > kMaxStage ||
      (nst > 1 && nsrc != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    tc::TcChain ch{};
    for (int j = 0; j < nsrc; ++j) {
      ch.src[j] = static_cast<const uint16_t*>(src[j]);
      ch.src_c[j] = src_c[j];
    }
    ch.nsrc = nsrc;
    for (int i = 0; i < nst; ++i) {
      ch.w[i] = static_cast<const uint16_t*>(w[i]);
      ch.b[i] = b[i];
      ch.cin[i] = cin[i];
      ch.cout[i] = cout[i];
      ch.act[i] = act[i];
    }
    ch.nst = nst;
    ch.kc = kc;
    return tc::run_tc(ch, static_cast<uint16_t*>(out), B, hw, smem, s);
  }
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
  return run<float>(ch, out, B, hw, s);
}
