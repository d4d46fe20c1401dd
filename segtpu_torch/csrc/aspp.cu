// The dense convolutions of DeepLab-v3's atrous spatial pyramid pooling
// head (ASPP, arXiv:1706.05587 section 3.3) with BatchNorm folded, on the
// tensor cores, CUDA C++ for sm_90a.
//
// Replaces: no TPU kernel. The JAX package has no DeepLab head; the port
// serves one (models/aspp_decoder.py), and its dense 3x3 atrous products
// (320 -> 256 channels, K = 2880, at rates 6, 12 and 18) are the head's
// work: at 8 x 64 x 128 (a b8 1024 x 2048 call at output stride 16) 344
// GFLOP a call with the 1x1 branch and the projection, which the CUDA
// cores' f32 multiply-adds (59.5 TFLOP/s, conv_chw's dense route) cannot
// take under 5.8 ms.
//
// Function of a launch: up to four branches over one input x [B, Cin, H, W]
// (bf16), branch i a k_i x k_i convolution (k 1 or 3) at dilation d_i with
// zero padding d_i (k_i / 2), Cout_i outputs written at channels co_i ..
// co_i + Cout_i - 1 of out [B, Ctot, H, W] (bf16):
//   out[b, co_i + o, y, x] = round(relu(sum_{t, c} w_i[o, c, t] x[b, c, y +
//       d_i (ty - k_i / 2), x + d_i (tx - k_i / 2)] + bias_i[o] + vec[b,
//       co_i + o]))
// vec optional [B, Ctot] f32 (the pooled branch's slice of the
// projection, constant over the map, enters as such a vector).
// Dtypes at each step: x and the weights bf16 (weights packed by
// chw_ops.pack_weights: [k * k][Np][Kc], Np = Cout rounded to 8, Kc = Cin
// rounded to 16); products exact, summed in f32 by mma.sync m16n8k16 (the
// tensor cores' order: 16 channels at a time, channel chunks of 32 in
// ascending order, tap rows outer, tap columns inner); + bias, + vec and
// the ReLU in f32; one rounding to bf16. The head's tail (the
// upsampling and argmax) runs in f32 in upsample_argmax.cu. The plain twin
// (kernels/aspp.py aspp_chw_plain) sums in another f32 order: the two agree
// to a tolerance (most elements bit for bit, the rest one rounding apart),
// and that order is the same for every pixel wherever it sits in a tile or
// a batch.
//
// Bound on the H100: operations. The three atrous branches, the 1x1 branch
// and the projection are 300.6 GFLOP of bf16 products at the cell's shape
// (0.30 ms at 989 TFLOP/s); their bytes (x 42 MB read once, the concatenated
// branches 134 MB written and read, weights 6 MB) take 0.10 ms at 3.35
// TB/s.
//
// Design (aspp_kernel): an implicit GEMM, M = pixels, N = output channels,
// K = taps x input channels.
// - A block owns a tile of kTM = 128 consecutive pixels of one image row
//   and kTN = 128 output channels of one branch (blockIdx.z; the host puts
//   the 3x3 branches first, so the heavy blocks start first); 8 warps,
//   2 x 4 over (pixels, channels), each 64 pixels x 32 channels: 4 m16
//   tiles x 4 n8 tiles, 64 f32 accumulators a thread.
// - The K loop walks stages (tap row ty, chunk of kKC = 32 input
//   channels). A stage's input is one image row of 32 channels with a halo
//   of P = the widest branch's d (k / 2) rounded up to 8 columns each side
//   (176 columns at rate 18), staged raw [32][128 + 2P] by 16-byte cp.async
//   (zero outside the image; W % 8 == 0, else by 2-byte loads), then
//   copied channel-innermost into xt [128 + 2P][32 + 8], so that each tap
//   column is a whole-pixel shift of the A operand and each ldmatrix row
//   of 8 channels is 16-byte aligned; the row pitch of 80 bytes puts the 8
//   rows of an ldmatrix phase in 8 bank groups. The stage's weights, the
//   k tap columns of its tap row [k][128][32 + 8], come by cp.async.
// - Two buffers of raw rows and weights: stage s + 1 is fetched while
//   stage s's copy into xt is read by the products, one wait and two
//   barriers a stage.
// - Epilogue: + bias, + vec, ReLU, one rounding, through shared memory [128
//   channels][128 + 8 pixels], stored as 16-byte runs of pixels.
// The host plans nothing but the halo and the taps (chw_ops-style mirror:
// kernels/aspp.py aspp_smem); the entry checks the shared bytes it is
// given against its own count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

using namespace segtpu;

constexpr int kTM = 128;      // pixels of a tile (one image row's run)
constexpr int kTN = 128;      // output channels of a tile
constexpr int kKC = 32;       // input channels of a stage
constexpr int kThreads = 256;
constexpr int kMaxBranches = 4;
constexpr int kXP = kKC + 8;  // pitch of xt and of the staged weights
constexpr int kOP = kTM + 8;  // pitch of the epilogue's staged output
constexpr int kSmemMax = 227 * 1024;

struct Branch {
  const uint16_t* w;   // packed [k * k][np][kc] bf16
  const float* b;      // [cout] f32
  int k, dil, cout, co, np, kc;
};

struct Args {
  const uint16_t* x;   // [B, Cin, H, W] bf16
  const float* vec;    // [B, Ctot] f32, or null
  uint16_t* out;       // [B, Ctot, H, W] bf16
  int B, Cin, H, W, Ctot, nbr, P, kmax;
  Branch br[kMaxBranches];
};

// Shared memory (kernels/aspp.py aspp_smem): two raw buffers [kKC][NC]
// (NC = kTM + 2P), xt [NC][kXP], two weight buffers [kmax][kTN][kXP], all
// bf16; at least the epilogue's [kTN][kOP].
__host__ __device__ inline int raw_elems(int P) { return kKC * (kTM + 2 * P); }
__host__ __device__ inline int smem_bytes(int P, int kmax) {
  const int stages = 2 * raw_elems(P) + (kTM + 2 * P) * kXP +
                     2 * kmax * kTN * kXP;
  const int epi = kTN * kOP;
  return 2 * (stages > epi ? stages : epi);
}

__global__ void __launch_bounds__(kThreads, 2)
    aspp_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char sm_raw[];
  uint16_t* sm = reinterpret_cast<uint16_t*>(sm_raw);
  const Branch& br = a.br[blockIdx.z];
  const int co0 = blockIdx.y * kTN;
  if (co0 >= br.cout) return;
  const int ntx = (a.W + kTM - 1) / kTM;
  const int tx = blockIdx.x % ntx, r = blockIdx.x / ntx;
  const int y = r % a.H, b = r / a.H, x0 = tx * kTM;
  const int P = a.P, NC = kTM + 2 * P, k = br.k, half = k / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;

  uint16_t* raw0 = sm;
  uint16_t* xt = raw0 + 2 * raw_elems(P);
  uint16_t* wb0 = xt + NC * kXP;
  const int wsz = a.kmax * kTN * kXP;

  const uint16_t* xb = a.x + (size_t)b * a.Cin * a.H * a.W;
  const int nch = a.Cin / kKC, ns = k * nch;
  const bool vec_ok = a.W % 8 == 0;

  // stage s (tap row s / nch, channels (s % nch) kKC ..) into buffer s & 1
  auto fetch = [&](int s) {
    const int ty = s / nch, c0 = (s % nch) * kKC;
    const int gy = y + br.dil * (ty - half);
    const bool row = gy >= 0 && gy < a.H;
    uint16_t* raw = raw0 + (s & 1) * raw_elems(P);
    const int gx0 = x0 - P;
    if (vec_ok) {
      const int q = NC / 8;   // 16-byte runs a channel
      for (int i = tid; i < kKC * q; i += kThreads) {
        const int c = i / q, j = i - c * q, gx = gx0 + 8 * j;
        const bool ok = row && gx >= 0 && gx < a.W;
        cp_async16(raw + c * NC + 8 * j,
                   ok ? xb + ((size_t)(c0 + c) * a.H + gy) * a.W + gx : a.x,
                   ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kKC * NC; i += kThreads) {
        const int c = i / NC, j = i - c * NC, gx = gx0 + j;
        raw[i] = row && gx >= 0 && gx < a.W
                     ? xb[((size_t)(c0 + c) * a.H + gy) * a.W + gx]
                     : (uint16_t)0;
      }
    }
    // the tap row's k taps: rows co0.. of packed[t][.][c0 .. c0 + 31]
    uint16_t* wb = wb0 + (s & 1) * wsz;
    for (int i = tid; i < k * kTN * 4; i += kThreads) {
      const int kx = i / (kTN * 4), rem = i - kx * kTN * 4;
      const int n = rem >> 2, part = rem & 3;
      const int t = ty * k + kx;
      const bool ok = co0 + n < br.cout;
      cp_async16(wb + (kx * kTN + n) * kXP + 8 * part,
                 ok ? br.w + ((size_t)t * br.np + co0 + n) * br.kc + c0 +
                          8 * part
                    : br.w,
                 ok ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  fetch(0);
  cp_async_commit();
  for (int s = 0; s < ns; ++s) {
    cp_async_wait<0>();
    __syncthreads();   // stage s landed; the products of s - 1 are done
    {                  // raw [c][col] -> xt [col][c], two channels a word
      const uint16_t* raw = raw0 + (s & 1) * raw_elems(P);
      for (int i = tid; i < (kKC / 2) * NC; i += kThreads) {
        const int cp = i / NC, col = i - cp * NC;
        const uint32_t v = (uint32_t)raw[(2 * cp) * NC + col] |
                           (uint32_t)raw[(2 * cp + 1) * NC + col] << 16;
        *reinterpret_cast<uint32_t*>(xt + col * kXP + 2 * cp) = v;
      }
    }
    __syncthreads();   // xt holds stage s; raw buffer s & 1 is free
    if (s + 1 < ns) fetch(s + 1);
    cp_async_commit();

    const uint16_t* wb = wb0 + (s & 1) * wsz;
    for (int kx = 0; kx < k; ++kx) {
      // column of xt that pixel 0 of the tile reads at this tap
      const int sh = P + br.dil * (kx - half);
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        uint32_t bf[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          ldsm_x4(bf[j], wb + (kx * kTN + wn * 32 + 16 * j + (lane & 7) +
                               ((lane >> 4) << 3)) * kXP +
                             kk + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t af[4];
          ldsm_x4(af, xt + (sh + wm * 64 + 16 * i + (lane & 15)) * kXP + kk +
                          (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma_bf16(acc[i][2 * j], af, bf[j][0], bf[j][1]);
            mma_bf16(acc[i][2 * j + 1], af, bf[j][2], bf[j][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every product done: shared memory is the epilogue's

  // + bias, + vec, ReLU, one rounding, into os [channel][pixel]
  uint16_t* os = sm;
  const float* vec = a.vec ? a.vec + (size_t)b * a.Ctot + br.co : nullptr;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = wn * 32 + 8 * j + 2 * (lane & 3) + h;
      const int co = co0 + n;
      float add = 0.f;
      if (co < br.cout) {
        add = __ldg(br.b + co);
        if (vec) add += __ldg(vec + co);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int m = wm * 64 + 16 * i + (lane >> 2) + 8 * g;
          os[n * kOP + m] =
              f32_to_bf16_bits(fmaxf(acc[i][j][2 * g + h] + add, 0.f));
        }
      }
    }
  }
  __syncthreads();

  uint16_t* ob = a.out + ((size_t)b * a.Ctot + br.co + co0) * a.H * a.W +
                 (size_t)y * a.W;
  const int ncol = a.W - x0 < kTM ? a.W - x0 : kTM;
  if (vec_ok) {
    for (int i = tid; i < kTN * (kTM / 8); i += kThreads) {
      const int n = i / (kTM / 8), j = i - n * (kTM / 8);
      if (co0 + n < br.cout && 8 * j < ncol)
        *reinterpret_cast<uint4*>(ob + (size_t)n * a.H * a.W + x0 + 8 * j) =
            *reinterpret_cast<const uint4*>(os + n * kOP + 8 * j);
    }
  } else {
    for (int i = tid; i < kTN * kTM; i += kThreads) {
      const int n = i / kTM, m = i - n * kTM;
      if (co0 + n < br.cout && m < ncol)
        ob[(size_t)n * a.H * a.W + x0 + m] = os[n * kOP + m];
    }
  }
}

}  // namespace

// One launch of up to four branches over x. Per branch (arrays of nbr):
// w the packed weight (chw_ops.pack_weights, [k * k][np][kc] bf16, 16-byte
// aligned), b its f32 bias, k 1 or 3, dil >= 1, cout a multiple of 8 (np
// = cout rounded to 8, kc = Cin rounded to 16), co its first output channel
// of Ctot. Cin a multiple of 32; vec null or [B, Ctot] f32; P the widest
// branch's halo dil (k / 2) rounded up to 8, kmax the
// largest k; smem must be smem_bytes(P, kmax). Returns the cudaError_t of
// the launch (0 = ok).
extern "C" int segtpu_aspp(const void* x, const void* const* w,
                           const float* const* bias, const int* k,
                           const int* dil, const int* cout, const int* co,
                           int nbr, const float* vec, void* out, int B,
                           int Cin, int H, int W, int Ctot, int P, int kmax,
                           int smem, void* stream) {
  if (nbr < 1 || nbr > kMaxBranches || Cin < kKC || Cin % kKC || H < 1 ||
      W < 1 || B < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const uint16_t*>(x), vec, static_cast<uint16_t*>(out),
         B, Cin, H, W, Ctot, nbr, P, kmax, {}};
  int want_p = 0, want_k = 0, ny = 0;
  for (int i = 0; i < nbr; ++i) {
    if ((k[i] != 1 && k[i] != 3) || dil[i] < 1 || cout[i] < 8 ||
        cout[i] % 8 || co[i] < 0 || co[i] + cout[i] > Ctot ||
        reinterpret_cast<uintptr_t>(w[i]) % 16)
      return (int)cudaErrorInvalidValue;
    const int p = (dil[i] * (k[i] / 2) + 7) & ~7;
    want_p = p > want_p ? p : want_p;
    want_k = k[i] > want_k ? k[i] : want_k;
    const int t = (cout[i] + kTN - 1) / kTN;
    ny = t > ny ? t : ny;
    a.br[i] = Branch{static_cast<const uint16_t*>(w[i]), bias[i], k[i],
                     dil[i], cout[i], co[i], r8(cout[i]), r16(Cin)};
  }
  if (P != want_p || kmax != want_k || smem != smem_bytes(P, kmax) ||
      smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        aspp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long tiles = (long long)B * H * ((W + kTM - 1) / kTM);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, ny, nbr);
  aspp_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
