// K4 on Hopper: int8 x int8 -> int32 GEMM with the dequant -> activation
// -> requant epilogue of a quantized 1x1 conv.
//
// Replaces the TPU kernel double_yolo_kaist_tpu/ops/pallas_qgemm.py
// (_kernel via qgemm, epilogue _epilogue). x (M, K) s8 row-major times
// w (K, N) s8 row-major, summed exactly in int32; then, in the output type
// T (bf16 or fp32), op by op as the plain PyTorch version runs them:
//   y = T(acc) * T(scale) + T(bias);  y = act(y);
//   optionally q = clamp(round(y * T(out_inv_s)), -127, 127) -> s8.
// Each op rounds to T (bf16 ops are computed in fp32 and rounded to bf16,
// as PyTorch computes them), with no FMA contraction, so the kernel and the
// plain version agree bit for bit where expf/log1pf/tanhf agree. T(acc)
// goes through fp32 first, as PyTorch's int32 -> bf16 cast does.
//
// Bound on the H100: bytes. On the flagship's ten chain 1x1 convs (K 256 to
// 1024, N 128 to 512) the products are 100 to 340 int8 operations per byte
// moved, near the int8 tensor cores' balance point (~590), and the whole
// int8 forward keeps these tensors at one byte per element. What the
// design does about it, simple first:
//   * a block computes a 64 x 64 output tile on the tensor cores with WMMA
//     16x16x16 s8 fragments (int32 accumulators), 4 warps of 32 x 32;
//   * x and w tiles (64 deep) are staged in shared memory with 16-byte
//     loads, each stored as 16-byte-wide k (or n) slabs so that every
//     fragment pointer is 32-byte aligned as WMMA requires;
//   * the epilogue runs on the int32 tile in shared memory and writes the
//     output (s8 when requantizing) once, coalesced along N: the bf16
//     intermediate of the unfused path never reaches device memory.
// Not yet: a pipelined (cp.async / TMA) k loop, wgmma, larger tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 64;
constexpr int THREADS = 128;

enum Act { ACT_LINEAR = 0, ACT_LEAKY = 1, ACT_MISH = 2, ACT_RELU = 3,
           ACT_RELU6 = 4 };

// one op of the epilogue in the output type: fp32 as it is, bf16 rounded
// to nearest even after every op
template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool BF16>
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case ACT_LEAKY:  // 0.1 in the output type, as JAX's weak scalar
      return fmaxf(v, rnd<BF16>(__fmul_rn(v, rnd<BF16>(0.1f))));
    case ACT_MISH: {
      // x * tanh(max(x, 0) + log1p(exp(-|x|))), each op rounded
      const float e = rnd<BF16>(expf(-fabsf(v)));
      const float l = rnd<BF16>(log1pf(e));
      const float sp = rnd<BF16>(__fadd_rn(fmaxf(v, 0.0f), l));
      const float t = rnd<BF16>(tanhf(sp));
      return rnd<BF16>(__fmul_rn(v, t));
    }
    case ACT_RELU:
      return fmaxf(v, 0.0f);
    case ACT_RELU6:
      return fminf(fmaxf(v, 0.0f), 6.0f);
    default:
      return v;
  }
}

template <bool BF16, bool REQUANT>
__global__ void __launch_bounds__(THREADS)
qgemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ scale, const float* __restrict__ bias,
             void* __restrict__ out, int M, int K, int N, int act,
             float out_inv) {
  // xs: (BK/16) slabs of (BM rows x 16 k); ws: (BN/16) slabs of (BK rows x
  // 16 n); cs: the int32 tile
  __shared__ __align__(128) int8_t xs[BK / 16][BM][16];
  __shared__ __align__(128) int8_t ws[BN / 16][BK][16];
  __shared__ __align__(128) int32_t cs[BM][BN];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;    // the warp's 32 x 32 quadrant
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // BM rows x BK bytes of x and BK rows x BN bytes of w, 16 bytes a load
    for (int i = tid; i < BM * (BK / 16); i += THREADS) {
      const int r = i / (BK / 16), q = i % (BK / 16);
      const int m = m0 + r, k = k0 + q * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && k < K) {
        v = *reinterpret_cast<const uint4*>(x + static_cast<int64_t>(m) * K +
                                            k);
      }
      *reinterpret_cast<uint4*>(&xs[q][r][0]) = v;
    }
    for (int i = tid; i < BK * (BN / 16); i += THREADS) {
      const int r = i / (BN / 16), q = i % (BN / 16);
      const int k = k0 + r, n = n0 + q * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < K && n < N) {
        v = *reinterpret_cast<const uint4*>(w + static_cast<int64_t>(k) * N +
                                            n);
      }
      *reinterpret_cast<uint4*>(&ws[q][r][0]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(a[i], &xs[kk][wm * 32 + i * 16][0], 16);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(b[j], &ws[wn * 2 + j][kk * 16][0], 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j],
                                                   acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(&cs[wm * 32 + i * 16][wn * 32 + j * 16],
                              acc[i][j], BN, wmma::mem_row_major);
    }
  __syncthreads();

  const float inv = rnd<BF16>(out_inv);
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float y = rnd<BF16>(__int2float_rn(cs[r][c]));
    y = rnd<BF16>(__fmul_rn(y, rnd<BF16>(scale[n])));
    y = rnd<BF16>(__fadd_rn(y, rnd<BF16>(bias[n])));
    y = activate<BF16>(y, act);
    const int64_t o = static_cast<int64_t>(m) * N + n;
    if (REQUANT) {
      float q = rintf(rnd<BF16>(__fmul_rn(y, inv)));
      q = fminf(fmaxf(q, -127.0f), 127.0f);
      static_cast<int8_t*>(out)[o] = static_cast<int8_t>(q);
    } else if (BF16) {
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
    } else {
      static_cast<float*>(out)[o] = y;
    }
  }
}

template <bool BF16, bool REQUANT>
int launch(const int8_t* x, const int8_t* w, const float* scale,
           const float* bias, void* out, int M, int K, int N, int act,
           float out_inv, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qgemm_kernel<BF16, REQUANT><<<grid, THREADS, 0, st>>>(
      x, w, scale, bias, out, M, K, N, act, out_inv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* dyk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x: (M, K) s8 contiguous; w: (K, N) s8 contiguous; scale, bias: (N,) fp32.
// out: (M, N) contiguous, s8 if requant else bf16 (is_bf16) or fp32; the
// epilogue computes in bf16 (is_bf16) or fp32 either way. act: 0 linear,
// 1 leaky, 2 mish, 3 relu, 4 relu6. K and N multiples of 16. Returns the
// launch's cudaError_t.
extern "C" int dyk_qgemm(const int8_t* x, const int8_t* w, const float* scale,
                         const float* bias, void* out, int M, int K, int N,
                         int act, int is_bf16, int requant, float out_inv,
                         void* stream) {
  if (M < 1 || K < 16 || N < 16 || K % 16 || N % 16 || act < 0 || act > 4 ||
      (M + BM - 1) / BM > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    return requant
        ? launch<true, true>(x, w, scale, bias, out, M, K, N, act, out_inv, st)
        : launch<true, false>(x, w, scale, bias, out, M, K, N, act, out_inv,
                              st);
  }
  return requant
      ? launch<false, true>(x, w, scale, bias, out, M, K, N, act, out_inv, st)
      : launch<false, false>(x, w, scale, bias, out, M, K, N, act, out_inv,
                             st);
}
