// K3 on Hopper: 3x3, stride 2, pad 1 conv for C_in = 32, + bias, mish or
// leaky, NHWC in and out.
//
// Replaces the TPU kernel double_yolo_kaist_tpu/ops/pallas_stem.py
// (_kernel_packed via stem_conv_s2_packed, and _kernel_acc /
// _kernel_scratch via stem_conv_s2). It computes what they compute: the
// conv summed in fp32, + bias in fp32, the activation in fp32, one rounding
// to the output type. mish is x * tanh(softplus(x)) with softplus written
// as max(x, 0) + log1p(exp(-|x|)), as the JAX package writes it.
//
// Bound on the H100: bytes. On the flagship (B, 512, 640, 32) -> (B, 256,
// 320, 64) in bf16 it reads 21 MB and writes 10.5 MB per image against
// 3 GFLOP, about 100 flops per byte, under the ~295 at which the bf16
// tensor cores become the limit. What the design does about it:
//   * the TPU kernel's 128-lane packing, halo DMA and even/odd carry exist
//     for the MXU's lane width and are not carried over: a block reads the
//     three input rows of one output row straight from device memory with
//     16-byte loads, zero-filling the pad, into shared memory;
//   * the 3*3*32*O weights are loaded into shared memory once per block,
//     and each block then walks many output tiles (a grid of a few blocks
//     per SM), so the weights cost no device-memory traffic per tile;
//   * bf16: the tile is an implicit GEMM (64 output pixels x O channels,
//     K = 288) on the tensor cores through WMMA 16x16x16 bf16 fragments
//     with fp32 accumulators. The stride-2 im2col is only a leading
//     dimension: the input row is stored as two planes, even and odd
//     columns, so the 16 pixels of an A fragment are 16 consecutive plane
//     entries for every tap kw (kw = 0, 2: even plane at p, p + 1; kw = 1:
//     odd plane at p). Plane entries, weight rows and accumulator rows are
//     padded (96, 160 and 288 bytes apart) so that a fragment's rows fall
//     in different shared-memory banks as far as WMMA's 32-byte pointer
//     alignment allows (2-way at most, against 8-way unpadded);
//   * fp32: the same tiling on the CUDA cores (fp32 FMA, no TF32), for the
//     fp32 path that the checks against the CPU run;
//   * bias and activation are applied in fp32 before the only store.
// Input pixels are read 1.5 times (adjacent output rows share an input
// row); that is the first thing to fix when the kernel is made fast.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int CIN = 32;                   // the gate: C_in == 32
constexpr int TILE_PX = 64;               // output pixels per tile (one row)
constexpr int WARPS = 4;                  // 16 output pixels per warp
constexpr int THREADS = WARPS * 32;
constexpr int IN_COLS = 2 * TILE_PX + 1;  // input columns one tile reads
constexpr int KTAPS = 9 * CIN;            // GEMM depth: (kh, kw, c)
constexpr int F32_CSTRIDE = CIN + 1;      // fp32 path: padded channel stride
constexpr int PLANE = TILE_PX + 1;        // entries of one column plane
constexpr int CS = CIN + 16;              // bf16 plane entry stride (96 B)

__host__ __device__ constexpr int w_stride(int op) { return op + 16; }
__host__ __device__ constexpr int acc_stride(int op) { return op + 8; }

size_t bf16_smem(int nf) {
  return (size_t)(3 * 2 * PLANE * CS + KTAPS * w_stride(nf * 16)) * 2 +
         (size_t)WARPS * 16 * acc_stride(nf * 16) * 4;
}

enum Act { ACT_LINEAR = 0, ACT_LEAKY = 1, ACT_MISH = 2 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_MISH) {
    const float sp = fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
    return v * tanhf(sp);
  }
  if (act == ACT_LEAKY) return fmaxf(v, 0.1f * v);
  return v;
}

__device__ __forceinline__ void decode_tile(int tile, int tiles_per_row,
                                            int Ho, int* b, int* oy,
                                            int* ox0) {
  const int tx = tile % tiles_per_row;
  const int row = tile / tiles_per_row;   // b * Ho + oy
  *oy = row % Ho;
  *b = row / Ho;
  *ox0 = tx * TILE_PX;
}

// bf16 in, bf16 out, tensor cores. NF = number of 16-wide output-channel
// fragments (O padded up to NF * 16 in shared memory).
template <int NF>
__global__ void __launch_bounds__(THREADS)
stem_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,  // [KTAPS][O]
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                 int B, int H, int W, int Ho, int Wo, int O, int act) {
  constexpr int OP = NF * 16;
  constexpr int WS = w_stride(OP), AS = acc_stride(OP);
  extern __shared__ __align__(128) unsigned char smem[];
  // in_s[row r][plane (col & 1)][col >> 1][CS]
  __nv_bfloat16* in_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w_s = in_s + 3 * 2 * PLANE * CS;                // [KTAPS][WS]
  float* out_s = reinterpret_cast<float*>(w_s + KTAPS * WS);     // [16][AS]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int i = tid; i < KTAPS * WS; i += THREADS) {
    const int k = i / WS, o = i - k * WS;
    w_s[i] = o < O ? w[k * O + o] : __float2bfloat16_rn(0.0f);
  }

  const int tiles_per_row = (Wo + TILE_PX - 1) / TILE_PX;
  const int ntiles = B * Ho * tiles_per_row;
  float* my_out = out_s + warp * 16 * AS;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    int b, oy, ox0;
    decode_tile(tile, tiles_per_row, Ho, &b, &oy, &ox0);
    const int ix0 = 2 * ox0 - 1;
    __syncthreads();  // weights stored / the last tile's reads are done
    // three input rows x IN_COLS columns x 32 channels, 16 bytes (8
    // channels) per load; rows and columns outside the image are the pad
    for (int i = tid; i < 3 * IN_COLS * 4; i += THREADS) {
      const int r = i / (IN_COLS * 4);
      const int rem = i - r * IN_COLS * 4;
      const int col = rem >> 2, q = rem & 3;
      const int iy = 2 * oy - 1 + r, ix = ix0 + col;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
        v = *reinterpret_cast<const uint4*>(
            x + ((static_cast<int64_t>(b) * H + iy) * W + ix) * CIN + q * 8);
      }
      *reinterpret_cast<uint4*>(
          in_s + ((r * 2 + (col & 1)) * PLANE + (col >> 1)) * CS + q * 8) = v;
    }
    __syncthreads();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.0f);
    const int px0 = warp * 16;
#pragma unroll 1
    for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        // output pixel p reads input column 2p + kw: plane kw & 1, entry
        // p + (kw >> 1)
        const __nv_bfloat16* a_base =
            in_s + ((kh * 2 + (kw & 1)) * PLANE + px0 + (kw >> 1)) * CS;
#pragma unroll
        for (int c0 = 0; c0 < CIN; c0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> a;
          wmma::load_matrix_sync(a, a_base + c0, CS);
          const __nv_bfloat16* wk = w_s + ((kh * 3 + kw) * CIN + c0) * WS;
#pragma unroll
          for (int j = 0; j < NF; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> bf;
            wmma::load_matrix_sync(bf, wk + j * 16, WS);
            wmma::mma_sync(acc[j], a, bf, acc[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::store_matrix_sync(my_out + j * 16, acc[j], AS, wmma::mem_row_major);
    }
    __syncwarp();
    // this warp's 16 pixels x O channels are contiguous in the output
    const int64_t base =
        ((static_cast<int64_t>(b) * Ho + oy) * Wo + ox0 + px0) * O;
    for (int e = lane; e < 16 * O; e += 32) {
      const int p = e / O, o = e - p * O;
      if (ox0 + px0 + p < Wo) {
        const float v = activate(my_out[p * AS + o] + bias[o], act);
        y[base + e] = __float2bfloat16_rn(v);
      }
    }
    __syncwarp();
  }
}

// fp32 in, fp32 out, CUDA cores. Thread t computes pixel t % 64 of the tile
// for half (t / 64) of the OP channels.
template <int NF>
__global__ void __launch_bounds__(THREADS)
stem_f32_kernel(const float* __restrict__ x,
                const float* __restrict__ w,  // [KTAPS][O]
                const float* __restrict__ bias, float* __restrict__ y, int B,
                int H, int W, int Ho, int Wo, int O, int act) {
  constexpr int OP = NF * 16;
  constexpr int HALF = OP / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  float* in_s = reinterpret_cast<float*>(smem);  // [3][IN_COLS][F32_CSTRIDE]
  float* w_s = in_s + 3 * IN_COLS * F32_CSTRIDE;  // [KTAPS][OP]

  const int tid = threadIdx.x;
  for (int i = tid; i < KTAPS * OP; i += THREADS) {
    const int k = i / OP, o = i - k * OP;
    w_s[i] = o < O ? w[k * O + o] : 0.0f;
  }
  const int px = tid % TILE_PX;
  const int o0 = (tid / TILE_PX) * HALF;

  const int tiles_per_row = (Wo + TILE_PX - 1) / TILE_PX;
  const int ntiles = B * Ho * tiles_per_row;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    int b, oy, ox0;
    decode_tile(tile, tiles_per_row, Ho, &b, &oy, &ox0);
    const int ix0 = 2 * ox0 - 1;
    __syncthreads();
    for (int i = tid; i < 3 * IN_COLS * CIN; i += THREADS) {
      const int r = i / (IN_COLS * CIN);
      const int rem = i - r * IN_COLS * CIN;
      const int col = rem / CIN, c = rem - col * CIN;
      const int iy = 2 * oy - 1 + r, ix = ix0 + col;
      float v = 0.0f;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
        v = x[((static_cast<int64_t>(b) * H + iy) * W + ix) * CIN + c];
      }
      in_s[(r * IN_COLS + col) * F32_CSTRIDE + c] = v;
    }
    __syncthreads();

    float acc[HALF];
#pragma unroll
    for (int o = 0; o < HALF; ++o) acc[o] = 0.0f;
#pragma unroll 1
    for (int kh = 0; kh < 3; ++kh) {
#pragma unroll 1
      for (int kw = 0; kw < 3; ++kw) {
        const float* xin = in_s + (kh * IN_COLS + 2 * px + kw) * F32_CSTRIDE;
        const float* wk = w_s + (kh * 3 + kw) * CIN * OP + o0;
#pragma unroll 4
        for (int c = 0; c < CIN; ++c) {
          const float xv = xin[c];
#pragma unroll
          for (int o = 0; o < HALF; ++o) {
            acc[o] = fmaf(xv, wk[c * OP + o], acc[o]);
          }
        }
      }
    }
    const int ox = ox0 + px;
    if (ox < Wo) {
      float* dst = y + ((static_cast<int64_t>(b) * Ho + oy) * Wo + ox) * O;
#pragma unroll
      for (int o = 0; o < HALF; ++o) {
        if (o0 + o < O) dst[o0 + o] = activate(acc[o] + bias[o0 + o], act);
      }
    }
  }
}

int launch(const void* kernel_fn, size_t smem, int ntiles, cudaStream_t st,
           void** args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_fn,
                                                    THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int blocks = sms * per_sm;
  if (blocks > ntiles) blocks = ntiles;
  e = cudaLaunchKernel(kernel_fn, dim3(blocks), dim3(THREADS), args, smem,
                       st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int NF>
int run(const void* x, int is_bf16, const void* w, const float* bias,
        void* y, int B, int H, int W, int O, int act, cudaStream_t st) {
  int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const int ntiles = B * Ho * ((Wo + TILE_PX - 1) / TILE_PX);
  void* args[] = {(void*)&x, (void*)&w, (void*)&bias, (void*)&y, &B, &H,
                  &W, &Ho, &Wo, &O, &act};
  if (is_bf16) {
    return launch((const void*)stem_bf16_kernel<NF>, bf16_smem(NF), ntiles,
                  st, args);
  }
  const size_t smem = (3 * IN_COLS * F32_CSTRIDE + KTAPS * NF * 16) * 4;
  return launch((const void*)stem_f32_kernel<NF>, smem, ntiles, st, args);
}

}  // namespace

extern "C" const char* dyk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x: (B, H, W, 32) contiguous, bf16 (is_bf16) or fp32; w: (3, 3, 32, O)
// contiguous ([kh][kw][c][o]) in x's type; bias: (O,) fp32; y: (B, Ho, Wo,
// O) contiguous in x's type, Ho = ceil(H / 2), Wo = ceil(W / 2). act: 0
// linear, 1 leaky, 2 mish. 1 <= O <= 128. Returns the launch's cudaError_t.
extern "C" int dyk_stem_conv_s2(const void* x, int is_bf16, const void* w,
                                const float* bias, void* y, int B, int H,
                                int W, int O, int act, void* stream) {
  if (B < 1 || H < 1 || W < 1 || O < 1 || O > 128 || act < 0 || act > 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch ((O + 15) / 16) {
    case 1: return run<1>(x, is_bf16, w, bias, y, B, H, W, O, act, st);
    case 2: return run<2>(x, is_bf16, w, bias, y, B, H, W, O, act, st);
    case 3: return run<3>(x, is_bf16, w, bias, y, B, H, W, O, act, st);
    case 4: return run<4>(x, is_bf16, w, bias, y, B, H, W, O, act, st);
    case 5: return run<5>(x, is_bf16, w, bias, y, B, H, W, O, act, st);
    case 6: return run<6>(x, is_bf16, w, bias, y, B, H, W, O, act, st);
    case 7: return run<7>(x, is_bf16, w, bias, y, B, H, W, O, act, st);
    default: return run<8>(x, is_bf16, w, bias, y, B, H, W, O, act, st);
  }
}
