// K1 on Hopper: fused YOLO head decode, every head of a forward in one
// launch.
//
// Replaces the TPU kernel double_yolo_kaist_tpu/ops/pallas_decode.py
// (_decode_kernel, via pallas_decode_head / decode_head_pallas) and computes
// exactly double_yolo_kaist_tpu/models/graph.py::decode_head:
//   v3: xy = sigmoid(p) + grid,          wh = exp(p) * anchor
//   v4: xy = 2 sigmoid(p) - 0.5 + grid,  wh = (2 sigmoid(p))^2 * anchor
//   then xy, wh times the stride; obj and cls through sigmoid.
//
// Bound on the H100: bytes, a few MB per batch (bf16 or fp32 in, fp32 out,
// a few flops each), so little that the launches themselves were most of
// its time. What the design does about it:
//   * one launch decodes up to four heads: their parameters come by value,
//     each head owns a run of the grid's blocks, and each writes fp32 rows
//     straight into its slice of the concatenated (bs, sum of rows, no)
//     output, which saves the torch.cat. Grid offsets and anchors come from
//     the cell index and the arguments: no geometry table in device memory
//     (the TPU kernel read one);
//   * the fast path, for the layout the model produces (channels-last bf16,
//     no = 6, ny * nx a multiple of 4): a block takes 32 consecutive cells
//     of one image (the last block of an image fewer, a multiple of 4, as
//     for the 13x16 head of a 416x512 eval batch). Their na * 6 values each
//     are contiguous (1152 bytes for three anchors) and come in as 16-byte
//     loads into shared memory; warp
//     a then decodes anchor a, a lane a cell: the six values of a row have
//     their place in the formula fixed at compile time, so a value costs
//     its expf and its division and little else (the kernel is a few
//     microseconds of launch and of arithmetic, not of bandwidth: with four
//     values of any place a thread, 75 instructions a value, it took a
//     third longer). The rows go through shared memory once more, which
//     turns them from cell-major to anchor-major, and each anchor's 32 rows
//     x 24 bytes = 768 contiguous bytes leave as 16-byte stores,
//     consecutive threads consecutive addresses. One division a block
//     places the cells on the grid;
//   * any other input (NCHW strides, fp32, a grid of cells no multiple of
//     4, another `no`, a misaligned base) takes the general path in the
//     same launch: one thread per (image, anchor, cell) row reading through
//     the strides,
//     which folds reshape_head's transpose into the load. The host picks
//     the path per head from shape, strides and alignment.
// expf and the division are libm's: real heads reach |p| of 20 and more,
// where the fast intrinsics are off by tens of ulp.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define DYK_MAX_ANCHORS 16
#define DYK_MAX_HEADS 4
#define DYK_FAST_MAX_ANCHORS 4
#define DYK_FAST_NO 6

// One head: x is the head conv's output, element strides (s0, s1, s2, s3)
// of its (bs, na * no, ny, nx) shape; anchors (w, h) in grid units; the
// head writes rows [row_offset, row_offset + na * ny * nx) of each image
// and owns blocks [first_block, first_block + its count) of the grid.
struct Head {
  const void* x;
  long long s0, s1, s2, s3;
  long long row_offset;
  int na, ny, nx;
  int is_bf16, v4, fast;
  int first_block;
  float stride;
  float wh[2 * DYK_MAX_ANCHORS];
};

struct Heads {
  Head h[DYK_MAX_HEADS];
  int n, bs, no, nblocks;
  float* out;
  long long out_batch_stride;
};

namespace {

// a block of the fast path takes 32 cells, a warp for each of up to four
// anchors
constexpr int THREADS = 32 * DYK_FAST_MAX_ANCHORS;
constexpr int MAX_GENERAL_BLOCKS = 132 * 16;
// a block's patch: 32 cells x up to 4 anchors x 6 bf16
constexpr int PATCH_BYTES = 32 * DYK_FAST_MAX_ANCHORS * DYK_FAST_NO * 2;

__device__ __forceinline__ float load_f32(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// value k of a row from its raw p: k 0, 1 are x, y (grid = gx or gy), k 2,
// 3 are w, h (anchor = its w or h), the rest obj and classes
__device__ __forceinline__ float decode_value(float p, int k, int v4,
                                              float grid, float anchor,
                                              float stride) {
  if (v4) {
    const float s = sigmoid_f32(p);
    if (k < 2) return (s * 2.0f - 0.5f + grid) * stride;
    if (k < 4) {
      const float t = s * 2.0f;
      return (t * t * anchor) * stride;
    }
    return s;
  }
  if (k < 2) return (sigmoid_f32(p) + grid) * stride;
  if (k < 4) return (expf(p) * anchor) * stride;
  return sigmoid_f32(p);
}

// General path: one thread per (image, anchor, cell) row, through strides.
template <typename T>
__device__ void decode_general(const Head& h, int block, int nblocks, int bs,
                               int no, float* __restrict__ out,
                               long long out_batch_stride) {
  const T* __restrict__ x = static_cast<const T*>(h.x);
  const int cells = h.ny * h.nx;
  const int rows_per_image = h.na * cells;
  const int rows = bs * rows_per_image;
  for (int r = block * THREADS + threadIdx.x; r < rows;
       r += nblocks * THREADS) {
    const int b = r / rows_per_image;
    const int row = r - b * rows_per_image;   // a * cells + gy * nx + gx
    const int a = row / cells;
    const int cell = row - a * cells;
    const int gy = cell / h.nx;
    const int gx = cell - gy * h.nx;
    const T* src = x + b * h.s0 + (int64_t)(a * no) * h.s1 + gy * h.s2 +
                   gx * h.s3;
    float* dst = out + b * out_batch_stride + (h.row_offset + row) * no;
    for (int k = 0; k < no; ++k) {
      dst[k] = decode_value(load_f32(src, (int64_t)k * h.s1), k, h.v4,
                            (float)(k == 0 ? gx : gy), h.wh[2 * a + (k & 1)],
                            h.stride);
    }
  }
}

// Fast path: block `item` of the head takes cells 32 c ... 32 c + n - 1 of
// image b, item = b * ceil(cells / 32) + c, n = min(32, cells - 32 c), a
// multiple of 4 (cells is). Channels-last bf16, no = 6.
__device__ void decode_fast(const Head& h, int item,
                            float* __restrict__ out,
                            long long out_batch_stride) {
  constexpr int NO = DYK_FAST_NO;
  __shared__ __align__(16) unsigned char patch[PATCH_BYTES];
  __shared__ __align__(16) float rows[DYK_FAST_MAX_ANCHORS][32 * NO];
  const int t = threadIdx.x;
  const int a = t >> 5, lane = t & 31;
  const int cells = h.ny * h.nx;
  const int chunks_per_image = (cells + 31) >> 5;
  const int b = item / chunks_per_image;
  const int cell0 = (item - b * chunks_per_image) << 5;
  const int n = min(32, cells - cell0);       // cells of this block
  const int rec = h.na * NO;                  // values of a cell
  const uint4* src = reinterpret_cast<const uint4*>(
      static_cast<const __nv_bfloat16*>(h.x) + b * h.s0 +
      static_cast<int64_t>(cell0) * rec);
  const int n_in = n * rec / 8;               // n cells x rec x 2 B / 16 B
  if (t < n_in) reinterpret_cast<uint4*>(patch)[t] = __ldg(src + t);
  __syncthreads();
  if (a < h.na && lane < n) {                 // anchor a of cell cell0 + lane
    const int gy0 = cell0 / h.nx;
    int gx = cell0 - gy0 * h.nx + lane, gy = gy0;
    while (gx >= h.nx) {
      gx -= h.nx;
      ++gy;
    }
    const __nv_bfloat162* raw = reinterpret_cast<const __nv_bfloat162*>(
        patch + (lane * rec + a * NO) * 2);
    float v[NO];
#pragma unroll
    for (int k = 0; k < NO; k += 2) {
      const float2 p = __bfloat1622float2(raw[k / 2]);
      v[k] = decode_value(p.x, k, h.v4, (float)gx, h.wh[2 * a], h.stride);
      v[k + 1] = decode_value(p.y, k + 1, h.v4, (float)gy, h.wh[2 * a + 1],
                              h.stride);
    }
    float2* row = reinterpret_cast<float2*>(rows[a] + lane * NO);
    row[0] = make_float2(v[0], v[1]);
    row[1] = make_float2(v[2], v[3]);
    row[2] = make_float2(v[4], v[5]);
  }
  __syncthreads();
  // anchor a's n rows are n * 6 floats = 1.5 n float4, contiguous in out
  float* dst0 = out + b * out_batch_stride + (h.row_offset + cell0) * NO;
  const int per = n * NO / 4;
  for (int i = t; i < h.na * per; i += THREADS) {
    const int a2 = i / per, f = i - a2 * per;
    *reinterpret_cast<float4*>(dst0 + static_cast<int64_t>(a2) * cells * NO +
                               4 * f) =
        *reinterpret_cast<const float4*>(rows[a2] + 4 * f);
  }
}

__global__ void __launch_bounds__(THREADS)
decode_heads_kernel(const __grid_constant__ Heads p) {
  int i = 0;
#pragma unroll
  for (int j = 1; j < DYK_MAX_HEADS; ++j) {
    if (j < p.n && (int)blockIdx.x >= p.h[j].first_block) i = j;
  }
  const Head& h = p.h[i];
  const int block = blockIdx.x - h.first_block;
  const int nblocks =
      (i + 1 < p.n ? p.h[i + 1].first_block : p.nblocks) - h.first_block;
  if (h.fast) {
    decode_fast(h, block, p.out, p.out_batch_stride);
  } else if (h.is_bf16) {
    decode_general<__nv_bfloat16>(h, block, nblocks, p.bs, p.no, p.out,
                                  p.out_batch_stride);
  } else {
    decode_general<float>(h, block, nblocks, p.bs, p.no, p.out,
                          p.out_batch_stride);
  }
}

}  // namespace

extern "C" const char* dyk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Decodes heads p->h[0 .. n) of a batch of bs images into out (fp32,
// out_batch_stride elements per image, `no` values a row). The caller fills
// everything but first_block and nblocks, and sets `fast` only for a head
// that is channels-last and dense (s1 = 1, s3 = na * no, s2 = nx * s3, s0 =
// ny * s2), bf16, no = 6, na <= 4, ny * nx a multiple of 4, with x 16-byte
// aligned and every row run of out 16-byte aligned (out itself, an even
// row_offset, out_batch_stride a multiple of 4). Returns cudaGetLastError().
extern "C" int dyk_decode_heads(Heads* p, void* stream) {
  if (p->n < 1 || p->n > DYK_MAX_HEADS || p->bs < 0 || p->no < 5) {
    return (int)cudaErrorInvalidValue;
  }
  long long blocks = 0;
  for (int i = 0; i < p->n; ++i) {
    Head& h = p->h[i];
    if (h.na < 1 || h.na > DYK_MAX_ANCHORS || h.ny < 0 || h.nx < 0) {
      return (int)cudaErrorInvalidValue;
    }
    const long long cells = (long long)h.ny * h.nx;
    long long need;
    if (h.fast) {
      if (h.na > DYK_FAST_MAX_ANCHORS || p->no != DYK_FAST_NO || cells % 4 ||
          !h.is_bf16) {
        return (int)cudaErrorInvalidValue;
      }
      need = p->bs * ((cells + 31) / 32);
    } else {
      need = (p->bs * h.na * cells + THREADS - 1) / THREADS;
      if (need > MAX_GENERAL_BLOCKS) need = MAX_GENERAL_BLOCKS;
    }
    h.first_block = (int)blocks;
    blocks += need;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p->nblocks = (int)blocks;
  if (blocks == 0) return 0;
  decode_heads_kernel<<<(int)blocks, THREADS, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}
