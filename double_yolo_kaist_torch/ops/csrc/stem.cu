// K3 on Hopper: 3x3, stride 2, pad 1 conv for C_in = 32, + bias, mish or
// leaky, NHWC in and out; and the probe variants of the same kernel.
//
// Replaces the TPU kernel double_yolo_kaist_tpu/ops/pallas_stem.py
// (_kernel_packed via stem_conv_s2_packed, and _kernel_acc /
// _kernel_scratch via stem_conv_s2). It computes what they compute: the
// conv summed in fp32, + bias in fp32, the activation in fp32, one rounding
// to the output type. The probe entry (dyk_stem_probe) is the counterpart of
// tools/archive/stem_probe.py ... stem_probe4.py: the same kernel with
// stages left out, to show where its time goes.
//
// Bound on the H100: bytes. On the flagship (B, 512, 640, 32) -> (B, 256,
// 320, 64) in bf16 it reads 21 MB and writes 10.5 MB per image against
// 3 GFLOP, about 100 flops per byte, under the ~295 at which the bf16
// tensor cores become the limit. So the design is about moving each byte
// once, never waiting for it, and spending few operations beside it (with
// one warpgroup a block the schedulers' rate, not the memory, was the first
// limit that showed). The bf16 path, stem_wg_kernel:
//   * a block is one warpgroup that owns a vertical strip segment: 64
//     output columns of one image, a run of output rows chosen on the host
//     so that all blocks fit the card in one wave. It walks the rows top to
//     bottom over a ring of 5 input rows in shared memory. An output row
//     needs two new input rows and reuses one, so within a segment every
//     input row is read once (plus a one-column halo per strip and a one-row
//     halo per segment);
//   * the ring is filled by cp.async (16 bytes a thread through L1, whose
//     128-byte lines the 8 copies of a quarter-warp fill whole; zero fill
//     for the pad on all four sides, so odd H and W need no second path),
//     one output row ahead of the MMAs; a step waits for its own group,
//     fences the async proxy and meets one block barrier, the only one of
//     the step. What a thread copies of a row does not depend on the row and
//     is worked out once a block. Loads of a block overlap its own MMAs and
//     epilogue, and two blocks share an SM. This is the cp.async rung. The
//     TMA rung (a tensor map over (B, H, W / 2, 2, 32)) was not built: it
//     exists only for even W, and with this loader the load-and-store probe
//     already moves the conv's bytes at about 2.7 TB/s (NVIDIA H100 80GB
//     HBM3 at 700 W, chip_smoke.py);
//   * the tile is an implicit GEMM, 64 pixels x NP channels x K 288, as 18
//     wgmma m64nNPk16 with A and B read from shared memory by descriptor
//     and fp32 accumulators in registers. Both operands lie in wgmma's
//     unswizzled K-major layout of 8-row x 16-byte core matrices: a ring row
//     is stored as two column planes (the stride-2 im2col is then a plane
//     choice and a one-entry shift of the descriptor's start) of four
//     8-channel chunks, each chunk holding its 65 entries 16 bytes apart,
//     so a core matrix is 128 contiguous bytes (no bank conflict for the
//     MMA) and the chunk and plane strides (1040 and 4160 bytes) put the 8
//     copies of a quarter-warp, which are coalesced in device memory, in 8
//     different bank groups. The weights are packed on the host once as
//     [36 k-chunks][NP][8] and stay in shared memory for the block's life;
//   * the epilogue works on the accumulator registers: bias, activation,
//     pack to bf16 pairs, a per-warp staging tile in shared memory (padded
//     rows, conflict free), then 16-byte stores, 512 contiguous bytes a
//     warp store, at offsets worked out once a block. mish is one
//     ex2.approx and one rcp.approx, ten operations a value: with e =
//     exp(x), n = e (e + 2), tanh(softplus(x)) = n / (n + 2); it agrees with
//     the exact form far inside a bf16 ulp. The activation is a template
//     parameter, so a kernel carries one epilogue.
// The fp32 path (stem_f32_kernel, CUDA cores, exact mish) is the one the
// comparisons with the CPU run; it keeps the simple one-tile-per-row form.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CIN = 32;                   // the gate: C_in == 32
constexpr int TILE_PX = 64;               // output pixels per tile (one row)
constexpr int THREADS = 128;              // one warpgroup
constexpr int IN_COLS = 2 * TILE_PX + 1;  // input columns one tile reads
constexpr int KTAPS = 9 * CIN;            // GEMM depth: (kh, kw, c)
constexpr int KCHUNKS = KTAPS / 8;        // 16-byte chunks along K
constexpr int F32_CSTRIDE = CIN + 1;      // fp32 path: padded channel stride

// bf16 path: the ring of input rows
constexpr int ENTRIES = TILE_PX + 1;      // entries of one column plane
constexpr int CHUNK_B = ENTRIES * 16;     // bytes of one 8-channel chunk
constexpr int PLANE_B = 4 * CHUNK_B;      // bytes of one column plane
constexpr int ROW_B = 2 * PLANE_B;        // bytes of one ring row
constexpr int DEPTH = 1;                  // output rows loaded ahead (2 and 3
                                          // measured no faster)
constexpr int NSLOT = 2 * DEPTH + 3;      // ring rows: 3 in use, 2 DEPTH ahead
constexpr int FIXED_ROWS = 8;             // a block's set-up cost, in input rows

enum Act { ACT_LINEAR = 0, ACT_LEAKY = 1, ACT_MISH = 2 };
enum Mode { MODE_FULL = 0, MODE_LOAD = 1, MODE_STORE = 2, MODE_COPY = 3,
            MODE_MMA = 4 };

__host__ __device__ constexpr int wg_w_bytes(int np) { return KCHUNKS * np * 16; }
__host__ __device__ constexpr int wg_stage_row(int np) { return np * 2 + 16; }
__host__ __device__ constexpr int wg_smem(int np) {
  return wg_w_bytes(np) + NSLOT * ROW_B + 4 * 16 * wg_stage_row(np);
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_MISH) {
    const float sp = fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
    return v * tanhf(sp);
  }
  if (act == ACT_LEAKY) return fmaxf(v, 0.1f * v);
  return v;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// mish with one exponential and one reciprocal (see the note above): ten
// operations a value. The exponent is cut at 2^60, where n / (n + 2) has
// long been 1 in fp32, so that n stays finite.
__device__ __forceinline__ float mish_fast(float v) {
  const float e = ex2_approx(fminf(v * 1.4426950408889634f, 60.0f));
  const float n = e * (e + 2.0f);
  return v * (n * rcp_approx(n + 2.0f));
}

template <int ACT>
__device__ __forceinline__ float activate_fast(float v) {
  if (ACT == ACT_MISH) return mish_fast(v);
  if (ACT == ACT_LEAKY) return fmaxf(v, 0.1f * v);
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros (the pad)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// what this thread wrote to shared memory becomes visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// wgmma shared-memory descriptor, no swizzle, K-major: core matrices of 8
// rows x 16 bytes, 128 contiguous bytes each; lbo = bytes between the two
// core matrices along K, sbo = bytes between 8-row groups along M or N.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

#define DYK_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define DYK_ACC16(i) \
  DYK_ACC4(i), DYK_ACC4(i + 4), DYK_ACC4(i + 8), DYK_ACC4(i + 12)

// d (64 x NP, fp32, NP / 2 registers a thread) = or += A (64 x 16) B (16 x
// NP), both bf16 from shared memory, K-major.
template <int NP>
__device__ __forceinline__ void wgmma_bf16(float (&d)[NP / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  static_assert(NP == 32 || NP == 64 || NP == 128, "unsupported width");
  if constexpr (NP == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : DYK_ACC16(0)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  if constexpr (NP == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : DYK_ACC16(0), DYK_ACC16(16)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  if constexpr (NP == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : DYK_ACC16(0), DYK_ACC16(16), DYK_ACC16(32), DYK_ACC16(48)
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// Byte offset inside a ring row of the 16-byte chunk q (8 channels) of input
// column ix0 + col: plane col & 1, entry col >> 1.
__device__ __forceinline__ int ring_offset(int col, int q) {
  return (col & 1) * PLANE_B + q * CHUNK_B + (col >> 1) * 16;
}

// What a thread copies of every ring row: chunks t, t + 128, ... of the
// row's 129 x 4, so that consecutive threads read consecutive 16 bytes. The
// offsets do not depend on the row and are worked out once.
constexpr int ROW_CHUNKS = IN_COLS * 4;
constexpr int CHUNKS_PER_THREAD = (ROW_CHUNKS + THREADS - 1) / THREADS;

struct RowCopy {
  int src[CHUNKS_PER_THREAD];       // element offset inside the input row
  uint32_t dst[CHUNKS_PER_THREAD];  // byte offset inside the ring row
  uint32_t in_row;                  // bit c: chunk c exists
  uint32_t in_image;                // bit c: its column is inside the image
};

__device__ __forceinline__ RowCopy make_row_copy(int tid, int ix0, int W) {
  RowCopy rc;
  rc.in_row = rc.in_image = 0;
#pragma unroll
  for (int c = 0; c < CHUNKS_PER_THREAD; ++c) {
    const int i = tid + c * THREADS;
    const int col = i >> 2, q = i & 3;
    const int ix = ix0 + col;
    const bool inside = i < ROW_CHUNKS && ix >= 0 && ix < W;
    rc.src[c] = inside ? ix * CIN + q * 8 : 0;
    rc.dst[c] = ring_offset(col, q);
    rc.in_row |= (i < ROW_CHUNKS ? 1u : 0u) << c;
    rc.in_image |= (inside ? 1u : 0u) << c;
  }
  return rc;
}

// Input row iy of image xb into the ring row at dst_row. Rows and columns
// outside the image are zero filled.
__device__ __forceinline__ void load_row(const RowCopy& rc, uint32_t dst_row,
                                         const __nv_bfloat16* xb, int iy,
                                         int H, int W) {
  const bool row_ok = iy >= 0 && iy < H;
  const __nv_bfloat16* src_row =
      xb + (row_ok ? static_cast<int64_t>(iy) * W * CIN : 0);
#pragma unroll
  for (int c = 0; c < CHUNKS_PER_THREAD; ++c) {
    if ((rc.in_row >> c) & 1u) {
      cp_async16(dst_row + rc.dst[c], src_row + rc.src[c],
                 (row_ok && ((rc.in_image >> c) & 1u)) ? 16u : 0u);
    }
  }
}

// The load probe's checksum: the sum of the 16-bit patterns of the chunks
// this thread copied into the ring row at `row`.
__device__ __forceinline__ uint32_t sum_row(const RowCopy& rc,
                                            const unsigned char* row) {
  uint32_t s = 0;
#pragma unroll
  for (int c = 0; c < CHUNKS_PER_THREAD; ++c) {
    if ((rc.in_row >> c) & 1u) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + rc.dst[c]);
      s += (v.x & 0xFFFFu) + (v.x >> 16) + (v.y & 0xFFFFu) + (v.y >> 16) +
           (v.z & 0xFFFFu) + (v.z >> 16) + (v.w & 0xFFFFu) + (v.w >> 16);
    }
  }
  return s;
}

// Accumulators -> + bias, activation -> bf16 pairs in the warp's staging
// tile [16 pixels][SROW bytes]. Lane l holds, for every 8-channel block j,
// channels 8 j + 2 (l % 4) + {0, 1} of pixels l / 4 and l / 4 + 8.
template <int NP, int ACT>
__device__ __forceinline__ void stage_acc(const float (&d)[NP / 2],
                                          const float (&bia)[NP / 4],
                                          unsigned char* st, int lane) {
  constexpr int SROW = wg_stage_row(NP);
  unsigned char* lo = st + (lane >> 2) * SROW + (lane & 3) * 4;
  unsigned char* hi = lo + 8 * SROW;
#pragma unroll
  for (int j = 0; j < NP / 8; ++j) {
    const float v0 = activate_fast<ACT>(d[4 * j] + bia[2 * j]);
    const float v1 = activate_fast<ACT>(d[4 * j + 1] + bia[2 * j + 1]);
    const float v2 = activate_fast<ACT>(d[4 * j + 2] + bia[2 * j]);
    const float v3 = activate_fast<ACT>(d[4 * j + 3] + bia[2 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(lo + j * 16) =
        __floats2bfloat162_rn(v0, v1);
    *reinterpret_cast<__nv_bfloat162*>(hi + j * 16) =
        __floats2bfloat162_rn(v2, v3);
  }
}

__device__ __forceinline__ int next_slot(int slot, int by) {
  slot += by;
  return slot >= NSLOT ? slot - NSLOT : slot;
}

// bf16 in, bf16 out, wgmma. NP: O padded to 32, 64 or 128 in shared memory.
// MODE_FULL is the conv with activation ACT; the other modes are the probes
// (see dyk_stem_probe). Block (b, strip, seg) computes output rows seg *
// seg_rows ... of columns strip * 64 ... of image b.
template <int NP, int MODE, int ACT>
__global__ void __launch_bounds__(THREADS)
stem_wg_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ wp,  // [KCHUNKS][NP][8]
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
               uint32_t* __restrict__ sums, int H, int W, int Ho, int Wo,
               int O, int seg_rows, int nseg, int nstrips, float fill) {
  constexpr bool LOADS = MODE != MODE_STORE;
  constexpr bool MMAS = MODE == MODE_FULL || MODE == MODE_MMA;
  constexpr bool STORES = MODE != MODE_LOAD;
  constexpr int SROW = wg_stage_row(NP);
  constexpr int OUT_ITERS = NP / 16;      // 16 pixels x NP / 8 chunks / 32
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem + wg_w_bytes(NP);
  unsigned char* stage = ring + NSLOT * ROW_B;
  const uint32_t w_addr = smem_u32(smem);
  const uint32_t ring_addr = smem_u32(ring);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  int blk = blockIdx.x;
  const int seg = blk % nseg;
  blk /= nseg;
  const int strip = blk % nstrips;
  const int b = blk / nstrips;
  const int oy0 = seg * seg_rows;
  const int nsteps = min(seg_rows, Ho - oy0);
  const int ox0 = strip * TILE_PX;
  const int iy_first = 2 * oy0 - 1;
  const __nv_bfloat16* xb = x + static_cast<int64_t>(b) * H * W * CIN;
  const RowCopy rc = make_row_copy(tid, 2 * ox0 - 1, W);

  // step s = output row oy0 + s reads ring rows 2 s, 2 s + 1, 2 s + 2 (input
  // rows iy_first + ...); its loads are the rows no earlier step loaded.
  // Rows are loaded in order, so the slot of the next one is a counter.
  int load_slot = 0;
  auto load_step = [&](int s) {
    for (int rr = s == 0 ? 0 : 2 * s + 1; rr <= 2 * s + 2; ++rr) {
      load_row(rc, ring_addr + load_slot * ROW_B, xb, iy_first + rr, H, W);
      load_slot = next_slot(load_slot, 1);
    }
  };

  if constexpr (MMAS) {
    for (int i = tid; i < wg_w_bytes(NP) / 16; i += THREADS) {
      cp_async16(w_addr + i * 16,
                 reinterpret_cast<const unsigned char*>(wp) + i * 16, 16u);
    }
  }
  if constexpr (LOADS) {
#pragma unroll
    for (int s = 0; s < DEPTH; ++s) {
      if (s < nsteps) load_step(s);
      cp_async_commit();                  // the weights ride in group 0
    }
  }

  float bia[NP / 4];
#pragma unroll
  for (int j = 0; j < NP / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    bia[2 * j] = (MODE == MODE_FULL && col < O) ? bias[col] : 0.0f;
    bia[2 * j + 1] = (MODE == MODE_FULL && col + 1 < O) ? bias[col + 1] : 0.0f;
  }

  // the warp's 16 pixels x O channels are contiguous in the output: 16-byte
  // chunk e = lane + 32 it of them is chunk e % (O / 8) of pixel e / (O / 8)
  unsigned char* st = stage + warp * 16 * SROW;
  const int px_base = ox0 + warp * 16;
  const bool vector_out = (O & 7) == 0;
  int out_src[OUT_ITERS], out_dst[OUT_ITERS];
  uint32_t out_ok = 0;
  if (vector_out) {
    const int cpp = O >> 3;
#pragma unroll
    for (int it = 0; it < OUT_ITERS; ++it) {
      const int e = lane + 32 * it;
      const int p = e / cpp, c = e - p * cpp;
      out_src[it] = p * SROW + c * 16;
      out_dst[it] = p * O + c * 8;
      out_ok |= ((e < 16 * cpp && px_base + p < Wo) ? 1u : 0u) << it;
    }
  }
  __nv_bfloat16* yrow =
      y + ((static_cast<int64_t>(b) * Ho + oy0) * Wo + px_base) * O;

  uint32_t csum = 0;
  int top_slot = 0;                       // the slot of ring row 2 s
  for (int s = 0; s < nsteps; ++s, yrow += static_cast<int64_t>(Wo) * O,
           top_slot = next_slot(top_slot, 2)) {
    if constexpr (LOADS) {
      cp_async_wait<DEPTH - 1>();         // this thread's part of step s
      fence_proxy_async();
    }
    // step s has landed for every thread, and every warp is done with step
    // s - 1, whose rows the next loads overwrite
    __syncthreads();
    if constexpr (LOADS) {
      if (s + DEPTH < nsteps) load_step(s + DEPTH);
      cp_async_commit();
    }
    const int mid_slot = next_slot(top_slot, 1);
    const int low_slot = next_slot(top_slot, 2);

    float d[NP / 2];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) d[i] = MODE == MODE_STORE ? fill : 0.0f;
    if constexpr (MMAS) {
      wgmma_fence();
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const uint32_t row =
            ring_addr +
            (kh == 0 ? top_slot : kh == 1 ? mid_slot : low_slot) * ROW_B;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          // output pixel p reads input column 2 p + kw of the strip: plane
          // kw & 1, entry p + (kw >> 1)
          const uint32_t a_tap = row + (kw & 1) * PLANE_B + (kw >> 1) * 16;
          const uint32_t b_tap = w_addr + (kh * 3 + kw) * 4 * NP * 16;
#pragma unroll
          for (int c = 0; c < 2; ++c) {   // channels 16 c ... 16 c + 15
            wgmma_bf16<NP>(d, wg_desc(a_tap + 2 * c * CHUNK_B, CHUNK_B, 128),
                           wg_desc(b_tap + 2 * c * NP * 16, NP * 16, 128),
                           (kh | kw | c) != 0);
          }
        }
      }
      wgmma_commit();
      wgmma_wait0();
    }
    if constexpr (MODE == MODE_LOAD) {
      if (s == 0) csum += sum_row(rc, ring + top_slot * ROW_B);
      csum += sum_row(rc, ring + mid_slot * ROW_B);
      csum += sum_row(rc, ring + low_slot * ROW_B);
    }

    if constexpr (MODE == MODE_COPY) {
      // y[.., o] = x[b, 2 oy, 2 ox + ((o >> 5) & 1), o & 31] from the ring
      const unsigned char* row = ring + mid_slot * ROW_B;
      for (int e = lane; e < 16 * (NP / 8); e += 32) {
        const int p = e / (NP / 8), oc = e % (NP / 8);
        const int col = 2 * (warp * 16 + p) + 1 + ((oc >> 2) & 1);
        *reinterpret_cast<uint4*>(st + p * SROW + oc * 16) =
            *reinterpret_cast<const uint4*>(row + ring_offset(col, oc & 3));
      }
    } else if constexpr (STORES) {
      stage_acc<NP, MODE == MODE_FULL ? ACT : ACT_LINEAR>(d, bia, st, lane);
    }

    if constexpr (STORES) {
      __syncwarp();
      if (vector_out) {
#pragma unroll
        for (int it = 0; it < OUT_ITERS; ++it) {
          if ((out_ok >> it) & 1u) {
            *reinterpret_cast<uint4*>(yrow + out_dst[it]) =
                *reinterpret_cast<const uint4*>(st + out_src[it]);
          }
        }
      } else {
        for (int e = lane; e < 16 * O; e += 32) {
          const int p = e / O, o = e - p * O;
          if (px_base + p < Wo) {
            yrow[e] = reinterpret_cast<const __nv_bfloat16*>(st + p * SROW)[o];
          }
        }
      }
      __syncwarp();
    }
  }

  if constexpr (MODE == MODE_LOAD) {
    uint32_t* total = reinterpret_cast<uint32_t*>(stage);
    if (tid == 0) *total = 0;
    __syncthreads();
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      csum += __shfl_down_sync(0xffffffffu, csum, off);
    }
    if (lane == 0) atomicAdd(total, csum);
    __syncthreads();
    if (tid == 0) sums[blockIdx.x] = *total;
  }
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

// fp32 in, fp32 out, CUDA cores. Thread t computes pixel t % 64 of the tile
// for half (t / 64) of the OP channels. NF = number of 16-wide channel
// groups (O padded up to NF * 16 in shared memory).
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

// Blocks of `threads` with `smem` bytes that the card runs at once.
int resident_blocks(const void* kernel_fn, size_t smem, int* cap) {
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
  *cap = sms * per_sm;
  return 0;
}

template <int NF>
int run_f32(const void* x, const void* w, const float* bias, void* y, int B,
            int H, int W, int O, int act, cudaStream_t st) {
  int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const int ntiles = B * Ho * ((Wo + TILE_PX - 1) / TILE_PX);
  const size_t smem = (3 * IN_COLS * F32_CSTRIDE + KTAPS * NF * 16) * 4;
  const void* kernel_fn = (const void*)stem_f32_kernel<NF>;
  int cap = 0;
  const int rc = resident_blocks(kernel_fn, smem, &cap);
  if (rc != 0) return rc;
  void* args[] = {(void*)&x, (void*)&w, (void*)&bias, (void*)&y, &B, &H,
                  &W, &Ho, &Wo, &O, &act};
  cudaError_t e = cudaLaunchKernel(kernel_fn, dim3(cap < ntiles ? cap : ntiles),
                                   dim3(THREADS), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The segmentation of the wgmma kernel: strips of 64 output columns, each
// cut into nseg runs of seg_rows output rows. A run of R rows loads 2 R + 1
// input rows and pays a set-up of about FIXED_ROWS more (the weights, the
// first loads); the blocks run in waves of `cap`. The R with the least
// waves x (2 R + 1 + FIXED_ROWS) wins, the larger R on a tie.
struct Plan {
  int nstrips, seg_rows, nseg;
};

Plan make_plan(int B, int Ho, int Wo, int cap, int seg_rows) {
  Plan p;
  p.nstrips = (Wo + TILE_PX - 1) / TILE_PX;
  if (seg_rows < 1) {
    long best = -1;
    for (int n = 1; n <= Ho; ++n) {
      const int r = (Ho + n - 1) / n;
      const long blocks = (long)B * p.nstrips * ((Ho + r - 1) / r);
      const long cost = ((blocks + cap - 1) / cap) * (2L * r + 1 + FIXED_ROWS);
      if (best < 0 || cost < best) {
        best = cost;
        seg_rows = r;
      }
    }
  }
  p.seg_rows = seg_rows < Ho ? seg_rows : Ho;
  p.nseg = (Ho + p.seg_rows - 1) / p.seg_rows;
  return p;
}

template <int NP, int MODE, int ACT>
int run_wg(const void* x, const void* wp, const float* bias, void* y,
           void* sums, int B, int H, int W, int O, int seg_rows, float fill,
           int* plan_out, cudaStream_t st) {
  static int cap = 0;                     // the card's resident blocks
  auto kernel_fn = stem_wg_kernel<NP, MODE, ACT>;
  if (cap == 0) {
    const int rc = resident_blocks((const void*)kernel_fn, wg_smem(NP), &cap);
    if (rc != 0) return rc;
  }
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const Plan p = make_plan(B, Ho, Wo, cap, seg_rows);
  if (plan_out != nullptr) {              // a query, not a launch
    plan_out[0] = p.nstrips;
    plan_out[1] = p.seg_rows;
    plan_out[2] = p.nseg;
    return 0;
  }
  kernel_fn<<<B * p.nstrips * p.nseg, THREADS, wg_smem(NP), st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wp), bias,
      static_cast<__nv_bfloat16*>(y), static_cast<uint32_t*>(sums), H, W, Ho,
      Wo, O, p.seg_rows, p.nseg, p.nstrips, fill);
  return (int)cudaGetLastError();
}

template <int NP>
int run_wg_mode(int mode, const void* x, const void* wp, const float* bias,
                void* y, void* sums, int B, int H, int W, int O, int act,
                int seg_rows, float fill, int* plan_out, cudaStream_t st) {
#define DYK_RUN(M, A)                                                         \
  return run_wg<NP, M, A>(x, wp, bias, y, sums, B, H, W, O, seg_rows, fill,   \
                          plan_out, st)
  switch (mode) {
    case MODE_FULL:
      if (act == ACT_MISH) DYK_RUN(MODE_FULL, ACT_MISH);
      if (act == ACT_LEAKY) DYK_RUN(MODE_FULL, ACT_LEAKY);
      DYK_RUN(MODE_FULL, ACT_LINEAR);
    case MODE_LOAD: DYK_RUN(MODE_LOAD, ACT_LINEAR);
    case MODE_STORE: DYK_RUN(MODE_STORE, ACT_LINEAR);
    case MODE_COPY: DYK_RUN(MODE_COPY, ACT_LINEAR);
    case MODE_MMA: DYK_RUN(MODE_MMA, ACT_LINEAR);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DYK_RUN
}

int run_bf16(int mode, const void* x, const void* wp, const float* bias,
             void* y, void* sums, int B, int H, int W, int O, int act,
             int seg_rows, float fill, int* plan_out, cudaStream_t st) {
  if (B < 1 || H < 1 || W < 1 || O < 1 || O > 128 || act < 0 || act > 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (O <= 32) {
    return run_wg_mode<32>(mode, x, wp, bias, y, sums, B, H, W, O, act,
                           seg_rows, fill, plan_out, st);
  }
  if (O <= 64) {
    return run_wg_mode<64>(mode, x, wp, bias, y, sums, B, H, W, O, act,
                           seg_rows, fill, plan_out, st);
  }
  return run_wg_mode<128>(mode, x, wp, bias, y, sums, B, H, W, O, act,
                          seg_rows, fill, plan_out, st);
}

}  // namespace

extern "C" const char* dyk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x: (B, H, W, 32) contiguous, bf16 (is_bf16) or fp32, 16-byte aligned.
// w: for fp32, (3, 3, 32, O) contiguous ([kh][kw][c][o]) fp32; for bf16,
// the packed kernel [36][NP][8] bf16, NP = 32, 64 or 128 the least >= O:
// element [kc][n][e] is the weight of output n at k = 8 kc + e, k = (kh * 3
// + kw) * 32 + c, zero for n >= O. bias: (O,) fp32. y: (B, Ho, Wo, O)
// contiguous in x's type, Ho = ceil(H / 2), Wo = ceil(W / 2). act: 0 linear,
// 1 leaky, 2 mish. 1 <= O <= 128. Returns the launch's cudaError_t.
extern "C" int dyk_stem_conv_s2(const void* x, int is_bf16, const void* w,
                                const float* bias, void* y, int B, int H,
                                int W, int O, int act, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    return run_bf16(MODE_FULL, x, w, bias, y, nullptr, B, H, W, O, act, 0,
                    0.0f, nullptr, st);
  }
  if (B < 1 || H < 1 || W < 1 || O < 1 || O > 128 || act < 0 || act > 2) {
    return (int)cudaErrorInvalidValue;
  }
  switch ((O + 15) / 16) {
    case 1: return run_f32<1>(x, w, bias, y, B, H, W, O, act, st);
    case 2: return run_f32<2>(x, w, bias, y, B, H, W, O, act, st);
    case 3: return run_f32<3>(x, w, bias, y, B, H, W, O, act, st);
    case 4: return run_f32<4>(x, w, bias, y, B, H, W, O, act, st);
    case 5: return run_f32<5>(x, w, bias, y, B, H, W, O, act, st);
    case 6: return run_f32<6>(x, w, bias, y, B, H, W, O, act, st);
    case 7: return run_f32<7>(x, w, bias, y, B, H, W, O, act, st);
    default: return run_f32<8>(x, w, bias, y, B, H, W, O, act, st);
  }
}

// The segmentation the bf16 conv uses at this shape: plan = {strips of 64
// output columns, output rows per block, blocks per strip}. Block (b, strip,
// seg) of the grid is number (b * strips + strip) * blocks per strip + seg.
extern "C" int dyk_stem_plan(int B, int H, int W, int O, int* plan) {
  return run_bf16(MODE_FULL, nullptr, nullptr, nullptr, nullptr, nullptr, B,
                  H, W, O, 0, 0, 0.0f, plan, nullptr);
}

// The bf16 kernel with stages left out, at the segmentation seg_rows (from
// dyk_stem_plan). x, wp, bias, y as in dyk_stem_conv_s2.
//   mode 0 full:  the conv itself.
//   mode 1 load:  the ring's loads only; sums[block] (uint32) = the sum of
//                 the 16-bit patterns of everything the block loaded (its
//                 rows 2 oy0 - 1 ... 2 oy1 - 1, columns 2 ox0 - 1 ... 2 ox0
//                 + 127, zero outside the image). y is not written.
//   mode 2 store: no loads, no MMAs; y = fill everywhere.
//   mode 3 copy:  loads and stores, no MMAs: y[b, oy, ox, o] = x[b, 2 oy,
//                 2 ox + ((o >> 5) & 1), o & 31] (zero outside the image).
//   mode 4 mma:   loads, MMAs and stores: the raw conv sums, no bias, no
//                 activation, rounded once to bf16.
extern "C" int dyk_stem_probe(int mode, const void* x, const void* wp,
                              const float* bias, void* y, void* sums, int B,
                              int H, int W, int O, int act, int seg_rows,
                              float fill, void* stream) {
  if (seg_rows < 1) return (int)cudaErrorInvalidValue;
  return run_bf16(mode, x, wp, bias, y, sums, B, H, W, O, act, seg_rows, fill,
                  nullptr, (cudaStream_t)stream);
}
