// K4 on Hopper: int8 x int8 -> int32 GEMM with the dequant -> activation
// -> requant epilogue of a quantized 1x1 conv.
//
// Replaces the TPU kernel double_yolo_kaist_tpu/ops/pallas_qgemm.py
// (_kernel via qgemm, epilogue _epilogue). x (M, K) s8 row-major times the
// weights, given K-major as (N, K) s8 row-major, summed exactly in int32;
// then, in the output type T (bf16 or fp32), op by op as the plain PyTorch
// version runs them:
//   y = T(acc) * T(scale) + T(bias);  y = act(y);
//   optionally q = clamp(round(y * T(out_inv_s)), -127, 127) -> s8.
// Each op rounds to T (bf16 ops are computed in fp32 and rounded to bf16,
// as PyTorch computes them), with no FMA contraction, so the kernel and the
// plain version agree bit for bit where expf/log1pf/tanhf agree. T(acc)
// goes through fp32 first, as PyTorch's int32 -> bf16 cast does.
//
// Bound on the H100: bytes, or operations by a hair. The flagship's ten
// chain 1x1 convs (K 256 to 1024, N 128 to 512) are 100 to 340 int8
// operations per byte moved, under the int8 tensor cores' balance point
// (~590), and each is only 1.4 to 6.3 us of work for the whole card, so a
// launch's ramp and tail weigh as much as either. What the design does
// about it:
//   * the products are wgmma m64nNk32 s8 x s8 -> s32, both operands read
//     from shared memory by descriptor (8-bit wgmma takes both K-major,
//     which is why the weights arrive packed as (N, K)), accumulators in
//     registers. A block is one or two warpgroups, each owning 64 rows of a
//     BM x BN output tile (128 x 128, 64 x 128 or 64 x 64, chosen on the
//     host so that the tiles fill the card);
//   * x and w tiles, 128 bytes of K deep, lie in the 128-byte swizzle
//     layout: row r's 16-byte chunk c at r * 128 + ((c ^ (r & 7)) << 4), so
//     that the 8 copies of a quarter-warp, 128 contiguous bytes of device
//     memory, fill one conflict-free line, and the four k32 steps of a
//     stage are the descriptor's start moved by 32 bytes. A ring of 3 or 4
//     such stages is filled by cp.async (past L1: every byte is used once
//     by its block, and the re-reads by other blocks are L2's; zero fill
//     past M, N and K, so any M >= 1 and any K, N that are multiples of 16
//     take this one kernel) two or three stages ahead of the MMAs. A
//     stage's copies are started right after its MMAs, so the two overlap;
//     where each of a thread's rows starts is worked out once a tile;
//   * blocks are persistent: the grid is what the card holds at once, a
//     block walks over its tiles, and the ring runs on across tile
//     boundaries, so one tile's epilogue and stores overlap the next one's
//     loads (the flagship's K = 256 shape has only two stages a tile);
//   * the epilogue works on the accumulator registers (thread t of a warp
//     owns rows t / 4 and t / 4 + 8, columns 8 j + 2 (t % 4) and + 1): scale
//     and bias of a tile's columns come into shared memory with its first
//     stage (read from device memory in the epilogue they cost an L2 round
//     trip per column pair, more than all the arithmetic), the activation and
//     the requant are template parameters, and the bf16 epilogue runs on
//     column pairs with the packed bf16 instructions (finish2: the same
//     values as the op-by-op fp32 form, a quarter of the instructions). The
//     results go through a per-warp staging tile in shared memory (padded
//     rows, conflict free) and leave as 16-byte stores, 256 contiguous
//     bytes a half-warp, for s8, bf16 and fp32 alike.
// What binds it now (clock64 stamps in a block, NVIDIA H100 80GB HBM3): a
// stage is ~800 cycles, ~650 of them spent starting its 8 to 12 cp.async a
// thread, ahead of the ~450 to 600 of its MMAs; an epilogue ~2650. TMA
// loads (one instruction a tile) are the next step; not built.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int BK = 128;            // K bytes of a stage: one swizzle row
constexpr int WG = 128;            // threads of a warpgroup
constexpr int MAX_DEVICES = 64;    // cards of one process

enum Act { ACT_LINEAR = 0, ACT_LEAKY = 1, ACT_MISH = 2, ACT_RELU = 3,
           ACT_RELU6 = 4 };

// one op of the epilogue in the output type: fp32 as it is, bf16 rounded
// to nearest even after every op
template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool BF16, int ACT>
__device__ __forceinline__ float activate(float v) {
  if constexpr (ACT == ACT_LEAKY) {  // 0.1 in the output type, as JAX's
    return fmaxf(v, rnd<BF16>(__fmul_rn(v, rnd<BF16>(0.1f))));  // weak scalar
  } else if constexpr (ACT == ACT_MISH) {
    // x * tanh(max(x, 0) + log1p(exp(-|x|))), each op rounded
    const float e = rnd<BF16>(expf(-fabsf(v)));
    const float l = rnd<BF16>(log1pf(e));
    const float sp = rnd<BF16>(__fadd_rn(fmaxf(v, 0.0f), l));
    const float t = rnd<BF16>(tanhf(sp));
    return rnd<BF16>(__fmul_rn(v, t));
  } else if constexpr (ACT == ACT_RELU) {
    return fmaxf(v, 0.0f);
  } else if constexpr (ACT == ACT_RELU6) {
    return fminf(fmaxf(v, 0.0f), 6.0f);
  } else {
    return v;
  }
}

// int32 sum -> the output value (the s8 code, as a float, when requantizing)
template <bool BF16, int ACT, bool REQUANT>
__device__ __forceinline__ float finish(int acc, float s, float b, float inv) {
  float y = rnd<BF16>(__int2float_rn(acc));
  y = rnd<BF16>(__fmul_rn(y, s));
  y = rnd<BF16>(__fadd_rn(y, b));
  y = activate<BF16, ACT>(y);
  if constexpr (REQUANT) {
    y = rintf(rnd<BF16>(__fmul_rn(y, inv)));
    y = fminf(fmaxf(y, -127.0f), 127.0f);
  }
  return y;
}

// The same for two neighbouring columns at once, in bf16, with the packed
// bf16 instructions. A bf16 op computed in fp32 and rounded to bf16 (what
// finish does, and PyTorch) equals the correctly rounded bf16 op, because
// fp32 carries more than twice bf16's 8 bits of precision plus two, so
// rounding twice cannot differ from rounding once; the _rn forms are never
// contracted into an FMA. Clamping before rounding to the nearest integer
// equals rounding before clamping, the limits being integers. Not for mish,
// whose exp, log1p and tanh are fp32 functions.
template <int ACT, bool REQUANT>
__device__ __forceinline__ __nv_bfloat162 finish2(int acc0, int acc1,
                                                  __nv_bfloat162 s,
                                                  __nv_bfloat162 b,
                                                  __nv_bfloat162 inv) {
  static_assert(ACT != ACT_MISH, "mish takes the fp32 path");
  __nv_bfloat162 y =
      __floats2bfloat162_rn(__int2float_rn(acc0), __int2float_rn(acc1));
  y = __hadd2_rn(__hmul2_rn(y, s), b);
  if constexpr (ACT == ACT_LEAKY) {
    y = __hmax2(y, __hmul2_rn(y, __float2bfloat162_rn(0.1f)));
  } else if constexpr (ACT == ACT_RELU) {
    y = __hmax2(y, __float2bfloat162_rn(0.0f));
  } else if constexpr (ACT == ACT_RELU6) {
    y = __hmin2(__hmax2(y, __float2bfloat162_rn(0.0f)),
                __float2bfloat162_rn(6.0f));
  }
  if constexpr (REQUANT) {
    y = __hmul2_rn(y, inv);
    y = __hmin2(__hmax2(y, __float2bfloat162_rn(-127.0f)),
                __float2bfloat162_rn(127.0f));
  }
  return y;
}

// the s8 codes of a clamped pair
__device__ __forceinline__ char2 codes(__nv_bfloat162 y) {
  return make_char2(static_cast<signed char>(__float2int_rn(__low2float(y))),
                    static_cast<signed char>(__float2int_rn(__high2float(y))));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; src_bytes 0 writes zeros (past M, N or K)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
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

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle
// layout: rows of 128 bytes, 8-row groups 1024 bytes apart (the tile starts
// on a 1024-byte boundary). The leading offset is not used in this layout.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

#define DYK_ACC4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define DYK_ACC16(i) \
  DYK_ACC4(i), DYK_ACC4(i + 4), DYK_ACC4(i + 8), DYK_ACC4(i + 12)

// d (64 x BN, int32, BN / 2 registers a thread) = or += A (64 x 32) B^T
// (BN x 32), both s8 from shared memory, K-major.
template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(BN == 64 || BN == 128, "unsupported width");
  if constexpr (BN == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : DYK_ACC16(0), DYK_ACC16(16)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  if constexpr (BN == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : DYK_ACC16(0), DYK_ACC16(16), DYK_ACC16(32), DYK_ACC16(48)
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// The epilogue's staging: a warp's 16 rows go out in passes of at most 256
// bytes a row. The row pitch keeps the fragment's writes off each other's
// banks: 4-byte (bf16 pair) and 2-byte (s8 pair) writes want 8 rows 4 words
// apart, 8-byte (fp32 pair) writes want 4 rows 8 words apart.
template <int BN, int ESZ>
struct Stage {
  static constexpr int COLS = BN * ESZ <= 256 ? BN : 256 / ESZ;  // per pass
  static constexpr int PASSES = BN / COLS;
  static constexpr int PITCH = ESZ == 4 ? 288 : 272;       // bytes a row
  static constexpr int CHUNKS = COLS * ESZ / 16;           // 16 B per row
  static constexpr int ITERS = 16 * CHUNKS / 32;           // per lane
  static constexpr int WARP_BYTES = 16 * PITCH;
};

constexpr int ring_bytes(int wgs, int bn, int stages) {
  return stages * (wgs * 64 + bn) * BK;
}
// the ring, the warps' staging tiles, and per tile in flight the scale and
// bias of its BN columns
constexpr int smem_bytes(int wgs, int bn, int stages, int esz) {
  return ring_bytes(wgs, bn, stages) + wgs * 4 * 16 * (esz == 4 ? 288 : 272) +
         stages * 2 * bn * 4;
}

// A block of WGS warpgroups computes tiles blockIdx.x, + gridDim.x, ... of
// 64 WGS x BN outputs; tile t is rows (t / tiles_n) and columns (t %
// tiles_n), so blocks that run side by side share their rows of x in L2.
template <int WGS, int BN, int STAGES, bool BF16, int ACT, bool REQUANT>
__global__ void __launch_bounds__(WGS * WG)
qgemm_wg_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale,
                const float* __restrict__ bias, void* __restrict__ out, int M,
                int K, int N, float out_inv, int tiles_n, int ntiles) {
  constexpr int THREADS = WGS * WG;
  constexpr int BM = WGS * 64;
  constexpr int ROWS_PER_PASS = THREADS / 8;  // 8 threads copy a 128-byte row
  constexpr int X_COPIES = BM / ROWS_PER_PASS;
  constexpr int W_COPIES = BN / ROWS_PER_PASS;
  constexpr int STAGE_BYTES = (BM + BN) * BK;
  constexpr int ESZ = REQUANT ? 1 : (BF16 ? 2 : 4);
  using St = Stage<BN, ESZ>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);

  const int tid = threadIdx.x;
  const int wg = tid / WG;
  const int warp = (tid % WG) >> 5;
  const int lane = tid & 31;
  const int kt_per_tile = (K + BK - 1) / BK;

  // what this thread copies of every stage: chunk (tid & 7) of rows tid / 8,
  // + ROWS_PER_PASS, ...; the swizzle depends on row & 7 = (tid / 8) & 7
  const int ld_row = tid >> 3;
  const int ld_k = (tid & 7) * 16;
  const uint32_t ld_dst = ld_row * BK + (((tid & 7) ^ (ld_row & 7)) << 4);
  // scale and bias of a tile's columns ride with its first stage: thread t <
  // BN / 2 copies 16 bytes of one of them. A tile's loads start at most
  // STAGES - 1 tiles ahead of its epilogue, so STAGES buffers go round.
  float* sb = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES +
                                       WGS * 4 * St::WARP_BYTES);
  const uint32_t sb_dst = smem_u32(sb) + (tid / (BN / 4)) * BN * 4 +
                          (tid % (BN / 4)) * 16;
  const float* sb_src = tid / (BN / 4) ? bias : scale;
  int ld_tile = blockIdx.x, ld_kt = 0, ld_slot = 0, ld_buf = 0;
  // the rows this thread copies of the loader's tile, worked out once a
  // tile: where each starts (the base if it lies past M or N) and whether
  // it exists
  const int8_t* x_row[X_COPIES];
  const int8_t* w_row[W_COPIES];
  uint32_t x_ok = 0, w_ok = 0;
  auto load_next = [&]() {
    if (ld_tile < ntiles) {
      if (ld_kt == 0) {
        const int m0 = (ld_tile / tiles_n) * BM;
        const int n0 = (ld_tile % tiles_n) * BN;
        x_ok = w_ok = 0;
#pragma unroll
        for (int c = 0; c < X_COPIES; ++c) {
          const int row = m0 + ld_row + c * ROWS_PER_PASS;
          x_row[c] = x + (row < M ? static_cast<int64_t>(row) * K + ld_k : 0);
          x_ok |= (row < M ? 1u : 0u) << c;
        }
#pragma unroll
        for (int c = 0; c < W_COPIES; ++c) {
          const int row = n0 + ld_row + c * ROWS_PER_PASS;
          w_row[c] = w + (row < N ? static_cast<int64_t>(row) * K + ld_k : 0);
          w_ok |= (row < N ? 1u : 0u) << c;
        }
        if (tid < BN / 2) {
          const int col = n0 + (tid % (BN / 4)) * 4;  // N: a multiple of 16
          cp_async16(sb_dst + ld_buf * 2 * BN * 4,
                     sb_src + (col < N ? col : 0), col < N ? 16u : 0u);
        }
      }
      const int k = ld_kt * BK;
      const bool k_ok = k + ld_k < K;
      const uint32_t dst = ring + ld_slot * STAGE_BYTES + ld_dst;
#pragma unroll
      for (int c = 0; c < X_COPIES; ++c) {
        const bool ok = k_ok && ((x_ok >> c) & 1u);
        cp_async16(dst + c * ROWS_PER_PASS * BK, x_row[c] + (ok ? k : 0),
                   ok ? 16u : 0u);
      }
#pragma unroll
      for (int c = 0; c < W_COPIES; ++c) {
        const bool ok = k_ok && ((w_ok >> c) & 1u);
        cp_async16(dst + (BM + c * ROWS_PER_PASS) * BK,
                   w_row[c] + (ok ? k : 0), ok ? 16u : 0u);
      }
      if (++ld_kt == kt_per_tile) {
        ld_kt = 0;
        ld_tile += gridDim.x;
        ld_buf = ld_buf + 1 == STAGES ? 0 : ld_buf + 1;
      }
      ld_slot = ld_slot + 1 == STAGES ? 0 : ld_slot + 1;
    }
    cp_async_commit();                    // one group a step, loads or none
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_next();

  unsigned char* st = smem + STAGES * STAGE_BYTES +
                      (wg * 4 + warp) * St::WARP_BYTES;
  const int g = lane >> 2, q = lane & 3;
  const float inv = rnd<BF16>(out_inv);
  const __nv_bfloat162 inv2 = __float2bfloat162_rn(out_inv);
  int slot = 0, buf = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    int d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0;
    for (int kt = 0; kt < kt_per_tile; ++kt) {
      cp_async_wait<STAGES - 2>();        // this thread's part of the stage
      fence_proxy_async();
      // the stage has landed for every thread, and every warp is done with
      // the stage before it, whose slot the next loads overwrite
      __syncthreads();
      const uint32_t xs = ring + slot * STAGE_BYTES + wg * 64 * BK;
      const uint32_t ws = ring + slot * STAGE_BYTES + BM * BK;
      const uint64_t da = wg_desc(xs), db = wg_desc(ws);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {  // 32 bytes: the start >> 4 + 2
        wgmma_s8<BN>(d, da + 2 * kk, db + 2 * kk, (kt | kk) != 0);
      }
      wgmma_commit();
      load_next();                        // while the tensor cores work
      wgmma_wait0();
      slot = slot + 1 == STAGES ? 0 : slot + 1;
    }

    const int m0 = (tile / tiles_n) * BM + wg * 64 + warp * 16;
    const int n0 = (tile % tiles_n) * BN;
    const float* sc_s = sb + buf * 2 * BN + 2 * q;
    const float* bi_s = sc_s + BN;
    buf = buf + 1 == STAGES ? 0 : buf + 1;
#pragma unroll
    for (int pass = 0; pass < St::PASSES; ++pass) {
#pragma unroll
      for (int jj = 0; jj < St::COLS / 8; ++jj) {
        // columns past N are computed too, from the zeros their weights,
        // scale and bias were filled with, and never stored
        const int j = pass * (St::COLS / 8) + jj;
        const float2 sc = *reinterpret_cast<const float2*>(sc_s + 8 * j);
        const float2 bi = *reinterpret_cast<const float2*>(bi_s + 8 * j);
        unsigned char* lo = st + g * St::PITCH + (8 * jj + 2 * q) * ESZ;
        unsigned char* hi = lo + 8 * St::PITCH;
        if constexpr (BF16 && ACT != ACT_MISH) {
          const __nv_bfloat162 s2 = __floats2bfloat162_rn(sc.x, sc.y);
          const __nv_bfloat162 b2 = __floats2bfloat162_rn(bi.x, bi.y);
          const __nv_bfloat162 v01 =
              finish2<ACT, REQUANT>(d[4 * j], d[4 * j + 1], s2, b2, inv2);
          const __nv_bfloat162 v23 =
              finish2<ACT, REQUANT>(d[4 * j + 2], d[4 * j + 3], s2, b2, inv2);
          if constexpr (REQUANT) {
            *reinterpret_cast<char2*>(lo) = codes(v01);
            *reinterpret_cast<char2*>(hi) = codes(v23);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(lo) = v01;
            *reinterpret_cast<__nv_bfloat162*>(hi) = v23;
          }
        } else {
          const float s0 = rnd<BF16>(sc.x), s1 = rnd<BF16>(sc.y);
          const float b0 = rnd<BF16>(bi.x), b1 = rnd<BF16>(bi.y);
          const float v0 = finish<BF16, ACT, REQUANT>(d[4 * j], s0, b0, inv);
          const float v1 = finish<BF16, ACT, REQUANT>(d[4 * j + 1], s1, b1,
                                                      inv);
          const float v2 = finish<BF16, ACT, REQUANT>(d[4 * j + 2], s0, b0,
                                                      inv);
          const float v3 = finish<BF16, ACT, REQUANT>(d[4 * j + 3], s1, b1,
                                                      inv);
          if constexpr (REQUANT) {
            *reinterpret_cast<char2*>(lo) = make_char2(
                static_cast<signed char>(v0), static_cast<signed char>(v1));
            *reinterpret_cast<char2*>(hi) = make_char2(
                static_cast<signed char>(v2), static_cast<signed char>(v3));
          } else if constexpr (BF16) {
            *reinterpret_cast<__nv_bfloat162*>(lo) =
                __floats2bfloat162_rn(v0, v1);
            *reinterpret_cast<__nv_bfloat162*>(hi) =
                __floats2bfloat162_rn(v2, v3);
          } else {
            *reinterpret_cast<float2*>(lo) = make_float2(v0, v1);
            *reinterpret_cast<float2*>(hi) = make_float2(v2, v3);
          }
        }
      }
      __syncwarp();
      // 16 rows x CHUNKS 16-byte pieces, consecutive lanes consecutive pieces
#pragma unroll
      for (int it = 0; it < St::ITERS; ++it) {
        const int e = lane + 32 * it;
        const int p = e / St::CHUNKS, c = e % St::CHUNKS;
        const int row = m0 + p;
        const int col = n0 + pass * St::COLS + c * (16 / ESZ);
        if (row < M && col < N) {
          *reinterpret_cast<uint4*>(
              static_cast<unsigned char*>(out) +
              (static_cast<int64_t>(row) * N + col) * ESZ) =
              *reinterpret_cast<const uint4*>(st + p * St::PITCH + c * 16);
        }
      }
      __syncwarp();
    }
  }
  cp_async_wait<0>();
}

// Multiprocessors of card `dev`: the one figure the tile choice on the host
// (dyk_qgemm_sms) and the persistent grid (resident_blocks) both start from.
int multiprocessors(int dev, int* sms) {
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                     dev);
}

// Lets the kernel have `smem` bytes on card `dev`, the current one (the
// opt-in is the card's own), and gives the blocks of `threads` it runs at
// once.
int resident_blocks(const void* kernel_fn, int threads, size_t smem, int dev,
                    int* cap) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int sms = 0, per_sm = 0;
  const int rc = multiprocessors(dev, &sms);
  if (rc != 0) return rc;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_fn,
                                                    threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *cap = sms * per_sm;
  return 0;
}

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const float* bias;
  void* out;
  int M, K, N, act;
  float out_inv;
  cudaStream_t st;
};

template <int WGS, int BN, int STAGES, bool BF16, int ACT, bool REQUANT>
int run(const Args& a) {
  constexpr int ESZ = REQUANT ? 1 : (BF16 ? 2 : 4);
  constexpr int SMEM = smem_bytes(WGS, BN, STAGES, ESZ);
  // each card's resident blocks, 0 until its first launch; threads that
  // meet there work out the same figure
  static std::atomic<int> caps[MAX_DEVICES];
  auto kernel_fn = qgemm_wg_kernel<WGS, BN, STAGES, BF16, ACT, REQUANT>;
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int cap = caps[dev].load(std::memory_order_acquire);
  if (cap == 0) {
    const int rc = resident_blocks((const void*)kernel_fn, WGS * WG, SMEM,
                                   dev, &cap);
    if (rc != 0) return rc;
    caps[dev].store(cap, std::memory_order_release);
  }
  const int tiles_n = (a.N + BN - 1) / BN;
  const long long ntiles =
      (long long)((a.M + WGS * 64 - 1) / (WGS * 64)) * tiles_n;
  if (ntiles > 0x7fffffffLL - cap) return (int)cudaErrorInvalidValue;
  kernel_fn<<<(int)(ntiles < cap ? ntiles : cap), WGS * WG, SMEM, a.st>>>(
      a.x, a.w, a.scale, a.bias, a.out, a.M, a.K, a.N, a.out_inv, tiles_n,
      (int)ntiles);
  return (int)cudaGetLastError();
}

template <int WGS, int BN, int STAGES, bool BF16, bool REQUANT>
int run_act(const Args& a) {
  switch (a.act) {
    case ACT_LINEAR: return run<WGS, BN, STAGES, BF16, ACT_LINEAR, REQUANT>(a);
    case ACT_LEAKY: return run<WGS, BN, STAGES, BF16, ACT_LEAKY, REQUANT>(a);
    case ACT_MISH: return run<WGS, BN, STAGES, BF16, ACT_MISH, REQUANT>(a);
    case ACT_RELU: return run<WGS, BN, STAGES, BF16, ACT_RELU, REQUANT>(a);
    case ACT_RELU6: return run<WGS, BN, STAGES, BF16, ACT_RELU6, REQUANT>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int WGS, int BN, int STAGES>
int run_type(const Args& a, int is_bf16, int requant) {
  if (is_bf16) {
    return requant ? run_act<WGS, BN, STAGES, true, true>(a)
                   : run_act<WGS, BN, STAGES, true, false>(a);
  }
  return requant ? run_act<WGS, BN, STAGES, false, true>(a)
                 : run_act<WGS, BN, STAGES, false, false>(a);
}

}  // namespace

extern "C" const char* dyk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Multiprocessors of the current card, for the host's choice of (bm, bn).
extern "C" int dyk_qgemm_sms(int* sms) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  return e != cudaSuccess ? (int)e : multiprocessors(dev, sms);
}

// x: (M, K) s8 contiguous, 16-byte aligned; w: the weights K-major, (N, K)
// s8 contiguous, 16-byte aligned; scale, bias: (N,) fp32, 16-byte aligned.
// out: (M, N) contiguous, 16-byte aligned, s8 if requant else bf16
// (is_bf16) or fp32; the epilogue computes in bf16 (is_bf16) or fp32 either
// way. act: 0 linear, 1 leaky, 2 mish, 3 relu, 4 relu6. M >= 1; K and N
// multiples of 16. (bm, bn): the output tile of a block, (128, 128),
// (64, 128) or (64, 64). Returns the launch's cudaError_t.
extern "C" int dyk_qgemm(const int8_t* x, const int8_t* w, const float* scale,
                         const float* bias, void* out, int M, int K, int N,
                         int act, int is_bf16, int requant, float out_inv,
                         int bm, int bn, void* stream) {
  if (M < 1 || K < 16 || N < 16 || K % 16 || N % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a = {x, w, scale, bias, out, M, K, N, act, out_inv,
                  (cudaStream_t)stream};
  if (bm == 128 && bn == 128) return run_type<2, 128, 3>(a, is_bf16, requant);
  if (bm == 64 && bn == 128) return run_type<1, 128, 3>(a, is_bf16, requant);
  if (bm == 64 && bn == 64) return run_type<1, 64, 4>(a, is_bf16, requant);
  return (int)cudaErrorInvalidValue;
}
