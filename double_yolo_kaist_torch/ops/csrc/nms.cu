// K2 on Hopper: greedy NMS over a fixed candidate pool, one thread block
// cluster per image.
//
// Replaces the TPU kernel double_yolo_kaist_tpu/ops/pallas_nms.py
// (_nms_kernel, via pallas_nms_indices) and computes exactly
// double_yolo_kaist_tpu/ops/nms.py::nms_indices for each image: max_det
// rounds of "take the highest score (ties to the first index), suppress
// every candidate whose IoU with it is > iou_thres, and the winner itself";
// a round whose best score is <= NEG_INF / 2 is not valid, and neither is
// any round after it. Scores may come in any order; they must not be NaN.
//
// Bound on the H100: launch and latency, not bytes or flops. An image's
// pool is ~10 KB in and 800 B out; the work is a chain of up to max_det
// dependent rounds behind a (K, K) IoU test. What the design does about it:
//   * rank once, then scan. Greedy NMS takes winners in descending (score,
//     then lower index) order, so each candidate's rank is counted once
//     (rank_i = the number of candidates that beat i; no barrier inside) and
//     the pool is put in rank order. A winner can then only suppress later
//     ranks: only the upper triangle of the IoU bitmask, in rank order and
//     up to the last valid score, is computed, and the next winner is the
//     first rank still alive. A pool that arrives sorted (the serving path
//     cuts it with a stable descending sort) is seen as such and skips the
//     ranking;
//   * the mask is spread over the card: a cluster of 8 blocks per image, on
//     8 SMs, in one launch. Block c ranks candidates c K / 8 ... (4 threads
//     a candidate) and scatters their boxes, in rank order, into every
//     block's shared memory through distributed shared memory. Then it
//     computes mask rows c, c + 8, ... into its own shared memory: a warp
//     takes a word of 32 columns, a lane keeps its column's box and area in
//     registers and tests it against four rows at a time (the long,
//     branch-free part of the tests first, the decisions after), a ballot
//     makes the word. Words are paired (w with the last minus w) and a
//     pair's rows dealt to 16 / pairs warps, so the triangle is spread
//     evenly. Block 0 then reads all rows into its own shared memory, 16
//     bytes a read and four reads in flight a thread (storing each word
//     into block 0 as it is made was tried first and was slower). The
//     blocks meet at four cluster barriers. The first, which only waits
//     for the cluster to be resident, arrives relaxed, without the memory
//     fence; the last, after which the other blocks exit and their shared
//     memory goes, is arrived at with release by block 0 after every value
//     it read from them has been stored into its own mask, so no read of
//     another block's memory is in flight there. Mask words that lie wholly
//     under the diagonal, or beyond the last valid rank, are never computed;
//     the rounds read such a word only into lanes whose alive bits are
//     already spent. Device memory sees the pool
//     once. The other route, the mask through L2 with one grid, needs either
//     a second launch or a counter in device memory that outlives the
//     launch; the cluster needs neither;
//   * the rounds run in one warp of block 0 with no block barrier and no
//     exchange between lanes in the chain: lane l keeps word l of the alive
//     mask (K <= 1024 = 32 words) in a register, every lane keeps the word
//     being scanned, and a round is a find-first-set, two shared-memory
//     reads of the winner's mask row and an and-not (a warp-wide minimum
//     over the lanes' first alive ranks took more than twice as long). It
//     stops at the first rank that is not valid or at max_det;
//   * the IoU decision must match the plain version bit for bit, so it is
//     written with round-to-nearest intrinsics in box_iou's order
//     (inter / (area_i + area_j - inter + 1e-16)) and the file is compiled
//     with --fmad=false besides. The division is skipped where inter lies
//     outside thres (1 -+ 2^-20) den, which decides the rounded quotient
//     already (the roundings, 2^-24 each, stay far inside that margin).
// With 8 SMs an image the mask is bound by the schedulers' rate; it is the
// largest part of the kernel's time, ahead of the rounds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define DYK_NMS_MAX_K 1024
#define DYK_NMS_THREADS 512
#define DYK_NMS_WARPS (DYK_NMS_THREADS / 32)
#define DYK_NMS_CLUSTER 8
#define DYK_NMS_UNROLL 4       // IoU tests a lane keeps in flight
#define DYK_VALID_MIN (-5e9f)  // NEG_INF / 2

namespace {


__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// The two halves of a cluster barrier: what a block wrote before it arrives
// (also into another block's shared memory) is seen after the wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
// For a barrier that orders execution only (no data is handed over).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The address of this block's shared-memory object p in block `rank`.
__device__ __forceinline__ uint32_t remote_addr(const void* p, uint32_t rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_remote(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}
__device__ __forceinline__ void st_remote(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ uint32_t ld_remote(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint4 ld_remote4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ float box_area(float4 a) {
  return __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
}

// IoU(a, b) > thres must fall as box_iou's rounded quotient inter / den
// falls. The test is cut in two so that a lane can keep several in flight:
// iou_terms is the long, branch-free part (inter and den, in box_iou's order
// of operations); iou_over decides. It divides only where inter lies inside
// thres (1 -+ 2^-20) den: outside, the quotient is more than an ulp away from
// thres whatever the roundings (2^-24 each) did. th_hi and th_lo are thres
// (1 +- 2^-20), or +-infinity for a thres <= 1e-6, which then always
// divides.
__device__ __forceinline__ void iou_terms(float4 a, float area_a, float4 b,
                                          float area_b, float* inter,
                                          float* den) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  *inter = __fmul_rn(iw, ih);
  *den = __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), *inter), 1e-16f);
}

// Called by all lanes of a warp together; `wanted` is false for a lane whose
// pair is not part of the mask.
__device__ __forceinline__ bool iou_over(float inter, float den, float thres,
                                         float th_hi, float th_lo,
                                         bool wanted) {
  bool over = inter > __fmul_rn(th_hi, den);
  const bool sure =
      den > 1e-30f && (over || inter < __fmul_rn(th_lo, den));
  if (__any_sync(0xffffffffu, wanted && !sure)) {
    if (!sure) over = __fdiv_rn(inter, den) > thres;
  }
  return over && wanted;
}

__global__ void __cluster_dims__(DYK_NMS_CLUSTER, 1, 1)
__launch_bounds__(DYK_NMS_THREADS)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
           int k, float iou_thres, int max_det, int* __restrict__ idx_out,
           unsigned char* __restrict__ valid_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 31) >> 5;
  const int slab_rows = (k + DYK_NMS_CLUSTER - 1) / DYK_NMS_CLUSTER;
  float4* sbox = reinterpret_cast<float4*>(smem);     // boxes in rank order
  float* sarea = reinterpret_cast<float*>(sbox + k);  // their areas
  float* sc = sarea + k;                              // scores as given
  int* order = reinterpret_cast<int*>(sc + k);        // rank -> index
  // this block's mask rows crank, crank + 8, ...: slab_rows x words
  uint32_t* slab = reinterpret_cast<uint32_t*>(
      smem + ((k * 28 + 15) & ~15));      // 16-byte aligned, after order
  // the whole mask, k rows x words, gathered in block 0 of the cluster
  uint32_t* mask = slab + slab_rows * words;
  int* win = reinterpret_cast<int*>(sc);  // the winners' ranks (block 0)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t crank = cluster_rank();
  const int img = blockIdx.x / DYK_NMS_CLUSTER;
  boxes += static_cast<int64_t>(img) * k;
  scores += static_cast<int64_t>(img) * k;
  idx_out += static_cast<int64_t>(img) * max_det;
  valid_out += static_cast<int64_t>(img) * max_det;

  cluster_arrive_relaxed();  // barrier 0: every block of the cluster runs

  // the boxes at this thread's indices, for the sorted case: asked for now,
  // they arrive while the scores are looked at
  float4 mine[DYK_NMS_MAX_K / DYK_NMS_THREADS];
#pragma unroll
  for (int u = 0; u < DYK_NMS_MAX_K / DYK_NMS_THREADS; ++u) {
    const int i = tid + u * DYK_NMS_THREADS;
    mine[u] = boxes[i < k ? i : 0];
  }
  for (int i = tid; i < k; i += DYK_NMS_THREADS) sc[i] = scores[i];
  __syncthreads();
  // nv = the number of valid scores; sorted = they descend as given (then
  // rank = index, since equal scores already stand lower index first)
  int nv = 0, sorted = 1;
  for (int base = 0; base < k; base += DYK_NMS_THREADS) {
    const int i = base + tid;
    const float s = i < k ? sc[i] : 0.0f;
    nv += __syncthreads_count(i < k && s > DYK_VALID_MIN);
    sorted &= __syncthreads_and(i + 1 >= k || s >= sc[i + 1]);
  }

  if (sorted) {
#pragma unroll
    for (int u = 0; u < DYK_NMS_MAX_K / DYK_NMS_THREADS; ++u) {
      const int i = tid + u * DYK_NMS_THREADS;
      if (i < k) {
        sbox[i] = mine[u];
        order[i] = i;
      }
    }
    cluster_wait();  // barrier 0
  } else {
    cluster_wait();  // barrier 0, before the first store into another block
    // this block ranks candidates crank * slab_rows ...; 4 threads each
    const int part = tid & 3;
    const int i = crank * slab_rows + (tid >> 2);
    const bool active = (tid >> 2) < slab_rows && i < k;
    int rank = 0;
    if (active) {
      const float si = sc[i];
      for (int j = part; j < k; j += 4) {
        const float sj = sc[j];
        rank += (sj > si || (sj == si && j < i)) ? 1 : 0;
      }
    }
    rank += __shfl_xor_sync(0xffffffffu, rank, 1);
    rank += __shfl_xor_sync(0xffffffffu, rank, 2);
    if (active) {
      const float4 box = boxes[i];
      for (uint32_t t = part; t < DYK_NMS_CLUSTER; t += 4) {
        st_remote(remote_addr(sbox + rank, t), box);
      }
      if (part == 0) {
        st_remote(remote_addr(order + rank, 0), static_cast<uint32_t>(i));
      }
    }
    cluster_arrive();  // barrier 1: the pool is in rank order everywhere
    cluster_wait();
  }
  __syncthreads();
  for (int i = tid; i < nv; i += DYK_NMS_THREADS) sarea[i] = box_area(sbox[i]);
  __syncthreads();

  // the upper triangle of the mask, in rank order: bit c of row r is
  // IoU(r, c) > iou_thres for r < c < nv. This block's rows are r = crank +
  // 8 q. A warp takes a word w of 32 columns (a lane keeps its column's box
  // and area) and walks the rows above it, DYK_NMS_UNROLL tests in flight.
  // Word w has about 4 (w + 1) such rows, so words are paired, w with nw -
  // 1 - w, and each pair's rows are dealt to 16 / pairs warps.
  const int nw = (nv + 31) >> 5;
  const int npairs = (nw + 1) >> 1;
  const int share = npairs > 0 ? max(1, DYK_NMS_WARPS / npairs) : 1;
  const int pair = warp / share;
  const int sub = warp - pair * share;
  const bool margins = iou_thres > 1e-6f;
  const float th_hi = margins ? iou_thres * (1.0f + 0x1p-20f) : INFINITY;
  const float th_lo = margins ? iou_thres * (1.0f - 0x1p-20f) : -INFINITY;
  for (int side = 0; side < 2 && pair < npairs; ++side) {
    const int w = side == 0 ? pair : nw - 1 - pair;
    if (side == 1 && w == pair) break;
    const int c = 32 * w + lane;
    const float4 bc = sbox[min(c, nv - 1)];
    const float ac = sarea[min(c, nv - 1)];
    // rows r = crank + 8 q < r_end lie above some column of this word
    const int r_end = min(nv, 32 * w + 31);
    const int c_cut = c < nv ? c : -1;    // row r is wanted for r < c_cut
    for (int q0 = sub; static_cast<int>(crank) + DYK_NMS_CLUSTER * q0 < r_end;
         q0 += DYK_NMS_UNROLL * share) {
      float inter[DYK_NMS_UNROLL], den[DYK_NMS_UNROLL];
#pragma unroll
      for (int u = 0; u < DYK_NMS_UNROLL; ++u) {
        const int r = min(static_cast<int>(crank) +
                              DYK_NMS_CLUSTER * (q0 + u * share),
                          r_end - 1);
        iou_terms(sbox[r], sarea[r], bc, ac, &inter[u], &den[u]);
      }
#pragma unroll
      for (int u = 0; u < DYK_NMS_UNROLL; ++u) {
        const int q = q0 + u * share;
        const int r = static_cast<int>(crank) + DYK_NMS_CLUSTER * q;
        const uint32_t bits = __ballot_sync(
            0xffffffffu, iou_over(inter[u], den[u], iou_thres, th_hi, th_lo,
                                  r < c_cut));
        if (lane == 0 && r < r_end) slab[q * words + w] = bits;
      }
    }
  }
  cluster_arrive();  // barrier 2: every block's rows are computed
  cluster_wait();
  if (crank == 0) {
    // gather the rows: row r is row r / 8 of block r % 8. Reads of another
    // block's shared memory are slow, so a thread keeps four in flight, of
    // 16 bytes where a row is a whole number of them, and skips what lies
    // wholly under the diagonal.
    if ((words & 3) == 0) {
      const int vpr = words >> 2;         // 16-byte vectors per row
      const int total = nv * vpr;
      uint4* mask4 = reinterpret_cast<uint4*>(mask);
      for (int t0 = tid; t0 < total; t0 += 4 * DYK_NMS_THREADS) {
        uint4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = min(t0 + u * DYK_NMS_THREADS, total - 1);
          const int r = t / vpr;
          const int j = t - r * vpr;
          v[u] = 4 * j + 3 >= (r >> 5)
                     ? ld_remote4(remote_addr(
                           slab + (r / DYK_NMS_CLUSTER) * words + 4 * j,
                           r % DYK_NMS_CLUSTER))
                     : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = t0 + u * DYK_NMS_THREADS;
          if (t < total) mask4[t] = v[u];
        }
      }
    } else {
      const int total = nv * words;
      for (int t0 = tid; t0 < total; t0 += 4 * DYK_NMS_THREADS) {
        uint32_t v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = min(t0 + u * DYK_NMS_THREADS, total - 1);
          const int r = t / words;
          const int w = t - r * words;
          v[u] = ld_remote(remote_addr(
              slab + (r / DYK_NMS_CLUSTER) * words + w, r % DYK_NMS_CLUSTER));
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = t0 + u * DYK_NMS_THREADS;
          if (t < total) mask[t] = v[u];
        }
      }
    }
  }
  // barrier 3: block 0 has read the others' rows (every value it read is
  // stored into its mask above, so the reads have returned; the release
  // orders them before the arrive besides) and the others may exit
  cluster_arrive();
  cluster_wait();
  if (crank != 0) return;
  __syncthreads();
  if (warp != 0) return;

  // the rounds, in one warp. Lane l holds the alive bits of ranks 32 l ...
  // 32 l + 31; the word being scanned is held by every lane (cur), so the
  // next winner is a find-first-set with no exchange between lanes, and a
  // round is that, two shared-memory reads of the winner's row (this lane's
  // word and the scanned word) and an and-not.
  uint32_t alive = 0;
  if (32 * lane < nv) {
    alive = nv - 32 * lane >= 32 ? 0xffffffffu
                                 : (1u << (nv - 32 * lane)) - 1u;
  }
  int n = 0;
  for (int wi = 0; wi < nw && n < max_det; ++wi) {
    uint32_t cur = __shfl_sync(0xffffffffu, alive, wi);
    while (cur != 0 && n < max_det) {
      const int b = __ffs(cur) - 1;
      const int r = 32 * wi + b;
      const uint32_t* row = mask + r * words;
      // words below wi hold no alive rank; what is read there is not used
      if (lane < words) alive &= ~row[lane];
      cur &= ~(row[wi] | (1u << b));
      if (lane == 0) win[n] = r;
      ++n;
    }
  }
  __syncwarp();
  for (int m = lane; m < max_det; m += 32) {
    idx_out[m] = m < n ? order[win[m]] : 0;
    valid_out[m] = m < n ? 1 : 0;
  }
}

}  // namespace

extern "C" const char* dyk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// boxes (bs, k, 4) fp32 xyxy and scores (bs, k) fp32, contiguous, on the
// device; idx (bs, max_det) int32 and valid (bs, max_det) bytes of 0 or 1.
// Returns cudaGetLastError().
extern "C" int dyk_nms(const float* boxes, const float* scores, int bs, int k,
                       float iou_thres, int max_det, int* idx,
                       unsigned char* valid, void* stream) {
  if (bs < 1 || k < 1 || k > DYK_NMS_MAX_K || max_det < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int words = (k + 31) / 32;
  const size_t smem =
      (((size_t)k * 28 + 15) & ~(size_t)15) +  // boxes, areas, scores, order
      (size_t)((k + DYK_NMS_CLUSTER - 1) / DYK_NMS_CLUSTER + k) * words *
          sizeof(uint32_t);
  static size_t smem_allowed = 0;         // raised once per pool size
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  nms_kernel<<<bs * DYK_NMS_CLUSTER, DYK_NMS_THREADS, smem,
               (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(boxes), scores, k, iou_thres, max_det,
      idx, valid);
  return (int)cudaGetLastError();
}
