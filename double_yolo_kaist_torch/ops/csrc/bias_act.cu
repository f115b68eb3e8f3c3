// K5 on Hopper: a conv's bias + activation epilogue in one pass over its
// NHWC output, out = act(y + bias[c]), act linear, leaky or mish.
//
// It replaces no TPU kernel: XLA fuses a conv's bias and activation into
// the conv on the TPU. On the card the folded forward ran them eagerly:
// cuDNN's conv, then ATen's bias add (`at::_convolution` adds it as a
// separate broadcast pass), then the activation term by term (ops/act.py:
// leaky is two passes, mish eight). K5 is those passes in one.
//
// The same work, bit for bit. Eager PyTorch rounds each op's output to the
// tensor's type; K5 computes in fp32 and rounds to the compute type after
// every term at the same places, with the functions ATen's kernels call
// (the accurate expf, log1pf and tanhf: no fast-math flag), so its output
// equals the eager output in bf16 and in fp32, NaN and inf included:
//   t = rnd(y + b)
//   leaky: max(t, rnd(t * rnd(0.1)))                  (NaN-propagating max)
//   mish:  rnd(t * rnd(tanhf(rnd(max(t, 0) + rnd(log1pf(rnd(expf(
//          -|t|))))))))
// Adds and products are __fadd_rn / __fmul_rn, never contracted.
//
// Bound: bytes for leaky and linear (one read and one write of the output
// at 3.35 TB/s); mish is bound by its accurate exp, log1p and tanh on the
// CUDA cores, about 93 instructions a value: on an H100 it runs at about
// 40% of the bytes bound.
// Design: a grid-stride walk, 8 channels a thread a step (a 16-byte vector
// of bf16, two of fp32), the 8 biases as one read-only 16-byte load (the
// bias is a few KB and stays in L1 / L2), the channel of each step carried
// along by one add and one compare (no division in the loop), and a scalar
// walk for channel counts that are not multiples of 8 (the heads' 18) or
// unaligned pointers. out may be y (in place): each value is read once,
// before its own write, by the thread that writes it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;                  // channels a thread takes a step
constexpr int BLOCKS_PER_SM = 8;        // 2048 threads: a full SM

enum Act { ACT_LINEAR = 0, ACT_LEAKY = 1, ACT_MISH = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);           // round to nearest even, as c10's
}

// The value an eager op stores: rounded to T and read back.
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

template <typename T, int ACT>
__device__ __forceinline__ float epilogue(float y, float b) {
  const float t = rnd<T>(__fadd_rn(y, b));
  if (ACT == ACT_LEAKY) {
    // ops/act.py: torch.maximum(x, x * tensor(0.1, x.dtype))
    const float s = rnd<T>(__fmul_rn(t, rnd<T>(0.1f)));
    return t != t ? t : (s != s ? s : fmaxf(t, s));
  }
  if (ACT == ACT_MISH) {
    // ops/act.py: x * tanh(clamp_min(x, 0) + log1p(exp(-abs(x)))). t is a
    // value of T, so max(t, 0), |t| and -|t| are too: their roundings are
    // exact and left out (a NaN stays a NaN, which the last product makes
    // the canonical one, as the eager product does).
    const float relu = t != t ? t : fmaxf(t, 0.0f);
    const float e = rnd<T>(expf(-fabsf(t)));
    const float sp = rnd<T>(__fadd_rn(relu, rnd<T>(log1pf(e))));
    return rnd<T>(__fmul_rn(t, rnd<T>(tanhf(sp))));
  }
  return t;
}

// 8 values of T <-> 8 floats through 16-byte (bf16) or 2 x 16-byte (fp32)
// vectors.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void ldg8(const __nv_bfloat16* p, float (&v)[VEC]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void ldg8(const float* p, float (&v)[VEC]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[VEC]) {
  uint4 u;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < VEC; ++i) h[i] = __float2bfloat16(v[i]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[VEC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// C % 8 == 0, every pointer 16-byte aligned: thread step i takes the 8
// channels of vector v = first + i * stride, whose first channel c is
// carried along: c advances by step_c = stride * 8 mod C each step.
template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
bias_act_kernel(const T* y, const T* __restrict__ bias, T* out,
                long long nvec, int C, int step_c) {
  const long long stride = (long long)gridDim.x * THREADS;
  long long v = (long long)blockIdx.x * THREADS + threadIdx.x;
  int c = (int)((v * VEC) % C);
  for (; v < nvec; v += stride) {
    float x[VEC], b[VEC];
    load8(y + v * VEC, x);
    ldg8(bias + c, b);
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = epilogue<T, ACT>(x[i], b[i]);
    store8(out + v * VEC, x);
    c += step_c;
    if (c >= C) c -= C;
  }
}

// Any C and alignment: one value a thread a step, its channel carried
// along as above (step_c = stride mod C).
template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
bias_act_kernel_scalar(const T* y, const T* __restrict__ bias, T* out,
                       long long n, int C, int step_c) {
  const long long stride = (long long)gridDim.x * THREADS;
  long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  int c = (int)(i % C);
  for (; i < n; i += stride) {
    out[i] = from_f<T>(epilogue<T, ACT>(to_f(y[i]), to_f(bias[c])));
    c += step_c;
    if (c >= C) c -= C;
  }
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
        != cudaSuccess || n <= 0) {
      return 132;
    }
    cached[dev] = n;
  }
  return cached[dev];
}

template <typename T, int ACT>
int run(const void* y, const void* bias, void* out, long long n, int C,
        cudaStream_t st) {
  const T* yp = static_cast<const T*>(y);
  const T* bp = static_cast<const T*>(bias);
  T* op = static_cast<T*>(out);
  const long long cap = (long long)sm_count() * BLOCKS_PER_SM;
  const bool vec = C % VEC == 0 &&
      ((uintptr_t)y | (uintptr_t)bias | (uintptr_t)out) % 16 == 0;
  const long long items = vec ? n / VEC : n;
  long long blocks = (items + THREADS - 1) / THREADS;
  if (blocks > cap) blocks = cap;
  const long long stride = blocks * THREADS;
  if (vec) {
    const int step_c = (int)((stride * VEC) % C);
    bias_act_kernel<T, ACT><<<(int)blocks, THREADS, 0, st>>>(
        yp, bp, op, items, C, step_c);
  } else {
    const int step_c = (int)(stride % C);
    bias_act_kernel_scalar<T, ACT><<<(int)blocks, THREADS, 0, st>>>(
        yp, bp, op, items, C, step_c);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int run_act(const void* y, const void* bias, void* out, long long n, int C,
            int act, cudaStream_t st) {
  if (act == ACT_MISH) return run<T, ACT_MISH>(y, bias, out, n, C, st);
  if (act == ACT_LEAKY) return run<T, ACT_LEAKY>(y, bias, out, n, C, st);
  return run<T, ACT_LINEAR>(y, bias, out, n, C, st);
}

}  // namespace

extern "C" const char* dyk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// y, out: (N, C) contiguous (an NHWC tensor's memory: n = N * C values,
// channel fastest), bf16 (is_bf16) or fp32; out may be y. bias: (C,) of
// the same type. act: 0 linear, 1 leaky, 2 mish. Returns the launch's
// cudaError_t; n == 0 launches nothing.
extern "C" int dyk_bias_act(const void* y, const void* bias, void* out,
                            long long n, int C, int is_bf16, int act,
                            void* stream) {
  if (n < 0 || C < 1 || n % C != 0 || act < 0 || act > 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) return run_act<__nv_bfloat16>(y, bias, out, n, C, act, st);
  return run_act<float>(y, bias, out, n, C, act, st);
}
