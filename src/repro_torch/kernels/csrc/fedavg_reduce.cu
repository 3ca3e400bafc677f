// FedAvg reduce for Hopper (sm_90a): out[i] = sum_c w_c / (sum_c' w_c') *
// x[c, i] over C stacked flat client vectors, in fp32.
//
// Replaces: src/repro/kernels/fedavg_reduce.py::_fedavg_kernel (the Pallas
// TPU kernel behind the Eq. 3 flat average, reached from
// core/hierarchy.py::fedavg_flat_kernel when use_kernel_aggregation is set).
//
// Bound on the H100: bytes. About 2C flops per C*4 bytes read, far below
// the card's ratio of operations to bytes, so the least time is
// (C*N*4 + C*4 + N*4) bytes over 3.35 TB/s: at C=5 accepted BSs and the
// CNN's N=2,156,490 parameters that is about 51.8 MB, or 15.5 us.
//
// Design. One pass over the stack, each output element written once:
//   * each block normalises the C weights into shared memory first, in a
//     fixed order (C is a handful of BSs), so no separate launch is needed;
//   * a grid-stride loop over the output, where each thread loads one
//     vector of V fp32 values from each of the C rows and keeps V fp32
//     accumulators in registers. V = 4 (16-byte loads) when every row
//     starts 16-byte aligned, V = 1 otherwise. The wrapper module builds
//     the main path's stack with fedavg_reduce.stack_rows, whose row stride
//     is a multiple of 4 floats, so the round always runs at V = 4;
//   * the last N mod 4 elements go through a scalar tail (N = 2,156,490
//     leaves two of them).
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 8;

// V fp32 values as one load/store: float4 (16 bytes) or float.
template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  static __device__ void unpack(const float4 v, float (&f)[4]) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  static __device__ float4 pack(const float (&f)[4]) { return make_float4(f[0], f[1], f[2], f[3]); }
};
template <>
struct Vec<1> {
  using T = float;
  static __device__ void unpack(const float v, float (&f)[1]) { f[0] = v; }
  static __device__ float pack(const float (&f)[1]) { return f[0]; }
};

template <int V>
__global__ void __launch_bounds__(kThreads)
fedavg_kernel(const float* __restrict__ x, long long ld,
              const float* __restrict__ w, int c, float* __restrict__ out,
              long long n) {
  extern __shared__ float wn[];
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int j = 0; j < c; ++j) total += w[j];
    for (int j = 0; j < c; ++j) wn[j] = w[j] / total;
  }
  __syncthreads();
  using T = typename Vec<V>::T;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nvec = n / V;
  for (long long i = tid; i < nvec; i += stride) {
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
    for (int j = 0; j < c; ++j) {
      float f[V];
      Vec<V>::unpack(reinterpret_cast<const T*>(x + j * ld)[i], f);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = fmaf(wn[j], f[e], acc[e]);
    }
    reinterpret_cast<T*>(out)[i] = Vec<V>::pack(acc);
  }
  for (long long i = nvec * V + tid; i < n; i += stride) {
    float acc = 0.f;
    for (int j = 0; j < c; ++j) acc = fmaf(wn[j], x[j * ld + i], acc);
    out[i] = acc;
  }
}

template <int V>
int launch(const float* x, long long ld, const float* w, int c, float* out, long long n,
           cudaStream_t s) {
  const long long work = std::max(n / V, 1LL);
  const long long blocks = std::min((work + kThreads - 1) / kThreads, kMaxBlocks);
  fedavg_kernel<V><<<static_cast<unsigned>(blocks), kThreads, c * sizeof(float), s>>>(
      x, ld, w, c, out, n);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

// x: c rows of n fp32 values on the device, row j at x + j*ld (ld >= n);
// w: (c,) fp32 raw weights; out: (n,) fp32. Returns cudaGetLastError()
// after the launch, or a refusal code.
int fedavg_reduce_f32(const float* x, long long ld, const float* w, int c,
                      float* out, long long n, void* stream) {
  if (n <= 0 || c <= 0 || ld < n || c > 8192) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ld % 4 == 0 && aligned(x, 16) && aligned(out, 16)) return launch<4>(x, ld, w, c, out, n, s);
  return launch<1>(x, ld, w, c, out, n, s);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
