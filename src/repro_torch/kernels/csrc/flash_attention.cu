// Flash attention (forward) for Hopper (sm_90a): online-softmax GQA
// attention with causal, sliding-window and logit soft-cap masking, in fp32.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel (the Pallas
// TPU kernel behind models/layers.py::attend(use_pallas=True), which every
// prefill layer of a dense decoder reaches through attention.gqa_forward).
//
// What it computes, as the Pallas kernel does: q (B, Sq, Hq, hd) and k, v
// (B, Sk, Hkv, hd), fp32 or bf16, read as fp32. Query head h reads KV head
// h / (Hq / Hkv). Scores s = (q . k) * scale, then tanh(s / cap) * cap when a
// cap is given, then the mask: key k is allowed for query row r (position
// r + q_offset) when k < Sk, k <= r + q_offset if causal, and
// k > r + q_offset - window if window > 0; masked scores are -2e38 (the
// reference's NEG_INF). Online max / sum rescaling and P.V in fp32; the
// output, acc / max(l, 1e-37), is rounded once to the input type.
//
// Bound on the H100: operations. At the LM serving path's prefill call
// (B=4, Sq=Sk=4608, 32/8 heads, hd 80, causal, window 4096) the band holds
// 1.342e9 (q, k) pairs at 320 flops each, 4.30e11 flops: 0.43 ms at the
// bf16 tensor-core peak, 6.4 ms at the fp32 peak outside the tensor cores,
// against 0.07 ms to move its 236 MB.
//
// Design (fp32 on the CUDA cores; tensor cores and TMA are later work):
//   * one block of 256 threads owns one (batch, query head, 64-row q tile)
//     and loops over 64-key tiles staged in shared memory; the loop takes
//     the place of the TPU's sequential kv grid axis. The q tiles are issued
//     heaviest first so that the short causal tiles fill the last wave;
//   * k tiles wholly outside the causal / window band are skipped. That is
//     exact: a fully masked tile met before a valid one adds p = 1 rows that
//     the valid tile's correction exp(-2e38 - m) = 0 wipes out. Without it
//     the serving prefill would do twice the work. Only a row that no key
//     may attend to (none on the port's paths) differs from the Pallas
//     kernel, which averages V over the tiles it visited: here it gets the
//     average over the visited tiles inside the band, or 0;
//   * each thread holds a 4 x 4 block of the 64 x 64 score tile and a
//     4-row x ceil(hd/16)-column block of the fp32 accumulator in registers.
//     Q and K tiles are stored transposed ([d][row], rows padded to 68
//     floats), so the score loop reads one 16-byte vector of each per d;
//     V is stored [key][d], so the P.V loop reads it conflict-free. Row
//     max and sum go through warp shuffles over the 16 threads of a row;
//   * the tensors are read in their public (B, S, H, hd) layout through
//     their strides (the last stride must be 1), with no transposed copies;
//     ragged Sq / Sk edges and head dims that are not a multiple of 16 are
//     zero-filled in shared memory and masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 scores each
constexpr int kLdt = kBQ + 4;    // row pitch of the transposed tiles (16-byte aligned)
constexpr float kNegInf = -2.0e38f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;  // contiguous (B, Sq, Hq, hd)
  int sq, sk, hq, hkv, hd;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale, cap;  // cap <= 0: no soft-cap
  int causal, window, q_offset;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int NC>
constexpr size_t smem_bytes() {
  return (2 * 16 * NC * kLdt + kBK * 16 * NC + kBQ * kLdt) * sizeof(float);
}

// NC = ceil(hd / 16): each thread accumulates NC output columns.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 2) flash_kernel(const Params p) {
  constexpr int HDP = 16 * NC;  // head dim padded to a multiple of 16
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [HDP][kLdt] Q tile, transposed
  float* kt = qt + HDP * kLdt;                  // [HDP][kLdt] K tile, transposed
  float* vs = kt + HDP * kLdt;                  // [kBK][HDP]  V tile
  float* ps = vs + kBK * HDP;                   // [kBQ][kLdt] probabilities

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < kBQ * HDP; i += kThreads) {
    const int r = i / HDP, d = i % HDP;
    float x = 0.f;
    if (q0 + r < p.sq && d < p.hd) x = to_f32(qg[(q0 + r) * p.q_ss + d]);
    qt[d * kLdt + r] = x;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // the k tiles that hold any allowed key of this q tile
  const int q_last = min(q0 + kBQ, p.sq) - 1;
  const int n_kt = (p.sk + kBK - 1) / kBK;
  int kt_lo = 0, kt_hi = n_kt;
  if (p.window > 0) {
    const int k_min = q0 + p.q_offset - p.window + 1;
    kt_lo = k_min > 0 ? k_min / kBK : 0;
  }
  if (p.causal) {
    const int k_max = q_last + p.q_offset;
    kt_hi = k_max < 0 ? 0 : min(n_kt, k_max / kBK + 1);
  }

  for (int kti = kt_lo; kti < kt_hi; ++kti) {
    const int k0 = kti * kBK;
    __syncthreads();  // the last tile's readers are done (and Q is stored)
    for (int i = tid; i < kBK * HDP; i += kThreads) {
      const int r = i / HDP, d = i % HDP;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < p.sk && d < p.hd) {
        kx = to_f32(kg[(k0 + r) * p.k_ss + d]);
        vx = to_f32(vg[(k0 + r) * p.v_ss + d]);
      }
      kt[d * kLdt + r] = kx;
      vs[r * HDP + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kLdt + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(kt + d * kLdt + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + p.q_offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        float x = s[i][j] * p.scale;
        if (p.cap > 0.f) x = tanhf(x / p.cap) * p.cap;
        bool ok = kpos < p.sk;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
      *reinterpret_cast<float4*>(ps + (ty * 4 + i) * kLdt + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * kLdt + kk);
        pv[i][0] = t.x; pv[i][1] = t.y; pv[i][2] = t.z; pv[i][3] = t.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float vv = vs[(kk + u) * HDP + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i][u], vv, acc[i][c]);
        }
    }
  }

  T* og = static_cast<T*>(p.out) + static_cast<long long>(b) * p.sq * p.hq * p.hd +
          static_cast<long long>(h) * p.hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= p.sq) continue;
    const float denom = fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < p.hd)
        og[static_cast<long long>(r) * p.hq * p.hd + d] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int NC>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NC>();
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<T, NC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.hq, batch);
  flash_kernel<T, NC><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, int batch, cudaStream_t s) {
  switch ((p.hd + 15) / 16) {
    case 1: return launch<T, 1>(p, batch, s);
    case 2: return launch<T, 2>(p, batch, s);
    case 3: return launch<T, 3>(p, batch, s);
    case 4: return launch<T, 4>(p, batch, s);
    case 5: return launch<T, 5>(p, batch, s);
    case 6: return launch<T, 6>(p, batch, s);
    case 7: return launch<T, 7>(p, batch, s);
    case 8: return launch<T, 8>(p, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16 (q, k, v and out alike). q/k/v strides are in
// elements for the batch, sequence and head axes; the head-dim stride is 1.
// out is a contiguous (B, Sq, Hq, hd) tensor of the same dtype. cap <= 0
// means no soft-cap; window <= 0 means no window. Returns
// cudaGetLastError() after the launch, or a refusal code.
int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* out,
                        int batch, int sq, int sk, int hq, int hkv, int hd,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        float scale, float cap, int causal, int window, int q_offset,
                        void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || hd <= 0 || hd > 128 || hkv <= 0 ||
      hq % hkv != 0 || hq > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, out, sq, sk, hq, hkv, hd,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 scale, cap, causal, window, q_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, batch, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
