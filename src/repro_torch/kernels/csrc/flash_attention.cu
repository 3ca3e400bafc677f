// Flash attention (forward) for Hopper (sm_90a): online-softmax GQA
// attention with causal, sliding-window and logit soft-cap masking.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel (the Pallas
// TPU kernel behind models/layers.py::attend(use_pallas=True), which every
// prefill layer of a dense decoder reaches through attention.gqa_forward).
//
// What it computes, as the Pallas kernel does: q (B, Sq, Hq, hd) and k, v
// (B, Sk, Hkv, hd), fp32 or bf16. Query head h reads KV head h / (Hq / Hkv).
// Scores s = (q . k) * scale, then tanh(s / cap) * cap when a cap is given,
// then the mask: key k is allowed for query row r (position r + q_offset)
// when k < Sk, k <= r + q_offset if causal, and k > r + q_offset - window if
// window > 0; masked scores are -2e38 (the reference's NEG_INF). Online max /
// sum rescaling in fp32; the output, acc / max(l, 1e-37), is rounded once to
// the input type.
//
// Bound on the H100: operations. At the LM serving path's prefill call
// (B=4, Sq=Sk=4608, 32/8 heads, hd 80, causal, window 4096, bf16) the band
// holds 1.342e9 (q, k) pairs at 320 flops each, 4.30e11 flops: 0.43 ms at the
// bf16 tensor-core peak, 6.4 ms at the fp32 peak outside the tensor cores,
// against 0.07 ms to move its 236 MB. So only the tensor cores can bring
// the bf16 call near its bound, and two variants live here, chosen by dtype:
//
// bf16: tensor cores (flash_kernel_bf16_tc), FlashAttention-2's shape.
//   * one block of 8 warps owns one (batch, query head,
//     128-row q tile); each warp owns 16 query rows and loops over the
//     64-key tiles of the block's causal / window band. The grid is one
//     axis with the q tile slowest, so that every head's heaviest tiles go
//     first and the short causal tiles fill the last wave. Up to hd 80 the
//     registers are capped at 128 a thread, so that two blocks (16 warps)
//     share an SM. At the prefill's call 8 warps a block beat 4 by ~13%
//     (PERF.md);
//   * Q, K and V come into shared memory by 16-byte cp.async copies, read
//     through their strides (rows must be 16-byte aligned; the wrapper
//     checks). K and V run in a two-stage ring: tile j + 1 is in flight
//     while tile j is computed, with one barrier a tile. Rows are padded
//     by 16 bytes (hd 80: 176-byte pitch), so that the eight rows an
//     ldmatrix reads fall on eight different bank groups;
//   * S = Q.K^T is mma.sync m16n8k16 (bf16 in, fp32 accumulators), with
//     Q's A fragments and K's B fragments by ldmatrix at each k-step (Q kept
//     in registers instead, 20 more a thread at hd 80, measured 2-3%
//     slower under the 128-register cap); scale, soft-cap and mask act on the
//     accumulators in registers, and only tiles that cross the diagonal,
//     the window's lower edge or Sk compute the per-element mask. The
//     softmax works in log2 units (exp2 with log2(e) folded into the scale)
//     and reduces rows over the 4 threads of a quad by shuffles;
//   * P is rounded to bf16 in registers, where the accumulator layout of two
//     adjacent n-tiles is the A layout of the next mma, and O += P.V takes
//     V's B fragments by ldmatrix.trans; l sums the fp32 P. Only P's
//     rounding departs from the reference's fp32 math (relative 2^-9 a
//     weight); bf16 x bf16 products are exact in fp32;
//   * the output goes through the warp's own rows of the Q tile to 16-byte
//     stores. hd is padded to HD = 16 * ceil(hd / 16) with zeros, up to 256
//     (gemma2's head dim).
//
// fp32: CUDA cores (flash_kernel_f32). Its inputs are held to 2e-5, which
// bf16 or TF32 tensor cores cannot meet. One block of 256 threads owns a
// 64-row q tile; each thread holds a 4 x 4 block of the 64 x 64 score tile
// and a 4-row x ceil(hd/16)-column block of the accumulator in registers.
// Q and K tiles are stored transposed ([d][row], rows padded to 68 floats),
// V as [key][d]; row max and sum go through warp shuffles over the 16
// threads of a row.
//
// Both variants skip k tiles wholly outside the causal / window band (the
// serving prefill would otherwise do twice the work). That is exact: a
// fully masked tile met before a valid one adds p = 1 rows that the valid
// tile's correction exp(-2e38 - m) = 0 wipes out. Only a row that no key may
// attend to (none on the port's paths) differs from the Pallas kernel,
// which averages V over the tiles it visited: here it gets the average over
// the visited tiles inside its block's band, or 0. Ragged Sq / Sk edges and
// padded head dims are zero-filled in shared memory and masked.
//
// What still holds the bf16 variant back: at the prefill's call it does
// about a fifth of the bf16 peak's work rate. Per warp and 64-key tile it
// issues 80 mma.sync and 40 ldmatrix beside ~300 other instructions
// (softmax, rescale, copies), with 4 warps an SM sub-partition to hide
// their latencies; 32 rows a warp (FlashAttention-2's layout) needs 245+
// registers and measured slower. Hopper's own path is FlashAttention-3's:
// wgmma on 64-row warpgroup tiles with operands in shared memory, TMA into
// an mbarrier ring from a producer warp, and the softmax of one tile
// overlapped with the products of the next.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kWarps = 8;  // warps (16 query rows each) in a bf16 block
constexpr int kMaxHeadDim = 256;

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

// The k tiles of width bk that hold any allowed key of the q rows
// [q0, q_last]: [lo, hi).
__device__ __forceinline__ void band_tiles(const Params& p, int q0, int q_last, int bk,
                                           int& lo, int& hi) {
  const int n = (p.sk + bk - 1) / bk;
  lo = 0;
  hi = n;
  if (p.window > 0) {
    const int k_min = q0 + p.q_offset - p.window + 1;
    lo = k_min > 0 ? k_min / bk : 0;
  }
  if (p.causal) {
    const int k_max = q_last + p.q_offset;
    hi = k_max < 0 ? 0 : min(n, k_max / bk + 1);
  }
}

// ------------------------------------------------------------------------
// bf16 on the tensor cores

constexpr int kBK = 64;  // keys per tile (both variants)

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared; the bytes past src_bytes (0..16) are zeroed
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values as one bf16x2 mma operand register (lo in the lower half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int HD>
struct TcShape {
  static constexpr int kLd = HD + 8;        // row pitch in elements: 16 bytes of padding
  static constexpr int kChunks = HD / 8;    // 16-byte chunks a row
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kThreads = 32 * kWarps;
  // up to hd 80 the registers are capped at 128 a thread, so that 16 warps
  // share an SM (uncapped, hd 80 takes 160 and leaves 12 or 8); above, one
  // block an SM, uncapped (at hd 256 the tiles take ~203 KB of shared
  // memory and the accumulator 128 registers a thread)
  static constexpr int kMinBlocks = HD <= 80 ? 16 / kWarps : 1;
  static constexpr size_t kTileElems = static_cast<size_t>(kBK) * kLd;
  static constexpr size_t kSmem =
      (static_cast<size_t>(kRows) * kLd + 4 * kTileElems) * sizeof(__nv_bfloat16);
};

// rows x HD tile, row r from src + r * stride (zero past n_rows or hd)
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int n_rows, int hd) {
  using S = TcShape<HD>;
  for (int c = threadIdx.x; c < ROWS * S::kChunks; c += S::kThreads) {
    const int r = c / S::kChunks, d = (c % S::kChunks) * 8;
    const __nv_bfloat16* g = src;
    int bytes = 0;
    if (r < n_rows && d < hd) {
      g = src + r * stride + d;
      bytes = min(16, (hd - d) * 2);
    }
    cp_async16(smem_u32(dst + r * S::kLd + d), g, bytes);
  }
}

template <int HD>
__global__ void __launch_bounds__(TcShape<HD>::kThreads, TcShape<HD>::kMinBlocks)
    flash_kernel_bf16_tc(const Params p) {
  using S = TcShape<HD>;
  constexpr int KS = HD / 16;  // k-steps of Q.K^T; d-tile pairs of P.V
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr float kMasked = kNegInf * kLog2e;  // -2.9e38, finite
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem4);  // [kRows][kLd]
  __nv_bfloat16* sk = sq + S::kRows * S::kLd;                    // [2][kBK][kLd]
  __nv_bfloat16* sv = sk + 2 * S::kTileElems;                    // [2][kBK][kLd]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // one grid axis, q tile slowest: every head's heaviest tiles go first
  const int n_qt = (p.sq + S::kRows - 1) / S::kRows, n_hb = gridDim.x / n_qt;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / n_hb) * S::kRows;
  const int h = blockIdx.x % n_hb % p.hq, b = blockIdx.x % n_hb / p.hq;
  const int hk = h / (p.hq / p.hkv);
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb +
                            h * p.q_sh + q0 * p.q_ss;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  int kt_lo, kt_hi;
  band_tiles(p, q0, min(q0 + S::kRows, p.sq) - 1, kBK, kt_lo, kt_hi);

  // this warp's 16 rows: their Q in shared memory, and their positions,
  // which bound its mask-free tiles
  const __nv_bfloat16* wq = sq + 16 * warp * S::kLd;
  const int wq_lo = q0 + 16 * warp + p.q_offset, wq_hi = wq_lo + 15;
  const bool capped = p.cap > 0.f;
  const float s_mul = capped ? p.scale / p.cap : p.scale * kLog2e;
  const float cap_log2e = p.cap * kLog2e;

  float o[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kMasked, m1 = kMasked;  // rows g and g + 8, log2 units
  float l0 = 0.f, l1 = 0.f;          // this thread's columns; quad-summed at the end

  auto load_kv = [&](int kti, int stage) {
    const int k0 = kti * kBK;
    load_tile<HD, kBK>(sk + stage * S::kTileElems, kg + k0 * p.k_ss, p.k_ss, p.sk - k0, p.hd);
    load_tile<HD, kBK>(sv + stage * S::kTileElems, vg + k0 * p.v_ss, p.v_ss, p.sk - k0, p.hd);
  };
  if (kt_lo < kt_hi) {
    load_tile<HD, S::kRows>(sq, qg, p.q_ss, p.sq - q0, p.hd);
    load_kv(kt_lo, 0);
    cp_async_commit();
  }

  for (int kti = kt_lo; kti < kt_hi; ++kti) {
    const int stage = (kti - kt_lo) & 1;
    cp_async_wait<0>();  // this thread's copies of tile kti (and Q) landed
    // one barrier a tile: every thread's copies of tile kti are visible, and
    // every warp is done with tile kti - 1, whose stage the next copy refills
    __syncthreads();
    if (kti + 1 < kt_hi) {
      load_kv(kti + 1, stage ^ 1);
      cp_async_commit();
    }
    const __nv_bfloat16* kt = sk + stage * S::kTileElems;
    const __nv_bfloat16* vt = sv + stage * S::kTileElems;
    const int k0 = kti * kBK;

    // S = Q . K^T: 16 x 64 a warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      ldmatrix_x4(qa, smem_u32(wq + (lane & 15) * S::kLd + kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t bf[4];
        ldmatrix_x4(bf, smem_u32(kt + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * S::kLd +
                                 kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * nj], qa, bf[0], bf[1]);
        mma_bf16(s[2 * nj + 1], qa, bf[2], bf[3]);
      }
    }

    // scale (log2 units), soft-cap, mask; c0, c1: row g; c2, c3: row g + 8
    const bool edge = k0 + kBK > p.sk || (p.causal && k0 + kBK - 1 > wq_lo) ||
                      (p.window > 0 && k0 <= wq_hi - p.window);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * s_mul;
        if (capped) x = tanhf(x) * cap_log2e;
        if (edge) {
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          const int qpos = wq_lo + g + 8 * (e >> 1);
          bool ok = key < p.sk;
          if (p.causal) ok = ok && key <= qpos;
          if (p.window > 0) ok = ok && key > qpos - p.window;
          x = ok ? x : kMasked;
        }
        s[n][e] = x;
      }
    }

    // online softmax over the quad that shares a row
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float corr0 = exp2_approx(m0 - mx0), corr1 = exp2_approx(m1 - mx1);
    m0 = mx0;
    m1 = mx1;

    // P in bf16, as the A fragments of 4 k-steps of 16 keys; l sums it in fp32
    uint32_t pa[4][4];
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = exp2_approx(s[n][0] - mx0), p1 = exp2_approx(s[n][1] - mx0);
      const float p2 = exp2_approx(s[n][2] - mx1), p3 = exp2_approx(s[n][3] - mx1);
      ls0 += p0 + p1;
      ls1 += p2 + p3;
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * corr0 + ls0;
    l1 = l1 * corr1 + ls1;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
      o[n][0] *= corr0;
      o[n][1] *= corr0;
      o[n][2] *= corr1;
      o[n][3] *= corr1;
    }

    // O += P . V: V's B fragments by ldmatrix.trans, two d-tiles at a time
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dj = 0; dj < KS; ++dj) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, smem_u32(vt + (kk * 16 + (lane & 15)) * S::kLd + dj * 16 +
                                       (lane >> 4) * 8));
        mma_bf16(o[2 * dj], pa[kk], bf[0], bf[1]);
        mma_bf16(o[2 * dj + 1], pa[kk], bf[2], bf[3]);
      }
    }
  }

  // epilogue: acc / max(l, 1e-37), rounded once, staged through this warp's
  // own 16 rows of the Q tile (no other warp reads them), then 16-byte stores
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float d0 = fmaxf(l0, 1e-37f), d1 = fmaxf(l1, 1e-37f);
  __nv_bfloat16* stage = sq + 16 * warp * S::kLd;
  __syncwarp();  // every lane's last Q fragment load is done
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) {
    const int col = 8 * n + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(stage + g * S::kLd + col) =
        __floats2bfloat162_rn(o[n][0] / d0, o[n][1] / d0);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * S::kLd + col) =
        __floats2bfloat162_rn(o[n][2] / d1, o[n][3] / d1);
  }
  __syncwarp();
  const long long row_stride = static_cast<long long>(p.hq) * p.hd;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out) +
                      static_cast<long long>(b) * p.sq * row_stride +
                      static_cast<long long>(h) * p.hd;
  const int r0 = q0 + 16 * warp;
  if (p.hd % 8 == 0) {
    const int chunks = p.hd / 8;
    for (int c = lane; c < 16 * chunks; c += 32) {
      const int r = c / chunks, d = (c % chunks) * 8;
      if (r0 + r < p.sq)
        *reinterpret_cast<uint4*>(og + (r0 + r) * row_stride + d) =
            *reinterpret_cast<const uint4*>(stage + r * S::kLd + d);
    }
  } else {
    for (int c = lane; c < 16 * p.hd; c += 32) {
      const int r = c / p.hd, d = c % p.hd;
      if (r0 + r < p.sq) og[(r0 + r) * row_stride + d] = stage[r * S::kLd + d];
    }
  }
}

template <int HD>
int launch_bf16_tc(const Params& p, int batch, cudaStream_t stream) {
  using S = TcShape<HD>;
  cudaError_t e = cudaFuncSetAttribute(flash_kernel_bf16_tc<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(S::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = static_cast<long long>((p.sq + S::kRows - 1) / S::kRows) * p.hq * batch;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  flash_kernel_bf16_tc<HD><<<grid, S::kThreads, S::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_bf16_tc(const Params& p, int batch, cudaStream_t s) {
  // cp.async moves 16-byte chunks: the rows must start 16-byte aligned
  const long long strides[9] = {p.q_sb, p.q_ss, p.q_sh, p.k_sb, p.k_ss,
                                p.k_sh, p.v_sb, p.v_ss, p.v_sh};
  for (long long st : strides)
    if (st % 8 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  const void* ptrs[3] = {p.q, p.k, p.v};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  switch ((p.hd + 15) / 16) {
    case 1: return launch_bf16_tc<16>(p, batch, s);
    case 2: return launch_bf16_tc<32>(p, batch, s);
    case 3: return launch_bf16_tc<48>(p, batch, s);
    case 4: return launch_bf16_tc<64>(p, batch, s);
    case 5: return launch_bf16_tc<80>(p, batch, s);
    case 6: return launch_bf16_tc<96>(p, batch, s);
    case 7: return launch_bf16_tc<112>(p, batch, s);
    case 8: return launch_bf16_tc<128>(p, batch, s);
    case 9: return launch_bf16_tc<144>(p, batch, s);
    case 10: return launch_bf16_tc<160>(p, batch, s);
    case 11: return launch_bf16_tc<176>(p, batch, s);
    case 12: return launch_bf16_tc<192>(p, batch, s);
    case 13: return launch_bf16_tc<208>(p, batch, s);
    case 14: return launch_bf16_tc<224>(p, batch, s);
    case 15: return launch_bf16_tc<240>(p, batch, s);
    case 16: return launch_bf16_tc<256>(p, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------------------------------
// fp32 on the CUDA cores

constexpr int kBQ = 64;          // query rows per block
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 scores each
constexpr int kLdt = kBQ + 4;    // row pitch of the transposed tiles (16-byte aligned)

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

// NC = ceil(hd / 16): each thread accumulates NC output columns. From NC 8
// on, the tiles take more than half of an SM's shared memory (222,208 bytes
// at NC 16, hd 256), so one block runs an SM; above NC 8 its registers are
// uncapped.
template <int NC>
__global__ void __launch_bounds__(kThreads, NC <= 8 ? 2 : 1) flash_kernel_f32(const Params p) {
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
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < kBQ * HDP; i += kThreads) {
    const int r = i / HDP, d = i % HDP;
    float x = 0.f;
    if (q0 + r < p.sq && d < p.hd) x = qg[(q0 + r) * p.q_ss + d];
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

  int kt_lo, kt_hi;
  band_tiles(p, q0, min(q0 + kBQ, p.sq) - 1, kBK, kt_lo, kt_hi);

  for (int kti = kt_lo; kti < kt_hi; ++kti) {
    const int k0 = kti * kBK;
    __syncthreads();  // the last tile's readers are done (and Q is stored)
    for (int i = tid; i < kBK * HDP; i += kThreads) {
      const int r = i / HDP, d = i % HDP;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < p.sk && d < p.hd) {
        kx = kg[(k0 + r) * p.k_ss + d];
        vx = vg[(k0 + r) * p.v_ss + d];
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

  float* og = static_cast<float*>(p.out) + static_cast<long long>(b) * p.sq * p.hq * p.hd +
              static_cast<long long>(h) * p.hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= p.sq) continue;
    const float denom = fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < p.hd) og[static_cast<long long>(r) * p.hq * p.hd + d] = acc[i][c] / denom;
    }
  }
}

template <int NC>
int launch_f32(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NC>();
  cudaError_t e = cudaFuncSetAttribute(flash_kernel_f32<NC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.hq, batch);
  flash_kernel_f32<NC><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const Params& p, int batch, cudaStream_t s) {
  switch ((p.hd + 15) / 16) {
    case 1: return launch_f32<1>(p, batch, s);
    case 2: return launch_f32<2>(p, batch, s);
    case 3: return launch_f32<3>(p, batch, s);
    case 4: return launch_f32<4>(p, batch, s);
    case 5: return launch_f32<5>(p, batch, s);
    case 6: return launch_f32<6>(p, batch, s);
    case 7: return launch_f32<7>(p, batch, s);
    case 8: return launch_f32<8>(p, batch, s);
    case 9: return launch_f32<9>(p, batch, s);
    case 10: return launch_f32<10>(p, batch, s);
    case 11: return launch_f32<11>(p, batch, s);
    case 12: return launch_f32<12>(p, batch, s);
    case 13: return launch_f32<13>(p, batch, s);
    case 14: return launch_f32<14>(p, batch, s);
    case 15: return launch_f32<15>(p, batch, s);
    case 16: return launch_f32<16>(p, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 fp32 (CUDA-core variant), 1 bf16 (tensor-core variant); q, k, v
// and out alike. q/k/v strides are in elements for the batch, sequence and
// head axes; the head-dim stride is 1. bf16 rows must be 16-byte aligned
// (pointers, and strides that are multiples of 8). out is a contiguous
// (B, Sq, Hq, hd) tensor of the same dtype. cap <= 0 means no soft-cap;
// window <= 0 means no window. Returns cudaGetLastError() after the launch,
// or a refusal code.
int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* out,
                        int batch, int sq, int sk, int hq, int hkv, int hd,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        float scale, float cap, int causal, int window, int q_offset,
                        void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || hd <= 0 || hd > kMaxHeadDim || hkv <= 0 ||
      hq % hkv != 0 || hq > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, out, sq, sk, hq, hkv, hd,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 scale, cap, causal, window, q_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(p, batch, s);
  if (dtype == 1) return dispatch_bf16_tc(p, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
