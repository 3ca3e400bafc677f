// Mamba-2 SSD chunked scan (forward) for Hopper (sm_90a): the chunk-parallel
// form, its products on the tensor cores in 3xTF32.
//
// Replaces: src/repro/kernels/ssd_scan.py::_ssd_kernel (the Pallas TPU
// kernel behind models/mamba.py::mamba_forward(use_pallas=True), which every
// layer of mamba2's prefill/scoring forward reaches).
//
// What it computes, as the Pallas kernel and ssd_chunked_ref do: x (B, S,
// H, P), dt (B, S, H), A (H,), Bm / Cm (B, S, N); y (B, S, H, P) in fp32.
// dt and A are fp32; x, Bm and Cm are all fp32 or all bf16 (the forward's
// conv output, read as it is: a bf16 value widened to fp32 is exact). Per
// chunk of Q steps and head h, with cum the in-chunk cumulative sum of
// dt * A[h] and total its last entry:
//   y_q = sum_{k <= q} (C_q . B_k) exp(cum_q - cum_k) dt_k x_k   (intra)
//       + exp(cum_q) C_q . h                                     (inter)
//   h  <- exp(total) h + sum_k exp(total - cum_k) B_k (outer) dt_k x_k
// with h (N, P) the state entering the chunk, 0 before the first one. The
// decay is masked before the exp (k > q would overflow). cum is summed in
// fp64 and each exponent is rounded to fp32 once before its exp, as in the
// plain version (models/mamba.py::ssd_chunked_ref): at full width |cum|
// reaches ~3,300, where an fp32 ulp is 2.4e-4.
//
// Bound on the H100. At mamba2-2.7b's forward call (B=4, S=4608, H=80,
// P=64, N=128, Q=256) the scan needs 7.38e10 flops and moves 0.58 GB with
// bf16 x, B, C (0.78 GB in fp32): 0.17 ms at 3.35 TB/s. Its products run on
// the TF32 tensor cores (495 TFLOP/s), split as
//   a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi,  a_hi = tf32(a), a_lo = tf32(a - a_hi)
// (3xTF32): one TF32 product rounds its operands at 2^-11, which cannot hold
// the reference tests' atol 2e-4 at |y| ~ 240; the split keeps ~fp32
// precision. A bf16 input widened to fp32 is exact in TF32 (its lo is 0), so
// with bf16 x, B and C the product terms with that operand's lo are skipped
// and each product takes two TF32 products: 1.5e11 of them, 0.30 ms.
//
// Design: the decomposition of the Mamba-2 paper (arXiv:2405.21060, sec. 6):
// chunk cumsum, chunk state, state passing, chunk scan, as five launches
// behind one call. Where the Pallas kernel walks the chunks in order and
// carries h in VMEM, here every chunk is independent but the cheap state
// passing, so the grid covers all (batch, chunk, head):
//   1. ssd_cum_kernel, one warp per (b, c, h): the fp64 scan of dt * A over
//      the chunk; stores cum (as an fp32 pair hi + lo), dt, exp(cum),
//      exp(total - cum) * dt and exp(total), each exponent rounded to fp32
//      once;
//   2. ssd_cb_kernel, per (b, c): C . B^T for the 64 x 64 tiles on or below
//      the diagonal, fp32 on the CUDA cores (1.2e9 flops in all; 19 MB that
//      every head then reads, mostly from L2);
//   3. ssd_state_kernel, per (b, c, h, 64 columns of P): the chunk's own
//      state s_c = (B^T . diag(exp(total - cum) dt)) . x, an (N x Q)(Q x P)
//      product on the tensor cores;
//   4. ssd_pass_kernel, per (b, h) and 4 state elements a thread: h_{c+1} =
//      exp(total_c) h_c + s_c over the chunks in order, in fp32, overwriting
//      s_c with h_c, the state entering chunk c;
//   5. ssd_out_kernel, per (b, c, h, 64-row q tile, 64 columns of P), the
//      4 q tiles of a unit side by side in the grid, heaviest first, so that
//      they share its state, x and C.B^T through L2: (C_q . h_c) scaled by
//      exp(cum_q), then W . x over the k tiles at or below the diagonal,
//      with the weight tile W = (C.B^T) exp(cum_q - cum_k) dt_k built in
//      registers (masked before the exp; on the diagonal tile a warp stops
//      at its last row), both products on the tensor cores into one
//      accumulator.
// Kernels 3 and 5 stream 64-deep operand tiles into shared memory through a
// two-stage cp.async ring (16-byte copies; a tensor whose rows are not
// 16-byte aligned is copied element by element instead), one barrier a
// tile. A warp owns 16 output rows and all 64 columns: mma.sync m16n8k8
// TF32, 8 n-tiles. Fragments are read from shared memory with the k order
// of each 8-step permuted (mma slot t <-> k = 2t, slot t + 4 <-> k = 2t + 1,
// the same for A and B), so that a fragment's two k values are adjacent: an
// fp32 pair is one 8-byte load, and a bf16 tile (x, C, B) gives four
// fragments' pairs to one ldmatrix (.trans for the [k][col] tiles). Tile
// pitches keep the loads free of bank conflicts. The TF32 rounding is done
// with integer adds, and the cum differences from fp32 pairs, off the card's
// slow conversion and 64-bit units. Sums run in a fixed order and no atomics
// are used: results repeat bit for bit. x, dt, Bm and Cm are read through
// their strides (last stride 1); y is contiguous.
//
// What holds it back (PERF.md: copies of this kernel with one part taken
// out, timed on an H100): at the forward's call the out kernel takes two
// thirds of the time. Its loads alone (2.5 GB of L2 traffic a call for the
// state, x, C and C.B^T tiles, each read by every q tile that needs it)
// keep 57% of its time, its arithmetic alone
// 76%; the products (4.9e7 mma.sync a call) are about a quarter of it and
// the weights' exp an eighth, the two halves overlapping only in part at
// 16 warps an SM. The next form keeps a unit's state and x in shared
// memory across its q tiles, and moves the products to wgmma.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kT = 64;  // rows, columns and k depth of a tile
constexpr int kMaxN = 128;
constexpr int kMaxQ = 1024;
constexpr int kOutWarps = 4;    // 16 q rows each
constexpr int kStateWarps = 8;  // 16 state rows each: N <= 128
constexpr int kRowLd = kT + 8;  // pitch of a row-major A tile (pairs along k)

using bf16_t = uint16_t;  // bf16 inputs, as raw bits

// pitch of a [k][col] tile read one element at a time along the columns
template <typename T>
__host__ __device__ constexpr int kmaj_ld(int cols) { return cols + (sizeof(T) == 4 ? 4 : 8); }

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* bm;
  const void* cm;
  float* cb;     // (batch * nc, Qp, Qp) C . B^T, tiles on or below the diagonal
  float2* cum;   // (units, Qp) in-chunk cumsum of dt * A as hi + lo; a unit is (b, c, h)
  float* aux;    // (3, units, Qp): dt, exp(cum), exp(total - cum) * dt; 0 / total past Q
  float* etot;   // (units,) exp(total)
  float* st;     // (units, N, P): chunk states, then the states entering each chunk
  float* y;      // contiguous (B, S, H, P)
  int batch, S, H, P, N, Q, Qp, nc;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss;
  int vec_x, vec_b, vec_c, vec_st;  // rows 16-byte aligned: cp.async copies
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// two adjacent fp32 elements of shared memory
__device__ __forceinline__ float2 ld2(const float* s) {
  return *reinterpret_cast<const float2*>(s);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
// 16 bytes global -> shared; the bytes past src_bytes (0..16) are zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// dst[r][c] = src[r * stride + c] for r < n_rows, c < n_cols, else 0; a
// ROWS x COLS tile of pitch LD. vec: 16-byte cp.async copies (src and stride
// 16-byte aligned), else element by element.
template <typename T, int ROWS, int COLS, int LD, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride, int n_rows,
                                          int n_cols, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T), CH = COLS / E;
    for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * E;
      const bool ok = r < n_rows && c < n_cols;
      const int bytes = ok ? min(E, n_cols - c) * static_cast<int>(sizeof(T)) : 0;
      cp_async16(dst + r * LD + c, ok ? src + r * stride + c : src, bytes);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, c = i % COLS;
      dst[r * LD + c] = (r < n_rows && c < n_cols) ? src[r * stride + c] : T(0);
    }
  }
}

// 8 x 8 matrices of 16-bit elements from shared memory (lanes 8i .. 8i + 7
// give the row addresses of matrix i); thread l gets the 32-bit pair at row
// l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of each, or with .trans at
// rows 2 (l % 4) and 2 (l % 4) + 1 of column l / 4: with the permuted k
// order, a pair along k is the (slot t, slot t + 4) pair of one fragment
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(ptr)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(ptr)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(ptr)));
}
// the two bf16 of a pair, widened: exact TF32 operands
__device__ __forceinline__ uint32_t bf_lo(uint32_t w) { return w << 16; }
__device__ __forceinline__ uint32_t bf_hi(uint32_t w) { return w & 0xffff0000u; }

// ---- 3xTF32 on mma.sync m16n8k8 ----

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero
// as cvt.rna.tf32.f32 does, by integer adds: the conversion instruction runs
// on the card's slow conversion unit
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct Split {
  uint32_t hi, lo;
};
// x = hi + lo in TF32 (a widened bf16 value is its own hi, lo 0: the bf16
// paths build that Split directly)
__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = tf32(x);
  return {hi, tf32(x - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in 3xTF32: the small terms first, the terms with an exact
// operand's lo skipped
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], const Split& b0,
                                     const Split& b1) {
  if (!A_EXACT) mma_tf32(d, alo, b0.hi, b1.hi);
  if (!B_EXACT) mma_tf32(d, ahi, b0.lo, b1.lo);
  mma_tf32(d, ahi, b0.hi, b1.hi);
}

// A fragment from four fp32 values: rows g, g + 8 at slots t (k = 2t) and
// t + 4 (k = 2t + 1)
__device__ __forceinline__ void split_a(uint32_t (&hi)[4], uint32_t (&lo)[4], float a0, float a1,
                                        float a2, float a3) {
  const float v[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split s = split(v[i]);
    hi[i] = s.hi;
    lo[i] = s.lo;
  }
}

// (ah + al) - (bh + bl), rounded to fp32 once: the difference of two cum
// values kept as fp32 pairs, hi + lo, whose sum is the fp64 cumsum to ~48
// bits. TwoSum of the high parts keeps their difference exact; the low
// parts join it before the one rounding. So the exponent is the fp64
// difference rounded to fp32, as in the plain version, from fp32 adds only
// (a double subtraction and its conversion to fp32 run on the card's
// slow 64-bit units)
__device__ __forceinline__ float diff_hilo(float ah, float al, float bh, float bl) {
  const float s = ah - bh;
  const float v = s - ah;
  const float e = (ah - (s - v)) + (-bh - v);
  return s + (e + (al - bl));
}

// one intra weight (C.B^T)_qk exp(cum_q - cum_k) dt_k, masked before the exp
__device__ __forceinline__ float weight(bool keep, float cb, float2 cq, float kh, float kl,
                                        float dt) {
  const float d = diff_hilo(cq.x, cq.y, kh, kl);  // computed either way: no branch
  const float e = expf(keep ? d : 0.f);
  return keep ? cb * e * dt : 0.f;
}

// ---- 1. in-chunk cumsum, one warp per unit (b, c, h) ----

__global__ void __launch_bounds__(256) ssd_cum_kernel(Params p) {
  const int lane = threadIdx.x & 31;
  const long long u = blockIdx.x * 8LL + (threadIdx.x >> 5);
  const long long units = static_cast<long long>(p.batch) * p.nc * p.H;
  if (u >= units) return;
  const int h = static_cast<int>(u % p.H);
  const long long bc = u / p.H;
  const int c = static_cast<int>(bc % p.nc), b = static_cast<int>(bc / p.nc);
  const float a_h = p.A[h];
  const float* dtb = p.dt + b * p.dt_sb + h * p.dt_sh + static_cast<long long>(c) * p.Q * p.dt_ss;
  float2* cum = p.cum + u * p.Qp;
  float* dts = p.aux + u * p.Qp;
  float* ecum = dts + units * p.Qp;
  float* edt = ecum + units * p.Qp;
  // 32 steps at a time, one a lane: a warp scan in fp64, then the carry
  double carry = 0.0;
  for (int k = lane; k < p.Qp; k += 32) {
    const float d = k < p.Q ? dtb[k * p.dt_ss] : 0.f;
    double v = static_cast<double>(d * a_h);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double up = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += up;
    }
    const double ck = carry + v;
    carry = __shfl_sync(0xffffffffu, ck, 31);
    const float hi = static_cast<float>(ck);
    cum[k] = make_float2(hi, static_cast<float>(ck - hi));
    dts[k] = d;
    ecum[k] = expf(static_cast<float>(ck));
  }
  const double total = carry;  // the padding adds 0
  for (int k = lane; k < p.Qp; k += 32) {
    const float2 ck = cum[k];
    edt[k] = expf(static_cast<float>(total - (static_cast<double>(ck.x) + ck.y))) * dts[k];
  }
  if (lane == 0) p.etot[u] = expf(static_cast<float>(total));
}

// ---- 2. C . B^T per (b, c), 64 x 64 tiles on or below the diagonal ----

constexpr int kCbN = 32;  // n depth of a step
constexpr int kCbLd = kT + 4;

template <typename T>
__global__ void __launch_bounds__(256) ssd_cb_kernel(Params p) {
  const int qt = blockIdx.x, kt = blockIdx.y, bc = blockIdx.z;
  if (kt > qt) return;
  const int b = bc / p.nc, c = bc % p.nc;
  const T* cm = static_cast<const T*>(p.cm);
  const T* bm = static_cast<const T*>(p.bm);
  __shared__ __align__(16) float ct[kCbN * kCbLd];
  __shared__ __align__(16) float bt[kCbN * kCbLd];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long s0 = static_cast<long long>(c) * p.Q;
  float acc[4][4] = {};
  for (int n0 = 0; n0 < p.N; n0 += kCbN) {
    for (int e = tid; e < kT * kCbN; e += 256) {
      const int r = e / kCbN, n = e % kCbN;
      const int qi = qt * kT + r, ki = kt * kT + r;
      const bool nv = n0 + n < p.N;
      ct[n * kCbLd + r] = (nv && qi < p.Q) ? widen(cm[b * p.c_sb + (s0 + qi) * p.c_ss + n0 + n]) : 0.f;
      bt[n * kCbLd + r] = (nv && ki < p.Q) ? widen(bm[b * p.b_sb + (s0 + ki) * p.b_ss + n0 + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int n = 0; n < kCbN; ++n) {
      const float4 a = *reinterpret_cast<const float4*>(&ct[n * kCbLd + ty * 4]);
      const float4 v = *reinterpret_cast<const float4*>(&bt[n * kCbLd + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = p.cb + static_cast<long long>(bc) * p.Qp * p.Qp;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = qt * kT + ty * 4 + i;
    *reinterpret_cast<float4*>(&out[static_cast<long long>(q) * p.Qp + kt * kT + tx * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// ---- 3. chunk states, per (unit, 64 columns of P) ----

template <typename T>
struct StateShape {
  static constexpr int kLdB = kmaj_ld<T>(kMaxN);  // Bm tile [k][n]
  static constexpr int kLdX = kmaj_ld<T>(kT);     // x tile [k][p]
  static constexpr int kStage = kT * (kLdB + kLdX);  // elements
  static size_t smem(int qp) { return 2 * kStage * sizeof(T) + qp * sizeof(float); }
};

// s[n][p] = sum_k Bm[k][n] (exp(total - cum_k) dt_k) x[k][p]: A = Bm^T
// scaled by the decay (fp32, split), B = x (exact when bf16)
template <typename T>
__global__ void __launch_bounds__(32 * kStateWarps, 2) ssd_state_kernel(Params p) {
  using S = StateShape<T>;
  constexpr bool EXACT = sizeof(T) == 2;
  constexpr int kThreads = 32 * kStateWarps;
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);
  float* edt_s = reinterpret_cast<float*>(ring + 2 * S::kStage);  // [Qp]

  const int npt = (p.P + kT - 1) / kT;
  const int pt = blockIdx.x % npt;
  const long long u = blockIdx.x / npt;
  const int h = static_cast<int>(u % p.H);
  const long long bc = u / p.H;
  const int c = static_cast<int>(bc % p.nc), b = static_cast<int>(bc / p.nc);
  const int p0 = pt * kT;
  const long long s0 = static_cast<long long>(c) * p.Q;
  const long long units = static_cast<long long>(p.batch) * p.nc * p.H;
  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + s0 * p.x_ss + h * p.x_sh + p0;
  const T* bg = static_cast<const T*>(p.bm) + b * p.b_sb + s0 * p.b_ss;
  const float* edt = p.aux + 2 * units * p.Qp + u * p.Qp;
  for (int k = threadIdx.x; k < p.Qp; k += kThreads) edt_s[k] = edt[k];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * warp;  // this warp's state rows
  const bool active = m0 < p.N;
  const int n_kt = p.Qp / kT;
  auto issue = [&](int kt, int stage) {
    T* bs = ring + stage * S::kStage;
    const int k0 = kt * kT;
    load_tile<T, kT, kMaxN, S::kLdB, kThreads>(bs, bg + k0 * p.b_ss, p.b_ss, p.Q - k0, p.N,
                                               p.vec_b);
    load_tile<T, kT, kT, S::kLdX, kThreads>(bs + kT * S::kLdB, xg + k0 * p.x_ss, p.x_ss,
                                            p.Q - k0, p.P - p0, p.vec_x);
    cp_async_commit();
  };

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  issue(0, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    if (kt + 1 < n_kt) issue(kt + 1, (kt + 1) & 1);
    if (!active) continue;
    const T* bs = ring + (kt & 1) * S::kStage;
    const T* xs = bs + kT * S::kLdB;
    const float* e = edt_s + kt * kT;
#pragma unroll 2
    for (int ks = 0; ks < kT; ks += 8) {
      const int kk = ks + 2 * t;
      const float2 d = *reinterpret_cast<const float2*>(e + kk);
      uint32_t ahi[4], alo[4];
      if constexpr (EXACT) {
        uint32_t bp[2], xp[8];
        ldsm_x2_t(bp, bs + (ks + (lane & 7)) * S::kLdB + m0 + 8 * ((lane >> 3) & 1));
        split_a(ahi, alo, __uint_as_float(bf_lo(bp[0])) * d.x,
                       __uint_as_float(bf_lo(bp[1])) * d.x, __uint_as_float(bf_hi(bp[0])) * d.y,
                       __uint_as_float(bf_hi(bp[1])) * d.y);
        const T* xr = xs + (ks + (lane & 7)) * S::kLdX + 8 * (lane >> 3);
        ldsm_x4_t(xp, xr);
        ldsm_x4_t(xp + 4, xr + 32);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mma3<false, true>(acc[j], ahi, alo, Split{bf_lo(xp[j]), 0u}, Split{bf_hi(xp[j]), 0u});
      } else {
        const T* b0 = bs + kk * S::kLdB + m0 + g;
        split_a(ahi, alo, widen(b0[0]) * d.x, widen(b0[8]) * d.x,
                       widen(b0[S::kLdB]) * d.y, widen(b0[S::kLdB + 8]) * d.y);
        const T* x0 = xs + kk * S::kLdX + g;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const Split bv0 = split(widen(x0[8 * j]));
          const Split bv1 = split(widen(x0[S::kLdX + 8 * j]));
          mma3<false, false>(acc[j], ahi, alo, bv0, bv1);
        }
      }
    }
  }
  if (!active) return;
  float* sg = p.st + u * p.N * p.P;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = p0 + 8 * j + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = m0 + g + 8 * half;
      if (n >= p.N) continue;
      float* dst = sg + static_cast<long long>(n) * p.P + col;
      if (col + 1 < p.P && p.P % 2 == 0) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
      } else {
        if (col < p.P) dst[0] = acc[j][2 * half];
        if (col + 1 < p.P) dst[1] = acc[j][2 * half + 1];
      }
    }
  }
}

// ---- 4. state passing, per (b, h), in chunk order ----

template <int U>  // chunks a group; the next group's loads are in flight while one is stored
__global__ void __launch_bounds__(256) ssd_pass_kernel(Params p) {
  const long long np = static_cast<long long>(p.N) * p.P;
  const long long e0 = (blockIdx.x * 256LL + threadIdx.x) * 4;
  if (e0 >= np) return;
  const int h = blockIdx.y % p.H, b = blockIdx.y / p.H;
  const long long cstride = static_cast<long long>(p.H) * np;
  float* base = p.st + (static_cast<long long>(b) * p.nc * p.H + h) * np + e0;
  const float* et = p.etot + static_cast<long long>(b) * p.nc * p.H + h;
  const int n = static_cast<int>(min(4LL, np - e0));
  const bool vec = n == 4 && np % 4 == 0;
  auto load = [&](float (&s)[U][4], float (&g)[U], int c0) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (c0 + i >= p.nc) break;
      const float* src = base + (c0 + i) * cstride;
      g[i] = et[static_cast<long long>(c0 + i) * p.H];
      if (vec) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        s[i][0] = v.x;
        s[i][1] = v.y;
        s[i][2] = v.z;
        s[i][3] = v.w;
      } else {
        for (int e = 0; e < n; ++e) s[i][e] = src[e];
      }
    }
  };
  float hc[4] = {0.f, 0.f, 0.f, 0.f};
  float s[2][U][4], g[2][U];
  load(s[0], g[0], 0);
  for (int c0 = 0, cur = 0; c0 < p.nc; c0 += U, cur ^= 1) {
    if (c0 + U < p.nc) load(s[cur ^ 1], g[cur ^ 1], c0 + U);
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (c0 + i >= p.nc) break;
      float* dst = base + (c0 + i) * cstride;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(hc[0], hc[1], hc[2], hc[3]);
      } else {
        for (int e = 0; e < n; ++e) dst[e] = hc[e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) hc[e] = fmaf(hc[e], g[cur][i], s[cur][i][e]);
    }
  }
}

// ---- 5. chunk scan, per (unit, 64-row q tile, 64 columns of P) ----

template <typename T>
struct OutShape {
  // a stage holds, for an inter tile, C [q][n] (T) and h [n][p] (fp32), or,
  // for an intra tile, C.B^T [q][k] (fp32) and x [k][p] (T): 26 KB with
  // bf16 inputs, so that 4 blocks (16 warps) share an SM; C.B^T's pitch of
  // 68 costs its 8-byte loads a 2-way bank conflict and saves the 4 KB
  static constexpr int kCbLd = kT + 4;
  static constexpr int kCBytes = kT * kRowLd * sizeof(T);
  static constexpr int kWBytes = kT * kCbLd * 4;
  static constexpr int kInter = kCBytes + kT * kmaj_ld<float>(kT) * 4;
  static constexpr int kIntra = kWBytes + kT * kmaj_ld<T>(kT) * sizeof(T);
  static constexpr int kStageBytes = kInter > kIntra ? kInter : kIntra;
  static constexpr int kMinBlocks = sizeof(T) == 2 ? 4 : 3;
  static size_t smem(int qp) { return 2 * kStageBytes + qp * (sizeof(float2) + sizeof(float)); }
};

template <typename T>
__global__ void __launch_bounds__(32 * kOutWarps, OutShape<T>::kMinBlocks)
    ssd_out_kernel(Params p) {
  using S = OutShape<T>;
  constexpr bool EXACT = sizeof(T) == 2;
  constexpr int kThreads = 32 * kOutWarps;
  constexpr int kLdH = kmaj_ld<float>(kT), kLdX = kmaj_ld<T>(kT);
  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);
  float2* cum_s = reinterpret_cast<float2*>(ring + 2 * S::kStageBytes);  // [Qp]
  float* dt_s = reinterpret_cast<float*>(cum_s + p.Qp);                  // [Qp]

  // one grid axis, the q tile fastest (heaviest first), then the P slice,
  // then the unit: the blocks of one unit run together and share its
  // state, x and C.B^T through L2
  const int npt = (p.P + kT - 1) / kT, nqt = p.Qp / kT;
  const long long units = static_cast<long long>(p.batch) * p.nc * p.H;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x % nqt);
  const int pt = static_cast<int>(blockIdx.x / nqt % npt);
  const long long u = blockIdx.x / nqt / npt;
  const int h = static_cast<int>(u % p.H);
  const long long bc = u / p.H;
  const int c = static_cast<int>(bc % p.nc), b = static_cast<int>(bc / p.nc);
  const int q0 = qt * kT, p0 = pt * kT;
  const long long s0 = static_cast<long long>(c) * p.Q;

  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + s0 * p.x_ss + h * p.x_sh + p0;
  const T* cg = static_cast<const T*>(p.cm) + b * p.c_sb + (s0 + q0) * p.c_ss;
  const float* hg = p.st + u * p.N * p.P + p0;
  const float* cbg = p.cb + bc * p.Qp * p.Qp + static_cast<long long>(q0) * p.Qp;
  const float2* cum = p.cum + u * p.Qp;
  const float* dts = p.aux + u * p.Qp;
  const float* ecum = dts + units * p.Qp;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;  // this thread's rows in the tile: r0, r0 + 8
  const float2 cq0 = cum[q0 + r0], cq1 = cum[q0 + r0 + 8];
  const int n_nt = (p.N + kT - 1) / kT;  // inter tiles (n slabs); then qt + 1 intra tiles
  const int n_tiles = n_nt + qt + 1;

  auto issue = [&](int i, int stage) {
    char* st = ring + stage * S::kStageBytes;
    if (i < n_nt) {
      const int n0 = i * kT;
      load_tile<T, kT, kT, kRowLd, kThreads>(reinterpret_cast<T*>(st), cg + n0, p.c_ss,
                                             p.Q - q0, p.N - n0, p.vec_c);
      load_tile<float, kT, kT, kLdH, kThreads>(reinterpret_cast<float*>(st + S::kCBytes),
                                               hg + static_cast<long long>(n0) * p.P, p.P,
                                               p.N - n0, p.P - p0, p.vec_st);
    } else {
      const int k0 = (i - n_nt) * kT;
      load_tile<float, kT, kT, S::kCbLd, kThreads>(reinterpret_cast<float*>(st), cbg + k0, p.Qp,
                                                 kT, kT, true);
      load_tile<T, kT, kT, kLdX, kThreads>(reinterpret_cast<T*>(st + S::kWBytes),
                                           xg + k0 * p.x_ss, p.x_ss, p.Q - k0, p.P - p0,
                                           p.vec_x);
    }
    cp_async_commit();
  };

  issue(0, 0);  // in flight while the block reads cum and dt
  for (int k = threadIdx.x; k < q0 + kT; k += kThreads) {
    cum_s[k] = cum[k];
    dt_s[k] = dts[k];
  }
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();
    __syncthreads();  // tile i landed; every warp is done with tile i - 1
    if (i + 1 < n_tiles) issue(i + 1, (i + 1) & 1);
    const char* st = ring + (i & 1) * S::kStageBytes;
    if (i < n_nt) {
      // inter: C_q . h, A = C (exact when bf16), B = h (fp32, split)
      const T* ct = reinterpret_cast<const T*>(st);
      const T* as = ct + r0 * kRowLd;
      const float* bs = reinterpret_cast<const float*>(st + S::kCBytes);
#pragma unroll 2
      for (int ks = 0; ks < kT; ks += 8) {
        const int kk = ks + 2 * t;
        uint32_t ahi[4], alo[4];
        if constexpr (EXACT) {
          uint32_t cp[2];
          ldsm_x2(cp, ct + (16 * warp + (lane & 15)) * kRowLd + ks);
          ahi[0] = bf_lo(cp[0]);
          ahi[1] = bf_lo(cp[1]);
          ahi[2] = bf_hi(cp[0]);
          ahi[3] = bf_hi(cp[1]);
          alo[0] = alo[1] = alo[2] = alo[3] = 0u;
        } else {
          const float2 c0 = ld2(as + kk), c1 = ld2(as + 8 * kRowLd + kk);
          split_a(ahi, alo, c0.x, c1.x, c0.y, c1.y);
        }
        const float* h0 = bs + kk * kLdH + g;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const Split bv0 = split(h0[8 * j]), bv1 = split(h0[kLdH + 8 * j]);
          mma3<EXACT, false>(acc[j], ahi, alo, bv0, bv1);
        }
      }
      if (i == n_nt - 1) {  // y_inter = exp(cum_q) (C_q . h)
        const float e0 = ecum[q0 + r0], e1 = ecum[q0 + r0 + 8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j][0] *= e0;
          acc[j][1] *= e0;
          acc[j][2] *= e1;
          acc[j][3] *= e1;
        }
      }
    } else {
      // intra: W . x, W = (C.B^T) exp(cum_q - cum_k) dt_k built in
      // registers (fp32, split), B = x (exact when bf16)
      const int k0 = (i - n_nt) * kT;
      const bool diag = k0 == q0;
      const int qa = q0 + r0, qb = qa + 8;
      const float* as = reinterpret_cast<const float*>(st) + r0 * S::kCbLd;
      const T* xs = reinterpret_cast<const T*>(st + S::kWBytes);
#pragma unroll 2
      for (int ks = 0; ks < kT; ks += 8) {
        if (diag && ks >= 16 * warp + 16) break;  // k past this warp's rows: all masked
        const int kk = ks + 2 * t, k = k0 + kk;
        const float2 w0 = ld2(as + kk), w1 = ld2(as + 8 * S::kCbLd + kk);
        const float4 ck = *reinterpret_cast<const float4*>(cum_s + k);  // k, k + 1
        const float2 dk = *reinterpret_cast<const float2*>(dt_s + k);
        // masked before the exp: a weight with k > q is 0
        const bool m00 = !diag || k <= qa, m10 = !diag || k <= qb;
        const bool m01 = !diag || k + 1 <= qa, m11 = !diag || k + 1 <= qb;
        const float a0 = weight(m00, w0.x, cq0, ck.x, ck.y, dk.x);
        const float a1 = weight(m10, w1.x, cq1, ck.x, ck.y, dk.x);
        const float a2 = weight(m01, w0.y, cq0, ck.z, ck.w, dk.y);
        const float a3 = weight(m11, w1.y, cq1, ck.z, ck.w, dk.y);
        uint32_t ahi[4], alo[4];
        split_a(ahi, alo, a0, a1, a2, a3);
        if constexpr (EXACT) {
          uint32_t xp[8];
          const T* xr = xs + (ks + (lane & 7)) * kLdX + 8 * (lane >> 3);
          ldsm_x4_t(xp, xr);
          ldsm_x4_t(xp + 4, xr + 32);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            mma3<false, true>(acc[j], ahi, alo, Split{bf_lo(xp[j]), 0u}, Split{bf_hi(xp[j]), 0u});
        } else {
          const T* x0 = xs + kk * kLdX + g;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const Split bv0 = split(widen(x0[8 * j]));
            const Split bv1 = split(widen(x0[kLdX + 8 * j]));
            mma3<false, false>(acc[j], ahi, alo, bv0, bv1);
          }
        }
      }
    }
  }

  const long long row = static_cast<long long>(p.H) * p.P;
  float* yg = p.y + (static_cast<long long>(b) * p.S + s0 + q0) * row + static_cast<long long>(h) * p.P;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (q0 + r >= p.Q) continue;
    float* yr = yg + r * row;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = p0 + 8 * j + 2 * t;
      if (col + 1 < p.P && p.P % 2 == 0) {
        *reinterpret_cast<float2*>(yr + col) = make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
      } else {
        if (col < p.P) yr[col] = acc[j][2 * half];
        if (col + 1 < p.P) yr[col + 1] = acc[j][2 * half + 1];
      }
    }
  }
}

// 1 when every row that a tile copy starts on is 16-byte aligned
int rows_aligned(const void* ptr, int es, long long s0, long long s1, long long s2) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (s0 * es) % 16 == 0 &&
         (s1 * es) % 16 == 0 && (s2 * es) % 16 == 0;
}

template <typename T>
int launch_all(const Params& p, cudaStream_t stream) {
  const long long units = static_cast<long long>(p.batch) * p.nc * p.H;
  const int nqt = p.Qp / kT, npt = (p.P + kT - 1) / kT;
  ssd_cum_kernel<<<static_cast<unsigned>((units + 7) / 8), 256, 0, stream>>>(p);
  ssd_cb_kernel<T><<<dim3(nqt, nqt, p.batch * p.nc), 256, 0, stream>>>(p);
  const size_t state_smem = StateShape<T>::smem(p.Qp);
  cudaError_t e = cudaFuncSetAttribute(ssd_state_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(state_smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_state_kernel<T><<<static_cast<unsigned>(units * npt), 32 * kStateWarps, state_smem,
                        stream>>>(p);
  const long long np = static_cast<long long>(p.N) * p.P;
  ssd_pass_kernel<2><<<dim3(static_cast<unsigned>((np + 1023) / 1024), p.batch * p.H), 256, 0,
                       stream>>>(p);
  const size_t out_smem = OutShape<T>::smem(p.Qp);
  e = cudaFuncSetAttribute(ssd_out_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(out_smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_out_kernel<T><<<static_cast<unsigned>(units * npt * nqt), 32 * kOutWarps, out_smem,
                      stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The padded chunk length (a multiple of 64) that sizes the scratch: cb
// holds batch * (S / Q) * Qp * Qp floats, cum units * Qp * 2 floats, aux 3 *
// units * Qp floats, etot units floats and st units * N * P floats, with
// units = batch * (S / Q) * H.
int ssd_scan_padded_chunk(int Q) { return ((Q + kT - 1) / kT) * kT; }

// dtype: 0 fp32, 1 bf16 for x, bm and cm; dt and A fp32. x (B, S, H, P), dt
// (B, S, H), A (H,), bm / cm (B, S, N): last strides 1, other strides in
// elements. y: contiguous fp32 (B, S, H, P). Needs S % Q == 0, 1 <= Q <=
// 1024 and 1 <= N <= 128. Returns cudaGetLastError() after the launches,
// or a refusal code.
int ssd_scan_fwd(int dtype, const void* x, const float* dt, const float* A, const void* bm,
                 const void* cm, float* cb, float* cum, float* aux, float* etot, float* st,
                 float* y, int batch, int S, int H, int P, int N, int Q, long long x_sb,
                 long long x_ss, long long x_sh, long long dt_sb, long long dt_ss,
                 long long dt_sh, long long b_sb, long long b_ss, long long c_sb,
                 long long c_ss, void* stream_ptr) {
  if (batch < 1 || S < 1 || H < 1 || P < 1 || N < 1 || N > kMaxN || Q < 1 || Q > kMaxQ ||
      S % Q != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = S / Q;
  const long long units = static_cast<long long>(batch) * nc * H;
  const long long blocks = units * ((P + kT - 1) / kT) * (ssd_scan_padded_chunk(Q) / kT);
  if (static_cast<long long>(batch) * nc > 65535 || static_cast<long long>(batch) * H > 65535 ||
      blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int es = dtype == 0 ? 4 : 2;
  Params p{x, dt, A, bm, cm, cb, reinterpret_cast<float2*>(cum), aux, etot, st, y,
           batch, S, H, P, N, Q, ssd_scan_padded_chunk(Q), nc,
           x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss,
           rows_aligned(x, es, x_sb, x_ss, x_sh), rows_aligned(bm, es, b_sb, b_ss, 0),
           rows_aligned(cm, es, c_sb, c_ss, 0), rows_aligned(st, 4, P, 0, 0)};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return dtype == 0 ? launch_all<float>(p, stream) : launch_all<bf16_t>(p, stream);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
