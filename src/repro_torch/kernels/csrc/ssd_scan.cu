// Mamba-2 SSD chunked scan (forward) for Hopper (sm_90a), in fp32.
//
// Replaces: src/repro/kernels/ssd_scan.py::_ssd_kernel (the Pallas TPU
// kernel behind models/mamba.py::mamba_forward(use_pallas=True), which every
// layer of mamba2's prefill/scoring forward reaches).
//
// What it computes, as the Pallas kernel and ssd_chunked_ref do: x (B, S,
// H, P), dt (B, S, H), A (H,), Bm / Cm (B, S, N), all fp32; y (B, S, H, P).
// Per chunk of Q steps and head h, with cum the in-chunk cumulative sum of
// dt * A[h] and total its last entry:
//   y_q = sum_{k <= q} (C_q . B_k) exp(cum_q - cum_k) dt_k x_k   (intra)
//       + exp(cum_q) C_q . h                                     (inter)
//   h  <- exp(total) h + sum_k exp(total - cum_k) B_k (outer) dt_k x_k
// with h (N, P) the state entering the chunk, 0 before the first one. The
// decay is masked before the exp (k > q would overflow). cum is summed in
// fp64 and each exponent is rounded to fp32 once before its exp, as in the
// plain version (models/mamba.py::ssd_chunked_ref): at full width |cum|
// reaches ~3,300, where an fp32 ulp is 2.4e-4, and two fp32 sums in
// different orders put y apart by up to 5e-4.
//
// Bound on the H100: operations. At mamba2-2.7b's forward call (B=4,
// S=4608, H=80, P=64, N=128, Q=256) the work is 7.38e10 flops, 1.10 ms at
// the fp32 peak outside the tensor cores, against 0.23 ms to move its
// 0.78 GB.
//
// Design (fp32 on the CUDA cores; wgmma and TMA are later work). The Pallas
// kernel keeps a whole chunk's (Q, Q, H) decay and (H, N, P) state in VMEM,
// tens of MB at full width: far beyond a block's 227 KB. One head's state,
// N x P = 128 x 64 fp32, is 32 KB, so:
//   * a first kernel computes C . B^T once per (batch, chunk), for the
//     64 x 64 tiles on or below the diagonal, into a scratch buffer (19 MB
//     at full width, mostly L2-resident) that all heads then read;
//   * the main kernel gives one block of 256 threads to each (batch, head,
//     64-column slice of P). It walks the chunks in order (the loop takes
//     the place of the TPU's sequential chunk grid axis) and keeps h in
//     shared memory across them. Per chunk: one warp scans dt * A into cum;
//     each 64-row q tile accumulates a 4 x 4 register block per thread of
//     the inter term (C tile . h), scales it by exp(cum_q), adds the intra
//     term over the k tiles at or below it, and is stored; then the k tiles
//     are swept once more into the state update, which each thread writes
//     to the rows of h it owns;
//   * sums run in a fixed order and no atomics are used: results repeat
//     run to run;
//   * x, dt, Bm and Cm are read through their strides (their last stride
//     must be 1): x is a reshaped slice of the conv output and Bm / Cm are
//     slices of it, so the model makes no copies. y is contiguous.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kT = 64;         // q rows, k rows and p columns of a tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLd = kT + 4;    // pitch of transposed tiles (16-byte aligned)
constexpr int kCbN = 32;       // n depth of a C . B^T step
constexpr int kMaxN = 128;
constexpr int kMaxQ = 1024;

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* bm;
  const float* cm;
  const float* cb;  // (batch * nc, Qp, Qp) from cb_kernel
  float* y;         // contiguous (B, S, H, P)
  int S, H, P, N, Q, Qp, nc;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss;
};

// cb[bc, q, k] = sum_n C[q, n] B[k, n] for the 64 x 64 tiles with k tile <=
// q tile; rows past Q are zero.
__global__ void __launch_bounds__(kThreads)
cb_kernel(Params p, float* cb) {
  const int qt = blockIdx.x, kt = blockIdx.y, bc = blockIdx.z;
  if (kt > qt) return;
  const int b = bc / p.nc, c = bc % p.nc;
  __shared__ __align__(16) float ct[kCbN * kLd];
  __shared__ __align__(16) float bt[kCbN * kLd];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long s0 = static_cast<long long>(c) * p.Q;
  float acc[4][4] = {};
  for (int n0 = 0; n0 < p.N; n0 += kCbN) {
    for (int e = tid; e < kT * kCbN; e += kThreads) {
      const int r = e / kCbN, n = e % kCbN;
      const int qi = qt * kT + r, ki = kt * kT + r;
      const bool nv = n0 + n < p.N;
      ct[n * kLd + r] = (nv && qi < p.Q)
          ? p.cm[b * p.c_sb + (s0 + qi) * p.c_ss + n0 + n] : 0.f;
      bt[n * kLd + r] = (nv && ki < p.Q)
          ? p.bm[b * p.b_sb + (s0 + ki) * p.b_ss + n0 + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int n = 0; n < kCbN; ++n) {
      const float4 a = *reinterpret_cast<const float4*>(&ct[n * kLd + ty * 4]);
      const float4 v = *reinterpret_cast<const float4*>(&bt[n * kLd + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = cb + static_cast<long long>(bc) * p.Qp * p.Qp;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = qt * kT + ty * 4 + i;
    *reinterpret_cast<float4*>(&out[static_cast<long long>(q) * p.Qp + kt * kT + tx * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// 16 * NR >= N state rows; thread (ty, tx) owns rows ty + 16 i and columns
// 4 tx .. 4 tx + 3 of h.
template <int NR>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(Params p) {
  constexpr int NP = 16 * NR;
  const int p0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int Q = p.Q, Qp = p.Qp;

  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [NP][kT] state
  double* cum = reinterpret_cast<double*>(hs + NP * kT);  // [Qp] cumulative dt * A
  float* dts = reinterpret_cast<float*>(cum + Qp);        // [Qp] dt
  float* eq = dts + Qp;                         // [Qp] exp(cum)
  float* dec = eq + Qp;                         // [Qp] exp(total - cum)
  float* stage = dec + Qp;                      // tiles, reused per phase
  float* wt = stage;                            // [kT][kLd] intra weights, transposed
  float* xs = stage + kT * kLd;                 // [kT][kT] x * dt (intra)
  float* ctile = stage;                         // [NP][kLd] C tile, transposed
  float* bs = stage;                            // [kT][NP] B tile (state)
  float* xs2 = stage + kT * NP;                 // [kT][kT] x * dt * dec (state)

  for (int e = tid; e < NP * kT; e += kThreads) hs[e] = 0.f;
  const float a_h = p.A[h];
  const float* xb = p.x + b * p.x_sb + h * p.x_sh + p0;
  const float* dtb = p.dt + b * p.dt_sb + h * p.dt_sh;
  const float* bb = p.bm + b * p.b_sb;
  const float* cbase = p.cm + b * p.c_sb;
  const int pw = min(kT, p.P - p0);  // valid columns of this slice
  const int nqt = (Q + kT - 1) / kT;

  for (int c = 0; c < p.nc; ++c) {
    const long long s0 = static_cast<long long>(c) * Q;
    for (int k = tid; k < Qp; k += kThreads)
      dts[k] = k < Q ? dtb[(s0 + k) * p.dt_ss] : 0.f;
    __syncthreads();
    if (warp == 0) {  // cum = inclusive scan of dt * A in fp64 (padding adds 0)
      const int per = Qp / 32, base = lane * per;
      double run = 0.0;
      for (int j = 0; j < per; ++j) {
        run += static_cast<double>(dts[base + j] * a_h);
        cum[base + j] = run;
      }
      double incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      const double excl = incl - run;
      for (int j = 0; j < per; ++j) cum[base + j] += excl;
    }
    __syncthreads();
    const double total = cum[Q - 1];
    for (int k = tid; k < Qp; k += kThreads) {
      eq[k] = expf(static_cast<float>(cum[k]));
      dec[k] = expf(static_cast<float>(total - cum[k]));
    }
    const float* cbc = p.cb + (static_cast<long long>(b) * p.nc + c) * Qp * Qp;

    // ---- outputs, one 64-row q tile at a time ----
    for (int qt = 0; qt < nqt; ++qt) {
      float acc[4][4] = {};
      // inter: C tile . h, then * exp(cum_q)
      for (int e = tid; e < kT * NP; e += kThreads) {
        const int r = e / NP, n = e % NP, qi = qt * kT + r;
        ctile[n * kLd + r] = (n < p.N && qi < Q)
            ? cbase[(s0 + qi) * p.c_ss + n] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int n = 0; n < NP; ++n) {
        const float4 a = *reinterpret_cast<const float4*>(&ctile[n * kLd + ty * 4]);
        const float4 v = *reinterpret_cast<const float4*>(&hs[n * kT + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w}, hv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], hv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float g = eq[qt * kT + ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= g;
      }
      __syncthreads();
      // intra: sum over the k tiles at or below the diagonal
      for (int kt = 0; kt <= qt; ++kt) {
        for (int e = tid; e < kT * kT; e += kThreads) {
          const int r = e / kT, k = e % kT;
          const int qi = qt * kT + r, ki = kt * kT + k;
          wt[k * kLd + r] = (ki <= qi && qi < Q)
              ? cbc[static_cast<long long>(qi) * Qp + ki] *
                    expf(static_cast<float>(cum[qi] - cum[ki]))
              : 0.f;
          const int kr = e / kT, col = e % kT, kk = kt * kT + kr;
          xs[kr * kT + col] = (kk < Q && col < pw)
              ? xb[(s0 + kk) * p.x_ss + col] * dts[kk] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < kT; ++k) {
          const float4 w = *reinterpret_cast<const float4*>(&wt[k * kLd + ty * 4]);
          const float4 v = *reinterpret_cast<const float4*>(&xs[k * kT + tx * 4]);
          const float wv[4] = {w.x, w.y, w.z, w.w}, xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = qt * kT + ty * 4 + i;
        if (qi >= Q) continue;
        float* yr = p.y + ((static_cast<long long>(b) * p.S + s0 + qi) * p.H + h) * p.P + p0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (tx * 4 + j < pw) yr[tx * 4 + j] = acc[i][j];
      }
    }

    // ---- state update: h <- exp(total) h + sum_k B_k (outer) x_k dt_k dec_k ----
    float st[NR][4] = {};
    for (int kt = 0; kt < nqt; ++kt) {
      for (int e = tid; e < kT * NP; e += kThreads) {
        const int r = e / NP, n = e % NP, ki = kt * kT + r;
        bs[r * NP + n] = (n < p.N && ki < Q) ? bb[(s0 + ki) * p.b_ss + n] : 0.f;
      }
      for (int e = tid; e < kT * kT; e += kThreads) {
        const int r = e / kT, col = e % kT, ki = kt * kT + r;
        xs2[r * kT + col] = (ki < Q && col < pw)
            ? xb[(s0 + ki) * p.x_ss + col] * dts[ki] * dec[ki] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kT; ++k) {
        const float4 v = *reinterpret_cast<const float4*>(&xs2[k * kT + tx * 4]);
        const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const float bv = bs[k * NP + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) st[i][j] = fmaf(bv, xv[j], st[i][j]);
        }
      }
      __syncthreads();
    }
    const float g = expf(static_cast<float>(total));
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* hp = &hs[(ty + 16 * i) * kT + tx * 4 + j];
        *hp = *hp * g + st[i][j];
      }
    __syncthreads();
  }
}

size_t ssd_smem_bytes(int np, int qp) {
  const int intra = kT * kLd + kT * kT;
  const int inter = np * kLd;
  const int state = kT * np + kT * kT;
  int stage = intra > inter ? intra : inter;
  stage = stage > state ? stage : state;
  // h, cum (fp64), dt, exp(cum), exp(total - cum), the tiles
  return sizeof(float) * (static_cast<size_t>(np) * kT + 5 * qp + stage);
}

template <int NR>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = ssd_smem_bytes(16 * NR, p.Qp);
  cudaError_t e = cudaFuncSetAttribute(ssd_kernel<NR>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.P + kT - 1) / kT, p.H, batch);
  ssd_kernel<NR><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The padded chunk length (a multiple of 64) that sizes the C . B^T
// scratch: cb must hold batch * (S / Q) * Qp * Qp floats.
int ssd_scan_padded_chunk(int Q) { return ((Q + kT - 1) / kT) * kT; }

// x (B, S, H, P), dt (B, S, H), A (H,), bm / cm (B, S, N): fp32, last
// strides 1, other strides in elements. y: contiguous fp32 (B, S, H, P).
// Needs S % Q == 0, 1 <= Q <= 1024 and 1 <= N <= 128. Returns
// cudaGetLastError() after the launches, or a refusal code.
int ssd_scan_fwd(const float* x, const float* dt, const float* A,
                 const float* bm, const float* cm, float* cb, float* y,
                 int batch, int S, int H, int P, int N, int Q,
                 long long x_sb, long long x_ss, long long x_sh,
                 long long dt_sb, long long dt_ss, long long dt_sh,
                 long long b_sb, long long b_ss, long long c_sb,
                 long long c_ss, void* stream_ptr) {
  if (batch < 1 || S < 1 || H < 1 || P < 1 || N < 1 || N > kMaxN || Q < 1 ||
      Q > kMaxQ || S % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = S / Q;
  if (batch > 65535 || H > 65535 || static_cast<long long>(batch) * nc > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Params p{x, dt, A, bm, cm, cb, y, S, H, P, N, Q, ssd_scan_padded_chunk(Q), nc,
           x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss};
  const int nqt = p.Qp / kT;
  cb_kernel<<<dim3(nqt, nqt, batch * nc), kThreads, 0, stream>>>(p, cb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  switch ((N + 15) / 16) {
    case 1: return launch<1>(p, batch, stream);
    case 2: return launch<2>(p, batch, stream);
    case 3: return launch<3>(p, batch, stream);
    case 4: return launch<4>(p, batch, stream);
    case 5: return launch<5>(p, batch, stream);
    case 6: return launch<6>(p, batch, stream);
    case 7: return launch<7>(p, batch, stream);
    default: return launch<8>(p, batch, stream);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
