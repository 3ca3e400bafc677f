// Segment-reduce for Hopper (sm_90a): out[m, :] = sum of values[j, :] over
// the twins j with assoc[j] == m, in fp32.
//
// Replaces: src/repro/kernels/segment_reduce.py::_seg_pallas_kernel (the
// Pallas TPU kernel behind every per-BS sum of the DTWN round: the Eq. 4
// weights and per-leaf averages, the Eq. 12 work and the K_i counts of
// Eqs. 14-15).
//
// Bound on the H100: bytes. Each value is read once and added once, so the
// least time is (N*K*4 + N*4 + M*K*4) bytes over 3.35 TB/s. At the round's
// largest call (the CNN's fc1_w leaf: N=10 twins, K=2,097,152, M=5) that is
// about 126 MB, or 37.6 us.
//
// Design. The TPU kernel keeps one (M, K) accumulator in VMEM across a grid
// that runs in order; at fc1_w's K that block is 84 MB, far beyond any VMEM,
// and Hopper blocks run in no order. So the work is cut both ways:
//   * Stage 1: grid = (column strips of bx columns, twin tiles). A block of
//     256 threads is bx columns by by = 256/bx twin lanes; bx is the smallest
//     power of two >= K, capped at 256, so a narrow payload (K=1) spends its
//     threads on twins instead of idle columns. Each thread owns one column
//     and one lane, and adds its lane's twins in a fixed order into its own M
//     accumulators in shared memory (no races, no atomics). The twin ids of
//     the tile go through shared memory in chunks, loaded once per block.
//     The lanes are then summed by a fixed-order tree, and the block writes
//     one (M, bx) partial: into the output when there is one twin tile, else
//     into scratch (tiles, M, K).
//   * Twin tiles are added only when the column strips alone give fewer
//     than two blocks per SM, so the Eq. 4 leaves (N=10) run in one tile and
//     skip stage 2.
//   * Stage 2 adds the partials in tile order.
// Every sum is taken in the same order on every run, so the result is
// bitwise repeatable (no fp32 atomics). Ids outside [0, M) add nothing.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kIdChunk = 1024;        // twin ids staged in shared memory
constexpr long long kMinTileRows = 1024;
constexpr long long kTargetBlocks = 264;  // two blocks per SM (132 SMs)
constexpr size_t kMaxSmem = 227 * 1024;

struct Geometry {
  int bx;
  long long col_blocks;
  long long tiles;
  long long rows_per_tile;
};

Geometry geometry(long long n, long long k) {
  Geometry g;
  g.bx = 1;
  while (g.bx < k && g.bx < kThreads) g.bx <<= 1;
  g.col_blocks = (k + g.bx - 1) / g.bx;
  const long long max_tiles = (n + kMinTileRows - 1) / kMinTileRows;
  const long long want = (kTargetBlocks + g.col_blocks - 1) / g.col_blocks;
  long long tiles = std::max(1LL, std::min(max_tiles, want));
  g.rows_per_tile = (n + tiles - 1) / tiles;
  g.tiles = (n + g.rows_per_tile - 1) / g.rows_per_tile;
  return g;
}

size_t stage1_smem(int m) {
  return kIdChunk * sizeof(int) + static_cast<size_t>(kThreads) * m * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
seg_stage1(const float* __restrict__ values, const int* __restrict__ assoc,
           float* __restrict__ dst, long long n, long long k, int m,
           long long rows_per_tile, int bx) {
  extern __shared__ float smem[];
  int* ids = reinterpret_cast<int*>(smem);
  float* acc = smem + kIdChunk;  // [by][m][bx]
  const int by = blockDim.x / bx;
  const int tx = threadIdx.x % bx;
  const int ty = threadIdx.x / bx;
  const long long col = static_cast<long long>(blockIdx.x) * bx + tx;
  const bool col_ok = col < k;
  const long long row0 = static_cast<long long>(blockIdx.y) * rows_per_tile;
  const long long row1 = min(n, row0 + rows_per_tile);
  float* mine = acc + static_cast<size_t>(ty) * m * bx + tx;
  for (int s = 0; s < m; ++s) mine[s * bx] = 0.f;

  for (long long c0 = row0; c0 < row1; c0 += kIdChunk) {
    const int len = static_cast<int>(min(static_cast<long long>(kIdChunk), row1 - c0));
    __syncthreads();  // the previous chunk's ids are no longer read
    for (int i = threadIdx.x; i < len; i += blockDim.x) ids[i] = assoc[c0 + i];
    __syncthreads();
    if (!col_ok) continue;
    const float* v = values + c0 * k + col;
    int i = ty;
    // four loads in flight before the four adds, in twin order
    for (; i + 3 * by < len; i += 4 * by) {
      const float v0 = v[static_cast<long long>(i) * k];
      const float v1 = v[static_cast<long long>(i + by) * k];
      const float v2 = v[static_cast<long long>(i + 2 * by) * k];
      const float v3 = v[static_cast<long long>(i + 3 * by) * k];
      const int a0 = ids[i], a1 = ids[i + by], a2 = ids[i + 2 * by], a3 = ids[i + 3 * by];
      if (a0 >= 0 && a0 < m) mine[a0 * bx] += v0;
      if (a1 >= 0 && a1 < m) mine[a1 * bx] += v1;
      if (a2 >= 0 && a2 < m) mine[a2 * bx] += v2;
      if (a3 >= 0 && a3 < m) mine[a3 * bx] += v3;
    }
    for (; i < len; i += by) {
      const float v0 = v[static_cast<long long>(i) * k];
      const int a0 = ids[i];
      if (a0 >= 0 && a0 < m) mine[a0 * bx] += v0;
    }
  }
  // fixed-order tree over the twin lanes: lane ty adds lane ty + s
  const size_t lane = static_cast<size_t>(m) * bx;
  for (int s = by / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (ty < s) {
      for (int j = 0; j < m; ++j) mine[j * bx] += mine[s * lane + j * bx];
    }
  }
  if (ty == 0 && col_ok) {
    float* out = dst + static_cast<long long>(blockIdx.y) * m * k;
    for (int j = 0; j < m; ++j) out[static_cast<long long>(j) * k + col] = mine[j * bx];
  }
}

__global__ void __launch_bounds__(kThreads)
seg_stage2(const float* __restrict__ partial, float* __restrict__ out,
           long long mk, long long tiles) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < mk; e += stride) {
    float s = 0.f;
    for (long long t = 0; t < tiles; ++t) s += partial[t * mk + e];
    out[e] = s;
  }
}

}  // namespace

extern "C" {

// Number of twin tiles stage 1 uses for (n, k); scratch of (tiles, m, k)
// fp32 is needed when it is above 1.
long long seg_reduce_tiles(long long n, long long k) {
  return geometry(n, k).tiles;
}

// Largest M the kernel takes (its accumulators live in shared memory).
int seg_reduce_max_segments() {
  return static_cast<int>((kMaxSmem - kIdChunk * sizeof(int)) / (kThreads * sizeof(float)));
}

// values (n, k) fp32 and assoc (n,) int32, both contiguous on the device;
// out (m, k) fp32; scratch (tiles, m, k) fp32 or null when tiles == 1.
// Returns cudaGetLastError() after the launches, or a refusal code.
int seg_reduce_f32(const float* values, const int* assoc, float* out,
                   float* scratch, long long n, long long k, int m,
                   void* stream) {
  if (n <= 0 || k <= 0 || m <= 0 || m > seg_reduce_max_segments()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g = geometry(n, k);
  if (g.tiles > 1 && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = stage1_smem(m);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        seg_stage1, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(g.col_blocks), static_cast<unsigned>(g.tiles));
  seg_stage1<<<grid, kThreads, smem, s>>>(values, assoc, g.tiles > 1 ? scratch : out, n,
                                          k, m, g.rows_per_tile, g.bx);
  if (g.tiles > 1) {
    const long long mk = static_cast<long long>(m) * k;
    const long long blocks = std::min((mk + kThreads - 1) / kThreads, 4096LL);
    seg_stage2<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(scratch, out, mk, g.tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
