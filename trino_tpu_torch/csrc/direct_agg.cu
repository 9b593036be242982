// K5: grouped sums over a small dense group domain for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` (launched by `_mxu_sums`, public
// `direct_group_aggregate_mxu`) in trino_tpu/ops/pallas_agg.py.
//
// Contract: gid [n] int32 (a value outside [0, G) is the miss group and
// is dropped), planes [A, n] int64; out[g][a] = sum of planes[a][i] over
// the rows i with gid[i] == g, as a wrapping int64 sum. G <= MAX_GROUPS,
// A <= MAX_PLANES. The TPU kernel decomposed each int64 into int32 hi/lo
// planes and 12-bit limbs so that a one-hot f32 matmul on the MXU summed
// them exactly (exact for |value| < 2^59); here the sums are native int64,
// so the result equals the TPU kernel's on that domain and equals the
// plain masked sums everywhere.
//
// What bounds it on this card: bytes. Each row reads its group id and A
// planes once (n * (4 + 8 A) bytes); the G x A accumulators are tiny.
// What the design must avoid is contention: every row adds into one of at
// most 16 x 17 cells. Each warp owns a private copy of the cells in shared
// memory (8 warps x 272 x 8 B = 17 KB per block), so only the 32 lanes of
// one warp contend on a shared-memory 64-bit atomicAdd; a block folds its
// warps' copies and adds each non-zero cell to the global result once.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_GROUPS 16
#define MAX_PLANES 17
#define THREADS 256
#define WARPS (THREADS / 32)
#define CELLS (MAX_GROUPS * MAX_PLANES)

__global__ void __launch_bounds__(THREADS)
group_sums_kernel(const int32_t* __restrict__ gid,
                  const int64_t* __restrict__ planes, int64_t n, int A,
                  int G, unsigned long long* __restrict__ out) {
  __shared__ unsigned long long acc[WARPS][CELLS];
  const int cells = G * A;
  const int warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < WARPS * CELLS; c += THREADS)
    (&acc[0][0])[c] = 0ull;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    int g = gid[i];
    if (g < 0 || g >= G) continue;
    unsigned long long* row = &acc[warp][g * A];
    for (int a = 0; a < A; ++a)
      atomicAdd(&row[a], (unsigned long long)planes[(int64_t)a * n + i]);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += THREADS) {
    unsigned long long s = 0ull;
    for (int w = 0; w < WARPS; ++w) s += acc[w][c];
    if (s != 0ull) atomicAdd(&out[c], s);
  }
}

// C entry (bound with ctypes). gid [n] int32, planes [A, n] int64; out
// [G, A] int64 is allocated by the caller and zeroed here. Returns
// cudaGetLastError() after the launch.
extern "C" int k5_group_sums(const int32_t* gid, const int64_t* planes,
                             int64_t n, int A, int G, int64_t* out,
                             void* stream) {
  if (G < 1 || G > MAX_GROUPS || A < 1 || A > MAX_PLANES || n < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)G * A * sizeof(int64_t),
                                  s);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return (int)cudaSuccess;
  int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 132 * 8) blocks = 132 * 8;
  group_sums_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      gid, planes, n, A, G, (unsigned long long*)out);
  return (int)cudaGetLastError();
}
