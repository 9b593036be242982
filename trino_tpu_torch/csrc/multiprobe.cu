// K4: fused multiway star probe for Hopper (sm_90a).
//
// Replaces the TPU kernel `_multiprobe_kernel` (launched by
// `multiway_probe`) in trino_tpu/ops/pallas_hash.py.
//
// Contract (the TPU kernel's, bit for bit): k <= MAX_DIMS dimension hash
// tables built by K3 at one shared slot count T (tkey/src [k, T]); per fact
// row i and dimension d an encoded slot slot[d][i] (-2 dead row, -1 live
// row whose key is NULL or the empty sentinel, else the home slot) and the
// key key[d][i]. Dimensions are walked in order d = 0..k-1. Each probes at
// most MAX_PROBES consecutive slots of tkey[d] from the home slot, wrapping
// at T: a matching key gives found[d][i] = src[d][slot]; an empty slot or
// an exhausted chain is a miss. A row that misses is dead for every later
// dimension (found = -1 there, and no further miss is counted). miss[d]
// counts the rows still alive entering dimension d that failed there.
// The dead/live split is per row, so dimension 0's slot plane answers it.
//
// What bounds it on this card: bytes. Every fact row reads its k slots and
// keys and writes k results once (k * n * 24 B streamed from HBM); the
// tables are random access, but at the reference's budget (k * T * 12 B
// <= 8 MiB, here k * T * 16 B) they stay in the 50 MB L2 — the role the
// TPU's resident VMEM played. Dead rows stop reading after dimension 0's
// slot, so a selective star moves fewer bytes than the bound counts.
//
// Design: the TPU kernel ran one sequential row loop per block with the
// tables pinned in VMEM and per-dimension miss counters in SMEM. Here one
// thread walks one row; misses are reduced per warp (__ballot_sync +
// __popc) and added with one 64-bit atomicAdd per warp and dimension. All
// threads of a warp run the dimension loop the same number of times, so
// the ballot sees the full warp.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_DIMS 5
#define MAX_PROBES 16
#define EMPTY_KEY ((long long)(-9223372036854775807LL - 1))

__global__ void multiprobe_kernel(const int64_t* __restrict__ slot,
                                  const int64_t* __restrict__ key,
                                  const int64_t* __restrict__ tkey,
                                  const int64_t* __restrict__ src, int64_t n,
                                  int k, int64_t T,
                                  int64_t* __restrict__ found,
                                  unsigned long long* __restrict__ miss) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool in = i < n;
  bool alive = in && slot[i] != -2;
  for (int d = 0; d < k; ++d) {
    bool hit = false;
    int64_t f = -1;
    if (alive) {
      int64_t s = slot[(int64_t)d * n + i];
      if (s >= 0) {
        long long kk = (long long)key[(int64_t)d * n + i];
        const long long* tk = (const long long*)tkey + (int64_t)d * T;
        for (int p = 0; p < MAX_PROBES; ++p) {
          long long t = __ldg(&tk[s]);
          if (t == EMPTY_KEY) break;
          if (t == kk) {
            hit = true;
            f = __ldg(&src[(int64_t)d * T + s]);
            break;
          }
          s = (s + 1 == T) ? 0 : s + 1;
        }
      }
    }
    if (in) found[(int64_t)d * n + i] = f;
    unsigned m = __ballot_sync(0xffffffffu, alive && !hit);
    if ((threadIdx.x & 31) == 0 && m != 0u)
      atomicAdd(&miss[d], (unsigned long long)__popc(m));
    alive = hit;
  }
}

// C entry (bound with ctypes). slot/key [k, n] int64, tkey/src [k, T]
// int64. Outputs (allocated by the caller): found [k, n] int64, miss [k]
// int64 (zeroed here). Returns cudaGetLastError() after the launch.
extern "C" int k4_multiprobe(const int64_t* slot, const int64_t* key,
                             const int64_t* tkey, const int64_t* src,
                             int64_t n, int k, int64_t T, int64_t* found,
                             int64_t* miss, void* stream) {
  if (k < 1 || k > MAX_DIMS || T <= 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(miss, 0, k * sizeof(int64_t), s);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  multiprobe_kernel<<<(unsigned)blocks, threads, 0, s>>>(
      slot, key, tkey, src, n, k, T, found, (unsigned long long*)miss);
  return (int)cudaGetLastError();
}
