// K4: fused multiway star probe for Hopper (sm_90a).
//
// Replaces the TPU kernel `_multiprobe_kernel` (launched by
// `multiway_probe`) in trino_tpu/ops/pallas_hash.py.
//
// Contract (the TPU kernel's with its wrapper's prep, bit for bit): k <=
// MAX_DIMS dimension hash tables built by K3 at one shared slot count T
// (a power of two), each slot a key and a build row id. Per fact row i:
// its live byte, and per dimension d its key (int32 or int64, as the
// column lies) and validity byte. The kernel derives what the TPU's
// wrapper derived: ok = live & valid & key != EMPTY_KEY, the home slot
// splitmix64(key + SEED) & (T - 1). Dimensions are walked in order d =
// 0..k-1. Each probes at most MAX_PROBES consecutive slots of table d from
// the home slot, wrapping at T: a matching key gives found[d][i] = the
// slot's row id; an empty slot, an exhausted chain or a key that is not
// ok is a miss. A dead row, and a row that missed an earlier dimension,
// is -1 in every later dimension and counts no further miss. miss[d]
// counts the rows still alive entering dimension d that failed there.
//
// What bounds it on this card: bytes. The live byte of every row, the key
// and validity byte of dimension d for the rows alive entering it, and
// found (int32) for every row and dimension, streamed once from HBM; the
// tables (k * T * 16 B) are random access but stay in the 50 MB L2 — the
// role the TPU's resident VMEM played.
//
// Design: the TPU kernel ran one sequential row loop per block with the
// tables pinned in VMEM and per-dimension miss counters in SMEM, over
// slot and key planes its wrapper prepared. Here each thread walks rows
// of a grid-stride loop and reads the key columns themselves (no prepared
// planes), so the only lanes streamed are the live and validity bytes,
// the keys as they lie and the int32 result. The card's limit in practice
// is the latency of each row's dependent loads (key, then table), so the
// launch keeps every SM full. The tables are the interleaved {key, row
// id} table a K3 join build writes: one 16-byte load per probe step (on
// an H100, 6% faster than a key-plane read per step and a row-id-plane
// read on a hit). Misses are counted per thread in registers, reduced per
// warp and block, and added with one 64-bit atomicAdd per block and
// dimension.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_DIMS 5
#define MAX_PROBES 16
#define EMPTY_KEY ((long long)0x8000000000000000ull)
#define SLOT_SEED 0xD1B54A32D192ED03ull

struct Dims {
  const void* key[MAX_DIMS];
  const uint8_t* valid[MAX_DIMS];
  int key_size[MAX_DIMS];
};

__device__ __forceinline__ unsigned long long splitmix64(
    unsigned long long z) {
  z += 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// 8 blocks of 256 threads an SM (32 registers a thread): the launch's
// 132 * 8 blocks are all resident at once, for as many probe chains in
// flight as the card holds (a few spilled registers cost less)
__global__ void __launch_bounds__(256, 8)
    multiprobe_kernel(const uint8_t* __restrict__ live, Dims D, int64_t n,
                      int k, const longlong2* __restrict__ table, int64_t T,
                      int32_t* __restrict__ found,
                      unsigned long long* __restrict__ miss) {
  __shared__ unsigned block_miss[MAX_DIMS];
  if (threadIdx.x < MAX_DIMS) block_miss[threadIdx.x] = 0u;
  __syncthreads();
  unsigned mine[MAX_DIMS];
#pragma unroll
  for (int d = 0; d < MAX_DIMS; ++d) mine[d] = 0u;
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    bool alive = live[i] != 0;
#pragma unroll
    for (int d = 0; d < MAX_DIMS; ++d) {
      if (d >= k) break;
      int32_t f = -1;
      if (alive) {
        bool hit = false;
        long long kk = 0;
        bool ok = D.valid[d][i] != 0;
        if (ok) {
          kk = D.key_size[d] == 8 ? ((const long long*)D.key[d])[i]
                                  : (long long)((const int32_t*)D.key[d])[i];
          ok = kk != EMPTY_KEY;
        }
        if (ok) {
          int64_t s = (int64_t)(splitmix64((unsigned long long)kk +
                                           SLOT_SEED) &
                                (unsigned long long)(T - 1));
          const longlong2* tab = table + (int64_t)d * T;
          for (int p = 0; p < MAX_PROBES; ++p) {
            const longlong2 e = __ldg(tab + s);
            if (e.x == EMPTY_KEY) break;
            if (e.x == kk) {
              hit = true;
              f = (int32_t)e.y;
              break;
            }
            s = (s + 1) & (T - 1);
          }
        }
        if (!hit) mine[d] += 1u;
        alive = hit;
      }
      found[(int64_t)d * n + i] = f;
    }
  }
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 0; d < MAX_DIMS; ++d) {
    if (d >= k) break;
    const unsigned w = __reduce_add_sync(0xffffffffu, mine[d]);
    if (lane == 0 && w != 0u) atomicAdd(&block_miss[d], w);
  }
  __syncthreads();
  if (threadIdx.x < k && block_miss[threadIdx.x] != 0u)
    atomicAdd(&miss[threadIdx.x],
              (unsigned long long)block_miss[threadIdx.x]);
}

// C entry (bound with ctypes). live [n] bool; `dims` points at 3 *
// MAX_DIMS host words: per dimension its key column (int32 or int64), its
// validity plane (bool) and its key width in bytes. table: [k, T] slots
// of {key, row id} int64, contiguous and 16-byte aligned. Outputs
// (allocated by the caller): found [k, n] int32, miss [k] int64 (zeroed
// here). Returns cudaGetLastError() after the launch.
extern "C" int k4_multiprobe(const uint8_t* live,
                             const unsigned long long* dims, int64_t n,
                             int k, const int64_t* table, int64_t T,
                             int32_t* found, int64_t* miss, void* stream) {
  if (k < 1 || k > MAX_DIMS || T <= 0 || (T & (T - 1)) != 0 || n < 0 ||
      ((uintptr_t)table & 15) != 0)
    return (int)cudaErrorInvalidValue;
  Dims D;
  for (int d = 0; d < MAX_DIMS; ++d) {
    D.key[d] = (const void*)dims[3 * d];
    D.valid[d] = (const uint8_t*)dims[3 * d + 1];
    D.key_size[d] = (int)dims[3 * d + 2];
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(miss, 0, k * sizeof(int64_t), s);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  multiprobe_kernel<<<(unsigned)blocks, threads, 0, s>>>(
      live, D, n, k, (const longlong2*)table, T, found,
      (unsigned long long*)miss);
  return (int)cudaGetLastError();
}
