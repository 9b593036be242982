// K3: open-addressing hash insert-or-accumulate for Hopper (sm_90a).
//
// Replaces the TPU kernel `_insert_kernel` / `_hash_insert` in
// trino_tpu/ops/pallas_hash.py (public entries `hash_group_aggregate`,
// `build_join_table`).
//
// Contract (same as the TPU kernel's, minus its sequential row order):
// home slot = splitmix64(key + SEED) & (T - 1) (computed by the caller),
// linear probing over at most MAX_PROBES slots, occupancy capped at
// `cap` slots. Per aggregate: count, and a value state that is a wrapping
// int64 sum, a min or a max. A row that exhausts its probes, or claims an
// empty slot when the table is at its cap, is counted in `esc` and not
// accumulated. Guarantees: esc > 0 iff some live row was not accumulated;
// with esc == 0, `occ` is exactly the number of occupied slots and every
// group's states equal the sequential kernel's. Which rows escape may
// differ from the TPU's; a run with esc > 0 is discarded by the caller
// (its over-cap slots keep their keys, so only `occ` respects the cap).
//
// What bounds it on this card: operations on one memory location. Each
// row costs one key probe chain (a 64-bit CAS on first sight of a slot)
// plus one atomic round trip per state it updates; the table is random
// access over T <= 2^17 slots (<= ~9 MB with 8 states), which stays in the
// 50 MB L2, so the DRAM floor is only the streaming read of the inputs:
// n * (8 + 8 + 4 + 8 * NV) bytes / 3.35 TB/s. Atomics to one hot slot
// serialise in L2 (many rows per group), which is what the design cannot
// hide: q3's groups hold ~4 rows each, so contention stays low there.
//
// Design: the TPU ran one sequential grid with the table in VMEM and
// int32 limb arithmetic. On Hopper the table lives in global memory
// (L2-resident at these sizes) with native 64-bit keys and states, one
// thread per row in parallel: a claim is a 64-bit atomicCAS on the key,
// and only a won claim reserves occupancy with atomicAdd (one over the cap
// is undone and escapes; reserving before the CAS would let the hundreds
// of rows that race for one new group's slot overshoot the cap together
// and escape falsely); count and sum use
// atomicAdd on unsigned long long (wraps exactly like int64); min/max use
// atomicMin/atomicMax on long long from INT64_MAX/INT64_MIN. An epilogue
// writes 0 wherever a value state's count is 0, so the result equals the
// TPU kernel's zero-initialised planes.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_AGGS 8
#define MAX_PROBES 16
#define EMPTY_KEY ((long long)(-9223372036854775807LL - 1))

enum { K_COUNT = 0, K_SUM = 1, K_MIN = 2, K_MAX = 3 };

struct Layout {
  int kind[MAX_AGGS];
  int val_state[MAX_AGGS];   // -1 for count
  int cnt_state[MAX_AGGS];
  int val_plane[MAX_AGGS];   // -1 for count
  int naggs;
  int nstates;
};

__global__ void init_kernel(long long* __restrict__ tkey,
                            long long* __restrict__ st, int64_t T,
                            Layout L) {
  int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; s < T;
       s += stride) {
    tkey[s] = EMPTY_KEY;
    for (int k = 0; k < L.nstates; ++k) st[k * T + s] = 0;
    for (int a = 0; a < L.naggs; ++a) {
      if (L.kind[a] == K_MIN) st[L.val_state[a] * T + s] = 0x7fffffffffffffffLL;
      if (L.kind[a] == K_MAX) st[L.val_state[a] * T + s] = EMPTY_KEY;
    }
  }
}

__global__ void insert_kernel(const int64_t* __restrict__ slot,
                              const int64_t* __restrict__ key,
                              const int32_t* __restrict__ vbits,
                              const int64_t* __restrict__ vals, int64_t n,
                              long long* __restrict__ tkey,
                              long long* __restrict__ st, int64_t T,
                              int cap, int* __restrict__ counters,
                              Layout L) {
  int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int64_t s = slot[i];
    if (s < 0) continue;
    long long k = (long long)key[i];
    bool found = false;
    for (int p = 0; p < MAX_PROBES; ++p) {
      // L2 read (slots only ever go from empty to a key, so a stale
      // EMPTY is harmless: the CAS below is authoritative)
      long long cur = __ldcg(&tkey[s]);
      if (cur == k) { found = true; break; }
      if (cur == EMPTY_KEY) {
        unsigned long long prev = atomicCAS(
            (unsigned long long*)&tkey[s], (unsigned long long)EMPTY_KEY,
            (unsigned long long)k);
        if (prev == (unsigned long long)EMPTY_KEY) {
          // claimed: reserve occupancy; over the cap the reservation is
          // undone and the row escapes (the run is then discarded)
          int old = atomicAdd(&counters[1], 1);
          if (old >= cap) {
            atomicSub(&counters[1], 1);
            break;
          }
          found = true;
          break;
        }
        if ((long long)prev == k) { found = true; break; }
      }
      s = (s + 1) & (T - 1);
    }
    if (!found) {
      atomicAdd(&counters[0], 1);
      continue;
    }
    int bits = vbits[i];
    for (int a = 0; a < L.naggs; ++a) {
      if (!((bits >> a) & 1)) continue;
      atomicAdd((unsigned long long*)&st[L.cnt_state[a] * T + s], 1ull);
      if (L.kind[a] == K_COUNT) continue;
      long long v = (long long)vals[L.val_plane[a] * n + i];
      long long* dst = &st[L.val_state[a] * T + s];
      if (L.kind[a] == K_SUM)
        atomicAdd((unsigned long long*)dst, (unsigned long long)v);
      else if (L.kind[a] == K_MIN)
        atomicMin(dst, v);
      else
        atomicMax(dst, v);
    }
  }
}

__global__ void epilogue_kernel(long long* __restrict__ st, int64_t T,
                                Layout L) {
  int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; s < T;
       s += stride) {
    for (int a = 0; a < L.naggs; ++a) {
      if (L.kind[a] == K_COUNT) continue;
      if (st[L.cnt_state[a] * T + s] == 0) st[L.val_state[a] * T + s] = 0;
    }
  }
}

static unsigned grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  return (unsigned)blocks;
}

// C entry (bound with ctypes). slot/key [n] int64 (slot -1 = skip row),
// vbits [n] int32 (bit a = aggregate a takes this row), vals [NV, n] int64.
// Outputs (allocated by the caller): tkey [T] int64, st [nstates, T]
// int64, counters [2] int32 = (escaped, occupied). Layout arrays have
// `naggs` entries. Returns cudaGetLastError() after the launches.
extern "C" int k3_hash_insert(const int64_t* slot, const int64_t* key,
                              const int32_t* vbits, const int64_t* vals,
                              int64_t n, long long* tkey, long long* st,
                              int64_t T, int cap, int* counters,
                              const int* kind, const int* val_state,
                              const int* cnt_state, const int* val_plane,
                              int naggs, int nstates, void* stream) {
  if (naggs < 0 || naggs > MAX_AGGS || (T & (T - 1)) != 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  Layout L;
  for (int a = 0; a < MAX_AGGS; ++a) {
    L.kind[a] = a < naggs ? kind[a] : K_COUNT;
    L.val_state[a] = a < naggs ? val_state[a] : -1;
    L.cnt_state[a] = a < naggs ? cnt_state[a] : 0;
    L.val_plane[a] = a < naggs ? val_plane[a] : -1;
  }
  L.naggs = naggs;
  L.nstates = nstates;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(counters, 0, 2 * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  const int threads = 256;
  init_kernel<<<grid_for(T, threads), threads, 0, s>>>(tkey, st, T, L);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (n > 0) {
    insert_kernel<<<grid_for(n, threads), threads, 0, s>>>(
        slot, key, vbits, vals, n, tkey, st, T, cap, counters, L);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  epilogue_kernel<<<grid_for(T, threads), threads, 0, s>>>(st, T, L);
  return (int)cudaGetLastError();
}
