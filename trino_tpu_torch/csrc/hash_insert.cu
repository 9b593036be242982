// K3: open-addressing hash insert-or-accumulate for Hopper (sm_90a), over
// G independent tables in one launch.
//
// Replaces the TPU kernel `_insert_kernel` / `_hash_insert` in
// trino_tpu/ops/pallas_hash.py (public entries `hash_group_aggregate`,
// `build_join_table`). The TPU called it once per table; here one launch
// takes a star's dimension builds, or all of a partitioned hash
// aggregate's partitions, each row carrying its table id.
//
// Contract per table (the TPU kernel's, minus its sequential row order):
// home slot = splitmix64(key + SEED) & (T - 1), computed here, linear
// probing over at most MAX_PROBES slots, occupancy capped at `cap` slots.
// Rows whose mask byte is 0 are skipped. Per aggregate: count, and a value
// state that is a wrapping int64 sum, a min or a max; aggregate a takes a
// row iff its validity plane (none for count(*)) is set there. A row that
// exhausts its probes, or claims an empty slot when its table is at its
// cap, is counted in that table's `esc` and not accumulated. Guarantees,
// per table: esc > 0 iff some live row of it was not accumulated; with
// esc == 0, `occ` is exactly its number of occupied slots and every
// group's states equal the sequential kernel's. Which rows escape may
// differ from the TPU's; a table with esc > 0 is discarded by the caller.
//
// What bounds it on this card: per call, launch and host work at the
// main path's sizes (an 18K-row build is microseconds of device work);
// per row, the atomics on the slot it lands in. The bytes: the inputs
// streamed once, the tables (G * T * 8 * (1 + states), L2-resident at a
// star's sizes) zeroed once and their keys rewritten once.
//
// Design: the TPU ran one sequential grid per table with the table in
// VMEM. Here one thread per row, G tables laid out [G, T], and an empty
// table is all zero bytes, so one memset initialises every table and the
// counters: a key is stored XOR EMPTY_KEY (empty slot = 0), a min or max
// is kept as an unsigned atomicMax over an order-preserving encoding
// (max: v ^ SIGN; min: ~(v ^ SIGN); the memset's 0 is below every
// value). A claim is a 64-bit atomicCAS on the key; a won claim then
// reserves occupancy, warp-aggregated per table (one atomicAdd per table
// and warp; a reservation over the cap is undone and escapes — reserving
// before the CAS would let the rows that race for one new group's slot
// overshoot the cap together and escape falsely). Count and sum are
// unsigned atomicAdd (wraps like int64). One epilogue kernel decodes the
// keys (empty -> EMPTY_KEY) and the min/max states (0 where the count is
// 0, as the TPU's zero-initialised planes), and for a join build writes
// the interleaved {key, row id} table that K4 reads with one 16-byte load
// per probe step. Device work per call: one memset and two kernels,
// whatever G is.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_AGGS 8
#define MAX_PROBES 16
#define EMPTY_KEY 0x8000000000000000ull
#define SIGN 0x8000000000000000ull
#define SLOT_SEED 0xD1B54A32D192ED03ull

enum { K_COUNT = 0, K_SUM = 1, K_MIN = 2, K_MAX = 3 };

// the aggregate layout, fixed per query plan (the host caches it)
struct Layout {
  int kind[MAX_AGGS];
  int val_state[MAX_AGGS];   // -1 for count
  int cnt_state[MAX_AGGS];
  int naggs;
  int nstates;
};

// per call: each aggregate's value plane (int32 or int64; null for a
// count) and validity plane (bool; null: every row the mask keeps)
struct Planes {
  const void* val[MAX_AGGS];
  const uint8_t* valid[MAX_AGGS];
  int val_size[MAX_AGGS];
};

__device__ __forceinline__ unsigned long long splitmix64(
    unsigned long long z) {
  z += 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

__global__ void insert_kernel(const long long* __restrict__ key,
                              const uint8_t* __restrict__ mask,
                              const int32_t* __restrict__ tid, int64_t n,
                              unsigned long long* __restrict__ tkey,
                              unsigned long long* __restrict__ st,
                              int* __restrict__ counters, int64_t T,
                              int64_t GT, int cap, Layout L, Planes P) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  // warp-uniform trip count: every lane reaches the warp collectives
  for (int64_t i0 = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       i0 < n; i0 += stride) {
    const int64_t i = i0 + lane;
    const bool in = i < n && mask[i];
    const int g = (in && tid != nullptr) ? tid[i] : 0;
    int64_t s = 0;
    bool found = false, claimed = false;
    if (in) {
      const unsigned long long k = (unsigned long long)key[i];
      const unsigned long long stored = k ^ EMPTY_KEY;
      unsigned long long* tab = tkey + (int64_t)g * T;
      s = (int64_t)(splitmix64(k + SLOT_SEED) & (unsigned long long)(T - 1));
      for (int p = 0; p < MAX_PROBES; ++p) {
        // L2 read (a slot only goes from empty to a key, so a stale empty
        // is harmless: the CAS below is authoritative)
        unsigned long long cur = __ldcg(&tab[s]);
        if (cur == stored) { found = true; break; }
        if (cur == 0ull) {
          unsigned long long prev = atomicCAS(&tab[s], 0ull, stored);
          if (prev == 0ull) { claimed = true; break; }
          if (prev == stored) { found = true; break; }
        }
        s = (s + 1) & (T - 1);
      }
    }
    // reserve occupancy for the won claims, one atomic per table and warp
    const unsigned cm = __ballot_sync(0xffffffffu, claimed);
    if (claimed) {
      const unsigned peers = __match_any_sync(cm, g);
      const int leader = __ffs(peers) - 1;
      const int cnt = __popc(peers);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      int old = 0;
      if (lane == leader) {
        old = atomicAdd(&counters[2 * g + 1], cnt);
        const int over = old + cnt - cap;
        if (over > 0) atomicSub(&counters[2 * g + 1], over < cnt ? over : cnt);
      }
      old = __shfl_sync(peers, old, leader);
      found = old + rank < cap;
    }
    if (in && !found) {
      atomicAdd(&counters[2 * g], 1);
      continue;
    }
    if (!in) continue;
    const int64_t slot = (int64_t)g * T + s;
    for (int a = 0; a < L.naggs; ++a) {
      if (P.valid[a] != nullptr && !P.valid[a][i]) continue;
      atomicAdd(&st[L.cnt_state[a] * GT + slot], 1ull);
      if (L.kind[a] == K_COUNT) continue;
      const unsigned long long v =
          P.val_size[a] == 8
              ? (unsigned long long)((const long long*)P.val[a])[i]
              : (unsigned long long)(long long)((const int32_t*)P.val[a])[i];
      unsigned long long* dst = &st[L.val_state[a] * GT + slot];
      if (L.kind[a] == K_SUM)
        atomicAdd(dst, v);
      else if (L.kind[a] == K_MIN)
        atomicMax(dst, ~(v ^ SIGN));
      else
        atomicMax(dst, v ^ SIGN);
    }
  }
}

__global__ void epilogue_kernel(unsigned long long* __restrict__ tkey,
                                unsigned long long* __restrict__ st,
                                int64_t GT, Layout L,
                                unsigned long long* __restrict__ pairs,
                                int pair_state) {
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < GT;
       j += stride) {
    const unsigned long long stored = tkey[j];
    tkey[j] = stored ^ EMPTY_KEY;
    // an empty slot's states were never touched: all zero already
    if (stored != 0ull) {
      for (int a = 0; a < L.naggs; ++a) {
        const int kind = L.kind[a];
        if (kind != K_MIN && kind != K_MAX) continue;
        unsigned long long* v = &st[L.val_state[a] * GT + j];
        if (st[L.cnt_state[a] * GT + j] == 0ull)
          *v = 0ull;
        else
          *v = kind == K_MAX ? (*v ^ SIGN) : (~*v ^ SIGN);
      }
    }
    if (pairs != nullptr) {
      ulonglong2 e;
      e.x = stored ^ EMPTY_KEY;
      e.y = stored != 0ull ? st[pair_state * GT + j] : 0ull;
      reinterpret_cast<ulonglong2*>(pairs)[j] = e;
    }
  }
}

static unsigned grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  return (unsigned)blocks;
}

// C entry (bound with ctypes). key [n] int64, mask [n] bool, tid [n]
// int32 table ids (null when G = 1). `layout` points at a host Layout;
// `planes` at 3 * MAX_AGGS host words: per aggregate its value plane,
// validity plane and value width in bytes (4 or 8). `buf` is one device
// allocation of int64 words: counters [G, 2] int32 (G rounded up to even,
// in words), then table keys [G, T], then states [nstates, G, T]; all of
// it is zeroed here. `pairs` (null, or [G, T] 16-byte slots) receives
// {key, state `pair_state`} per slot. Returns cudaGetLastError() after
// the launches.
extern "C" int k3_hash_insert_multi(const int64_t* key, const uint8_t* mask,
                                    const int32_t* tid, int64_t n,
                                    const Layout* layout,
                                    const unsigned long long* planes,
                                    int64_t* buf, int64_t T, int G, int cap,
                                    int64_t* pairs, int pair_state,
                                    void* stream) {
  if (G < 1 || T <= 0 || (T & (T - 1)) != 0 || n < 0 ||
      layout->naggs < 0 || layout->naggs > MAX_AGGS ||
      (pairs != nullptr &&
       (pair_state < 0 || pair_state >= layout->nstates)))
    return (int)cudaErrorInvalidValue;
  Layout L = *layout;
  Planes P;
  for (int a = 0; a < MAX_AGGS; ++a) {
    P.val[a] = (const void*)planes[3 * a];
    P.valid[a] = (const uint8_t*)planes[3 * a + 1];
    P.val_size[a] = (int)planes[3 * a + 2];
  }
  const int64_t GT = (int64_t)G * T;
  const int64_t cwords = G + (G & 1);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(
      buf, 0, (size_t)(cwords + GT * (1 + L.nstates)) * sizeof(int64_t), s);
  if (e != cudaSuccess) return (int)e;
  int* counters = (int*)buf;
  unsigned long long* tkey = (unsigned long long*)(buf + cwords);
  unsigned long long* st = tkey + GT;
  const int threads = 256;
  if (n > 0) {
    insert_kernel<<<grid_for(n, threads), threads, 0, s>>>(
        (const long long*)key, mask, tid, n, tkey, st, counters, T, GT, cap,
        L, P);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  epilogue_kernel<<<grid_for(GT, threads), threads, 0, s>>>(
      tkey, st, GT, L, (unsigned long long*)pairs, pair_state);
  return (int)cudaGetLastError();
}
