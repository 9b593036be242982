// K5: a direct aggregate over a small dense group domain, for Hopper
// (sm_90a), in one launch.
//
// Replaces the TPU kernel `_kernel` (launched by `_mxu_sums`, public
// `direct_group_aggregate_mxu`) in trino_tpu/ops/pallas_agg.py, together
// with the torch work its wrapper did around it.
//
// Contract (the reference's `direct_group_aggregate_mxu`, bit for bit on
// its domain |value| < 2^59, wrapping int64 sums everywhere). Inputs are
// the batch's columns as they lie: the live byte of each row; per key
// (at most MAX_KEYS) its integer column (int8, int16, int32, int64 or a
// byte), its validity byte and its domain d; per aggregate (at most
// MAX_AGGS) a kind — count_star (no column), count (the column's
// validity) or sum (integer column and validity). A row contributes when
// it is live and every key is valid; its group is g = sum of digit *
// radix, each digit the key cast to int32 and clamped to [0, d-1]. The
// per-group planes are the reference's: the live count, then per count
// one plane, per sum its value and its non-null count (count_star reuses
// the live count). The kernel then writes the output batch's columns into
// one allocation at offsets the wrapper chose: each key's digit in the
// key's dtype, group_live = live count > 0, each state (int64) and each
// sum's validity (group_live and non-null count > 0).
//
// What bounds it on this card: bytes. Every row's live byte, key and key
// validity bytes, and per aggregate its value and validity byte, read
// once; the G x A (at most 16 x 17) sums are tiny. At a query's batch
// (q12: 32,768 rows) the wrapper used to dominate: about 30 torch passes
// building a group-id lane and [A, n] int64 planes in HBM, a memset, the
// kernel and ten epilogue ops.
//
// Design: each thread decodes its rows' group and plane values from the
// columns themselves (no lane, no plane in HBM), issuing all of a row's
// loads before it uses any (one memory latency a row, not one per
// column), and adds them into its warp's copy of the G x A cells in
// shared memory, sized to the call. The adds are native 32-bit atomics:
// 64-bit shared-memory atomics are a compare-and-swap loop on this card
// that spins when lanes share a group, so a 0/1 count adds to its word's
// low half and a value adds its two halves with the low half's carry.
// The TPU's one-hot matmul done in registers (templated G x A bounds,
// predicated adds, a warp shuffle) was built and measured slower at every
// shape timed, q12's batch included, and removed. The grid is a few
// blocks per SM with a grid-stride loop. Each block adds its non-zero
// sums into a small accumulator in the scratch buffer (integer atomics:
// the wrapping int64 sum is the same bits in any order, so the result is
// deterministic); the last block to take the ticket reads the sums,
// writes the output columns, and returns the accumulator and the ticket
// to zero for the next call. No memset, one kernel per call.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_KEYS 16
#define MAX_AGGS 8
#define MAX_GROUPS 16
#define MAX_PLANES (1 + 2 * MAX_AGGS)
#define MAX_CELLS (MAX_GROUPS * MAX_PLANES)
#define THREADS 256
#define MAX_DEVICES 16
// blocks per SM, and lanes sharing one copy of the cells (on an H100,
// with native 32-bit atomics, one copy a warp at 6 blocks an SM beat
// half a warp a copy and the other occupancies tried)
#define BLOCKS_PER_SM 6
#define LANES_PER_COPY 32
#define COPIES (THREADS / LANES_PER_COPY)

// column codes: the element size of a signed integer, or a byte
#define CODE_BYTE 9
// plane kinds
#define PLANE_CONTRIB 0    // 1 for a contributing row
#define PLANE_VALID 1      // the column's validity byte
#define PLANE_VALUE 2      // the column's value where valid, else 0
// aggregate kinds
#define AGG_COUNT_STAR 0
#define AGG_COUNT 1
#define AGG_SUM 2

struct Key {
  const void* data;
  const uint8_t* valid;
  int code;
  int domain;
  long long out_off;       // byte offset of its digit column in `out`
};

struct Plane {
  const void* data;
  const uint8_t* valid;
  int code;
  int kind;
};

struct Agg {
  int kind;
  int plane;               // its state's plane; a sum's count is plane + 1
  long long state_off;     // byte offset of its int64 state column
  long long valid_off;     // a sum's validity column (others: group_live)
};

struct Params {
  const uint8_t* live;
  long long n;
  int nkeys, naggs, G, A;
  Key key[MAX_KEYS];
  Plane plane[MAX_PLANES];
  Agg agg[MAX_AGGS];
  long long live_off;      // group_live's byte offset in `out`
  uint8_t* out;
  unsigned long long* acc;   // [MAX_CELLS] zero between calls
  unsigned int* ticket;      // zero between calls
};

__device__ __forceinline__ long long load_int(const void* p, int code,
                                              long long i) {
  switch (code) {
    case 1: return (long long)__ldg((const signed char*)p + i);
    case 2: return (long long)__ldg((const short*)p + i);
    case 4: return (long long)__ldg((const int*)p + i);
    case 8: return __ldg((const long long*)p + i);
    default: return (long long)__ldg((const unsigned char*)p + i);
  }
}

__device__ __forceinline__ void store_int(uint8_t* p, int code, int g,
                                          long long v) {
  switch (code) {
    case 1: ((signed char*)p)[g] = (signed char)v; break;
    case 2: ((short*)p)[g] = (short)v; break;
    case 4: ((int*)p)[g] = (int)v; break;
    case 8: ((long long*)p)[g] = v; break;
    default: p[g] = (uint8_t)v; break;
  }
}

// Row i's group, or -1 when it does not contribute (dead, or a NULL key).
// Every load is issued whatever the earlier ones hold, so that a row
// waits for one memory latency, not one per column.
__device__ __forceinline__ int row_group(const Params& P, long long i) {
  bool ok = __ldg(P.live + i);
  int g = 0;
#pragma unroll
  for (int k = 0; k < MAX_KEYS; ++k) {
    if (k < P.nkeys) {
      const Key& K = P.key[k];
      ok &= (bool)__ldg(K.valid + i);
      // the reference casts the key to int32 before it clamps
      int x = (int)load_int(K.data, K.code, i);
      x = min(max(x, 0), K.domain - 1);
      g = g * K.domain + x;
    }
  }
  return ok ? g : -1;
}

// Plane value of row i (loaded whatever its validity, then selected).
__device__ __forceinline__ unsigned long long plane_value(const Plane& Q,
                                                          long long i) {
  if (Q.kind == PLANE_CONTRIB) return 1ull;
  const bool valid = __ldg(Q.valid + i);
  if (Q.kind == PLANE_VALID) return valid;
  const long long x = load_int(Q.data, Q.code, i);
  return valid ? (unsigned long long)x : 0ull;
}

// The block's cell sums are in `cell` ([cells], shared). Adds them to the
// accumulator; the last block writes the output columns and resets.
__device__ void finish(const Params& P, const unsigned long long* cell,
                       unsigned long long* tot) {
  __shared__ bool last;
  const int cells = P.G * P.A;
  for (int c = threadIdx.x; c < cells; c += THREADS)
    if (cell[c]) atomicAdd(P.acc + c, cell[c]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(P.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int c = threadIdx.x; c < cells; c += THREADS)
    tot[c] = atomicExch(P.acc + c, 0ull);
  if (threadIdx.x == 0) atomicExch(P.ticket, 0u);
  __syncthreads();
  const int g = threadIdx.x;
  if (g >= P.G) return;
  const long long* t = (const long long*)tot + g * P.A;
  const bool live = t[0] > 0;
  P.out[P.live_off + g] = live;
  int radix = P.G;
#pragma unroll
  for (int k = 0; k < MAX_KEYS; ++k) {
    if (k < P.nkeys) {
      const Key& K = P.key[k];
      radix /= K.domain;
      store_int(P.out + K.out_off, K.code, g, (g / radix) % K.domain);
    }
  }
#pragma unroll
  for (int j = 0; j < MAX_AGGS; ++j) {
    if (j < P.naggs) {
      const Agg& a = P.agg[j];
      ((long long*)(P.out + a.state_off))[g] = t[a.plane];
      if (a.kind == AGG_SUM)
        P.out[a.valid_off + g] = live && t[a.plane + 1] > 0;
    }
  }
}

// A copy of the G x A cells in shared memory per LANES_PER_COPY lanes
// (dynamic, COPIES * G * A words).
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
k5_direct_agg_kernel(const __grid_constant__ Params P) {
  extern __shared__ unsigned long long copy_cells[];
  __shared__ unsigned long long cell[MAX_CELLS];
  __shared__ unsigned long long tot[MAX_CELLS];
  const int cells = P.G * P.A;
  for (int c = threadIdx.x; c < COPIES * cells; c += THREADS)
    copy_cells[c] = 0ull;
  __syncthreads();
  unsigned long long* mine =
      copy_cells + (threadIdx.x / LANES_PER_COPY) * cells;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < P.n; i += stride) {
    const int row = row_group(P, i);
    const unsigned long long keep = row >= 0 ? ~0ull : 0ull;
    unsigned long long v[MAX_PLANES];
#pragma unroll
    for (int a = 0; a < MAX_PLANES; ++a)
      v[a] = a < P.A ? plane_value(P.plane[a], i) & keep : 0ull;
    unsigned long long* at = mine + max(row, 0) * P.A;
    // native 32-bit atomics (64-bit ones compile to ATOMS.CAST.SPIN.64):
    // a 0/1 count adds to its word's low half (a copy sees far fewer than
    // 2^32 rows); a value adds its low half, then its high half plus the
    // low half's carry
#pragma unroll
    for (int a = 0; a < MAX_PLANES; ++a) {
      if (!v[a]) continue;
      unsigned int* word = (unsigned int*)(at + a);
      if (P.plane[a].kind == PLANE_VALUE) {
        const unsigned int lo = (unsigned int)v[a];
        const unsigned int old = atomicAdd(word, lo);
        const unsigned int hi = (unsigned int)(v[a] >> 32) + (old + lo < old);
        if (hi) atomicAdd(word + 1, hi);
      } else {
        atomicAdd(word, 1u);
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += THREADS) {
    unsigned long long s = 0ull;
    for (int w = 0; w < COPIES; ++w) s += copy_cells[w * cells + c];
    cell[c] = s;
  }
  __syncthreads();
  finish(P, cell, tot);
}

static int sm_count() {
  static int sms[MAX_DEVICES] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= MAX_DEVICES) dev = 0;
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev] > 0 ? sms[dev] : 132;
}

static unsigned grid(long long n) {
  long long blocks = (n + THREADS - 1) / THREADS;
  const long long cap = (long long)sm_count() * BLOCKS_PER_SM;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1u : (unsigned)blocks;
}

// Host words (uint64), per key k at [KEY_WORDS * k]: data, validity,
// code, domain, digit offset; per aggregate j at [KEY_WORDS * MAX_KEYS +
// AGG_WORDS * j]: kind, data, validity, code, state offset, validity
// offset; then group_live's offset.
#define KEY_WORDS 5
#define AGG_WORDS 6

// C entry (bound with ctypes). live [n] bool; out: the output columns'
// allocation (G groups); scratch: MAX_CELLS + 1 words, zero before the
// first call (each call leaves it zero). Returns cudaGetLastError()
// after the launch.
extern "C" int k5_direct_agg(const uint8_t* live,
                             const unsigned long long* words, long long n,
                             int nkeys, int naggs, int G, uint8_t* out,
                             unsigned long long* scratch, void* stream) {
  if (n < 0 || nkeys < 0 || nkeys > MAX_KEYS || naggs < 0 ||
      naggs > MAX_AGGS || G < 1 || G > MAX_GROUPS)
    return (int)cudaErrorInvalidValue;
  Params P;
  P.live = live;
  P.n = n;
  P.nkeys = nkeys;
  P.naggs = naggs;
  P.G = G;
  P.out = out;
  P.acc = scratch;
  P.ticket = (unsigned int*)(scratch + MAX_CELLS);
  long long domains = 1;
  for (int k = 0; k < MAX_KEYS; ++k) {
    const unsigned long long* w = words + KEY_WORDS * k;
    Key& K = P.key[k];
    K.data = (const void*)w[0];
    K.valid = (const uint8_t*)w[1];
    K.code = (int)w[2];
    K.domain = (int)w[3];
    K.out_off = (long long)w[4];
    if (k < nkeys) {
      if (K.domain < 1 || (K.code != 1 && K.code != 2 && K.code != 4 &&
                           K.code != 8 && K.code != CODE_BYTE))
        return (int)cudaErrorInvalidValue;
      domains *= K.domain;
    }
  }
  if (domains != G) return (int)cudaErrorInvalidValue;
  int A = 0;
  Plane contrib = {nullptr, nullptr, 0, PLANE_CONTRIB};
  P.plane[A++] = contrib;
  for (int j = 0; j < MAX_AGGS; ++j) {
    const unsigned long long* w = words + KEY_WORDS * MAX_KEYS + AGG_WORDS * j;
    Agg& a = P.agg[j];
    a.kind = (int)w[0];
    a.state_off = (long long)w[4];
    a.valid_off = (long long)w[5];
    a.plane = A;
    if (j >= naggs) continue;
    const void* data = (const void*)w[1];
    const uint8_t* valid = (const uint8_t*)w[2];
    const int code = (int)w[3];
    if (a.kind == AGG_COUNT_STAR) {
      P.plane[A++] = contrib;
    } else if (a.kind == AGG_COUNT) {
      P.plane[A++] = Plane{nullptr, valid, 0, PLANE_VALID};
    } else if (a.kind == AGG_SUM) {
      if (code != 1 && code != 2 && code != 4 && code != 8 &&
          code != CODE_BYTE)
        return (int)cudaErrorInvalidValue;
      P.plane[A++] = Plane{data, valid, code, PLANE_VALUE};
      P.plane[A++] = Plane{nullptr, valid, 0, PLANE_VALID};
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  for (int a = A; a < MAX_PLANES; ++a) P.plane[a] = contrib;
  P.A = A;
  P.live_off = (long long)words[KEY_WORDS * MAX_KEYS + AGG_WORDS * MAX_AGGS];
  cudaStream_t s = (cudaStream_t)stream;
  const size_t shared = (size_t)COPIES * G * A * sizeof(unsigned long long);
  k5_direct_agg_kernel<<<grid(n), THREADS, shared, s>>>(P);
  return (int)cudaGetLastError();
}
