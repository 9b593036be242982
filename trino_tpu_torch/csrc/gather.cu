// K1: fused multi-table gather for Hopper (sm_90a).
//
// Replaces the TPU kernel `_scan_kernel` / `_scan_gather_planes` in
// trino_tpu/ops/pallas_gather.py (public entry `gather_columns`):
//
//   out[t][i] = tables[t][idx[i]]   if 0 <= idx[i] < W
//             = fills[t]            otherwise
//
// bit-exact for every lane width (1, 2, 4, 8 bytes), int32 or int64
// indices.
//
// What bounds it on this card: bytes. The index is read once and every
// output written once; least time = (n * (idx bytes + sum(itemsize)) +
// the tables once) / 3.35 TB/s. What stands in the way is the random
// table reads: a thread that walked all of a call's tables for one index
// would keep a slice of every table in L1 at once, so nearly every read
// would be its own 32-byte L2 sector (a TPC-DS star's 18-table payload
// gather: ~216 M sector requests, 6.9 GB of L2 traffic for 1.15 GB of
// output).
//
// Design: one launch carries up to MAX_TABLES tables in its parameter
// block (__grid_constant__), so the index is read once. A persistent CTA
// of 512 threads takes a tile of indices at a time: each thread loads
// GROUPS groups of four consecutive indices (16- or 32-byte loads),
// range-checks them against W and keeps them as int32 in registers (a
// miss is -1). Then it walks the tables in order, reading each through
// __ldg, so that L1 holds the current table rather than a slice of all of
// them. Each thread writes its four outputs of a group as one 4-, 8-, 16-
// or 2 x 16-byte store: a warp's stores are contiguous. Where a table is
// small enough to stay in L1 the wrapper asks for big tiles (16,384
// indices), so that each tile reuses it across more indices.
//
// The TPU staged each table in VMEM and scanned it (its W <= 65536 gate).
// Hopper's counterpart, each table copied whole into shared memory per
// tile, measured slower than L1 on the H100's main-path launches (every
// tile re-copies its tables, where L1 fetches only the rows the tile
// touches; PERF.md), so it is not here.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_TABLES 64
#define THREADS 512
#define MAX_DEVICES 16          // cards whose occupancy a process caches
#define LANES 4                 // consecutive indices per thread and group

struct K1Args {
  const void* tab[MAX_TABLES];
  void* out[MAX_TABLES];
  unsigned long long fill[MAX_TABLES];
  unsigned char esize[MAX_TABLES];
  int ntab;
};

template <typename T>
__device__ __forceinline__ void store4(T* out, int64_t i0, int64_t n,
                                       const T (&v)[LANES]) {
  if (i0 + LANES <= n) {
    if constexpr (sizeof(T) == 1) {
      *(unsigned*)(out + i0) = (unsigned)v[0] | ((unsigned)v[1] << 8) |
                               ((unsigned)v[2] << 16) |
                               ((unsigned)v[3] << 24);
    } else if constexpr (sizeof(T) == 2) {
      *(uint2*)(out + i0) = make_uint2(
          (unsigned)v[0] | ((unsigned)v[1] << 16),
          (unsigned)v[2] | ((unsigned)v[3] << 16));
    } else if constexpr (sizeof(T) == 4) {
      *(uint4*)(out + i0) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
      ulonglong2* o = (ulonglong2*)(out + i0);
      o[0] = make_ulonglong2(v[0], v[1]);
      o[1] = make_ulonglong2(v[2], v[3]);
    }
  } else {
#pragma unroll
    for (int l = 0; l < LANES; ++l)
      if (i0 + l < n) out[i0 + l] = v[l];
  }
}

// one table over the thread's indices
template <typename T, int GROUPS>
__device__ __forceinline__ void gather_table(const T* src, T* out, T fill,
                                             const int (&j)[GROUPS][LANES],
                                             int64_t base, int64_t n) {
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int64_t i0 =
        base + ((int64_t)g * THREADS + threadIdx.x) * LANES;
    if (i0 < n) {
      T v[LANES];
#pragma unroll
      for (int l = 0; l < LANES; ++l) {
        const int k = j[g][l];
        v[l] = k < 0 ? fill : __ldg(src + k);
      }
      store4<T>(out, i0, n, v);
    }
  }
}

template <typename IdxT, int GROUPS>
__global__ void __launch_bounds__(THREADS, GROUPS >= 8 ? 1 : 2)
gather_kernel(const IdxT* __restrict__ idx, int64_t n, int64_t width,
              const __grid_constant__ K1Args a) {
  constexpr int64_t TILE = (int64_t)THREADS * LANES * GROUPS;
  const int64_t n_tiles = (n + TILE - 1) / TILE;
  const bool vec = ((uintptr_t)idx & 15) == 0;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t base = tile * TILE;
    int j[GROUPS][LANES];
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const int64_t i0 =
          base + ((int64_t)g * THREADS + threadIdx.x) * LANES;
      IdxT v[LANES];
      if (vec && i0 + LANES <= n) {
        if constexpr (sizeof(IdxT) == 8) {
          const longlong2 p = __ldg((const longlong2*)(idx + i0));
          const longlong2 q = __ldg((const longlong2*)(idx + i0) + 1);
          v[0] = p.x; v[1] = p.y; v[2] = q.x; v[3] = q.y;
        } else {
          const int4 p = __ldg((const int4*)(idx + i0));
          v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
        }
      } else {
#pragma unroll
        for (int l = 0; l < LANES; ++l)
          v[l] = i0 + l < n ? __ldg(idx + i0 + l) : (IdxT)-1;
      }
#pragma unroll
      for (int l = 0; l < LANES; ++l)
        j[g][l] = (v[l] >= 0 && (int64_t)v[l] < width) ? (int)v[l] : -1;
    }
    for (int t = 0; t < a.ntab; ++t) {
      const void* src = a.tab[t];
      void* out = a.out[t];
      const unsigned long long fill = a.fill[t];
      switch (a.esize[t]) {
        case 8:
          gather_table<unsigned long long, GROUPS>(
              (const unsigned long long*)src, (unsigned long long*)out, fill,
              j, base, n);
          break;
        case 4:
          gather_table<unsigned, GROUPS>((const unsigned*)src,
                                         (unsigned*)out, (unsigned)fill, j,
                                         base, n);
          break;
        case 2:
          gather_table<unsigned short, GROUPS>(
              (const unsigned short*)src, (unsigned short*)out,
              (unsigned short)fill, j, base, n);
          break;
        default:
          gather_table<unsigned char, GROUPS>(
              (const unsigned char*)src, (unsigned char*)out,
              (unsigned char)fill, j, base, n);
          break;
      }
    }
  }
}

template <typename IdxT, int GROUPS>
static int launch(const void* idx, int64_t n, int64_t width, const K1Args& a,
                  cudaStream_t s) {
  auto kern = gather_kernel<IdxT, GROUPS>;
  // per instance and card, once: the blocks that fit on the current card
  // (the caller made the tensors' card current) at a time
  static int64_t resident[MAX_DEVICES] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident[dev] = (int64_t)sms * per_sm;
  }
  const int64_t tile = (int64_t)THREADS * LANES * GROUPS;
  int64_t grid = (n + tile - 1) / tile;
  if (grid > resident[dev]) grid = resident[dev];
  kern<<<(unsigned)grid, THREADS, 0, s>>>((const IdxT*)idx, n, width, a);
  return (int)cudaGetLastError();
}

// C entry (bound with ctypes). `desc` holds four words per table: the
// table's device pointer, its output's (16-byte aligned, n elements), the
// fill bit pattern (low esize bytes used) and esize. `big_tile` picks
// 16,384 indices per tile (else 4,096). Returns cudaGetLastError() after
// the launch (0 = launched), or the error that refused it.
extern "C" int k1_gather(const void* idx, int idx_bytes, int64_t n,
                         int64_t width, int ntab,
                         const unsigned long long* desc, int big_tile,
                         void* stream) {
  if (ntab < 1 || ntab > MAX_TABLES || n < 1 || width < 0 ||
      width > 0x7fffffffLL || (idx_bytes != 4 && idx_bytes != 8))
    return (int)cudaErrorInvalidValue;
  K1Args a;
  a.ntab = ntab;
  for (int t = 0; t < MAX_TABLES; ++t) {
    const unsigned long long* d = desc + 4 * (t < ntab ? t : 0);
    a.tab[t] = (const void*)d[0];
    a.out[t] = (void*)d[1];
    a.fill[t] = d[2];
    a.esize[t] = (unsigned char)d[3];
    const unsigned long long e = d[3];
    if (e != 1 && e != 2 && e != 4 && e != 8) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (idx_bytes == 8)
    return big_tile ? launch<int64_t, 8>(idx, n, width, a, s)
                    : launch<int64_t, 2>(idx, n, width, a, s);
  return big_tile ? launch<int, 8>(idx, n, width, a, s)
                  : launch<int, 2>(idx, n, width, a, s);
}
