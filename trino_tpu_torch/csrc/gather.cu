// K1: fused multi-table gather for Hopper (sm_90a).
//
// Replaces the TPU kernel `_scan_kernel` / `_scan_gather_planes` in
// trino_tpu/ops/pallas_gather.py (public entry `gather_columns`):
//
//   out[t][i] = tables[t][idx[i]]   if 0 <= idx[i] < W
//             = fills[t]            otherwise
//
// bit-exact for every lane width (1, 2, 4, 8 bytes).
//
// What bounds it on this card: bytes. Each output index reads its 8-byte
// index once and writes sum(itemsize) bytes of output; each table read is
// a random access that costs one 32-byte sector of DRAM traffic unless the
// table is L2-resident (50 MB L2: a 1.5M-row int64 table or an 8M-entry
// int32 LUT fits). Least time = n * (8 + sum(itemsize) + 32 * T) bytes /
// 3.35 TB/s; an L2-resident table does better than that bound's sector term.
//
// Design: the TPU needed int32 planes and a slab scan over the table
// (W/1024 VPU ops per element, hence its W <= 65536 gate). Hopper has
// native 64-bit loads and a gather costs the same at any W, so the kernel
// is one thread per output index (grid-stride): the index is sanitised
// once, then the thread walks up to MAX_TABLES tables whose pointers,
// element sizes and fill bit patterns ride in the kernel's parameter
// block (no device-side argument buffer). Consecutive threads write
// consecutive outputs, so every store is coalesced; only the table reads
// are random.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_TABLES 16

struct GatherArgs {
  const void* tab[MAX_TABLES];
  void* out[MAX_TABLES];
  unsigned long long fill[MAX_TABLES];
  int esize[MAX_TABLES];
  int ntab;
};

__global__ void gather_kernel(const int64_t* __restrict__ idx, int64_t n,
                              int64_t width, GatherArgs a) {
  int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int64_t j = idx[i];
    bool ok = (j >= 0) && (j < width);
    for (int t = 0; t < a.ntab; ++t) {
      switch (a.esize[t]) {
        case 8: {
          uint64_t v = ok ? ((const uint64_t*)a.tab[t])[j]
                          : (uint64_t)a.fill[t];
          ((uint64_t*)a.out[t])[i] = v;
          break;
        }
        case 4: {
          uint32_t v = ok ? ((const uint32_t*)a.tab[t])[j]
                          : (uint32_t)a.fill[t];
          ((uint32_t*)a.out[t])[i] = v;
          break;
        }
        case 2: {
          uint16_t v = ok ? ((const uint16_t*)a.tab[t])[j]
                          : (uint16_t)a.fill[t];
          ((uint16_t*)a.out[t])[i] = v;
          break;
        }
        default: {
          uint8_t v = ok ? ((const uint8_t*)a.tab[t])[j]
                         : (uint8_t)a.fill[t];
          ((uint8_t*)a.out[t])[i] = v;
          break;
        }
      }
    }
  }
}

// C entry (bound with ctypes). `tables`/`outs` are arrays of `ntab` device
// pointers, `esizes` element sizes in bytes, `fills` the per-table fill
// bit patterns (low esize bytes used). Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int k1_gather(const int64_t* idx, int64_t n, int64_t width,
                         int ntab, void* const* tables, void* const* outs,
                         const int* esizes, const unsigned long long* fills,
                         void* stream) {
  if (ntab < 1 || ntab > MAX_TABLES) return (int)cudaErrorInvalidValue;
  GatherArgs a;
  for (int t = 0; t < MAX_TABLES; ++t) {
    a.tab[t] = t < ntab ? tables[t] : nullptr;
    a.out[t] = t < ntab ? outs[t] : nullptr;
    a.esize[t] = t < ntab ? esizes[t] : 1;
    a.fill[t] = t < ntab ? fills[t] : 0ull;
  }
  a.ntab = ntab;
  if (n > 0) {
    const int threads = 256;
    int64_t blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;  // 32 blocks per SM, then stride
    gather_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        idx, n, width, a);
  }
  return (int)cudaGetLastError();
}
