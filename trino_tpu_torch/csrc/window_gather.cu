// K2: windowed single-word gather for Hopper (sm_90a).
//
// Replaces the TPU kernel `_window_kernel` (launched by
// `_window_gather_planes`, public `gather_word_windowed`) in
// trino_tpu/ops/pallas_gather.py.
//
// Contract (the TPU kernel's, word for word and escape for escape). The
// TPU wrapper's index prep is folded in: an index outside [0, lut_len) of
// the PADDED LUT is a miss (-1), and the last tile is padded with misses,
// tiles aligned at index 0. The LUT is padded to a multiple of WIN = 8192
// entries, at least 2 * WIN, so n_blocks = lut_len / WIN >= 2, and
// lut_len < 2^31 (the TPU's int32 indices). Per 1024-index tile:
//
//   base = clip(min(in-range indices of the tile) / WIN, 0, n_blocks - 2)
//          (a tile with no in-range index takes INT32_MAX, so the clip)
//   rel  = idx - base * WIN
//   out  = lut[idx] sign-extended to int64  if 0 <= rel < 2 * WIN
//        = 0                                otherwise
//
// and every in-range index outside its tile's window is an escape; the
// escapes of all tiles are summed into one int64. The caller treats a
// non-zero total as a violated near-sorted guess and reruns plain.
//
// What bounds it on this card: bytes. Each index is read once (8 B) and
// each word written once (8 B); the LUT bytes read are those of the
// windows the tiles touch, at most the key span of the chunk. The TPU
// needed the window DMA'd into VMEM because Mosaic gathers only along
// lanes; here each thread reads its words straight from global memory
// (__ldg), which is the value the window would hold. A near-sorted tile
// touches about as many consecutive entries as it has indices, so its
// reads fall on a few consecutive sectors that L2 serves; staging the
// whole 2 * WIN window in shared memory would read 16x the LUT bytes the
// tile needs.
//
// Design: one CTA of 256 threads per 1024-index tile, each thread four
// consecutive indices (two 16-byte index loads, two 16-byte word stores),
// so that every tile of a 1M-index call is resident in one wave. The tile
// minimum is a warp __reduce_min_sync, then one more over the 8 warp
// minima in shared memory; escapes likewise with __reduce_add_sync, one
// atomicAdd per block with escapes into the total, which the C entry
// zeroes with one memset on the launch stream first. The kernel is
// templated on the word size (1, 2, 4 or 8 bytes).

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 1024
#define WIN 8192
#define THREADS 256
#define PER_THREAD (TILE / THREADS)

template <typename T>
__global__ void __launch_bounds__(THREADS)
window_gather_kernel(const int64_t* __restrict__ idx, int64_t n,
                     const T* __restrict__ lut, int64_t lut_len,
                     int64_t* __restrict__ out,
                     unsigned long long* __restrict__ esc, bool vec) {
  __shared__ unsigned warp_min[THREADS / 32];
  __shared__ unsigned warp_esc[THREADS / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t i0 = (int64_t)blockIdx.x * TILE + (int64_t)t * PER_THREAD;
  int64_t j[PER_THREAD];
  if (vec && i0 + PER_THREAD <= n) {
    const longlong2 a = __ldg((const longlong2*)(idx + i0));
    const longlong2 b = __ldg((const longlong2*)(idx + i0) + 1);
    j[0] = a.x; j[1] = a.y; j[2] = b.x; j[3] = b.y;
  } else {
#pragma unroll
    for (int l = 0; l < PER_THREAD; ++l)
      j[l] = i0 + l < n ? __ldg(idx + i0 + l) : -1;
  }
  unsigned m = 0x7fffffffu;
#pragma unroll
  for (int l = 0; l < PER_THREAD; ++l) {
    if (j[l] < 0 || j[l] >= lut_len) j[l] = -1;
    else m = min(m, (unsigned)j[l]);
  }
  m = __reduce_min_sync(0xffffffffu, m);
  if (lane == 0) warp_min[warp] = m;
  __syncthreads();
  if (warp == 0) {
    unsigned mm = __reduce_min_sync(
        0xffffffffu, lane < THREADS / 32 ? warp_min[lane] : 0x7fffffffu);
    if (lane == 0) warp_min[0] = mm;
  }
  __syncthreads();
  // the minimum is >= 0 and n_blocks - 2 >= 0, so one side of the clip
  const int64_t lo = (int64_t)warp_min[0] / WIN, top = lut_len / WIN - 2;
  const int64_t base = lo < top ? lo : top;
  int64_t w[PER_THREAD];
  unsigned e = 0;
#pragma unroll
  for (int l = 0; l < PER_THREAD; ++l) {
    const int64_t rel = j[l] - base * WIN;
    const bool in_win = j[l] >= 0 && rel >= 0 && rel < 2 * WIN;
    w[l] = in_win ? (int64_t)__ldg(lut + j[l]) : 0;
    e += j[l] >= 0 && !in_win;
  }
  if (i0 + PER_THREAD <= n) {
    ((longlong2*)(out + i0))[0] = make_longlong2(w[0], w[1]);
    ((longlong2*)(out + i0))[1] = make_longlong2(w[2], w[3]);
  } else {
#pragma unroll
    for (int l = 0; l < PER_THREAD; ++l)
      if (i0 + l < n) out[i0 + l] = w[l];
  }
  e = __reduce_add_sync(0xffffffffu, e);
  if (lane == 0) warp_esc[warp] = e;
  __syncthreads();
  if (warp == 0) {
    const unsigned total = __reduce_add_sync(
        0xffffffffu, lane < THREADS / 32 ? warp_esc[lane] : 0u);
    if (lane == 0 && total != 0u) atomicAdd(esc, (unsigned long long)total);
  }
}

template <typename T>
static void launch(const int64_t* idx, int64_t n, const void* lut,
                   int64_t lut_len, int64_t* out, unsigned long long* esc,
                   cudaStream_t s) {
  const int64_t n_tiles = (n + TILE - 1) / TILE;
  const bool vec = ((uintptr_t)idx & 15) == 0;
  window_gather_kernel<T><<<(unsigned)n_tiles, THREADS, 0, s>>>(
      idx, n, (const T*)lut, lut_len, out, esc, vec);
}

// C entry (bound with ctypes). idx: n int64 indices, any value (-1 and
// anything outside [0, lut_len) are misses); lut: lut_len words of esize
// bytes (lut_len a multiple of WIN, >= 2 * WIN, < 2^31); out: n int64,
// 16-byte aligned; esc: one int64, zeroed here. n must be > 0. Returns
// the memset's error, or cudaGetLastError() after the launch.
extern "C" int k2_window_gather(const int64_t* idx, int64_t n,
                                const void* lut, int64_t lut_len, int esize,
                                int64_t* out, int64_t* esc, void* stream) {
  if (n <= 0 || lut_len % WIN != 0 || lut_len < 2 * WIN ||
      lut_len > 0x7fffffffLL || ((uintptr_t)out & 15) != 0 ||
      (esize != 1 && esize != 2 && esize != 4 && esize != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(esc, 0, sizeof(int64_t), s);
  if (err != cudaSuccess) return (int)err;
  unsigned long long* ue = (unsigned long long*)esc;
  switch (esize) {
    case 1: launch<signed char>(idx, n, lut, lut_len, out, ue, s); break;
    case 2: launch<short>(idx, n, lut, lut_len, out, ue, s); break;
    case 4: launch<int>(idx, n, lut, lut_len, out, ue, s); break;
    default: launch<long long>(idx, n, lut, lut_len, out, ue, s); break;
  }
  return (int)cudaGetLastError();
}
