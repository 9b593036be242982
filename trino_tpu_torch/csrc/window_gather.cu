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
// lanes; here each thread reads its word straight from global memory
// (__ldg), which is the value the window would hold. A near-sorted tile
// touches at most 2 * WIN consecutive entries, so its reads fall on a few
// hundred consecutive sectors that L2 serves.
//
// Design: one CTA of 1024 threads per tile. The tile minimum is a warp
// __reduce_min_sync, then one more over the 32 warp minima in shared
// memory. Escapes are counted per warp (__ballot_sync + __popc) and added
// with one 64-bit atomicAdd per warp. The kernel is templated on the word
// size (1, 2, 4 or 8 bytes). Staging the window in shared memory (TMA or
// cp.async) is left to a later performance change.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 1024
#define WIN 8192

template <typename T>
__global__ void window_gather_kernel(const int64_t* __restrict__ idx,
                                     int64_t n, const T* __restrict__ lut,
                                     int64_t lut_len,
                                     int64_t* __restrict__ out,
                                     unsigned long long* __restrict__ esc) {
  __shared__ unsigned warp_min[TILE / 32];
  const int t = threadIdx.x;
  const int64_t i = (int64_t)blockIdx.x * TILE + t;
  const int64_t j = i < n ? idx[i] : -1;
  const bool in_range = j >= 0 && j < lut_len;
  unsigned m = __reduce_min_sync(0xffffffffu,
                                 in_range ? (unsigned)j : 0x7fffffffu);
  if ((t & 31) == 0) warp_min[t >> 5] = m;
  __syncthreads();
  if (t < 32) {
    unsigned mm = __reduce_min_sync(0xffffffffu, warp_min[t]);
    if (t == 0) warp_min[0] = mm;
  }
  __syncthreads();
  // the minimum is >= 0 and n_blocks - 2 >= 0, so one side of the clip
  const int64_t lo = (int64_t)warp_min[0] / WIN, top = lut_len / WIN - 2;
  const int64_t base = lo < top ? lo : top;
  const int64_t rel = j - base * WIN;
  const bool in_win = in_range && rel >= 0 && rel < 2 * WIN;
  if (i < n) out[i] = in_win ? (int64_t)__ldg(lut + j) : 0;
  unsigned e = __ballot_sync(0xffffffffu, in_range && !in_win);
  if ((t & 31) == 0 && e != 0u)
    atomicAdd(esc, (unsigned long long)__popc(e));
}

template <typename T>
static void launch(const int64_t* idx, int64_t n, const void* lut,
                   int64_t lut_len, int64_t* out, unsigned long long* esc,
                   cudaStream_t s) {
  const int64_t n_tiles = (n + TILE - 1) / TILE;
  window_gather_kernel<T><<<(unsigned)n_tiles, TILE, 0, s>>>(
      idx, n, (const T*)lut, lut_len, out, esc);
}

// C entry (bound with ctypes). idx: n int64 indices, any value (-1 and
// anything outside [0, lut_len) are misses); lut: lut_len words of esize
// bytes (lut_len a multiple of WIN, >= 2 * WIN, < 2^31); out: n int64;
// esc: one int64, zeroed here. Returns cudaGetLastError() after the
// launch.
extern "C" int k2_window_gather(const int64_t* idx, int64_t n,
                                const void* lut, int64_t lut_len, int esize,
                                int64_t* out, int64_t* esc, void* stream) {
  if (n < 0 || lut_len % WIN != 0 || lut_len < 2 * WIN ||
      lut_len > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(esc, 0, sizeof(int64_t), s);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return (int)cudaSuccess;
  unsigned long long* ue = (unsigned long long*)esc;
  switch (esize) {
    case 1: launch<signed char>(idx, n, lut, lut_len, out, ue, s); break;
    case 2: launch<short>(idx, n, lut, lut_len, out, ue, s); break;
    case 4: launch<int>(idx, n, lut, lut_len, out, ue, s); break;
    case 8: launch<long long>(idx, n, lut, lut_len, out, ue, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
