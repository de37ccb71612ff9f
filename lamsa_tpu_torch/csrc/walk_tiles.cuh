// Shared by the two traceback walkers (traceback_adiag.cu,
// traceback_row.cu): cp.async copies and the staging of one tile of
// direction words into a warp's shared-memory buffer.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace walk_tiles {

constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Lane origin of a tile staged for a cursor at lane l: a multiple of 4
// words (16 bytes), LEFT to LEFT + 3 lanes left of the cursor.
template <int LEFT>
__device__ __forceinline__ int tile_origin(int l) {
  return (l - LEFT) & ~3;
}

// Stage tile t of an instance's direction words db[R][L]: word rows
// [t*TR, (t+1)*TR) by lanes [l0, l0 + TL), into a buffer of row stride
// TS words. Words outside [0, R) x [0, L) are not copied and never read.
// vec16: 16-byte copies (L a multiple of 4 words and db 16-byte
// aligned; l0 always is a multiple of 4), else word by word.
template <int TR, int TL, int TS>
__device__ __forceinline__ void stage(int32_t* tile, const int32_t* db, int t,
                                      int l0, int R, int L, int vec16,
                                      int lane) {
  static_assert(TL % 4 == 0 && TL >= 8 && TR >= 1 && TS % 4 == 0,
                "tile shape");
  if (t < 0) return;
  if (vec16) {
    constexpr int CH = TL / 4;          // 16-byte chunks per tile row
    for (int c = lane; c < TR * CH; c += 32) {
      const int k = c / CH, x = (c % CH) * 4;
      const int wr = t * TR + k, gl = l0 + x;
      if (wr < R && gl >= 0 && gl < L)
        cp_async16(tile + k * TS + x, db + (size_t)wr * L + gl);
    }
  } else {
    for (int c = lane; c < TR * TL; c += 32) {
      const int k = c / TL, x = c % TL;
      const int wr = t * TR + k, gl = l0 + x;
      if (wr < R && gl >= 0 && gl < L)
        cp_async4(tile + k * TS + x, db + (size_t)wr * L + gl);
    }
  }
}

}  // namespace walk_tiles
