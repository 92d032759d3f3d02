// What the beam-decode kernels share: B and C (decode_attention.cu) and D
// (decode_attention_q.cu). The compaction of the live cache columns of a
// split, and mma.sync on signed 8-bit operands.
//
// Fragment layouts of mma.m16n8k32.row.col.s32.s8.s8.s32 (lane = 4 g + tq),
// four int8 per register, the lowest k in the lowest byte:
//   A (16 x 32): a0 = (g, 4tq..4tq+3), a1 = (g + 8, 4tq..), a2 = (g, 16 + 4tq..),
//                a3 = (g + 8, 16 + 4tq..);
//   B (32 x 8):  b0 = (k 4tq..4tq+3, n g), b1 = (k 16 + 4tq.., n g);
//   C (16 x 8):  int32, as the f32 accumulators of m16n8k16 (flash_attention_mma.cuh).
// In bytes these are the bf16 m16n8k16 fragments, so a row of 32 int8 is
// read as a row of 16 bf16 would be.
#pragma once

#include "flash_attention_mma.cuh"

namespace mm {

constexpr int kMaxBeams = 16;  // query rows per (b, h) of B, C's decode step, D, F
constexpr int kBSpan = 2048;   // most columns one split covers (16-bit offsets)
constexpr int kSMs = 132;      // an H100's SMs

// The live columns of [c0, c1) (those on some beam's path, flat_rep[k][j]
// == j), in column order, as (offset | beams << 16) into ``live``; returns
// their count. Each thread reads R columns per round with all its K loads
// in flight at once (``count`` holds R x NT / 32 ints). Ends with a block
// barrier, so what the block wrote before the call is visible after it.
template <int NT, int R>
__device__ __forceinline__ int compact_live(const int* fr, int K, int TS, int c0, int c1,
                                            uint32_t* live, int* count) {
  constexpr int NW = NT / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int n_live = 0;
  for (int base = c0; base < c1; base += NT * R) {
    int v[R][kMaxBeams];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = base + r * NT + threadIdx.x;
#pragma unroll
      for (int k = 0; k < kMaxBeams; ++k) v[r][k] = k < K && j < c1 ? fr[(int64_t)k * TS + j] : -1;
    }
    unsigned beams[R], ballot[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = base + r * NT + threadIdx.x;
      beams[r] = 0;
#pragma unroll
      for (int k = 0; k < kMaxBeams; ++k) beams[r] |= (unsigned)(v[r][k] == j) << k;
      ballot[r] = __ballot_sync(0xffffffffu, beams[r] != 0);
      if (lane == 0) count[r * NW + warp] = __popc(ballot[r]);
    }
    __syncthreads();
    int off = n_live;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int mine = off;
      for (int w = 0; w < NW; ++w) {
        mine += w < warp ? count[r * NW + w] : 0;
        off += count[r * NW + w];
      }
      if (beams[r])
        live[mine + __popc(ballot[r] & ((1u << lane) - 1))] =
            (uint32_t)(base + r * NT + threadIdx.x - c0) | (beams[r] << 16);
    }
    n_live = off;
    __syncthreads();  // count is rewritten by the next round
  }
  return n_live;
}

namespace tc {

// c += a . b, one m16n8k32 tile, int8 inputs, exact int32 accumulators.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The two int8 in the low 16 bits of x as two bf16 (exact: |x| <= 128), lo low.
__device__ __forceinline__ uint32_t i8x2_bf16x2(uint32_t x) {
  return pack_bf16((float)(int8_t)(x & 0xFFu), (float)(int8_t)((x >> 8) & 0xFFu));
}

// Four ints (each in [-128, 127]) as four int8 bytes, a lowest.
__device__ __forceinline__ uint32_t pack_i8x4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xFF) | ((uint32_t)(b & 0xFF) << 8) | ((uint32_t)(c & 0xFF) << 16) |
         ((uint32_t)(d & 0xFF) << 24);
}

}  // namespace tc
}  // namespace mm
