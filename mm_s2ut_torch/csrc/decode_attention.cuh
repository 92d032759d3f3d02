// What the beam-decode kernels share: B and C (decode_attention.cu), D, E
// and F (decode_attention_q.cu). The compaction of the live cache columns
// of a split, mma.sync on signed 8-bit operands, the int4 cache's nibble
// unpack, and the fp32 kernels' 3xTF32 fragments read from raw tiles.
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

#include <type_traits>

#include "flash_attention_mma.cuh"

namespace mm {

constexpr int kMaxBeams = 16;  // query rows per (b, h) of B, C's decode step, D, F
constexpr int kBSpan = 2048;   // most columns one split covers (16-bit offsets)
constexpr int kSMs = 132;      // an H100's SMs
constexpr int kSmemPerSM = 233472;  // an SM's shared memory for blocks on Hopper, 1 KB of it
                                    // reserved per resident block

// The live columns of [c0, c1) (those on some beam's path, flat_rep[k][j]
// == j), in column order, as (offset | beams << 16) into ``live``; returns
// their count. Each thread reads R columns per round with all its K loads
// in flight at once (``count`` holds R x NT / 32 ints). Ends with a block
// barrier, so what the block wrote before the call is visible after it.
// PAIR: [c0, c1) are packed rows of an int4 cache (P rows, row j holds
// columns j and j + P); a row is live if either column is, ``live`` gets
// its low column's beams and ``live_hi`` its high column's.
template <int NT, int R, bool PAIR = false>
__device__ __forceinline__ int compact_live(const int* fr, int K, int TS, int c0, int c1,
                                            uint32_t* live, int* count, int P = 0,
                                            uint16_t* live_hi = nullptr) {
  constexpr int NW = NT / 32, NH = PAIR ? 2 : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int n_live = 0;
  for (int base = c0; base < c1; base += NT * R) {
    int v[R][NH][kMaxBeams];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = base + r * NT + threadIdx.x;
#pragma unroll
      for (int hf = 0; hf < NH; ++hf)
#pragma unroll
        for (int k = 0; k < kMaxBeams; ++k)
          v[r][hf][k] = k < K && j < c1 ? fr[(int64_t)k * TS + j + hf * P] : -1;
    }
    unsigned beams[R][NH], ballot[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = base + r * NT + threadIdx.x;
#pragma unroll
      for (int hf = 0; hf < NH; ++hf) {
        beams[r][hf] = 0;
#pragma unroll
        for (int k = 0; k < kMaxBeams; ++k) beams[r][hf] |= (unsigned)(v[r][hf][k] == j + hf * P) << k;
      }
      ballot[r] = __ballot_sync(0xffffffffu, (beams[r][0] | beams[r][NH - 1]) != 0);
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
      if (beams[r][0] | beams[r][NH - 1]) {
        mine += __popc(ballot[r] & ((1u << lane) - 1));
        live[mine] = (uint32_t)(base + r * NT + threadIdx.x - c0) | (beams[r][0] << 16);
        if constexpr (PAIR) live_hi[mine] = (uint16_t)beams[r][1];
      }
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

// The low (high = false) or high nibbles of four packed int4 bytes, each
// sign-extended to a byte: byte-parallel, (n ^ 8) - 8 on four nibbles at
// once (WIDE = false), or each byte widened to int32 and shifted, as the
// reference's unpack does (WIDE = true). The same bytes either way.
template <bool WIDE = false>
__device__ __forceinline__ uint32_t nibbles(uint32_t w, bool high) {
  if constexpr (WIDE) {
    uint32_t r = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int x = (int)(int8_t)(w >> (8 * i));
      r |= (uint32_t)((high ? x >> 4 : (int)((uint32_t)x << 28) >> 28) & 0xFF) << (8 * i);
    }
    return r;
  } else {
    const uint32_t n = (high ? w >> 4 : w) & 0x0F0F0F0Fu;
    return __vsub4(n ^ 0x08080808u, 0x08080808u);
  }
}

// ------------------------------------------------ fp32: 3xTF32 on raw tiles
//
// In fp32 B and C a warp owns its key tiles, so each K and V element meets
// one warp and one product. A split tile (flash_attention.cu's, written
// once per block for the 4 warps that share it) would cost a pass over
// shared memory and twice its room for nothing here: the fragments are
// read from the raw fp32 tile that cp.async filled and split into their
// tf32 halves in registers (split_tf32), each element once. A raw tile
// holds rows of D floats; 16-byte chunk c of row r sits at chunk
// c ^ (2 ((r ^ (r >> 2)) & 3) mod D / 4), so that the 8-byte reads of
// frag_b32_rows (a half-warp: rows n0 .. n0 + 3, 8 floats each) and the
// 4-byte reads of frag_bt32_rows (rows k0 + 2 tq + j, 8 floats each) fall on
// 32 distinct banks for D >= 32 (2-way at D = 16). The k-step order is
// flash_attention_mma.cuh's 0, 2, 4, 6, 1, 3, 5, 7.

// The float offset of element e of row r of a raw D-wide tile.
template <int D>
__device__ __forceinline__ int rsw(int r, int e) {
  constexpr int CH = D / 4;
  static_assert(CH >= 4, "at least four 16-byte chunks per row");
  return r * D + (((e >> 2) ^ ((2 * ((r ^ (r >> 2)) & 3)) & (CH - 1))) << 2) + (e & 3);
}

// A fragment: rows r0..r0+15 of a raw tile, k = head dims 8 kk..8 kk+7.
template <int D>
__device__ __forceinline__ void frag_a32_rows(FragA32& f, const float* tile, int r0, int kk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const float2 x0 = *reinterpret_cast<const float2*>(tile + rsw<D>(r0 + g, 8 * kk + 2 * tq));
  const float2 x1 = *reinterpret_cast<const float2*>(tile + rsw<D>(r0 + g + 8, 8 * kk + 2 * tq));
  split_tf32(x0.x, f.hi[0], f.lo[0]);
  split_tf32(x1.x, f.hi[1], f.lo[1]);
  split_tf32(x0.y, f.hi[2], f.lo[2]);
  split_tf32(x1.y, f.hi[3], f.lo[3]);
}

// B fragment with n = rows n0..n0+7 of a raw tile and k = head dims
// 8 kk..8 kk+7 (Q.K^T reads K so).
template <int D>
__device__ __forceinline__ void frag_b32_rows(FragB32& f, const float* tile, int n0, int kk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const float2 x = *reinterpret_cast<const float2*>(tile + rsw<D>(n0 + g, 8 * kk + 2 * tq));
  split_tf32(x.x, f.hi[0], f.lo[0]);
  split_tf32(x.y, f.hi[1], f.lo[1]);
}

// B fragment with k = rows k0..k0+7 of a raw tile in the k-step order and
// n = head dims 8 dn..8 dn+7 (P.V reads V so).
template <int D>
__device__ __forceinline__ void frag_bt32_rows(FragB32& f, const float* tile, int k0, int dn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  split_tf32(tile[rsw<D>(k0 + 2 * tq, 8 * dn + g)], f.hi[0], f.lo[0]);
  split_tf32(tile[rsw<D>(k0 + 2 * tq + 1, 8 * dn + g)], f.hi[1], f.lo[1]);
}

// ------------------------------------- the warps' online softmax and merge

// One tile of a warp's online softmax over its 16 mma rows (rows g and g +
// 8 of each thread): ``s`` holds the tile's logits, -inf where masked,
// element e of n-tile n in row g + 8 (e >> 1). On return it holds p =
// exp(s - m_new) (0 while a row's max is still -inf), and l_run and o are
// rescaled by exp(m_old - m_new), l_run with the tile's p added. B, C and
// E, both dtypes.
template <int NS, int NT>
__device__ __forceinline__ void softmax_tile(float (&s)[NS][4], float (&o)[NT][4],
                                             float (&m_run)[2], float (&l_run)[2]) {
  float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
  float alpha[2], m_new[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_new[r] = fmaxf(m_run[r], quad_max(mt[r]));
    // -inf until an unmasked column comes: nothing to rescale yet
    alpha[r] = m_new[r] == -INFINITY ? 1.f : exp_e(m_run[r] - m_new[r]);
    m_run[r] = m_new[r];
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float p = m_new[r] == -INFINITY ? 0.f : exp_e(s[n][e] - m_new[r]);
      l_run[r] += p;
      s[n][e] = p;
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
}

// The end of the 4 warps' tiles: each warp's (m, l, O) of its 16 rows into
// ``merge`` (4 x 16 (D + 2) floats over the drained rings), then, for each
// (row k < K, dim d) of the block in turn per thread, fn(k, d, M, l, acc):
// the warps folded in warp order, a warp that saw no column (max -inf)
// weighing 0. Starts with a block barrier and ends without one. Column
// ``col`` of n-tile n of ``o`` is head dim 8 R (n / R) + R col + n % R:
// 8 n + col for R = 1; fp32 E reads R bytes of V per lane and so holds R
// n-tiles interleaved.
template <int D, int R = 1, class Fn>
__device__ __forceinline__ void merge_warps(float* merge, int K, const float (&m_run)[2],
                                            const float (&l_run)[2], const float (&o)[D / 8][4],
                                            Fn&& fn) {
  constexpr int W = 16 * (D + 2);  // floats per warp: O (16 x D), m, l
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  __syncthreads();  // every ring is drained: the merge goes over them
  float* mw = merge + warp * W;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    if (tq == 0) {
      mw[16 * D + g + 8 * r] = m_run[r];
      mw[16 * D + 16 + g + 8 * r] = l;
    }
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mw[(g + 8 * (e >> 1)) * D + 8 * R * (n / R) + R * (2 * tq + (e & 1)) + n % R] = o[n][e];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < K * D; e += blockDim.x) {
    const int k = e / D, d = e % D;
    float M = -INFINITY, l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) M = fmaxf(M, merge[w * W + 16 * D + k]);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float* mv = merge + w * W;
      const float m = mv[16 * D + k];
      if (m == -INFINITY) continue;  // the warp saw no column (or only -inf logits)
      const float sc = exp_e(m - M);
      l = fmaf(sc, mv[16 * D + 16 + k], l);
      acc = fmaf(sc, mv[k * D + d], acc);
    }
    fn(k, d, M, l, acc);
  }
}

}  // namespace tc
}  // namespace mm
