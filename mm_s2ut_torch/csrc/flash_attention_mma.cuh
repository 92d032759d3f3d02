// The arguments of kernels A, G and H, the launchers of their bf16
// tensor-core versions (flash_attention_mma.cu: A and G;
// flash_attention_bwd_mma.cu: H), and the sm_80+ building blocks those and
// the fp32 versions (flash_attention.cu, flash_attention_bwd.cu) use: 16-byte
// cp.async into XOR-swizzled shared tiles, ldmatrix, mma.sync m16n8k16 (bf16
// in, fp32 accumulate) and mma.sync m16n8k8 (tf32 in, fp32 accumulate) with
// 3xTF32 operand splitting.
//
// Fragment layouts of mma.m16n8k16.row.col (lane = 4 g + tq):
//   A (16 x 16): a0 = (g, 2tq..2tq+1), a1 = (g + 8, 2tq..), a2 = (g, 8 + 2tq..),
//                a3 = (g + 8, 8 + 2tq..), two bf16 each, the lower column low;
//   B (16 x 8):  b0 = (k 2tq..2tq+1, n g), b1 = (k 8 + 2tq.., n g);
//   C (16 x 8):  c0, c1 = (g, 2tq), (g, 2tq + 1); c2, c3 = the same at row g + 8.
// So the C fragments of n-tiles 2j and 2j+1 are, packed to bf16, the A
// fragment of k-step j (acc_to_a): a softmax tile feeds the next product
// straight from registers.
//
// Fragment layouts of mma.m16n8k8.row.col.tf32:
//   A (16 x 8): a0 = (g, tq), a1 = (g + 8, tq), a2 = (g, tq + 4), a3 = (g + 8, tq + 4);
//   B (8 x 8):  b0 = (k tq, n g), b1 = (k tq + 4, n g);
//   C (16 x 8): as m16n8k16's.
// The fp32 kernels give every 8-wide k-step the order 0, 2, 4, 6, 1, 3, 5, 7:
// k-index tq is element 2 tq of the step and tq + 4 is element 2 tq + 1, in
// both operands (a sum over k does not depend on its order). Then a0 and a2
// are one float2 of row g, b0 and b1 one float2 of row n, and the C
// fragment of an 8-wide n-tile is, reordered (c0, c2, c1, c3), the A
// fragment of the next product's k-step over the same 8 columns
// (acc_to_a_f32), with no shuffle.
#pragma once

#include "common.cuh"

namespace mm {

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // (B, S) additive key bias
  void* out;          // (B, T, H, D) contiguous
  int T, S, H;
  int64_t q_sb, q_st, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  float scale;
  int window;  // with a causal mask: keys s > t - window only (0 = unbounded)
  float rate;      // attention dropout rate (0 = none)
  float inv_keep;  // 1 / (1 - rate), rounded to float as JAX's weak typing does
  uint32_t seed;
  uint32_t bh0;   // the dropout hash's row of (b, h) = (0, 0): a data-parallel shard's first row times h_total
  uint32_t h_total;  // the heads of the whole layer (H, or more under tensor parallelism)
  uint32_t h0;       // the global head of local head 0
  float* stat_m;  // (B.H, T) row max, or nullptr
  float* stat_l;  // (B.H, T) row denominator, or nullptr
};

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;    // (B, S) additive key bias
  const void* dout;     // (B, T, H, D) contiguous, q's type
  const float* stat_m;  // (B.H, T) row max of the forward's softmax
  const float* stat_l;  // (B.H, T) row denominator
  float* delta;         // (B.H, T) sum_s P (dP F): written by H-q, read by H-kv
  void* dq;             // (B, T, H, D) contiguous, q's type
  float* dk;            // (B, S, H, D) fp32
  float* dv;            // (B, S, H, D) fp32
  float* dbias;         // (B.H, S) fp32
  int T, S, H;
  int64_t q_sb, q_st, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  float scale;
  int causal;
  int window;
  float rate;
  float inv_keep;
  uint32_t seed;
  uint32_t bh0;  // as FlashArgs::bh0
  uint32_t h_total;  // as FlashArgs::h_total
  uint32_t h0;       // as FlashArgs::h0
};

// The dropout hash's (b, h) coordinate of the block of local head h of
// batch row b: (row0 + b).h_total + h0 + h, with bh0 = row0.h_total. A
// tensor-parallel rank holding heads [h0, h0 + H) of h_total draws the
// whole layer's mask on its heads; (h_total, h0) = (H, 0) gives bh0 + b.H + h.
// Each kernel computes it once, beside b and h.
template <class Args>
__device__ __forceinline__ uint32_t hash_bh(const Args& a, int b, int h) {
  return a.bh0 + static_cast<uint32_t>(b) * a.h_total + a.h0 + static_cast<uint32_t>(h);
}

// Kernel H: outside the causal/window band, where the forward replaced the logit by -1e9.
__device__ __forceinline__ bool masked(const BwdArgs& a, int t, int s) {
  return a.causal && (s > t || (a.window > 0 && s <= t - a.window));
}

// Kernel H: the dropout factor of weight (t, s) of the block whose hash row
// is ``hrow`` (hash_bh), keep / (1 - rate), or 1.
__device__ __forceinline__ float keep_factor(const BwdArgs& a, uint32_t hrow, int t, int s) {
  if (a.rate <= 0.f) return 1.f;
  return hash_keep(hrow, t, s, a.seed, a.rate) ? a.inv_keep : 0.f;
}

// Kernel A (skip = false) or G (skip = true, needs causal) in bf16 on the
// tensor cores; D in {16, 32, 64, 128}. Rows of q, k, v must be 16-byte
// aligned (base and strides multiples of 8).
cudaError_t launch_flash_fwd_mma(const FlashArgs& a, int B, int D, bool causal, bool skip,
                                 cudaStream_t stream);
// The same in fp32, 3xTF32 on the tensor cores (flash_attention.cu); the same rules.
cudaError_t launch_flash_fwd_f32(const FlashArgs& a, int B, int D, bool causal, bool skip,
                                 cudaStream_t stream);
// Kernel H (H-q, then H-kv) in bf16 on the tensor cores; the same rules.
cudaError_t launch_flash_bwd_mma(const BwdArgs& a, int B, int D, cudaStream_t stream);

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // 4 warps, each owning 16 rows of an mma tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; ok = false writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b, one m16n8k16 tile, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulators of n-tiles 2j (c0) and 2j + 1 (c1) as the A fragment of k-step j.
__device__ __forceinline__ void acc_to_a(uint32_t (&f)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  f[0] = pack_bf16(c0[0], c0[1]);
  f[1] = pack_bf16(c0[2], c0[3]);
  f[2] = pack_bf16(c1[0], c1[1]);
  f[3] = pack_bf16(c1[2], c1[3]);
}

// A shared tile holds rows of D bf16 (D / 8 chunks of 16 bytes). Chunk c
// of row r sits at chunk c ^ sw(r), where sw spreads the 8 rows that one
// ldmatrix phase reads over all 32 banks (for D < 64 several rows share a
// 128-byte line, so sw steps every 8 / chunks rows).
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int CH = D / 8;
  constexpr int SPAN = CH < 8 ? CH : 8;
  constexpr int STEP = CH < 8 ? 8 / CH : 1;
  return static_cast<uint32_t>(r * D * 2 + ((c ^ ((r / STEP) % SPAN)) << 4));
}

// Rows [r0, r0 + ROWS) of a bf16 matrix with row stride `stride` (elements)
// into the swizzled tile at `dst`; rows at or past n are zeros.
template <int ROWS, int D>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src, int64_t stride, int r0,
                                          int n) {
  constexpr int CH = D / 8;
  static_assert(ROWS * CH % kThreads == 0, "whole rounds of 16-byte copies");
#pragma unroll
  for (int it = 0; it < ROWS * CH / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < n;
    cp_async16(dst + swz<D>(r, c), src + (int64_t)(ok ? r0 + r : 0) * stride + c * 8, ok);
  }
}

// Elements [i0, i0 + N) of a float vector into shared `dst`; past n zeros.
template <int N>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int i0, int n) {
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const bool ok = i0 + i < n;
    cp_async4(smem_u32(dst + i), src + (ok ? i0 + i : 0), ok);
  }
}

// A fragment: rows r0..r0+15 of a tile, k = head dims 16 kk..16 kk+15.
template <int D>
__device__ __forceinline__ void frag_a(uint32_t (&f)[4], uint32_t tile, int r0, int kk) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(f, tile + swz<D>(r0 + (lane & 15), 2 * kk + (lane >> 4)));
}

// The A fragment of k-step kk of a warp's 16 resident rows (r0..): the
// copy held in registers (REGS), or read from the tile again (at D = 128,
// where holding them would spill).
template <int D, bool REGS>
__device__ __forceinline__ void resident(uint32_t (&f)[4], const uint32_t (&held)[4],
                                         uint32_t tile, int r0, int kk) {
  if (REGS) {
    f[0] = held[0];
    f[1] = held[1];
    f[2] = held[2];
    f[3] = held[3];
  } else {
    frag_a<D>(f, tile, r0, kk);
  }
}

// B fragments with n = tile rows r0..r0+15 and k = head dims 16 kk..:
// {b0, b1} of n-tile r0..r0+7, then of r0+8..r0+15 (Q.K^T reads K so).
template <int D>
__device__ __forceinline__ void frag_b(uint32_t (&f)[4], uint32_t tile, int r0, int kk) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(f, tile + swz<D>(r0 + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1)));
}

// B fragments with k = tile rows r0..r0+15 and n = head dims 16 dp..16 dp+15
// (P.V reads V so): {b0, b1} of n-tile 2 dp, then of 2 dp + 1.
template <int D>
__device__ __forceinline__ void frag_bt(uint32_t (&f)[4], uint32_t tile, int r0, int dp) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(f, tile + swz<D>(r0 + (lane & 7) + (((lane >> 3) & 1) << 3), 2 * dp + (lane >> 4)));
}

// e^x as exp2f(x . log2 e): the ex2 unit and one multiply, fewer
// instructions than expf's range reduction, a few ulp apart from it.
__device__ __forceinline__ float exp_e(float x) { return exp2f(x * 1.4426950408889634f); }

// Sum over the 4 lanes of a quad (the lanes that share an accumulator row).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// ---------------------------------------------------------------- fp32: 3xTF32
//
// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact), tf32
// rounding to nearest with ties away from zero on the 13 dropped mantissa
// bits, as cvt.rna.tf32.f32 rounds (the low 13 bits are left zero). A
// product is lo.hi + hi.lo + hi.hi, each an mma with fp32 accumulation; the
// dropped lo.lo term and lo's own rounding leave ~2^-21 of |a.b|, where one
// tf32 product leaves ~2^-11.

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a . b, one m16n8k8 tile, tf32 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An operand fragment split into its tf32 halves.
struct FragA32 {
  uint32_t hi[4], lo[4];
};
struct FragB32 {
  uint32_t hi[2], lo[2];
};

// c += a . b in 3xTF32: the two cross terms first, then hi . hi, all
// accumulated in the tensor cores. Their accumulation is coarser than an
// fp32 rounded add, so a long sum (P.V over hundreds of keys) drifts:
// at B = 8, T = 499 A's rms error against float64 is 2.7e-7, 7x the FMA
// kernel's it replaced; summing each k-step from zero and adding it with a
// rounded fp32 add took it to 1.9e-8 but A 53% longer (H100, PERF.md).
__device__ __forceinline__ void mma3(float (&c)[4], const FragA32& a, const FragB32& b) {
  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// fp32 tiles live in shared memory twice. cp.async lands the rows as they
// are (a raw tile, row stride D floats); split_tile then writes each element
// as a {hi, lo} float2 into a split tile, once per block for all its warps,
// so that a fragment read is a load and nothing else. In a split tile the
// 16-byte chunk m = e / 2 of row r (elements 2m and 2m + 1, each {hi, lo})
// sits at chunk m ^ hs(r), hs(r) = 4 (r & 1) ^ 2 ((r >> 1) & 3), row stride
// 2 D floats: the 16-byte reads of frag_a32 / frag_b32 (rows g, g + 1 and
// chunks 4 kk + tq in a quarter-warp) and the 8-byte reads of frag_bt32
// (rows 2 tq or 2 tq + 1, elements g in a half-warp) each fall on 32
// distinct banks. Returns the word offset of element (r, e)'s hi.
template <int D>
__device__ __forceinline__ int sswz(int r, int e) {
  const int h = ((r & 1) << 2) ^ (((r >> 1) & 3) << 1);
  return r * 2 * D + (((e >> 1) ^ h) << 2) + ((e & 1) << 1);
}

// Rows [r0, r0 + ROWS) of an fp32 matrix with row stride `stride` (elements)
// into the raw tile at `dst` (row stride D); rows at or past n are zeros.
template <int ROWS, int D>
__device__ __forceinline__ void load_raw(float* dst, const float* src, int64_t stride, int r0,
                                         int n) {
  constexpr int CH = D / 4;
  static_assert(ROWS * CH % kThreads == 0, "whole rounds of 16-byte copies");
#pragma unroll
  for (int it = 0; it < ROWS * CH / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < n;
    cp_async16(smem_u32(dst + r * D + 4 * c), src + (int64_t)(ok ? r0 + r : 0) * stride + 4 * c,
               ok);
  }
}

// The raw tile `raw` (ROWS x D) split into the split tile `dst`; each thread
// takes whole 16-byte chunks. The caller synchronises before and after.
template <int ROWS, int D>
__device__ __forceinline__ void split_tile(float* dst, const float* raw) {
  constexpr int CH = D / 4;
  static_assert(ROWS * CH % kThreads == 0, "whole rounds of chunks");
#pragma unroll
  for (int it = 0; it < ROWS * CH / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / CH, c = i % CH;
    const float4 x = *reinterpret_cast<const float4*>(raw + r * D + 4 * c);
    uint4 a, b;
    split_tf32(x.x, a.x, a.y);
    split_tf32(x.y, a.z, a.w);
    split_tf32(x.z, b.x, b.y);
    split_tf32(x.w, b.z, b.w);
    *reinterpret_cast<uint4*>(dst + sswz<D>(r, 4 * c)) = a;
    *reinterpret_cast<uint4*>(dst + sswz<D>(r, 4 * c + 2)) = b;
  }
}

// A fragment: rows r0..r0+15 of a split tile, k = head dims 8 kk..8 kk+7.
template <int D>
__device__ __forceinline__ void frag_a32(FragA32& f, const float* tile, int r0, int kk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const uint4 x0 = *reinterpret_cast<const uint4*>(tile + sswz<D>(r0 + g, 8 * kk + 2 * tq));
  const uint4 x1 = *reinterpret_cast<const uint4*>(tile + sswz<D>(r0 + g + 8, 8 * kk + 2 * tq));
  f.hi[0] = x0.x, f.lo[0] = x0.y, f.hi[2] = x0.z, f.lo[2] = x0.w;
  f.hi[1] = x1.x, f.lo[1] = x1.y, f.hi[3] = x1.z, f.lo[3] = x1.w;
}

// The same from a raw tile, split here (a block's resident rows, once).
template <int D>
__device__ __forceinline__ void frag_a32_raw(FragA32& f, const float* raw, int r0, int kk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const float2 x0 = *reinterpret_cast<const float2*>(raw + (r0 + g) * D + 8 * kk + 2 * tq);
  const float2 x1 = *reinterpret_cast<const float2*>(raw + (r0 + g + 8) * D + 8 * kk + 2 * tq);
  split_tf32(x0.x, f.hi[0], f.lo[0]);
  split_tf32(x1.x, f.hi[1], f.lo[1]);
  split_tf32(x0.y, f.hi[2], f.lo[2]);
  split_tf32(x1.y, f.hi[3], f.lo[3]);
}

// B fragment with n = rows n0..n0+7 of a split tile and k = head dims
// 8 kk..8 kk+7 (Q.K^T reads K so).
template <int D>
__device__ __forceinline__ void frag_b32(FragB32& f, const float* tile, int n0, int kk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const uint4 x = *reinterpret_cast<const uint4*>(tile + sswz<D>(n0 + g, 8 * kk + 2 * tq));
  f.hi[0] = x.x, f.lo[0] = x.y, f.hi[1] = x.z, f.lo[1] = x.w;
}

// B fragment with k = rows k0..k0+7 of a split tile in the k-step order
// above and n = head dims 8 dn..8 dn+7 (P.V reads V so).
template <int D>
__device__ __forceinline__ void frag_bt32(FragB32& f, const float* tile, int k0, int dn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const uint2 x0 = *reinterpret_cast<const uint2*>(tile + sswz<D>(k0 + 2 * tq, 8 * dn + g));
  const uint2 x1 = *reinterpret_cast<const uint2*>(tile + sswz<D>(k0 + 2 * tq + 1, 8 * dn + g));
  f.hi[0] = x0.x, f.lo[0] = x0.y, f.hi[1] = x1.x, f.lo[1] = x1.y;
}

// The accumulators of an n-tile over 8 columns as the A fragment of a
// k-step over those columns, in the k-step order above: split into tf32
// halves like any operand (not rounded to a narrower type first).
__device__ __forceinline__ void acc_to_a32(FragA32& f, const float (&c)[4]) {
  split_tf32(c[0], f.hi[0], f.lo[0]);
  split_tf32(c[2], f.hi[1], f.lo[1]);
  split_tf32(c[1], f.hi[2], f.lo[2]);
  split_tf32(c[3], f.hi[3], f.lo[3]);
}

// Raise a kernel's dynamic shared memory limit where it passes the 48 KB default.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// allow_smem, and the carveout that gives shared memory all it can, so that
// two of the fp32 kernels' blocks of up to ~113 KB sit on one SM.
template <typename K>
cudaError_t allow_smem_max(K kernel, int bytes) {
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace tc
}  // namespace mm
