// Kernels D, E and F — beam-decode attention of the unit decoder over the
// quantized decode caches (GenerationConfig.kv_cache_dtype int8 / int4).
//
// Kernel D replaces the Pallas TPU kernel
// mm_s2ut/ops/decode_attention.py:_kernel_i8 (pallas_call at :173, launched
// by ancestry_decode_attention_i8, reached from models/decoder.py:349-357):
// kernel B's ancestry self-attention over an int8 K||V cache with per-column,
// per-head dequant scales sk/sv. It reproduces the reference's quantization,
// not only its dequantized math:
//   q8 = round(q / qs), qs = max|q|/127 + 1e-20 (per beam row);
//   score_j = float(sum q8.k8_j) . qs . sk_j (an exact int32 contraction);
//   softmax over the on-path columns plus the full-precision self logit q.k_new;
//   w_eff_j = p_j/denom . sv_j; ws = max_j w_eff_j / 127 + 1e-20 (the max over
//   the WHOLE row); w8_j = round(w_eff_j / ws);
//   out = float(sum w8.v8) . ws + p_self/denom . v_new.
// Rounding is half to even (rintf) and every division is IEEE (the build has
// no --use_fast_math), as jnp.round and XLA's division are.
//
// Kernel F replaces mm_s2ut/ops/decode_attention.py:_kernel_i4 (pallas_call at
// :367, launched by ancestry_decode_attention_i4, reached from
// models/decoder.py:340-348): D over the half-split nibble-packed int4 cache.
// Logical column j lives in byte row j mod P, P = TS/2 of the current
// segment: the low nibble if j < P, the high one otherwise, sign-extended.
// flat_rep, sk and sv use logical column ids, so F is D's math with another
// load.
//
// Kernel E replaces mm_s2ut/ops/decode_attention.py:_kernel_cross_i8
// (pallas_call at :577, launched by cross_decode_attention_i8, reached from
// models/layers.py:201-202): kernel C over an int8 encoder slab. k8 converts
// exactly to bf16 or float, the scores are (q.k8).sk + bias, the softmax
// weights are (p/sum).sv, and out = sum w.v8.
//
// What bounds them on the card: like B and C, bytes and latency, not
// arithmetic (K <= 16 queries per head against a 2.Dh-byte row per column).
// The int8 cache halves B's bytes. The int4 cache halves them again only
// where a column's partner (j + P or j - P) is live too: the two share every
// byte of their packed row, so a live column costs its whole 2.Dh-byte
// packed row unless its partner is read in the same pass.
//
// Design of D, B's split over blocks (decode_attention.cu) with integer
// tensor-core products. Grid (B.H, n_split) (with variant 3 two batch rows
// per block), n_split picked for about four blocks per SM (several at the
// flagship's B = 8, 1 at B = 128), the split boundaries whole steps (K
// columns). The per-row requant scale ws needs the finished softmax of
// the whole row, before any w8 exists, which no one-pass online softmax
// across blocks gives; so D runs two passes, each split over blocks,
// through fp32 scratch:
//  1. the score pass compacts its span's live columns (compact_live, all K
//     loads of a column in flight), then each of its 4 warps gathers its
//     own tiles of 32 live K8 halves (16-byte cp.async, 2-stage ring) and
//     computes s32 = q8.k8 on mma.m16n8k32 s8 with the beams as the 16 rows
//     (q8 as A fragments, K8 rows as the k-contiguous B operand): exact, the
//     reference's s32 bit for bit; score = (s32 . qs) . sk (__fmul_rn, the
//     reference's order). A beam has at most one on-path column among the
//     K slots of a step (UnitDecoder.step's flat_rep), so each on-path
//     score goes to scratch at (beam, step) with its column's sv, 2.K.T
//     floats per (b, h) (in global memory: K.T floats of shared memory
//     would be 150 KB at the 3000-position clamp); the split's
//     (max, sum of exp) per beam are then taken from the stored scores,
//     not by an online softmax per tile, whose exp of every (beam, column)
//     element (most of them off-path) cost more than the tile's products.
//     The head-0 block of each (b, split) also leaves its live columns in
//     scratch: every head of b has the same ones;
//  2. the output pass reads that list in place of compacting again, puts
//     its first V tile in flight, folds the splits' (max, sum) in a fixed
//     order, with the self term, into m and den, takes ws from the row's
//     scores and sv in scratch with the reference's expression (the block's
//     threads over the steps, independent loads), and forms the w8 of each
//     of its span's (beam, step) once, into a shared table (one byte each,
//     <= kBSpan). It gathers the live V8 halves, transposes each tile's bytes
//     into dim-major rows (__byte_perm on 4 x 4 blocks: sm_90's ldmatrix
//     .trans is 16-bit only) in an order that makes the score
//     accumulators' layout the s8 A fragment, reads each element's w8 from
//     the table, and adds w8.v8 in int32 on the s8 tensor cores. Integer
//     sums merge exactly in any order: the warps' in shared memory, the
//     splits' in a small merge kernel (one split writes the output
//     directly), then out = float(sum) . ws + (p_self / den) . v_new.
// No atomics: two launches give the same bits. At step 0 no column is on
// a path and the output is exactly v_new. fp32 and bf16 q take the same
// kernels (q is quantized to int8 either way). The cache and both scale
// arrays are read through their strides (the beam search passes prefix
// views of one allocation), q, k_new, v_new and the output through theirs
// (the decoder's beam-major views). Variants for tools/kernel_ab.py, all
// the same bits (the same integers from the same w8): 1 the output product
// on bf16 mma over exactly converted int8 (each 32-column tile's fp32 sums,
// <= 32 . 127^2 < 2^24, turned to int32), 2 both products so (|s32| <=
// 128 . 127^2 < 2^24), 3 two batch rows per block.
//
// Design of F: D's two passes, the same template instances' code, with the
// load (template argument LOAD) changed: the gather takes live column j's
// half from packed row j mod P (16-byte cp.async as D), and the lanes turn
// the packed words into the columns' int8 values (the low or high nibbles,
// sign-extended, four bytes at a time by __vsub4) as they read them: the
// score pass in its s8 fragment loads, the output pass in its byte
// transpose, each lane knowing which of its rows hold high columns (a
// separate unpack pass in shared memory cost 8% more at B = 128). From
// there the s8 products, the scratch, the w8 table and the
// integer merge are D's, so F's output equals D's on i4_unpack of the same
// cache bit for bit. The scores moved to global scratch with D's design, so
// F has no ceiling in K.T (its former one-block-per-(b, h) design kept K.T
// scores in shared memory and refused beam 16 from T ~ 2850). Variants for
// tools/kernel_ab.py, all v0's bits: 1 the unpack one byte at a time through
// int32 shifts (the reference's unpack); 2 D's variant 2 (both products on
// bf16 mma over exactly converted values) on F's gather; 3 the gather by
// packed row: the splits cut the P packed rows, a row whose low or high
// column is live is read once, both nibbles unpacked and both columns run
// through the products, the dead one's bits masked (the scores start as
// -inf in a fill kernel, since a step may straddle two splits' rows; a
// stats kernel then takes the softmax partials over D's split of the steps,
// so that every float is formed as in v0).
//
// Design of E, kernel C's tensor-core split (decode_attention.cu) over the
// int8 slab, in both dtypes. Grid (B.H, n_split, ceil(K/16)); each group of
// <= 16 rows (the beams of a decode step, or 16 of the prefill's P rows)
// are the 16 mma rows; the S columns are cut into n_split spans of whole
// key tiles where B.H.groups is under a wave (one tile per split for a
// 501-row prefill would pay a merge for nothing); 4 warps per block, each
// with its own 2-stage cp.async ring of raw int8 K||V rows (padded, so
// that the 8 keys of a fragment load hit distinct banks) and their sk, sv
// and bias, and its own online softmax: s = (q.k8) . sk + bias (the
// reference's order, -inf past S), l += p, O += (p . sv).V (sv folded into
// each unnormalised weight, as the reference folds it into the normalised
// one). The warps merge in shared memory, the splits in a merge kernel in
// split order (a span that saw only -inf keeps max -inf and weighs 0; a
// span of -1e9 padding keeps a finite max that exp(-1e9 - M) wipes). q and
// the output go through strides.
// bf16: mma.m16n8k16; K's B fragments converted to bf16 (exact: |x| <=
// 127) as they are read from the raw rows, V's rows into the warp's bf16
// tile in C's swizzled layout, which P.V reads through ldmatrix .trans as
// C does (a bf16 K tile as well cost a fifth block's worth of shared
// memory: three blocks per SM, not four); the weights p . sv rounded to
// bf16 (both sides round each weight to a few bf16 ulps of a convex mix,
// inside the card checks' 2e-2).
// fp32 (one TF32 pass would miss the 1e-4 tolerance): fp32 C's m16n8k8
// products with two passes, not three, since every int8 value is exact in
// tf32 (lo(k8) = lo(v8) = 0): lo(q).k8 + hi(q).k8, lo(P).v8 + hi(P).v8,
// 3xTF32's bits. q is split once per block (in registers for Dh <= 64), P
// = p . sv from the S accumulators. K and V are read straight from the raw
// rows, a word of 4 consecutive dims of one key per lane: K's word serves
// the two k-steps of a 16-dim chunk (dims 4tq, 4tq + 1, then 4tq + 2,
// 4tq + 3; q's fragments read the same way), V's word 4 n-tiles at once
// (n-tile 4j + i holds dims 32j + 4col + i), so no tile is converted or
// transposed in shared memory.
// Variant 1 (bf16; tools/kernel_ab.py; the port of
// scripts_dev/cross_block_probe.py): two batch rows per block, in turn;
// v0's bits at the same split count. The bf16 split kernel, without scales
// or bias, reads a dense int8 slab or its values nibble-packed
// (mm_dense_attention_probe, the port of scripts_dev/int4_support_probe.py's
// _attnish timing).
#include "decode_attention.cuh"

namespace mm {
namespace {

using namespace tc;

// ------------------------------------------------------------ kernels D and F

constexpr int kDThreads = 128;   // 4 warps, each with its own tiles
constexpr int kDTile = 32;       // live columns per warp tile: one k-step of the s8 output product
constexpr int kDMaxSplits = 64;

// The load of D's passes: D's int8 rows; F's nibble-packed rows unpacked
// byte-parallel (kI4) or through int32 shifts (kI4Wide); or F's gather by
// packed row (kI4Pair).
enum Load : int { kI8 = 0, kI4 = 1, kI4Wide = 2, kI4Pair = 3 };

struct I8Args {
  const void* q;       // (B, H, K, Dh) through strides, pre-scaled
  const void* k_new;   // (B, H, K, Dh) through strides
  const void* v_new;   // (B, H, K, Dh) through strides
  int64_t q_sb, q_sh, q_sk, kn_sb, kn_sh, kn_sk, vn_sb, vn_sh, vn_sk;
  const int8_t* kv;    // (B, L, H, TS or P, 2.Dh) through strides, rows 16-byte aligned
  int64_t kv_sb, kv_sl, kv_sh, kv_sj;
  const float* sk;     // (B, L, H, TS) through strides, last dim dense
  int64_t sk_sb, sk_sl, sk_sh;
  const float* sv;     // (B, L, H, TS) through strides, last dim dense
  int64_t sv_sb, sv_sl, sv_sh;
  const int* flat_rep; // (B, K, TS) contiguous
  void* out;           // (B, H, K, Dh) through strides
  int64_t o_sb, o_sh, o_sk;
  float* sc;           // (B.H, K, T) each beam's on-path score at step t, -inf if none
  float* svs;          // (B.H, K, T) its column's sv
  int* live_g;         // (B, n_split, lstride) each split's live column count, then the
                       // columns (compact_live's format; kI4Pair: then the high beams),
                       // from the score pass's head-0 blocks
  float* part_m;       // (B.H, n_split, K) each split's score max, -inf if it saw none
  float* part_l;       // (B.H, n_split, K) its sum of exp(score - max)
  int* part_acc;       // (B.H, n_split, K, Dh) its sum of w8.v8 (n_split > 1)
  float* row_st;       // (B.H, K, 2) ws and p_self / den of each row (n_split > 1)
  int H, K, TS, T, layer, n_split, span, rpb;  // span: columns (kI4Pair: packed rows) per
                                               // split, D and F a multiple of K; rpb: batch
                                               // rows per block
  int n_stat, stat_span;  // the splits of the softmax partials (part_m, part_l): D's, F's
                          // v0-v2: n_split and span; kI4Pair: D's split of the steps
  int P;               // F: packed rows of the segment, TS / 2
  int lstride;         // ints per (b, split) of live_g
};

// Shared memory of D's passes. A staged K (or V) half row is padded to
// kRow bytes, so that the 8 rows of one 32-bit fragment load hit distinct
// banks; a stage holds kDTile such rows and, in the score pass, their
// kDTile sk and sv (PAIR: both columns'). The V tile is transposed into
// kTRow-byte rows, one per head dim. The block's int32 merge of pass 2
// goes over the drained rings; its w8 table (K.nt <= kBSpan bytes) follows
// the compaction's counts. PAIR adds each warp's tile of high columns and
// the live rows' high beams.
template <int DH, bool PAIR = false>
struct DSh {
  static constexpr int kRow = (DH < 32 ? 32 : DH) + 16;
  static constexpr int kTRow = kDTile + 16;
  static constexpr int kStage = kDTile * kRow + (PAIR ? 4 : 2) * kDTile * 4;
  static constexpr int kRing = 0;                        // 4 warps x 2 stages
  static constexpr int kHi = kRing + 4 * 2 * kStage;     // PAIR: 4 warps x kDTile x kRow
  static constexpr int kVt = kHi + (PAIR ? 4 * kDTile * kRow : 0);  // 4 warps x DH x kTRow
  static constexpr int kQ = kVt + 4 * DH * kTRow;        // q8, 16 rows x kRow
  static constexpr int kRowSt = kQ + 16 * kRow;          // per-row values: 160 floats
  static constexpr int kLive = kRowSt + 160 * 4;
  static constexpr int kLiveHi = kLive + kBSpan * 4;     // PAIR: kBSpan / 2 uint16
  static constexpr int kCount = kLiveHi + (PAIR ? kBSpan : 0);
  static constexpr int kW8 = kCount + 4 * 4 * 4;
  static constexpr int kBytes = kW8 + kBSpan;
  static_assert(4 * 16 * DH * 4 <= kVt - kRing, "the merge fits over the rings");
  static_assert(kStage % 16 == 0 && kHi % 16 == 0 && kVt % 16 == 0 && kQ % 16 == 0,
                "16-byte aligned tiles");
};

// Column c = 8a + 2t + e (a < 4, t < 4, e < 2) of a 32-column tile sits at
// byte pi(c) of a transposed V row. With this order the s8 A fragment of
// the requantized weights is the score accumulators' own elements (lane
// (g, t) holds columns 8a + 2t + e of rows g and g + 8), and the B
// fragments are aligned 32-bit loads.
__device__ __forceinline__ int d_pi(int c) {
  const int a = c >> 3, t = (c >> 1) & 3;
  return 16 * (a >> 1) + 4 * t + 2 * (a & 1) + (c & 1);
}

// The live tile i of a split: each live column's DH-byte K (half = 0) or V
// (half = 1) half (F: of its packed row), and its ``scale`` and ``scale2``
// where given (kI4Pair: the row's low and high columns'), into the warp's
// stage; rows past n_live zeros.
template <int DH, int LOAD>
__device__ __forceinline__ void d_gather(uint32_t dst, const int8_t* slab, int64_t sj, int P,
                                         const float* scale, const float* scale2,
                                         const uint32_t* live, int c0, int n_live, int i,
                                         int half) {
  constexpr bool PAIR = LOAD == kI4Pair;
  using C = DSh<DH, PAIR>;
  constexpr int CH = DH / 16, NS = PAIR ? 2 : 1;
  const int lane = threadIdx.x & 31;
  const int r0 = i * kDTile, n = min(kDTile, n_live - r0);
  for (int e = lane; e < kDTile * CH; e += 32) {
    const int r = e / CH, c = e % CH;
    const bool ok = r < n;
    int row = c0 + (ok ? (int)(live[r0 + r] & 0xFFFFu) : 0);
    if (LOAD == kI4 || LOAD == kI4Wide) row -= row >= P ? P : 0;  // the column's packed row
    cp_async16(dst + r * C::kRow + c * 16, slab + (int64_t)row * sj + half * DH + c * 16, ok);
  }
  const bool ok = lane < n;
  const int col = c0 + (ok ? (int)(live[r0 + lane] & 0xFFFFu) : 0);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (scale) cp_async4(dst + kDTile * C::kRow + (s * kDTile + lane) * 4, scale + col + s * P, ok);
    if (scale2)
      cp_async4(dst + kDTile * C::kRow + ((NS + s) * kDTile + lane) * 4, scale2 + col + s * P, ok);
  }
}

// F: bit i of the result is set where row r0 + rows[i] of the live list
// (a staged row of the tile) holds a high (j >= P) column.
template <int N>
__device__ __forceinline__ uint32_t d_high(const uint32_t* live, int r0, int n_in, int c0, int P,
                                           const int (&rows)[N]) {
  uint32_t hi = 0;
#pragma unroll
  for (int i = 0; i < N; ++i)
    hi |= (uint32_t)(rows[i] < n_in && c0 + (int)(live[r0 + rows[i]] & 0xFFFFu) >= P) << i;
  return hi;
}

// kI4Pair: the high columns of the n_in staged packed rows to ``hi``, the
// low ones in place.
template <int DH>
__device__ __forceinline__ void d_unpack_pair(unsigned char* tile, unsigned char* hi, int n_in) {
  constexpr int W = DH / 4;
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < n_in * W; e += 32) {
    const int off = (e / W) * DSh<DH, true>::kRow + 4 * (e % W);
    const uint32_t w = *reinterpret_cast<const uint32_t*>(tile + off);
    *reinterpret_cast<uint32_t*>(hi + off) = nibbles(w, true);
    *reinterpret_cast<uint32_t*>(tile + off) = nibbles(w, false);
  }
}

// s32 = q8.k8 of a staged 32-column tile: s32[n][e] is beam g + 8 (e >> 1),
// tile column 8 n + 2 tq + (e & 1). SC8: on the s8 tensor cores, else on
// bf16 ones over exactly converted operands (|s| <= 128 . 127^2 < 2^24).
// F (LOAD kI4, kI4Wide): the staged rows are packed bytes, unpacked here
// as the fragments are loaded, row 8 n + g's high nibbles where bit n of hi
// is set.
template <int DH, bool SC8, int KS, int LOAD = kI8>
__device__ __forceinline__ void d_s32(int (&s32)[4][4], const uint32_t (&qf)[KS][4],
                                      const unsigned char* kt, int g, int tq, uint32_t hi = 0) {
  constexpr int kRow = DSh<DH>::kRow;
  constexpr bool F = LOAD == kI4 || LOAD == kI4Wide;
  auto ld = [&](const unsigned char* at, bool high) {  // a fragment's 32 (SC8) or 16 bits
    const uint32_t w = SC8 ? *reinterpret_cast<const uint32_t*>(at)
                           : (uint32_t)*reinterpret_cast<const uint16_t*>(at);
    return F ? nibbles<LOAD == kI4Wide>(w, high) : w;
  };
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const unsigned char* krow = kt + (8 * n + g) * kRow;
    const bool high = (hi >> n) & 1u;
    if constexpr (SC8) {
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int o = 32 * kk + 4 * tq;
        mma_s8(acc, qf[kk], ld(krow + o, high), DH >= 32 ? ld(krow + o + 16, high) : 0u);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s32[n][e] = acc[e];
    } else {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int o = 16 * kk + 2 * tq;
        mma(acc, qf[kk], i8x2_bf16x2(ld(krow + o, high)), i8x2_bf16x2(ld(krow + o + 8, high)));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s32[n][e] = (int)acc[e];
    }
  }
}

// A V tile's bytes (kRow-byte rows) transposed into vt: 4 x 4 byte blocks,
// column c of dim d to vt[d][pi(c)]. A lane's blocks are all in rows
// 4 (lane & 7).. + 3; F (LOAD kI4, kI4Wide) unpacks their bytes as it
// reads them, row 4 (lane & 7) + i's high nibbles where bit i of hi4 is set.
template <int DH, int LOAD = kI8>
__device__ __forceinline__ void d_transpose(unsigned char* vt, const unsigned char* vr,
                                            uint32_t hi4 = 0) {
  constexpr int kRow = DSh<DH>::kRow, kTRow = DSh<DH>::kTRow;
  constexpr bool F = LOAD == kI4 || LOAD == kI4Wide;
  const int lane = threadIdx.x & 31;
  auto ld = [&](const unsigned char* at, int i) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(at);
    return F ? nibbles<LOAD == kI4Wide>(w, (hi4 >> i) & 1u) : w;
  };
  for (int u = lane; u < 2 * DH; u += 32) {
    const int rb4 = u & 7, db = u >> 3;  // columns 4 rb4.., dims 4 db..
    const unsigned char* src = vr + 4 * rb4 * kRow + 4 * db;
    const uint32_t w0 = ld(src, 0), w1 = ld(src + kRow, 1), w2 = ld(src + 2 * kRow, 2),
                   w3 = ld(src + 3 * kRow, 3);
    const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), hi01 = __byte_perm(w0, w1, 0x7362);
    const uint32_t lo23 = __byte_perm(w2, w3, 0x5140), hi23 = __byte_perm(w2, w3, 0x7362);
    const uint32_t col4[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                              __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
    const int p0 = d_pi(4 * rb4);  // columns 4 rb4, +1 at p0, p0 + 1; +2, +3 at p0 + 4, p0 + 5
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      unsigned char* dst = vt + (4 * db + e) * kTRow + p0;
      *reinterpret_cast<uint16_t*>(dst) = (uint16_t)(col4[e] & 0xFFFFu);
      *reinterpret_cast<uint16_t*>(dst + 4) = (uint16_t)(col4[e] >> 16);
    }
  }
}

// acc += w8.v8 over a transposed tile: on the s8 tensor cores (OUT8), or on
// bf16 ones over exactly converted operands, each 32-column tile's fp32
// sums turned to int32 (exact: <= 32 . 127^2 < 2^24).
template <int DH, bool OUT8>
__device__ __forceinline__ void d_wv(int (&acc)[DH / 8][4], const int (&w8)[4][4],
                                     const unsigned char* vt, int g, int tq) {
  constexpr int NT = DH / 8, kTRow = DSh<DH>::kTRow;
  if constexpr (OUT8) {
    // A (16 beams x 32 columns in pi order): reg 0 = row g, columns
    // 2tq, 2tq+1, 8+2tq, 9+2tq (n-tiles 0, 1); reg 2 the same of n-tiles 2, 3.
    const uint32_t wa[4] = {pack_i8x4(w8[0][0], w8[0][1], w8[1][0], w8[1][1]),
                            pack_i8x4(w8[0][2], w8[0][3], w8[1][2], w8[1][3]),
                            pack_i8x4(w8[2][0], w8[2][1], w8[3][0], w8[3][1]),
                            pack_i8x4(w8[2][2], w8[2][3], w8[3][2], w8[3][3])};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const unsigned char* vrow = vt + (8 * n + g) * kTRow + 4 * tq;
      mma_s8(acc[n], wa, *reinterpret_cast<const uint32_t*>(vrow),
             *reinterpret_cast<const uint32_t*>(vrow + 16));
    }
  } else {
    float f[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) f[n][0] = f[n][1] = f[n][2] = f[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const float c0f[4] = {(float)w8[2 * kk][0], (float)w8[2 * kk][1], (float)w8[2 * kk][2],
                            (float)w8[2 * kk][3]};
      const float c1f[4] = {(float)w8[2 * kk + 1][0], (float)w8[2 * kk + 1][1],
                            (float)w8[2 * kk + 1][2], (float)w8[2 * kk + 1][3]};
      uint32_t wa[4];
      acc_to_a(wa, c0f, c1f);  // exact: |w8| <= 127
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        // columns 16 kk + 2tq, +1 at pi = 16 kk + 4tq, +1; 16 kk + 8 + 2tq, +1 at +2, +3
        const uint32_t v = *reinterpret_cast<const uint32_t*>(vt + (8 * n + g) * kTRow +
                                                              16 * kk + 4 * tq);
        mma(f[n], wa, i8x2_bf16x2(v & 0xFFFFu), i8x2_bf16x2(v >> 16));
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += (int)f[n][e];
  }
}

// A split's softmax partials: one warp per beam (beams warp, warp + 4, ...
// together, so that their loads overlap) takes the max and the sum of exp
// of the beam's stored scores at steps [t0, t0 + nt), lanes over the steps
// in a fixed order; a beam with no score there keeps max -inf.
__device__ __forceinline__ void d_split_stats(const I8Args& a, const float* sc, int64_t bh,
                                              int split, int t0, int nt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, K = a.K;
  float mk[4], lk[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mk[kk] = -INFINITY, lk[kk] = 0.f;
  for (int t = lane; t < nt; t += 32) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (warp + 4 * kk < K) mk[kk] = fmaxf(mk[kk], sc[(warp + 4 * kk) * a.T + t0 + t]);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mk[kk] = warp_max(mk[kk]);
  for (int t = lane; t < nt; t += 32) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // mk -inf: no column of the split on this beam's path
      if (warp + 4 * kk < K && mk[kk] != -INFINITY)
        lk[kk] += expf(sc[(warp + 4 * kk) * a.T + t0 + t] - mk[kk]);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int k = warp + 4 * kk;
    const float l = warp_sum(lk[kk]);
    if (k < K && lane == 0) {
      a.part_m[(bh * a.n_stat + split) * K + k] = mk[kk];
      a.part_l[(bh * a.n_stat + split) * K + k] = l;
    }
  }
}

// kI4Pair: D's softmax partials over D's split of the steps, once every
// score is stored (grid (B.H, n_stat)), so that the output pass folds the
// same floats in the same order as D's and v0's bits follow.
__global__ void __launch_bounds__(kDThreads) ancestry_q_stats_kernel(const I8Args a) {
  const int64_t bh = blockIdx.x;
  const int c0 = blockIdx.y * a.stat_span, c1 = min(a.TS, c0 + a.stat_span);
  d_split_stats(a, a.sc + bh * a.K * a.T, bh, blockIdx.y, c0 / a.K, (c1 - c0) / a.K);
}

// Pass 1: block (batch row group x head, split). Per batch row: q quantized
// (q8 = rint(q / qs), qs = max|q| / 127 + 1e-20) into shared memory, the
// split's score entries set to -inf, its live columns compacted (and, in
// the head-0 block, left in scratch for pass 2); then warp w takes live
// tiles w, w + 4, ...: s32 = q8.k8 (F: the packed bytes unpacked as loaded)
// with the K beams as mma rows, score = (s32 . qs) . sk in fp32, each
// on-path (beam, column) score and sv stored to scratch at (beam, step).
// Last (not kI4Pair, whose stats kernel follows), the split's softmax
// partials (d_split_stats).
//
// PROBE (not 0 only in mm_ancestry_decode_fixed_work, whose output is not
// valid) leaves parts of both passes out: 1 the tiles, 2 the compaction, 4
// the ws and the w8 table.
template <typename T, int DH, bool SC8, int LOAD, int PROBE = 0>
__global__ void __launch_bounds__(kDThreads, 4) ancestry_q_score_kernel(const I8Args a) {
  constexpr bool PAIR = LOAD == kI4Pair;
  constexpr int NH = PAIR ? 2 : 1;  // columns per staged row
  using C = DSh<DH, PAIR>;
  extern __shared__ __align__(128) unsigned char d_smem[];
  uint32_t* live = reinterpret_cast<uint32_t*>(d_smem + C::kLive);
  uint16_t* live_hi = reinterpret_cast<uint16_t*>(d_smem + C::kLiveHi);
  float* qs_sm = reinterpret_cast<float*>(d_smem + C::kRowSt);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int K = a.K, h = blockIdx.x % a.H, split = blockIdx.y;
  const int c0 = split * a.span, c1 = min(PAIR ? a.P : a.TS, c0 + a.span);
  const int t0 = c0 / K, nt = (c1 - c0) / K;  // D, F: the split's whole steps
  const uint32_t kmag = (65536u + K - 1) / K;  // step of column offset o < 2^11: (o . kmag) >> 16
  const uint32_t ring = smem_u32(d_smem + C::kRing) + warp * 2 * C::kStage;
  unsigned char* hi_w = d_smem + C::kHi + warp * kDTile * C::kRow;
  const unsigned char* q8 = d_smem + C::kQ;

  for (int rb = 0; rb < a.rpb; ++rb) {
    const int b = (blockIdx.x / a.H) * a.rpb + rb;
    const int64_t bh = (int64_t)b * a.H + h;
    float* sc = a.sc + bh * K * a.T;
    float* svs = a.svs + bh * K * a.T;
    if constexpr (!PAIR)  // kI4Pair: a step may straddle two splits; a fill kernel sets them
      for (int i = threadIdx.x; i < K * nt; i += kDThreads) sc[(i / nt) * a.T + t0 + i % nt] = -INFINITY;
    {  // q8 of rows warp, warp + 4, ...: every load in flight before the first reduction
      constexpr int QE = (DH + 31) / 32;
      const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
      float qv[4][QE];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int u = 0; u < QE; ++u) {
          const int k = warp + 4 * kk, d = lane + 32 * u;
          qv[kk][u] = k < K && d < DH ? to_f32(q[k * a.q_sk + d]) : 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = warp + 4 * kk;
        float amax = 0.f;
#pragma unroll
        for (int u = 0; u < QE; ++u) amax = fmaxf(amax, fabsf(qv[kk][u]));
        const float qs = warp_max(amax) / 127.0f + 1e-20f;
        int8_t* row = reinterpret_cast<int8_t*>(d_smem + C::kQ + k * C::kRow);
#pragma unroll
        for (int u = 0; u < QE; ++u) {
          const int d = lane + 32 * u;
          if (d < DH) row[d] = (int8_t)(int)rintf(qv[kk][u] / qs);
        }
        if (lane == 0) qs_sm[k] = qs;
      }
    }
    const int* fr = a.flat_rep + (int64_t)b * K * a.TS;
    int* count = reinterpret_cast<int*>(d_smem + C::kCount);
    int n_live = 0;
    if constexpr ((PROBE & 2) != 0)
      __syncthreads();
    else if constexpr (PAIR)
      n_live = compact_live<kDThreads, 2, true>(fr, K, a.TS, c0, c1, live, count, a.P, live_hi);
    else
      n_live = compact_live<kDThreads, 4>(fr, K, a.TS, c0, c1, live, count);
    if (h == 0) {  // the output pass of every head of b reads these
      int* lg = a.live_g + ((int64_t)b * a.n_split + split) * a.lstride;
      for (int e = threadIdx.x; e <= n_live; e += kDThreads) {
        lg[e] = e == 0 ? n_live : (int)live[e - 1];
        if (PAIR && e > 0) lg[a.span + e] = live_hi[e - 1];
      }
    }
    const int n_tiles = (PROBE & 1) ? 0 : (n_live + kDTile - 1) / kDTile;
    const int8_t* slab = a.kv + b * a.kv_sb + (int64_t)a.layer * a.kv_sl + h * a.kv_sh;
    const float* skp = a.sk + b * a.sk_sb + (int64_t)a.layer * a.sk_sl + h * a.sk_sh;
    const float* svp = a.sv + b * a.sv_sb + (int64_t)a.layer * a.sv_sl + h * a.sv_sh;

    int i = warp;
    if (i < n_tiles) {
      d_gather<DH, LOAD>(ring, slab, a.kv_sj, a.P, skp, svp, live, c0, n_live, i, 0);
      cp_async_commit();
    }
    // q8 as A fragments: s8 (k-steps of 32 dims) or bf16 (k-steps of 16).
    constexpr int KS = SC8 ? (DH + 31) / 32 : DH / 16;
    uint32_t qf[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if constexpr (SC8) {
        const int o = 32 * kk + 4 * tq;
        qf[kk][0] = *reinterpret_cast<const uint32_t*>(q8 + g * C::kRow + o);
        qf[kk][1] = *reinterpret_cast<const uint32_t*>(q8 + (g + 8) * C::kRow + o);
        qf[kk][2] = DH >= 32 ? *reinterpret_cast<const uint32_t*>(q8 + g * C::kRow + o + 16) : 0u;
        qf[kk][3] = DH >= 32 ? *reinterpret_cast<const uint32_t*>(q8 + (g + 8) * C::kRow + o + 16) : 0u;
      } else {
        const int o = 16 * kk + 2 * tq;
        qf[kk][0] = i8x2_bf16x2(*reinterpret_cast<const uint16_t*>(q8 + g * C::kRow + o));
        qf[kk][1] = i8x2_bf16x2(*reinterpret_cast<const uint16_t*>(q8 + (g + 8) * C::kRow + o));
        qf[kk][2] = i8x2_bf16x2(*reinterpret_cast<const uint16_t*>(q8 + g * C::kRow + o + 8));
        qf[kk][3] = i8x2_bf16x2(*reinterpret_cast<const uint16_t*>(q8 + (g + 8) * C::kRow + o + 8));
      }
    }
    const float qs_r[2] = {qs_sm[g], qs_sm[g + 8]};

    for (int j = 0; i < n_tiles; ++j, i += 4) {
      const int stage = j & 1;
      if (i + 4 < n_tiles) {
        d_gather<DH, LOAD>(ring + (stage ^ 1) * C::kStage, slab, a.kv_sj, a.P, skp, svp, live, c0,
                           n_live, i + 4, 0);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      unsigned char* kt = d_smem + C::kRing + (warp * 2 + stage) * C::kStage;
      const float* skt = reinterpret_cast<const float*>(kt + kDTile * C::kRow);
      const int r0 = i * kDTile, n_in = min(kDTile, n_live - r0);
      uint32_t hi = 0;  // F: which of the lane's fragment rows hold high columns
      if constexpr (LOAD == kI4 || LOAD == kI4Wide) {
        const int rows[4] = {g, 8 + g, 16 + g, 24 + g};
        hi = d_high(live, r0, n_in, c0, a.P, rows);
      } else if constexpr (PAIR) {
        d_unpack_pair<DH>(kt, hi_w, n_in);
        __syncwarp();
      }
#pragma unroll
      for (int hf = 0; hf < NH; ++hf) {
        int s32[4][4];
        d_s32<DH, SC8, KS, PAIR ? kI8 : LOAD>(s32, qf, hf ? hi_w : kt, g, tq, hi);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int c = 8 * n + 2 * tq + e1;
            const uint32_t col = c < n_in ? live[r0 + c] : 0u;
            const uint32_t beams = hf ? (c < n_in ? (uint32_t)live_hi[r0 + c] : 0u) : col >> 16;
            const int t = PAIR ? (c0 + (int)(col & 0xFFFFu) + hf * a.P) / K
                               : t0 + (int)(((col & 0xFFFFu) * kmag) >> 16);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int beam = g + 8 * r;
              if ((beams >> beam) & 1u) {
                sc[beam * a.T + t] = __fmul_rn(__fmul_rn((float)s32[n][2 * r + e1], qs_r[r]),
                                               skt[hf * kDTile + c]);
                svs[beam * a.T + t] = skt[(NH + hf) * kDTile + c];
              }
            }
          }
        }
      }
      __syncwarp();  // the stage is refilled by the next iteration's gather
    }
    __syncthreads();  // the block's scores are in scratch
    if constexpr (!PAIR) d_split_stats(a, sc, bh, split, t0, nt);
    __syncthreads();  // shared memory is the next batch row's
  }
}

// Pass 2: block (batch row group x head, split). Per batch row: the split's
// live columns from the score pass's list, each warp's first V tile put in
// flight, then each beam's self logit q.k_new, row max m and denominator
// den (the splits' partials folded in a fixed order, plus the self term),
// one warp per beam; the requant scale ws = max_t w_eff / 127 + 1e-20 over
// the whole row's scores and sv in scratch, w_eff = (exp(score - m) / den)
// . sv, the block's threads over the steps (the same in every split); and
// w8 = rint(w_eff / ws) of each (beam, step) of the split, formed once,
// into a shared table. Then warp w takes live tiles w, w + 4, ... of the V
// halves, transposes each into dim-major rows (F: unpacked as read), reads
// the w8 of the (beam, column) elements it holds from the table, and adds
// w8.v8 in int32 (d_wv). The warps' int32 sums merge exactly in shared
// memory; with one split the block writes out = float(sum) . ws + (p_self
// / den) . v_new, else the split's int32 partial, which the merge kernel
// adds.
template <typename T, int DH, bool OUT8, int LOAD, int PROBE = 0>
__global__ void __launch_bounds__(kDThreads, 4) ancestry_q_out_kernel(const I8Args a) {
  constexpr bool PAIR = LOAD == kI4Pair;
  constexpr int NH = PAIR ? 2 : 1;
  using C = DSh<DH, PAIR>;
  constexpr int NT = DH / 8;  // n-tiles of the output row
  extern __shared__ __align__(128) unsigned char d_smem[];
  uint32_t* live = reinterpret_cast<uint32_t*>(d_smem + C::kLive);
  uint16_t* live_hi = reinterpret_cast<uint16_t*>(d_smem + C::kLiveHi);
  int8_t* w8s = reinterpret_cast<int8_t*>(d_smem + C::kW8);  // [K][nt]
  float* st_m = reinterpret_cast<float*>(d_smem + C::kRowSt);
  float* st_den = st_m + 16;
  float* st_ws = st_den + 16;
  float* st_ps = st_ws + 16;
  float* ws_part = st_ps + 16;  // [4 warps][16]
  int* merge = reinterpret_cast<int*>(d_smem + C::kRing);  // [4 warps][16][DH], after the tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int K = a.K, h = blockIdx.x % a.H, split = blockIdx.y;
  const int c0 = split * a.span, c1 = min(PAIR ? a.P : a.TS, c0 + a.span);
  // The split's steps: D and F [t0, t0 + nt); kI4Pair those of its low
  // columns [t0, t0 + nl), then of its high ones from th0.
  const int t0 = c0 / K;
  const int nl = PAIR ? (c1 - 1) / K - t0 + 1 : (c1 - c0) / K;
  const int th0 = (c0 + a.P) / K;
  const int nt = PAIR ? nl + (c1 - 1 + a.P) / K - th0 + 1 : nl;
  const uint32_t kmag = (65536u + K - 1) / K;
  const uint32_t ring = smem_u32(d_smem + C::kRing) + warp * 2 * C::kStage;
  unsigned char* vt = d_smem + C::kVt + warp * DH * C::kTRow;
  unsigned char* hi_w = d_smem + C::kHi + warp * kDTile * C::kRow;

  for (int rb = 0; rb < a.rpb; ++rb) {
    const int b = (blockIdx.x / a.H) * a.rpb + rb;
    const int64_t bh = (int64_t)b * a.H + h;
    const float* sc = a.sc + bh * K * a.T;
    const float* svs = a.svs + bh * K * a.T;
    const int* lg = a.live_g + ((int64_t)b * a.n_split + split) * a.lstride;
    const int n_live = lg[0];
    for (int e = threadIdx.x; e < n_live; e += kDThreads) {
      live[e] = (uint32_t)lg[1 + e];
      if constexpr (PAIR) live_hi[e] = (uint16_t)lg[1 + a.span + e];
    }
    __syncthreads();
    const int n_tiles = (PROBE & 1) ? 0 : (n_live + kDTile - 1) / kDTile;
    const int8_t* slab = a.kv + b * a.kv_sb + (int64_t)a.layer * a.kv_sl + h * a.kv_sh;
    int i = warp;
    if (i < n_tiles) {  // in flight while the row's statistics are formed
      d_gather<DH, LOAD>(ring, slab, a.kv_sj, a.P, nullptr, nullptr, live, c0, n_live, i, 1);
      cp_async_commit();
    }
    {  // beams warp, warp + 4, ...: every load in flight before the first reduction
      constexpr int QE = (DH + 31) / 32, SE = (kDMaxSplits + 31) / 32;
      float sl[4], pmv[4][SE], plv[4][SE];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = warp + 4 * kk;
        const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + k * a.q_sk;
        const T* kn = static_cast<const T*>(a.k_new) + b * a.kn_sb + h * a.kn_sh + k * a.kn_sk;
        sl[kk] = 0.f;
#pragma unroll
        for (int u = 0; u < QE; ++u) {
          const int d = lane + 32 * u;
          if (k < K && d < DH) sl[kk] = fmaf(to_f32(q[d]), to_f32(kn[d]), sl[kk]);
        }
#pragma unroll
        for (int u = 0; u < SE; ++u) {
          const int64_t at = (bh * a.n_stat + lane + 32 * u) * K + k;
          const bool ok = k < K && lane + 32 * u < a.n_stat;
          pmv[kk][u] = ok ? a.part_m[at] : -INFINITY;
          plv[kk][u] = ok ? a.part_l[at] : 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = warp + 4 * kk;
        if (k >= K) break;  // warp-uniform
        const float self = warp_sum(sl[kk]);
        float m = self;
#pragma unroll
        for (int u = 0; u < SE; ++u) m = fmaxf(m, pmv[kk][u]);
        m = warp_max(m);
        float den = 0.f;
#pragma unroll
        for (int u = 0; u < SE; ++u)
          if (pmv[kk][u] != -INFINITY) den = fmaf(expf(pmv[kk][u] - m), plv[kk][u], den);
        const float p_self = expf(self - m);
        den = warp_sum(den) + p_self;
        if (lane == 0) {
          st_m[k] = m;
          st_den[k] = den;
          st_ps[k] = p_self;
        }
      }
    }
    __syncthreads();
    if constexpr (!(PROBE & 4)) {  // ws: each thread's steps of every beam, then the beams' maxima
      float wmax[kMaxBeams];
#pragma unroll
      for (int k = 0; k < kMaxBeams; ++k) wmax[k] = 0.f;
      for (int t = threadIdx.x; t < a.T; t += kDThreads) {
#pragma unroll
        for (int k = 0; k < kMaxBeams; ++k) {
          if (k < K) {
            const float x = sc[k * a.T + t], v = svs[k * a.T + t];  // v unset where x is -inf
            if (x != -INFINITY) wmax[k] = fmaxf(wmax[k], __fmul_rn(expf(x - st_m[k]) / st_den[k], v));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxBeams; ++k) {
        if (k < K) {
          const float w = warp_max(wmax[k]);
          if (lane == 0) ws_part[warp * 16 + k] = w;
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < K) {
      const int k = threadIdx.x;
      const float w = fmaxf(fmaxf(ws_part[k], ws_part[16 + k]), fmaxf(ws_part[32 + k], ws_part[48 + k]));
      st_ws[k] = w / 127.0f + 1e-20f;
      if (split == 0 && a.n_split > 1) {
        a.row_st[(bh * K + k) * 2] = st_ws[k];
        a.row_st[(bh * K + k) * 2 + 1] = st_ps[k] / st_den[k];
      }
    }
    __syncthreads();
    if constexpr (!(PROBE & 4)) {  // K.nt <= kBSpan entries: every load in flight before the first w8
      constexpr int WE = kBSpan / kDThreads;
      float xv[WE], vv[WE];
#pragma unroll
      for (int u = 0; u < WE; ++u) {
        const int e = threadIdx.x + kDThreads * u, k = e / nt, s = e - k * nt;
        const int t = !PAIR || s < nl ? t0 + s : th0 + s - nl;
        xv[u] = e < K * nt ? sc[k * a.T + t] : -INFINITY;
        vv[u] = e < K * nt ? svs[k * a.T + t] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < WE; ++u) {
        const int e = threadIdx.x + kDThreads * u, k = e / nt;
        int w = 0;
        if (xv[u] != -INFINITY)
          w = (int)rintf(__fmul_rn(expf(xv[u] - st_m[k]) / st_den[k], vv[u]) / st_ws[k]);
        if (e < K * nt) w8s[e] = (int8_t)w;
      }
    }
    __syncthreads();  // the w8 table is written
    int acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;

    for (int j = 0; i < n_tiles; ++j, i += 4) {
      const int stage = j & 1;
      if (i + 4 < n_tiles) {
        d_gather<DH, LOAD>(ring + (stage ^ 1) * C::kStage, slab, a.kv_sj, a.P, nullptr, nullptr,
                           live, c0, n_live, i + 4, 1);
        cp_async_commit();
      }
      // The w8 of this tile's (beam, column) elements, while the V rows land.
      const int r0 = i * kDTile, n_in = min(kDTile, n_live - r0);
      int w8[NH][4][4];
#pragma unroll
      for (int hf = 0; hf < NH; ++hf) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int c = 8 * n + 2 * tq + e1;
            const uint32_t col = c < n_in ? live[r0 + c] : 0u;
            const uint32_t beams = hf ? (c < n_in ? (uint32_t)live_hi[r0 + c] : 0u) : col >> 16;
            int t;  // the step's entry in the table
            if constexpr (PAIR)
              t = hf ? nl + (c0 + (int)(col & 0xFFFFu) + a.P) / K - th0
                     : (c0 + (int)(col & 0xFFFFu)) / K - t0;
            else
              t = (int)(((col & 0xFFFFu) * kmag) >> 16);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int beam = g + 8 * r;
              w8[hf][n][2 * r + e1] = (beams >> beam) & 1u ? (int)w8s[beam * nt + t] : 0;
            }
          }
        }
      }
      if (i + 4 < n_tiles) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncwarp();
      unsigned char* vr = d_smem + C::kRing + (warp * 2 + stage) * C::kStage;
      uint32_t hi4 = 0;  // F: which of the lane's transpose rows hold high columns
      if constexpr (LOAD == kI4 || LOAD == kI4Wide) {
        const int rows[4] = {4 * (lane & 7), 4 * (lane & 7) + 1, 4 * (lane & 7) + 2,
                             4 * (lane & 7) + 3};
        hi4 = d_high(live, r0, n_in, c0, a.P, rows);
      } else if constexpr (PAIR) {
        d_unpack_pair<DH>(vr, hi_w, n_in);
        __syncwarp();
      }
#pragma unroll
      for (int hf = 0; hf < NH; ++hf) {
        d_transpose<DH, PAIR ? kI8 : LOAD>(vt, hf ? hi_w : vr, hi4);
        __syncwarp();  // vt is written
        d_wv<DH, OUT8>(acc, w8[hf], vt, g, tq);
        __syncwarp();  // the stage and vt are rewritten next
      }
    }
    __syncthreads();  // every ring is drained: the merge goes over them
    int* mw = merge + warp * 16 * DH;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mw[(g + 8 * (e >> 1)) * DH + 8 * n + 2 * tq + (e & 1)] = acc[n][e];
    }
    __syncthreads();
    const T* vn = static_cast<const T*>(a.v_new) + b * a.vn_sb + h * a.vn_sh;
    T* out = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;
    for (int e = threadIdx.x; e < K * DH; e += kDThreads) {
      const int k = e / DH, d = e % DH;
      const int total = merge[k * DH + d] + merge[16 * DH + k * DH + d] +
                        merge[32 * DH + k * DH + d] + merge[48 * DH + k * DH + d];
      if (a.n_split == 1) {
        const float hist = __fmul_rn((float)total, st_ws[k]);
        const float self = __fmul_rn(st_ps[k] / st_den[k], to_f32(vn[k * a.vn_sk + d]));
        out[k * a.o_sk + d] = from_f32<T>(__fadd_rn(hist, self));
      } else {
        a.part_acc[((bh * a.n_split + split) * K + k) * DH + d] = total;
      }
    }
    __syncthreads();  // shared memory is the next batch row's
  }
}

// Merge (n_split > 1): one block per (b, h) adds the splits' int32 sums
// (exact in any order) and applies ws and the self term.
template <typename T, int DH, int LOAD>
__global__ void __launch_bounds__(kDThreads) ancestry_q_merge_kernel(const I8Args a) {
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, K = a.K;
  const T* vn = static_cast<const T*>(a.v_new) + b * a.vn_sb + h * a.vn_sh;
  T* out = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;
  for (int e = threadIdx.x; e < K * DH; e += kDThreads) {
    const int k = e / DH, d = e % DH;
    int total = 0;
    for (int s = 0; s < a.n_split; ++s)
      total += a.part_acc[(((int64_t)bh * a.n_split + s) * K + k) * DH + d];
    const float* st = a.row_st + ((int64_t)bh * K + k) * 2;
    const float hist = __fmul_rn((float)total, st[0]);
    out[k * a.o_sk + d] = from_f32<T>(__fadd_rn(hist, __fmul_rn(st[1], to_f32(vn[k * a.vn_sk + d]))));
  }
}

// kI4Pair: every score entry -inf before the score pass (a step's columns
// may lie in two splits' rows, so no split owns its entries).
__global__ void fill_kernel(float* p, float v, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    p[i] = v;
}

template <typename T, int DH, bool SC8, bool OUT8, int LOAD, int PROBE = 0>
cudaError_t launch_q(const I8Args& a, int B, cudaStream_t stream) {
  constexpr int smem = DSh<DH, LOAD == kI4Pair>::kBytes;
  const dim3 grid(B / a.rpb * a.H, a.n_split);
  cudaError_t err = allow_smem(ancestry_q_score_kernel<T, DH, SC8, LOAD, PROBE>, smem);
  if (err == cudaSuccess) err = allow_smem(ancestry_q_out_kernel<T, DH, OUT8, LOAD, PROBE>, smem);
  if (err != cudaSuccess) return err;
  if (LOAD == kI4Pair) {
    fill_kernel<<<4 * kSMs, 256, 0, stream>>>(a.sc, -INFINITY, (int64_t)B * a.H * a.K * a.T);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ancestry_q_score_kernel<T, DH, SC8, LOAD, PROBE><<<grid, kDThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (LOAD == kI4Pair) {
    ancestry_q_stats_kernel<<<dim3(B * a.H, a.n_stat), kDThreads, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ancestry_q_out_kernel<T, DH, OUT8, LOAD, PROBE><<<grid, kDThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  ancestry_q_merge_kernel<T, DH, LOAD><<<B * a.H, kDThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool SC8, bool OUT8, int LOAD>
cudaError_t dispatch_q(int DH, const I8Args& a, int B, cudaStream_t stream) {
  switch (DH) {
    case 16: return launch_q<T, 16, SC8, OUT8, LOAD>(a, B, stream);
    case 32: return launch_q<T, 32, SC8, OUT8, LOAD>(a, B, stream);
    case 64: return launch_q<T, 64, SC8, OUT8, LOAD>(a, B, stream);
    case 128: return launch_q<T, 128, SC8, OUT8, LOAD>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// D (packed = false) or F: the variant's products and load. F's variants
// 1-3 are instantiated at Dh = 64 only (tools/kernel_ab.py's shapes).
template <typename T>
cudaError_t dispatch_q_variant(bool packed, int variant, int DH, const I8Args& a, int B,
                               cudaStream_t stream) {
  if (!packed) switch (variant) {
      case 1: return dispatch_q<T, true, false, kI8>(DH, a, B, stream);
      case 2: return dispatch_q<T, false, false, kI8>(DH, a, B, stream);
      default: return dispatch_q<T, true, true, kI8>(DH, a, B, stream);  // 0 and 3 (rpb 2)
    }
  if (variant == 0) return dispatch_q<T, true, true, kI4>(DH, a, B, stream);
  if (DH != 64) return cudaErrorInvalidValue;
  switch (variant) {
    case 1: return launch_q<T, 64, true, true, kI4Wide>(a, B, stream);
    case 2: return launch_q<T, 64, false, false, kI4>(a, B, stream);
    case 3: return launch_q<T, 64, true, true, kI4Pair>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// mm_ancestry_decode_fixed_work's instances: D's or F's v0, bf16, Dh = 64.
template <int PROBE>
cudaError_t launch_fixed_work(bool packed, const I8Args& a, int B, cudaStream_t stream) {
  return packed ? launch_q<__nv_bfloat16, 64, true, true, kI4, PROBE>(a, B, stream)
                : launch_q<__nv_bfloat16, 64, true, true, kI8, PROBE>(a, B, stream);
}

// ------------------------------------------------------------------ kernel E

constexpr int kEThreads = 128;  // split passes and merge: 4 warps
constexpr int kEMaxSplits = 16;

// What the bf16 split pass reads: E's int8 slab with its scales and the
// bias, or (mm_dense_attention_probe) a dense int8 slab or the same values
// nibble-packed (half-split, as the int4 cache), without scales or bias.
// The fp32 split pass reads E's.
enum CrossLoad : int { kE = 0, kDense8 = 1, kDense4 = 2 };

struct CrossQArgs {
  const void* q;       // (B, H, K, Dh) through strides, pre-scaled
  int64_t q_sb, q_sh, q_sk;
  const int8_t* kv;    // (B, H, S, 2.Dh) contiguous (kDense4: (B, H, S/2, 2.Dh) packed)
  const float* sk;     // (B, H, S) contiguous
  const float* sv;     // (B, H, S) contiguous
  const float* bias;   // (B, S) additive
  void* out;           // (B, H, K, Dh) through strides
  int64_t o_sb, o_sh, o_sk;
  float* part_m;       // (B.H.G, n_split, 16) max of each split, -inf if it saw no column
  float* part_l;       // (B.H.G, n_split, 16) its denominator
  float* part_acc;     // (B.H.G, n_split, 16, Dh) its unnormalised sum
  int H, K, S, G, n_split, tps, rpb;  // G: groups of 16 rows; tps: key tiles per split;
                                      // rpb: batch rows per block
};


// Shared memory of the bf16 split pass: each warp's 2-stage ring of TW raw
// int8 K||V rows (padded to kRawRow bytes, so that the 8 rows of one
// fragment load hit distinct banks) with their sk, sv and bias, its bf16 V
// tile (swizzled, as C's), then the rows' q as 16 zero-padded rows: 54 KB
// at Dh = 64, four blocks per SM. The warps' (O, m, l) for the block's
// merge go over the drained ring.
template <int D>
struct EMma {
  static constexpr int kTW = D <= 64 ? 32 : 16;   // keys per warp tile
  static constexpr int kRawRow = 2 * D + 16;
  static constexpr int kRaw = kTW * kRawRow;      // the int8 rows
  static constexpr int kStage = kRaw + 3 * kTW * 4;
  static constexpr int kTile = kTW * D * 2;       // the bf16 V tile
  static constexpr int kRing = 0;
  static constexpr int kTiles = kRing + 4 * 2 * kStage;
  static constexpr int kQ = kTiles + 4 * kTile;
  static constexpr int kBytes = kQ + 16 * D * 2;
  static constexpr int kMerge = 16 * (D + 2);  // floats per warp: O (16 x D), m, l
  static_assert(4 * kMerge * 4 <= kQ - kRing, "the merge fits over the ring and tiles");
  static_assert(kStage % 16 == 0 && kTiles % 16 == 0 && kRawRow % 16 == 0, "16-byte aligned rows");
};

// bf16 split pass: block ((b.H + h) / rpb, split, row group). Warp w takes
// key tiles i0 + w, i0 + w + 4, ... of the split's [i0, i1), gathers each
// tile's raw rows by its own lanes, converts the K halves to bf16 fragments
// as it reads them and the V halves into its own bf16 tile, and keeps its own online softmax with the group's rows as mma rows; the
// four warps' (m, l, O) merge at the end, into the output (one split) or
// the split's partial.
template <int D, int LOAD>
__global__ void __launch_bounds__(kEThreads, 4) cross_i8_split_kernel_mma(const CrossQArgs a) {
  using C = EMma<D>;
  constexpr int KS = D / 16, NT = D / 8, TW = C::kTW, CH = 2 * D / 16;
  extern __shared__ __align__(128) unsigned char e_smem[];
  float* merge = reinterpret_cast<float*>(e_smem + C::kRing);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int S = a.S, P = S / 2, h = blockIdx.x % a.H, split = blockIdx.y, grp = blockIdx.z;
  const int r0 = grp * 16, K = min(16, a.K - r0);
  const int i1 = min((S + TW - 1) / TW, (split + 1) * a.tps);
  const uint32_t ring = smem_u32(e_smem + C::kRing) + warp * 2 * C::kStage;
  unsigned char* tiles = e_smem + C::kTiles + warp * C::kTile;
  const uint32_t vt = smem_u32(tiles);

  for (int rb = 0; rb < a.rpb; ++rb) {
    const int b = (blockIdx.x / a.H) * a.rpb + rb;
    const int64_t bh = (int64_t)b * a.H + h;
    const int8_t* slab = a.kv + bh * (LOAD == kDense4 ? P : S) * 2 * D;
    const float* skp = a.sk + bh * S;
    const float* svp = a.sv + bh * S;
    const float* bias = a.bias + (int64_t)b * S;
    auto gather = [&](uint32_t stage, int i) {  // key tile i; past S zeros
      const int s0 = i * TW;
      for (int e = lane; e < TW * CH; e += 32) {
        const int r = e / CH, c = e % CH;
        const bool ok = s0 + r < S;
        int row = ok ? s0 + r : 0;
        if (LOAD == kDense4) row -= row >= P ? P : 0;
        cp_async16(stage + r * C::kRawRow + c * 16, slab + (int64_t)row * 2 * D + c * 16, ok);
      }
      if (LOAD == kE && lane < TW) {
        const bool ok = s0 + lane < S;
        const int s = ok ? s0 + lane : 0;
        cp_async4(stage + C::kRaw + lane * 4, skp + s, ok);
        cp_async4(stage + C::kRaw + (TW + lane) * 4, svp + s, ok);
        cp_async4(stage + C::kRaw + (2 * TW + lane) * 4, bias + s, ok);
      }
    };
    int i = split * a.tps + warp;
    if (i < i1) {  // the warp's first tile goes in flight before q is staged
      gather(ring, i);
      cp_async_commit();
    }
    const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh + r0 * a.q_sk;
    for (int e = threadIdx.x; e < 16 * D; e += kEThreads) {
      const int r = e / D, d = e % D;
      *reinterpret_cast<bf16*>(e_smem + C::kQ + swz<D>(r, d / 8) + (d % 8) * 2) =
          r < K ? q[r * a.q_sk + d] : __float2bfloat16(0.f);
    }
    __syncthreads();
    uint32_t qf[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) frag_a<D>(qf[kk], smem_u32(e_smem + C::kQ), 0, kk);
    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

    for (int j = 0; i < i1; ++j, i += 4) {
      const int stage = j & 1;
      if (i + 4 < i1) {
        gather(ring + (stage ^ 1) * C::kStage, i + 4);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      const unsigned char* raw = e_smem + C::kRing + (warp * 2 + stage) * C::kStage;
      const float* sks = reinterpret_cast<const float*>(raw + C::kRaw);  // sk, sv, bias
      const int s0 = i * TW, n_in = min(TW, S - s0);
      // The raw V halves to bf16 (exact: |x| <= 127), 8 values per lane step.
      for (int e = lane; e < TW * (D / 8); e += 32) {
        const int r = e / (D / 8), c = e % (D / 8);
        uint2 w = *reinterpret_cast<const uint2*>(raw + r * C::kRawRow + D + c * 8);
        if (LOAD == kDense4) {
          const bool high = s0 + r >= P;
          w.x = nibbles(w.x, high);
          w.y = nibbles(w.y, high);
        }
        const uint4 v = {i8x2_bf16x2(w.x & 0xFFFFu), i8x2_bf16x2(w.x >> 16),
                         i8x2_bf16x2(w.y & 0xFFFFu), i8x2_bf16x2(w.y >> 16)};
        *reinterpret_cast<uint4*>(tiles + swz<D>(r, c)) = v;
      }
      // S = Q.K^T, K's B fragments (key row 8 n + g, dims 16 kk + 2 tq, +1
      // and + 8) converted from the raw int8 rows as they are read.
      float s[TW / 8][4];
#pragma unroll
      for (int n = 0; n < TW / 8; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        const unsigned char* kr = raw + (8 * n + g) * C::kRawRow + 2 * tq;
        const bool high = LOAD == kDense4 && s0 + 8 * n + g >= P;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t b0 = *reinterpret_cast<const uint16_t*>(kr + 16 * kk);
          uint32_t b1 = *reinterpret_cast<const uint16_t*>(kr + 16 * kk + 8);
          if (LOAD == kDense4) b0 = nibbles(b0, high), b1 = nibbles(b1, high);
          mma(s[n], qf[kk], i8x2_bf16x2(b0), i8x2_bf16x2(b1));
        }
      }
      __syncwarp();  // the V tile is written
      // Element e of n-tile n: row g + 8 (e >> 1), key s0 + 8 n + 2 tq + (e & 1).
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < TW / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * tq + (e & 1);
          const float x = LOAD == kE ? __fadd_rn(__fmul_rn(s[n][e], sks[c]), sks[2 * TW + c])
                                     : s[n][e];
          s[n][e] = c < n_in ? x : -INFINITY;
          mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
        }
      }
      float alpha[2], m_new[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_new[r] = fmaxf(m_run[r], quad_max(mt[r]));
        // -inf until a key with a finite logit comes: nothing to rescale yet
        alpha[r] = m_new[r] == -INFINITY ? 1.f : exp_e(m_run[r] - m_new[r]);
        m_run[r] = m_new[r];
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < TW / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = 8 * n + 2 * tq + (e & 1);
          const float p = m_new[r] == -INFINITY ? 0.f : exp_e(s[n][e] - m_new[r]);
          l_run[r] += p;
          s[n][e] = LOAD == kE ? p * sks[TW + c] : p;  // sv folded in before the bf16 rounding
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < TW / 16; ++kk) {
        uint32_t pa[4];
        acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < NT / 2; ++dp) {
          uint32_t f[4];
          frag_bt<D>(f, vt, kk * 16, dp);
          mma(o[2 * dp], pa, f[0], f[1]);
          mma(o[2 * dp + 1], pa, f[2], f[3]);
        }
      }
      __syncwarp();  // the stage and the tiles are rewritten by the next tile
    }

    __syncthreads();  // every ring is drained: the merge goes over them
    float* mw = merge + warp * C::kMerge;  // O [16][D], then m [16], l [16]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l = quad_sum(l_run[r]);
      if (tq == 0) {
        mw[16 * D + g + 8 * r] = m_run[r];
        mw[16 * D + 16 + g + 8 * r] = l;
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mw[(g + 8 * (e >> 1)) * D + 8 * n + 2 * tq + (e & 1)] = o[n][e];
    }
    __syncthreads();
    const int64_t part = (bh * a.G + grp) * a.n_split + split;
    bf16* out = static_cast<bf16*>(a.out) + b * a.o_sb + h * a.o_sh + r0 * a.o_sk;
    for (int e = threadIdx.x; e < K * D; e += kEThreads) {
      const int k = e / D, d = e % D;
      float M = -INFINITY, l = 0.f, acc = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) M = fmaxf(M, merge[w * C::kMerge + 16 * D + k]);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float* mv = merge + w * C::kMerge;
        const float m = mv[16 * D + k];
        if (m == -INFINITY) continue;  // the warp saw no key (or only -inf logits)
        const float sc = exp_e(m - M);
        l = fmaf(sc, mv[16 * D + 16 + k], l);
        acc = fmaf(sc, mv[k * D + d], acc);
      }
      if (a.n_split == 1) {
        out[k * a.o_sk + d] = __float2bfloat16_rn(acc / l);
        continue;
      }
      if (d == 0) {
        a.part_m[part * 16 + k] = M;
        a.part_l[part * 16 + k] = l;
      }
      a.part_acc[(part * 16 + k) * D + d] = acc;
    }
    __syncthreads();  // shared memory is the next batch row's
  }
}

// ------------------------------------------------- kernel E in fp32: 2xTF32
//
// Every int8 value is exact in tf32 (|x| <= 128 needs 8 of its 11
// significant bits), so split_tf32 of k8 or v8 gives lo = 0, and of
// 3xTF32's three products the cross term hi(q).lo(k8) (hi(P).lo(v8)) adds
// exactly 0: two products per tile, lo(q).k8 then hi(q).k8 (lo(P).v8 then
// hi(P).v8), the bits of 3xTF32 with a third fewer mma.

// Shared memory of the fp32 split pass: each warp's 2-stage ring of kTW raw
// int8 K||V rows (kRawRow bytes, as bf16's) with their sk, sv and bias,
// then the group's q as 16 zero-padded fp32 rows of kQRow floats, kQRow =
// 16 mod 32, so that the 16-byte reads of rows g and g + 1 by a
// quarter-warp fall on distinct banks. The warps' (O, m, l) go over the
// drained ring. 44 KB at Dh = 64: the registers (143 at Dh = 64) hold it
// to three blocks per SM. 32-key tiles (bf16's) were measured against 16
// (2-14% slower), and V through a per-warp fp32 tile in C's layout against
// V read from the raw rows (6-28% slower, tools/kernel_ab.py; PERF.md).
template <int D>
struct ETf32 {
  static constexpr int kTW = D <= 64 ? 32 : 16;  // keys per warp tile
  static constexpr int kRawRow = 2 * D + 16;
  static constexpr int kRaw = kTW * kRawRow;
  static constexpr int kStage = kRaw + 3 * kTW * 4;
  static constexpr int kRing = 0;
  static constexpr int kQ = kRing + 4 * 2 * kStage;
  static constexpr int kQRow = D % 32 == 0 ? D + 16 : D;
  static constexpr int kBytes = kQ + 16 * kQRow * 4;
  static_assert(4 * 16 * (D + 2) * 4 <= kQ - kRing, "the merge fits over the ring");
  static_assert(kStage % 16 == 0 && kRawRow % 16 == 0, "16-byte aligned rows");
};

// Byte i of w, a signed int8, as the bits of the exact float: a tf32
// operand whose lo half is 0.
__device__ __forceinline__ uint32_t i8_tf32(uint32_t w, int i) {
  return __float_as_uint((float)(int8_t)(w >> (8 * i)));
}

// c += a . b with b exact in tf32 (an int8 value): lo(a).b, then hi(a).b.
__device__ __forceinline__ void mma2(float (&c)[4], const FragA32& a, uint32_t b0, uint32_t b1) {
  mma_tf32(c, a.lo, b0, b1);
  mma_tf32(c, a.hi, b0, b1);
}

// q's A fragments of the 16 head dims 16 c.. from the staged rows (row
// stride QR floats), split into tf32 halves: lane (g, tq) reads dims
// 16 c + 4 tq .. + 3 of rows g and g + 8, as K's int8 words hold them, so
// k-step 2 c takes dims 16 c + 4 tq and + 1 (k-indices tq and tq + 4) and
// k-step 2 c + 1 dims + 2 and + 3; both operands agree, and a dot product
// does not depend on the order of its dims.
template <int QR>
__device__ __forceinline__ void frag_q_e(FragA32 (&f)[2], const float* q, int c) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const float4 x0 = *reinterpret_cast<const float4*>(q + g * QR + 16 * c + 4 * tq);
  const float4 x1 = *reinterpret_cast<const float4*>(q + (g + 8) * QR + 16 * c + 4 * tq);
  split_tf32(x0.x, f[0].hi[0], f[0].lo[0]);
  split_tf32(x1.x, f[0].hi[1], f[0].lo[1]);
  split_tf32(x0.y, f[0].hi[2], f[0].lo[2]);
  split_tf32(x1.y, f[0].hi[3], f[0].lo[3]);
  split_tf32(x0.z, f[1].hi[0], f[1].lo[0]);
  split_tf32(x1.z, f[1].hi[1], f[1].lo[1]);
  split_tf32(x0.w, f[1].hi[2], f[1].lo[2]);
  split_tf32(x1.w, f[1].hi[3], f[1].lo[3]);
}

// R bytes of a raw row (R = 4 or 2) as one load.
template <int R>
__device__ __forceinline__ uint32_t load_bytes(const unsigned char* p) {
  if constexpr (R == 4) return *reinterpret_cast<const uint32_t*>(p);
  return *reinterpret_cast<const uint16_t*>(p);
}

// fp32 split pass: block (b.H + h, split, row group), bf16's blocks, rings
// and online softmax with fp32 C's m16n8k8 products in 2xTF32: q split once
// (into registers for Dh <= 64); K read straight from the raw int8 rows,
// one word of 4 dims per lane, each byte an exact tf32 operand; s = (q.k8)
// . sk + bias (the reference's order, -inf past S); P = p . sv split from
// the S accumulators (sv folded into each unnormalised weight, l summing
// p); V read from the raw rows too, R bytes (R consecutive dims of one key)
// per lane, which serve R n-tiles: n-tile R j + i holds dims 8 R j + R col
// + i (merge_warps' R).
template <int D>
__global__ void __launch_bounds__(kEThreads, 3) cross_i8_split_kernel_tf32(const CrossQArgs a) {
  using C = ETf32<D>;
  constexpr int NC = D / 16, NT = D / 8, CH = 2 * D / 16, TW = C::kTW;
  constexpr int R = D >= 32 ? 4 : 2;
  constexpr bool Q_REGS = D <= 64;
  extern __shared__ __align__(128) unsigned char e_smem[];
  float* merge = reinterpret_cast<float*>(e_smem + C::kRing);
  float* q_tile = reinterpret_cast<float*>(e_smem + C::kQ);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int S = a.S, b = blockIdx.x / a.H, h = blockIdx.x % a.H, split = blockIdx.y;
  const int r0 = blockIdx.z * 16, K = min(16, a.K - r0);
  const int i1 = min((S + TW - 1) / TW, (split + 1) * a.tps);
  const int64_t bh = (int64_t)b * a.H + h;
  const int8_t* slab = a.kv + bh * S * 2 * D;
  const float* skp = a.sk + bh * S;
  const float* svp = a.sv + bh * S;
  const float* bias = a.bias + (int64_t)b * S;
  const uint32_t ring = smem_u32(e_smem + C::kRing) + warp * 2 * C::kStage;
  auto gather = [&](uint32_t stage, int i) {  // key tile i; past S zeros
    const int s0 = i * TW;
    for (int e = lane; e < TW * CH; e += 32) {
      const int r = e / CH, c = e % CH;
      const bool ok = s0 + r < S;
      cp_async16(stage + r * C::kRawRow + c * 16,
                 slab + (int64_t)(ok ? s0 + r : 0) * 2 * D + c * 16, ok);
    }
    if (lane < TW) {
      const bool ok = s0 + lane < S;
      const int s = ok ? s0 + lane : 0;
      cp_async4(stage + C::kRaw + lane * 4, skp + s, ok);
      cp_async4(stage + C::kRaw + (TW + lane) * 4, svp + s, ok);
      cp_async4(stage + C::kRaw + (2 * TW + lane) * 4, bias + s, ok);
    }
  };
  int i = split * a.tps + warp;
  if (i < i1) {  // the warp's first tile goes in flight before q is staged
    gather(ring, i);
    cp_async_commit();
  }
  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh + r0 * a.q_sk;
  for (int e = threadIdx.x; e < 16 * D; e += kEThreads) {
    const int r = e / D, d = e % D;
    q_tile[r * C::kQRow + d] = r < K ? q[r * a.q_sk + d] : 0.f;
  }
  __syncthreads();
  FragA32 qf[Q_REGS ? NC : 1][2];
  if constexpr (Q_REGS) {
#pragma unroll
    for (int c = 0; c < NC; ++c) frag_q_e<C::kQRow>(qf[c], q_tile, c);
  }
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int j = 0; i < i1; ++j, i += 4) {
    const int stage = j & 1;
    if (i + 4 < i1) {
      gather(ring + (stage ^ 1) * C::kStage, i + 4);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const unsigned char* raw = e_smem + C::kRing + (warp * 2 + stage) * C::kStage;
    const float* sks = reinterpret_cast<const float*>(raw + C::kRaw);  // sk, sv, bias
    const int n_in = min(TW, S - i * TW);
    // S = Q.K^T: one word of key 8 n + g, dims 16 c + 4 tq .. + 3, per lane.
    float s[TW / 8][4];
#pragma unroll
    for (int n = 0; n < TW / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      FragA32 qc[2];
      if constexpr (Q_REGS) {
        qc[0] = qf[c][0];
        qc[1] = qf[c][1];
      } else {
        frag_q_e<C::kQRow>(qc, q_tile, c);
      }
#pragma unroll
      for (int n = 0; n < TW / 8; ++n) {
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(raw + (8 * n + g) * C::kRawRow + 16 * c + 4 * tq);
        mma2(s[n], qc[0], i8_tf32(w, 0), i8_tf32(w, 1));
        mma2(s[n], qc[1], i8_tf32(w, 2), i8_tf32(w, 3));
      }
    }
    // Element e of n-tile n: row g + 8 (e >> 1), key i.TW + 8 n + 2 tq + (e & 1).
#pragma unroll
    for (int n = 0; n < TW / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * tq + (e & 1);
        s[n][e] = c < n_in ? __fadd_rn(__fmul_rn(s[n][e], sks[c]), sks[2 * TW + c]) : -INFINITY;
      }
    }
    softmax_tile(s, o, m_run, l_run);
#pragma unroll
    for (int n = 0; n < TW / 8; ++n) {
      float w[4];  // sv folded into each weight before it is split
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = __fmul_rn(s[n][e], sks[TW + 8 * n + 2 * tq + (e & 1)]);
      FragA32 pa;
      acc_to_a32(pa, w);
      // Keys 8 n + 2 tq and + 1 (k-indices tq, tq + 4), dims 8 R jd + R g .. + R - 1.
      const unsigned char* vr = raw + (8 * n + 2 * tq) * C::kRawRow + D + R * g;
#pragma unroll
      for (int jd = 0; jd < NT / R; ++jd) {
        const uint32_t w0 = load_bytes<R>(vr + 8 * R * jd);
        const uint32_t w1 = load_bytes<R>(vr + C::kRawRow + 8 * R * jd);
#pragma unroll
        for (int r = 0; r < R; ++r) mma2(o[R * jd + r], pa, i8_tf32(w0, r), i8_tf32(w1, r));
      }
    }
    __syncwarp();  // the stage is refilled by the next tile's gather
  }
  // The 4 warps merged; one split writes O / l, several their partials.
  const int64_t part = (bh * a.G + blockIdx.z) * a.n_split + split;
  float* out = static_cast<float*>(a.out) + b * a.o_sb + h * a.o_sh + r0 * a.o_sk;
  merge_warps<D, R>(merge, K, m_run, l_run, o, [&](int k, int d, float M, float l, float acc) {
    if (a.n_split == 1) {
      out[k * a.o_sk + d] = acc / l;
      return;
    }
    if (d == 0) {
      a.part_m[part * 16 + k] = M;
      a.part_l[part * 16 + k] = l;
    }
    a.part_acc[(part * 16 + k) * D + d] = acc;
  });
}

// Merge (n_split > 1): one block per (b, h, row group) folds the splits'
// (m, l, O) in split order; a split that saw no column (max -inf) weighs 0.
template <typename T, int D>
__global__ void __launch_bounds__(kEThreads) cross_i8_merge_kernel(const CrossQArgs a) {
  const int bhg = blockIdx.x, grp = bhg % a.G, bh = bhg / a.G, b = bh / a.H, h = bh % a.H;
  const int r0 = grp * 16, K = min(16, a.K - r0), NS = a.n_split;
  const int64_t part0 = (int64_t)bhg * NS;
  T* out = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh + r0 * a.o_sk;
  for (int e = threadIdx.x; e < K * D; e += kEThreads) {
    const int k = e / D, d = e % D;
    float M = -INFINITY;
    for (int sp = 0; sp < NS; ++sp) M = fmaxf(M, a.part_m[(part0 + sp) * 16 + k]);
    float l = 0.f, acc = 0.f;
    for (int sp = 0; sp < NS; ++sp) {
      const float m = a.part_m[(part0 + sp) * 16 + k];
      if (m == -INFINITY) continue;  // its l and O may be unwritten
      const float sc = expf(m - M);
      l = fmaf(sc, a.part_l[(part0 + sp) * 16 + k], l);
      acc = fmaf(sc, a.part_acc[((part0 + sp) * 16 + k) * D + d], acc);
    }
    out[k * a.o_sk + d] = from_f32<T>(acc / l);
  }
}

template <int D, int LOAD>
cudaError_t launch_cross_i8_mma(const CrossQArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = EMma<D>::kBytes;
  cudaError_t err = allow_smem(cross_i8_split_kernel_mma<D, LOAD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B / a.rpb * a.H, a.n_split, a.G);
  cross_i8_split_kernel_mma<D, LOAD><<<grid, kEThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  cross_i8_merge_kernel<bf16, D><<<B * a.H * a.G, kEThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_cross_i8_tf32(const CrossQArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = ETf32<D>::kBytes;
  cudaError_t err = allow_smem(cross_i8_split_kernel_tf32<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.H, a.n_split, a.G);
  cross_i8_split_kernel_tf32<D><<<grid, kEThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  cross_i8_merge_kernel<float, D><<<B * a.H * a.G, kEThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// Keys per warp tile of E's split passes, both dtypes.
int e_tile(int DH) { return DH <= 64 ? 32 : 16; }

}  // namespace
}  // namespace mm

// C entries: each returns cudaGetLastError() after its launch (0 on success).

// Kernel D's split count for B batch rows of H heads over TS = T.K
// columns: as many (b.h) x split blocks as fit in one wave of four per SM
// (a fifth block on a few SMs would double the pass), each split whole
// steps (multiples of K columns), at most kBSpan columns, at most
// kDMaxSplits.
extern "C" int mm_ancestry_decode_i8_splits(int B, int H, int K, int TS) {
  if (K < 1 || K > mm::kMaxBeams || TS < K) return 1;
  const int T = TS / K, per = mm::kBSpan / K;  // per: most steps in a split
  const int lo = (T + per - 1) / per;
  int n = 4 * mm::kSMs / (B * H);
  n = n > 1 ? n : 1;
  n = n < T ? n : T;
  n = n < mm::kDMaxSplits ? n : mm::kDMaxSplits;
  n = n > lo ? n : lo;
  const int spt = (T + n - 1) / n;
  return (T + spt - 1) / spt;
}

// Kernel F's split count: D's for variants 0-2; variant 3 cuts the TS / 2
// packed rows instead, at most (kBSpan - 4.K) / 2 per split (its w8 table
// holds the steps of both columns of each row).
extern "C" int mm_ancestry_decode_i4_splits(int B, int H, int K, int TS, int variant) {
  if (variant != 3) return mm_ancestry_decode_i8_splits(B, H, K, TS);
  if (K < 1 || K > mm::kMaxBeams || TS < 2) return 1;
  const int P = TS / 2, most = (mm::kBSpan - 4 * K) / 2;
  const int lo = (P + most - 1) / most;
  int n = 4 * mm::kSMs / (B * H);
  n = n > 1 ? n : 1;
  n = n < P ? n : P;
  n = n < mm::kDMaxSplits ? n : mm::kDMaxSplits;
  n = n > lo ? n : lo;
  const int span = (P + n - 1) / n;
  return (P + span - 1) / span;
}

// Bytes of kernel D's scratch: scores (B.H.K.T floats), each split's max and
// sum (2 x B.H.n_split.K floats), with several splits their int32 sums
// (B.H.n_split.K.Dh) and each row's ws and p_self / den (B.H.K.2 floats),
// then the scores' sv (B.H.K.T floats) and each split's live columns
// (B.n_split.(1 + span) ints).
extern "C" long long mm_ancestry_decode_i8_scratch_bytes(int B, int H, int K, int DH, int TS,
                                                         int n_split) {
  const long long bhk = (long long)B * H * K, T = TS / K, span = (T + n_split - 1) / n_split * K;
  long long n = 8 * bhk * T + 8 * bhk * n_split + 4LL * B * n_split * (1 + span);
  if (n_split > 1) n += 4 * bhk * n_split * DH + 8 * bhk;
  return n;
}

// Kernel F's: D's, except that variant 3's live lists hold 1 + 2 x span ints
// (span packed rows, then their high columns' beams) and its softmax
// partials follow D's split count.
extern "C" long long mm_ancestry_decode_i4_scratch_bytes(int B, int H, int K, int DH, int TS,
                                                         int n_split, int variant) {
  if (variant != 3) return mm_ancestry_decode_i8_scratch_bytes(B, H, K, DH, TS, n_split);
  const long long bhk = (long long)B * H * K, T = TS / K;
  const long long span = (TS / 2 + n_split - 1) / n_split;
  const long long n_stat = mm_ancestry_decode_i8_splits(B, H, K, TS);
  long long n = 8 * bhk * T + 8 * bhk * n_stat + 4LL * B * n_split * (1 + 2 * span);
  if (n_split > 1) n += 4 * bhk * n_split * DH + 8 * bhk;
  return n;
}

namespace {

// Kernels D (packed = false) and F, after their entries' checks; probe 0,
// or mm_ancestry_decode_fixed_work's.
int quant_ancestry(bool packed, int probe, int dtype, int variant, const void* q,
                   const void* k_new, const void* v_new, const void* kv, const void* sk,
                   const void* sv, const void* flat_rep, void* out, void* scratch, int B, int H,
                   int K, int DH, int TS, int layer, int n_split, const int64_t* st,
                   void* stream) {
  const bool pair = packed && variant == 3;
  if (K < 1 || K > mm::kMaxBeams || TS < K || TS % K != 0 || (packed && TS % 2 != 0) ||
      variant < 0 || variant > 3 || (!packed && variant == 3 && B % 2 != 0) || n_split < 1 ||
      n_split > mm::kDMaxSplits)
    return (int)cudaErrorInvalidValue;
  const int T = TS / K, P = TS / 2;
  int span;
  if (pair) {
    span = (P + n_split - 1) / n_split;
    if ((P + span - 1) / span != n_split || 2 * span + 4 * K > mm::kBSpan)
      return (int)cudaErrorInvalidValue;
  } else {
    const int spt = (T + n_split - 1) / n_split;
    span = spt * K;
    if ((T + spt - 1) / spt != n_split || span > mm::kBSpan) return (int)cudaErrorInvalidValue;
  }
  const int n_stat = pair ? mm_ancestry_decode_i8_splits(B, H, K, TS) : n_split;
  const int stat_span = pair ? (T + n_stat - 1) / n_stat * K : span;
  const long long bhk = (long long)B * H * K;
  float* sc = static_cast<float*>(scratch);
  float* part_m = sc + bhk * T;
  float* part_l = part_m + bhk * n_stat;
  int* part_acc = reinterpret_cast<int*>(part_l + bhk * n_stat);
  float* row_st = reinterpret_cast<float*>(part_acc + (n_split > 1 ? bhk * n_split * DH : 0));
  float* svs = row_st + (n_split > 1 ? 2 * bhk : 0);
  int* live_g = reinterpret_cast<int*>(svs + bhk * T);
  const mm::I8Args a{q, k_new, v_new, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                     static_cast<const int8_t*>(kv), st[12], st[13], st[14], st[15],
                     static_cast<const float*>(sk), st[16], st[17], st[18],
                     static_cast<const float*>(sv), st[19], st[20], st[21],
                     static_cast<const int*>(flat_rep), out, st[9], st[10], st[11],
                     sc, svs, live_g, part_m, part_l, part_acc, row_st,
                     H, K, TS, T, layer, n_split, span, !packed && variant == 3 ? 2 : 1,
                     n_stat, stat_span, packed ? P : 0, 1 + (pair ? 2 : 1) * span};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (probe != 0) {
    if (dtype != mm::kBFloat16 || variant != 0 || DH != 64) return (int)cudaErrorInvalidValue;
    switch (probe) {
      case 1: return (int)mm::launch_fixed_work<1>(packed, a, B, s);
      case 3: return (int)mm::launch_fixed_work<3>(packed, a, B, s);
      case 7: return (int)mm::launch_fixed_work<7>(packed, a, B, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == mm::kFloat32)
    return (int)mm::dispatch_q_variant<float>(packed, variant, DH, a, B, s);
  if (dtype == mm::kBFloat16)
    return (int)mm::dispatch_q_variant<__nv_bfloat16>(packed, variant, DH, a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Kernel D: the score pass, the output pass and, with several splits, the
// merge on ``stream``; n_split from mm_ancestry_decode_i8_splits, and
// ``scratch`` of mm_ancestry_decode_i8_scratch_bytes. q, k_new, v_new and
// out go through their (b, h, k) strides (head dim dense). ``variant`` (0
// in the port; the others for tools/kernel_ab.py; all give the same bits):
// 0 both products on the s8 tensor cores; 1 the output product on bf16
// ones over converted operands; 2 both on bf16 ones; 3 as 0 with two batch
// rows per block (B even).
extern "C" int mm_ancestry_decode_attention_i8(
    int dtype, int variant, const void* q, const void* k_new, const void* v_new,
    const void* kv, const void* sk, const void* sv, const void* flat_rep, void* out,
    void* scratch, int B, int H, int K, int DH, int TS, int layer, int n_split,
    int64_t q_sb, int64_t q_sh, int64_t q_sk, int64_t kn_sb, int64_t kn_sh, int64_t kn_sk,
    int64_t vn_sb, int64_t vn_sh, int64_t vn_sk, int64_t o_sb, int64_t o_sh, int64_t o_sk,
    int64_t kv_sb, int64_t kv_sl, int64_t kv_sh, int64_t kv_sj,
    int64_t sk_sb, int64_t sk_sl, int64_t sk_sh, int64_t sv_sb, int64_t sv_sl, int64_t sv_sh,
    void* stream) {
  const int64_t st[22] = {q_sb, q_sh, q_sk, kn_sb, kn_sh, kn_sk, vn_sb, vn_sh, vn_sk, o_sb, o_sh,
                          o_sk, kv_sb, kv_sl, kv_sh, kv_sj, sk_sb, sk_sl, sk_sh, sv_sb, sv_sl, sv_sh};
  return quant_ancestry(false, 0, dtype, variant, q, k_new, v_new, kv, sk, sv, flat_rep, out,
                        scratch, B, H, K, DH, TS, layer, n_split, st, stream);
}

// Kernel F: D's entry over the nibble-packed cache (kv (B, L, H, TS / 2,
// 2.Dh); sk, sv and flat_rep by logical column); n_split from
// mm_ancestry_decode_i4_splits, ``scratch`` of
// mm_ancestry_decode_i4_scratch_bytes. ``variant`` (0 in the port; the
// others, at Dh = 64, for tools/kernel_ab.py; all give the same bits): 0
// byte-parallel unpack; 1 the unpack through int32 shifts; 2 both products
// on bf16 tensor cores; 3 the gather by packed row.
extern "C" int mm_ancestry_decode_attention_i4(
    int dtype, int variant, const void* q, const void* k_new, const void* v_new,
    const void* kv, const void* sk, const void* sv, const void* flat_rep, void* out,
    void* scratch, int B, int H, int K, int DH, int TS, int layer, int n_split,
    int64_t q_sb, int64_t q_sh, int64_t q_sk, int64_t kn_sb, int64_t kn_sh, int64_t kn_sk,
    int64_t vn_sb, int64_t vn_sh, int64_t vn_sk, int64_t o_sb, int64_t o_sh, int64_t o_sk,
    int64_t kv_sb, int64_t kv_sl, int64_t kv_sh, int64_t kv_sj,
    int64_t sk_sb, int64_t sk_sl, int64_t sk_sh, int64_t sv_sb, int64_t sv_sl, int64_t sv_sh,
    void* stream) {
  const int64_t st[22] = {q_sb, q_sh, q_sk, kn_sb, kn_sh, kn_sk, vn_sb, vn_sh, vn_sk, o_sb, o_sh,
                          o_sk, kv_sb, kv_sl, kv_sh, kv_sj, sk_sb, sk_sl, sk_sh, sv_sb, sv_sl, sv_sh};
  return quant_ancestry(true, 0, dtype, variant, q, k_new, v_new, kv, sk, sv, flat_rep, out,
                        scratch, B, H, K, DH, TS, layer, n_split, st, stream);
}

// tools/kernel_ab.py --fixed-work: D's (packed = 0) or F's (packed = 1)
// v0 passes, bf16, Dh = 64, with parts left out to time the per-block work
// that does not scale with the tiles (the output is not valid): probe 1 no
// tiles, 3 no compaction either, 7 no ws and w8 table either. The other
// arguments as mm_ancestry_decode_attention_i8's (i4's) after ``variant``.
extern "C" int mm_ancestry_decode_fixed_work(
    int packed, int probe, const void* q, const void* k_new, const void* v_new,
    const void* kv, const void* sk, const void* sv, const void* flat_rep, void* out,
    void* scratch, int B, int H, int K, int DH, int TS, int layer, int n_split,
    int64_t q_sb, int64_t q_sh, int64_t q_sk, int64_t kn_sb, int64_t kn_sh, int64_t kn_sk,
    int64_t vn_sb, int64_t vn_sh, int64_t vn_sk, int64_t o_sb, int64_t o_sh, int64_t o_sk,
    int64_t kv_sb, int64_t kv_sl, int64_t kv_sh, int64_t kv_sj,
    int64_t sk_sb, int64_t sk_sl, int64_t sk_sh, int64_t sv_sb, int64_t sv_sl, int64_t sv_sh,
    void* stream) {
  if (probe == 0) return (int)cudaErrorInvalidValue;
  const int64_t st[22] = {q_sb, q_sh, q_sk, kn_sb, kn_sh, kn_sk, vn_sb, vn_sh, vn_sk, o_sb, o_sh,
                          o_sk, kv_sb, kv_sl, kv_sh, kv_sj, sk_sb, sk_sl, sk_sh, sv_sb, sv_sl, sv_sh};
  return quant_ancestry(packed != 0, probe, mm::kBFloat16, 0, q, k_new, v_new, kv, sk, sv,
                        flat_rep, out, scratch, B, H, K, DH, TS, layer, n_split, st, stream);
}

// Kernel E's split count for B batch rows of H heads, K rows (groups of 16)
// over S columns, the same in both dtypes (their key tiles are alike): one
// split where the (b.h, group) blocks fill a wave, else enough splits for
// about two blocks per SM, each a whole number of key tiles, at most
// kEMaxSplits.
extern "C" int mm_cross_decode_i8_splits(int B, int H, int K, int S, int DH) {
  if (S < 1 || B * H < 1 || K < 1) return 1;
  const int n_tiles = (S + mm::e_tile(DH) - 1) / mm::e_tile(DH);
  const int blocks = B * H * ((K + 15) / 16);
  if (blocks >= mm::kSMs) return 1;  // a wave already: a split would only add a merge
  int n = (2 * mm::kSMs + blocks - 1) / blocks;
  n = n < n_tiles ? n : n_tiles;
  n = n < mm::kEMaxSplits ? n : mm::kEMaxSplits;
  const int tps = (n_tiles + n - 1) / n;
  return (n_tiles + tps - 1) / tps;
}

// Kernel E on ``stream``: the split pass, then with several splits the
// merge; ``scratch`` holds (B.H.G.n_split.16) maxima, as many denominators
// and (B.H.G.n_split.16.Dh) partial sums, fp32, G = ceil(K / 16), with
// n_split from mm_cross_decode_i8_splits. q and out go through their
// (b, h, k) strides (head dim dense); kv, sk, sv and bias are contiguous.
// ``variant`` (bf16; 0 in the port, 1 for tools/kernel_ab.py): 1 two batch
// rows per block, in turn (B even).
extern "C" int mm_cross_decode_attention_i8(
    int dtype, int variant, const void* q, const void* kv, const void* sk, const void* sv,
    const void* bias, void* out, void* scratch, int B, int H, int K, int DH, int S, int n_split,
    int64_t q_sb, int64_t q_sh, int64_t q_sk, int64_t o_sb, int64_t o_sh, int64_t o_sk,
    void* stream) {
  const bool f32 = dtype == mm::kFloat32;
  if (K < 1 || S < 1 || (!f32 && dtype != mm::kBFloat16) || variant < 0 || variant > 1 ||
      (variant == 1 && (B % 2 || f32)) || n_split != mm_cross_decode_i8_splits(B, H, K, S, DH))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  const int G = (K + 15) / 16;
  const int64_t n_part = (int64_t)B * H * G * n_split * 16;
  const int n_tiles = (S + mm::e_tile(DH) - 1) / mm::e_tile(DH);
  const mm::CrossQArgs a{q, q_sb, q_sh, q_sk, static_cast<const int8_t*>(kv),
                         static_cast<const float*>(sk), static_cast<const float*>(sv),
                         static_cast<const float*>(bias), out, o_sb, o_sh, o_sk,
                         part, part + n_part, part + 2 * n_part, H, K, S, G, n_split,
                         (n_tiles + n_split - 1) / n_split, variant == 1 ? 2 : 1};
  if (f32) {
    switch (DH) {
      case 16: return (int)mm::launch_cross_i8_tf32<16>(a, B, st);
      case 32: return (int)mm::launch_cross_i8_tf32<32>(a, B, st);
      case 64: return (int)mm::launch_cross_i8_tf32<64>(a, B, st);
      case 128: return (int)mm::launch_cross_i8_tf32<128>(a, B, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (DH) {
    case 16: return (int)mm::launch_cross_i8_mma<16, mm::kE>(a, B, st);
    case 32: return (int)mm::launch_cross_i8_mma<32, mm::kE>(a, B, st);
    case 64: return (int)mm::launch_cross_i8_mma<64, mm::kE>(a, B, st);
    case 128: return (int)mm::launch_cross_i8_mma<128, mm::kE>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dense probe (tools/kernel_ab.py; the port of
// scripts_dev/int4_support_probe.py:73's _attnish): softmax(q.k).v over
// every column of a (B, H, S, 2.Dh) int8 slab (packed = 0) or of the same
// values nibble-packed, (B, H, S / 2, 2.Dh) (packed = 1), bf16 products, no
// scales or bias; E's split pass with another load, bf16, Dh = 64. n_split
// and scratch as E's.
extern "C" int mm_dense_attention_probe(int packed, const void* q, const void* kv, void* out,
                                        void* scratch, int B, int H, int K, int DH, int S,
                                        int n_split, int64_t q_sb, int64_t q_sh, int64_t q_sk,
                                        int64_t o_sb, int64_t o_sh, int64_t o_sk, void* stream) {
  if (K < 1 || S < 2 || DH != 64 || (packed && S % 2) ||
      n_split != mm_cross_decode_i8_splits(B, H, K, S, DH))
    return (int)cudaErrorInvalidValue;
  float* part = static_cast<float*>(scratch);
  const int G = (K + 15) / 16;
  const int64_t n_part = (int64_t)B * H * G * n_split * 16;
  const int n_tiles = (S + mm::e_tile(DH) - 1) / mm::e_tile(DH);
  const mm::CrossQArgs a{q, q_sb, q_sh, q_sk, static_cast<const int8_t*>(kv), nullptr, nullptr,
                         nullptr, out, o_sb, o_sh, o_sk, part, part + n_part, part + 2 * n_part,
                         H, K, S, G, n_split, (n_tiles + n_split - 1) / n_split, 1};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return packed ? (int)mm::launch_cross_i8_mma<64, mm::kDense4>(a, B, st)
                : (int)mm::launch_cross_i8_mma<64, mm::kDense8>(a, B, st);
}
