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
// flat_rep, sk and sv use logical column ids, so F computes D's math with
// another load (on D's former grid until its own redesign).
//
// Kernel E replaces mm_s2ut/ops/decode_attention.py:_kernel_cross_i8
// (pallas_call at :577, launched by cross_decode_attention_i8, reached from
// models/layers.py:273-276): kernel C over an int8 encoder slab. k8 converts
// exactly to float, the scores are (q.k8).sk + bias, the softmax weights are
// (p/sum).sv, and out = sum w.v8.
//
// What bounds them on the card: like B and C, bytes and latency, not
// arithmetic (K <= 16 queries per head against a 2.Dh-byte row per column).
// The int8 cache halves B's bytes and int4 quarters them.
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
// Design of F: the grid (B, H) that D had before, warps striding over
// 32-column chunks of the T.S axis with a ballot over coalesced flat_rep
// reads, so only on-path columns are read, each once for all the beams on
// it. Pass 1 reads the K halves and keeps each beam's on-path scores in
// shared memory (K.T floats plus one slot byte each); between the passes
// one warp per beam takes the row max, the denominator and ws from shared
// memory; pass 2 reads the V halves, recomputes each w_eff with the same
// expression, and accumulates w8.v8 in int32 registers, merged across
// warps with shared-memory integer atomics (exact in any order). At step 0
// the output is exactly v_new.
//
// Design of E: kernel C's SIMT design (grid (B.H, ceil(K/16)), a block's
// <= 16 rows of scores in shared memory for a two-pass softmax, one thread
// per output dim in the V pass; any row count, as the prefill's P rows),
// with the scales folded where the reference folds them and each thread's
// K row read in 16-byte chunks.
#include "decode_attention.cuh"

namespace mm {
namespace {

using namespace tc;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_sum_int(int v) { return __reduce_add_sync(kFull, v); }

// ---------------------------------------------------------------- kernel F

struct QuantAncestryArgs {
  const void* q;        // (B, H, K, Dh) contiguous, pre-scaled
  const void* k_new;    // (B, H, K, Dh) contiguous
  const void* v_new;    // (B, H, K, Dh) contiguous
  const int8_t* kv;     // (B, L, H, rows, 2.Dh) through strides, last dim dense;
                        // rows = TS/2 (nibble-packed)
  const float* sk;      // (B, L, H, TS) through strides, last dim dense
  const float* sv;      // (B, L, H, TS) through strides, last dim dense
  const int* flat_rep;  // (B, K, TS) contiguous
  void* out;            // (B, H, K, Dh) contiguous
  int H, K, TS, layer;
  int64_t kv_sb, kv_sl, kv_sh, kv_sj;
  int64_t sk_sb, sk_sl, sk_sh;
  int64_t sv_sb, sv_sl, sv_sh;
};

// Element e (< 2.Dh) of logical column j of the packed slab, as a signed integer.
__device__ __forceinline__ int load_col(const int8_t* slab, int64_t sj, int P, int j, int e) {
  const bool high = j >= P;
  const int x = slab[(int64_t)(high ? j - P : j) * sj + e];
  return high ? (x >> 4) : (((x & 0xF) ^ 8) - 8);  // sign-extended nibble
}

// Static shared memory of the F kernel besides the dynamic score area.
template <int DH>
struct QuantShared {
  float qs[kMaxBeams], sl[kMaxBeams], m[kMaxBeams], den[kMaxBeams], pself[kMaxBeams],
      ws[kMaxBeams];
  int acc[kMaxBeams][DH];
};

template <typename T, int DH, int NW>
__global__ void __launch_bounds__(NW * 32) ancestry_decode_q_kernel(const QuantAncestryArgs a) {
  constexpr int E = (DH + 31) / 32;  // dims per lane
  constexpr int NT = NW * 32;
  extern __shared__ float dyn[];
  __shared__ QuantShared<DH> sh;

  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int K = a.K, TS = a.TS, Tn = TS / K, P = TS / 2;
  float* sc = dyn;                                              // [K][Tn] scores
  uint8_t* slot = reinterpret_cast<uint8_t*>(dyn + K * Tn);     // [K][Tn] column - t.K
  const int64_t bh = (int64_t)b * a.H + h;
  const T* q = static_cast<const T*>(a.q) + bh * K * DH;
  const T* kn = static_cast<const T*>(a.k_new) + bh * K * DH;
  const T* vn = static_cast<const T*>(a.v_new) + bh * K * DH;
  const int8_t* slab = a.kv + b * a.kv_sb + (int64_t)a.layer * a.kv_sl + h * a.kv_sh;
  const float* skp = a.sk + b * a.sk_sb + (int64_t)a.layer * a.sk_sl + h * a.sk_sh;
  const float* svp = a.sv + b * a.sv_sb + (int64_t)a.layer * a.sv_sl + h * a.sv_sh;
  const int* fr = a.flat_rep + (int64_t)b * K * TS;

  for (int i = threadIdx.x; i < K * Tn; i += NT) sc[i] = -INFINITY;  // no on-path column
  for (int i = threadIdx.x; i < K * DH; i += NT) sh.acc[i / DH][i % DH] = 0;

  // Row scale qs and the full-precision self logit of each beam.
  for (int k = warp; k < K; k += NW) {
    float amax = 0.f, s = 0.f;
    for (int d = lane; d < DH; d += 32) {
      const float x = to_f32(q[k * DH + d]);
      amax = fmaxf(amax, fabsf(x));
      s = fmaf(x, to_f32(kn[k * DH + d]), s);
    }
    amax = warp_max(amax);
    s = warp_sum(s);
    if (lane == 0) {
      sh.qs[k] = amax / 127.0f + 1e-20f;
      sh.sl[k] = s;
    }
  }
  __syncthreads();

  // Pass 1: integer scores of the on-path columns into shared memory.
  {
    int q8[kMaxBeams][E];
#pragma unroll
    for (int k = 0; k < kMaxBeams; ++k) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = lane * E + e;
        q8[k][e] = (k < K && d < DH) ? (int)rintf(to_f32(q[k * DH + d]) / sh.qs[k]) : 0;
      }
    }
    for (int j0 = warp * 32; j0 < TS; j0 += NT) {
      const int j = j0 + lane;
      unsigned beams = 0;  // bit k: column j is on beam k's path
      if (j < TS)
        for (int k = 0; k < K; ++k) beams |= (unsigned)(fr[(int64_t)k * TS + j] == j) << k;
      unsigned live = __ballot_sync(kFull, beams != 0);
      while (live) {
        const int c = __ffs(live) - 1;
        live &= live - 1;
        const unsigned on = __shfl_sync(kFull, beams, c);
        const int jj = j0 + c, t = jj / K;
        int kr[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = lane * E + e;
          kr[e] = d < DH ? load_col(slab, a.kv_sj, P, jj, d) : 0;
        }
        const float skj = skp[jj];
#pragma unroll
        for (int k = 0; k < kMaxBeams; ++k) {
          if (!((on >> k) & 1u)) continue;  // warp-uniform
          int s = 0;
#pragma unroll
          for (int e = 0; e < E; ++e) s += q8[k][e] * kr[e];
          s = warp_sum_int(s);
          if (lane == 0) {
            sc[k * Tn + t] = __fmul_rn(__fmul_rn((float)s, sh.qs[k]), skj);
            slot[k * Tn + t] = (uint8_t)(jj - t * K);
          }
        }
      }
    }
  }
  __syncthreads();

  // Row max, denominator (with the self term) and requant scale, per beam.
  for (int k = warp; k < K; k += NW) {
    const float* sck = sc + k * Tn;
    float m = -INFINITY;
    for (int t = lane; t < Tn; t += 32) m = fmaxf(m, sck[t]);
    m = fmaxf(warp_max(m), sh.sl[k]);
    float sum = 0.f;
    for (int t = lane; t < Tn; t += 32)
      if (sck[t] != -INFINITY) sum += expf(sck[t] - m);
    sum = warp_sum(sum);
    const float p_self = expf(sh.sl[k] - m);
    const float den = sum + p_self;
    float wmax = 0.f;
    for (int t = lane; t < Tn; t += 32) {
      if (sck[t] == -INFINITY) continue;
      const int jj = t * K + slot[k * Tn + t];
      wmax = fmaxf(wmax, __fmul_rn(expf(sck[t] - m) / den, svp[jj]));
    }
    wmax = warp_max(wmax);
    if (lane == 0) {
      sh.m[k] = m;
      sh.den[k] = den;
      sh.pself[k] = p_self;
      sh.ws[k] = wmax / 127.0f + 1e-20f;
    }
  }
  __syncthreads();

  // Pass 2: requantized weights times the V halves, in int32.
  {
    int acc[kMaxBeams][E];
#pragma unroll
    for (int k = 0; k < kMaxBeams; ++k)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[k][e] = 0;
    for (int j0 = warp * 32; j0 < TS; j0 += NT) {
      const int j = j0 + lane;
      unsigned beams = 0;
      if (j < TS)
        for (int k = 0; k < K; ++k) beams |= (unsigned)(fr[(int64_t)k * TS + j] == j) << k;
      unsigned live = __ballot_sync(kFull, beams != 0);
      while (live) {
        const int c = __ffs(live) - 1;
        live &= live - 1;
        const unsigned on = __shfl_sync(kFull, beams, c);
        const int jj = j0 + c, t = jj / K;
        int vr[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = lane * E + e;
          vr[e] = d < DH ? load_col(slab, a.kv_sj, P, jj, DH + d) : 0;
        }
        const float svj = svp[jj];
#pragma unroll
        for (int k = 0; k < kMaxBeams; ++k) {
          if (!((on >> k) & 1u)) continue;  // warp-uniform
          const float w_eff = __fmul_rn(expf(sc[k * Tn + t] - sh.m[k]) / sh.den[k], svj);
          const int w8 = (int)rintf(w_eff / sh.ws[k]);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[k][e] += w8 * vr[e];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxBeams; ++k) {
      if (k >= K) break;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = lane * E + e;
        if (d < DH && acc[k][e] != 0) atomicAdd(&sh.acc[k][d], acc[k][e]);
      }
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(a.out) + bh * K * DH;
  for (int i = threadIdx.x; i < K * DH; i += NT) {
    const int k = i / DH, d = i % DH;
    const float hist = __fmul_rn((float)sh.acc[k][d], sh.ws[k]);
    const float self = __fmul_rn(sh.pself[k] / sh.den[k], to_f32(vn[i]));
    out[i] = from_f32<T>(__fadd_rn(hist, self));
  }
}

// Dynamic shared memory of the F kernel: K.T scores and K.T slot bytes.
size_t quant_dyn_bytes(int K, int Tn) {
  const size_t n = (size_t)K * Tn;
  return n * sizeof(float) + ((n + 3) / 4) * 4;
}

template <typename T, int DH>
cudaError_t launch_quant_ancestry(const QuantAncestryArgs& a, int B, cudaStream_t stream) {
  constexpr int NW = 8;
  const size_t smem = quant_dyn_bytes(a.K, a.TS / a.K);
  auto kernel = ancestry_decode_q_kernel<T, DH, NW>;
  if (smem + sizeof(QuantShared<DH>) > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(B, a.H), NW * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_quant_ancestry(int DH, const QuantAncestryArgs& a, int B,
                                    cudaStream_t stream) {
  switch (DH) {
    case 16: return launch_quant_ancestry<T, 16>(a, B, stream);
    case 32: return launch_quant_ancestry<T, 32>(a, B, stream);
    case 64: return launch_quant_ancestry<T, 64>(a, B, stream);
    case 128: return launch_quant_ancestry<T, 128>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- kernel D

constexpr int kDThreads = 128;   // 4 warps, each with its own tiles
constexpr int kDTile = 32;       // live columns per warp tile: one k-step of the s8 output product
constexpr int kDMaxSplits = 64;

struct I8Args {
  const void* q;       // (B, H, K, Dh) through strides, pre-scaled
  const void* k_new;   // (B, H, K, Dh) through strides
  const void* v_new;   // (B, H, K, Dh) through strides
  int64_t q_sb, q_sh, q_sk, kn_sb, kn_sh, kn_sk, vn_sb, vn_sh, vn_sk;
  const int8_t* kv;    // (B, L, H, TS, 2.Dh) through strides, rows 16-byte aligned
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
  int* live_g;         // (B, n_split, 1 + span) each split's live column count, then the
                       // columns (compact_live's format), from the score pass's head-0 blocks
  float* part_m;       // (B.H, n_split, K) each split's score max, -inf if it saw none
  float* part_l;       // (B.H, n_split, K) its sum of exp(score - max)
  int* part_acc;       // (B.H, n_split, K, Dh) its sum of w8.v8 (n_split > 1)
  float* row_st;       // (B.H, K, 2) ws and p_self / den of each row (n_split > 1)
  int H, K, TS, T, layer, n_split, span, rpb;  // span: columns per split, a multiple of K;
                                               // rpb: batch rows per block
};

// Shared memory of D's passes. A staged K (or V) half row is padded to
// kRow bytes, so that the 8 rows of one 32-bit fragment load hit distinct
// banks; a stage holds kDTile such rows and, in the score pass, their
// kDTile sk and sv. The V tile is transposed into kTRow-byte rows, one per
// head dim. The block's int32 merge of pass 2 goes over the drained rings;
// its w8 table (K.nt <= kBSpan bytes) follows the compaction's counts.
template <int DH>
struct DSh {
  static constexpr int kRow = (DH < 32 ? 32 : DH) + 16;
  static constexpr int kTRow = kDTile + 16;
  static constexpr int kStage = kDTile * kRow + 2 * kDTile * 4;
  static constexpr int kRing = 0;                        // 4 warps x 2 stages
  static constexpr int kVt = kRing + 4 * 2 * kStage;     // 4 warps x DH x kTRow
  static constexpr int kQ = kVt + 4 * DH * kTRow;        // q8, 16 rows x kRow
  static constexpr int kRowSt = kQ + 16 * kRow;          // per-row values: 160 floats
  static constexpr int kLive = kRowSt + 160 * 4;
  static constexpr int kCount = kLive + kBSpan * 4;
  static constexpr int kW8 = kCount + 4 * 4 * 4;
  static constexpr int kBytes = kW8 + kBSpan;
  static_assert(4 * 16 * DH * 4 <= kVt - kRing, "the merge fits over the rings");
  static_assert(kStage % 16 == 0 && kVt % 16 == 0 && kQ % 16 == 0, "16-byte aligned tiles");
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
// (half = 1) half, and its ``scale`` and ``scale2`` where given, into the
// warp's stage; rows past n_live zeros.
template <int DH>
__device__ __forceinline__ void d_gather(uint32_t dst, const int8_t* slab, int64_t sj,
                                         const float* scale, const float* scale2,
                                         const uint32_t* live, int c0, int n_live, int i,
                                         int half) {
  using C = DSh<DH>;
  constexpr int CH = DH / 16;
  const int lane = threadIdx.x & 31;
  const int r0 = i * kDTile, n = min(kDTile, n_live - r0);
  for (int e = lane; e < kDTile * CH; e += 32) {
    const int r = e / CH, c = e % CH;
    const bool ok = r < n;
    const int col = c0 + (ok ? (int)(live[r0 + r] & 0xFFFFu) : 0);
    cp_async16(dst + r * C::kRow + c * 16, slab + (int64_t)col * sj + half * DH + c * 16, ok);
  }
  const bool ok = lane < n;
  const int col = c0 + (ok ? (int)(live[r0 + lane] & 0xFFFFu) : 0);
  if (scale) cp_async4(dst + kDTile * C::kRow + lane * 4, scale + col, ok);
  if (scale2) cp_async4(dst + kDTile * C::kRow + (kDTile + lane) * 4, scale2 + col, ok);
}

// Pass 1: block (batch row group x head, split). Per batch row: q quantized
// (q8 = rint(q / qs), qs = max|q| / 127 + 1e-20) into shared memory, the
// split's score entries set to -inf, its live columns compacted (and, in
// the head-0 block, left in scratch for pass 2); then warp w takes live
// tiles w, w + 4, ...: s32 = q8.k8 with the K beams as mma rows (exact, on
// the s8 tensor cores, or with SC8 = false on bf16 ones over exactly
// converted operands), score = (s32 . qs) . sk in fp32, each on-path
// (beam, column) score and sv stored to scratch at (beam, step). Last, one
// warp per beam takes the split's (max, sum of exp) from its stored
// scores, lanes over the steps in a fixed order.
template <typename T, int DH, bool SC8>
__global__ void __launch_bounds__(kDThreads) ancestry_i8_score_kernel(const I8Args a) {
  using C = DSh<DH>;
  extern __shared__ __align__(128) unsigned char d_smem[];
  uint32_t* live = reinterpret_cast<uint32_t*>(d_smem + C::kLive);
  float* qs_sm = reinterpret_cast<float*>(d_smem + C::kRowSt);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int K = a.K, h = blockIdx.x % a.H, split = blockIdx.y;
  const int c0 = split * a.span, c1 = min(a.TS, c0 + a.span);
  const int t0 = c0 / K, nt = (c1 - c0) / K;
  const uint32_t kmag = (65536u + K - 1) / K;  // step of column offset o < 2^11: (o . kmag) >> 16
  const uint32_t ring = smem_u32(d_smem + C::kRing) + warp * 2 * C::kStage;
  const unsigned char* q8 = d_smem + C::kQ;

  for (int rb = 0; rb < a.rpb; ++rb) {
    const int b = (blockIdx.x / a.H) * a.rpb + rb;
    const int64_t bh = (int64_t)b * a.H + h;
    float* sc = a.sc + bh * K * a.T;
    float* svs = a.svs + bh * K * a.T;
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
    const int n_live = compact_live<kDThreads, 4>(a.flat_rep + (int64_t)b * K * a.TS, K, a.TS, c0,
                                                  c1, live, reinterpret_cast<int*>(d_smem + C::kCount));
    if (h == 0) {  // the output pass of every head of b reads these
      int* lg = a.live_g + ((int64_t)b * a.n_split + split) * (a.span + 1);
      for (int e = threadIdx.x; e <= n_live; e += kDThreads)
        lg[e] = e == 0 ? n_live : (int)live[e - 1];
    }
    const int n_tiles = (n_live + kDTile - 1) / kDTile;
    const int8_t* slab = a.kv + b * a.kv_sb + (int64_t)a.layer * a.kv_sl + h * a.kv_sh;
    const float* skp = a.sk + b * a.sk_sb + (int64_t)a.layer * a.sk_sl + h * a.sk_sh;
    const float* svp = a.sv + b * a.sv_sb + (int64_t)a.layer * a.sv_sl + h * a.sv_sh;

    int i = warp;
    if (i < n_tiles) {
      d_gather<DH>(ring, slab, a.kv_sj, skp, svp, live, c0, n_live, i, 0);
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
        d_gather<DH>(ring + (stage ^ 1) * C::kStage, slab, a.kv_sj, skp, svp, live, c0, n_live,
                     i + 4, 0);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      const unsigned char* kt = d_smem + C::kRing + (warp * 2 + stage) * C::kStage;
      const float* skt = reinterpret_cast<const float*>(kt + kDTile * C::kRow);
      const float* svt = skt + kDTile;
      const int r0 = i * kDTile, n_in = min(kDTile, n_live - r0);
      // s32[n][e]: beam g + 8 (e >> 1), tile column 8 n + 2 tq + (e & 1).
      int s32[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const unsigned char* krow = kt + (8 * n + g) * C::kRow;
        if constexpr (SC8) {
          int acc[4] = {0, 0, 0, 0};
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            const int o = 32 * kk + 4 * tq;
            mma_s8(acc, qf[kk], *reinterpret_cast<const uint32_t*>(krow + o),
                   DH >= 32 ? *reinterpret_cast<const uint32_t*>(krow + o + 16) : 0u);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) s32[n][e] = acc[e];
        } else {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            const int o = 16 * kk + 2 * tq;
            mma(acc, qf[kk], i8x2_bf16x2(*reinterpret_cast<const uint16_t*>(krow + o)),
                i8x2_bf16x2(*reinterpret_cast<const uint16_t*>(krow + o + 8)));
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) s32[n][e] = (int)acc[e];  // exact: |s| <= 128 . 127^2 < 2^24
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int c = 8 * n + 2 * tq + e1;
          const uint32_t col = c < n_in ? live[r0 + c] : 0u;
          const int t = t0 + (int)(((col & 0xFFFFu) * kmag) >> 16);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int beam = g + 8 * r;
            if ((col >> (16 + beam)) & 1u) {
              sc[beam * a.T + t] = __fmul_rn(__fmul_rn((float)s32[n][2 * r + e1], qs_r[r]), skt[c]);
              svs[beam * a.T + t] = svt[c];
            }
          }
        }
      }
      __syncwarp();  // the stage is refilled by the next iteration's gather
    }
    __syncthreads();  // the block's scores are in scratch
    {  // beams warp, warp + 4, ... together, so that their loads overlap
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
          a.part_m[(bh * a.n_split + split) * K + k] = mk[kk];
          a.part_l[(bh * a.n_split + split) * K + k] = l;
        }
      }
    }
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
// halves, transposes each into dim-major rows, reads the w8 of the
// (beam, column) elements it holds from the table, and adds w8.v8 in
// int32: on the s8 tensor cores, or (OUT8 = false) on bf16 ones over
// exactly converted operands, each 32-column tile's fp32 sums turned to
// int32 (exact: <= 32 . 127^2 < 2^24). The warps' int32 sums merge exactly
// in shared memory; with one split the block writes out = float(sum) . ws
// + (p_self / den) . v_new, else the split's int32 partial, which the
// merge kernel adds.
template <typename T, int DH, bool OUT8>
__global__ void __launch_bounds__(kDThreads) ancestry_i8_out_kernel(const I8Args a) {
  using C = DSh<DH>;
  constexpr int NT = DH / 8;  // n-tiles of the output row
  extern __shared__ __align__(128) unsigned char d_smem[];
  uint32_t* live = reinterpret_cast<uint32_t*>(d_smem + C::kLive);
  int8_t* w8s = reinterpret_cast<int8_t*>(d_smem + C::kW8);  // [K][nt]
  float* st_m = reinterpret_cast<float*>(d_smem + C::kRowSt);
  float* st_den = st_m + 16;
  float* st_ws = st_den + 16;
  float* st_ps = st_ws + 16;
  float* ws_part = st_ps + 16;  // [4 warps][16]
  int* merge = reinterpret_cast<int*>(d_smem + C::kRing);  // [4 warps][16][DH], after the tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int K = a.K, h = blockIdx.x % a.H, split = blockIdx.y;
  const int c0 = split * a.span;
  const int t0 = c0 / K, nt = (min(a.TS, c0 + a.span) - c0) / K;
  const uint32_t kmag = (65536u + K - 1) / K;
  const uint32_t ring = smem_u32(d_smem + C::kRing) + warp * 2 * C::kStage;
  unsigned char* vt = d_smem + C::kVt + warp * DH * C::kTRow;

  for (int rb = 0; rb < a.rpb; ++rb) {
    const int b = (blockIdx.x / a.H) * a.rpb + rb;
    const int64_t bh = (int64_t)b * a.H + h;
    const float* sc = a.sc + bh * K * a.T;
    const float* svs = a.svs + bh * K * a.T;
    const int* lg = a.live_g + ((int64_t)b * a.n_split + split) * (a.span + 1);
    const int n_live = lg[0];
    for (int e = threadIdx.x; e < n_live; e += kDThreads) live[e] = (uint32_t)lg[1 + e];
    __syncthreads();
    const int n_tiles = (n_live + kDTile - 1) / kDTile;
    const int8_t* slab = a.kv + b * a.kv_sb + (int64_t)a.layer * a.kv_sl + h * a.kv_sh;
    int i = warp;
    if (i < n_tiles) {  // in flight while the row's statistics are formed
      d_gather<DH>(ring, slab, a.kv_sj, nullptr, nullptr, live, c0, n_live, i, 1);
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
          const int64_t at = (bh * a.n_split + lane + 32 * u) * K + k;
          const bool ok = k < K && lane + 32 * u < a.n_split;
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
    {  // ws: each thread's steps of every beam, then the beams' maxima over the block
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
    {  // K.nt <= kBSpan entries: every load in flight before the first w8
      constexpr int WE = kBSpan / kDThreads;
      float xv[WE], vv[WE];
#pragma unroll
      for (int u = 0; u < WE; ++u) {
        const int e = threadIdx.x + kDThreads * u, k = e / nt, t = t0 + e - k * nt;
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
        d_gather<DH>(ring + (stage ^ 1) * C::kStage, slab, a.kv_sj, nullptr, nullptr, live, c0,
                     n_live, i + 4, 1);
        cp_async_commit();
      }
      // The w8 of this tile's (beam, column) elements, while the V rows land.
      const int r0 = i * kDTile, n_in = min(kDTile, n_live - r0);
      int w8[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int c = 8 * n + 2 * tq + e1;
          const uint32_t col = c < n_in ? live[r0 + c] : 0u;
          const int t = (int)(((col & 0xFFFFu) * kmag) >> 16);  // the step within the split
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int beam = g + 8 * r;
            w8[n][2 * r + e1] = (col >> (16 + beam)) & 1u ? (int)w8s[beam * nt + t] : 0;
          }
        }
      }
      if (i + 4 < n_tiles) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncwarp();
      const unsigned char* vr = d_smem + C::kRing + (warp * 2 + stage) * C::kStage;
      // Transpose the V tile: 4 x 4 byte blocks, column c of dim d to vt[d][pi(c)].
      for (int u = lane; u < 2 * DH; u += 32) {
        const int rb4 = u & 7, db = u >> 3;  // columns 4 rb4.., dims 4 db..
        const unsigned char* src = vr + 4 * rb4 * C::kRow + 4 * db;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(src);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(src + C::kRow);
        const uint32_t w2 = *reinterpret_cast<const uint32_t*>(src + 2 * C::kRow);
        const uint32_t w3 = *reinterpret_cast<const uint32_t*>(src + 3 * C::kRow);
        const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), hi01 = __byte_perm(w0, w1, 0x7362);
        const uint32_t lo23 = __byte_perm(w2, w3, 0x5140), hi23 = __byte_perm(w2, w3, 0x7362);
        const uint32_t col4[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                                  __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
        const int p0 = d_pi(4 * rb4);  // columns 4 rb4, +1 at p0, p0 + 1; +2, +3 at p0 + 4, p0 + 5
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          unsigned char* dst = vt + (4 * db + e) * C::kTRow + p0;
          *reinterpret_cast<uint16_t*>(dst) = (uint16_t)(col4[e] & 0xFFFFu);
          *reinterpret_cast<uint16_t*>(dst + 4) = (uint16_t)(col4[e] >> 16);
        }
      }
      __syncwarp();  // vt is written
      if constexpr (OUT8) {
        // A (16 beams x 32 columns in pi order): reg 0 = row g, columns
        // 2tq, 2tq+1, 8+2tq, 9+2tq (n-tiles 0, 1); reg 2 the same of n-tiles 2, 3.
        const uint32_t wa[4] = {pack_i8x4(w8[0][0], w8[0][1], w8[1][0], w8[1][1]),
                                pack_i8x4(w8[0][2], w8[0][3], w8[1][2], w8[1][3]),
                                pack_i8x4(w8[2][0], w8[2][1], w8[3][0], w8[3][1]),
                                pack_i8x4(w8[2][2], w8[2][3], w8[3][2], w8[3][3])};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const unsigned char* vrow = vt + (8 * n + g) * C::kTRow + 4 * tq;
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
            const uint32_t v = *reinterpret_cast<const uint32_t*>(vt + (8 * n + g) * C::kTRow +
                                                                  16 * kk + 4 * tq);
            mma(f[n], wa, i8x2_bf16x2(v & 0xFFFFu), i8x2_bf16x2(v >> 16));
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += (int)f[n][e];
      }
      __syncwarp();  // the stage and vt are rewritten by the next tile
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
template <typename T, int DH>
__global__ void __launch_bounds__(kDThreads) ancestry_i8_merge_kernel(const I8Args a) {
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

template <typename T, int DH, bool SC8, bool OUT8>
cudaError_t launch_i8(const I8Args& a, int B, cudaStream_t stream) {
  constexpr int smem = DSh<DH>::kBytes;
  const dim3 grid(B / a.rpb * a.H, a.n_split);
  cudaError_t err = allow_smem(ancestry_i8_score_kernel<T, DH, SC8>, smem);
  if (err == cudaSuccess) err = allow_smem(ancestry_i8_out_kernel<T, DH, OUT8>, smem);
  if (err != cudaSuccess) return err;
  ancestry_i8_score_kernel<T, DH, SC8><<<grid, kDThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ancestry_i8_out_kernel<T, DH, OUT8><<<grid, kDThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  ancestry_i8_merge_kernel<T, DH><<<B * a.H, kDThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool SC8, bool OUT8>
cudaError_t dispatch_i8(int DH, const I8Args& a, int B, cudaStream_t stream) {
  switch (DH) {
    case 16: return launch_i8<T, 16, SC8, OUT8>(a, B, stream);
    case 32: return launch_i8<T, 32, SC8, OUT8>(a, B, stream);
    case 64: return launch_i8<T, 64, SC8, OUT8>(a, B, stream);
    case 128: return launch_i8<T, 128, SC8, OUT8>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_i8_variant(int variant, int DH, const I8Args& a, int B, cudaStream_t stream) {
  switch (variant) {
    case 1: return dispatch_i8<T, true, false>(DH, a, B, stream);
    case 2: return dispatch_i8<T, false, false>(DH, a, B, stream);
    default: return dispatch_i8<T, true, true>(DH, a, B, stream);  // 0 and 3 (rpb 2)
  }
}

// ---------------------------------------------------------------- kernel E

constexpr int kCrossThreadsQ = 256;

struct CrossQArgs {
  const void* q;      // (B, H, K, Dh) contiguous, pre-scaled
  const int8_t* kv;   // (B, H, S, 2.Dh) contiguous
  const float* sk;    // (B, H, S) contiguous
  const float* sv;    // (B, H, S) contiguous
  const float* bias;  // (B, S) additive
  void* out;          // (B, H, K, Dh) contiguous
  int H, K, S;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kCrossThreadsQ) cross_decode_i8_kernel(const CrossQArgs a) {
  extern __shared__ float smem[];
  constexpr int NW = kCrossThreadsQ / 32;
  const int r0 = blockIdx.y * kMaxBeams;  // this block's rows: [r0, r0 + K)
  const int K = min(kMaxBeams, a.K - r0), S = a.S;
  float* qs = smem;         // [K][DH]
  float* sc = qs + K * DH;  // [K][S] scores, then weights (p/sum).sv

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int64_t row0 = (int64_t)bh * a.K + r0;
  const T* q = static_cast<const T*>(a.q) + row0 * DH;
  const int8_t* kv = a.kv + (int64_t)bh * S * 2 * DH;
  const float* sk = a.sk + (int64_t)bh * S;
  const float* sv = a.sv + (int64_t)bh * S;
  const float* bias = a.bias + (int64_t)b * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < K * DH; i += kCrossThreadsQ) qs[i] = to_f32(q[i]);
  __syncthreads();

  // Pass 1: scores (q.k8).sk + bias, one thread per source column. Each
  // thread reads the K half of its row 16 bytes at a time (a row is
  // 2.Dh >= 32 bytes and the wrapper checks the slab's alignment): a
  // byte-wide load would touch 32 rows' lines per warp instruction, Dh
  // times over.
  for (int s = threadIdx.x; s < S; s += kCrossThreadsQ) {
    const int4* krow = reinterpret_cast<const int4*>(kv + (int64_t)s * 2 * DH);
    float acc[kMaxBeams];
#pragma unroll
    for (int k = 0; k < kMaxBeams; ++k) acc[k] = 0.f;
#pragma unroll 1
    for (int c = 0; c < DH / 16; ++c) {
      const int4 chunk = krow[c];
      const int8_t* kb = reinterpret_cast<const int8_t*>(&chunk);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float kd = (float)kb[i];
        const float* qd = qs + c * 16 + i;
#pragma unroll
        for (int k = 0; k < kMaxBeams; ++k)
          if (k < K) acc[k] = fmaf(qd[k * DH], kd, acc[k]);
      }
    }
    const float sks = sk[s], bs = bias[s];
#pragma unroll
    for (int k = 0; k < kMaxBeams; ++k)
      if (k < K) sc[k * S + s] = __fadd_rn(__fmul_rn(acc[k], sks), bs);
  }
  __syncthreads();

  // Softmax weights folded with sv, one warp per beam row.
  for (int k = warp; k < K; k += NW) {
    float mx = -INFINITY;
    for (int s = lane; s < S; s += 32) mx = fmaxf(mx, sc[k * S + s]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float p = expf(sc[k * S + s] - mx);
      sc[k * S + s] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    for (int s = lane; s < S; s += 32) sc[k * S + s] = __fmul_rn(sc[k * S + s] / sum, sv[s]);
  }
  __syncthreads();

  // Pass 2: out[k, d] = sum_s w[k, s] . v8[s, d].
  constexpr int NKG = kCrossThreadsQ / DH;           // beam groups
  constexpr int KPT = (kMaxBeams + NKG - 1) / NKG;  // beams per thread
  const int d = threadIdx.x % DH, kg = threadIdx.x / DH;
  float acc[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) acc[i] = 0.f;
  for (int s = 0; s < S; ++s) {
    const float vd = (float)kv[(int64_t)s * 2 * DH + DH + d];
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int k = kg + i * NKG;
      if (k < K) acc[i] = fmaf(sc[k * S + s], vd, acc[i]);
    }
  }
  T* out = static_cast<T*>(a.out) + row0 * DH;
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int k = kg + i * NKG;
    if (k < K) out[k * DH + d] = from_f32<T>(acc[i]);
  }
}

template <typename T, int DH>
cudaError_t launch_cross_q(const CrossQArgs& a, int B, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cross_decode_i8_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(B * a.H, (a.K + kMaxBeams - 1) / kMaxBeams);
  cross_decode_i8_kernel<T, DH><<<grid, kCrossThreadsQ, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_cross_q(int DH, const CrossQArgs& a, int B, size_t smem,
                             cudaStream_t stream) {
  switch (DH) {
    case 16: return launch_cross_q<T, 16>(a, B, smem, stream);
    case 32: return launch_cross_q<T, 32>(a, B, smem, stream);
    case 64: return launch_cross_q<T, 64>(a, B, smem, stream);
    case 128: return launch_cross_q<T, 128>(a, B, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mm

// C entries: each returns cudaGetLastError() after its launch (0 on success).

// All shared memory of kernel F for (K, T = TS/K, Dh), in bytes.
extern "C" long long mm_ancestry_decode_i4_smem_bytes(int K, int T, int DH) {
  return (long long)mm::quant_dyn_bytes(K, T) + 4LL * (6 * mm::kMaxBeams + mm::kMaxBeams * DH);
}

extern "C" int mm_ancestry_decode_attention_i4(
    int dtype, const void* q, const void* k_new, const void* v_new,
    const void* kv, const void* sk, const void* sv, const void* flat_rep, void* out,
    int B, int H, int K, int DH, int TS, int layer,
    int64_t kv_sb, int64_t kv_sl, int64_t kv_sh, int64_t kv_sj,
    int64_t sk_sb, int64_t sk_sl, int64_t sk_sh,
    int64_t sv_sb, int64_t sv_sl, int64_t sv_sh, void* stream) {
  if (K < 1 || K > mm::kMaxBeams || TS % K != 0 || TS % 2 != 0)
    return (int)cudaErrorInvalidValue;
  const mm::QuantAncestryArgs a{
      q, k_new, v_new, static_cast<const int8_t*>(kv), static_cast<const float*>(sk),
      static_cast<const float*>(sv), static_cast<const int*>(flat_rep), out,
      H, K, TS, layer, kv_sb, kv_sl, kv_sh, kv_sj, sk_sb, sk_sl, sk_sh, sv_sb, sv_sl, sv_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mm::kFloat32) return (int)mm::dispatch_quant_ancestry<float>(DH, a, B, st);
  if (dtype == mm::kBFloat16)
    return (int)mm::dispatch_quant_ancestry<__nv_bfloat16>(DH, a, B, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mm_cross_decode_attention_i8(
    int dtype, const void* q, const void* kv, const void* sk, const void* sv,
    const void* bias, void* out, int B, int H, int K, int DH, int S, void* stream) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  // The same layout as kernel C's: a block's <= 16 rows of Dh query floats,
  // then their S scores each.
  const size_t k = K < mm::kMaxBeams ? K : mm::kMaxBeams;
  const size_t smem = 4 * (k * DH + k * S + k);
  const mm::CrossQArgs a{q, static_cast<const int8_t*>(kv), static_cast<const float*>(sk),
                         static_cast<const float*>(sv), static_cast<const float*>(bias),
                         out, H, K, S};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mm::kFloat32) return (int)mm::dispatch_cross_q<float>(DH, a, B, smem, st);
  if (dtype == mm::kBFloat16) return (int)mm::dispatch_cross_q<__nv_bfloat16>(DH, a, B, smem, st);
  return (int)cudaErrorInvalidValue;
}

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
  if (K < 1 || K > mm::kMaxBeams || TS < K || TS % K != 0 || variant < 0 || variant > 3 ||
      (variant == 3 && B % 2 != 0) || n_split < 1 || n_split > mm::kDMaxSplits)
    return (int)cudaErrorInvalidValue;
  const int T = TS / K, spt = (T + n_split - 1) / n_split;
  if ((T + spt - 1) / spt != n_split || spt * K > mm::kBSpan) return (int)cudaErrorInvalidValue;
  const long long bhk = (long long)B * H * K;
  float* sc = static_cast<float*>(scratch);
  float* part_m = sc + bhk * T;
  float* part_l = part_m + bhk * n_split;
  int* part_acc = reinterpret_cast<int*>(part_l + bhk * n_split);
  float* row_st = reinterpret_cast<float*>(part_acc + (n_split > 1 ? bhk * n_split * DH : 0));
  float* svs = row_st + (n_split > 1 ? 2 * bhk : 0);
  int* live_g = reinterpret_cast<int*>(svs + bhk * T);
  const mm::I8Args a{q, k_new, v_new, q_sb, q_sh, q_sk, kn_sb, kn_sh, kn_sk, vn_sb, vn_sh, vn_sk,
                     static_cast<const int8_t*>(kv), kv_sb, kv_sl, kv_sh, kv_sj,
                     static_cast<const float*>(sk), sk_sb, sk_sl, sk_sh,
                     static_cast<const float*>(sv), sv_sb, sv_sl, sv_sh,
                     static_cast<const int*>(flat_rep), out, o_sb, o_sh, o_sk,
                     sc, svs, live_g, part_m, part_l, part_acc, row_st,
                     H, K, TS, T, layer, n_split, spt * K, variant == 3 ? 2 : 1};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mm::kFloat32) return (int)mm::dispatch_i8_variant<float>(variant, DH, a, B, st);
  if (dtype == mm::kBFloat16)
    return (int)mm::dispatch_i8_variant<__nv_bfloat16>(variant, DH, a, B, st);
  return (int)cudaErrorInvalidValue;
}
