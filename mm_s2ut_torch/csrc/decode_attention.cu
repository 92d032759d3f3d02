// Kernels B and C — beam-decode attention of the unit decoder.
//
// Kernel B replaces the Pallas TPU kernel
// mm_s2ut/ops/decode_attention.py:_kernel (pallas_call at :430, launched by
// ancestry_decode_attention, reached from models/decoder.py:359): decode
// self-attention over the ancestry-indexed K||V cache. For beam k of
// batch row b and head h it takes a softmax over the cache columns j on
// k's path (flat_rep[b, k, j] == j) plus the current token's own logit
// q.k_new, then returns w.V + w_self.v_new.
//
// Kernel C replaces mm_s2ut/ops/decode_attention.py:_kernel_cross
// (pallas_call at :519, launched by cross_decode_attention, reached from
// models/layers.py:277-278): decode cross-attention of the K query rows of
// a batch row over their shared encoder K||V slab, softmax(q.k + bias).v.
// The rows are the K beams of a decode step (K <= 16), or the P = max_len
// + 1 prefix positions of UnitDecoder.prefill (501 at the streaming
// bench's max_len 500); the TPU kernel takes any row count too.
//
// What bounds them on the card: both read far more bytes than they
// compute with (K <= 16 queries per head against a 2.Dh-wide row per
// column), so they are bound by memory latency and bandwidth. Kernel B's
// cache is the largest tensor of the decode step (B.L.H.T.S.2.Dh
// elements); kernel C reads the (S, 2.Dh) slab once per (b, h, layer, step).
// At the flagship's phase-2 shape (B = 8, H = 8, K = 10, Dh = 64, bf16,
// step 300 of T.S = 5000) B must read ~34 MB of on-path K||V rows for
// ~10 operations a byte: far under the ~295 at which the tensor cores
// would bound it, but half the ~20 at which the fp32 FMA pipes (67 TFLOP/s)
// would, and a SIMT product also spends a shared-memory load per FMA. So
// bf16 B does its products on the tensor cores, and the design keeps many
// independent row reads in flight on every SM.
//
// Design of B, flash-decoding style: the T.S column axis is split over
// blocks, grid (B.H, n_split), n_split picked for one wave of blocks on
// the 132 SMs (~7 splits at B = 8, 1 at B = 128; the grid (B, H) it
// replaces put 64 blocks on 132 SMs at B = 8, and each warp waited on one
// dependent 256-byte row read per column). A block reads its span of
// flat_rep once, all K loads of a column in flight together, and compacts
// the columns on some beam's path, with the beams' bit mask, into shared
// memory. In bf16 each of its 4 warps then gathers its own tiles of 32
// live rows (16 at Dh = 128) through its own 2-stage cp.async ring and
// keeps its own online softmax, with the K beams as the 16 rows of
// mma.m16n8k16: S = Q.K^T, -inf off each beam's path (weight 0),
// O += bf16(P).V; the warps merge in shared memory at the end. No block
// barrier runs between tiles. In fp32 (and as bf16's measured
// alternative) the block shares each tile and puts a (beam, column), then
// a (beam, dim), pair on each thread. Each split leaves (max,
// denominator, unnormalised w.V) per beam in fp32 scratch; a second small
// kernel per (b, h) folds the splits in split order with the beam's own
// logit q.k_new and v_new. No atomics, so two launches give the same bits;
// a split with no live column writes max -inf and weighs 0, so at step 0
// the output is exactly v_new. The kernel reads the whole stacked cache
// through the layer index and strides, so the layer's slab is never
// copied (the reference's BlockSpec index map has the same contract), and
// any T.S runs; q, k_new, v_new and the output go through strides too (the
// decoder's beam-major views, without copies).
//
// Design of C: grid (B.H, ceil(K/16)); a block takes 16 of the rows (all
// K when K <= 16, so a decode step runs one block per (b, h) as before,
// and many rows re-read the slab once per 16 of them: 32 reads of a
// 64 KB slab at 501 rows). The block's pre-scaled queries sit in shared
// memory; one thread per source column computes its rows' scores, which
// stay in shared memory (16.S floats at most) for a two-pass softmax; then
// each thread owns one output dim for a few rows and streams the V half of
// the slab.
// The TPU version's batch-row blocking (_cross_block_rows) and the host
// broadcast of the bias over K were Mosaic/VMEM workarounds and have no
// counterpart.
#include "flash_attention_mma.cuh"

namespace mm {
namespace {

constexpr int kMaxBeams = 16;

// ---------------------------------------------------------------- kernel B

using namespace tc;

constexpr int kBSpan = 2048;      // most columns one split covers (16-bit offsets)
constexpr int kBMaxSplits = 64;   // most splits of one (b, h): the merge's weights table
constexpr int kBThreads = 256;    // SIMT split pass and merge: 8 warps
constexpr int kBTile = 32;        // SIMT: live columns per staged tile, one per lane
constexpr int kBMmaThreads = 128; // tensor-core split pass: 4 warps, each with its own tiles
constexpr int kSMs = 132;         // an H100's SMs

struct AncestryArgs {
  const void* q;       // (B, H, K, Dh) through strides, pre-scaled
  const void* k_new;   // (B, H, K, Dh) through strides
  const void* v_new;   // (B, H, K, Dh) through strides
  int64_t q_sb, q_sh, q_sk, kn_sb, kn_sh, kn_sk, vn_sb, vn_sh, vn_sk;
  const void* kv;      // (B, L, H, TS, 2.Dh) through strides, rows 16-byte aligned
  int64_t kv_sb, kv_sl, kv_sh, kv_sj;
  const int* flat_rep; // (B, K, TS) contiguous
  void* out;           // (B, H, K, Dh) through strides
  int64_t o_sb, o_sh, o_sk;
  float* part_m;       // (B.H, n_split, K) max of each split, -inf if it saw no column
  float* part_l;       // (B.H, n_split, K) its denominator
  float* part_acc;     // (B.H, n_split, K, Dh) its unnormalised w.V
  int H, K, TS, layer, n_split, span, hpb;  // hpb: heads per block (1 or H)
};

// The live columns of [c0, c1) (those on some beam's path, flat_rep[k][j]
// == j), in column order, as (offset | beams << 16) into ``live``; returns
// their count. Each thread reads R columns per round with all its K loads
// in flight at once (``count`` holds R x NT / 32 ints).
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

// A split with no live column: only its maxima are read, by the merge.
__device__ __forceinline__ void write_empty(const AncestryArgs& a, int64_t part0) {
  for (int i = threadIdx.x; i < a.hpb * a.K; i += blockDim.x)
    a.part_m[(part0 + (int64_t)(i / a.K) * a.n_split) * a.K + i % a.K] = -INFINITY;
}

// Shared memory of the tensor-core split pass: each warp's 2-stage ring of
// TW-row K and V tiles (swizzled, as flash_attention_mma.cuh's A and G
// read them), the head's q as 16 zero-padded rows, the live columns and
// the compaction's counts. The warps' (O, m, l) for the block's merge go
// over the drained ring.
template <int D>
struct BMma {
  static constexpr int kTW = D <= 64 ? 32 : 16;  // live columns per warp tile
  static constexpr int kTile = kTW * D * 2;      // one K (or V) tile, bf16
  static constexpr int kRing = 0;
  static constexpr int kQ = kRing + 4 * 2 * 2 * kTile;
  static constexpr int kLive = kQ + 16 * D * 2;
  static constexpr int kCount = kLive + kBSpan * 4;
  static constexpr int kBytes = kCount + 4 * 4 * 4;
  static constexpr int kMerge = 16 * (D + 2);  // floats per warp: O (16 x D), m, l
  static_assert(4 * kMerge * 4 <= kQ - kRing, "the merge fits over the ring");
};

// Tensor-core split pass (bf16): block (b, head group) x split. After the
// compaction, warp w takes live tiles w, w + 4, ... of each head, each
// gathered by its own 32 lanes through its own 2-stage cp.async ring, and
// keeps its own online softmax: S = Q.K^T with the K beams as the 16 rows
// of mma.m16n8k16 (rows past K are zeros) and the tile's columns as n,
// scores off a beam's path set to -inf (weight 0), then O += bf16(P).V with
// P from the accumulators (acc_to_a) and V through ldmatrix.trans. No block
// barrier runs between tiles; at the end of a head the four warps' (m, l,
// O) merge in shared memory into the split's partial.
template <int D>
__global__ void __launch_bounds__(kBMmaThreads) ancestry_split_kernel_mma(const AncestryArgs a) {
  using C = BMma<D>;
  constexpr int KS = D / 16, NT = D / 8, TW = C::kTW, CH = D / 8;
  extern __shared__ __align__(128) unsigned char m_smem[];
  uint32_t* live = reinterpret_cast<uint32_t*>(m_smem + C::kLive);
  float* merge = reinterpret_cast<float*>(m_smem + C::kRing);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int K = a.K, groups = a.H / a.hpb;
  const int b = blockIdx.x / groups, h0 = (blockIdx.x % groups) * a.hpb, split = blockIdx.y;
  const int c0 = split * a.span, c1 = min(a.TS, c0 + a.span);
  const int n_live = compact_live<kBMmaThreads, 4>(a.flat_rep + (int64_t)b * K * a.TS, K, a.TS,
                                                   c0, c1, live,
                                                   reinterpret_cast<int*>(m_smem + C::kCount));
  const int64_t part0 = ((int64_t)b * a.H + h0) * a.n_split + split;  // (bh, split) of head h0
  if (n_live == 0) return write_empty(a, part0);

  const int n_tiles = (n_live + TW - 1) / TW;
  const bf16* kvb = static_cast<const bf16*>(a.kv) + b * a.kv_sb + (int64_t)a.layer * a.kv_sl;
  const uint32_t ring = smem_u32(m_smem + C::kRing) + warp * 2 * 2 * C::kTile;
  const uint32_t q_tile = smem_u32(m_smem + C::kQ);
  for (int h = h0; h < h0 + a.hpb; ++h) {
    const bf16* slab = kvb + (int64_t)h * a.kv_sh;
    auto gather = [&](int stage, int i) {  // live tile i into this warp's stage; past n_live zeros
      const uint32_t kt = ring + stage * 2 * C::kTile, vt = kt + C::kTile;
      const int r0 = i * TW, n = min(TW, n_live - r0);
      for (int e = lane; e < TW * 2 * CH; e += 32) {
        const int r = e / (2 * CH), c = e % (2 * CH);
        const bool ok = r < n;
        const int col = c0 + (ok ? (int)(live[r0 + r] & 0xFFFFu) : 0);
        cp_async16(c < CH ? kt + swz<D>(r, c) : vt + swz<D>(r, c - CH),
                   slab + (int64_t)col * a.kv_sj + c * 8, ok);
      }
    };
    int i = warp;
    if (i < n_tiles) {  // the warp's first tile goes in flight before q is staged
      gather(0, i);
      cp_async_commit();
    }
    const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
    for (int e = threadIdx.x; e < 16 * D; e += kBMmaThreads) {
      const int r = e / D, d = e % D;
      *reinterpret_cast<bf16*>(m_smem + C::kQ + swz<D>(r, d / 8) + (d % 8) * 2) =
          r < K ? q[r * a.q_sk + d] : __float2bfloat16(0.f);
    }
    __syncthreads();
    uint32_t qf[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) frag_a<D>(qf[kk], q_tile, 0, kk);
    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

    for (int j = 0; i < n_tiles; ++j, i += 4) {
      const int stage = j & 1;
      if (i + 4 < n_tiles) {
        gather(stage ^ 1, i + 4);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      const uint32_t kt = ring + stage * 2 * C::kTile, vt = kt + C::kTile;
      const int r0 = i * TW, n_in = min(TW, n_live - r0);
      float s[TW / 8][4];
#pragma unroll
      for (int n = 0; n < TW / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int np = 0; np < TW / 16; ++np) {
          uint32_t f[4];
          frag_b<D>(f, kt, np * 16, kk);
          mma(s[2 * np], qf[kk], f[0], f[1]);
          mma(s[2 * np + 1], qf[kk], f[2], f[3]);
        }
      }
      // Element e of n-tile n: beam g + 8 (e >> 1), column 8 n + 2 tq + (e & 1).
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < TW / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * tq + (e & 1), beam = g + 8 * (e >> 1);
          const bool on = c < n_in && ((live[r0 + c] >> (16 + beam)) & 1u);
          s[n][e] = on ? s[n][e] : -INFINITY;
          mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
        }
      }
      float alpha[2], m_new[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_new[r] = fmaxf(m_run[r], quad_max(mt[r]));
        // -inf until a column on the beam's path comes: nothing to rescale yet
        alpha[r] = m_new[r] == -INFINITY ? 1.f : exp_e(m_run[r] - m_new[r]);
        m_run[r] = m_new[r];
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < TW / 8; ++n) {
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
      __syncwarp();  // the stage is refilled by the next iteration's gather
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
    const int64_t part = part0 + (int64_t)(h - h0) * a.n_split;
    for (int e = threadIdx.x; e < K * D; e += kBMmaThreads) {
      const int k = e / D, d = e % D;
      float M = -INFINITY, l = 0.f, acc = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) M = fmaxf(M, merge[w * C::kMerge + 16 * D + k]);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float* mv = merge + w * C::kMerge;
        const float m = mv[16 * D + k];
        if (m == -INFINITY) continue;  // the warp saw no column on k's path
        const float sc = exp_e(m - M);
        l = fmaf(sc, mv[16 * D + 16 + k], l);
        acc = fmaf(sc, mv[k * D + d], acc);
      }
      if (d == 0) {
        a.part_m[part * K + k] = M;
        a.part_l[part * K + k] = l;
      }
      a.part_acc[(part * K + k) * D + d] = acc;
    }
    __syncthreads();  // the merge area is the next head's ring
  }
}

// Shared memory of the SIMT split pass: a 2-stage ring of kBTile K||V rows
// (each padded by 16 bytes, so the 16-byte reads of 8 lanes at one chunk
// of 8 rows hit distinct banks), the head's q (rows padded by one float),
// the tile's scores then weights, each beam's rescale, the split's live
// columns and the compaction's counts.
template <typename T, int DH>
struct BSimt {
  static constexpr int kRow = 2 * DH * (int)sizeof(T) + 16;
  static constexpr int kQs = DH + 1;
  static constexpr int kRows = 0;
  static constexpr int kQ = kRows + 2 * kBTile * kRow;
  static constexpr int kP = kQ + kMaxBeams * kQs * 4;
  static constexpr int kAlpha = kP + kMaxBeams * kBTile * 4;
  static constexpr int kLive = kAlpha + kMaxBeams * 4;
  static constexpr int kCount = kLive + kBSpan * 4;
  static constexpr int kBytes = kCount + 2 * 8 * 4;
};

// SIMT split pass (fp32, and bf16's alternative design): the same blocks
// and compaction; then the block gathers each head's live rows, 32 at a
// time, into a 2-stage cp.async ring and runs one online softmax for all K
// beams over each tile: a (beam, column) pair per thread for the scores
// (warp w: beams w and w + 8, lane: column; -inf off the beam's path), the
// beam's max and sum by one warp, then a (beam, dim) pair per thread for
// w.V, on the fp32 FMA pipes.
template <typename T, int DH>
__global__ void __launch_bounds__(kBThreads) ancestry_split_kernel_simt(const AncestryArgs a) {
  using SM = BSimt<T, DH>;
  constexpr int EPC = 16 / (int)sizeof(T);          // elements per 16-byte chunk
  constexpr int CH = 2 * DH / EPC;                  // chunks per K||V row
  constexpr int NKG = kBThreads / DH;               // beam groups of the w.V step
  constexpr int KPT = (kMaxBeams + NKG - 1) / NKG;  // beams per thread there
  extern __shared__ __align__(16) unsigned char b_smem[];
  float* q_sm = reinterpret_cast<float*>(b_smem + SM::kQ);
  float* p_sm = reinterpret_cast<float*>(b_smem + SM::kP);
  float* alpha_sm = reinterpret_cast<float*>(b_smem + SM::kAlpha);
  uint32_t* live = reinterpret_cast<uint32_t*>(b_smem + SM::kLive);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int K = a.K, groups = a.H / a.hpb;
  const int b = blockIdx.x / groups, h0 = (blockIdx.x % groups) * a.hpb, split = blockIdx.y;
  const int c0 = split * a.span, c1 = min(a.TS, c0 + a.span);
  const int n_live =
      compact_live<kBThreads, 2>(a.flat_rep + (int64_t)b * K * a.TS, K, a.TS, c0, c1, live,
                                 reinterpret_cast<int*>(b_smem + SM::kCount));
  const int64_t part0 = ((int64_t)b * a.H + h0) * a.n_split + split;  // (bh, split) of head h0
  if (n_live == 0) return write_empty(a, part0);

  // Visit v: head h0 + v / n_tiles, live tile v % n_tiles.
  const int n_tiles = (n_live + kBTile - 1) / kBTile;
  const int n_visits = a.hpb * n_tiles;
  const T* kv = static_cast<const T*>(a.kv) + b * a.kv_sb + (int64_t)a.layer * a.kv_sl;
  auto load_tile = [&](int stage, int v) {
    const T* slab = kv + (int64_t)(h0 + v / n_tiles) * a.kv_sh;
    const int r0 = (v % n_tiles) * kBTile, n = min(kBTile, n_live - r0);
    const uint32_t dst = smem_u32(b_smem + SM::kRows + stage * kBTile * SM::kRow);
    for (int i = threadIdx.x; i < n * CH; i += kBThreads) {
      const int r = i / CH, c = i % CH;
      const int col = c0 + (int)(live[r0 + r] & 0xFFFFu);
      cp_async16(dst + r * SM::kRow + c * 16, slab + (int64_t)col * a.kv_sj + c * EPC, true);
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  float m_run[2], l_run[2], acc[KPT];
  const int d_own = threadIdx.x % DH, kg = threadIdx.x / DH;
  for (int v = 0; v < n_visits; ++v) {
    const int stage = v & 1, i = v % n_tiles, h = h0 + v / n_tiles;
    if (v + 1 < n_visits) {
      load_tile(stage ^ 1, v + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (i == 0) {  // a new head: its q, and a fresh softmax state
      const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
      for (int e = threadIdx.x; e < K * DH; e += kBThreads)
        q_sm[(e / DH) * SM::kQs + e % DH] = to_f32(q[(e / DH) * a.q_sk + e % DH]);
      m_run[0] = m_run[1] = -INFINITY;
      l_run[0] = l_run[1] = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) acc[j] = 0.f;
      __syncthreads();
    }
    const unsigned char* rows = b_smem + SM::kRows + stage * kBTile * SM::kRow;
    const int r0 = i * kBTile, n = min(kBTile, n_live - r0);

    // Scores of the tile: p_sm[k][c] = q_k . K_c on k's path, else -inf.
    {
      const int kb0 = warp, kb1 = warp + 8;
      float s0 = -INFINITY, s1 = -INFINITY;
      const unsigned on = lane < n ? live[r0 + lane] >> 16 : 0u;
      const bool b0 = kb0 < K && ((on >> kb0) & 1u), b1 = kb1 < K && ((on >> kb1) & 1u);
      if (b0 || b1) {
        const uint4* kr = reinterpret_cast<const uint4*>(rows + lane * SM::kRow);
        const float* q0 = q_sm + kb0 * SM::kQs;
        const float* q1 = q_sm + (kb1 < K ? kb1 : kb0) * SM::kQs;
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int c = 0; c < CH / 2; ++c) {
          const uint4 u = kr[c];
          const T* x = reinterpret_cast<const T*>(&u);
#pragma unroll
          for (int e = 0; e < EPC; ++e) {
            const float xv = to_f32(x[e]);
            d0 = fmaf(q0[c * EPC + e], xv, d0);
            d1 = fmaf(q1[c * EPC + e], xv, d1);
          }
        }
        s0 = b0 ? d0 : -INFINITY;
        s1 = b1 ? d1 : -INFINITY;
      }
      if (kb0 < K) p_sm[kb0 * kBTile + lane] = s0;
      if (kb1 < K) p_sm[kb1 * kBTile + lane] = s1;
      __syncwarp();
    }

    // Online softmax per beam (warp w: beams w, w + 8; lane: column).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kb = warp + 8 * r;
      if (kb >= K) continue;  // warp-uniform
      const float sv = p_sm[kb * kBTile + lane];  // -inf past the tile's n columns
      const float m_new = fmaxf(m_run[r], warp_max(sv));
      float alpha = 1.f, p = 0.f;
      if (m_new != -INFINITY) {  // some column of this split is on kb's path
        alpha = expf(m_run[r] - m_new);  // 0 on the first such tile
        p = expf(sv - m_new);            // 0 off the path
      }
      l_run[r] = fmaf(l_run[r], alpha, warp_sum(p));
      m_run[r] = m_new;
      p_sm[kb * kBTile + lane] = p;
      if (lane == 0) alpha_sm[kb] = alpha;
    }
    __syncthreads();

    // acc[k][d] = acc . alpha_k + sum_c p[k][c] V_c[d]: one (beam, dim) pair per thread.
    {
      const T* vr = reinterpret_cast<const T*>(rows) + DH + d_own;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int k = kg + j * NKG;
        if (k < K) acc[j] *= alpha_sm[k];
      }
      for (int c = 0; c < n; ++c) {
        const float vd = to_f32(vr[c * (SM::kRow / (int)sizeof(T))]);
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          const int k = kg + j * NKG;
          if (k < K) acc[j] = fmaf(p_sm[k * kBTile + c], vd, acc[j]);
        }
      }
    }
    if (i == n_tiles - 1) {  // the head's partials
      const int64_t part = part0 + (int64_t)(h - h0) * a.n_split;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kb = warp + 8 * r;
        if (kb < K && lane == 0) {
          a.part_m[part * K + kb] = m_run[r];
          a.part_l[part * K + kb] = l_run[r];
        }
      }
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int k = kg + j * NKG;
        if (k < K) a.part_acc[(part * K + k) * DH + d_own] = acc[j];
      }
    }
    __syncthreads();  // stage v & 1 and p_sm are rewritten by the next visit
  }
}

// Merge pass: one block per (b, h). One warp per beam takes the max over
// the beam's own logit q . k_new and its splits' maxima, each split's
// weight exp(m - max) (0 for a split that saw no column on the beam's
// path) and the denominator; then one (beam, dim) pair per thread folds
// the splits' w.V, in split order, with the self term. With no live column
// at all (step 0) the output is exactly v_new.
template <typename T, int DH>
__global__ void __launch_bounds__(kBThreads) ancestry_merge_kernel(const AncestryArgs a) {
  __shared__ float self_sm[kMaxBeams], den_sm[kMaxBeams];
  __shared__ float w_sm[kMaxBeams][kBMaxSplits];
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, K = a.K, S = a.n_split;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kn = static_cast<const T*>(a.k_new) + b * a.kn_sb + h * a.kn_sh;
  const T* vn = static_cast<const T*>(a.v_new) + b * a.vn_sb + h * a.vn_sh;
  const int64_t part0 = (int64_t)bh * S;
  for (int k = warp; k < K; k += kBThreads / 32) {
    float s = 0.f;
    for (int d = lane; d < DH; d += 32)
      s = fmaf(to_f32(q[k * a.q_sk + d]), to_f32(kn[k * a.kn_sk + d]), s);
    s = warp_sum(s);
    float mx = s;
    for (int sp = lane; sp < S; sp += 32) mx = fmaxf(mx, a.part_m[(part0 + sp) * K + k]);
    mx = warp_max(mx);
    float den = 0.f;
    for (int sp = lane; sp < S; sp += 32) {
      const float m = a.part_m[(part0 + sp) * K + k];
      const float w = m == -INFINITY ? 0.f : expf(m - mx);
      w_sm[k][sp] = w;
      den += w == 0.f ? 0.f : w * a.part_l[(part0 + sp) * K + k];
    }
    den = warp_sum(den);
    if (lane == 0) {
      self_sm[k] = expf(s - mx);  // the self term's weight
      den_sm[k] = den + self_sm[k];
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;
  for (int i = threadIdx.x; i < K * DH; i += kBThreads) {
    const int k = i / DH, d = i % DH;
    float num = self_sm[k] * to_f32(vn[k * a.vn_sk + d]);
#pragma unroll 4
    for (int sp = 0; sp < S; ++sp) {
      const float w = w_sm[k][sp];
      const float x = a.part_acc[((part0 + sp) * K + k) * DH + d];  // unwritten where w = 0
      num = fmaf(w, w == 0.f ? 0.f : x, num);
    }
    out[k * a.o_sk + d] = from_f32<T>(num / den_sm[k]);
  }
}

template <typename T, int DH, bool MMA>
cudaError_t launch_ancestry(const AncestryArgs& a, int B, cudaStream_t stream) {
  constexpr int threads = MMA ? kBMmaThreads : kBThreads;
  constexpr int smem = MMA ? BMma<DH>::kBytes : BSimt<T, DH>::kBytes;
  const dim3 grid(B * (a.H / a.hpb), a.n_split);
  cudaError_t err;
  if constexpr (MMA) {
    err = allow_smem(ancestry_split_kernel_mma<DH>, smem);
    if (err != cudaSuccess) return err;
    ancestry_split_kernel_mma<DH><<<grid, threads, smem, stream>>>(a);
  } else {
    err = allow_smem(ancestry_split_kernel_simt<T, DH>, smem);
    if (err != cudaSuccess) return err;
    ancestry_split_kernel_simt<T, DH><<<grid, threads, smem, stream>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ancestry_merge_kernel<T, DH><<<B * a.H, kBThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool MMA>
cudaError_t dispatch_ancestry(int DH, const AncestryArgs& a, int B, cudaStream_t stream) {
  switch (DH) {
    case 16: return launch_ancestry<T, 16, MMA>(a, B, stream);
    case 32: return launch_ancestry<T, 32, MMA>(a, B, stream);
    case 64: return launch_ancestry<T, 64, MMA>(a, B, stream);
    case 128: return launch_ancestry<T, 128, MMA>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- kernel C

constexpr int kCrossThreads = 256;

struct CrossArgs {
  const void* q;      // (B, H, K, Dh) contiguous, pre-scaled
  const void* kv;     // (B, H, S, 2.Dh) contiguous
  const float* bias;  // (B, S) additive
  void* out;          // (B, H, K, Dh) contiguous
  int H, K, S;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kCrossThreads) cross_decode_kernel(const CrossArgs a) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.y * kMaxBeams;  // this block's rows: [r0, r0 + K)
  const int K = min(kMaxBeams, a.K - r0), S = a.S;
  float* qs = smem;            // [K][DH]
  float* sc = qs + K * DH;     // [K][S] scores, then probabilities
  float* rsum = sc + K * S;    // [K]

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int64_t row0 = (int64_t)bh * a.K + r0;
  const T* q = static_cast<const T*>(a.q) + row0 * DH;
  const T* kv = static_cast<const T*>(a.kv) + (int64_t)bh * S * 2 * DH;
  const float* bias = a.bias + (int64_t)b * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int NW = kCrossThreads / 32;

  for (int i = threadIdx.x; i < K * DH; i += kCrossThreads) qs[i] = to_f32(q[i]);
  __syncthreads();

  // Pass 1: scores, one thread per source column.
  for (int s = threadIdx.x; s < S; s += kCrossThreads) {
    const T* krow = kv + (int64_t)s * 2 * DH;
    float acc[kMaxBeams];
#pragma unroll
    for (int k = 0; k < kMaxBeams; ++k) acc[k] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float kd = to_f32(krow[d]);
#pragma unroll
      for (int k = 0; k < kMaxBeams; ++k)
        if (k < K) acc[k] = fmaf(qs[k * DH + d], kd, acc[k]);
    }
    const float bs = bias[s];
#pragma unroll
    for (int k = 0; k < kMaxBeams; ++k)
      if (k < K) sc[k * S + s] = acc[k] + bs;
  }
  __syncthreads();

  // Softmax numerators and row sums, one warp per beam row.
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
    if (lane == 0) rsum[k] = sum;
  }
  __syncthreads();

  // Pass 2: out[k, d] = sum_s p[k, s] . v[s, d] / rsum[k].
  constexpr int NKG = kCrossThreads / DH;                 // beam groups
  constexpr int KPT = (kMaxBeams + NKG - 1) / NKG;        // beams per thread
  const int d = threadIdx.x % DH, kg = threadIdx.x / DH;
  float acc[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) acc[i] = 0.f;
  for (int s = 0; s < S; ++s) {
    const float vd = to_f32(kv[(int64_t)s * 2 * DH + DH + d]);
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
    if (k < K) out[k * DH + d] = from_f32<T>(acc[i] / rsum[k]);
  }
}

template <typename T, int DH>
cudaError_t launch_cross(const CrossArgs& a, int B, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cross_decode_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(B * a.H, (a.K + kMaxBeams - 1) / kMaxBeams);
  cross_decode_kernel<T, DH><<<grid, kCrossThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_cross(int DH, const CrossArgs& a, int B, size_t smem, cudaStream_t stream) {
  switch (DH) {
    case 16: return launch_cross<T, 16>(a, B, smem, stream);
    case 32: return launch_cross<T, 32>(a, B, smem, stream);
    case 64: return launch_cross<T, 64>(a, B, smem, stream);
    case 128: return launch_cross<T, 128>(a, B, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mm

// C entries: each returns cudaGetLastError() after its launch (0 on success).
// Kernel B's split count for B batch rows of H heads over TS columns:
// enough blocks of (b, head group) x split for one wave on the card (3
// tensor-core blocks or 8 SIMT blocks per SM), each split at least one
// tile and at most kBSpan columns wide, at most kBMaxSplits. ``variant`` as
// mm_ancestry_decode_attention's.
extern "C" int mm_ancestry_decode_splits(int dtype, int B, int H, int TS, int variant) {
  const bool mma = dtype == mm::kBFloat16 && variant != 2;
  const int groups = B * (variant == 1 ? 1 : H);
  const int target = (mma ? 3 : 8) * mm::kSMs;
  const int want = (target + groups - 1) / groups;
  const int lo = (TS + mm::kBSpan - 1) / mm::kBSpan;
  int hi = (TS + mm::kBTile - 1) / mm::kBTile;
  hi = hi < mm::kBMaxSplits ? hi : mm::kBMaxSplits;
  return want < lo ? lo : (want > hi ? (hi > lo ? hi : lo) : want);
}

// Kernel B: the split pass then the merge on ``stream``; ``scratch`` holds
// (B.H.n_split.K) maxima, as many denominators, then (B.H.n_split.K.Dh)
// partial sums, fp32, with n_split from mm_ancestry_decode_splits.
// ``variant`` (0 in the port; the others for tools/kernel_ab.py): 0 one
// head per block, on the tensor cores in bf16 and SIMT in fp32; 1 all H
// heads of a batch row per block (the reference's grid); 2 the SIMT pass
// in bf16 too.
extern "C" int mm_ancestry_decode_attention(
    int dtype, int variant, const void* q, const void* k_new, const void* v_new,
    const void* kv, const void* flat_rep, void* out, void* scratch,
    int B, int H, int K, int DH, int TS, int layer, int n_split,
    int64_t q_sb, int64_t q_sh, int64_t q_sk, int64_t kn_sb, int64_t kn_sh, int64_t kn_sk,
    int64_t vn_sb, int64_t vn_sh, int64_t vn_sk, int64_t o_sb, int64_t o_sh, int64_t o_sk,
    int64_t kv_sb, int64_t kv_sl, int64_t kv_sh, int64_t kv_sj, void* stream) {
  if (K < 1 || K > mm::kMaxBeams || TS < 1 || n_split < 1 || n_split > mm::kBMaxSplits ||
      variant < 0 || variant > 2)
    return (int)cudaErrorInvalidValue;
  const int span = (TS + n_split - 1) / n_split;
  if (span > mm::kBSpan) return (int)cudaErrorInvalidValue;
  float* part = static_cast<float*>(scratch);
  const int64_t n_part = (int64_t)B * H * n_split * K;
  const mm::AncestryArgs a{q, k_new, v_new, q_sb, q_sh, q_sk, kn_sb, kn_sh, kn_sk,
                           vn_sb, vn_sh, vn_sk, kv, kv_sb, kv_sl, kv_sh, kv_sj,
                           static_cast<const int*>(flat_rep), out, o_sb, o_sh, o_sk,
                           part, part + n_part, part + 2 * n_part,
                           H, K, TS, layer, n_split, span, variant == 1 ? H : 1};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mm::kFloat32) return (int)mm::dispatch_ancestry<float, false>(DH, a, B, st);
  if (dtype != mm::kBFloat16) return (int)cudaErrorInvalidValue;
  return variant == 2 ? (int)mm::dispatch_ancestry<__nv_bfloat16, false>(DH, a, B, st)
                      : (int)mm::dispatch_ancestry<__nv_bfloat16, true>(DH, a, B, st);
}

// Dynamic shared memory of kernel C (and E) for (K rows, S, Dh), in bytes:
// a block holds at most 16 rows' queries, scores and sums.
extern "C" long long mm_cross_decode_smem_bytes(int K, int S, int DH) {
  const long long k = K < mm::kMaxBeams ? K : mm::kMaxBeams;
  return 4LL * (k * DH + k * S + k);
}

extern "C" int mm_cross_decode_attention(
    int dtype, const void* q, const void* kv, const void* bias, void* out,
    int B, int H, int K, int DH, int S, void* stream) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)mm_cross_decode_smem_bytes(K, S, DH);
  const mm::CrossArgs a{q, kv, static_cast<const float*>(bias), out, H, K, S};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mm::kFloat32) return (int)mm::dispatch_cross<float>(DH, a, B, smem, st);
  if (dtype == mm::kBFloat16) return (int)mm::dispatch_cross<__nv_bfloat16>(DH, a, B, smem, st);
  return (int)cudaErrorInvalidValue;
}
