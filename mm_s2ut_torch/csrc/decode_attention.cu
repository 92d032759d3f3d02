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
// both dtypes do their products on the tensor cores (fp32 in 3xTF32, 5
// operations a byte, far under the TF32 cores' ~148 even counted three
// times), and the design keeps many independent row reads in flight on
// every SM.
//
// Design of B, flash-decoding style: the T.S column axis is split over
// blocks, grid (B.H, n_split), n_split picked for one wave of blocks on
// the 132 SMs (~7 splits at B = 8, 1 at B = 128; the grid (B, H) it
// replaces put 64 blocks on 132 SMs at B = 8, and each warp waited on one
// dependent 256-byte row read per column). A block reads its span of
// flat_rep once, all K loads of a column in flight together, and compacts
// the columns on some beam's path, with the beams' bit mask, into shared
// memory. Each of its 4 warps then gathers its own tiles of live rows
// through its own 2-stage cp.async ring and keeps its own online softmax,
// with the K beams as the 16 rows of the mma (rows past K are zeros): S =
// Q.K^T, -inf off each beam's path (weight 0), O += P.V; the warps merge
// in shared memory at the end. No block barrier runs between tiles. bf16:
// tiles of 32 live rows (16 at Dh = 128), mma.m16n8k16, P rounded to bf16.
// fp32: tiles of 8 live rows, every product 3xTF32 on mma.m16n8k8
// (flash_attention_mma.cuh: x = hi + lo, lo.hi + hi.lo + hi.hi; one TF32
// pass would miss the fp32 checks' 1e-4), each fragment read from the raw
// fp32 tile and split in registers (decode_attention.cuh: an element meets
// one warp, so no split tile), Q split once per head, P kept in fp32 and
// split like any operand; 8-row tiles leave room for five blocks per SM. bf16's alternative design (tools/kernel_ab.py variant 2)
// shares each tile over the block and puts a (beam, column), then a (beam,
// dim), pair on each thread, on the FMA pipes. Each split leaves (max,
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
// Design of C. The K <= 16 rows of a decode step are the 16 rows of the
// mma (rows past K are zeros), as B's beams are: grid (B.H, n_split), the
// S columns cut into n_split spans of whole key tiles where B.H is under
// a wave (n_split 1 at B = 128, the slab then read once per (b, h)), 4
// warps per block, and each warp takes its own tiles of the span through
// its own 2-stage cp.async ring of K and V rows with the tile's bias
// beside them, and keeps its own online softmax: S = Q.K^T + bias (-inf
// past S), O += P.V. bf16: 32-key tiles (16 at Dh = 128), XOR-swizzled,
// mma.m16n8k16, P rounded to bf16. fp32: B's 3xTF32 on raw 16-key tiles
// (8 at Dh = 128: 8-key tiles tie at B = 128 and split more at B = 8,
// where the merge then costs more); the online softmax needs no S-sized
// score buffer, so fp32 splits by bf16's rule. The slab is dense, so no compaction. The
// warps merge in shared memory at the end; with one split the block
// divides by the denominator and stores, else it leaves (max, denominator,
// unnormalised O) per row in fp32 scratch and a small merge kernel per (b,
// h) folds the splits in split order. No atomics, so two launches give the
// same bits. A warp, or a split, that saw no column keeps max -inf and
// weighs 0 in the merge (a span of -1e9 padding keeps a finite max that
// the merge weighs exp(-1e9 - M) = 0). bf16 rounds P to bf16 before P.V,
// unnormalised, as in A, B and G; the reference rounds the normalised
// weights (p / sum p) to bf16 (_kernel_cross, decode_attention.py:497):
// both round each weight to a few bf16 ulps of a convex mix, inside the
// card checks' bf16 2e-2. The prefill's many rows (K > 16, P = max_len +
// 1) take A's forward in either dtype (flash_attention_mma.cu, and
// flash_attention.cu's 3xTF32 in fp32) with scale 1 over the slab's K and
// V halves as strided (B, S, H, Dh) views: 4 warps x 16 query rows per
// block over every key tile, so the slab is read once per 64 rows.
// q and the output go through strides: the decoder hands a beam-major
// (B, K, H, Dh) query viewed as (B, H, K, Dh), and the result is a view
// of a beam-major buffer, so neither is copied.
// The TPU version's batch-row blocking (_cross_block_rows) and the host
// broadcast of the bias over K were Mosaic/VMEM workarounds and have no
// counterpart.
#include "decode_attention.cuh"

namespace mm {
namespace {

// ---------------------------------------------------------------- kernel B

using namespace tc;

constexpr int kBMaxSplits = 64;   // most splits of one (b, h): the merge's weights table
constexpr int kBThreads = 256;    // SIMT split pass and merge: 8 warps
constexpr int kBTile = 32;        // SIMT: live columns per staged tile, one per lane
constexpr int kBMmaThreads = 128; // tensor-core split pass: 4 warps, each with its own tiles

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

// A split with no live column: only its maxima are read, by the merge.
__device__ __forceinline__ void write_empty(const AncestryArgs& a, int64_t part0) {
  for (int i = threadIdx.x; i < a.hpb * a.K; i += blockDim.x)
    a.part_m[(part0 + (int64_t)(i / a.K) * a.n_split) * a.K + i % a.K] = -INFINITY;
}

// The split pass's partials of head h: (max, denominator) per beam and the
// unnormalised w.V, from merge_warps, then the barrier before the merge
// area is the next head's ring.
template <int D>
__device__ __forceinline__ void write_partials(const AncestryArgs& a, float* merge,
                                               int64_t part, const float (&m_run)[2],
                                               const float (&l_run)[2],
                                               const float (&o)[D / 8][4]) {
  const int K = a.K;
  merge_warps<D>(merge, K, m_run, l_run, o, [&](int k, int d, float M, float l, float acc) {
    if (d == 0) {
      a.part_m[part * K + k] = M;
      a.part_l[part * K + k] = l;
    }
    a.part_acc[(part * K + k) * D + d] = acc;
  });
  __syncthreads();
}

// Shared memory of the bf16 split pass: each warp's 2-stage ring of TW-row
// K and V tiles (swizzled, as flash_attention_mma.cuh's A and G read them),
// the head's q as 16 zero-padded rows, the live columns and the
// compaction's counts. The warps' (O, m, l) for the block's merge go over
// the drained ring.
template <int D>
struct BMma {
  static constexpr int kTW = D <= 64 ? 32 : 16;  // live columns per warp tile
  static constexpr int kTile = kTW * D * 2;      // one K (or V) tile, bf16
  static constexpr int kRing = 0;
  static constexpr int kQ = kRing + 4 * 2 * 2 * kTile;
  static constexpr int kLive = kQ + 16 * D * 2;
  static constexpr int kCount = kLive + kBSpan * 4;
  static constexpr int kBytes = kCount + 4 * 4 * 4;
  static_assert(4 * 16 * (D + 2) * 4 <= kQ - kRing, "the merge fits over the ring");
};

// bf16 split pass: block (b, head group) x split. After the compaction,
// warp w takes live tiles w, w + 4, ... of each head, each gathered by its
// own 32 lanes through its own 2-stage cp.async ring, and keeps its own
// online softmax: S = Q.K^T with the K beams as the 16 rows of
// mma.m16n8k16 (rows past K are zeros) and the tile's columns as n, scores
// off a beam's path set to -inf (weight 0), then O += bf16(P).V with P
// from the accumulators (acc_to_a) and V through ldmatrix.trans. No block
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
#pragma unroll
      for (int n = 0; n < TW / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * tq + (e & 1), beam = g + 8 * (e >> 1);
          const bool on = c < n_in && ((live[r0 + c] >> (16 + beam)) & 1u);
          s[n][e] = on ? s[n][e] : -INFINITY;
        }
      }
      softmax_tile(s, o, m_run, l_run);
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
    write_partials<D>(a, merge, part0 + (int64_t)(h - h0) * a.n_split, m_run, l_run, o);
  }
}

// Shared memory of the fp32 split pass: each warp's 2-stage ring of TW-row
// raw K and V tiles (decode_attention.cuh's rsw), the head's q as 16
// zero-padded raw rows, the live columns and the compaction's counts; the
// warps' (O, m, l) for the block's merge go over the drained ring. 44 KB
// at Dh = 64: five blocks per SM. Tiles of 8 rows were measured against 16
// and 32 (tools/kernel_ab.py, PERF.md): the smaller rings let 5 blocks
// share an SM instead of 2 or 1, so more compactions and gathers are in
// flight, and the split pass took 212 us against 246 and 290 at B = 128.
template <int D>
struct BTf32 {
  static constexpr int kTW = 8;                 // live columns per warp tile
  static constexpr int kTile = kTW * D;         // floats of one K (or V) tile
  static constexpr int kRing = 0;
  static constexpr int kQ = kRing + 4 * 2 * 2 * kTile * 4;
  static constexpr int kLive = kQ + 16 * D * 4;
  static constexpr int kCount = kLive + kBSpan * 4;
  static constexpr int kBytes = kCount + 4 * 4 * 4;
  static_assert(4 * 16 * (D + 2) * 4 <= kQ - kRing, "the merge fits over the ring");
};
constexpr int kBF32Blocks = kSmemPerSM / (BTf32<64>::kBytes + 1024);  // per SM at Dh = 64

// fp32 split pass: bf16's blocks, compaction, rings and online softmax,
// every product in 3xTF32 on mma.m16n8k8 (mma3: lo.hi + hi.lo + hi.hi, fp32
// accumulators). Q is split once per head (into registers for Dh <= 64; at
// Dh = 128 its fragments are read and split from the raw q rows at each
// tile, where holding them would spill); K's and V's fragments are split
// as they are read from the warp's raw tile; P, in fp32, is split from the
// S accumulators (acc_to_a32: an n-tile over 8 columns is the A fragment
// of the k-step over them, in the k-step order 0, 2, 4, 6, 1, 3, 5, 7).
template <int D>
__global__ void __launch_bounds__(kBMmaThreads) ancestry_split_kernel_tf32(const AncestryArgs a) {
  using C = BTf32<D>;
  constexpr int KS = D / 8, NT = D / 8, TW = C::kTW, CH = D / 4, TF = C::kTile;
  constexpr bool Q_REGS = D <= 64;
  extern __shared__ __align__(128) unsigned char f_smem[];
  uint32_t* live = reinterpret_cast<uint32_t*>(f_smem + C::kLive);
  float* merge = reinterpret_cast<float*>(f_smem + C::kRing);
  float* q_tile = reinterpret_cast<float*>(f_smem + C::kQ);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int K = a.K, groups = a.H / a.hpb;
  const int b = blockIdx.x / groups, h0 = (blockIdx.x % groups) * a.hpb, split = blockIdx.y;
  const int c0 = split * a.span, c1 = min(a.TS, c0 + a.span);
  const int n_live = compact_live<kBMmaThreads, 4>(a.flat_rep + (int64_t)b * K * a.TS, K, a.TS,
                                                   c0, c1, live,
                                                   reinterpret_cast<int*>(f_smem + C::kCount));
  const int64_t part0 = ((int64_t)b * a.H + h0) * a.n_split + split;  // (bh, split) of head h0
  if (n_live == 0) return write_empty(a, part0);

  const int n_tiles = (n_live + TW - 1) / TW;
  const float* kvb = static_cast<const float*>(a.kv) + b * a.kv_sb + (int64_t)a.layer * a.kv_sl;
  float* ring = reinterpret_cast<float*>(f_smem + C::kRing) + warp * 2 * 2 * TF;
  for (int h = h0; h < h0 + a.hpb; ++h) {
    const float* slab = kvb + (int64_t)h * a.kv_sh;
    auto gather = [&](int stage, int i) {  // live tile i into this warp's stage; past n_live zeros
      float* kt = ring + stage * 2 * TF;
      const int r0 = i * TW, n = min(TW, n_live - r0);
      for (int e = lane; e < TW * 2 * CH; e += 32) {
        const int r = e / (2 * CH), c = e % (2 * CH);
        const bool ok = r < n;
        const int col = c0 + (ok ? (int)(live[r0 + r] & 0xFFFFu) : 0);
        cp_async16(smem_u32(c < CH ? kt + rsw<D>(r, 4 * c) : kt + TF + rsw<D>(r, 4 * (c - CH))),
                   slab + (int64_t)col * a.kv_sj + c * 4, ok);
      }
    };
    int i = warp;
    if (i < n_tiles) {  // the warp's first tile goes in flight before q is staged
      gather(0, i);
      cp_async_commit();
    }
    const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
    for (int e = threadIdx.x; e < 16 * D; e += kBMmaThreads) {
      const int r = e / D, d = e % D;
      q_tile[rsw<D>(r, d)] = r < K ? q[r * a.q_sk + d] : 0.f;
    }
    __syncthreads();
    FragA32 qf[Q_REGS ? KS : 1];
    if constexpr (Q_REGS) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) frag_a32_rows<D>(qf[kk], q_tile, 0, kk);
    }
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
      const float* kt = ring + stage * 2 * TF;
      const float* vt = kt + TF;
      const int r0 = i * TW, n_in = min(TW, n_live - r0);
      float s[TW / 8][4];
#pragma unroll
      for (int n = 0; n < TW / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        FragA32 qa;
        if constexpr (Q_REGS)
          qa = qf[kk];
        else
          frag_a32_rows<D>(qa, q_tile, 0, kk);
#pragma unroll
        for (int n = 0; n < TW / 8; ++n) {
          FragB32 kf;
          frag_b32_rows<D>(kf, kt, 8 * n, kk);
          mma3(s[n], qa, kf);
        }
      }
      // Element e of n-tile n: beam g + 8 (e >> 1), column 8 n + 2 tq + (e & 1).
#pragma unroll
      for (int n = 0; n < TW / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * tq + (e & 1), beam = g + 8 * (e >> 1);
          const bool on = c < n_in && ((live[r0 + c] >> (16 + beam)) & 1u);
          s[n][e] = on ? s[n][e] : -INFINITY;
        }
      }
      softmax_tile(s, o, m_run, l_run);
#pragma unroll
      for (int n = 0; n < TW / 8; ++n) {
        FragA32 pa;
        acc_to_a32(pa, s[n]);
#pragma unroll
        for (int dn = 0; dn < NT; ++dn) {
          FragB32 vf;
          frag_bt32_rows<D>(vf, vt, 8 * n, dn);
          mma3(o[dn], pa, vf);
        }
      }
      __syncwarp();  // the stage is refilled by the next iteration's gather
    }
    write_partials<D>(a, merge, part0 + (int64_t)(h - h0) * a.n_split, m_run, l_run, o);
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

// SIMT split pass (bf16's alternative design, tools/kernel_ab.py variant
// 2): the same blocks and compaction; then the block gathers each head's
// live rows, 32 at a time, into a 2-stage cp.async ring and runs one online
// softmax for all K beams over each tile: a (beam, column) pair per thread for the scores
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

// Variant 3 (tools/kernel_ab.py; the port of scripts_dev/interleave_probe.py:67):
// one block per (b, h) over the whole interleaved slab, no split, a
// single-pass softmax with all of the row's scores in shared memory. It
// takes UnitDecoder.step's contract (TS = T.K, a beam on at most one column
// of a step), so the scores are K.T floats. Warps stride over 32-column
// chunks of flat_rep, a ballot picks the live columns, each is read once
// for all the beams on it (a lane's Dh / 32 dims, then a warp sum per
// beam); one warp per beam takes the max and the denominator with the self
// logit; the V pass adds each weight (rounded to T, as the plain version
// rounds it) times its row into per-warp fp32 sums, merged in warp order.
template <typename T, int DH>
__global__ void __launch_bounds__(kBThreads) ancestry_whole_kernel(const AncestryArgs a) {
  constexpr int E = (DH + 31) / 32, NW = kBThreads / 32;
  extern __shared__ float w_smem[];
  const int K = a.K, Tn = a.TS / K, b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  float* sc = w_smem;                      // [K][Tn]
  float* part = sc + K * Tn;               // [NW][K][DH]
  float* st = part + NW * K * DH;          // m, den, p_self: [3][16]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kn = static_cast<const T*>(a.k_new) + b * a.kn_sb + h * a.kn_sh;
  const T* vn = static_cast<const T*>(a.v_new) + b * a.vn_sb + h * a.vn_sh;
  const T* slab = static_cast<const T*>(a.kv) + b * a.kv_sb + (int64_t)a.layer * a.kv_sl + h * a.kv_sh;
  const int* fr = a.flat_rep + (int64_t)b * K * a.TS;
  for (int i = threadIdx.x; i < K * Tn; i += kBThreads) sc[i] = -INFINITY;
  float qv[kMaxBeams][E];
#pragma unroll
  for (int k = 0; k < kMaxBeams; ++k)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane + 32 * e;
      qv[k][e] = k < K && d < DH ? to_f32(q[k * a.q_sk + d]) : 0.f;
    }
  __syncthreads();
  for (int pass = 0; pass < 2; ++pass) {
    float acc[kMaxBeams][E];
#pragma unroll
    for (int k = 0; k < kMaxBeams; ++k)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[k][e] = 0.f;
    for (int j0 = warp * 32; j0 < a.TS; j0 += kBThreads) {
      const int j = j0 + lane;
      unsigned beams = 0;
      if (j < a.TS)
        for (int k = 0; k < K; ++k) beams |= (unsigned)(fr[(int64_t)k * a.TS + j] == j) << k;
      unsigned live = __ballot_sync(0xffffffffu, beams != 0);
      while (live) {
        const int c = __ffs(live) - 1;
        live &= live - 1;
        const unsigned on = __shfl_sync(0xffffffffu, beams, c);
        const int col = j0 + c, t = col / K;
        float x[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = lane + 32 * e;
          x[e] = d < DH ? to_f32(slab[(int64_t)col * a.kv_sj + pass * DH + d]) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < kMaxBeams; ++k) {
          if (!((on >> k) & 1u)) continue;  // warp-uniform
          if (pass == 0) {
            float s = 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e) s = fmaf(qv[k][e], x[e], s);
            s = warp_sum(s);
            if (lane == 0) sc[k * Tn + t] = s;
          } else {
            const float w = to_f32(from_f32<T>(expf(sc[k * Tn + t] - st[k]) / st[16 + k]));
#pragma unroll
            for (int e = 0; e < E; ++e) acc[k][e] = fmaf(w, x[e], acc[k][e]);
          }
        }
      }
    }
    if (pass == 1) {
#pragma unroll
      for (int k = 0; k < kMaxBeams; ++k)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = lane + 32 * e;
          if (k < K && d < DH) part[(warp * K + k) * DH + d] = acc[k][e];
        }
      break;
    }
    __syncthreads();  // every score is in shared memory
    for (int k = warp; k < K; k += NW) {
      float self = 0.f;
      for (int d = lane; d < DH; d += 32) self = fmaf(to_f32(q[k * a.q_sk + d]), to_f32(kn[k * a.kn_sk + d]), self);
      self = warp_sum(self);
      float m = self;
      for (int t = lane; t < Tn; t += 32) m = fmaxf(m, sc[k * Tn + t]);
      m = warp_max(m);
      float den = 0.f;
      for (int t = lane; t < Tn; t += 32)
        if (sc[k * Tn + t] != -INFINITY) den += expf(sc[k * Tn + t] - m);
      den = warp_sum(den);
      const float p_self = expf(self - m);
      if (lane == 0) st[k] = m, st[16 + k] = den + p_self, st[32 + k] = p_self;
    }
    __syncthreads();
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;
  for (int i = threadIdx.x; i < K * DH; i += kBThreads) {
    const int k = i / DH, d = i % DH;
    float num = 0.f;
    for (int w = 0; w < NW; ++w) num += part[(w * K + k) * DH + d];
    num = fmaf(st[32 + k] / st[16 + k], to_f32(vn[k * a.vn_sk + d]), num);
    out[k * a.o_sk + d] = from_f32<T>(num);
  }
}

template <typename T, int DH>
cudaError_t launch_ancestry_whole(const AncestryArgs& a, int B, cudaStream_t stream) {
  const int smem = 4 * (a.K * (a.TS / a.K) + (kBThreads / 32) * a.K * DH + 48);
  cudaError_t err = allow_smem(ancestry_whole_kernel<T, DH>, smem);
  if (err != cudaSuccess) return err;
  ancestry_whole_kernel<T, DH><<<B * a.H, kBThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// MMA: the tensor-core split pass of T (bf16 m16n8k16, or fp32 3xTF32),
// else the SIMT one (bf16's alternative design); then the merge.
template <typename T, int DH, bool MMA>
cudaError_t launch_ancestry(const AncestryArgs& a, int B, cudaStream_t stream) {
  const dim3 grid(B * (a.H / a.hpb), a.n_split);
  cudaError_t err;
  if constexpr (!MMA) {
    constexpr int smem = BSimt<T, DH>::kBytes;
    err = allow_smem(ancestry_split_kernel_simt<T, DH>, smem);
    if (err != cudaSuccess) return err;
    ancestry_split_kernel_simt<T, DH><<<grid, kBThreads, smem, stream>>>(a);
  } else if constexpr (std::is_same<T, float>::value) {
    constexpr int smem = BTf32<DH>::kBytes;
    err = allow_smem_max(ancestry_split_kernel_tf32<DH>, smem);
    if (err != cudaSuccess) return err;
    ancestry_split_kernel_tf32<DH><<<grid, kBMmaThreads, smem, stream>>>(a);
  } else {
    constexpr int smem = BMma<DH>::kBytes;
    err = allow_smem(ancestry_split_kernel_mma<DH>, smem);
    if (err != cudaSuccess) return err;
    ancestry_split_kernel_mma<DH><<<grid, kBMmaThreads, smem, stream>>>(a);
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

constexpr int kCThreads = 128;  // split pass and merge: 4 warps
constexpr int kCMaxSplits = 16;

struct CrossArgs {
  const void* q;       // (B, H, K, Dh) through strides, pre-scaled
  int64_t q_sb, q_sh, q_sk;
  const void* kv;      // (B, H, S, 2.Dh) contiguous
  const float* bias;   // (B, S) additive
  void* out;           // (B, H, K, Dh) through strides
  int64_t o_sb, o_sh, o_sk;
  float* part_m;       // (B.H, n_split, K) max of each split, -inf if it saw no column
  float* part_l;       // (B.H, n_split, K) its denominator
  float* part_acc;     // (B.H, n_split, K, Dh) its unnormalised P.V
  int H, K, S, n_split, tps;  // tps: key tiles per split
};

// The split pass's result: with one split out = acc / l in T, else the
// split's (max, denominator) per row and unnormalised P.V, for the merge.
template <typename T, int D>
__device__ __forceinline__ void write_cross(const CrossArgs& a, float* merge, int b, int h,
                                            const float (&m_run)[2], const float (&l_run)[2],
                                            const float (&o)[D / 8][4]) {
  const int K = a.K;
  const int64_t part = ((int64_t)b * a.H + h) * a.n_split + blockIdx.y;
  T* out = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;
  merge_warps<D>(merge, K, m_run, l_run, o, [&](int k, int d, float M, float l, float acc) {
    if (a.n_split == 1) {
      out[k * a.o_sk + d] = from_f32<T>(acc / l);
      return;
    }
    if (d == 0) {
      a.part_m[part * K + k] = M;
      a.part_l[part * K + k] = l;
    }
    a.part_acc[(part * K + k) * D + d] = acc;
  });
}

// Shared memory of the bf16 split pass: each warp's 2-stage ring of TW-key
// K and V tiles (swizzled) and their TW bias values, then the head's q as
// 16 zero-padded rows. The warps' (O, m, l) for the block's merge go over
// the drained ring.
template <int D>
struct CMma {
  static constexpr int kTW = D <= 64 ? 32 : 16;  // keys per warp tile
  static constexpr int kTile = kTW * D * 2;      // one K (or V) tile, bf16
  static constexpr int kStage = 2 * kTile + kTW * 4;
  static constexpr int kRing = 0;
  static constexpr int kQ = kRing + 4 * 2 * kStage;
  static constexpr int kBytes = kQ + 16 * D * 2;
  static_assert(4 * 16 * (D + 2) * 4 <= kQ - kRing, "the merge fits over the ring");
  static_assert(kStage % 16 == 0, "16-byte aligned stages");
};

// bf16 split pass: block (b.h, split). Warp w takes key tiles i0 + w, i0 +
// w + 4, ... of the split's [i0, i1), each gathered by its own lanes, and
// keeps its own online softmax with the K rows as mma rows; the four
// warps' (m, l, O) merge at the end, into the output (one split) or the
// split's partial.
template <int D>
__global__ void __launch_bounds__(kCThreads) cross_decode_split_kernel_mma(const CrossArgs a) {
  using C = CMma<D>;
  constexpr int KS = D / 16, NT = D / 8, TW = C::kTW, CH = D / 8;
  extern __shared__ __align__(128) unsigned char c_smem[];
  float* merge = reinterpret_cast<float*>(c_smem + C::kRing);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
  const int K = a.K, S = a.S;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, split = blockIdx.y;
  const int i1 = min((S + TW - 1) / TW, (split + 1) * a.tps);
  const bf16* slab = static_cast<const bf16*>(a.kv) + (int64_t)bh * S * 2 * D;
  const float* bias = a.bias + (int64_t)b * S;
  const uint32_t ring = smem_u32(c_smem + C::kRing) + warp * 2 * C::kStage;
  auto gather = [&](int stage, int i) {  // key tile i into this warp's stage; past S zeros
    const uint32_t kt = ring + stage * C::kStage, vt = kt + C::kTile;
    const int s0 = i * TW;
    for (int e = lane; e < TW * 2 * CH; e += 32) {
      const int r = e / (2 * CH), c = e % (2 * CH);
      const bool ok = s0 + r < S;
      cp_async16(c < CH ? kt + swz<D>(r, c) : vt + swz<D>(r, c - CH),
                 slab + (int64_t)(ok ? s0 + r : 0) * 2 * D + c * 8, ok);
    }
    if (lane < TW) {
      const bool ok = s0 + lane < S;
      cp_async4(kt + 2 * C::kTile + lane * 4, bias + (ok ? s0 + lane : 0), ok);
    }
  };
  int i = split * a.tps + warp;
  if (i < i1) {  // the warp's first tile goes in flight before q is staged
    gather(0, i);
    cp_async_commit();
  }
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  for (int e = threadIdx.x; e < 16 * D; e += kCThreads) {
    const int r = e / D, d = e % D;
    *reinterpret_cast<bf16*>(c_smem + C::kQ + swz<D>(r, d / 8) + (d % 8) * 2) =
        r < K ? q[r * a.q_sk + d] : __float2bfloat16(0.f);
  }
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) frag_a<D>(qf[kk], smem_u32(c_smem + C::kQ), 0, kk);
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int j = 0; i < i1; ++j, i += 4) {
    const int stage = j & 1;
    if (i + 4 < i1) {
      gather(stage ^ 1, i + 4);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const uint32_t kt = ring + stage * C::kStage, vt = kt + C::kTile;
    const float* bs = reinterpret_cast<const float*>(c_smem + C::kRing + warp * 2 * C::kStage +
                                                     stage * C::kStage + 2 * C::kTile);
    const int n_in = min(TW, S - i * TW);
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
    // Element e of n-tile n: row g + 8 (e >> 1), key i.TW + 8 n + 2 tq + (e & 1).
#pragma unroll
    for (int n = 0; n < TW / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * tq + (e & 1);
        s[n][e] = c < n_in ? s[n][e] + bs[c] : -INFINITY;
      }
    }
    softmax_tile(s, o, m_run, l_run);
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
  write_cross<bf16, D>(a, merge, b, h, m_run, l_run, o);
}

// Shared memory of the fp32 split pass: each warp's 2-stage ring of TW-key
// raw K and V tiles (rsw) and their TW bias values, then the head's q as
// 16 zero-padded raw rows; the warps' (O, m, l) go over the drained ring.
// ~70 KB at Dh = 64: three blocks per SM.
template <int D>
struct CTf32 {
  static constexpr int kTW = D <= 64 ? 16 : 8;  // keys per warp tile
  static constexpr int kTile = kTW * D;         // floats of one K (or V) tile
  static constexpr int kStage = 2 * kTile + kTW;  // floats: K, V, bias
  static constexpr int kRing = 0;
  static constexpr int kQ = kRing + 4 * 2 * kStage * 4;
  static constexpr int kBytes = kQ + 16 * D * 4;
  static_assert(4 * 16 * (D + 2) * 4 <= kQ - kRing, "the merge fits over the ring");
  static_assert(kStage % 4 == 0, "16-byte aligned stages");
};

// fp32 split pass: bf16's blocks, rings and online softmax with B's fp32
// products: 3xTF32 on mma.m16n8k8, Q split once (into registers for Dh <=
// 64), K's and V's fragments split as they are read from the raw tile, P
// split from the S accumulators.
template <int D>
__global__ void __launch_bounds__(kCThreads) cross_decode_split_kernel_tf32(const CrossArgs a) {
  using C = CTf32<D>;
  constexpr int KS = D / 8, NT = D / 8, TW = C::kTW, CH = D / 4, TF = C::kTile;
  constexpr bool Q_REGS = D <= 64;
  extern __shared__ __align__(128) unsigned char c_smem[];
  float* merge = reinterpret_cast<float*>(c_smem + C::kRing);
  float* q_tile = reinterpret_cast<float*>(c_smem + C::kQ);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
  const int K = a.K, S = a.S;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, split = blockIdx.y;
  const int i1 = min((S + TW - 1) / TW, (split + 1) * a.tps);
  const float* slab = static_cast<const float*>(a.kv) + (int64_t)bh * S * 2 * D;
  const float* bias = a.bias + (int64_t)b * S;
  float* ring = reinterpret_cast<float*>(c_smem + C::kRing) + warp * 2 * C::kStage;
  auto gather = [&](int stage, int i) {  // key tile i into this warp's stage; past S zeros
    float* kt = ring + stage * C::kStage;
    const int s0 = i * TW;
    for (int e = lane; e < TW * 2 * CH; e += 32) {
      const int r = e / (2 * CH), c = e % (2 * CH);
      const bool ok = s0 + r < S;
      cp_async16(smem_u32(c < CH ? kt + rsw<D>(r, 4 * c) : kt + TF + rsw<D>(r, 4 * (c - CH))),
                 slab + (int64_t)(ok ? s0 + r : 0) * 2 * D + c * 4, ok);
    }
    if (lane < TW) {
      const bool ok = s0 + lane < S;
      cp_async4(smem_u32(kt + 2 * TF + lane), bias + (ok ? s0 + lane : 0), ok);
    }
  };
  int i = split * a.tps + warp;
  if (i < i1) {  // the warp's first tile goes in flight before q is staged
    gather(0, i);
    cp_async_commit();
  }
  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  for (int e = threadIdx.x; e < 16 * D; e += kCThreads) {
    const int r = e / D, d = e % D;
    q_tile[rsw<D>(r, d)] = r < K ? q[r * a.q_sk + d] : 0.f;
  }
  __syncthreads();
  FragA32 qf[Q_REGS ? KS : 1];
  if constexpr (Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) frag_a32_rows<D>(qf[kk], q_tile, 0, kk);
  }
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int j = 0; i < i1; ++j, i += 4) {
    const int stage = j & 1;
    if (i + 4 < i1) {
      gather(stage ^ 1, i + 4);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const float* kt = ring + stage * C::kStage;
    const float* vt = kt + TF;
    const float* bs = kt + 2 * TF;
    const int n_in = min(TW, S - i * TW);
    float s[TW / 8][4];
#pragma unroll
    for (int n = 0; n < TW / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      FragA32 qa;
      if constexpr (Q_REGS)
        qa = qf[kk];
      else
        frag_a32_rows<D>(qa, q_tile, 0, kk);
#pragma unroll
      for (int n = 0; n < TW / 8; ++n) {
        FragB32 kf;
        frag_b32_rows<D>(kf, kt, 8 * n, kk);
        mma3(s[n], qa, kf);
      }
    }
    // Element e of n-tile n: row g + 8 (e >> 1), key i.TW + 8 n + 2 tq + (e & 1).
#pragma unroll
    for (int n = 0; n < TW / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * tq + (e & 1);
        s[n][e] = c < n_in ? s[n][e] + bs[c] : -INFINITY;
      }
    }
    softmax_tile(s, o, m_run, l_run);
#pragma unroll
    for (int n = 0; n < TW / 8; ++n) {
      FragA32 pa;
      acc_to_a32(pa, s[n]);
#pragma unroll
      for (int dn = 0; dn < NT; ++dn) {
        FragB32 vf;
        frag_bt32_rows<D>(vf, vt, 8 * n, dn);
        mma3(o[dn], pa, vf);
      }
    }
    __syncwarp();  // the stage is refilled by the next iteration's gather
  }
  write_cross<float, D>(a, merge, b, h, m_run, l_run, o);
}

// Merge (n_split > 1): one block per (b, h) folds the splits' (m, l, O) in
// split order; a split that saw no column (max -inf) weighs 0. bf16 takes
// the split pass's exp_e, fp32 expf.
template <typename T, int D>
__global__ void __launch_bounds__(kCThreads) cross_decode_merge_kernel(const CrossArgs a) {
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, K = a.K, S = a.n_split;
  const int64_t part0 = (int64_t)bh * S;
  T* out = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;
  for (int e = threadIdx.x; e < K * D; e += kCThreads) {
    const int k = e / D, d = e % D;
    float M = -INFINITY;
    for (int sp = 0; sp < S; ++sp) M = fmaxf(M, a.part_m[(part0 + sp) * K + k]);
    float l = 0.f, acc = 0.f;
    for (int sp = 0; sp < S; ++sp) {
      const float m = a.part_m[(part0 + sp) * K + k];
      if (m == -INFINITY) continue;  // its l and O may be unwritten
      const float sc = std::is_same<T, float>::value ? expf(m - M) : exp_e(m - M);
      l = fmaf(sc, a.part_l[(part0 + sp) * K + k], l);
      acc = fmaf(sc, a.part_acc[((part0 + sp) * K + k) * D + d], acc);
    }
    out[k * a.o_sk + d] = from_f32<T>(acc / l);
  }
}

// The split pass of T (bf16 m16n8k16, or fp32 3xTF32), then the merge
// when n_split > 1.
template <typename T, int D>
cudaError_t launch_cross(const CrossArgs& a, int B, cudaStream_t stream) {
  const dim3 grid(B * a.H, a.n_split);
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    constexpr int smem = CTf32<D>::kBytes;
    err = allow_smem_max(cross_decode_split_kernel_tf32<D>, smem);
    if (err != cudaSuccess) return err;
    cross_decode_split_kernel_tf32<D><<<grid, kCThreads, smem, stream>>>(a);
  } else {
    constexpr int smem = CMma<D>::kBytes;
    err = allow_smem(cross_decode_split_kernel_mma<D>, smem);
    if (err != cudaSuccess) return err;
    cross_decode_split_kernel_mma<D><<<grid, kCThreads, smem, stream>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  cross_decode_merge_kernel<T, D><<<B * a.H, kCThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_cross(int DH, const CrossArgs& a, int B, cudaStream_t stream) {
  switch (DH) {
    case 16: return launch_cross<T, 16>(a, B, stream);
    case 32: return launch_cross<T, 32>(a, B, stream);
    case 64: return launch_cross<T, 64>(a, B, stream);
    case 128: return launch_cross<T, 128>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Keys per warp tile of C's split pass.
int cross_tile(int dtype, int DH) {
  if (dtype == kFloat32) return DH <= 64 ? CTf32<64>::kTW : CTf32<128>::kTW;
  return DH <= 64 ? CMma<64>::kTW : CMma<128>::kTW;
}

}  // namespace
}  // namespace mm

// C entries: each returns cudaGetLastError() after its launch (0 on success).
// Kernel B's split count for B batch rows of H heads over TS columns:
// enough blocks of (b, head group) x split for one wave on the card (as
// many tensor-core blocks per SM as fit, 3 in bf16 and kBF32Blocks in
// fp32, or 8 SIMT blocks), each split at least one SIMT tile and at most
// kBSpan columns wide, at most kBMaxSplits. ``variant`` as
// mm_ancestry_decode_attention's.
extern "C" int mm_ancestry_decode_splits(int dtype, int B, int H, int TS, int variant) {
  if (variant == 3) return 1;
  const int groups = B * (variant == 1 ? 1 : H);
  const int per_sm = variant == 2 ? 8 : (dtype == mm::kFloat32 ? mm::kBF32Blocks : 3);
  const int want = (per_sm * mm::kSMs + groups - 1) / groups;
  const int lo = (TS + mm::kBSpan - 1) / mm::kBSpan;
  int hi = (TS + mm::kBTile - 1) / mm::kBTile;
  hi = hi < mm::kBMaxSplits ? hi : mm::kBMaxSplits;
  return want < lo ? lo : (want > hi ? (hi > lo ? hi : lo) : want);
}

// Kernel B: the split pass then the merge on ``stream``; ``scratch`` holds
// (B.H.n_split.K) maxima, as many denominators, then (B.H.n_split.K.Dh)
// partial sums, fp32, with n_split from mm_ancestry_decode_splits.
// ``variant`` (0 in the port; the others for tools/kernel_ab.py): 0 one
// head per block, on the tensor cores (bf16, or fp32 in 3xTF32); 1 all H
// heads of a batch row per block (the reference's grid); 2 the SIMT pass,
// bf16 only; 3 one block per (b, h) over the whole slab, no split
// (ancestry_whole_kernel: Dh = 64, TS = T.K, n_split 1).
extern "C" int mm_ancestry_decode_attention(
    int dtype, int variant, const void* q, const void* k_new, const void* v_new,
    const void* kv, const void* flat_rep, void* out, void* scratch,
    int B, int H, int K, int DH, int TS, int layer, int n_split,
    int64_t q_sb, int64_t q_sh, int64_t q_sk, int64_t kn_sb, int64_t kn_sh, int64_t kn_sk,
    int64_t vn_sb, int64_t vn_sh, int64_t vn_sk, int64_t o_sb, int64_t o_sh, int64_t o_sk,
    int64_t kv_sb, int64_t kv_sl, int64_t kv_sh, int64_t kv_sj, void* stream) {
  if (K < 1 || K > mm::kMaxBeams || TS < 1 || n_split < 1 || n_split > mm::kBMaxSplits ||
      variant < 0 || variant > 3 || (variant == 3 && (TS % K != 0 || n_split != 1)) ||
      (dtype != mm::kFloat32 && dtype != mm::kBFloat16) ||
      (variant == 2 && dtype != mm::kBFloat16))
    return (int)cudaErrorInvalidValue;
  const int span = (TS + n_split - 1) / n_split;
  if (span > mm::kBSpan && variant != 3) return (int)cudaErrorInvalidValue;
  float* part = static_cast<float*>(scratch);
  const int64_t n_part = (int64_t)B * H * n_split * K;
  const mm::AncestryArgs a{q, k_new, v_new, q_sb, q_sh, q_sk, kn_sb, kn_sh, kn_sk,
                           vn_sb, vn_sh, vn_sk, kv, kv_sb, kv_sl, kv_sh, kv_sj,
                           static_cast<const int*>(flat_rep), out, o_sb, o_sh, o_sk,
                           part, part + n_part, part + 2 * n_part,
                           H, K, TS, layer, n_split, span, variant == 1 ? H : 1};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool f32 = dtype == mm::kFloat32;
  if (variant == 3) {
    const int smem = 4 * (TS + 8 * K * DH + 48);
    if (smem > mm::kSmemPerSM - 1024 || DH != 64) return (int)cudaErrorInvalidValue;
    return f32 ? (int)mm::launch_ancestry_whole<float, 64>(a, B, st)
               : (int)mm::launch_ancestry_whole<__nv_bfloat16, 64>(a, B, st);
  }
  if (f32) return (int)mm::dispatch_ancestry<float, true>(DH, a, B, st);
  return variant == 2 ? (int)mm::dispatch_ancestry<__nv_bfloat16, false>(DH, a, B, st)
                      : (int)mm::dispatch_ancestry<__nv_bfloat16, true>(DH, a, B, st);
}

// Kernel C's split count for B batch rows of H heads over S columns: enough
// (b.h) x split blocks for about two per SM, each split a whole number (>=
// 1) of key tiles (32 keys in bf16, 16 in fp32; half that at Dh = 128), at
// most kCMaxSplits. B.H, S and the tile alone decide it, not the K rows:
// more than 16 rows (a prefill) take A, which does not split.
extern "C" int mm_cross_decode_splits(int dtype, int B, int H, int K, int S, int DH) {
  if (S < 1 || K < 1 || (dtype != mm::kFloat32 && dtype != mm::kBFloat16)) return 1;
  const int tile = mm::cross_tile(dtype, DH);
  const int n_tiles = (S + tile - 1) / tile;
  int n = (2 * mm::kSMs + B * H - 1) / (B * H);
  n = n < n_tiles ? n : n_tiles;
  n = n < mm::kCMaxSplits ? n : mm::kCMaxSplits;
  const int tps = (n_tiles + n - 1) / n;
  return (n_tiles + tps - 1) / tps;
}

// Kernel C on ``stream``. q and out go through their (b, h, k) strides (the
// head dim dense). Up to 16 rows the split pass of the dtype (then the
// merge when n_split > 1; ``scratch`` holds (B.H.n_split.K) maxima, as many
// denominators and (B.H.n_split.K.Dh) partial sums, fp32); more rows A's
// forward of the dtype, which needs out beam-major contiguous (B, K, H, Dh)
// and q's rows 16-byte aligned.
extern "C" int mm_cross_decode_attention(
    int dtype, const void* q, const void* kv, const void* bias, void* out, void* scratch,
    int B, int H, int K, int DH, int S, int n_split, int64_t q_sb, int64_t q_sh, int64_t q_sk,
    int64_t o_sb, int64_t o_sh, int64_t o_sk, void* stream) {
  if (K < 1 || S < 1 || (dtype != mm::kFloat32 && dtype != mm::kBFloat16) ||
      n_split != mm_cross_decode_splits(dtype, B, H, K, S, DH))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool f32 = dtype == mm::kFloat32;
  if (K > mm::kMaxBeams) {  // the prefill's rows: A over the slab's K and V halves
    if (o_sk != (int64_t)H * DH || o_sh != DH || o_sb != (int64_t)K * H * DH)
      return (int)cudaErrorInvalidValue;
    const int64_t row = 2 * DH, head = (int64_t)S * row, batch = H * head;
    const void* v = static_cast<const char*>(kv) + DH * (f32 ? 4 : 2);
    const mm::FlashArgs f{q, kv, v, static_cast<const float*>(bias), out, K, S, H,
                          q_sb, q_sk, q_sh, batch, row, head, batch, row, head,
                          1.0f, 0, 0.0f, 1.0f, 0u, 0u, static_cast<uint32_t>(H), 0u,
                          nullptr, nullptr};
    return f32 ? (int)mm::launch_flash_fwd_f32(f, B, DH, false, false, st)
               : (int)mm::launch_flash_fwd_mma(f, B, DH, false, false, st);
  }
  const int n_tiles = (S + mm::cross_tile(dtype, DH) - 1) / mm::cross_tile(dtype, DH);
  float* part = static_cast<float*>(scratch);
  const int64_t n_part = (int64_t)B * H * n_split * K;
  const mm::CrossArgs a{q, q_sb, q_sh, q_sk, kv, static_cast<const float*>(bias), out,
                        o_sb, o_sh, o_sk, part, part + n_part, part + 2 * n_part,
                        H, K, S, n_split, (n_tiles + n_split - 1) / n_split};
  return f32 ? (int)mm::dispatch_cross<float>(DH, a, B, st)
             : (int)mm::dispatch_cross<__nv_bfloat16>(DH, a, B, st);
}
