// Kernel H — encoder self-attention backward (the fused attention VJP).
// This file holds its fp32 version, on the tensor cores in 3xTF32; bf16 runs
// on the tensor cores in bf16 (flash_attention_bwd_mma.cu), the same split
// and formulas.
//
// Replaces the Pallas TPU kernel mm_s2ut/ops/attention.py:_attn_bwd_kernel
// (pallas_call at attention.py:500, launched by _flash_bwd_call), the
// backward of the reference's flash-attention custom VJP. For the forward
// of kernel A or G (csrc/flash_attention.cu) it computes, per (b, h),
//   P[t, s]  = exp(l[t, s] - m[t]) / L[t]       (the forward's softmax,
//              l recomputed exactly as the forward computes it, m and L
//              the row max and denominator the forward wrote),
//   F[t, s]  = keep(bh, t, s) / (1 - rate)      (1 without dropout),
//   dP       = dO . V^T,   dS = P * (dP * F - Delta[t]) * A[t, s],
//   dQ = scale . dS . K,   dK = scale . dS^T . Q,   dV = (P * F)^T . dO,
//   dbias[s] = sum_t dS[t, s]   (per head; the wrapper sums the heads),
// with Delta[t] = sum_s P[t, s] (dP[t, s] F[t, s]) over every key, summed
// in fp32 by H-q from the same products that form dS (the reference's
// sum_k dW W, mm_s2ut/ops/attention.py:443; sum_d dO O from a rounded
// output would leave its rounding on rows of one valid key), and A the causal/window
// band (1 without a causal mask). The dropout mask is regenerated from the
// seed by the forward's counter hash (common.cuh hash_keep). A is the
// reference's own VJP (jax.vjp of reference_attention, its default
// backward): a logit the mask replaced by -1e9 is a constant. The Pallas
// kernel leaves A out; the two differ only on rows whose whole band is
// masked, where P is uniform over all keys.
//
// The TPU kernel held one head's whole K/V in VMEM and carried dK, dV and
// dbias across the sequential q-block axis of its grid. Blocks on the card
// run in parallel and in no order, so H is two kernels, deterministic and
// without atomics, H-q first (it writes the Delta that H-kv reads).
//
// What bounds it on the card: at the ViT's training shape (B = 8, H = 12,
// D = 64, 577 queries over 584 keys) the VJP does 10.B.H.Tq.S.D = 20.7 GFLOP
// (41.9 us at 495 TFLOP/s TF32, each product done once; H-q's Delta pass
// recomputes two of the five products on top) against ~114 MB of fp32 q,
// k, v, dO, O, dq, dk and dv (34.1 us at 3.35 TB/s), so the tensor cores
// bound it. The products on the fp32 FMA pipes (this file's first design, D / 32
// threads per row or key) ran 4.7x slower than SDPA's backward there.
//
// Design: flash_attention_bwd_mma.cu's with fp32 operands. Every product is
// 3xTF32 on mma.m16n8k8 (flash_attention_mma.cuh: x = hi + lo, both tf32,
// a.b = lo.hi + hi.lo + hi.hi, fp32 accumulate), and each thread owns
// distinct (key, query) elements of the S / dP tiles, so each pair's
// scalars (logit, exp, hash, dS) are done once per kernel. As in A, every
// staged element is split once per block into a {hi, lo} pair in a swizzled
// split tile (sswz), which all 4 warps read with plain loads: the block's
// own 64 rows once at the start (staged through the ring), and each staged
// tile of 32 rows (H-q's 64 at D <= 32) after its raw rows land (the next tile's
// cp.async in flight meanwhile). At D = 64 H-kv takes 113 KB of shared
// memory and H-q 80 KB: two blocks per SM (one at D = 128).
//   H-kv: one block of 4 warps per (b.h, 64-key tile), 16 keys per warp.
//     K and V are the resident split tiles, read as A fragments per use.
//     The block loops over every query tile of 32 rows: Q, dO and the
//     rows' m, l and Delta staged (the statistics in a 2-stage ring), in
//     steps of QC queries. Per step: S^T = K.Q^T and dP^T = V.dO^T, the
//     elementwise step, then dV += (P^T F).dO and dK += dS^T.Q from the
//     accumulator registers as A operands (an n-tile's accumulators are
//     the A fragment of a k-step over its 8 queries once dO's and Q's B
//     fragments read those queries in the order 0, 2, 4, 6, 1, 3, 5, 7),
//     and dbias sums dS^T's rows in fp32.
//   H-q: one block of 4 warps per (b.h, 64-query tile). dO is a resident
//     split tile and Q's split fragments stay in registers (a split tile at
//     D = 128; read from one at D = 64, H-q took 844 us against 743 at the
//     ViT's training shape, and 48-key tiles in the room it leaves 858, H100,
//     PERF.md); the block loops twice over every key tile (K, V and the key
//     bias staged): S = Q.K^T and dP = dO.V^T each time; pass 0 sums
//     Delta = sum_s P (dP F) per row and writes it for H-kv, pass 1 takes
//     the elementwise step and dQ += dS.K. P . F and dS are split in
//     registers like any operand, not rounded.
// Every tile is visited, under the causal/window mask too: a row whose
// whole band is padding has the reference's uniform weights over all S
// keys, and its gradients reach every key. Rows t >= T and keys s >= S are
// zero-filled in shared memory and give P = 0; a padded key's P is exactly
// 0, so its dk and dv are exactly 0. dq . scale, dk . scale, dv and dbias
// are stored in fp32; the wrapper sums dbias over heads. Sums run in a
// fixed order, so two launches give the same bits.
#include "flash_attention_mma.cuh"

namespace mm {
namespace {

using namespace tc;

constexpr int kTile = 64;  // keys per H-kv block, query rows per H-q block

template <int D>
struct KvCfg {  // H-kv
  static constexpr int kRows = 32;                  // queries per staged tile
  static constexpr int kChunk = D <= 64 ? 32 : 16;  // queries per compute step
  static constexpr int kRing = 6 * kRows * D;       // Q and dO split and raw (floats)
  // K and V split, the ring, 2 x (m, l, Delta)
  static constexpr int kSmem = (2 * kTile * 2 * D + kRing + 2 * 3 * kRows) * 4;
  static_assert(2 * kTile * D <= kRing, "K's and V's raw rows are staged in the ring");
};

template <int D>
struct QCfg {  // H-q
  static constexpr bool kQRegs = D <= 64;  // Q's split fragments in registers
  static constexpr int kRows = D <= 32 ? 64 : 32;  // keys per staged tile
  static constexpr int kChunk = D <= 64 ? kRows : 16;              // keys per compute step
  static constexpr int kRing = 6 * kRows * D;                      // K and V split and raw
  // dO (and, at D = 128, Q) split, the ring, 2 x bias
  static constexpr int kSmem = ((kQRegs ? 1 : 2) * kTile * 2 * D + kRing + 2 * kRows) * 4;
  static_assert(2 * kTile * D <= kRing, "Q's and dO's raw rows are staged in the ring");
};

// H-kv: dK, dV and dbias of one 64-key tile.
template <int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_kv_kernel(const BwdArgs a) {
  using C = KvCfg<D>;
  constexpr int KS = D / 8, NT = D / 8, QC = C::kChunk, R = C::kRows;
  extern __shared__ __align__(128) float smem32[];
  float* k_s = smem32;              // K split (resident)
  float* v_s = k_s + kTile * 2 * D;  // V split (resident)
  float* q_s = v_s + kTile * 2 * D;  // Q split; from here on, K's and V's raw rows at the start
  float* g_s = q_s + R * 2 * D;     // dO split
  float* q_raw = g_s + R * 2 * D;   // the next tile's Q, dO and statistics land here
  float* g_raw = q_raw + R * D;
  float* stat_sm = g_raw + R * D;   // 2 stages x (m, l, Delta)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const uint32_t hrow = hash_bh(a, b, h);  // the dropout hash's (b, h)
  const int k0 = blockIdx.y * kTile;
  const int kr0 = warp * 16;  // the warp's first key row in the tile
  const int s_r[2] = {k0 + kr0 + g, k0 + kr0 + g + 8};

  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* gb = static_cast<const float*>(a.dout) + ((int64_t)b * a.T * a.H + h) * D;
  const int64_t row0 = (int64_t)bh * a.T;

  auto load_q = [&](int i) {  // query tile i's raw Q and dO, and its statistics into stage i & 1
    const int t0 = i * R;
    load_raw<R, D>(q_raw, qb, a.q_st, t0, a.T);
    load_raw<R, D>(g_raw, gb, (int64_t)a.H * D, t0, a.T);
    float* st = stat_sm + (i & 1) * 3 * R;
    load_vec<R>(st, a.stat_m + row0, t0, a.T);
    load_vec<R>(st + R, a.stat_l + row0, t0, a.T);
    load_vec<R>(st + 2 * R, a.delta + row0, t0, a.T);
    cp_async_commit();
  };
  // The tile's K and V rows, staged in the ring and split once.
  load_raw<kTile, D>(q_s, kb, a.k_st, k0, a.S);
  load_raw<kTile, D>(q_s + kTile * D, vb, a.v_st, k0, a.S);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_tile<kTile, D>(k_s, q_s);
  split_tile<kTile, D>(v_s, q_s + kTile * D);
  __syncthreads();
  load_q(0);

  float bias_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) bias_r[r] = s_r[r] < a.S ? a.bias[(int64_t)b * a.S + s_r[r]] : 0.f;
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }
  float db[2] = {0.f, 0.f};

  const int n_tiles = (a.T + R - 1) / R;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // tile i's raw rows landed; tile i - 1's split tiles are consumed
    split_tile<R, D>(q_s, q_raw);
    split_tile<R, D>(g_s, g_raw);
    __syncthreads();  // the split tiles are ready and the raw ones free
    if (i + 1 < n_tiles) load_q(i + 1);
    const float* ms = stat_sm + (i & 1) * 3 * R;
    const float* ls = ms + R;
    const float* dls = ms + 2 * R;
    const int t0 = i * R;

#pragma unroll 1  // one step for D <= 64; at D = 128 a loop keeps the live ranges short
    for (int c0 = 0; c0 < R; c0 += QC) {
      // S^T = K.Q^T and dP^T = V.dO^T: 16 keys x QC queries per warp.
      float sc[QC / 8][4], dp[QC / 8][4];
#pragma unroll
      for (int n = 0; n < QC / 8; ++n) {
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        FragA32 ka, va;
        frag_a32<D>(ka, k_s, kr0, kk);
        frag_a32<D>(va, v_s, kr0, kk);
#pragma unroll
        for (int n = 0; n < QC / 8; ++n) {
          FragB32 f;
          frag_b32<D>(f, q_s, c0 + n * 8, kk);
          mma3(sc[n], ka, f);
          frag_b32<D>(f, g_s, c0 + n * 8, kk);
          mma3(dp[n], va, f);
        }
      }
      // Element e of n-tile n: key s_r[e >> 1], query column c0 + 8 n + 2 tq + (e & 1).
      // sc becomes P^T F, dp becomes dS^T.
#pragma unroll
      for (int n = 0; n < QC / 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = c0 + n * 8 + 2 * tq + c, t = t0 + j;
          const float m = ms[j], il = 1.f / ls[j], dl = dls[j];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c, s = s_r[r];
            const bool mask = masked(a, t, s);
            const float x = mask ? kMasked : fmaf(sc[n][e], a.scale, bias_r[r]);
            const float p = (t < a.T && s < a.S) ? exp_e(x - m) * il : 0.f;
            const float f = keep_factor(a, hrow, t, s);
            const float ds = mask ? 0.f : p * (dp[n][e] * f - dl);
            db[r] += ds;
            sc[n][e] = p * f;
            dp[n][e] = ds;
          }
        }
      }
      // dV += (P^T F).dO and dK += dS^T.Q: 16 keys x D per warp, a k-step per 8 queries.
#pragma unroll
      for (int j = 0; j < QC / 8; ++j) {
        FragA32 pa, da;
        acc_to_a32(pa, sc[j]);
        acc_to_a32(da, dp[j]);
#pragma unroll
        for (int dd = 0; dd < NT; ++dd) {
          FragB32 f;
          frag_bt32<D>(f, g_s, c0 + j * 8, dd);
          mma3(dv[dd], pa, f);
          frag_bt32<D>(f, q_s, c0 + j * 8, dd);
          mma3(dk[dd], da, f);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float dbias = quad_sum(db[r]);
    const int s = s_r[r];
    if (s >= a.S) continue;
    if (tq == 0) a.dbias[(int64_t)bh * a.S + s] = dbias;
    const int64_t o = (((int64_t)b * a.S + s) * a.H + h) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<float2*>(a.dk + o + n * 8) =
          make_float2(dk[n][2 * r] * a.scale, dk[n][2 * r + 1] * a.scale);
      *reinterpret_cast<float2*>(a.dv + o + n * 8) = make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// H-q: Delta, then dQ, of one 64-query tile. Two passes over the key tiles
// through one ring: pass 0 sums Delta_t = sum_s P (dP F) in fp32 and
// writes it for H-kv; pass 1 forms dS = P (dP F - Delta) and dQ. Both
// passes form P and dP F with the same instructions in the same order, so
// on a row whose band holds one key (P = 1 there, 0 elsewhere) Delta is
// that key's dP F exactly and dS is exactly 0, as in the reference.
template <int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_q_kernel(const BwdArgs a) {
  using C = QCfg<D>;
  constexpr int KS = D / 8, NT = D / 8, KC = C::kChunk, R = C::kRows;
  constexpr bool Q_REGS = C::kQRegs;
  extern __shared__ __align__(128) float smem32[];
  float* g_s = smem32;               // dO split (resident)
  float* q_s = g_s + kTile * 2 * D;  // Q split (resident, D = 128)
  float* k_s = q_s + (Q_REGS ? 0 : kTile * 2 * D);  // K split; from here on, Q's and dO's raw rows at the start
  float* v_s = k_s + R * 2 * D;     // V split
  float* k_raw = v_s + R * 2 * D;   // the next tile's K, V and bias land here
  float* v_raw = k_raw + R * D;
  float* bias_sm = v_raw + R * D;   // 2 stages

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const uint32_t hrow = hash_bh(a, b, h);  // the dropout hash's (b, h)
  const int q0 = blockIdx.y * kTile;
  const int qr0 = warp * 16;  // the warp's first query row in the tile
  const int t_r[2] = {q0 + qr0 + g, q0 + qr0 + g + 8};

  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* gb = static_cast<const float*>(a.dout) + ((int64_t)b * a.T * a.H + h) * D;
  const float* bias_row = a.bias + (int64_t)b * a.S;

  const int n_tiles = (a.S + R - 1) / R;
  auto load_kv = [&](int i) {  // visit i's raw K and V, and its bias into stage i & 1
    const int s0 = (i % n_tiles) * R;
    load_raw<R, D>(k_raw, kb, a.k_st, s0, a.S);
    load_raw<R, D>(v_raw, vb, a.v_st, s0, a.S);
    load_vec<R>(bias_sm + (i & 1) * R, bias_row, s0, a.S);
    cp_async_commit();
  };
  // The tile's Q and dO rows, staged in the ring and split once.
  load_raw<kTile, D>(k_s, qb, a.q_st, q0, a.T);
  load_raw<kTile, D>(k_s + kTile * D, gb, (int64_t)a.H * D, q0, a.T);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  FragA32 qf[Q_REGS ? KS : 1];
  if (Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < (Q_REGS ? KS : 0); ++kk) frag_a32_raw<D>(qf[kk], k_s, qr0, kk);
  } else {
    split_tile<kTile, D>(q_s, k_s);
  }
  split_tile<kTile, D>(g_s, k_s + kTile * D);
  __syncthreads();
  load_kv(0);

  float m_r[2], il_r[2], dl_r[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = t_r[r] < a.T;
    const int64_t row = (int64_t)bh * a.T + (ok ? t_r[r] : 0);
    m_r[r] = ok ? a.stat_m[row] : 0.f;
    il_r[r] = ok ? 1.f / a.stat_l[row] : 0.f;
  }
  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int i = 0; i < 2 * n_tiles; ++i) {  // visit i: pass i / n_tiles, key tile i % n_tiles
    const bool pass1 = i >= n_tiles;
    cp_async_wait<0>();
    __syncthreads();  // visit i's raw rows landed; visit i - 1's split tiles are consumed
    split_tile<R, D>(k_s, k_raw);
    split_tile<R, D>(v_s, v_raw);
    __syncthreads();  // the split tiles are ready and the raw ones free
    if (i + 1 < 2 * n_tiles) load_kv(i + 1);
    if (i == n_tiles) {  // Delta of each row: the quad's partial sums, in a fixed order
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dl_r[r] = quad_sum(dl_r[r]);
        if (tq == 0 && t_r[r] < a.T) a.delta[(int64_t)bh * a.T + t_r[r]] = dl_r[r];
      }
    }
    const float* bs = bias_sm + (i & 1) * R;
    const int s0 = (i % n_tiles) * R;

#pragma unroll 1  // one step for D <= 64; at D = 128 a loop keeps the live ranges short
    for (int c0 = 0; c0 < R; c0 += KC) {
      // S = Q.K^T and dP = dO.V^T: 16 queries x KC keys per warp.
      float sc[KC / 8][4], dp[KC / 8][4];
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) {
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        FragA32 qa, ga;
        if (Q_REGS)
          qa = qf[Q_REGS ? kk : 0];
        else
          frag_a32<D>(qa, q_s, qr0, kk);
        frag_a32<D>(ga, g_s, qr0, kk);
#pragma unroll
        for (int n = 0; n < KC / 8; ++n) {
          FragB32 f;
          frag_b32<D>(f, k_s, c0 + n * 8, kk);
          mma3(sc[n], qa, f);
          frag_b32<D>(f, v_s, c0 + n * 8, kk);
          mma3(dp[n], ga, f);
        }
      }
      // Element e of n-tile n: query t_r[e >> 1], key s0 + c0 + 8 n + 2 tq + (e & 1).
      // Pass 0 adds P (dP F) to Delta over every key (the masked ones carry
      // P = 0 unless the row's whole band is padding, as in the reference);
      // pass 1 turns sc into dS.
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, j = c0 + n * 8 + 2 * tq + (e & 1), s = s0 + j, t = t_r[r];
          const bool mask = masked(a, t, s);
          const float x = mask ? kMasked : fmaf(sc[n][e], a.scale, bs[j]);
          const float p = (t < a.T && s < a.S) ? exp_e(x - m_r[r]) * il_r[r] : 0.f;
          const float dw = dp[n][e] * keep_factor(a, hrow, t, s);
          if (pass1)
            sc[n][e] = mask ? 0.f : p * (dw - dl_r[r]);
          else
            dl_r[r] = fmaf(p, dw, dl_r[r]);
        }
      }
      if (pass1) {
        // dQ += dS.K: 16 queries x D per warp, a k-step per 8 keys.
#pragma unroll
        for (int j = 0; j < KC / 8; ++j) {
          FragA32 da;
          acc_to_a32(da, sc[j]);
#pragma unroll
          for (int dd = 0; dd < NT; ++dd) {
            FragB32 f;
            frag_bt32<D>(f, k_s, c0 + j * 8, dd);
            mma3(dq[dd], da, f);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t_r[r];
    if (t >= a.T) continue;
    float* o = static_cast<float*>(a.dq) + (((int64_t)b * a.T + t) * a.H + h) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(o + n * 8) =
          make_float2(dq[n][2 * r] * a.scale, dq[n][2 * r + 1] * a.scale);
  }
}

template <int D>
cudaError_t launch_bwd(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int kv_smem = KvCfg<D>::kSmem, q_smem = QCfg<D>::kSmem;
  cudaError_t err = allow_smem_max(attn_bwd_kv_kernel<D>, kv_smem);
  if (err == cudaSuccess) err = allow_smem_max(attn_bwd_q_kernel<D>, q_smem);
  if (err != cudaSuccess) return err;
  // H-q first: it writes the Delta that H-kv reads.
  attn_bwd_q_kernel<D><<<dim3(B * a.H, (a.T + kTile - 1) / kTile), kThreads, q_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_kv_kernel<D><<<dim3(B * a.H, (a.S + kTile - 1) / kTile), kThreads, kv_smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_bwd_f32(int D, const BwdArgs& a, int B, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_bwd<16>(a, B, stream);
    case 32: return launch_bwd<32>(a, B, stream);
    case 64: return launch_bwd<64>(a, B, stream);
    case 128: return launch_bwd<128>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mm

// Kernel H (H-q then H-kv on ``stream``; ``delta`` is (B.H, T) fp32
// scratch): returns cudaGetLastError() after the launches (0 on success).
// ``causal`` needs T <= S (query t at position t), as kernel G. Rows
// 16-byte aligned; bf16 in flash_attention_bwd_mma.cu, fp32 here.
extern "C" int mm_flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* stat_m, const void* stat_l, void* delta,
    void* dq, void* dk, void* dv, void* dbias, int B, int T, int S, int H, int D,
    int64_t q_sb, int64_t q_st, int64_t q_sh,
    int64_t k_sb, int64_t k_st, int64_t k_sh,
    int64_t v_sb, int64_t v_st, int64_t v_sh,
    float scale, int causal, int window, double rate, unsigned int seed, unsigned int bh0,
    unsigned int h_total, unsigned int h0,
    void* stream) {
  if (!(rate >= 0.0 && rate < 1.0) || (causal && T > S)) return (int)cudaErrorInvalidValue;
  const mm::BwdArgs a{q, k, v, static_cast<const float*>(bias), dout,
                      static_cast<const float*>(stat_m), static_cast<const float*>(stat_l),
                      static_cast<float*>(delta), dq, static_cast<float*>(dk),
                      static_cast<float*>(dv), static_cast<float*>(dbias), T, S, H,
                      q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, causal,
                      window, (float)rate, (float)(1.0 / (1.0 - rate)), seed, bh0, h_total, h0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mm::kFloat32) return (int)mm::dispatch_bwd_f32(D, a, B, st);
  if (dtype == mm::kBFloat16) return (int)mm::launch_flash_bwd_mma(a, B, D, st);
  return (int)cudaErrorInvalidValue;
}
