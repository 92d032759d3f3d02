// Kernel H in bf16 on Hopper's tensor cores: the encoder self-attention
// backward (H-q: Delta and dQ; H-kv: dK, dV, dbias), two kernels, no atomics.
//
// Replaces the Pallas TPU kernel mm_s2ut/ops/attention.py:_attn_bwd_kernel
// (pallas_call at attention.py:500) for bf16 inputs; fp32 inputs take the
// 3xTF32 kernels of flash_attention_bwd.cu, whose header states the formulas:
//   P = exp(l - m) / L (l recomputed as the forward's: one fmaf, -1e9 in
//   place of a logit outside the causal/window band), F = keep / (1 - rate),
//   dS = P (dP F - Delta) inside the band and 0 outside it, dP = dO.V^T,
//   dV = (P F)^T.dO, dK = scale.dS^T.Q, dQ = scale.dS.K, dbias = sum_t dS,
//   Delta_t = sum_s P (dP F) taken in fp32 in the kernel, as the reference
//   takes sum_k dW W from its fp32 weights (mm_s2ut/ops/attention.py:443).
//
// What bounds it on the card: at B = 2, T = 1000 (H = 8, D = 64) the VJP does
// 10.B.H.T^2.D = 10 GFLOP (10.4 us at 989 TFLOP/s bf16; Delta's pass recomputes
// two of the five products on top); at B = 8, T = 250 it moves ~16.5 MB of q,
// k, v, dO, O and the fp32 dk, dv for 2.6 GFLOP, so bytes bound it (4.9 us).
// The SIMT kernels it replaced did the products on the fp32 FMA pipes, and the
// D / 32 threads that shared a key or row each repeated the pair's exp,
// division, hash and shuffles: that scalar work set their time.
//
// Design: every product is mma.m16n8k16 (bf16 in, fp32 accumulate), and
// each thread owns distinct (key, query) elements of the S / dP tiles, so
// each pair's scalars are done once per kernel.
//   H-kv: one block of 4 warps per (b.h, 64-key tile), 16 keys per warp.
//     The tile's K and V rows are A fragments (registers for D <= 64, read
//     from shared memory per use at D = 128, where dK and dV already take
//     128 registers). The block loops over every query tile of 64 rows:
//     Q, dO and the rows' m, l and Delta staged as bf16 / fp32 in a
//     2-stage cp.async ring of swizzled tiles. Per tile: S^T = K.Q^T and
//     dP^T = V.dO^T (B fragments by ldmatrix), the elementwise step, then
//     dV += bf16(P^T F).dO and dK += bf16(dS^T).Q from the accumulator
//     registers as A operands (dO, Q through ldmatrix.trans), and dbias
//     sums dS^T's rows in fp32. At D = 128 a tile goes in four steps of
//     16 queries, which keeps the S^T / dP^T accumulators to 16 registers
//     (ptxas spilled with 32).
//   H-q (launched first): one block of 4 warps per (b.h, 64-query tile).
//     Q and dO are A fragments (as K, V above); the block loops twice over
//     every key tile (K, V and the key bias in the ring): S = Q.K^T and
//     dP = dO.V^T each time; pass 0 sums Delta = sum_s P (dP F) per row
//     and writes it for H-kv, pass 1 takes the elementwise step and
//     dQ += bf16(dS).K (K through ldmatrix.trans). A Delta taken from the
//     bf16 output (sum_d dO O) would leave its rounding as the whole result
//     on a row of one valid key, where dS cancels to 0.
// Every tile is visited, under a causal mask too: a row whose whole band
// is padding has uniform weights over all S keys and its gradient reaches
// every key. Rows t >= T and keys s >= S are zero-filled in shared memory
// and give P = 0. dk . scale, dv and dbias are stored in fp32, dq . scale in
// bf16; the wrapper casts and sums dbias over heads. Sums run in a fixed
// order, so two launches give the same bits.
#include "flash_attention_mma.cuh"

namespace mm {
namespace {

using namespace tc;

constexpr int kTile = 64;  // keys per H-kv block, rows per H-q block, rows per staged tile

template <int D>
struct Cfg {
  static constexpr bool kRegs = D <= 64;            // resident fragments in registers
  static constexpr int kChunk = D <= 64 ? 64 : 16;  // staged rows per compute step
  static constexpr int kTileBytes = kTile * D * 2;
  static constexpr int kKvSmem = 6 * kTileBytes + 2 * 3 * kTile * 4;  // K, V, 2 x (Q, dO, stats)
  static constexpr int kQSmem = 6 * kTileBytes + 2 * kTile * 4;       // Q, dO, 2 x (K, V, bias)
};

// H-kv: dK, dV and dbias of one 64-key tile.
template <int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_kv_kernel_mma(const BwdArgs a) {
  using C = Cfg<D>;
  constexpr int KS = D / 16, NT = D / 8, QC = C::kChunk, TB = C::kTileBytes;
  constexpr bool REGS = C::kRegs;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t k_sm = smem_u32(smem);
  const uint32_t v_sm = k_sm + TB;
  const uint32_t q_sm = v_sm + TB;      // 2 stages
  const uint32_t g_sm = q_sm + 2 * TB;  // 2 stages
  float* stat_sm = reinterpret_cast<float*>(smem + 6 * TB);  // 2 stages x (m, l, Delta)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const uint32_t hrow = hash_bh(a, b, h);  // the dropout hash's (b, h)
  const int k0 = blockIdx.y * kTile;
  const int kr0 = warp * 16;  // the warp's first key row in the tile
  const int s_r[2] = {k0 + kr0 + g, k0 + kr0 + g + 8};

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + h * a.v_sh;
  const bf16* gb = static_cast<const bf16*>(a.dout) + ((int64_t)b * a.T * a.H + h) * D;
  const int64_t row0 = (int64_t)bh * a.T;

  auto load_q = [&](int stage, int t0) {
    load_rows<kTile, D>(q_sm + stage * TB, qb, a.q_st, t0, a.T);
    load_rows<kTile, D>(g_sm + stage * TB, gb, (int64_t)a.H * D, t0, a.T);
    float* st = stat_sm + stage * 3 * kTile;
    load_vec<kTile>(st, a.stat_m + row0, t0, a.T);
    load_vec<kTile>(st + kTile, a.stat_l + row0, t0, a.T);
    load_vec<kTile>(st + 2 * kTile, a.delta + row0, t0, a.T);
  };
  load_rows<kTile, D>(k_sm, kb, a.k_st, k0, a.S);
  load_rows<kTile, D>(v_sm, vb, a.v_st, k0, a.S);
  load_q(0, 0);
  cp_async_commit();

  float bias_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) bias_r[r] = s_r[r] < a.S ? a.bias[(int64_t)b * a.S + s_r[r]] : 0.f;
  uint32_t kf[REGS ? KS : 1][4], vf[REGS ? KS : 1][4];
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }
  float db[2] = {0.f, 0.f};

  const int n_tiles = (a.T + kTile - 1) / kTile;
  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1;
    if (i + 1 < n_tiles) {
      load_q(stage ^ 1, (i + 1) * kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (REGS && i == 0) {
#pragma unroll
      for (int kk = 0; kk < (REGS ? KS : 0); ++kk) {
        frag_a<D>(kf[kk], k_sm, kr0, kk);
        frag_a<D>(vf[kk], v_sm, kr0, kk);
      }
    }
    const uint32_t qs = q_sm + stage * TB, gs = g_sm + stage * TB;
    const float* ms = stat_sm + stage * 3 * kTile;
    const float* ls = ms + kTile;
    const float* dls = ms + 2 * kTile;
    const int t0 = i * kTile;

#pragma unroll 1  // one step for D <= 64; at D = 128 a loop keeps the live ranges short
    for (int c0 = 0; c0 < kTile; c0 += QC) {
      // S^T = K.Q^T and dP^T = V.dO^T: 16 keys x QC queries per warp.
      float sc[QC / 8][4], dp[QC / 8][4];
#pragma unroll
      for (int n = 0; n < QC / 8; ++n) {
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        resident<D, REGS>(ka, kf[REGS ? kk : 0], k_sm, kr0, kk);
        resident<D, REGS>(va, vf[REGS ? kk : 0], v_sm, kr0, kk);
#pragma unroll
        for (int np = 0; np < QC / 16; ++np) {
          uint32_t f[4];
          frag_b<D>(f, qs, c0 + np * 16, kk);
          mma(sc[2 * np], ka, f[0], f[1]);
          mma(sc[2 * np + 1], ka, f[2], f[3]);
          frag_b<D>(f, gs, c0 + np * 16, kk);
          mma(dp[2 * np], va, f[0], f[1]);
          mma(dp[2 * np + 1], va, f[2], f[3]);
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
      // dV += bf16(P^T F).dO and dK += bf16(dS^T).Q: 16 keys x D per warp.
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {
        uint32_t pa[4], da[4];
        acc_to_a(pa, sc[2 * kk], sc[2 * kk + 1]);
        acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dd = 0; dd < NT / 2; ++dd) {
          uint32_t f[4];
          frag_bt<D>(f, gs, c0 + kk * 16, dd);
          mma(dv[2 * dd], pa, f[0], f[1]);
          mma(dv[2 * dd + 1], pa, f[2], f[3]);
          frag_bt<D>(f, qs, c0 + kk * 16, dd);
          mma(dk[2 * dd], da, f[0], f[1]);
          mma(dk[2 * dd + 1], da, f[2], f[3]);
        }
      }
    }
    __syncthreads();  // stage i & 1 is refilled by the next iteration's load
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
__global__ void __launch_bounds__(kThreads) attn_bwd_q_kernel_mma(const BwdArgs a) {
  using C = Cfg<D>;
  constexpr int KS = D / 16, NT = D / 8, KC = C::kChunk, TB = C::kTileBytes;
  constexpr bool REGS = C::kRegs;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_sm = smem_u32(smem);
  const uint32_t g_sm = q_sm + TB;
  const uint32_t k_sm = g_sm + TB;      // 2 stages
  const uint32_t v_sm = k_sm + 2 * TB;  // 2 stages
  float* bias_sm = reinterpret_cast<float*>(smem + 6 * TB);  // 2 stages

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const uint32_t hrow = hash_bh(a, b, h);  // the dropout hash's (b, h)
  const int q0 = blockIdx.y * kTile;
  const int qr0 = warp * 16;  // the warp's first query row in the tile
  const int t_r[2] = {q0 + qr0 + g, q0 + qr0 + g + 8};

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + h * a.v_sh;
  const bf16* gb = static_cast<const bf16*>(a.dout) + ((int64_t)b * a.T * a.H + h) * D;
  const float* bias_row = a.bias + (int64_t)b * a.S;

  auto load_kv = [&](int stage, int s0) {
    load_rows<kTile, D>(k_sm + stage * TB, kb, a.k_st, s0, a.S);
    load_rows<kTile, D>(v_sm + stage * TB, vb, a.v_st, s0, a.S);
    load_vec<kTile>(bias_sm + stage * kTile, bias_row, s0, a.S);
  };
  load_rows<kTile, D>(q_sm, qb, a.q_st, q0, a.T);
  load_rows<kTile, D>(g_sm, gb, (int64_t)a.H * D, q0, a.T);
  load_kv(0, 0);
  cp_async_commit();

  float m_r[2], il_r[2], dl_r[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = t_r[r] < a.T;
    const int64_t row = (int64_t)bh * a.T + (ok ? t_r[r] : 0);
    m_r[r] = ok ? a.stat_m[row] : 0.f;
    il_r[r] = ok ? 1.f / a.stat_l[row] : 0.f;
  }
  uint32_t qf[REGS ? KS : 1][4], gf[REGS ? KS : 1][4];
  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  const int n_tiles = (a.S + kTile - 1) / kTile;
  for (int i = 0; i < 2 * n_tiles; ++i) {  // visit i: pass i / n_tiles, key tile i % n_tiles
    const int stage = i & 1;
    const bool pass1 = i >= n_tiles;
    if (i + 1 < 2 * n_tiles) {
      load_kv(stage ^ 1, ((i + 1) % n_tiles) * kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (REGS && i == 0) {
#pragma unroll
      for (int kk = 0; kk < (REGS ? KS : 0); ++kk) {
        frag_a<D>(qf[kk], q_sm, qr0, kk);
        frag_a<D>(gf[kk], g_sm, qr0, kk);
      }
    }
    if (i == n_tiles) {  // Delta of each row: the quad's partial sums, in a fixed order
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dl_r[r] = quad_sum(dl_r[r]);
        if (tq == 0 && t_r[r] < a.T) a.delta[(int64_t)bh * a.T + t_r[r]] = dl_r[r];
      }
    }
    const uint32_t ks = k_sm + stage * TB, vs = v_sm + stage * TB;
    const float* bs = bias_sm + stage * kTile;
    const int s0 = (i % n_tiles) * kTile;

#pragma unroll 1  // one step for D <= 64; at D = 128 a loop keeps the live ranges short
    for (int c0 = 0; c0 < kTile; c0 += KC) {
      // S = Q.K^T and dP = dO.V^T: 16 queries x KC keys per warp.
      float sc[KC / 8][4], dp[KC / 8][4];
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) {
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[4], ga[4];
        resident<D, REGS>(qa, qf[REGS ? kk : 0], q_sm, qr0, kk);
        resident<D, REGS>(ga, gf[REGS ? kk : 0], g_sm, qr0, kk);
#pragma unroll
        for (int np = 0; np < KC / 16; ++np) {
          uint32_t f[4];
          frag_b<D>(f, ks, c0 + np * 16, kk);
          mma(sc[2 * np], qa, f[0], f[1]);
          mma(sc[2 * np + 1], qa, f[2], f[3]);
          frag_b<D>(f, vs, c0 + np * 16, kk);
          mma(dp[2 * np], ga, f[0], f[1]);
          mma(dp[2 * np + 1], ga, f[2], f[3]);
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
        // dQ += bf16(dS).K: 16 queries x D per warp.
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          uint32_t da[4];
          acc_to_a(da, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
          for (int dd = 0; dd < NT / 2; ++dd) {
            uint32_t f[4];
            frag_bt<D>(f, ks, c0 + kk * 16, dd);
            mma(dq[2 * dd], da, f[0], f[1]);
            mma(dq[2 * dd + 1], da, f[2], f[3]);
          }
        }
      }
    }
    __syncthreads();  // stage i & 1 is refilled by the next iteration's load
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t_r[r];
    if (t >= a.T) continue;
    bf16* o = static_cast<bf16*>(a.dq) + (((int64_t)b * a.T + t) * a.H + h) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o + n * 8) =
          __floats2bfloat162_rn(dq[n][2 * r] * a.scale, dq[n][2 * r + 1] * a.scale);
  }
}

template <int D>
cudaError_t launch(const BwdArgs& a, int B, cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = allow_smem(attn_bwd_kv_kernel_mma<D>, C::kKvSmem);
  if (err == cudaSuccess) err = allow_smem(attn_bwd_q_kernel_mma<D>, C::kQSmem);
  if (err != cudaSuccess) return err;
  // H-q first: it writes the Delta that H-kv reads.
  attn_bwd_q_kernel_mma<D>
      <<<dim3(B * a.H, (a.T + kTile - 1) / kTile), kThreads, C::kQSmem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_kv_kernel_mma<D>
      <<<dim3(B * a.H, (a.S + kTile - 1) / kTile), kThreads, C::kKvSmem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_flash_bwd_mma(const BwdArgs& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16>(a, B, stream);
    case 32: return launch<32>(a, B, stream);
    case 64: return launch<64>(a, B, stream);
    case 128: return launch<128>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mm
