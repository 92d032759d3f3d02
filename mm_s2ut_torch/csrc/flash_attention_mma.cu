// Kernels A and G in bf16 on Hopper's tensor cores: encoder self-attention
// forward with its causal/window mask, attention dropout and row statistics.
//
// Replaces the Pallas TPU kernels mm_s2ut/ops/attention.py:_attn_kernel
// (A, pallas_call at attention.py:362) and _attn_kernel_causal_skip (G,
// pallas_call at :348) for bf16 inputs; fp32 inputs take the 3xTF32
// kernel of flash_attention.cu. It computes what that kernel computes (see
// flash_attention.cu): per (b, h),
//   out[t] = sum_s softmax_s(l[t, s]) . F[t, s] . v[s],
//   l[t, s] = scale . q[t] . k[s] + bias[s], or -1e9 outside the
//   causal/window band, -inf past S; F the dropout factor keep / (1 - rate).
//
// What bounds it on the card: at B = 2, T = 1000 (H = 8, D = 64) one call
// does 4.B.H.T^2.D = 4.1 GFLOP on ~2 MB of q, k, v, so operations bound it
// (4.1 us at 989 TFLOP/s bf16); at B = 8, T = 250 it moves ~4 MB for 1 GFLOP
// and bytes bound it (2.45 us). The SIMT kernel it replaced did every
// product on the fp32 FMA pipes and repeated each row's softmax scalars
// in the two threads that shared the row.
//
// Design: one block of 4 warps per (b.h, 64-query tile), 16 query rows per
// warp. The Q tile is copied once as bf16 (16-byte cp.async) and held in
// registers as mma A fragments for the whole key loop (at D = 128 they are
// read from the tile per use instead, and key tiles are 32 wide: ptxas
// spilled otherwise). K and V tiles of 64 keys are staged as bf16 in a 2-stage cp.async ring (tile j + 1 in flight
// while tile j is consumed), in XOR-swizzled rows so that ldmatrix is free
// of bank conflicts, with the tile's 64 key-bias values beside them.
// Per tile and warp, S = Q.K^T is 8 n-tiles (4 at D = 128) x D/16 k-steps of
// mma.m16n8k16 (fp32 accumulate); each thread owns distinct (row, key)
// elements of S, so each pair's scalar work (logit, mask, exp, hash) is
// done once. The online softmax keeps each row's running max (reduced
// over the row's quad with two shuffles) and per-thread partial sums of
// the unmasked p; p . F is rounded to bf16 (where the reference casts its
// weights to v's dtype, attention.py:187) and feeds O += P.V from the S
// registers as the A operand, V through ldmatrix.trans. The epilogue
// divides by l in fp32 and stores bf16; each row's final max m and
// denominator l go to stat_m / stat_l for kernel H, with the fp32
// kernel's contract (no log-sum-exp: an all -1e9 row keeps l). A visits
// every key tile, so a row whose band is all padding gets the reference's
// uniform average. Rows are read through the (B, T, H, D) strides; the
// wrapper checks that they are 16-byte aligned.
//
// Kernel G (SKIP; the causal encoder's forward, T <= S with query t at position
// t) is the same tile loop over the key tiles that meet the block's band only,
// [lo, hi) as flash_attention.cu computes them: at most two tiles per query
// tile with a window of 64. The SIMT G it replaced (2 threads per row, fp32 FMA
// pipes) was 5.8x slower at B = 8, T = 250, window 64 than this loop over every
// tile (A-causal; H100, PERF.md). The ring prefetches the next visit's tile,
// not tile i + 1. After the last band tile a block-uniform __syncthreads_or
// asks whether a row of the block still has a running max below -5e8 (its whole
// band is padding); if so the block goes on over the skipped tiles, whose
// logits the mask sets to -1e9, and the row becomes the reference's uniform mix
// over all S keys. The first of those tiles is fetched only after that test.
// Skipped tiles add exactly 0 to a row with a real key (p = exp(-1e9 - m) = 0,
// alpha = 1), and the tiles before the band only ever raise the -1e9 max that
// the first real logit wipes (alpha = 0), so on such rows G gives A-causal's
// bits.
#include "flash_attention_mma.cuh"

namespace mm {
namespace {

using namespace tc;

constexpr int kBQ = 64;  // query rows per block

template <int D>
struct Cfg {
  static constexpr int kBK = D <= 64 ? 64 : 32;  // keys per staged tile (64 spilled at D = 128)
  static constexpr int kSmem = (kBQ + 4 * kBK) * D * 2 + 2 * kBK * 4;  // Q, 2 x (K, V), 2 x bias
};

// CAUSAL: apply the causal/window mask. SKIP (kernel G, needs CAUSAL):
// visit only the key tiles that meet the block's band, then, if a row of
// the block found no allowed key there, the skipped ones.
template <int D, bool CAUSAL, bool SKIP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel_mma(const FlashArgs a) {
  static_assert(CAUSAL || !SKIP, "band skipping needs the causal mask");
  constexpr int KS = D / 16;  // k-steps over the head dim
  constexpr int NT = D / 8;   // n-tiles of the output row
  constexpr int BK = Cfg<D>::kBK;
  constexpr int TILE = BK * D * 2;
  constexpr bool Q_REGS = D <= 64;  // Q's fragments held in registers (ptxas spilled at 128)
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_sm = smem_u32(smem);
  const uint32_t k_sm = q_sm + kBQ * D * 2;  // 2 stages
  const uint32_t v_sm = k_sm + 2 * TILE;     // 2 stages
  float* bias_sm = reinterpret_cast<float*>(smem + kBQ * D * 2 + 4 * TILE);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const uint32_t hrow = hash_bh(a, b, h);  // the dropout hash's (b, h)
  const int q0 = blockIdx.y * kBQ;
  const int row0 = warp * 16;
  const int t_r[2] = {q0 + row0 + g, q0 + row0 + g + 8};

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* bias_row = a.bias + (int64_t)b * a.S;

  // Visit i < n_band is band tile lo + i; past that (G only, when a row of
  // the block found no allowed key in its band) come the skipped tiles
  // [0, lo) and [hi, n_tiles), which the mask sets to -1e9 for every row.
  const int n_tiles = (a.S + BK - 1) / BK;
  int lo = 0, hi = n_tiles;
  if (SKIP) {
    hi = min((q0 + kBQ + BK - 1) / BK, n_tiles);
    if (a.window > 0) lo = max(q0 - a.window + 1, 0) / BK;
  }
  const int n_band = hi - lo;  // >= 1: tile q0 / BK is in the band
  auto tile_of = [&](int i) {
    const int e = i - n_band;
    return e < 0 ? lo + i : (e < lo ? e : e + n_band);
  };
  auto load_kv = [&](int stage, int s0) {
    load_rows<BK, D>(k_sm + stage * TILE, kb, a.k_st, s0, a.S);
    load_rows<BK, D>(v_sm + stage * TILE, vb, a.v_st, s0, a.S);
    load_vec<BK>(bias_sm + stage * BK, bias_row, s0, a.S);
  };
  load_rows<kBQ, D>(q_sm, qb, a.q_st, q0, a.T);
  load_kv(0, tile_of(0) * BK);
  cp_async_commit();

  uint32_t qf[Q_REGS ? KS : 1][4];
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  int n_visits = n_band, fetched = 0;  // fetched: the last visit whose tile load was issued
  for (int i = 0; i < n_visits; ++i) {
    const int stage = i & 1;
    if (SKIP && i > fetched) {  // the first skipped tile: known only after the band
      load_kv(stage, tile_of(i) * BK);
      cp_async_commit();
    }
    if (i + 1 < n_visits) {
      load_kv(stage ^ 1, tile_of(i + 1) * BK);
      cp_async_commit();
      fetched = i + 1;
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (Q_REGS && i == 0) {
#pragma unroll
      for (int kk = 0; kk < (Q_REGS ? KS : 0); ++kk) frag_a<D>(qf[kk], q_sm, row0, kk);
    }
    const uint32_t ks = k_sm + stage * TILE, vs = v_sm + stage * TILE;
    const float* bs = bias_sm + stage * BK;
    const int s0 = tile_of(i) * BK;

    // S = Q.K^T: 16 rows x BK keys per warp.
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      resident<D, Q_REGS>(qa, qf[Q_REGS ? kk : 0], q_sm, row0, kk);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t f[4];
        frag_b<D>(f, ks, np * 16, kk);
        mma(s[2 * np], qa, f[0], f[1]);
        mma(s[2 * np + 1], qa, f[2], f[3]);
      }
    }

    // Logits and the running max: element e of n-tile n is row t_r[e >> 1],
    // key s0 + 8 n + 2 tq + (e & 1).
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + 2 * tq + (e & 1), key = s0 + j, t = t_r[e >> 1];
        float x = fmaf(s[n][e], a.scale, bs[j]);
        if (CAUSAL && (key > t || (a.window > 0 && key <= t - a.window))) x = kMasked;
        x = key < a.S ? x : -INFINITY;
        s[n][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    }
    // mt >= -1e9 is finite: key s0 < S is in the tile, a masked logit is -1e9.
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(mt[r]));
      alpha[r] = exp_e(m_run[r] - m_new);  // 0 on the first tile (m_run = -inf)
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp_e(s[n][e] - m_run[e >> 1]);  // 0 past the key edge
        l_run[e >> 1] += p;
        s[n][e] = p;
      }
    }
    if (a.rate > 0.f) {  // the dropout factor of each kept weight
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = s0 + n * 8 + 2 * tq + (e & 1);
          s[n][e] = hash_keep(hrow, t_r[e >> 1], key, a.seed, a.rate) ? s[n][e] * a.inv_keep : 0.f;
        }
      }
    }

    // O += bf16(P . F) . V: 16 rows x D per warp.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        uint32_t f[4];
        frag_bt<D>(f, vs, kk * 16, dp);
        mma(o[2 * dp], pa, f[0], f[1]);
        mma(o[2 * dp + 1], pa, f[2], f[3]);
      }
    }
    __syncthreads();  // stage i & 1 is refilled by the next iteration's load
    // A row whose whole band is padding: the reference's softmax spans all
    // S keys at -1e9, so the skipped tiles join (block-uniform test).
    if (SKIP && i + 1 == n_band &&
        __syncthreads_or((t_r[0] < a.T && m_run[0] < -5e8f) || (t_r[1] < a.T && m_run[1] < -5e8f)))
      n_visits = n_tiles;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    const int t = t_r[r];
    if (t >= a.T) continue;
    if (a.stat_m != nullptr && tq == 0) {
      a.stat_m[(int64_t)bh * a.T + t] = m_run[r];
      a.stat_l[(int64_t)bh * a.T + t] = l;
    }
    const float inv = 1.f / l;
    bf16* op = static_cast<bf16*>(a.out) + (((int64_t)b * a.T + t) * a.H + h) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(op + n * 8) =
          __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

template <int D, bool CAUSAL, bool SKIP>
cudaError_t launch(const FlashArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = Cfg<D>::kSmem;
  const cudaError_t err = allow_smem(flash_fwd_kernel_mma<D, CAUSAL, SKIP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.H, (a.T + kBQ - 1) / kBQ);
  flash_fwd_kernel_mma<D, CAUSAL, SKIP><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool CAUSAL, bool SKIP>
cudaError_t dispatch(const FlashArgs& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16, CAUSAL, SKIP>(a, B, stream);
    case 32: return launch<32, CAUSAL, SKIP>(a, B, stream);
    case 64: return launch<64, CAUSAL, SKIP>(a, B, stream);
    case 128: return launch<128, CAUSAL, SKIP>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t launch_flash_fwd_mma(const FlashArgs& a, int B, int D, bool causal, bool skip,
                                 cudaStream_t stream) {
  if (skip) return causal ? dispatch<true, true>(a, B, D, stream) : cudaErrorInvalidValue;
  return causal ? dispatch<true, false>(a, B, D, stream) : dispatch<false, false>(a, B, D, stream);
}

}  // namespace mm
