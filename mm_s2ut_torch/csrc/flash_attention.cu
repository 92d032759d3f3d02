// Kernels A and G — encoder self-attention forward, with attention dropout.
// This file holds their fp32 version, on the tensor cores in 3xTF32. In bf16
// both run on the tensor cores in bf16 (flash_attention_mma.cu); the C
// entries below dispatch to it.
//
// Kernel A replaces the Pallas TPU kernel mm_s2ut/ops/attention.py:_attn_kernel,
// launched by _flash_call (pallas_call at attention.py:362) and reached
// from flash_attention / attention() for the encoder's self-attention,
// with its causal/window branch (attention.py:160-168).
// Kernel G replaces attention.py:_attn_kernel_causal_skip (pallas_call at
// :348, _flash_call with block_k set): the causal/window forward that
// computes only the key blocks meeting a query block's band.
//
// Both compute, for q, k, v in their (B, T, H, D) layout read through strides,
//   out[b, t, h, :] = softmax_s(l[t, s]) . v[b, s, h, :],
//   l[t, s] = scale * q[b, t, h] . k[b, s, h] + bias[b, s]
// with bias the additive key-padding row (0 valid, -1e9 pad). Under a
// causal mask, l[t, s] is REPLACED by -1e9 unless s <= t (and, with a
// window W > 0, s > t - W), as the reference replaces it; query t sits at
// position t, so G also takes T < S, as the reference's _flash_call does.
//
// What bounds them on the card: at the ViT's shape (B = 16, H = 12, D = 64,
// 577 queries over 584 keys) one call does 4.B.H.Tq.S.D = 16.6 GFLOP on
// ~114 MB of fp32 q, k, v and out: bytes (34.1 us at 3.35 TB/s) and the TF32
// tensor cores (33.5 us at 495 TFLOP/s, each product done once) bound it
// about equally; at B = 8, T = 250, H = 8 it moves ~16 MB for 1 GFLOP and
// bytes bound it (4.9 us). fp32 products on the FMA pipes (67 TFLOP/s, and a
// shared-memory load per FMA) were this file's first design; they ran 2.7x
// slower than SDPA at the ViT's shape.
//
// Design: bf16 A's (flash_attention_mma.cu) with fp32 operands. One block of
// 4 warps per (b.h, 64-query tile), 16 query rows per warp. Every product is
// 3xTF32 on mma.m16n8k8 (fp32 accumulate): x = hi + lo, both tf32, and a.b =
// lo.hi + hi.lo + hi.hi, so a product keeps ~2^-21 of its scale where one
// TF32 pass would keep ~2^-11 (2.2e-4 against the 1e-4 of the fp32 checks at
// the ViT's shape; mma3 says what the accumulation adds). Splitting is
// integer work (tf32_rna), and each K and V element meets all 4 warps, so it
// is done once per block: K and V tiles of 64 keys (16 at D = 128) land by
// 16-byte cp.async in raw tiles (the next tile's load in flight while this
// one is consumed), and one pass
// of the block writes each element as its {hi, lo} pair into split tiles,
// swizzled (flash_attention_mma.cuh sswz) so that a fragment read is one
// conflict-free 16- or 8-byte load and no arithmetic. Q is split once: into
// registers for D <= 64 (64 of them at D = 64), into a split tile at D =
// 128. Per tile and warp, S = Q.K^T is BK/8 n-tiles x D/8 k-steps of three
// mma; each thread owns distinct (row, key) elements of S, so each pair's
// scalar work (logit, mask, exp, hash) is done once. The online softmax
// keeps each row's running max (reduced over the row's quad) and per-thread
// partial sums of the unmasked p; p . F (the dropout factor), in fp32, is
// split in registers and feeds O += P.V from the S registers: an n-tile's
// accumulators are the A fragment of a k-step over its 8 keys once V's B
// fragment reads those keys in the order 0, 2, 4, 6, 1, 3, 5, 7
// (flash_attention_mma.cuh), so no value moves between lanes. Shared memory
// (96.5 KB at D = 64, 112 KB at D = 128) lets two blocks share an SM. The
// epilogue divides by l and stores fp32; each row's final max m and
// denominator l go to stat_m / stat_l for kernel H (no log-sum-exp: a row
// whose logits are all -1e9 keeps l, its key count, where m + log(l) would
// round back to -1e9). Rows are read through the (B, T, H, D) strides; the
// wrapper checks that they are 16-byte aligned.
//
// A masked logit is -1e9, never -inf (only keys past S are -inf), so a tile
// in which every key of a row is masked still has a finite maximum and the
// online softmax stays exact: such a row's weights are uniform until a tile
// with an allowed key wipes them (alpha = exp(-1e9 - m) = 0). A visits every
// key tile, so a row whose band is all padding gets the reference's uniform
// average over all S keys.
//
// Kernel G (SKIP) visits key tiles [lo, hi): lo = max(q0 - W + 1, 0) / BK (0
// without a window), hi = ceil((q0 + 64) / BK) clamped to the key count,
// masking in the edge tiles. A skipped tile holds only masked keys, and for
// a row with an allowed, unpadded key in its band those weigh exp(-1e9 - m)
// = 0, so skipping them is exact. A row whose whole band is padding (window
// > 0, t >= len + W - 1) is the exception: every one of its logits is -1e9,
// and the reference averages v over ALL S keys. So after the last band tile
// a block-uniform __syncthreads_or asks whether a row of the block still has
// a running max below -5e8; if so the block goes on over the skipped tiles
// [0, lo) and [hi, n), whose logits the mask sets to -1e9 for every row, and
// for every other row those add exactly 0 (p = 0, alpha = 1). The ring
// prefetches the next visit's tile; the first skipped tile is fetched only
// after that test. On rows with a real key G gives A-causal's bits.
//
// Dropout (training; attention.py:173-186 and :239-247): the reference
// multiplies the NORMALISED weights by keep / (1 - rate), with keep the
// counter hash of ((row0 + b).h_total + h0 + h, t, s) and a per-call seed (common.cuh
// hash_keep). The mask is a factor, so the online softmax stays exact when
// l sums the unmasked p and O sums p . F. The rate is a runtime argument (a
// launch with rate > 0 branches uniformly), so dropout adds no instance.
#include "flash_attention_mma.cuh"

namespace mm {
namespace {

using namespace tc;

constexpr int kBQ = 64;  // query rows per block

template <int D>
struct Cfg {
  static constexpr bool kQRegs = D <= 64;             // Q's split fragments in registers
  static constexpr int kBK = D <= 64 ? 64 : 16;       // keys per staged tile
  static constexpr int kQs = kQRegs ? 0 : kBQ * 2 * D;  // floats of Q's split tile (D = 128)
  // [Q split], K and V split, K and V raw, 2 x bias
  static constexpr int kSmem = (kQs + 6 * kBK * D + 2 * kBK) * 4;
  static_assert(kBQ * D <= 4 * kBK * D, "Q's raw rows are staged in the K and V split tiles");
};

// CAUSAL: apply the causal/window mask. SKIP (kernel G, needs CAUSAL):
// visit only the key tiles that meet the block's band, then, if a row of
// the block found no allowed key there, the skipped ones.
template <int D, bool CAUSAL, bool SKIP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FlashArgs a) {
  static_assert(CAUSAL || !SKIP, "band skipping needs the causal mask");
  using C = Cfg<D>;
  constexpr int KS = D / 8;  // k-steps over the head dim
  constexpr int NT = D / 8;  // n-tiles of the output row
  constexpr int BK = C::kBK;
  constexpr bool Q_REGS = C::kQRegs;
  extern __shared__ __align__(128) float smem32[];
  float* q_s = smem32;              // Q split (D = 128)
  float* k_s = q_s + C::kQs;        // K split; with v_s, Q's raw rows at the start
  float* v_s = k_s + BK * 2 * D;    // V split
  float* k_raw = v_s + BK * 2 * D;  // the next tile's K, V and bias land here
  float* v_raw = k_raw + BK * D;
  float* bias_sm = v_raw + BK * D;  // 2 stages

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const uint32_t hrow = hash_bh(a, b, h);  // the dropout hash's (b, h)
  const int q0 = blockIdx.y * kBQ;
  const int row0 = warp * 16;
  const int t_r[2] = {q0 + row0 + g, q0 + row0 + g + 8};

  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
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
  auto load_kv = [&](int i) {  // visit i's raw K and V, and its bias into stage i & 1
    const int s0 = tile_of(i) * BK;
    load_raw<BK, D>(k_raw, kb, a.k_st, s0, a.S);
    load_raw<BK, D>(v_raw, vb, a.v_st, s0, a.S);
    load_vec<BK>(bias_sm + (i & 1) * BK, bias_row, s0, a.S);
    cp_async_commit();
  };
  load_raw<kBQ, D>(k_s, qb, a.q_st, q0, a.T);
  load_kv(0);

  FragA32 qf[Q_REGS ? KS : 1];
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  int n_visits = n_band, fetched = 0;  // fetched: the last visit whose tile load was issued
  for (int i = 0; i < n_visits; ++i) {
    if (SKIP && i > fetched) load_kv(i);  // the first skipped tile: known only after the band
    cp_async_wait<0>();
    __syncthreads();  // visit i's raw tiles landed; visit i - 1's split tiles are consumed
    if (i == 0) {  // Q's staged rows: split into registers, or into q_s
      if (Q_REGS) {
#pragma unroll
        for (int kk = 0; kk < (Q_REGS ? KS : 0); ++kk) frag_a32_raw<D>(qf[kk], k_s, row0, kk);
      } else {
        split_tile<kBQ, D>(q_s, k_s);
      }
      __syncthreads();
    }
    split_tile<BK, D>(k_s, k_raw);
    split_tile<BK, D>(v_s, v_raw);
    __syncthreads();  // the split tiles are ready and the raw ones free
    if (i + 1 < n_visits) {
      load_kv(i + 1);
      fetched = i + 1;
    }
    const float* bs = bias_sm + (i & 1) * BK;
    const int s0 = tile_of(i) * BK;

    // S = Q.K^T: 16 rows x BK keys per warp.
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      FragA32 qa;
      if (Q_REGS)
        qa = qf[Q_REGS ? kk : 0];
      else
        frag_a32<D>(qa, q_s, row0, kk);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        FragB32 kf;
        frag_b32<D>(kf, k_s, n * 8, kk);
        mma3(s[n], qa, kf);
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

    // O += (P . F) . V: 16 rows x D per warp, a k-step per 8 keys.
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      FragA32 pa;
      acc_to_a32(pa, s[j]);
#pragma unroll
      for (int dn = 0; dn < NT; ++dn) {
        FragB32 vf;
        frag_bt32<D>(vf, v_s, j * 8, dn);
        mma3(o[dn], pa, vf);
      }
    }
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
    float* op = static_cast<float*>(a.out) + (((int64_t)b * a.T + t) * a.H + h) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(op + n * 8) = make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

template <int D, bool CAUSAL, bool SKIP>
cudaError_t launch_flash(const FlashArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = Cfg<D>::kSmem;
  const cudaError_t err = allow_smem_max(flash_fwd_kernel<D, CAUSAL, SKIP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.H, (a.T + kBQ - 1) / kBQ);
  flash_fwd_kernel<D, CAUSAL, SKIP><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool CAUSAL, bool SKIP>
cudaError_t dispatch_flash(int D, const FlashArgs& a, int B, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_flash<16, CAUSAL, SKIP>(a, B, stream);
    case 32: return launch_flash<32, CAUSAL, SKIP>(a, B, stream);
    case 64: return launch_flash<64, CAUSAL, SKIP>(a, B, stream);
    case 128: return launch_flash<128, CAUSAL, SKIP>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t launch_flash_fwd_f32(const FlashArgs& a, int B, int D, bool causal, bool skip,
                                 cudaStream_t stream) {
  if (skip) return dispatch_flash<true, true>(D, a, B, stream);
  return causal ? dispatch_flash<true, false>(D, a, B, stream)
                : dispatch_flash<false, false>(D, a, B, stream);
}

}  // namespace mm

// C entries: each returns cudaGetLastError() after its launch (0 on success).

// Kernel A: every key tile; the causal/window mask when ``causal`` != 0.
// ``rate`` > 0: attention dropout with ``seed``, the hash's (b, h) row offset by
// ``bh0`` (a data-parallel shard's first row times ``h_total``), local head h
// hashed as global head ``h0`` + h of ``h_total`` (tensor parallelism); non-null ``stat_m`` /
// ``stat_l``: each row's softmax max and denominator for kernel H. Rows
// 16-byte aligned; bf16 in flash_attention_mma.cu, fp32 here.
extern "C" int mm_flash_attention(
    int dtype, const void* q, const void* k, const void* v, const void* bias,
    void* out, int B, int T, int S, int H, int D,
    int64_t q_sb, int64_t q_st, int64_t q_sh,
    int64_t k_sb, int64_t k_st, int64_t k_sh,
    int64_t v_sb, int64_t v_st, int64_t v_sh,
    float scale, int causal, int window, double rate, unsigned int seed, unsigned int bh0,
    unsigned int h_total, unsigned int h0,
    float* stat_m, float* stat_l, void* stream) {
  if (!(rate >= 0.0 && rate < 1.0)) return (int)cudaErrorInvalidValue;
  const mm::FlashArgs a{q, k, v, static_cast<const float*>(bias), out, T, S, H,
                        q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, window,
                        (float)rate, (float)(1.0 / (1.0 - rate)), seed, bh0, h_total, h0,
                        stat_m, stat_l};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mm::kBFloat16)
    return (int)mm::launch_flash_fwd_mma(a, B, D, causal != 0, false, st);
  if (dtype != mm::kFloat32) return (int)cudaErrorInvalidValue;
  return (int)mm::launch_flash_fwd_f32(a, B, D, causal != 0, false, st);
}

// Kernel G: causal (``causal`` must be 1) with key-tile skipping, T <= S;
// the same rules.
extern "C" int mm_flash_attention_causal_skip(
    int dtype, const void* q, const void* k, const void* v, const void* bias,
    void* out, int B, int T, int S, int H, int D,
    int64_t q_sb, int64_t q_st, int64_t q_sh,
    int64_t k_sb, int64_t k_st, int64_t k_sh,
    int64_t v_sb, int64_t v_st, int64_t v_sh,
    float scale, int causal, int window, double rate, unsigned int seed, unsigned int bh0,
    unsigned int h_total, unsigned int h0,
    float* stat_m, float* stat_l, void* stream) {
  if (!causal || T > S) return (int)cudaErrorInvalidValue;
  if (!(rate >= 0.0 && rate < 1.0)) return (int)cudaErrorInvalidValue;
  const mm::FlashArgs a{q, k, v, static_cast<const float*>(bias), out, T, S, H,
                        q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, window,
                        (float)rate, (float)(1.0 / (1.0 - rate)), seed, bh0, h_total, h0,
                        stat_m, stat_l};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mm::kFloat32) return (int)mm::launch_flash_fwd_f32(a, B, D, true, true, st);
  if (dtype == mm::kBFloat16) return (int)mm::launch_flash_fwd_mma(a, B, D, true, true, st);
  return (int)cudaErrorInvalidValue;
}
