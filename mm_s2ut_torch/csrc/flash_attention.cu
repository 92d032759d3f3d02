// Kernels A and G — encoder self-attention forward, with attention dropout.
// This file holds the SIMT kernel, which runs A and G in fp32. In bf16 both
// run on the tensor cores (flash_attention_mma.cu); the C entries below
// dispatch to it.
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
// What bounds them on the card: at the encoder shapes (B = 1..8, H = 8,
// D = 64, T ~ 100-1000 after subsampling) one call does 4.B.H.T^2.D
// ~ 0.01-4 GFLOP against ~0.1-8 MB of q/k/v, so it is bound by
// arithmetic, done in this file on the fp32 FMA pipes (no tensor cores), and
// at short T by block count: B.H.ceil(T/64) blocks for 132 SMs. G does
// about half of A's causal work (more with a window) by never visiting
// the tiles above the diagonal or left of the window.
//
// Design: one block per (b.h, 64-query tile); two threads per query row,
// each owning D/2 dims of q and of the fp32 accumulator, their partial
// dot products joined by one shuffle. Key/value tiles are staged in
// shared memory as fp32 and consumed with an online softmax, so the
// (T, S) logits never leave registers. The TPU kernel held a head's whole
// K/V in VMEM and ran one softmax pass; a block's shared memory is far
// smaller, hence the tile loop with a running max. The ragged query and
// key edges are masked in-kernel, so any T and S run: the reference's
// pad-to-16 and alignment gate have no counterpart here. A masked logit
// is -1e9, never -inf, so a tile in which every key of a row is masked
// still has a finite maximum and the online softmax stays exact: such a
// row's weights are uniform until a tile with an allowed key wipes them
// (alpha = exp(-1e9 - m) = 0).
//
// G visits key tiles [lo, hi): lo = max(q0 - W + 1, 0) / BK (0 without a
// window), hi = ceil((q0 + 64) / BK) clamped to the key count, masking in
// the edge tiles. A skipped tile holds only masked keys, and for a row
// with an allowed, unpadded key in its band those weigh exp(-1e9 - m) = 0,
// so skipping them is exact. A row whose whole band is padding (window
// > 0, t >= len + W - 1) is the exception: every one of its logits is
// -1e9, and the reference averages v over ALL S keys. G reproduces that:
// if any row of the block ends the band with a running max below -5e8
// (no real logit comes near), the block goes on to visit the skipped
// tiles, where the causal/window mask sets every logit of the block to
// -1e9; for every other row those add exactly 0. Such rows are padding
// the encoder masks downstream, so this costs only blocks that hold them.
// Band and skipped tiles go through one loop, so the tile code is
// generated once.
//
// Dropout (training; attention.py:173-186 and :239-247): the reference
// multiplies the NORMALISED weights by keep / (1 - rate), with keep the
// counter hash of (bh, t, s) and a per-call seed (common.cuh hash_keep).
// The mask is a factor, so the online softmax stays exact when l_run sums
// the unmasked p and acc sums p . keep / (1 - rate). The rate is a runtime
// argument (a launch with rate > 0 branches uniformly), so dropout adds no
// kernel instance. When the caller needs a gradient, each row's final
// running max m and denominator l go to stat_m / stat_l (B.H, T) for kernel
// H, which recomputes P = exp(logit - m) / l with the same logits: a row
// whose logits are all -1e9 keeps l = (its key count) there, where a
// log-sum-exp m + log(l) would round back to -1e9 and lose it.
#include "flash_attention_mma.cuh"

namespace mm {
namespace {

constexpr int kBlockQ = 64;
constexpr int kFlashThreads = 2 * kBlockQ;

// One key tile [s0, s0 + BK) into the running softmax of query row t.
template <int D, int BK, bool CAUSAL>
__device__ __forceinline__ void visit_tile(
    const FlashArgs& a, const float* kb, const float* vb, const float* bias_row, int s0, int t,
    float (&ks)[BK][D], float (&vs)[BK][D], float (&bs)[BK],
    const float (&qr)[D / 2], float (&acc)[D / 2], float& m_run, float& l_run) {
  constexpr int HALF = D / 2;
  const int part = threadIdx.x & 1;
  __syncthreads();  // the previous tile is fully consumed
  for (int i = threadIdx.x; i < BK * D; i += kFlashThreads) {
    const int j = i / D, d = i % D;
    const int s = s0 + j;
    const bool ok = s < a.S;
    ks[j][d] = ok ? kb[(int64_t)s * a.k_st + d] : 0.f;
    vs[j][d] = ok ? vb[(int64_t)s * a.v_st + d] : 0.f;
  }
  for (int j = threadIdx.x; j < BK; j += kFlashThreads)
    bs[j] = s0 + j < a.S ? bias_row[s0 + j] : 0.f;
  __syncthreads();

  const int n = min(BK, a.S - s0);  // >= 1: every visited tile starts below S
  float sc[BK];
  float m_tile = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK; ++j) {
    const float4* kr = reinterpret_cast<const float4*>(&ks[j][part * HALF]);
    float s = 0.f;
#pragma unroll
    for (int d4 = 0; d4 < HALF / 4; ++d4) {
      const float4 kk = kr[d4];
      s = fmaf(qr[4 * d4 + 0], kk.x, s);
      s = fmaf(qr[4 * d4 + 1], kk.y, s);
      s = fmaf(qr[4 * d4 + 2], kk.z, s);
      s = fmaf(qr[4 * d4 + 3], kk.w, s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s = fmaf(s, a.scale, bs[j]);
    if (CAUSAL) {
      const int kpos = s0 + j;
      if (kpos > t || (a.window > 0 && kpos <= t - a.window)) s = kMasked;
    }
    s = j < n ? s : -INFINITY;
    sc[j] = s;
    m_tile = fmaxf(m_tile, s);
  }
  // m_tile >= -1e9 is finite: key s0 < S is in the tile, and a masked
  // logit is -1e9, not -inf.
  const float m_new = fmaxf(m_run, m_tile);
  const float alpha = expf(m_run - m_new);  // 0 on the first tile (m_run = -inf)
  l_run *= alpha;
#pragma unroll
  for (int d = 0; d < HALF; ++d) acc[d] *= alpha;
#pragma unroll
  for (int j = 0; j < BK; ++j) {
    sc[j] = expf(sc[j] - m_new);  // 0 past the key edge
    l_run += sc[j];
  }
  // Dropout touches the weights alone, in a loop of its own, so the
  // accumulation below is the same code with and without it.
  if (a.rate > 0.f) {
#pragma unroll
    for (int j = 0; j < BK; ++j)
      sc[j] = hash_keep(a.bh0 + blockIdx.x, t, s0 + j, a.seed, a.rate) ? sc[j] * a.inv_keep : 0.f;
  }
#pragma unroll
  for (int j = 0; j < BK; ++j) {
    const float p = sc[j];
    const float4* vr = reinterpret_cast<const float4*>(&vs[j][part * HALF]);
#pragma unroll
    for (int d4 = 0; d4 < HALF / 4; ++d4) {
      const float4 vv = vr[d4];
      acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
      acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
      acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
      acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
    }
  }
  m_run = m_new;
}

// CAUSAL: apply the causal/window mask. SKIP (kernel G, needs CAUSAL):
// visit only the key tiles that meet the block's band.
template <int D, bool CAUSAL, bool SKIP>
__global__ void __launch_bounds__(kFlashThreads) flash_fwd_kernel(const FlashArgs a) {
  constexpr int BK = D <= 64 ? 64 : 32;  // 2.BK.D.4 B = 32 KB of shared memory
  constexpr int HALF = D / 2;  // dims per thread
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ float bs[BK];

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int row = threadIdx.x >> 1;
  const int part = threadIdx.x & 1;
  const int q0 = blockIdx.y * kBlockQ;
  const int t = q0 + row;
  const bool row_ok = t < a.T;

  const float* q = static_cast<const float*>(a.q);
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* bias_row = a.bias + (int64_t)b * a.S;

  float qr[HALF], acc[HALF];
  const float* qp = q + b * a.q_sb + (int64_t)(row_ok ? t : 0) * a.q_st + h * a.q_sh + part * HALF;
#pragma unroll
  for (int d = 0; d < HALF; ++d) {
    qr[d] = row_ok ? qp[d] : 0.f;
    acc[d] = 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f;

  const int n_tiles = (a.S + BK - 1) / BK;
  int lo = 0, hi = n_tiles;
  if (SKIP) {
    hi = min((q0 + kBlockQ + BK - 1) / BK, n_tiles);
    if (a.window > 0) lo = max(q0 - a.window + 1, 0) / BK;
  }
  // Visit i < hi - lo is band tile lo + i; past that, only when a row of
  // the block found no allowed key in its band, come the skipped tiles
  // [0, lo) and [hi, n_tiles), all masked for every row of the block.
  const int n_band = hi - lo;  // >= 1: tile q0 / BK is in the band
  int n_visits = n_band;
  for (int i = 0; i < n_visits; ++i) {
    const int e = i - n_band;
    const int tile = e < 0 ? lo + i : (e < lo ? e : e + n_band);
    visit_tile<D, BK, CAUSAL>(a, kb, vb, bias_row, tile * BK, t, ks, vs, bs, qr, acc, m_run,
                              l_run);
    // A row whose whole band is padding: the reference's softmax spans all
    // S keys at -1e9, so the skipped tiles join (block-uniform test).
    if (SKIP && i + 1 == n_band && __syncthreads_or(row_ok && m_run < -5e8f))
      n_visits = n_tiles;
  }

  if (row_ok && a.stat_m != nullptr && part == 0) {
    a.stat_m[(int64_t)bh * a.T + t] = m_run;
    a.stat_l[(int64_t)bh * a.T + t] = l_run;
  }
  if (row_ok) {
    const float inv = 1.f / l_run;
    float* op = static_cast<float*>(a.out) + (((int64_t)b * a.T + t) * a.H + h) * D + part * HALF;
#pragma unroll
    for (int d = 0; d < HALF; ++d) op[d] = acc[d] * inv;
  }
}

template <int D, bool CAUSAL, bool SKIP>
cudaError_t launch_flash(const FlashArgs& a, int B, cudaStream_t stream) {
  const dim3 grid(B * a.H, (a.T + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<D, CAUSAL, SKIP><<<grid, kFlashThreads, 0, stream>>>(a);
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
}  // namespace mm

// C entries: each returns cudaGetLastError() after its launch (0 on success).

// Kernel A: every key tile; the causal/window mask when ``causal`` != 0.
// ``rate`` > 0: attention dropout with ``seed``, the hash's (b, h) row offset by
// ``bh0`` (a data-parallel shard's first row times H); non-null ``stat_m`` /
// ``stat_l``: each row's softmax max and denominator for kernel H. bf16
// runs on the tensor cores (rows 16-byte aligned), fp32 here.
extern "C" int mm_flash_attention(
    int dtype, const void* q, const void* k, const void* v, const void* bias,
    void* out, int B, int T, int S, int H, int D,
    int64_t q_sb, int64_t q_st, int64_t q_sh,
    int64_t k_sb, int64_t k_st, int64_t k_sh,
    int64_t v_sb, int64_t v_st, int64_t v_sh,
    float scale, int causal, int window, double rate, unsigned int seed, unsigned int bh0,
    float* stat_m, float* stat_l, void* stream) {
  if (!(rate >= 0.0 && rate < 1.0)) return (int)cudaErrorInvalidValue;
  const mm::FlashArgs a{q, k, v, static_cast<const float*>(bias), out, T, S, H,
                        q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, window,
                        (float)rate, (float)(1.0 / (1.0 - rate)), seed, bh0, stat_m, stat_l};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mm::kBFloat16)
    return (int)mm::launch_flash_fwd_mma(a, B, D, causal != 0, false, st);
  if (dtype != mm::kFloat32) return (int)cudaErrorInvalidValue;
  return causal ? (int)mm::dispatch_flash<true, false>(D, a, B, st)
                : (int)mm::dispatch_flash<false, false>(D, a, B, st);
}

// Kernel G: causal (``causal`` must be 1) with key-tile skipping, T <= S;
// bf16 on the tensor cores (rows 16-byte aligned), fp32 here.
extern "C" int mm_flash_attention_causal_skip(
    int dtype, const void* q, const void* k, const void* v, const void* bias,
    void* out, int B, int T, int S, int H, int D,
    int64_t q_sb, int64_t q_st, int64_t q_sh,
    int64_t k_sb, int64_t k_st, int64_t k_sh,
    int64_t v_sb, int64_t v_st, int64_t v_sh,
    float scale, int causal, int window, double rate, unsigned int seed, unsigned int bh0,
    float* stat_m, float* stat_l, void* stream) {
  if (!causal || T > S) return (int)cudaErrorInvalidValue;
  if (!(rate >= 0.0 && rate < 1.0)) return (int)cudaErrorInvalidValue;
  const mm::FlashArgs a{q, k, v, static_cast<const float*>(bias), out, T, S, H,
                        q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, window,
                        (float)rate, (float)(1.0 / (1.0 - rate)), seed, bh0, stat_m, stat_l};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mm::kFloat32) return (int)mm::dispatch_flash<true, true>(D, a, B, st);
  if (dtype == mm::kBFloat16) return (int)mm::launch_flash_fwd_mma(a, B, D, true, true, st);
  return (int)cudaErrorInvalidValue;
}
