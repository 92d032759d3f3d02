// Kernel H — encoder self-attention backward (the fused attention VJP).
// This file holds the SIMT kernels, which run H in fp32; bf16 runs on the
// tensor cores (flash_attention_bwd_mma.cu), the same split and formulas.
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
// without atomics:
//   H-kv: one block per (b.h, 64-key tile); each key belongs to D/DT
//         threads (DT = min(D, 32) dims each), which hold its k, v, dk and
//         dv rows in registers and loop over every query tile staged in
//         shared memory (fp32), accumulating dV, dK and dbias;
//   H-q:  one block per (b.h, 64-query tile), the same split per query
//         row, looping twice over every key tile staged in shared memory:
//         first summing Delta (written for H-kv, so H-q launches first),
//         then accumulating dQ.
// Every tile is visited, under the causal/window mask too: a row whose
// whole band is padding has the reference's uniform weights over all S
// keys, and its gradients reach every key. Query rows t >= T are the only
// rows that contribute nothing; key-padding rows t < T are real rows.
//
// What bounds it on the card: at the encoder's training shapes (B = 8,
// H = 8, T = S = 250, D = 64) the VJP does ~10.B.H.T.S.D ~ 2.6 GFLOP
// against ~16-20 MB of q, k, v, dO, O and the fp32 dq, dk, dv, so by
// bytes the bound is ~5-6 us; done on the fp32 FMA pipes (no tensor cores)
// it is bound by arithmetic, at ~4 FMA per (t, s, d) pair per kernel.
#include "flash_attention_mma.cuh"

namespace mm {
namespace {

template <int D>
struct Split {
  static constexpr int DT = D < 32 ? D : 32;  // dims per thread
  static constexpr int PARTS = D / DT;        // threads per query row or key
};

// Sum over the PARTS neighbouring lanes that share a row or a key.
template <int PARTS>
__device__ __forceinline__ float part_sum(float x) {
  if (PARTS >= 2) x += __shfl_xor_sync(0xffffffffu, x, 1);
  if (PARTS >= 4) x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// The weight P of (t, s) from the logit as the forward computes it (one
// fmaf, or -1e9 where masked) and the forward's row statistics.
__device__ __forceinline__ float weight(const BwdArgs& a, float dot, float bias, bool mask,
                                        float m, float l) {
  return expf((mask ? kMasked : fmaf(dot, a.scale, bias)) - m) / l;
}

// H-kv: dK, dV and dbias of one 64-key tile.
template <int D>
__global__ void __launch_bounds__(64 * Split<D>::PARTS) attn_bwd_kv_kernel(const BwdArgs a) {
  constexpr int DT = Split<D>::DT, PARTS = Split<D>::PARTS;
  constexpr int BK = 64;                 // keys per block
  constexpr int BQ = D <= 64 ? 64 : 32;  // query rows per staged tile: 2.BQ.D.4 B <= 32 KB
  constexpr int NT = BK * PARTS;
  __shared__ __align__(16) float qs[BQ][D];
  __shared__ __align__(16) float gs[BQ][D];
  __shared__ float ms[BQ], ls[BQ], dls[BQ];

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int part = threadIdx.x % PARTS;
  const int s = blockIdx.y * BK + threadIdx.x / PARTS;
  const bool key_ok = s < a.S;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + (int64_t)(key_ok ? s : 0) * a.k_st +
                h * a.k_sh + part * DT;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + (int64_t)(key_ok ? s : 0) * a.v_st +
                h * a.v_sh + part * DT;
  float kr[DT], vr[DT], dk[DT], dv[DT];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    kr[d] = key_ok ? kp[d] : 0.f;
    vr[d] = key_ok ? vp[d] : 0.f;
    dk[d] = 0.f;
    dv[d] = 0.f;
  }
  const float bias_s = key_ok ? a.bias[(int64_t)b * a.S + s] : 0.f;
  float dbias = 0.f;

  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* gb = static_cast<const float*>(a.dout) + ((int64_t)b * a.T * a.H + h) * D;
  const int64_t row0 = (int64_t)bh * a.T;
  for (int q0 = 0; q0 < a.T; q0 += BQ) {
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < BQ * D; i += NT) {
      const int r = i / D, d = i % D, t = q0 + r;
      const bool ok = t < a.T;
      qs[r][d] = ok ? qb[(int64_t)t * a.q_st + d] : 0.f;
      gs[r][d] = ok ? gb[(int64_t)t * a.H * D + d] : 0.f;
    }
    for (int r = threadIdx.x; r < BQ; r += NT) {
      const int t = q0 + r;
      const bool ok = t < a.T;
      ms[r] = ok ? a.stat_m[row0 + t] : 0.f;
      ls[r] = ok ? a.stat_l[row0 + t] : 1.f;
      dls[r] = ok ? a.delta[row0 + t] : 0.f;
    }
    __syncthreads();
    const int n = min(BQ, a.T - q0);
    for (int r = 0; r < n; ++r) {
      const int t = q0 + r;
      const float4* qrow = reinterpret_cast<const float4*>(&qs[r][part * DT]);
      const float4* grow = reinterpret_cast<const float4*>(&gs[r][part * DT]);
      float sdot = 0.f, pdot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DT / 4; ++d4) {
        const float4 qq = qrow[d4], gg = grow[d4];
        sdot = fmaf(qq.x, kr[4 * d4 + 0], sdot);
        sdot = fmaf(qq.y, kr[4 * d4 + 1], sdot);
        sdot = fmaf(qq.z, kr[4 * d4 + 2], sdot);
        sdot = fmaf(qq.w, kr[4 * d4 + 3], sdot);
        pdot = fmaf(gg.x, vr[4 * d4 + 0], pdot);
        pdot = fmaf(gg.y, vr[4 * d4 + 1], pdot);
        pdot = fmaf(gg.z, vr[4 * d4 + 2], pdot);
        pdot = fmaf(gg.w, vr[4 * d4 + 3], pdot);
      }
      sdot = part_sum<PARTS>(sdot);
      pdot = part_sum<PARTS>(pdot);
      const bool mask = masked(a, t, s);
      const float p = key_ok ? weight(a, sdot, bias_s, mask, ms[r], ls[r]) : 0.f;
      const float f = keep_factor(a, bh, t, s);
      const float pf = p * f;
      const float ds = mask ? 0.f : p * (pdot * f - dls[r]);
#pragma unroll
      for (int d4 = 0; d4 < DT / 4; ++d4) {
        const float4 qq = qrow[d4], gg = grow[d4];
        dv[4 * d4 + 0] = fmaf(pf, gg.x, dv[4 * d4 + 0]);
        dv[4 * d4 + 1] = fmaf(pf, gg.y, dv[4 * d4 + 1]);
        dv[4 * d4 + 2] = fmaf(pf, gg.z, dv[4 * d4 + 2]);
        dv[4 * d4 + 3] = fmaf(pf, gg.w, dv[4 * d4 + 3]);
        dk[4 * d4 + 0] = fmaf(ds, qq.x, dk[4 * d4 + 0]);
        dk[4 * d4 + 1] = fmaf(ds, qq.y, dk[4 * d4 + 1]);
        dk[4 * d4 + 2] = fmaf(ds, qq.z, dk[4 * d4 + 2]);
        dk[4 * d4 + 3] = fmaf(ds, qq.w, dk[4 * d4 + 3]);
      }
      dbias += ds;
    }
  }
  if (key_ok) {
    const int64_t o = (((int64_t)b * a.S + s) * a.H + h) * D + part * DT;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      a.dk[o + d] = dk[d] * a.scale;
      a.dv[o + d] = dv[d];
    }
    if (part == 0) a.dbias[(int64_t)bh * a.S + s] = dbias;
  }
}

// H-q: Delta, then dQ, of one 64-query tile.
template <int D>
__global__ void __launch_bounds__(64 * Split<D>::PARTS) attn_bwd_q_kernel(const BwdArgs a) {
  constexpr int DT = Split<D>::DT, PARTS = Split<D>::PARTS;
  constexpr int BQ = 64;                 // query rows per block
  constexpr int BK = D <= 64 ? 64 : 32;  // keys per staged tile: 2.BK.D.4 B <= 32 KB
  constexpr int NT = BQ * PARTS;
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ float bs[BK];

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int part = threadIdx.x % PARTS;
  const int t = blockIdx.y * BQ + threadIdx.x / PARTS;
  const bool row_ok = t < a.T;
  const int tt = row_ok ? t : 0;
  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + (int64_t)tt * a.q_st + h * a.q_sh +
                part * DT;
  const float* gp = static_cast<const float*>(a.dout) + (((int64_t)b * a.T + tt) * a.H + h) * D +
                part * DT;
  float qr[DT], gr[DT], dq[DT];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    qr[d] = row_ok ? qp[d] : 0.f;
    gr[d] = row_ok ? gp[d] : 0.f;
    dq[d] = 0.f;
  }
  const int64_t row = (int64_t)bh * a.T + tt;
  const float m = row_ok ? a.stat_m[row] : 0.f;
  const float l = row_ok ? a.stat_l[row] : 1.f;

  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* bias_row = a.bias + (int64_t)b * a.S;
  // Pass 0 sums Delta = sum_s P (dP F) over every key; pass 1 forms dS and
  // dQ. Both form P and dP F by the same instructions, so a row of one
  // valid key gets dS = 0 exactly, as the reference does.
  float dl = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int s0 = 0; s0 < a.S; s0 += BK) {
      __syncthreads();  // the previous tile is fully consumed
      for (int i = threadIdx.x; i < BK * D; i += NT) {
        const int j = i / D, d = i % D, s = s0 + j;
        const bool ok = s < a.S;
        ks[j][d] = ok ? kb[(int64_t)s * a.k_st + d] : 0.f;
        vs[j][d] = ok ? vb[(int64_t)s * a.v_st + d] : 0.f;
      }
      for (int j = threadIdx.x; j < BK; j += NT) bs[j] = s0 + j < a.S ? bias_row[s0 + j] : 0.f;
      __syncthreads();
      const int n = min(BK, a.S - s0);
      for (int j = 0; j < n; ++j) {
        const int s = s0 + j;
        const float4* krow = reinterpret_cast<const float4*>(&ks[j][part * DT]);
        const float4* vrow = reinterpret_cast<const float4*>(&vs[j][part * DT]);
        float sdot = 0.f, pdot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < DT / 4; ++d4) {
          const float4 kk = krow[d4], vv = vrow[d4];
          sdot = fmaf(qr[4 * d4 + 0], kk.x, sdot);
          sdot = fmaf(qr[4 * d4 + 1], kk.y, sdot);
          sdot = fmaf(qr[4 * d4 + 2], kk.z, sdot);
          sdot = fmaf(qr[4 * d4 + 3], kk.w, sdot);
          pdot = fmaf(gr[4 * d4 + 0], vv.x, pdot);
          pdot = fmaf(gr[4 * d4 + 1], vv.y, pdot);
          pdot = fmaf(gr[4 * d4 + 2], vv.z, pdot);
          pdot = fmaf(gr[4 * d4 + 3], vv.w, pdot);
        }
        sdot = part_sum<PARTS>(sdot);
        pdot = part_sum<PARTS>(pdot);
        const bool mask = masked(a, t, s);
        const float p = row_ok ? weight(a, sdot, bs[j], mask, m, l) : 0.f;
        const float dw = pdot * keep_factor(a, bh, t, s);
        if (pass == 0) {
          dl = fmaf(p, dw, dl);
          continue;
        }
        const float ds = mask ? 0.f : p * (dw - dl);
#pragma unroll
        for (int d4 = 0; d4 < DT / 4; ++d4) {
          const float4 kk = krow[d4];
          dq[4 * d4 + 0] = fmaf(ds, kk.x, dq[4 * d4 + 0]);
          dq[4 * d4 + 1] = fmaf(ds, kk.y, dq[4 * d4 + 1]);
          dq[4 * d4 + 2] = fmaf(ds, kk.z, dq[4 * d4 + 2]);
          dq[4 * d4 + 3] = fmaf(ds, kk.w, dq[4 * d4 + 3]);
        }
      }
    }
    if (pass == 0 && row_ok && part == 0) a.delta[row] = dl;
  }
  if (row_ok) {
    float* o = static_cast<float*>(a.dq) + (((int64_t)b * a.T + t) * a.H + h) * D + part * DT;
#pragma unroll
    for (int d = 0; d < DT; ++d) o[d] = dq[d] * a.scale;
  }
}

template <int D>
cudaError_t launch_bwd(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int NT = 64 * Split<D>::PARTS;
  // H-q first: it writes the Delta that H-kv reads.
  attn_bwd_q_kernel<D><<<dim3(B * a.H, (a.T + 63) / 64), NT, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_kv_kernel<D><<<dim3(B * a.H, (a.S + 63) / 64), NT, 0, stream>>>(a);
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
// ``causal`` needs T <= S (query t at position t), as kernel G. bf16 runs
// on the tensor cores (flash_attention_bwd_mma.cu; rows 16-byte aligned),
// fp32 here.
extern "C" int mm_flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* stat_m, const void* stat_l, void* delta,
    void* dq, void* dk, void* dv, void* dbias, int B, int T, int S, int H, int D,
    int64_t q_sb, int64_t q_st, int64_t q_sh,
    int64_t k_sb, int64_t k_st, int64_t k_sh,
    int64_t v_sb, int64_t v_st, int64_t v_sh,
    float scale, int causal, int window, double rate, unsigned int seed, unsigned int bh0,
    void* stream) {
  if (!(rate >= 0.0 && rate < 1.0) || (causal && T > S)) return (int)cudaErrorInvalidValue;
  const mm::BwdArgs a{q, k, v, static_cast<const float*>(bias), dout,
                      static_cast<const float*>(stat_m), static_cast<const float*>(stat_l),
                      static_cast<float*>(delta), dq, static_cast<float*>(dk),
                      static_cast<float*>(dv), static_cast<float*>(dbias), T, S, H,
                      q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, causal,
                      window, (float)rate, (float)(1.0 / (1.0 - rate)), seed, bh0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mm::kFloat32) return (int)mm::dispatch_bwd_f32(D, a, B, st);
  if (dtype == mm::kBFloat16) return (int)mm::launch_flash_bwd_mma(a, B, D, st);
  return (int)cudaErrorInvalidValue;
}
