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
// flat_rep, sk and sv use logical column ids, so F is D with another load.
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
// Design of D/F: grid (B, H), warps striding over 32-column chunks of the
// T.S axis with B's ballot over coalesced flat_rep reads, so only on-path
// columns are read, each once for all the beams on it. The per-row requant
// scale ws needs the finished softmax, which B's one-pass online softmax
// cannot give; so D runs two passes over the columns. Pass 1 reads the K
// halves and keeps each beam's on-path scores in shared memory: a beam has
// at most one on-path column among the S = K slots of a step, so the scores
// fit in K.T floats (plus one slot byte each), 10 KB at the bench's T = 201
// and 150 KB at the 3000-position clamp. Between the passes one warp per
// beam takes the row max, the denominator and ws from shared memory. Pass 2
// reads the V halves, recomputes each w_eff with the same expression (so
// w8 <= 127 as in the reference), and accumulates w8.v8 in int32 registers,
// merged across warps with shared-memory integer atomics: integer sums are
// exact in any order, so the kernel is deterministic. The cache and both
// scale arrays are read through their strides (the beam search passes
// prefix views of one allocation; a contiguous copy of the scales would
// move 2.B.L.H.T.S.4 bytes per layer call). At step 0 no column is on a
// path and the output is exactly v_new.
//
// Design of E: kernel C's (grid (B.H, ceil(K/16)), a block's <= 16 rows of
// scores in shared memory for a two-pass softmax, one thread per output
// dim in the V pass; any row count, as the prefill's P rows), with the
// scales folded where the reference folds them and each thread's K row
// read in 16-byte chunks.
#include "common.cuh"

namespace mm {
namespace {

constexpr int kMaxBeamsQ = 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_sum_int(int v) { return __reduce_add_sync(kFull, v); }

// ---------------------------------------------------------------- kernels D, F

struct QuantAncestryArgs {
  const void* q;        // (B, H, K, Dh) contiguous, pre-scaled
  const void* k_new;    // (B, H, K, Dh) contiguous
  const void* v_new;    // (B, H, K, Dh) contiguous
  const int8_t* kv;     // (B, L, H, rows, 2.Dh) through strides, last dim dense;
                        // rows = TS (int8) or TS/2 (int4, packed)
  const float* sk;      // (B, L, H, TS) through strides, last dim dense
  const float* sv;      // (B, L, H, TS) through strides, last dim dense
  const int* flat_rep;  // (B, K, TS) contiguous
  void* out;            // (B, H, K, Dh) contiguous
  int H, K, TS, layer;
  int64_t kv_sb, kv_sl, kv_sh, kv_sj;
  int64_t sk_sb, sk_sl, sk_sh;
  int64_t sv_sb, sv_sl, sv_sh;
};

// Element e (< 2.Dh) of logical column j, as a signed integer.
template <bool PACKED>
__device__ __forceinline__ int load_col(const int8_t* slab, int64_t sj, int P, int j, int e) {
  if (!PACKED) return slab[(int64_t)j * sj + e];
  const bool high = j >= P;
  const int x = slab[(int64_t)(high ? j - P : j) * sj + e];
  return high ? (x >> 4) : (((x & 0xF) ^ 8) - 8);  // sign-extended nibble
}

// Static shared memory of the D/F kernel besides the dynamic score area.
template <int DH>
struct QuantShared {
  float qs[kMaxBeamsQ], sl[kMaxBeamsQ], m[kMaxBeamsQ], den[kMaxBeamsQ], pself[kMaxBeamsQ],
      ws[kMaxBeamsQ];
  int acc[kMaxBeamsQ][DH];
};

template <typename T, int DH, int NW, bool PACKED>
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
    int q8[kMaxBeamsQ][E];
#pragma unroll
    for (int k = 0; k < kMaxBeamsQ; ++k) {
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
          kr[e] = d < DH ? load_col<PACKED>(slab, a.kv_sj, P, jj, d) : 0;
        }
        const float skj = skp[jj];
#pragma unroll
        for (int k = 0; k < kMaxBeamsQ; ++k) {
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
    int acc[kMaxBeamsQ][E];
#pragma unroll
    for (int k = 0; k < kMaxBeamsQ; ++k)
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
          vr[e] = d < DH ? load_col<PACKED>(slab, a.kv_sj, P, jj, DH + d) : 0;
        }
        const float svj = svp[jj];
#pragma unroll
        for (int k = 0; k < kMaxBeamsQ; ++k) {
          if (!((on >> k) & 1u)) continue;  // warp-uniform
          const float w_eff = __fmul_rn(expf(sc[k * Tn + t] - sh.m[k]) / sh.den[k], svj);
          const int w8 = (int)rintf(w_eff / sh.ws[k]);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[k][e] += w8 * vr[e];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxBeamsQ; ++k) {
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

// Dynamic shared memory of the D/F kernel: K.T scores and K.T slot bytes.
size_t quant_dyn_bytes(int K, int Tn) {
  const size_t n = (size_t)K * Tn;
  return n * sizeof(float) + ((n + 3) / 4) * 4;
}

template <typename T, int DH, bool PACKED>
cudaError_t launch_quant_ancestry(const QuantAncestryArgs& a, int B, cudaStream_t stream) {
  constexpr int NW = 8;
  const size_t smem = quant_dyn_bytes(a.K, a.TS / a.K);
  auto kernel = ancestry_decode_q_kernel<T, DH, NW, PACKED>;
  if (smem + sizeof(QuantShared<DH>) > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(B, a.H), NW * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool PACKED>
cudaError_t dispatch_quant_ancestry(int DH, const QuantAncestryArgs& a, int B,
                                    cudaStream_t stream) {
  switch (DH) {
    case 16: return launch_quant_ancestry<T, 16, PACKED>(a, B, stream);
    case 32: return launch_quant_ancestry<T, 32, PACKED>(a, B, stream);
    case 64: return launch_quant_ancestry<T, 64, PACKED>(a, B, stream);
    case 128: return launch_quant_ancestry<T, 128, PACKED>(a, B, stream);
    default: return cudaErrorInvalidValue;
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
  const int r0 = blockIdx.y * kMaxBeamsQ;  // this block's rows: [r0, r0 + K)
  const int K = min(kMaxBeamsQ, a.K - r0), S = a.S;
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
    float acc[kMaxBeamsQ];
#pragma unroll
    for (int k = 0; k < kMaxBeamsQ; ++k) acc[k] = 0.f;
#pragma unroll 1
    for (int c = 0; c < DH / 16; ++c) {
      const int4 chunk = krow[c];
      const int8_t* kb = reinterpret_cast<const int8_t*>(&chunk);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float kd = (float)kb[i];
        const float* qd = qs + c * 16 + i;
#pragma unroll
        for (int k = 0; k < kMaxBeamsQ; ++k)
          if (k < K) acc[k] = fmaf(qd[k * DH], kd, acc[k]);
      }
    }
    const float sks = sk[s], bs = bias[s];
#pragma unroll
    for (int k = 0; k < kMaxBeamsQ; ++k)
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
  constexpr int KPT = (kMaxBeamsQ + NKG - 1) / NKG;  // beams per thread
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
  const dim3 grid(B * a.H, (a.K + kMaxBeamsQ - 1) / kMaxBeamsQ);
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

// All shared memory of the D/F kernel for (K, T = TS/K, Dh), in bytes.
extern "C" long long mm_ancestry_decode_q_smem_bytes(int K, int T, int DH) {
  return (long long)mm::quant_dyn_bytes(K, T) + 4LL * (6 * mm::kMaxBeamsQ + mm::kMaxBeamsQ * DH);
}

extern "C" int mm_ancestry_decode_attention_q(
    int dtype, int packed, const void* q, const void* k_new, const void* v_new,
    const void* kv, const void* sk, const void* sv, const void* flat_rep, void* out,
    int B, int H, int K, int DH, int TS, int layer,
    int64_t kv_sb, int64_t kv_sl, int64_t kv_sh, int64_t kv_sj,
    int64_t sk_sb, int64_t sk_sl, int64_t sk_sh,
    int64_t sv_sb, int64_t sv_sl, int64_t sv_sh, void* stream) {
  if (K < 1 || K > mm::kMaxBeamsQ || TS % K != 0 || (packed && TS % 2 != 0))
    return (int)cudaErrorInvalidValue;
  const mm::QuantAncestryArgs a{
      q, k_new, v_new, static_cast<const int8_t*>(kv), static_cast<const float*>(sk),
      static_cast<const float*>(sv), static_cast<const int*>(flat_rep), out,
      H, K, TS, layer, kv_sb, kv_sl, kv_sh, kv_sj, sk_sb, sk_sl, sk_sh, sv_sb, sv_sl, sv_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mm::kFloat32)
    return (int)(packed ? mm::dispatch_quant_ancestry<float, true>(DH, a, B, st)
                        : mm::dispatch_quant_ancestry<float, false>(DH, a, B, st));
  if (dtype == mm::kBFloat16)
    return (int)(packed ? mm::dispatch_quant_ancestry<__nv_bfloat16, true>(DH, a, B, st)
                        : mm::dispatch_quant_ancestry<__nv_bfloat16, false>(DH, a, B, st));
  return (int)cudaErrorInvalidValue;
}

extern "C" int mm_cross_decode_attention_i8(
    int dtype, const void* q, const void* kv, const void* sk, const void* sv,
    const void* bias, void* out, int B, int H, int K, int DH, int S, void* stream) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  // The same layout as kernel C's: a block's <= 16 rows of Dh query floats,
  // then their S scores each.
  const size_t k = K < mm::kMaxBeamsQ ? K : mm::kMaxBeamsQ;
  const size_t smem = 4 * (k * DH + k * S + k);
  const mm::CrossQArgs a{q, static_cast<const int8_t*>(kv), static_cast<const float*>(sk),
                         static_cast<const float*>(sv), static_cast<const float*>(bias),
                         out, H, K, S};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mm::kFloat32) return (int)mm::dispatch_cross_q<float>(DH, a, B, smem, st);
  if (dtype == mm::kBFloat16) return (int)mm::dispatch_cross_q<__nv_bfloat16>(DH, a, B, smem, st);
  return (int)cudaErrorInvalidValue;
}
