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
//
// Design of B: grid (B, H); warps stride over 32-column chunks of the
// T.S axis. Each lane reads the flat_rep entries of one column for all
// K beams (coalesced across lanes), so a ballot names the columns that
// lie on some beam's path; only those K||V rows are read, once for all
// the beams on them, with each lane holding Dh/32 dims. Each warp keeps
// per-beam running (max, sum, acc[Dh]) in registers; the warps merge in
// shared memory together with the self term. The kernel takes the whole
// stacked cache plus the layer index and strides, so the layer's slab is
// never copied (the reference's BlockSpec index map has the same
// contract), and it streams, so any T.S runs. At step 0 no column is on a
// path and the output is exactly v_new.
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
#include "common.cuh"

namespace mm {
namespace {

constexpr int kMaxBeams = 16;

// ---------------------------------------------------------------- kernel B

struct AncestryArgs {
  const void* q;       // (B, H, K, Dh) contiguous, pre-scaled
  const void* k_new;   // (B, H, K, Dh) contiguous
  const void* v_new;   // (B, H, K, Dh) contiguous
  const void* kv;      // (B, L, H, TS, 2.Dh) through strides, last dim dense
  const int* flat_rep; // (B, K, TS) contiguous
  void* out;           // (B, H, K, Dh) contiguous
  int H, K, TS, layer;
  int64_t kv_sb, kv_sl, kv_sh, kv_sj;
};

template <typename T, int DH, int NW>
__global__ void __launch_bounds__(NW * 32) ancestry_decode_kernel(const AncestryArgs a) {
  constexpr int E = (DH + 31) / 32;  // dims per lane
  __shared__ float sm_m[NW][kMaxBeams];
  __shared__ float sm_l[NW][kMaxBeams];
  __shared__ float sm_acc[NW][kMaxBeams][DH];
  __shared__ float sm_self[kMaxBeams];

  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int K = a.K;
  const int64_t bh = (int64_t)b * a.H + h;
  const T* q = static_cast<const T*>(a.q) + bh * K * DH;
  const T* kn = static_cast<const T*>(a.k_new) + bh * K * DH;
  const T* vn = static_cast<const T*>(a.v_new) + bh * K * DH;

  float qr[kMaxBeams][E], acc[kMaxBeams][E], m[kMaxBeams], l[kMaxBeams];
#pragma unroll
  for (int k = 0; k < kMaxBeams; ++k) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane * E + e;
      qr[k][e] = (k < K && d < DH) ? to_f32(q[k * DH + d]) : 0.f;
      acc[k][e] = 0.f;
    }
    m[k] = -INFINITY;
    l[k] = 0.f;
  }

  // The self logit q_k . k_new_k of each beam (static k keeps qr in registers).
#pragma unroll
  for (int k = 0; k < kMaxBeams; ++k) {
    if (k >= K || k % NW != warp) continue;  // warp-uniform
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane * E + e;
      if (d < DH) s = fmaf(qr[k][e], to_f32(kn[k * DH + d]), s);
    }
    s = warp_sum(s);
    if (lane == 0) sm_self[k] = s;
  }

  const T* slab = static_cast<const T*>(a.kv) + b * a.kv_sb + (int64_t)a.layer * a.kv_sl + h * a.kv_sh;
  const int* fr = a.flat_rep + (int64_t)b * K * a.TS;
  for (int j0 = warp * 32; j0 < a.TS; j0 += NW * 32) {
    const int j = j0 + lane;
    unsigned beams = 0;  // bit k: column j is on beam k's path
    if (j < a.TS)
      for (int k = 0; k < K; ++k) beams |= (unsigned)(fr[(int64_t)k * a.TS + j] == j) << k;
    unsigned live = __ballot_sync(0xffffffffu, beams != 0);
    while (live) {
      const int c = __ffs(live) - 1;
      live &= live - 1;
      const unsigned on = __shfl_sync(0xffffffffu, beams, c);
      const T* row = slab + (int64_t)(j0 + c) * a.kv_sj;
      float kr[E], vr[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = lane * E + e;
        kr[e] = d < DH ? to_f32(row[d]) : 0.f;
        vr[e] = d < DH ? to_f32(row[DH + d]) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kMaxBeams; ++k) {
        if (!((on >> k) & 1u)) continue;  // warp-uniform
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s = fmaf(qr[k][e], kr[e], s);
        s = warp_sum(s);
        const float m_new = fmaxf(m[k], s);
        const float alpha = expf(m[k] - m_new);
        const float p = expf(s - m_new);
        l[k] = l[k] * alpha + p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[k][e] = fmaf(p, vr[e], acc[k][e] * alpha);
        m[k] = m_new;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kMaxBeams; ++k) {
    if (k >= K) break;
    if (lane == 0) {
      sm_m[warp][k] = m[k];
      sm_l[warp][k] = l[k];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane * E + e;
      if (d < DH) sm_acc[warp][k][d] = acc[k][e];
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(a.out) + bh * K * DH;
  for (int i = threadIdx.x; i < K * DH; i += NW * 32) {
    const int k = i / DH, d = i % DH;
    const float self = sm_self[k];
    float mx = self;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][k]);
    const float p_self = expf(self - mx);
    float den = p_self, num = p_self * to_f32(vn[k * DH + d]);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float sc = expf(sm_m[w][k] - mx);  // 0 for a warp that saw no column
      den = fmaf(sc, sm_l[w][k], den);
      num = fmaf(sc, sm_acc[w][k][d], num);
    }
    out[i] = from_f32<T>(num / den);
  }
}

template <typename T, int DH>
cudaError_t launch_ancestry(const AncestryArgs& a, int B, cudaStream_t stream) {
  constexpr int NW = DH <= 64 ? 8 : 4;  // keeps sm_acc <= 32 KB
  ancestry_decode_kernel<T, DH, NW><<<dim3(B, a.H), NW * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_ancestry(int DH, const AncestryArgs& a, int B, cudaStream_t stream) {
  switch (DH) {
    case 16: return launch_ancestry<T, 16>(a, B, stream);
    case 32: return launch_ancestry<T, 32>(a, B, stream);
    case 64: return launch_ancestry<T, 64>(a, B, stream);
    case 128: return launch_ancestry<T, 128>(a, B, stream);
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
extern "C" int mm_ancestry_decode_attention(
    int dtype, const void* q, const void* k_new, const void* v_new,
    const void* kv, const void* flat_rep, void* out,
    int B, int H, int K, int DH, int TS, int layer,
    int64_t kv_sb, int64_t kv_sl, int64_t kv_sh, int64_t kv_sj, void* stream) {
  if (K < 1 || K > mm::kMaxBeams) return (int)cudaErrorInvalidValue;
  const mm::AncestryArgs a{q, k_new, v_new, kv, static_cast<const int*>(flat_rep), out,
                           H, K, TS, layer, kv_sb, kv_sl, kv_sh, kv_sj};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mm::kFloat32) return (int)mm::dispatch_ancestry<float>(DH, a, B, st);
  if (dtype == mm::kBFloat16) return (int)mm::dispatch_ancestry<__nv_bfloat16>(DH, a, B, st);
  return (int)cudaErrorInvalidValue;
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
