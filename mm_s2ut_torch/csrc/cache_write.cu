// The decode step's cache write as a kernel: the port of the TPU probes
// scripts_dev/cache_write_fix_probe.py:77 (a Pallas write kernel aliased
// onto the bf16 cache at a scalar-prefetched step index) and
// scripts_dev/write_kernel_probe.py:81 (the same for the int8 cache, its
// scales by dynamic_update_slice). Neither is on a path of the JAX package,
// which writes with XLA's dynamic_update_slice; the port's decoder keeps
// the plain write too (ops/decode_attention.py write_step), and this
// kernel is timed against it by tools/kernel_ab.py.
//
// One launch writes a step's S rows of every layer, in place, at row
// ``row`` of the stacked cache (B, L, H, rows, 2.Dh): mode 0 copies each
// row's K half from k_src and its V half from v_src (bf16 or fp32 rows,
// through their strides); mode 1 does so for int8 rows and also writes
// their sk and sv at logical column ``scale_pos``; mode 2 merges int4
// nibbles into the packed rows (the low nibble of each byte when ``high``
// is 0, the high one otherwise; the other nibble kept: a read-merge-write
// of the word), with the scales as mode 1. Each thread moves 16 bytes.
// What bounds it: bytes (each source byte read once, each destination byte
// written once, read too in mode 2); the grid covers B.L.H.S rows x 2.Dh
// bytes in one wave of whole rows.
#include "common.cuh"

namespace mm {
namespace {

struct CacheWriteArgs {
  unsigned char* kv;            // (B, L, H, rows, 2.half) bytes, through byte strides
  int64_t kv_sb, kv_sl, kv_sh, kv_sj;
  const unsigned char* k_src;   // (B, L, H, S, half) bytes, through byte strides
  const unsigned char* v_src;   // the same strides
  int64_t s_sb, s_sl, s_sh, s_ss;
  float* sk_dst;                // (B, L, H, TS) through strides, last dim dense
  float* sv_dst;
  int64_t d_sb, d_sl, d_sh;
  const float* sk_src;          // (B, L, H, S) contiguous
  const float* sv_src;
  int B, L, H, S, half, row, high, scale_pos, mode;
};

__global__ void __launch_bounds__(256) cache_write_kernel(const CacheWriteArgs a) {
  const int CH = a.half / 16;  // 16-byte chunks of a half row
  const int64_t rows = (int64_t)a.B * a.L * a.H * a.S;
  const int64_t n = rows * 2 * CH;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % (2 * CH));
    int64_t r = i / (2 * CH);
    const int s = (int)(r % a.S);
    r /= a.S;
    const int h = (int)(r % a.H);
    r /= a.H;
    const int l = (int)(r % a.L), b = (int)(r / a.L);
    const unsigned char* src = (c < CH ? a.k_src : a.v_src) + b * a.s_sb + l * a.s_sl + h * a.s_sh +
                               s * a.s_ss + (c % CH) * 16;
    unsigned char* dst = a.kv + b * a.kv_sb + l * a.kv_sl + h * a.kv_sh +
                         (int64_t)(a.row + s) * a.kv_sj + c * 16;
    uint4 v = *reinterpret_cast<const uint4*>(src);
    if (a.mode == 2) {  // int4: the rows' values (in [-7, 7]) as nibbles, merged into the bytes
      const uint4 old = *reinterpret_cast<const uint4*>(dst);
      const uint32_t keep = a.high ? 0x0F0F0F0Fu : 0xF0F0F0F0u;
      const int sh = a.high ? 4 : 0;
      v.x = (old.x & keep) | ((v.x & 0x0F0F0F0Fu) << sh);
      v.y = (old.y & keep) | ((v.y & 0x0F0F0F0Fu) << sh);
      v.z = (old.z & keep) | ((v.z & 0x0F0F0F0Fu) << sh);
      v.w = (old.w & keep) | ((v.w & 0x0F0F0F0Fu) << sh);
    }
    *reinterpret_cast<uint4*>(dst) = v;
  }
  if (a.mode == 0) return;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < rows;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int s = (int)(i % a.S);
    int64_t r = i / a.S;
    const int h = (int)(r % a.H);
    r /= a.H;
    const int l = (int)(r % a.L), b = (int)(r / a.L);
    const int64_t d = b * a.d_sb + l * a.d_sl + h * a.d_sh + a.scale_pos + s;
    a.sk_dst[d] = a.sk_src[i];
    a.sv_dst[d] = a.sv_src[i];
  }
}

}  // namespace
}  // namespace mm

// The cache write on ``stream`` (see the file's head). Byte strides for kv
// and the rows, element strides for the scales; every row address and
// ``half`` must be multiples of 16 bytes.
extern "C" int mm_cache_write(int mode, void* kv, const void* k_src, const void* v_src,
                              void* sk_dst, void* sv_dst, const void* sk_src, const void* sv_src,
                              int B, int L, int H, int S, int half, int row, int high,
                              int scale_pos, int64_t kv_sb, int64_t kv_sl, int64_t kv_sh,
                              int64_t kv_sj, int64_t s_sb, int64_t s_sl, int64_t s_sh,
                              int64_t s_ss, int64_t d_sb, int64_t d_sl, int64_t d_sh,
                              void* stream) {
  if (mode < 0 || mode > 2 || B < 1 || L < 1 || H < 1 || S < 1 || half < 16 || half % 16 ||
      row < 0)
    return (int)cudaErrorInvalidValue;
  const mm::CacheWriteArgs a{static_cast<unsigned char*>(kv), kv_sb, kv_sl, kv_sh, kv_sj,
                             static_cast<const unsigned char*>(k_src),
                             static_cast<const unsigned char*>(v_src), s_sb, s_sl, s_sh, s_ss,
                             static_cast<float*>(sk_dst), static_cast<float*>(sv_dst),
                             d_sb, d_sl, d_sh, static_cast<const float*>(sk_src),
                             static_cast<const float*>(sv_src), B, L, H, S, half, row, high,
                             scale_pos, mode};
  const int64_t n = (int64_t)B * L * H * S * 2 * (half / 16);
  const int64_t blocks = (n + 255) / 256;
  mm::cache_write_kernel<<<(int)(blocks < 4 * 132 * 8 ? blocks : 4 * 132 * 8), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
