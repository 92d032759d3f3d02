// Native audio loader: RIFF/WAVE decode and threaded batch fill.
//
// A copy of mm_s2ut/native/audioio.cpp for the PyTorch port. One shared
// library decodes RIFF/WAVE files (PCM 8/16/24/32 and IEEE float32,
// WAVE_FORMAT_EXTENSIBLE, mono mixdown) and fills a padded batch buffer
// from a std::thread pool. Python calls it through ctypes
// (mm_s2ut_torch/native.py), which releases the GIL for the call; the
// threads write straight into the numpy batch, with no pickling or IPC.
//
// Built at first use by mm_s2ut_torch/native.py with the host compiler:
//   g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread audioio.cpp -o libmmaudio.so

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct WavResult {
  int n_samples = 0;   // samples written (post mixdown, pre-truncation)
  int sample_rate = 0;
  int error = 0;       // 0 ok; <0 error codes
};

constexpr int kErrOpen = -1;
constexpr int kErrFormat = -2;
constexpr int kErrUnsupported = -3;

inline uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
inline uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

// Decode one WAV file into out[0..max_samples), mono float32 in [-1, 1].
WavResult decode_wav(const char* path, float* out, int64_t max_samples) {
  WavResult res;
  FILE* f = fopen(path, "rb");
  if (!f) {
    res.error = kErrOpen;
    return res;
  }
  uint8_t header[12];
  if (fread(header, 1, 12, f) != 12 || memcmp(header, "RIFF", 4) ||
      memcmp(header + 8, "WAVE", 4)) {
    fclose(f);
    res.error = kErrFormat;
    return res;
  }
  uint16_t fmt_code = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  bool have_fmt = false;
  while (true) {
    uint8_t chunk[8];
    if (fread(chunk, 1, 8, f) != 8) break;
    uint32_t size = rd_u32(chunk + 4);
    if (!memcmp(chunk, "fmt ", 4)) {
      uint8_t fmt[16];
      if (size < 16 || fread(fmt, 1, 16, f) != 16) {
        fclose(f);
        res.error = kErrFormat;
        return res;
      }
      fmt_code = rd_u16(fmt);
      channels = rd_u16(fmt + 2);
      sample_rate = rd_u32(fmt + 4);
      bits = rd_u16(fmt + 14);
      have_fmt = true;
      uint32_t fmt_read = 16;
      if (fmt_code == 0xFFFE && size >= 40) {
        // WAVE_FORMAT_EXTENSIBLE: the real code is the first two bytes
        // of the SubFormat GUID (fmt offset 24). Without this, extensible
        // float32 files would be decoded as int32 PCM garbage.
        uint8_t ext[10];
        if (fread(ext, 1, 10, f) != 10) {
          fclose(f);
          res.error = kErrFormat;
          return res;
        }
        fmt_read += 10;
        fmt_code = rd_u16(ext + 8);
      }
      if (size > fmt_read) fseek(f, size - fmt_read + (size & 1), SEEK_CUR);
      else if (size & 1) fseek(f, 1, SEEK_CUR);
    } else if (!memcmp(chunk, "data", 4)) {
      if (!have_fmt || channels == 0) {
        fclose(f);
        res.error = kErrFormat;
        return res;
      }
      if (bits != 8 && bits != 16 && bits != 24 && bits != 32) {
        // Also guards the divide below: bits < 8 would make bytes_per 0.
        fclose(f);
        res.error = kErrUnsupported;
        return res;
      }
      const int bytes_per = bits / 8;
      // Trust the FILE, not the header: clamp the declared chunk size to
      // the bytes actually present (a lying/corrupt size field would
      // otherwise throw bad_alloc — std::terminate inside the pool
      // threads — or silently decode a zero tail as audio).
      long data_pos = ftell(f);
      fseek(f, 0, SEEK_END);
      long file_end = ftell(f);
      fseek(f, data_pos, SEEK_SET);
      uint64_t avail = file_end > data_pos ? (uint64_t)(file_end - data_pos) : 0;
      uint64_t want = size < avail ? size : avail;
      // Only read what we will decode (bounded by max_samples frames).
      const uint64_t frame_bytes = (uint64_t)bytes_per * channels;
      uint64_t cap = (uint64_t)max_samples * frame_bytes;
      if (want > cap) want = cap;
      std::vector<uint8_t> raw((size_t)want);
      size_t got = fread(raw.data(), 1, (size_t)want, f);
      const int64_t n_frames = (int64_t)(got / frame_bytes);
      const int64_t n_keep = n_frames < max_samples ? n_frames : max_samples;
      const uint8_t* p = raw.data();
      const float inv_ch = 1.0f / channels;
      if (fmt_code == 1 && bits == 16 && channels == 1) {
        // Hot path (16 kHz mono PCM16 — the corpus format): a tight
        // int16→float scale loop g++ auto-vectorizes; the generic loop
        // below carries a per-sample format switch that defeats SIMD.
        // WAV is little-endian; memcpy keeps it alignment/aliasing-safe
        // and compiles to a plain vector load on LE hosts.
        for (int64_t i = 0; i < n_keep; ++i) {
          int16_t tmp;
          memcpy(&tmp, p + 2 * i, 2);
          out[i] = tmp * (1.0f / 32768.f);
        }
        res.n_samples = (int)n_keep;
        res.sample_rate = (int)sample_rate;
        fclose(f);
        return res;
      }
      for (int64_t i = 0; i < n_keep; ++i) {
        float acc = 0.f;
        for (int c = 0; c < channels; ++c) {
          const uint8_t* s = p + (i * channels + c) * bytes_per;
          float v = 0.f;
          if (fmt_code == 3) {  // IEEE float
            if (bits == 32) {
              float tmp;
              memcpy(&tmp, s, 4);
              v = tmp;
            } else {
              res.error = kErrUnsupported;
            }
          } else {  // PCM
            switch (bits) {
              case 16: {
                int16_t tmp = (int16_t)rd_u16(s);
                v = tmp / 32768.f;
                break;
              }
              case 32: {
                int32_t tmp = (int32_t)rd_u32(s);
                v = tmp / 2147483648.f;
                break;
              }
              case 24: {
                int32_t tmp = s[0] | (s[1] << 8) | (s[2] << 16);
                if (tmp & 0x800000) tmp -= 0x1000000;
                v = tmp / 8388608.f;
                break;
              }
              case 8: {
                v = ((int)s[0] - 128) / 128.f;
                break;
              }
              default:
                res.error = kErrUnsupported;
            }
          }
          acc += v;
        }
        out[i] = acc * inv_ch;
      }
      res.n_samples = (int)n_keep;
      res.sample_rate = (int)sample_rate;
      fclose(f);
      return res;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  fclose(f);
  res.error = kErrFormat;
  return res;
}

}  // namespace

extern "C" {

// Decode a single wav. Returns samples written, or <0 on error.
// sample_rate_out receives the file's rate.
int mm_decode_wav(const char* path, float* out, int64_t max_samples,
                  int* sample_rate_out) {
  WavResult r = decode_wav(path, out, max_samples);
  if (r.error) return r.error;
  *sample_rate_out = r.sample_rate;
  return r.n_samples;
}

// Decode a batch of wavs into a padded (n, max_samples) row-major buffer
// using a thread pool. lengths_out[i] = valid samples (or <0 error code);
// rates_out[i] = sample rate. Rows are pre-zeroed here.
void mm_load_batch(const char** paths, int n, float* out,
                   int64_t max_samples, int* lengths_out, int* rates_out,
                   int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      float* row = out + (int64_t)i * max_samples;
      WavResult r = decode_wav(paths[i], row, max_samples);
      lengths_out[i] = r.error ? r.error : r.n_samples;
      rates_out[i] = r.sample_rate;
      // Zero only the pad tail (a full-buffer memset upfront doubles
      // the memory traffic of a typical mostly-full batch).
      int64_t valid = r.error ? 0 : r.n_samples;
      if (valid < max_samples)
        memset(row + valid, 0, sizeof(float) * (size_t)(max_samples - valid));
    }
  };
  std::vector<std::thread> pool;
  const int workers = n_threads < n ? n_threads : n;
  pool.reserve(workers);
  for (int t = 0; t < workers; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
