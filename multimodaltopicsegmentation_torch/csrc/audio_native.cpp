// Native audio loader of multimodaltopicsegmentation_torch: a copy of the JAX
// package's runtime/audio_native.cpp (the same code, so the same bits).
//
// A small self-contained C++ library in place of a third-party audio stack:
//   - RIFF/WAVE parsing for PCM16 / PCM24 / PCM32 / float32, any channel
//     count (averaged to mono), streamed via stdio
//   - polyphase windowed-sinc resampling to an arbitrary target rate
// Exposed through a C ABI consumed from Python with ctypes
// (runtime/audio_native.py). No exceptions across the boundary: every entry
// point returns a status code or a null buffer.
//
// Built at first use by core/cuda_build.py with the host C++ compiler
// (HOST_FLAGS: -O3 -march=native -fPIC -fopenmp -std=c++17 -shared) into
// build/torch_kernels/.
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct WavData {
  std::vector<float> samples;  // mono
  int sample_rate = 0;
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) { return (uint16_t)p[0] | ((uint16_t)p[1] << 8); }

// returns 0 on success. Corrupt headers must produce an ERROR CODE, never a
// crash: a zero bits_per_sample would divide by zero, an absurd declared
// chunk size would throw bad_alloc across the C ABI (aborting the OpenMP
// batch loader), and a short fmt chunk would read past its buffer.
int parse_wav(const char* path, WavData* out) try {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  uint8_t hdr[12];
  if (std::fread(hdr, 1, 12, f) != 12 || std::memcmp(hdr, "RIFF", 4) != 0 ||
      std::memcmp(hdr + 8, "WAVE", 4) != 0) {
    std::fclose(f);
    return 2;
  }
  // declared chunk sizes are bounded by what is actually in the file
  std::fseek(f, 0, SEEK_END);
  const long file_size = std::ftell(f);
  std::fseek(f, 12, SEEK_SET);
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  bool have_fmt = false;
  while (true) {
    uint8_t chunk[8];
    if (std::fread(chunk, 1, 8, f) != 8) break;
    uint32_t size = rd_u32(chunk + 4);
    const long pos = std::ftell(f);
    if (pos < 0 || (long)size > file_size - pos) size = (uint32_t)(file_size - pos);
    if (std::memcmp(chunk, "fmt ", 4) == 0) {
      if (size < 16) {  // canonical fmt chunk is at least 16 bytes
        std::fclose(f);
        return 3;
      }
      std::vector<uint8_t> buf(size);
      if (std::fread(buf.data(), 1, size, f) != size) break;
      fmt = rd_u16(buf.data());
      channels = rd_u16(buf.data() + 2);
      rate = rd_u32(buf.data() + 4);
      bits = rd_u16(buf.data() + 14);
      if (fmt == 0xFFFE && size >= 40) fmt = rd_u16(buf.data() + 24);  // extensible
      have_fmt = true;
    } else if (std::memcmp(chunk, "data", 4) == 0) {
      if (!have_fmt || channels == 0 ||
          (bits != 8 && bits != 16 && bits != 24 && bits != 32)) {
        std::fclose(f);
        return 3;
      }
      std::vector<uint8_t> raw(size);
      size_t got = std::fread(raw.data(), 1, size, f);
      raw.resize(got);
      size_t bytes_per = bits / 8;
      size_t n_frames = got / (bytes_per * channels);
      out->samples.resize(n_frames);
      const uint8_t* p = raw.data();
      for (size_t i = 0; i < n_frames; ++i) {
        double acc = 0.0;
        for (int c = 0; c < channels; ++c) {
          const uint8_t* s = p + (i * channels + c) * bytes_per;
          double v = 0.0;
          if (fmt == 3 && bits == 32) {  // IEEE float
            float fv;
            std::memcpy(&fv, s, 4);
            v = fv;
          } else if (bits == 16) {
            int16_t iv = (int16_t)rd_u16(s);
            v = iv / 32768.0;
          } else if (bits == 24) {
            int32_t iv = (int32_t)((uint32_t)s[0] << 8 | (uint32_t)s[1] << 16 |
                                   (uint32_t)s[2] << 24) >> 8;
            v = iv / 8388608.0;
          } else if (bits == 32) {
            int32_t iv = (int32_t)rd_u32(s);
            v = iv / 2147483648.0;
          } else if (bits == 8) {
            v = ((double)s[0] - 128.0) / 128.0;
          }
          acc += v;
        }
        out->samples[i] = (float)(acc / channels);
      }
      out->sample_rate = (int)rate;
      std::fclose(f);
      return 0;
    } else {
      std::fseek(f, (long)size + (size & 1), SEEK_CUR);
    }
  }
  std::fclose(f);
  return 4;
} catch (...) {
  return 5;  // allocation or other internal failure: error code, not a throw
}

// polyphase windowed-sinc resampler (Kaiser-windowed, zeros-per-crossing 16)
std::vector<float> resample(const std::vector<float>& x, int sr_in, int sr_out) {
  if (sr_in == sr_out || x.empty()) return x;
  // reduce the ratio
  int a = sr_in, b = sr_out;
  while (b) { int t = a % b; a = b; b = t; }
  const int up = sr_out / a, down = sr_in / a;

  const int half_taps = 32 * std::max(up, down);
  // anti-aliasing low-pass at the up-rate: cut at min(in, out) Nyquist
  const double cutoff = 0.95 * 0.5 / std::max(up, down);
  // build the prototype low-pass at the upsampled rate
  const int taps = 2 * half_taps + 1;
  std::vector<double> h(taps);
  const double beta = 8.0;
  auto bessel_i0 = [](double v) {
    double s = 1.0, t = 1.0;
    for (int k = 1; k < 32; ++k) {
      t *= (v / (2.0 * k)) * (v / (2.0 * k));
      s += t;
    }
    return s;
  };
  const double i0b = bessel_i0(beta);
  for (int i = 0; i < taps; ++i) {
    double n = i - half_taps;
    double sinc = (n == 0) ? 2.0 * cutoff
                           : std::sin(2.0 * M_PI * cutoff * n) / (M_PI * n);
    double w = bessel_i0(beta * std::sqrt(std::max(
                   0.0, 1.0 - (n / half_taps) * (n / half_taps)))) / i0b;
    h[i] = sinc * w * up;
  }

  const int64_t n_out = (int64_t)x.size() * up / down;
  std::vector<float> y((size_t)n_out);
#pragma omp parallel for schedule(static)
  for (int64_t m = 0; m < n_out; ++m) {
    // output sample m corresponds to up-rate index m*down
    const int64_t t = m * down;
    double acc = 0.0;
    // up-rate tap index j contributes x[(t - j + half) / up] when divisible
    const int64_t lo = t - half_taps, hi = t + half_taps;
    int64_t j = lo;
    // align j to a multiple of up (input sample positions)
    int64_t rem = ((j % up) + up) % up;
    if (rem) j += up - rem;
    for (; j <= hi; j += up) {
      const int64_t n_in = j / up;
      if (n_in < 0 || n_in >= (int64_t)x.size()) continue;
      acc += (double)x[(size_t)n_in] * h[(size_t)(t - j + half_taps)];
    }
    y[(size_t)m] = (float)acc;
  }
  return y;
}

}  // namespace

extern "C" {

// Reads a wav file; on success fills *n_samples/*sample_rate and returns a
// malloc'd float buffer the caller frees with mts_free. Returns null on error.
float* mts_read_wav(const char* path, int64_t* n_samples, int* sample_rate,
                    int target_sr) try {
  WavData wav;
  if (parse_wav(path, &wav) != 0) return nullptr;
  std::vector<float> samples = std::move(wav.samples);
  int sr = wav.sample_rate;
  if (target_sr > 0 && sr > 0 && sr != target_sr) {
    samples = resample(samples, sr, target_sr);
    sr = target_sr;
  }
  float* out = (float*)std::malloc(samples.size() * sizeof(float));
  if (!out) return nullptr;
  std::memcpy(out, samples.data(), samples.size() * sizeof(float));
  *n_samples = (int64_t)samples.size();
  *sample_rate = sr;
  return out;
} catch (...) {
  return nullptr;
}

float* mts_resample(const float* x, int64_t n, int sr_in, int sr_out,
                    int64_t* n_out) try {
  std::vector<float> in(x, x + n);
  std::vector<float> y = resample(in, sr_in, sr_out);
  float* out = (float*)std::malloc(y.size() * sizeof(float));
  if (!out) return nullptr;
  std::memcpy(out, y.data(), y.size() * sizeof(float));
  *n_out = (int64_t)y.size();
  return out;
} catch (...) {
  return nullptr;
}

void mts_free(float* p) { std::free(p); }

// Parallel batch loader: decodes + resamples n files concurrently (OpenMP).
// outputs[i] receives a malloc'd buffer (or null on error), n_samples[i] its
// length. The host pipeline uses this to prefetch the next documents while
// the card encodes the current one.
void mts_read_wav_batch(const char** paths, int n, int target_sr,
                        float** outputs, int64_t* n_samples,
                        int* sample_rates) {
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n; ++i) {
    outputs[i] = mts_read_wav(paths[i], &n_samples[i], &sample_rates[i],
                              target_sr);
    if (!outputs[i]) n_samples[i] = 0;
  }
}
}
