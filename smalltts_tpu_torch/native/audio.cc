// Native audio I/O: WAV decode, mono mix, windowed-sinc resample, WAV encode.
//
// C++ equivalent of the reference server's native audio path
// (reference: src/server/src/audio.rs:13-97 — symphonia decode -> mono mix ->
// rubato SincFixedIn(sinc_len 256, cutoff 0.95) -> hound 16-bit PCM writer).
// Exposed as a small C ABI consumed via ctypes (smalltts_tpu_torch/native/__init__.py),
// with a numpy fallback when the shared library is absent.
//
// Build: make -C smalltts_tpu_torch/native   (g++ -O3 -shared -fPIC)

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr double kKaiserBeta = 14.769656459379492;
constexpr double kRolloff = 0.94;
constexpr int kWidth = 64;  // zero crossings each side at the lower rate

double bessel_i0(double x) {
  // power series; converges fast for |x| < ~30
  double sum = 1.0, term = 1.0;
  for (int k = 1; k < 64; ++k) {
    term *= (x / (2.0 * k)) * (x / (2.0 * k));
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

double kaiser(double r, double beta) {  // r in [-1, 1]
  if (r < -1.0 || r > 1.0) return 0.0;
  return bessel_i0(beta * std::sqrt(1.0 - r * r)) / bessel_i0(beta);
}

double sinc(double x) {
  if (std::fabs(x) < 1e-12) return 1.0;
  const double px = M_PI * x;
  return std::sin(px) / px;
}

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) { return (uint16_t)p[0] | ((uint16_t)p[1] << 8); }

}  // namespace

extern "C" {

void stt_free(void* p) { std::free(p); }

// WAV bytes -> interleaved float32 [-1,1]. Returns 0 on success.
int stt_decode_wav(const uint8_t* data, long len, float** out, int* channels,
                   long* frames, int* sample_rate) {
  if (len < 12 || std::memcmp(data, "RIFF", 4) || std::memcmp(data + 8, "WAVE", 4))
    return -1;
  long pos = 12;
  int fmt = 0, ch = 0, bits = 0, sr = 0;
  const uint8_t* raw = nullptr;
  long raw_len = 0;
  while (pos + 8 <= len) {
    const uint8_t* hdr = data + pos;
    uint32_t csz = rd_u32(hdr + 4);
    const uint8_t* body = hdr + 8;
    if (pos + 8 + (long)csz > len) return -2;
    if (!std::memcmp(hdr, "fmt ", 4)) {
      if (csz < 16) return -3;
      fmt = rd_u16(body);
      ch = rd_u16(body + 2);
      sr = (int)rd_u32(body + 4);
      bits = rd_u16(body + 14);
      if (fmt == 0xFFFE && csz >= 40) fmt = rd_u16(body + 24);
    } else if (!std::memcmp(hdr, "data", 4)) {
      raw = body;
      raw_len = csz;
      break;
    }
    pos += 8 + csz + (csz & 1);
  }
  if (!raw || ch <= 0 || sr <= 0) return -4;

  long n = 0;
  float* buf = nullptr;
  if (fmt == 1 && bits == 16) {
    n = raw_len / 2;
    buf = (float*)std::malloc(n * sizeof(float));
    if (!buf) return -6;
    for (long i = 0; i < n; ++i) {
      int16_t v = (int16_t)rd_u16(raw + 2 * i);
      buf[i] = (float)v / 32768.0f;
    }
  } else if (fmt == 1 && bits == 24) {
    n = raw_len / 3;
    buf = (float*)std::malloc(n * sizeof(float));
    if (!buf) return -6;
    for (long i = 0; i < n; ++i) {
      int32_t v = raw[3 * i] | (raw[3 * i + 1] << 8) | (raw[3 * i + 2] << 16);
      if (v & 0x800000) v -= 0x1000000;
      buf[i] = (float)v / 8388608.0f;
    }
  } else if (fmt == 1 && bits == 32) {
    n = raw_len / 4;
    buf = (float*)std::malloc(n * sizeof(float));
    if (!buf) return -6;
    for (long i = 0; i < n; ++i) {
      int32_t v = (int32_t)rd_u32(raw + 4 * i);
      buf[i] = (float)((double)v / 2147483648.0);
    }
  } else if (fmt == 3 && bits == 32) {
    n = raw_len / 4;
    buf = (float*)std::malloc(n * sizeof(float));
    if (!buf) return -6;
    std::memcpy(buf, raw, n * sizeof(float));
  } else {
    return -5;
  }
  *out = buf;
  *channels = ch;
  *frames = n / ch;
  *sample_rate = sr;
  return 0;
}

// interleaved (frames, channels) -> mono mean mix
void stt_to_mono(const float* in, long frames, int channels, float* out) {
  for (long i = 0; i < frames; ++i) {
    double acc = 0.0;
    for (int c = 0; c < channels; ++c) acc += in[i * channels + c];
    out[i] = (float)(acc / channels);
  }
}

// windowed-sinc resample, mono float32
int stt_resample(const float* in, long n_in, int sr_in, int sr_out, float** out,
                 long* n_out) {
  // defense in depth behind the Python wrapper's bounds: nonpositive rates
  // (a u32 header rate cast negative) or a failed allocation must return an
  // error, not write through NULL (the serving path feeds attacker bytes)
  if (sr_in <= 0 || sr_out <= 0 || n_in < 0) return 1;
  if (sr_in == sr_out) {
    float* buf = (float*)std::malloc(n_in * sizeof(float));
    if (!buf) return 2;
    std::memcpy(buf, in, n_in * sizeof(float));
    *out = buf;
    *n_out = n_in;
    return 0;
  }
  const double ratio = (double)sr_out / sr_in;
  const long n = (long)std::llround((double)n_in * ratio);
  if (n < 0) return 1;
  float* buf = (float*)std::malloc(n * sizeof(float));
  if (!buf) return 2;
  // kernel in input-sample units: cutoff fc (<= 1), support width/fc
  const double fc = kRolloff * std::min(1.0, ratio);
  const double support = kWidth / fc;
  for (long m = 0; m < n; ++m) {
    const double center = (double)m / ratio;
    const long lo = (long)std::ceil(center - support);
    const long hi = (long)std::floor(center + support);
    double acc = 0.0;
    for (long k = std::max(lo, 0L); k <= std::min(hi, n_in - 1); ++k) {
      const double t = (double)k - center;
      acc += (double)in[k] * fc * sinc(fc * t) * kaiser(t / support, kKaiserBeta);
    }
    buf[m] = (float)acc;
  }
  *out = buf;
  *n_out = n;
  return 0;
}

// mono float32 -> 16-bit PCM WAV with clamp
int stt_encode_wav16(const float* in, long n, int sample_rate, uint8_t** out,
                     long* out_len) {
  if (n < 0 || sample_rate <= 0) return 1;
  const long data_len = n * 2;
  const long total = 44 + data_len;
  uint8_t* buf = (uint8_t*)std::malloc(total);
  if (!buf) return 2;
  auto wr_u32 = [&](long off, uint32_t v) {
    buf[off] = v & 0xff; buf[off + 1] = (v >> 8) & 0xff;
    buf[off + 2] = (v >> 16) & 0xff; buf[off + 3] = (v >> 24) & 0xff;
  };
  auto wr_u16 = [&](long off, uint16_t v) {
    buf[off] = v & 0xff; buf[off + 1] = (v >> 8) & 0xff;
  };
  std::memcpy(buf, "RIFF", 4);
  wr_u32(4, (uint32_t)(36 + data_len));
  std::memcpy(buf + 8, "WAVEfmt ", 8);
  wr_u32(16, 16);
  wr_u16(20, 1);
  wr_u16(22, 1);
  wr_u32(24, (uint32_t)sample_rate);
  wr_u32(28, (uint32_t)(sample_rate * 2));
  wr_u16(32, 2);
  wr_u16(34, 16);
  std::memcpy(buf + 36, "data", 4);
  wr_u32(40, (uint32_t)data_len);
  for (long i = 0; i < n; ++i) {
    float v = in[i];
    if (v > 1.0f) v = 1.0f;
    if (v < -1.0f) v = -1.0f;
    int16_t s = (int16_t)std::lrintf(v * 32767.0f);
    buf[44 + 2 * i] = (uint8_t)(s & 0xff);
    buf[44 + 2 * i + 1] = (uint8_t)((s >> 8) & 0xff);
  }
  *out = buf;
  *out_len = total;
  return 0;
}

}  // extern "C"
