// Native WAV decode + channel downmix + polyphase resample front end.
//
// C++ re-implementation of the host audio hot path:
//   cm3p_torch/audio/loading.py::_load_wav_bytes (RIFF/WAVE decode)
//   cm3p_torch/audio/loading.py::to_mono         (channel-mean downmix)
//   cm3p_torch/audio/loading.py::resample        (scipy.signal.resample_poly)
//
// The Python implementation stays the source of truth:
// tests/test_torch_native.py asserts BIT-IDENTICAL float32 output against it
// on every format x channel-count x rate-pair fixture, and load_audio_file
// falls back to the Python path on any buffer this file declines.
//
// Bit-parity contract (compiled with -ffp-contract=off):
//  * decode scaling replicates numpy's one-pass `np.multiply(ints, scale,
//    dtype=float32)` per element; the channel mean replicates
//    `reshape(-1, C).mean(axis=1)` (sequential float32 adds, then one
//    float32 divide by C).
//  * the resampler replicates scipy.signal.resample_poly with an explicit
//    window: h (already `*= up`-scaled by the caller, float32), zero-pre-pad
//    `down - half_len % down`, upfirdn accumulation in float32 over
//    ASCENDING input index (scipy's `_upfirdn_apply` order), output slice
//    [n_pre_remove, n_pre_remove + n_out), then trim/zero-pad to the
//    caller's `expected_out` (loading.py's true-rate length fix).
//
// Build: cm3p_torch/native/__init__.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_WIN32)
#define CT_EXPORT extern "C" __declspec(dllexport)
#else
#define CT_EXPORT extern "C" __attribute__((visibility("default")))
#endif

namespace {

struct WavInfo {
  int32_t audio_format = 0;  // 1 = PCM, 3 = IEEE float (after EXTENSIBLE unwrap)
  int32_t channels = 1;
  int32_t rate = 0;
  int32_t sampwidth = 0;  // bytes per sample
  const uint8_t* data = nullptr;
  int64_t data_len = 0;  // bytes, already truncated to whole frames
};

// Mirrors loading.py::_load_wav_bytes's chunk walk exactly (word-aligned chunks,
// fmt-before-data early exit, trailing-partial-frame truncation).
static bool parse_wav(const uint8_t* buf, int64_t n, WavInfo* w) {
  if (n < 12 || std::memcmp(buf, "RIFF", 4) != 0 || std::memcmp(buf + 8, "WAVE", 4) != 0)
    return false;
  const uint8_t* fmt = nullptr;
  int64_t fmt_len = 0;
  const uint8_t* data = nullptr;
  int64_t data_len = 0;
  int64_t pos = 12;
  auto rd_u32 = [&](int64_t p) -> uint32_t {
    uint32_t v;
    std::memcpy(&v, buf + p, 4);
    return v;  // little-endian host assumed (x86/ARM)
  };
  while (pos + 8 <= n) {
    int64_t csize = (int64_t)rd_u32(pos + 4);
    if (std::memcmp(buf + pos, "fmt ", 4) == 0) {
      fmt = buf + pos + 8;
      fmt_len = std::min<int64_t>(csize, n - (pos + 8));
    } else if (std::memcmp(buf + pos, "data", 4) == 0) {
      data = buf + pos + 8;
      data_len = std::min<int64_t>(csize, n - (pos + 8));
      if (fmt) break;
    }
    pos += 8 + csize + (csize & 1);
  }
  if (!fmt || fmt_len < 16 || !data) return false;
  auto rd_u16 = [&](const uint8_t* p) -> uint32_t { return (uint32_t)p[0] | ((uint32_t)p[1] << 8); };
  w->audio_format = (int32_t)rd_u16(fmt);
  w->channels = std::max(1, (int32_t)rd_u16(fmt + 2));
  uint32_t rate;
  std::memcpy(&rate, fmt + 4, 4);
  w->rate = (int32_t)rate;
  w->sampwidth = (int32_t)(rd_u16(fmt + 14) / 8);
  if (w->audio_format == 0xFFFE && fmt_len >= 26)  // WAVE_FORMAT_EXTENSIBLE
    w->audio_format = (int32_t)rd_u16(fmt + 24);
  int64_t block = (int64_t)w->sampwidth * w->channels;
  if (block > 0 && data_len % block) data_len -= data_len % block;
  w->data = data;
  w->data_len = data_len;
  return true;
}

// Decode one frame's channel `c` at frame index `i` to the scaled float32
// sample, replicating loading.py's per-format numpy arithmetic.
template <typename Decode>
static void downmix(int64_t frames, int channels, float* out, Decode dec) {
  if (channels == 1) {
    for (int64_t i = 0; i < frames; ++i) out[i] = dec(i);
  } else if (channels == 2) {
    for (int64_t i = 0; i < frames; ++i) {
      float a = dec(2 * i), b = dec(2 * i + 1);
      out[i] = (a + b) / 2.0f;  // np.mean over a 2-wide axis: sum, then /2
    }
  } else {
    const float inv = (float)channels;
    for (int64_t i = 0; i < frames; ++i) {
      float acc = 0.0f;
      for (int c = 0; c < channels; ++c) acc += dec(i * channels + c);
      out[i] = acc / inv;
    }
  }
}

// mono float32 decode of the data chunk; returns frame count or -1.
static int64_t decode_mono(const WavInfo& w, std::vector<float>* mono) {
  const int64_t samples = w.sampwidth ? w.data_len / w.sampwidth : 0;
  const int64_t frames = w.channels ? samples / w.channels : 0;
  mono->resize((size_t)frames);
  float* out = mono->data();
  const uint8_t* d = w.data;
  if (w.audio_format == 3) {  // IEEE float
    if (w.sampwidth == 4) {
      downmix(frames, w.channels, out, [&](int64_t s) {
        float v;
        std::memcpy(&v, d + 4 * s, 4);
        return v;
      });
    } else if (w.sampwidth == 8) {
      downmix(frames, w.channels, out, [&](int64_t s) {
        double v;
        std::memcpy(&v, d + 8 * s, 8);
        return (float)v;
      });
    } else {
      return -1;
    }
  } else if (w.audio_format == 1) {  // integer PCM
    if (w.sampwidth == 2) {
      const float k = 1.0f / 32768.0f;
      downmix(frames, w.channels, out, [&](int64_t s) {
        int16_t v;
        std::memcpy(&v, d + 2 * s, 2);
        return (float)v * k;
      });
    } else if (w.sampwidth == 4) {
      const float k = 1.0f / 2147483648.0f;
      downmix(frames, w.channels, out, [&](int64_t s) {
        int32_t v;
        std::memcpy(&v, d + 4 * s, 4);
        return (float)v * k;
      });
    } else if (w.sampwidth == 1) {  // 8-bit is unsigned; scale then -1
      const float k = 1.0f / 128.0f;
      downmix(frames, w.channels, out, [&](int64_t s) { return (float)d[s] * k - 1.0f; });
    } else if (w.sampwidth == 3) {  // 24-bit: widen via the top bytes of i32
      const float k = 1.0f / 2147483648.0f;
      downmix(frames, w.channels, out, [&](int64_t s) {
        const uint8_t* b = d + 3 * s;
        int32_t v = (int32_t)(((uint32_t)b[0] << 8) | ((uint32_t)b[1] << 16) | ((uint32_t)b[2] << 24));
        return (float)v * k;
      });
    } else {
      return -1;
    }
  } else {
    return -1;
  }
  return frames;
}

// scipy.signal.resample_poly(x, up, down, window=h_unscaled) with h already
// up-scaled by the caller; writes exactly expected_out floats (true-rate
// trim/pad applied). Accumulation: float32, ascending input index.
static void upfirdn_resample(const float* x, int64_t n_in, const float* h, int64_t h_len,
                             int64_t up, int64_t down, float* out, int64_t expected_out) {
  const int64_t half_len = (h_len - 1) / 2;
  const int64_t n_pre_pad = down - (half_len % down);  // scipy: no second mod
  const int64_t n_pre_remove = (half_len + n_pre_pad) / down;
  int64_t n_out = n_in * up;
  n_out = n_out / down + (n_out % down ? 1 : 0);
  const int64_t count = std::min(expected_out, n_out);
  for (int64_t m = 0; m < count; ++m) {
    // position in the (pre-padded) upsampled stream
    const int64_t pos = (m + n_pre_remove) * down;
    // valid taps: n_pre_pad <= pos - j*up < n_pre_pad + h_len
    int64_t j_lo = pos - n_pre_pad - h_len + 1;
    j_lo = j_lo <= 0 ? 0 : (j_lo + up - 1) / up;
    int64_t j_hi = (pos - n_pre_pad) / up;
    if (j_hi > n_in - 1) j_hi = n_in - 1;
    float acc = 0.0f;
    const int64_t base = pos - n_pre_pad;
    for (int64_t j = j_lo; j <= j_hi; ++j) acc += h[base - j * up] * x[j];
    out[m] = acc;
  }
  for (int64_t m = count; m < expected_out; ++m) out[m] = 0.0f;
}

}  // namespace

// Probe a WAV buffer: fills [rate, frames, channels]; returns 0 on success,
// negative on not-a-WAV / unsupported format (caller falls back to Python).
CT_EXPORT int32_t ct_wav_probe(const uint8_t* buf, int64_t n, int64_t* out3) {
  WavInfo w;
  if (!parse_wav(buf, n, &w)) return -1;
  bool supported = (w.audio_format == 3 && (w.sampwidth == 4 || w.sampwidth == 8)) ||
                   (w.audio_format == 1 &&
                    (w.sampwidth == 1 || w.sampwidth == 2 || w.sampwidth == 3 || w.sampwidth == 4));
  if (!supported) return -2;
  out3[0] = w.rate;
  out3[1] = w.sampwidth ? (w.data_len / w.sampwidth) / std::max(1, w.channels) : 0;
  out3[2] = w.channels;
  return 0;
}

// Decode + downmix + resample in one call. `h` is the resample_poly window
// ALREADY scaled by `up` (float32); pass up=down=1 with h_len=0 for a pure
// decode (out gets min(frames, expected_out) samples, zero-padded).
// Returns 0 on success, negative on malformed/unsupported input.
CT_EXPORT int32_t ct_wav_decode_resample(const uint8_t* buf, int64_t n, const float* h,
                                         int64_t h_len, int64_t up, int64_t down, float* out,
                                         int64_t expected_out) {
  WavInfo w;
  if (!parse_wav(buf, n, &w)) return -1;
  std::vector<float> mono;
  const int64_t frames = decode_mono(w, &mono);
  if (frames < 0) return -2;
  if (up == 1 && down == 1) {
    const int64_t count = std::min(frames, expected_out);
    std::memcpy(out, mono.data(), (size_t)count * sizeof(float));
    for (int64_t m = count; m < expected_out; ++m) out[m] = 0.0f;
    return 0;
  }
  if (h_len < 3 || (h_len & 1) == 0 || up < 1 || down < 1) return -3;
  upfirdn_resample(mono.data(), frames, h, h_len, up, down, out, expected_out);
  return 0;
}
