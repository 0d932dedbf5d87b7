// spevio — native I/O runtime for spev_tpu.
//
// The reference delegates audio I/O and dataset preparation to native
// libraries (libsndfile via soundfile, librosa's C paths — SURVEY.md §2.8).
// This library is the framework's own native substrate:
//
//   * WAV decode (PCM 8/16/24/32 and IEEE float, any channel count → mono
//     float32) and PCM16 encode,
//   * the dataset-prep hot loop (silence trim + peak normalize) operating
//     in-place on decoded buffers,
//   * a threaded prefetching file loader: a background thread reads and
//     decodes files into a bounded ring buffer while the host feeds the
//     accelerator (replacing the reference's DataLoader worker processes).
//
// Exposed as a C ABI for ctypes (no pybind11 dependency).  Build: `make`.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// WAV codec
// ---------------------------------------------------------------------------

struct WavData {
  float* samples;
  int64_t length;
  int32_t sample_rate;
};

static int read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out.resize(n);
  size_t got = std::fread(out.data(), 1, n, f);
  std::fclose(f);
  return got == static_cast<size_t>(n) ? 0 : -1;
}

static inline uint32_t rd_u32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}
static inline uint16_t rd_u16(const uint8_t* p) { return p[0] | (p[1] << 8); }

// Decode a WAV file to mono float32 in [-1, 1].  Returns 0 on success.
int spev_read_wav(const char* path, WavData* out) {
  std::vector<uint8_t> buf;
  if (read_file(path, buf) != 0 || buf.size() < 44) return -1;
  if (std::memcmp(buf.data(), "RIFF", 4) || std::memcmp(buf.data() + 8, "WAVE", 4))
    return -2;

  uint16_t fmt = 0, n_ch = 0, bits = 0;
  uint32_t sr = 0;
  const uint8_t* data = nullptr;
  uint32_t data_len = 0;

  size_t pos = 12;
  while (pos + 8 <= buf.size()) {
    const uint8_t* c = buf.data() + pos;
    uint32_t size = rd_u32(c + 4);
    if (!std::memcmp(c, "fmt ", 4) && size >= 16) {
      fmt = rd_u16(c + 8);
      n_ch = rd_u16(c + 10);
      sr = rd_u32(c + 12);
      bits = rd_u16(c + 22);
      if (fmt == 0xFFFE && size >= 26) fmt = rd_u16(c + 8 + 24);  // extensible
    } else if (!std::memcmp(c, "data", 4)) {
      data = c + 8;
      data_len = size;
      if (pos + 8 + data_len > buf.size()) data_len = buf.size() - pos - 8;
    }
    pos += 8 + size + (size & 1);
  }
  if (!data || !n_ch || !sr) return -3;

  int64_t n_frames;
  std::vector<float> interleaved;
  if (fmt == 3 && bits == 32) {
    n_frames = data_len / (4 * n_ch);
    interleaved.resize(n_frames * n_ch);
    std::memcpy(interleaved.data(), data, n_frames * n_ch * 4);
  } else if (fmt == 1 && bits == 16) {
    n_frames = data_len / (2 * n_ch);
    interleaved.resize(n_frames * n_ch);
    const int16_t* s = reinterpret_cast<const int16_t*>(data);
    for (int64_t i = 0; i < n_frames * n_ch; ++i) interleaved[i] = s[i] / 32768.0f;
  } else if (fmt == 1 && bits == 32) {
    n_frames = data_len / (4 * n_ch);
    interleaved.resize(n_frames * n_ch);
    const int32_t* s = reinterpret_cast<const int32_t*>(data);
    for (int64_t i = 0; i < n_frames * n_ch; ++i)
      interleaved[i] = s[i] / 2147483648.0f;
  } else if (fmt == 1 && bits == 24) {
    n_frames = data_len / (3 * n_ch);
    interleaved.resize(n_frames * n_ch);
    for (int64_t i = 0; i < n_frames * n_ch; ++i) {
      const uint8_t* p = data + 3 * i;
      int32_t v = p[0] | (p[1] << 8) | (p[2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      interleaved[i] = v / 8388608.0f;
    }
  } else if (fmt == 1 && bits == 8) {
    n_frames = data_len / n_ch;
    interleaved.resize(n_frames * n_ch);
    for (int64_t i = 0; i < n_frames * n_ch; ++i)
      interleaved[i] = (data[i] - 128) / 128.0f;
  } else {
    return -4;
  }

  float* mono = static_cast<float*>(std::malloc(n_frames * sizeof(float)));
  if (!mono) return -5;
  if (n_ch == 1) {
    std::memcpy(mono, interleaved.data(), n_frames * sizeof(float));
  } else {
    for (int64_t i = 0; i < n_frames; ++i) {
      float acc = 0.0f;
      for (int c2 = 0; c2 < n_ch; ++c2) acc += interleaved[i * n_ch + c2];
      mono[i] = acc / n_ch;
    }
  }
  out->samples = mono;
  out->length = n_frames;
  out->sample_rate = static_cast<int32_t>(sr);
  return 0;
}

void spev_free(float* p) { std::free(p); }

// Encode mono float32 → 16-bit PCM WAV.  Returns 0 on success.
int spev_write_wav(const char* path, const float* samples, int64_t length,
                   int32_t sample_rate) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  uint32_t data_bytes = static_cast<uint32_t>(length * 2);
  uint32_t riff = 36 + data_bytes;
  uint8_t hdr[44] = {'R', 'I', 'F', 'F', 0, 0, 0, 0, 'W', 'A', 'V', 'E',
                     'f', 'm', 't', ' ', 16, 0, 0, 0, 1, 0, 1, 0,
                     0, 0, 0, 0, 0, 0, 0, 0, 2, 0, 16, 0,
                     'd', 'a', 't', 'a', 0, 0, 0, 0};
  auto wr32 = [&](int off, uint32_t v) {
    hdr[off] = v & 0xFF; hdr[off + 1] = (v >> 8) & 0xFF;
    hdr[off + 2] = (v >> 16) & 0xFF; hdr[off + 3] = (v >> 24) & 0xFF;
  };
  wr32(4, riff);
  wr32(24, sample_rate);
  wr32(28, sample_rate * 2);  // byte rate, mono 16-bit
  wr32(40, data_bytes);
  std::fwrite(hdr, 1, 44, f);
  std::vector<int16_t> pcm(length);
  for (int64_t i = 0; i < length; ++i) {
    float v = samples[i];
    if (v > 1.0f) v = 1.0f;
    if (v < -1.0f) v = -1.0f;
    pcm[i] = static_cast<int16_t>(v * 32767.0f);
  }
  std::fwrite(pcm.data(), 2, length, f);
  std::fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// dataset-prep hot loop: silence trim + peak normalize
// ---------------------------------------------------------------------------

// Computes the [start, end) sample range keeping frames within top_db of
// the peak RMS (librosa.effects.trim semantics; frame 2048, hop 512), and
// optionally peak-normalizes in place.  Returns 0.
int spev_trim_normalize(float* samples, int64_t length, float top_db,
                        int do_normalize, int64_t* out_start, int64_t* out_end) {
  const int64_t frame = 2048, hop = 512;
  *out_start = 0;
  *out_end = length;
  if (length >= frame) {
    int64_t n = 1 + (length - frame) / hop;
    std::vector<float> rms(n);
    float peak_rms = 0.0f;
    for (int64_t t = 0; t < n; ++t) {
      double acc = 0.0;
      const float* p = samples + t * hop;
      for (int64_t j = 0; j < frame; ++j) acc += double(p[j]) * p[j];
      rms[t] = std::sqrt(acc / frame);
      if (rms[t] > peak_rms) peak_rms = rms[t];
    }
    if (peak_rms > 0.0f) {
      float thresh = peak_rms * std::pow(10.0f, -top_db / 20.0f);
      int64_t first = -1, last = -1;
      for (int64_t t = 0; t < n; ++t) {
        if (rms[t] > thresh) {
          if (first < 0) first = t;
          last = t;
        }
      }
      if (first >= 0) {
        *out_start = first * hop;
        *out_end = std::min<int64_t>(length, last * hop + frame);
      }
    }
  }
  if (do_normalize) {
    float peak = 0.0f;
    for (int64_t i = *out_start; i < *out_end; ++i) {
      float a = std::fabs(samples[i]);
      if (a > peak) peak = a;
    }
    if (peak > 0.0f)
      for (int64_t i = *out_start; i < *out_end; ++i) samples[i] /= peak;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// threaded prefetching loader
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<std::string> paths;
  std::deque<WavData> ready;
  std::deque<int> ready_idx;
  size_t next_submit = 0;
  size_t capacity = 4;
  bool stop = false;
  std::mutex mu;
  std::condition_variable cv_space, cv_data;
  std::thread worker;

  void run() {
    while (true) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] { return stop || (ready.size() < capacity &&
                                                next_submit < paths.size()); });
        if (stop || next_submit >= paths.size()) return;
        idx = next_submit++;
      }
      WavData wd{nullptr, 0, 0};
      int rc = spev_read_wav(paths[idx].c_str(), &wd);
      {
        std::unique_lock<std::mutex> lk(mu);
        if (rc != 0) wd = WavData{nullptr, 0, 0};
        ready.push_back(wd);
        ready_idx.push_back(static_cast<int>(idx));
      }
      cv_data.notify_one();
    }
  }
};

void* spev_prefetcher_create(const char** paths, int n_paths, int capacity) {
  auto* p = new Prefetcher();
  for (int i = 0; i < n_paths; ++i) p->paths.emplace_back(paths[i]);
  p->capacity = capacity > 0 ? capacity : 4;
  p->worker = std::thread([p] { p->run(); });
  return p;
}

// Blocks for the next decoded file.  Returns the file index, or -1 when
// exhausted.  Caller owns out->samples (spev_free).
int spev_prefetcher_next(void* handle, WavData* out) {
  auto* p = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_data.wait(lk, [&] {
    return !p->ready.empty() ||
           (p->next_submit >= p->paths.size() && p->ready.empty());
  });
  if (p->ready.empty()) return -1;
  *out = p->ready.front();
  int idx = p->ready_idx.front();
  p->ready.pop_front();
  p->ready_idx.pop_front();
  lk.unlock();
  p->cv_space.notify_one();
  return idx;
}

void spev_prefetcher_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->stop = true;
  }
  p->cv_space.notify_all();
  if (p->worker.joinable()) p->worker.join();
  for (auto& wd : p->ready) spev_free(wd.samples);
  delete p;
}

}  // extern "C"
