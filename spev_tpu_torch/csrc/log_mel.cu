// K2: fused log-mel spectrogram, for Hopper (sm_90a).
//
// Replaces spev_tpu/ops/pallas/kernels.py:_mel_kernel.  Frame f of the
// signal y (length L), reflect-padded by n_fft/2 on each side, is
// padded[f*hop .. f*hop + n_fft), and
//
//   x[f, n]   = padded[f*hop + n] * window[n]
//   X[f, k]   = sum_n x[f, n] * exp(-2 pi i n k / n_fft)   (n_freqs = n_fft/2 + 1 bins)
//   power     = re*re + im*im
//   out[m, f] = clip(log(max(sum_k power[f, k] * fb[m, k], floor)), clip_min, clip_max)
//
// Bound: the function's least work.  Per frame a real FFT (2.5*n*log2(n) =
// 25.6 kflop at n_fft 1024), the window, the power and the slaney
// filterbank's nonzero taps (each bin lies in at most two triangles) come to
// ~30 kflop; a 10 s clip (865 frames) is ~26 MFLOP, 0.39 us at the H100's 67
// TFLOP/s fp32, and its signal and output (1.2 MB) take 0.35 us at 3.35
// TB/s.  Neither is close: the least kernel takes ~1 us of device time
// (chip_smoke.py's launch floor), so the design keeps the chain of
// dependent steps in a block short and gives every SM work.  The Pallas
// kernel computed a dense DFT (2.18 MFLOP a frame, ~72x the function's work)
// because the TPU's matrix unit wants products; on Hopper the FFT is the
// design.
//
// Design of the FFT body (n_fft a power of two, a kernel per n_fft, so the
// pass schedule and every index are compile-time):
// - A block of 256 threads takes a tile of F = 1, 2 or 4 consecutive
//   frames, the largest F that still gives one block per SM (a 10 s clip:
//   F = 4, 217 blocks; a 1 s clip: F = 1, 97 blocks).
// - Everything the block reads goes to shared memory in one batch of
//   cp.async copies, so the block waits on device memory once: the tile's
//   span of the signal ((F-1)*hop + n_fft samples, where it lies inside y;
//   the reflect padding is index arithmetic on y, reflect_index, so there
//   is no padded copy), the window, the twiddles and the filterbank's
//   nonzero taps, 2 a bin (ops/stft.py:mel_taps_by_parity, 4 KB at n_fft
//   1024, where the filterbank is 164 KB).  46 KB at n_fft 1024, F = 4.
// - Each frame's n_fft real samples, windowed, are packed as n_fft/2
//   complex points z[m] = x[2m] + i x[2m+1] and transformed by Stockham
//   passes of radix 8 (then 4 or 2), ping-ponging between two shared
//   buffers: log8(512) = 3 passes at n_fft 1024, one __syncthreads each.
//   The twiddles come from a table made on the host in float64 and rounded
//   once (ops/stft.py:fft_twiddles; no __sinf/__cosf), gathered at the
//   start into one small table per pass in which neighbouring threads read
//   neighbouring entries (read in the host's layout, the twiddle loads of
//   a pass fall on one shared-memory bank).
// - The real-input post-processing gives bins k and n_fft/2 - k from one
//   pair of loads, and the power is rounded as the plain version rounds it
//   (__fmul_rn/__fadd_rn, no contraction).
// - Each (mel, frame) output sums its band's nonzero taps only, [lo, hi)
//   made on the host (ops/stft.py:mel_band_ranges), in ascending bin order:
//   for finite power an fmaf with a zero tap leaves the sum's bits as they
//   are, so this is the dense sum minus its zeros.
// - Every sum has a fixed order, so two launches give equal bits.
//
// For an n_fft that is a multiple of 4 but not a power of two (up to 1148),
// log_mel_dense_forward keeps the dense body: one block per 8-frame tile,
// one thread per bin running both DFT products as fmaf chains against
// cos/sin bases, then the same mel sum over the full rows.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTile = 4;       // frames per block of the FFT body
constexpr int kFftThreads = 256;

// Index into y of sample q of the signal reflect-padded by `pad` (F.pad's
// "reflect", one bounce: the wrapper requires len > pad).
__device__ __forceinline__ int reflect_index(int q, int pad, int len) {
  int s = q - pad;
  s = s < 0 ? -s : s;
  return s >= len ? 2 * (len - 1) - s : s;
}

// cp.async of 4, 8 or 16 bytes (16: bypassing L1)
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(kBytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
__device__ __forceinline__ float2 mul_minus_i(float2 a) { return make_float2(a.y, -a.x); }

// In-register forward DFTs of 2, 4 and 8 points, natural order in and out.
template <int R>
__device__ __forceinline__ void dft(float2* v);

template <>
__device__ __forceinline__ void dft<2>(float2* v) {
  const float2 t = v[0];
  v[0] = cadd(t, v[1]);
  v[1] = csub(t, v[1]);
}

template <>
__device__ __forceinline__ void dft<4>(float2* v) {
  const float2 s0 = cadd(v[0], v[2]), d0 = csub(v[0], v[2]);
  const float2 s1 = cadd(v[1], v[3]), d1 = mul_minus_i(csub(v[1], v[3]));
  v[0] = cadd(s0, s1);
  v[1] = cadd(d0, d1);
  v[2] = csub(s0, s1);
  v[3] = csub(d0, d1);
}

template <>
__device__ __forceinline__ void dft<8>(float2* v) {
  constexpr float r = 0.70710678118654752f;  // sqrt(1/2)
  float2 e[4] = {v[0], v[2], v[4], v[6]};
  float2 o[4] = {v[1], v[3], v[5], v[7]};
  dft<4>(e);
  dft<4>(o);
  o[1] = make_float2((o[1].x + o[1].y) * r, (o[1].y - o[1].x) * r);    // * exp(-i pi/4)
  o[2] = mul_minus_i(o[2]);                                            // * exp(-i pi/2)
  o[3] = make_float2((o[3].y - o[3].x) * r, -(o[3].x + o[3].y) * r);   // * exp(-3i pi/4)
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = cadd(e[k], o[k]);
    v[k + 4] = csub(e[k], o[k]);
  }
}

__host__ __device__ constexpr int radix_for(int left) {
  return left >= 8 ? 8 : (left >= 4 ? 4 : 2);
}

// The first Stockham pass (span 1, no twiddles) of one frame: butterfly j
// reads the windowed real pairs z[j + r*kN2/R] = x[2m] + i x[2m+1] straight
// from the frame's span of the signal and writes dst[j*R + r].
template <int kN2>
__device__ __forceinline__ void first_pass(const float* span, const float* window, float2* dst,
                                           int lt, int tpf) {
  constexpr int R = radix_for(kN2);
  constexpr int q = kN2 / R;
  for (int j = lt; j < q; j += tpf) {
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = j + r * q;
      v[r] = make_float2(__fmul_rn(span[2 * m], window[2 * m]),
                         __fmul_rn(span[2 * m + 1], window[2 * m + 1]));
    }
    dft<R>(v);
#pragma unroll
    for (int r = 0; r < R; ++r) dst[j * R + r] = v[r];
  }
}

// The Stockham passes from span kNs on, over every frame of the tile:
// butterfly j of a frame reads src[j + r*kN2/R] (r = 0..R-1), multiplies by
// W_{kNs*R}^{r*k} (k = j % kNs) from the pass's twiddle table, transforms,
// and writes dst[(j - k)*R + k + r*kNs]; then the next pass, buffers
// swapped.  Returns the buffer the last pass wrote.  The twiddle table of
// the pass of span ns starts at tw[ns - 1] and holds W_{ns*R}^{r*k} at
// [(r-1)*ns + k]: neighbouring threads read neighbouring entries.
template <int kN2, int kNs>
__device__ __forceinline__ float2* fft_passes(float2* src, float2* dst, const float2* tw,
                                              bool active, int lt, int tpf) {
  if constexpr (kNs >= kN2) {
    return src;
  } else {
    constexpr int R = radix_for(kN2 / kNs);
    constexpr int q = kN2 / R;
    const float2* ptw = tw + kNs - 1;
    for (int j = lt; active && j < q; j += tpf) {
      const int k = j & (kNs - 1);
      float2 v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = src[j + r * q];
      if (k > 0) {
#pragma unroll
        for (int r = 1; r < R; ++r) v[r] = cmul(v[r], ptw[(r - 1) * kNs + k]);
      }
      dft<R>(v);
      const int d = (j - k) * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) dst[d + r * kNs] = v[r];
    }
    __syncthreads();
    return fft_passes<kN2, kNs * R>(dst, src, tw, active, lt, tpf);
  }
}

// Copies the twiddle tables of every pass (see fft_passes) from the
// host's full table, W^m at tw[m] (W = exp(-2 pi i / n_fft)), to s_tw.
template <int kN2, int kNs>
__device__ __forceinline__ void stage_pass_twiddles(float2* s_tw, const float2* tw) {
  if constexpr (kNs < kN2) {
    constexpr int R = radix_for(kN2 / kNs);
    constexpr int stride = 2 * kN2 / (kNs * R);
    for (int i = threadIdx.x; i < (R - 1) * kNs; i += blockDim.x) {
      const int r = i / kNs + 1;
      const int k = i - (r - 1) * kNs;
      cp_async<8>(s_tw + kNs - 1 + i, tw + r * k * stride);
    }
    stage_pass_twiddles<kN2, kNs * R>(s_tw, tw);
  }
}

__device__ __forceinline__ float finish(float acc, float floor_v, float clip_min, float clip_max) {
  return fminf(fmaxf(logf(fmaxf(acc, floor_v)), clip_min), clip_max);
}

// The FFT body for n_fft = 2 * kN2.  Shared memory, in floats: two buffers
// of tile * n_fft (A, B: tile * kN2 complex each), the window (n_fft), the
// passes' twiddles (kN2 - 1 complex), W^k for k = 0..kN2/2 (the
// post-processing's), and the taps by parity (kN2 + 1 pairs).  The signal
// span lives in B until the first pass has read it; the power goes to
// whichever buffer the last pass did not write.
template <int kN2>
__global__ void __launch_bounds__(kFftThreads)
log_mel_fft_kernel(const float* __restrict__ y, int len, const float* __restrict__ window,
                   const float2* __restrict__ twiddles, const int2* __restrict__ bands,
                   const float2* __restrict__ taps, float* __restrict__ out, int n_frames,
                   int hop, int n_mels, int tile, float floor_v, float clip_min,
                   float clip_max) {
  constexpr int n_fft = 2 * kN2;
  constexpr int n_freqs = kN2 + 1;
  extern __shared__ float4 smem4[];
  float2* buf_a = reinterpret_cast<float2*>(smem4);
  float2* buf_b = buf_a + tile * kN2;
  float* span = reinterpret_cast<float*>(buf_b);
  float* s_win = reinterpret_cast<float*>(buf_b + tile * kN2);
  float2* s_tw = reinterpret_cast<float2*>(s_win + n_fft);
  float2* s_post = s_tw + kN2 - 1;
  float2* s_taps = s_post + kN2 / 2 + 1;

  const int f0 = blockIdx.x * tile;
  const int nf = min(tile, n_frames - f0);  // frames of this tile
  const int tpf = blockDim.x / tile;        // threads a frame in the FFT passes
  const int fr = threadIdx.x / tpf;         // this thread's frame there
  const int lt = threadIdx.x - fr * tpf;

  // 1. one batch of copies: the span of the signal under the tile's frames,
  //    the window, the twiddles and the taps
  const int span_len = (nf - 1) * hop + n_fft;
  const int base = f0 * hop;
  for (int i = threadIdx.x; i < span_len; i += blockDim.x) {
    const int s = reflect_index(base + i, kN2, len);
    if (s == base + i - kN2)
      cp_async<4>(span + i, y + s);
    else
      span[i] = __ldg(y + s);
  }
  for (int i = threadIdx.x; i < n_fft / 4; i += blockDim.x)
    cp_async<16>(s_win + 4 * i, window + 4 * i);
  stage_pass_twiddles<kN2, 1>(s_tw, twiddles);
  for (int i = threadIdx.x; i <= kN2 / 2; i += blockDim.x) cp_async<8>(s_post + i, twiddles + i);
  for (int i = threadIdx.x; i < n_freqs; i += blockDim.x) cp_async<8>(s_taps + i, taps + i);
  // this thread's first mel band, read while the copies land
  const int2 band0 = threadIdx.x < nf * n_mels ? __ldg(bands + threadIdx.x / nf) : make_int2(0, 0);
  cp_async_wait_all();
  __syncthreads();

  // 2. window, pack and the complex FFT of kN2 points, one frame per tpf threads
  const bool active = fr < nf;
  if (active) first_pass<kN2>(span + fr * hop, s_win, buf_a + fr * kN2, lt, tpf);
  __syncthreads();
  constexpr int kNs1 = radix_for(kN2);
  float2* z = fft_passes<kN2, kNs1>(buf_a + fr * kN2, buf_b + fr * kN2, s_tw, active, lt, tpf);
  const bool in_a = z == buf_a + fr * kN2;  // the same for every frame
  const float2* zs = in_a ? buf_a : buf_b;

  // 3. the real-input post-processing and the power of bins k and kN2-k:
  //    E = (Z[k] + conj Z[kN2-k]) / 2, O = -i (Z[k] - conj Z[kN2-k]) / 2,
  //    X[k] = E + W^k O, X[kN2-k] = conj(E - W^k O)
  float* power = reinterpret_cast<float*>(in_a ? buf_b : buf_a);
  constexpr int kPairs = kN2 / 2 + 1;
  for (int i = threadIdx.x; i < nf * kPairs; i += blockDim.x) {
    const int f = i / kPairs;
    const int k = i - f * kPairs;
    const float2 a = zs[f * kN2 + k];
    const float2 c = zs[f * kN2 + (k == 0 ? 0 : kN2 - k)];
    const float2 w = s_post[k];
    const float er = (a.x + c.x) * 0.5f, ei = (a.y - c.y) * 0.5f;
    const float or_ = (a.y + c.y) * 0.5f, oi = (c.x - a.x) * 0.5f;
    const float pr = w.x * or_ - w.y * oi, pi = w.x * oi + w.y * or_;
    const float re = er + pr, im = ei + pi;
    power[f * n_freqs + k] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
    if (2 * k != kN2) {
      const float re2 = er - pr, im2 = ei - pi;
      power[f * n_freqs + kN2 - k] = __fadd_rn(__fmul_rn(re2, re2), __fmul_rn(im2, im2));
    }
  }
  __syncthreads();

  // 4. the mel sums over each band's nonzero taps, floor, log and clip;
  //    out is (n_mels, n_frames), neighbouring threads on neighbouring frames
  const float* s_tapf = reinterpret_cast<const float*>(s_taps);
  for (int o = threadIdx.x; o < nf * n_mels; o += blockDim.x) {
    const int m = o / nf;
    const int f = o - m * nf;
    const int2 band = o == threadIdx.x ? band0 : __ldg(bands + m);
    const float* p = power + f * n_freqs;
    const float* w = s_tapf + (m & 1);
    float acc = 0.f;
#pragma unroll 4
    for (int k = band.x; k < band.y; ++k) acc = fmaf(p[k], w[2 * k], acc);
    out[(size_t)m * n_frames + f0 + f] = finish(acc, floor_v, clip_min, clip_max);
  }
}

constexpr int kDenseTile = 8;
constexpr int kDenseMaxThreads = 576;  // n_freqs <= 576: n_fft up to 1150

// The dense body, for an n_fft that is not a power of two: one thread per
// bin runs both DFT products over the tile's 8 frames.
__global__ void __launch_bounds__(kDenseMaxThreads)
log_mel_dense_kernel(const float* __restrict__ y, int len, const float* __restrict__ window,
                     const float* __restrict__ cos_b, const float* __restrict__ sin_b,
                     const float* __restrict__ fb, float* __restrict__ out, int n_frames,
                     int n_fft, int hop, int n_freqs, int n_mels, float floor_v, float clip_min,
                     float clip_max) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);  // kDenseTile x n_fft, later x n_freqs
  const int f0 = blockIdx.x * kDenseTile;

  // 1. the tile's windowed frames (rows past the last frame are zero)
  for (int i = threadIdx.x; i < kDenseTile * n_fft; i += blockDim.x) {
    const int f = i / n_fft;
    const int n = i - f * n_fft;
    tile[i] = (f0 + f < n_frames)
                  ? __fmul_rn(__ldg(y + reflect_index((f0 + f) * hop + n, n_fft / 2, len)),
                              window[n])
                  : 0.f;
  }
  __syncthreads();

  // 2. the rDFT: thread k takes bin k of every frame in the tile
  const int k = threadIdx.x;
  float re[kDenseTile], im[kDenseTile];
#pragma unroll
  for (int f = 0; f < kDenseTile; ++f) re[f] = im[f] = 0.f;
  if (k < n_freqs) {
#pragma unroll 4
    for (int n = 0; n < n_fft; n += 4) {
      const float* cb = cos_b + (size_t)n * n_freqs + k;
      const float* sb = sin_b + (size_t)n * n_freqs + k;
      const float c0 = cb[0], c1 = cb[n_freqs], c2 = cb[2 * n_freqs], c3 = cb[3 * n_freqs];
      const float s0 = sb[0], s1 = sb[n_freqs], s2 = sb[2 * n_freqs], s3 = sb[3 * n_freqs];
#pragma unroll
      for (int f = 0; f < kDenseTile; ++f) {
        const float4 x = *reinterpret_cast<const float4*>(tile + f * n_fft + n);
        re[f] = fmaf(x.x, c0, re[f]);
        im[f] = fmaf(x.x, s0, im[f]);
        re[f] = fmaf(x.y, c1, re[f]);
        im[f] = fmaf(x.y, s1, im[f]);
        re[f] = fmaf(x.z, c2, re[f]);
        im[f] = fmaf(x.z, s2, im[f]);
        re[f] = fmaf(x.w, c3, re[f]);
        im[f] = fmaf(x.w, s3, im[f]);
      }
    }
  }
  __syncthreads();  // every frame sample read before power overwrites the tile

  // 3. power, rounded as the plain version rounds it (no contraction)
  if (k < n_freqs) {
#pragma unroll
    for (int f = 0; f < kDenseTile; ++f)
      tile[f * n_freqs + k] = __fadd_rn(__fmul_rn(re[f], re[f]), __fmul_rn(im[f], im[f]));
  }
  __syncthreads();

  // 4. the mel product, floor, log and clip; out is (n_mels, n_frames)
  for (int o = threadIdx.x; o < kDenseTile * n_mels; o += blockDim.x) {
    const int m = o / kDenseTile;
    const int f = o - m * kDenseTile;
    if (f0 + f >= n_frames) continue;
    const float* w = fb + (size_t)m * n_freqs;
    const float* p = tile + f * n_freqs;
    float acc = 0.f;
    for (int j = 0; j < n_freqs; ++j) acc = fmaf(p[j], w[j], acc);
    out[(size_t)m * n_frames + f0 + f] = finish(acc, floor_v, clip_min, clip_max);
  }
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace

// The FFT body.  y (len,) f32 with len > n_fft/2; window (n_fft,);
// twiddles (n_fft, 2) f32 (cos, -sin); bands (n_mels, 2) int32 [lo, hi);
// taps (n_fft/2 + 1, 2) f32, band m's tap for bin k at [k, m % 2] ->
// out (n_mels, n_frames) f32.  Requires n_fft a power of two from 4 to
// 1024.  Launches on `stream`; returns cudaGetLastError().
extern "C" int log_mel_forward(const float* y, int len, const float* window,
                               const float* twiddles, const int* bands, const float* taps,
                               float* out, int n_frames, int n_fft, int hop, int n_mels,
                               float floor_v, float clip_min, float clip_max,
                               cudaStream_t stream) {
  // the largest tile that still gives every SM a block; a span of more than
  // n_fft samples a frame (hop > n_fft) would not fit the tile's buffers
  const int sms = sm_count();
  int tile = 1;
  for (int f = kMaxTile; f > 1 && hop <= n_fft; f /= 2) {
    if ((n_frames + f - 1) / f >= sms) {
      tile = f;
      break;
    }
  }
  const int blocks = (n_frames + tile - 1) / tile;
  // 46 KB at n_fft 1024 and tile 4: under the 48 KB a launch gets by default
  const size_t smem =
      ((size_t)2 * tile * n_fft + n_fft + 2 * (n_fft / 2 - 1) + 2 * (n_fft / 4 + 1)
       + 2 * (n_fft / 2 + 1)) * sizeof(float);
  const float2* tw = reinterpret_cast<const float2*>(twiddles);
  const int2* bd = reinterpret_cast<const int2*>(bands);
  const float2* tp = reinterpret_cast<const float2*>(taps);
#define SPEV_LAUNCH_FFT(N2)                                                                  \
  case 2 * N2:                                                                               \
    log_mel_fft_kernel<N2><<<blocks, kFftThreads, smem, stream>>>(                           \
        y, len, window, tw, bd, tp, out, n_frames, hop, n_mels, tile, floor_v, clip_min,     \
        clip_max);                                                                           \
    break;
  switch (n_fft) {
    SPEV_LAUNCH_FFT(2)
    SPEV_LAUNCH_FFT(4)
    SPEV_LAUNCH_FFT(8)
    SPEV_LAUNCH_FFT(16)
    SPEV_LAUNCH_FFT(32)
    SPEV_LAUNCH_FFT(64)
    SPEV_LAUNCH_FFT(128)
    SPEV_LAUNCH_FFT(256)
    SPEV_LAUNCH_FFT(512)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPEV_LAUNCH_FFT
  return static_cast<int>(cudaGetLastError());
}

// The dense body.  y and window as above, cos_b and sin_b (n_fft, n_freqs),
// fb (n_mels, n_freqs) -> out (n_mels, n_frames) f32.  Requires n_fft % 4
// == 0 and n_freqs = n_fft/2 + 1 <= 576.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int log_mel_dense_forward(const float* y, int len, const float* window,
                                     const float* cos_b, const float* sin_b, const float* fb,
                                     float* out, int n_frames, int n_fft, int hop, int n_freqs,
                                     int n_mels, float floor_v, float clip_min, float clip_max,
                                     cudaStream_t stream) {
  const int threads = (n_freqs + 31) / 32 * 32;
  const int blocks = (n_frames + kDenseTile - 1) / kDenseTile;
  const size_t smem = (size_t)kDenseTile * n_fft * sizeof(float);  // at most 36.7 KB
  log_mel_dense_kernel<<<blocks, threads, smem, stream>>>(y, len, window, cos_b, sin_b, fb, out,
                                                          n_frames, n_fft, hop, n_freqs, n_mels,
                                                          floor_v, clip_min, clip_max);
  return static_cast<int>(cudaGetLastError());
}
