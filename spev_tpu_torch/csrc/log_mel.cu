// K2: fused log-mel spectrogram, for Hopper (sm_90a).
//
// Replaces spev_tpu/ops/pallas/kernels.py:_mel_kernel.  On the reflect-padded
// signal (padded by n_fft/2 on each side, done by the wrapper), frame f is
// padded[f*hop .. f*hop + n_fft), and
//
//   x[f, n]   = padded[f*hop + n] * window[n]
//   re[f, k]  = sum_n x[f, n] * cos_b[n, k]      im[f, k] = sum_n x[f, n] * sin_b[n, k]
//   power     = re*re + im*im                              (n_freqs = n_fft/2 + 1 bins)
//   out[m, f] = clip(log(max(sum_k power[f, k] * fb[m, k], floor)), clip_min, clip_max)
//
// The Pallas kernel assembled each 128-frame block from a polyphase stack of
// the signal with k = n_fft/hop aligned DMAs, because Mosaic needs aligned
// copies; here a block reads its frames straight from the padded signal, so
// there is no stack and no gather matrix.  All three products are computed in
// this kernel's body at fp32 (no tensor cores, no TF32): each sum is a chain
// of fmaf in a fixed order (n = 0..n_fft-1, then k = 0..n_freqs-1), so two
// launches give equal bits.
//
// Design (a simple kernel that is right first):
// - One block takes a tile of kTile = 8 frames and one thread per bin
//   (n_freqs rounded up to warps: 544 threads at n_fft 1024; at most 576,
//   which leaves up to 113 registers a thread for the unrolled loop).
// - The tile's windowed frames go to shared memory (8 x 1024 floats, 32 KB).
//   Thread k walks n, reading cos_b[n, k] and sin_b[n, k] coalesced along the
//   bin axis (the 4.2 MB of bases stay in the 50 MB L2 across blocks), the
//   frame samples as float4 broadcasts from shared memory, and keeps re/im
//   for the 8 frames in registers.
// - Power (8 x 513) overwrites the frame tile; then each thread takes
//   (mel, frame) outputs and sums over the bins against the filterbank.
// - Occupancy: a 10 s clip has 865 frames.  A 16-frame tile would give 55
//   blocks for 132 SMs; the 8-frame tile gives 109 (13 for a 1 s clip).  A
//   smaller tile reads the bases from L2 once more per block, so 8 is the
//   compromise; splitting bins across blocks would need a second pass for
//   the mel product.
//
// Bound: the function's least work, not this design's.  Per frame a real
// FFT (2.5*n*log2(n) = 25.6 kflop at n_fft 1024), the window, the power and
// the slaney filterbank's nonzero taps (each bin lies in at most two
// triangles: 1000 taps at fmax sr/2) come to ~30 kflop; a 10 s clip (865
// frames) is ~26 MFLOP, 0.39 us at the H100's 67 TFLOP/s fp32, and its
// signal and output (1.2 MB) take 0.35 us at 3.35 TB/s.  The dense DFT
// products computed here (and by the Pallas kernel) are the TPU design's
// work, 2.18 MFLOP a frame, ~72x the bound's operations.  This kernel runs
// scalar FMAs from one 17-warp block per SM, each FMA pair waiting on a
// broadcast shared-memory load, so every block takes about as long as a
// whole 10 s clip: ~140 us per launch for 1-10 s clips on an H100 80GB HBM3
// at 700 W (PERF.md), some 350x its bound.  An FFT-based body, register-tiled
// or tensor-core products (3xTF32) and batching utterances are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8;
constexpr int kMaxThreads = 576;  // n_freqs <= 576: n_fft up to 1150

__global__ void __launch_bounds__(kMaxThreads)
log_mel_kernel(const float* __restrict__ padded, const float* __restrict__ window,
               const float* __restrict__ cos_b, const float* __restrict__ sin_b,
               const float* __restrict__ fb, float* __restrict__ out, int n_frames, int n_fft,
               int hop, int n_freqs, int n_mels, float floor_v, float clip_min, float clip_max) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);  // kTile x n_fft, later kTile x n_freqs
  const int f0 = blockIdx.x * kTile;

  // 1. the tile's windowed frames (rows past the last frame are zero)
  for (int i = threadIdx.x; i < kTile * n_fft; i += blockDim.x) {
    const int f = i / n_fft;
    const int n = i - f * n_fft;
    tile[i] = (f0 + f < n_frames) ? __fmul_rn(padded[(size_t)(f0 + f) * hop + n], window[n])
                                  : 0.f;
  }
  __syncthreads();

  // 2. the rDFT: thread k takes bin k of every frame in the tile
  const int k = threadIdx.x;
  float re[kTile], im[kTile];
#pragma unroll
  for (int f = 0; f < kTile; ++f) re[f] = im[f] = 0.f;
  if (k < n_freqs) {
    // unrolled so that the loads of four steps are in flight at once: one
    // block per SM would otherwise wait on L2 latency at every step
#pragma unroll 4
    for (int n = 0; n < n_fft; n += 4) {
      const float* cb = cos_b + (size_t)n * n_freqs + k;
      const float* sb = sin_b + (size_t)n * n_freqs + k;
      const float c0 = cb[0], c1 = cb[n_freqs], c2 = cb[2 * n_freqs], c3 = cb[3 * n_freqs];
      const float s0 = sb[0], s1 = sb[n_freqs], s2 = sb[2 * n_freqs], s3 = sb[3 * n_freqs];
#pragma unroll
      for (int f = 0; f < kTile; ++f) {
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
    for (int f = 0; f < kTile; ++f)
      tile[f * n_freqs + k] = __fadd_rn(__fmul_rn(re[f], re[f]), __fmul_rn(im[f], im[f]));
  }
  __syncthreads();

  // 4. the mel product, floor, log and clip; out is (n_mels, n_frames)
  for (int o = threadIdx.x; o < kTile * n_mels; o += blockDim.x) {
    const int m = o / kTile;
    const int f = o - m * kTile;
    if (f0 + f >= n_frames) continue;
    const float* w = fb + (size_t)m * n_freqs;
    const float* p = tile + f * n_freqs;
    float acc = 0.f;
    for (int j = 0; j < n_freqs; ++j) acc = fmaf(p[j], w[j], acc);
    out[(size_t)m * n_frames + f0 + f] =
        fminf(fmaxf(logf(fmaxf(acc, floor_v)), clip_min), clip_max);
  }
}

}  // namespace

// padded (n_fft + hop*(n_frames-1) or more,) f32, window (n_fft,), cos_b and
// sin_b (n_fft, n_freqs), fb (n_mels, n_freqs) -> out (n_mels, n_frames) f32.
// Requires n_fft % 4 == 0, n_freqs = n_fft/2 + 1 <= 576.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int log_mel_forward(const float* padded, const float* window, const float* cos_b,
                               const float* sin_b, const float* fb, float* out, int n_frames,
                               int n_fft, int hop, int n_freqs, int n_mels, float floor_v,
                               float clip_min, float clip_max, cudaStream_t stream) {
  const int threads = (n_freqs + 31) / 32 * 32;
  const int blocks = (n_frames + kTile - 1) / kTile;
  const size_t smem = (size_t)kTile * n_fft * sizeof(float);  // at most 36.7 KB
  log_mel_kernel<<<blocks, threads, smem, stream>>>(padded, window, cos_b, sin_b, fb, out,
                                                    n_frames, n_fft, hop, n_freqs, n_mels,
                                                    floor_v, clip_min, clip_max);
  return static_cast<int>(cudaGetLastError());
}
