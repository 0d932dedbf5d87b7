// K1: fused length regulation for Hopper (sm_90a).
//
// Replaces spev_tpu/ops/pallas/length_regulator_kernel.py:_lr_kernel, which
// expands phoneme-level hidden states and up to 8 variance tracks to frame
// level as a one-hot (M, T) matmul so that the TPU's matrix unit does it.
// On Hopper that matmul would read M*T zeros for nothing: the kernel is a
// fused gather instead.
//
//   frame j of row b  ->  phoneme ph = min(#{t : ends[b, t] <= j}, T - 1)
//   xout[b, j, :]  = j < total ? x[b, ph, :]     : 0      (H floats)
//   fout[b, j, :]  = j < total ? feats[b, ph, :] : 0      (8 floats)
//
// with ends the int32 cumsum of the sanitised durations and total =
// ends[b, T-1].  The result is a copy, so it is bit-equal to the plain
// PyTorch version (spev_tpu_torch/ops/cuda/length_regulator_kernel.py).
//
// Bound: pure data movement.  The outputs, B*M*(H+8)*4 bytes, dominate what
// must cross device memory; at B=16, T=128, H=256, M=768 that is 13.0 MB
// written and 2.2 MB read, 4.5 us at 3.35 TB/s.  Design against it: each
// block owns one batch row and a tile of 32 frames, stages ends[b, :T] in
// shared memory once, and each warp finds a frame's phoneme by binary search
// over the non-decreasing ends (upper bound) there.  The warp then copies
// the phoneme's row with 16-byte vector loads and stores, neighbouring lanes
// on neighbouring addresses, so every output byte is written once, fully
// coalesced.  Rows of x are re-read from L2 when several frames share a
// phoneme; the compulsory traffic stays the output.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // 8 warps
constexpr int kFramesPerBlock = 32;  // 4 frames per warp
constexpr int kTracks = 8;

__global__ void __launch_bounds__(kThreads)
lr_fused_kernel(const int* __restrict__ ends, const float* __restrict__ x,
                const float* __restrict__ feats, float* __restrict__ xout,
                float* __restrict__ fout, int T, int H, int M, int vec) {
  extern __shared__ int s_ends[];
  const int b = blockIdx.y;
  for (int t = threadIdx.x; t < T; t += kThreads) s_ends[t] = ends[(size_t)b * T + t];
  __syncthreads();

  const int total = s_ends[T - 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int jj = warp; jj < kFramesPerBlock; jj += kThreads / 32) {
    const int j = blockIdx.x * kFramesPerBlock + jj;
    if (j >= M) break;
    // upper bound: first t with ends[t] > j, i.e. #{t : ends[t] <= j}
    int lo = 0, hi = T;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_ends[mid] <= j) lo = mid + 1; else hi = mid;
    }
    const size_t src = (size_t)b * T + min(lo, T - 1);
    const size_t dst = (size_t)b * M + j;
    const bool valid = j < total;
    if (vec) {
      const float4* xin = reinterpret_cast<const float4*>(x + src * H);
      float4* xo = reinterpret_cast<float4*>(xout + dst * H);
      for (int c = lane; c < (H >> 2); c += 32) xo[c] = valid ? xin[c] : zero4;
      if (lane < kTracks / 4) {
        const float4* fin = reinterpret_cast<const float4*>(feats + src * kTracks);
        reinterpret_cast<float4*>(fout + dst * kTracks)[lane] = valid ? fin[lane] : zero4;
      }
    } else {
      for (int c = lane; c < H; c += 32) xout[dst * H + c] = valid ? x[src * H + c] : 0.f;
      if (lane < kTracks) fout[dst * kTracks + lane] = valid ? feats[src * kTracks + lane] : 0.f;
    }
  }
}

}  // namespace

// ends (B, T) int32; x (B, T, H) f32; feats (B, T, 8) f32 -> xout (B, M, H),
// fout (B, M, 8) f32.  vec != 0 requires H % 4 == 0 and 16-byte-aligned
// pointers.  Launches on `stream`; returns cudaGetLastError().
extern "C" int lr_fused_forward(const int* ends, const float* x, const float* feats,
                                float* xout, float* fout, int B, int T, int H, int M,
                                int vec, cudaStream_t stream) {
  const dim3 grid((M + kFramesPerBlock - 1) / kFramesPerBlock, B);
  lr_fused_kernel<<<grid, kThreads, T * sizeof(int), stream>>>(ends, x, feats, xout, fout,
                                                              T, H, M, vec);
  return static_cast<int>(cudaGetLastError());
}
