// K1: fused length regulation for Hopper (sm_90a), and below it K1b, its
// backward.
//
// K1 replaces spev_tpu/ops/pallas/length_regulator_kernel.py:_lr_kernel, which
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
// written and 2.2 MB read, 4.5 us at 3.35 TB/s.  On the serving path (B=1-4,
// M=512-1024) the bytes take under 1 us and a launch about 2 us, so what
// counts there is the chain of dependent steps in each warp and how many
// SMs get work.  Design against both:
// - One warp per frame, 8 frames a block: B=1, M=512 launches 64 blocks.
// - No shared memory and no __syncthreads.  Each lane counts the ends <= j
//   in its slice of ends[b, :] (4 ints, one 16-byte load where the row is
//   aligned; T*4 bytes that stay in L1/L2), a chunk of 128 ends a pass, and
//   __reduce_add_sync sums the counts.  Ends are non-decreasing, so the
//   count is exactly the upper bound a binary search would find, and
//   integer, so the result stays bit-equal.  The chain is then: the ends'
//   loads (all independent), one reduction, the row's loads, its stores.
// - The warp copies the phoneme's row with 16-byte loads and stores,
//   neighbouring lanes on neighbouring addresses, so every output byte is
//   written once, fully coalesced.  Rows of x are re-read from L2 when
//   several frames share a phoneme; the compulsory traffic stays the
//   output.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: 8 frames per block
constexpr int kTracks = 8;
constexpr int kChunk = 128;    // ends counted per pass of the warp: 4 a lane

__global__ void __launch_bounds__(kThreads)
lr_fused_kernel(const int* __restrict__ ends, const float* __restrict__ x,
                const float* __restrict__ feats, float* __restrict__ xout,
                float* __restrict__ fout, int T, int H, int M, int vec) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= M) return;  // the whole warp: j is the warp's

  // #{t : ends[b, t] <= j}, lane by lane, then across the warp
  const int* e = ends + (size_t)b * T;
  const bool e_vec = (reinterpret_cast<uintptr_t>(e) & 15) == 0;
  const int total = __ldg(e + T - 1);
  int count = 0;
#pragma unroll 4
  for (int t0 = lane * 4; t0 < T; t0 += kChunk) {
    if (e_vec && t0 + 4 <= T) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(e + t0));
      count += (v.x <= j) + (v.y <= j) + (v.z <= j) + (v.w <= j);
    } else {
      for (int t = t0; t < T && t < t0 + 4; ++t) count += __ldg(e + t) <= j;
    }
  }
  count = __reduce_add_sync(0xffffffffu, count);

  const size_t src = (size_t)b * T + min(count, T - 1);
  const size_t dst = (size_t)b * M + j;
  const bool valid = j < total;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
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

// K1b: the backward of K1 for Hopper (sm_90a).
//
// Replaces spev_tpu/ops/pallas/length_regulator_kernel.py:_lr_bwd_kernel
// (called through _lr_fused_bwd), the transposed one-hot matmul
// onehot^T @ g on the TPU's matrix unit.  Mathematically a segment-sum:
//
//   gxout[b, t, :] = sum of gx[b, j, :] over j in [ends[t-1], ends[t]) and
//                    j < M                      (ends[-1] := 0; H floats)
//   gfout[b, t, :] = the same over gf            (8 floats)
//
// Frames at or past total = ends[T-1] belong to no phoneme, and frames past
// the bucket M were dropped by the forward (saturation), so neither is read.
// A zero-duration phoneme (equal neighbouring ends) or an all-zero row gets
// exactly 0.
//
// Bound: pure data movement.  The valid frames' cotangents, at most
// B*M*(H+8)*4 bytes, are read once and B*T*(H+8)*4 bytes written once; at
// B=16, T=128, H=256, M=768 that is 12.9 MB + 2.2 MB, 4.5 us at 3.35 TB/s.
// Design: one warp owns one phoneme (a block holds 8 phonemes of one batch
// row), reads its [start, end) from ends and walks those frames in frame
// order, lanes across the channel axis with 16-byte loads, summing in
// registers; it writes its row once.  No atomics: the summation order is
// fixed, so two launches give equal bits, as the TPU kernel does.

constexpr int kBwdThreads = 256;  // 8 warps: 8 phonemes per block

__global__ void __launch_bounds__(kBwdThreads)
lr_fused_bwd_kernel(const int* __restrict__ ends, const float* __restrict__ gx,
                    const float* __restrict__ gf, float* __restrict__ gxout,
                    float* __restrict__ gfout, int T, int H, int M, int vec) {
  const int b = blockIdx.y;
  const int t = blockIdx.x * (kBwdThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= T) return;

  const int* e = ends + (size_t)b * T;
  const int stop = min(e[t], M);
  const int start = min(t > 0 ? e[t - 1] : 0, stop);
  const float* gxb = gx + (size_t)b * M * H;
  const float* gfb = gf + (size_t)b * M * kTracks;
  const size_t row = (size_t)b * T + t;

  if (vec) {
    const int H4 = H >> 2;
    for (int c = lane; c < H4; c += 32) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int j = start; j < stop; ++j) {
        const float4 v = reinterpret_cast<const float4*>(gxb + (size_t)j * H)[c];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      reinterpret_cast<float4*>(gxout + row * H)[c] = acc;
    }
  } else {
    for (int c = lane; c < H; c += 32) {
      float acc = 0.f;
#pragma unroll 4
      for (int j = start; j < stop; ++j) acc += gxb[(size_t)j * H + c];
      gxout[row * H + c] = acc;
    }
  }
  if (lane < kTracks) {
    float acc = 0.f;
#pragma unroll 4
    for (int j = start; j < stop; ++j) acc += gfb[(size_t)j * kTracks + lane];
    gfout[row * kTracks + lane] = acc;
  }
}

}  // namespace

// ends (B, T) int32; x (B, T, H) f32; feats (B, T, 8) f32 -> xout (B, M, H),
// fout (B, M, 8) f32.  vec != 0 requires H % 4 == 0 and 16-byte-aligned
// pointers.  Launches on `stream`; returns cudaGetLastError().
extern "C" int lr_fused_forward(const int* ends, const float* x, const float* feats,
                                float* xout, float* fout, int B, int T, int H, int M,
                                int vec, cudaStream_t stream) {
  constexpr int kFramesPerBlock = kThreads / 32;
  const dim3 grid((M + kFramesPerBlock - 1) / kFramesPerBlock, B);
  lr_fused_kernel<<<grid, kThreads, 0, stream>>>(ends, x, feats, xout, fout, T, H, M, vec);
  return static_cast<int>(cudaGetLastError());
}

// ends (B, T) int32; gx (B, M, H) f32; gf (B, M, 8) f32 -> gxout (B, T, H),
// gfout (B, T, 8) f32, every element written.  vec as above.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int lr_fused_backward(const int* ends, const float* gx, const float* gf,
                                 float* gxout, float* gfout, int B, int T, int H, int M,
                                 int vec, cudaStream_t stream) {
  constexpr int kPhonemesPerBlock = kBwdThreads / 32;
  const dim3 grid((T + kPhonemesPerBlock - 1) / kPhonemesPerBlock, B);
  lr_fused_bwd_kernel<<<grid, kBwdThreads, 0, stream>>>(ends, gx, gf, gxout, gfout,
                                                        T, H, M, vec);
  return static_cast<int>(cudaGetLastError());
}
