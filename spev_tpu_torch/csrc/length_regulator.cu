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
// onehot^T @ g on the TPU's matrix unit, whose time does not depend on the
// durations.  Mathematically a segment-sum:
//
//   gxout[b, t, :] = sum of gx[b, j, :] over j in [ends[t-1], ends[t]) and
//                    j < M                      (ends[-1] := 0; H floats)
//   gfout[b, t, :] = the same over gf            (8 floats)
//
// Frames at or past total = ends[T-1] belong to no phoneme, and frames past
// the bucket M were dropped by the forward (saturation), so neither is read.
// A zero-duration phoneme (equal neighbouring ends), an all-zero row or a
// phoneme past the bucket gets exactly 0.
//
// Bound: pure data movement.  The valid frames' cotangents, at most
// B*M*(H+8)*4 bytes, are read once and B*T*(H+8)*4 bytes written once; at
// B=16, T=128, H=256, M=768 that is 12.9 MB + 2.2 MB, 4.5 us at 3.35 TB/s.
//
// The first design gave one warp a phoneme and walked its frames in order,
// lanes across the channels: a warp's chain of dependent loads grew with
// its phoneme's duration (two channel passes at H=256, unrolled by 4), so
// the longest phoneme of the batch set the time of the launch (~8 us
// whatever the bytes, 146 us with a 1000-frame phoneme a row), and a long
// phoneme was read by one SM.  This design cuts every phoneme into pieces
// of at most kPieceFrames frames:
// - A block of 128 threads takes 32 phonemes of one batch row and one
//   channel slice: 4 V's (16 channels as float4, 4 as float) of gx or of
//   the 8 tracks of gf, so the tracks are one more slice (two as float) of
//   the same launch.  The grid is (phoneme groups, slices, B): a long
//   phoneme is read by H/16 + 1 blocks at once, one per slice.
// - Each warp reads the block's 32 (start, stop) pairs, one a lane, and
//   scans their piece counts (no shared memory, no barrier).  A round gives
//   each of the block's 32 lane groups (4 lanes, one V each) one piece: a
//   ballot over the scan finds its phoneme, and its <= kPieceFrames loads
//   are all issued before the first add.  So a thread's chain of dependent
//   loads is one round trip a round, whatever the duration; a block takes
//   ceil(pieces / 32) rounds: one for phonemes of up to 12 frames (the
//   training path's durations), four for a row whose 1000-frame phoneme
//   fills M = 1024.
// - A phoneme of one piece is written by its lane group.  The pieces of a
//   longer one go through shared memory: the lane group holding its last
//   piece in a round sums, in piece order, the partial carried from the
//   previous round (double-buffered) and this round's pieces, and either
//   writes the row or carries the sum on.  Blocks with no such phoneme
//   skip the barriers.
// The order of every sum is fixed (frames in order within a piece, pieces
// in order), with no atomics, so two launches give equal bits.  Pieces of
// 12 frames, 16-channel slices and 128 threads timed best on the card among
// 6-16 frames, 8-32 channels and 128-512 threads; loading the next round
// while summing this one doubled the registers and was slower.

constexpr int kBwdThreads = 128;                // 4 warps
constexpr int kBwdPhonemes = 32;                // phonemes a block: one a lane
constexpr int kSlice = 4;                       // V's of a row a lane group covers
constexpr int kGroups = kBwdThreads / kSlice;   // lane groups: pieces a round
constexpr int kPieceFrames = 12;                // frames of a piece at most

__device__ __forceinline__ float vadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}
template <typename V> __device__ __forceinline__ V vzero();
template <> __device__ __forceinline__ float vzero<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 vzero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// V = float4 (H % 4 == 0, aligned rows) or float.  hv, fv: the row widths of
// gx and gf in V's; slices = gx_slices + ceil(fv / kSlice), where gx_slices =
// ceil(hv / kSlice) take gx and the rest gf.
template <typename V>
__global__ void __launch_bounds__(kBwdThreads)
lr_fused_bwd_kernel(const int* __restrict__ ends, const V* __restrict__ gx,
                    const V* __restrict__ gf, V* __restrict__ gxout, V* __restrict__ gfout,
                    int T, int M, int hv, int fv, int gx_slices, int slices) {
  __shared__ V slot[kGroups][kSlice];
  __shared__ V carry[2][kSlice];
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int kGroupsPerWarp = 32 / kSlice;
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * kBwdPhonemes;
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x / kSlice;        // lane group: piece g of each round
  const int c = threadIdx.x % kSlice;        // its V within the slice
  const int sub = lane / kSlice;             // the group within the warp
  const V zero = vzero<V>();

  // phoneme t0 + lane: its frames [start, stop) and its pieces, scanned
  const int* e = ends + (size_t)b * T;
  const int t = t0 + lane;
  int start = 0, stop = 0;
  if (t < T) {
    stop = min(__ldg(e + t), M);
    start = min(t > 0 ? __ldg(e + t - 1) : 0, stop);
  }
  const int n = (stop - start + kPieceFrames - 1) / kPieceFrames;
  int end = n;  // one past the phoneme's last piece
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, end, o);
    if (lane >= o) end += y;
  }
  const int pieces = __shfl_sync(kFull, end, 31);
  const bool combine = __any_sync(kFull, n > 1);  // the same in every warp

  for (int s = blockIdx.y; s < slices; s += gridDim.y) {
    const bool tracks = s >= gx_slices;
    const int width = tracks ? fv : hv;
    const int col = (tracks ? s - gx_slices : s) * kSlice + c;
    const bool col_ok = col < width;
    const V* src = (tracks ? gf : gx) + (size_t)b * M * width + col;
    V* dst = (tracks ? gfout : gxout) + (size_t)b * T * width + col;
    // no frame: exact zeros (lane group g takes phoneme t0 + g)
    if (__shfl_sync(kFull, n, g % 32) == 0 && g < kBwdPhonemes && t0 + g < T && col_ok)
      dst[(size_t)(t0 + g) * width] = zero;

    for (int r0 = 0; r0 < pieces; r0 += kGroups) {
      const int k = r0 + g;
      int p = 0;  // the phoneme of piece k: how many phonemes end at or before it
#pragma unroll
      for (int q = 0; q < kGroupsPerWarp; ++q) {
        const int pq = __popc(__ballot_sync(kFull, end <= r0 + (g - sub) + q));
        if (q == sub) p = pq;
      }
      const bool has = k < pieces;  // then p < 32
      const int p_start = __shfl_sync(kFull, start, p & 31);
      const int p_stop = __shfl_sync(kFull, stop, p & 31);
      const int p_end = __shfl_sync(kFull, end, p & 31);
      const int p_first = p_end - __shfl_sync(kFull, n, p & 31);
      const int j0 = p_start + (k - p_first) * kPieceFrames;
      const int nj = has && col_ok ? min(kPieceFrames, p_stop - j0) : 0;
      V v[kPieceFrames];
#pragma unroll
      for (int i = 0; i < kPieceFrames; ++i)
        v[i] = i < nj ? __ldg(src + (size_t)(j0 + i) * width) : zero;
      V acc = v[0];
#pragma unroll
      for (int i = 1; i < kPieceFrames; ++i) acc = vadd(acc, v[i]);
      const bool alone = p_end - p_first == 1;
      if (has && alone && col_ok) dst[(size_t)(t0 + p) * width] = acc;
      if (!combine) continue;
      // phonemes of several pieces, through shared memory
      if (has && !alone) slot[g][c] = acc;
      __syncthreads();
      const int last = min(p_end, r0 + kGroups) - 1;  // its last piece in this round
      if (has && !alone && k == last) {
        const int round = r0 / kGroups;
        const bool carried = p_first < r0;
        V sum = carried ? carry[round & 1][c] : slot[p_first - r0][c];
#pragma unroll 8
        for (int kk = carried ? r0 : p_first + 1; kk <= last; ++kk)
          sum = vadd(sum, slot[kk - r0][c]);
        if (p_end > r0 + kGroups) carry[(round + 1) & 1][c] = sum;
        else if (col_ok) dst[(size_t)(t0 + p) * width] = sum;
      }
      __syncthreads();
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
  const int hv = vec ? H / 4 : H;
  const int fv = vec ? kTracks / 4 : kTracks;
  const int gx_slices = (hv + kSlice - 1) / kSlice;
  const int slices = gx_slices + (fv + kSlice - 1) / kSlice;
  const dim3 grid((T + kBwdPhonemes - 1) / kBwdPhonemes, slices < 65535 ? slices : 65535, B);
  if (vec) {
    lr_fused_bwd_kernel<float4><<<grid, kBwdThreads, 0, stream>>>(
        ends, reinterpret_cast<const float4*>(gx), reinterpret_cast<const float4*>(gf),
        reinterpret_cast<float4*>(gxout), reinterpret_cast<float4*>(gfout), T, M, hv, fv,
        gx_slices, slices);
  } else {
    lr_fused_bwd_kernel<float><<<grid, kBwdThreads, 0, stream>>>(
        ends, gx, gf, gxout, gfout, T, M, hv, fv, gx_slices, slices);
  }
  return static_cast<int>(cudaGetLastError());
}
