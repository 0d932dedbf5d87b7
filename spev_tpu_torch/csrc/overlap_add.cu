// K3: windowed-frame overlap-add with COLA normalisation, for Hopper (sm_90a).
//
// Replaces spev_tpu/ops/pallas/kernels.py:_ola_kernel.  With k = n_fft / hop,
// sample o of output row r (sample r*hop + o) is
//
//   out = sum_{d=0..k-1, 0 <= r-d < T} frames[r-d, d*hop + o]
//         / max(sum_{same d} window[d*hop + o]^2, 1e-8)
//
// The Pallas kernel took the window-square sum from a host constant of the
// Hann window and assembled polyphase row blocks with k DMAs.  Here the
// squares come from the window argument (the two agree for Hann).  Both
// sums run in the fixed order d = 0..k-1 over the in-range frames, with
// adds and products rounded separately (no FMA contraction) and an IEEE
// division, as the plain PyTorch version (spev_tpu_torch/ops/cuda/kernels.py)
// rounds them, so the result is bit-equal to it.
//
// Bound: data movement.  Each frame value is read once and each output
// written once: at T = 2048 frames of 1024, 8.4 MB read and 2.1 MB written,
// 3.1 us at 3.35 TB/s; at the Griffin-Lim path's T = 512, 0.8 us, under the
// ~1 us a launch of the least kernel takes.  So on the path the time is the
// chain of dependent steps in a thread, and at the bench shape the bytes.
//
// The first design (one thread per sample, 515 blocks at T = 512) lost time
// to a run-time division s / hop per sample, a loop over a run-time k with a
// branch a step, 4-byte loads, and a reload and square of window[c] for
// every contribution.  This one:
// - Each thread takes four consecutive samples of one output row, with
//   16-byte loads and stores: hop % 4 == 0, so the offsets o..o+3 of a row
//   are contiguous in every frame row and a group never crosses a row.
// - Row and offset come from the grid and the block (threadIdx.y, blockIdx.x
//   for the row; threadIdx.x, blockIdx.y for the 4-sample group): no
//   division per sample.
// - (hop, k) = (256, 4) and (128, 4), the configurations' n_fft 1024 and
//   512, are fixed at compile time: a block of 128 threads is hop/4
//   threads wide, the k frame loads and the k window loads are unrolled and
//   all issued before the first add.
// - Each thread reads the k window values it needs (16 bytes each; the
//   window's 4 KB stay in L1 and L2) and squares them.  Squares computed
//   once per block into shared memory cost a barrier and were slower on
//   the card.
// - A scalar body (one sample a thread, row and offset from the grid too)
//   takes every other case: another (n_fft, hop), or pointers that are not
//   16-byte aligned.  The wrapper decides, as K1's does.

#include <cuda_runtime.h>

namespace {

constexpr int kRowThreads = 128;  // threads a block in the vector body
constexpr int kThreads = 256;     // threads a block in the scalar body
constexpr int kScalarWidth = 64;  // of them along the row

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 square4(float4 w) {
  return make_float4(__fmul_rn(w.x, w.x), __fmul_rn(w.y, w.y), __fmul_rn(w.z, w.z),
                     __fmul_rn(w.w, w.w));
}

__device__ __forceinline__ float4 normalise4(float4 a, float4 s) {
  return make_float4(a.x / fmaxf(s.x, 1e-8f), a.y / fmaxf(s.y, 1e-8f), a.z / fmaxf(s.z, 1e-8f),
                     a.w / fmaxf(s.w, 1e-8f));
}

// The block is (kHop/4, kRowThreads/(kHop/4)): one block column per row.
template <int kHop, int kK>
__global__ void __launch_bounds__(kRowThreads)
ola_vec_kernel(const float4* __restrict__ frames, const float4* __restrict__ window,
               float4* __restrict__ out, int T) {
  constexpr int hop4 = kHop / 4;
  constexpr int nfft4 = hop4 * kK;
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= T + kK - 1) return;
  const int q = threadIdx.x;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 v[kK], w[kK];
#pragma unroll
  for (int d = 0; d < kK; ++d) {
    const int f = r - d;
    v[d] = f >= 0 && f < T ? __ldg(frames + (size_t)f * nfft4 + d * hop4 + q) : zero4;
    w[d] = __ldg(window + d * hop4 + q);
  }
  float4 acc = zero4, ws = zero4;
#pragma unroll
  for (int d = 0; d < kK; ++d) {
    const int f = r - d;
    if (f >= 0 && f < T) {
      acc = add4(acc, v[d]);
      ws = add4(ws, square4(w[d]));
    }
  }
  out[(size_t)r * hop4 + q] = normalise4(acc, ws);
}

// One sample a thread; the block is (kScalarWidth, kThreads/kScalarWidth)
// and blockIdx.y strides the row.
__global__ void __launch_bounds__(kThreads)
ola_scalar_kernel(const float* __restrict__ frames, const float* __restrict__ window,
                  float* __restrict__ out, int T, int n_fft, int hop, int k) {
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= T + k - 1) return;
  const int d0 = max(0, r - T + 1), d1 = min(k, r + 1);
  for (int o = blockIdx.y * blockDim.x + threadIdx.x; o < hop; o += gridDim.y * blockDim.x) {
    float acc = 0.f, ws = 0.f;
    for (int d = d0; d < d1; ++d) {
      const int c = d * hop + o;
      acc = __fadd_rn(acc, __ldg(frames + (size_t)(r - d) * n_fft + c));
      const float w = __ldg(window + c);
      ws = __fadd_rn(ws, __fmul_rn(w, w));
    }
    out[(size_t)r * hop + o] = acc / fmaxf(ws, 1e-8f);
  }
}

template <int kHop, int kK>
int launch_vec(const float* frames, const float* window, float* out, int T,
               cudaStream_t stream) {
  constexpr int width = kHop / 4;
  constexpr int rows_per_block = kRowThreads / width;
  const int rows = T + kK - 1;
  const dim3 block(width, rows_per_block);
  const dim3 grid((rows + rows_per_block - 1) / rows_per_block);
  ola_vec_kernel<kHop, kK><<<grid, block, 0, stream>>>(
      reinterpret_cast<const float4*>(frames), reinterpret_cast<const float4*>(window),
      reinterpret_cast<float4*>(out), T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// frames (T, n_fft) f32, window (n_fft,) f32 -> out (n_fft + hop*(T-1),) f32.
// Requires hop | n_fft.  vec != 0 takes the vector body, which requires
// (hop, n_fft) = (256, 1024) or (128, 512) and 16-byte-aligned pointers;
// otherwise the scalar body.  Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for vec with another hop.
extern "C" int overlap_add_forward(const float* frames, const float* window, float* out,
                                   int T, int n_fft, int hop, int vec, cudaStream_t stream) {
  const int k = n_fft / hop;
  if (vec) {
    if (hop == 256 && k == 4) return launch_vec<256, 4>(frames, window, out, T, stream);
    if (hop == 128 && k == 4) return launch_vec<128, 4>(frames, window, out, T, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int rows_per_block = kThreads / kScalarWidth;
  const int rows = T + k - 1;
  const int chunks = (hop + kScalarWidth - 1) / kScalarWidth;
  const dim3 block(kScalarWidth, rows_per_block);
  const dim3 grid((rows + rows_per_block - 1) / rows_per_block, chunks < 65535 ? chunks : 65535);
  ola_scalar_kernel<<<grid, block, 0, stream>>>(frames, window, out, T, n_fft, hop, k);
  return static_cast<int>(cudaGetLastError());
}
