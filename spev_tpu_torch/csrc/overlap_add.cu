// K3: windowed-frame overlap-add with COLA normalisation, for Hopper (sm_90a).
//
// Replaces spev_tpu/ops/pallas/kernels.py:_ola_kernel.  With k = n_fft / hop,
// output sample s (row r = s / hop, offset o = s % hop) is
//
//   out[s] = sum_{d=0..k-1, 0 <= r-d < T} frames[r-d, d*hop + o]
//            / max(sum_{same d} window[d*hop + o]^2, 1e-8)
//
// The Pallas kernel took the window-square sum from a host constant and
// assembled polyphase row blocks with k DMAs.  Here one thread computes one
// output sample, summing in the fixed order d = 0..k-1 over the in-range
// frames and accumulating the window-square sum in the same loop from the
// window array, so no host constant is needed.  Adds and products are
// rounded separately (no FMA contraction), as the plain PyTorch version
// (spev_tpu_torch/ops/cuda/kernels.py) rounds them.
//
// Bound: data movement.  Each frame value is read once and each output
// written once: at T = 2048 frames of 1024, 8.4 MB read and 2.1 MB written,
// 3.1 us at 3.35 TB/s.  Neighbouring threads take neighbouring samples, so
// for each d a warp reads 32 consecutive floats of one frame row: every load
// and store is coalesced, and nothing is read twice from device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
overlap_add_kernel(const float* __restrict__ frames, const float* __restrict__ window,
                   float* __restrict__ out, int T, int n_fft, int hop, int out_len) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= out_len) return;
  const int r = s / hop;
  const int o = s - r * hop;
  const int k = n_fft / hop;
  float acc = 0.f, wsq = 0.f;
  for (int d = 0; d < k; ++d) {
    const int f = r - d;
    if (f < 0 || f >= T) continue;
    const int c = d * hop + o;
    acc = __fadd_rn(acc, frames[(size_t)f * n_fft + c]);
    const float w = window[c];
    wsq = __fadd_rn(wsq, __fmul_rn(w, w));
  }
  out[s] = acc / fmaxf(wsq, 1e-8f);
}

}  // namespace

// frames (T, n_fft) f32, window (n_fft,) f32 -> out (n_fft + hop*(T-1),) f32.
// Requires hop | n_fft.  Launches on `stream`; returns cudaGetLastError().
extern "C" int overlap_add_forward(const float* frames, const float* window, float* out,
                                   int T, int n_fft, int hop, cudaStream_t stream) {
  const int out_len = n_fft + hop * (T - 1);
  const int blocks = (out_len + kThreads - 1) / kThreads;
  overlap_add_kernel<<<blocks, kThreads, 0, stream>>>(frames, window, out, T, n_fft, hop,
                                                      out_len);
  return static_cast<int>(cudaGetLastError());
}
