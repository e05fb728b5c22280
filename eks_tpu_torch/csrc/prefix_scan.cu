// Kernel B: inclusive prefix scan of Kalman filtering elements.
//
// Replaces: eks_tpu/ops/pallas_filter.py::_make_scan_kernel with the filter
// algebra (reached through filter_prefix_pallas from
// pkalman.kalman_filter_parallel, the forward filter of the final smoothing
// pass).
//
// Input and output are (N, P, T) float32 planes, P = 3D² + 2D (16 at D = 2,
// the singlecam family's; 33 at D = 3, the pupil family's), one lane per
// thread block. Each of the NT threads owns one contiguous chunk
// of ceil(T / NT) time steps:
//   pass 1   the thread folds its chunk sequentially, writing the
//            within-chunk inclusive prefixes to the output;
//   phase 2  a Hillis-Steele sweep over the NT chunk totals in shared memory
//            (filter_algebra.cuh::block_exclusive_scan) gives each thread the
//            combination of all earlier chunks;
//   pass 3   the thread folds that exclusive prefix into its stored partials.
// Steps at or beyond T belong to no chunk (a thread whose chunk is empty
// carries the identity), so no padding element is ever read.
//
// Bound on the H100: the scan reads each input plane once and writes each
// output plane once, 2 * N * P * T * 4 bytes (25.6 MB at N = 20, T = 10,000),
// against one combine of ~150 FP32 operations per step; so memory bytes
// bound it, at about 7.6 us at 3.35 TB/s. This first version keeps the
// simple chunk-per-thread layout: a thread walks its chunk with a stride of
// one float per plane, so a warp's loads are not coalesced, and the
// partials are written and read back once more in pass 3. N = 20 blocks fill
// only 20 of the 132 SMs; spreading a lane over several blocks is left for a
// later change. At D = 3 an element is 33 floats and one combine holds three
// of them, so the compiler reaches the 255-register limit and spills a few
// words; the pupil family gives the kernel one lane (or one per session).
#include "filter_algebra.cuh"

namespace {

constexpr int NT = 256;

template <int D>
__global__ void __launch_bounds__(NT) prefix_scan_filter_kernel(const float* __restrict__ in,
                                                                float* __restrict__ out, int T) {
  using Elem = eks::FilterElem<float, D>;
  constexpr int P = Elem::P;
  __shared__ float smem[P * NT];

  const size_t base = (size_t)blockIdx.x * P * T;
  const float* x = in + base;
  float* y = out + base;
  const int L = (T + NT - 1) / NT;
  const int lo = min((int)threadIdx.x * L, T);
  const int hi = min(lo + L, T);

  // pass 1: within-chunk inclusive prefixes
  Elem carry = eks::identity<float, D>();
  for (int t = lo; t < hi; ++t) {
    Elem e;
#pragma unroll
    for (int p = 0; p < P; ++p) e.x[p] = x[(size_t)p * T + t];
    carry = t == lo ? e : eks::combine<float, D>(carry, e);
#pragma unroll
    for (int p = 0; p < P; ++p) y[(size_t)p * T + t] = carry.x[p];
  }

  // phase 2: exclusive prefix of the chunk totals
  const Elem excl = eks::block_exclusive_scan<float, D, NT>(carry, smem);

  // pass 3: fold the earlier chunks into the stored partials
  if (threadIdx.x == 0) return;
  for (int t = lo; t < hi; ++t) {
    Elem e;
#pragma unroll
    for (int p = 0; p < P; ++p) e.x[p] = y[(size_t)p * T + t];
    e = eks::combine<float, D>(excl, e);
#pragma unroll
    for (int p = 0; p < P; ++p) y[(size_t)p * T + t] = e.x[p];
  }
}

}  // namespace

// in, out: (N, P, T) float32 contiguous, distinct buffers. Returns the CUDA
// error of the launch (0 on success); an unsupported D returns
// cudaErrorInvalidValue without launching.
extern "C" int prefix_scan_filter_f32(const float* in, float* out, int N, int T, int D,
                                      void* stream) {
  if (N <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // D = 2 (singlecam) and D = 3 (pupil) are instantiated; D = 1 comes from
  // the same template once a path needs it
  if (D == 2) {
    prefix_scan_filter_kernel<2><<<N, NT, 0, s>>>(in, out, T);
  } else if (D == 3) {
    prefix_scan_filter_kernel<3><<<N, NT, 0, s>>>(in, out, T);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
