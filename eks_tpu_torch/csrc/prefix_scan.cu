// Kernels B and D: inclusive scans of Kalman filtering and RTS smoothing
// elements over N lanes, on plain floats or on (primal, tangent) pairs.
//
// Replaces, in eks_tpu/ops/pallas_filter.py:
//   _make_scan_kernel with _filter_algebra     (kernel B: the forward filter
//       of the final smoothing pass, through filter_prefix_pallas);
//   _make_scan_kernel with _smoother_algebra   (kernel B: the backward RTS
//       pass, through smoother_suffix_pallas);
//   either with _paired_algebra                (the scan's JVP: primal and
//       tangent planes through one launch);
//   _make_scan_kernel_batched, plain and paired (kernel D: the same scans
//       over N lanes in one launch, the staged optimizer loss at O > 8).
// One kernel template covers all of them: <Algebra> picks the element, its
// combine and the scan direction, its scalar type (float or Dual) picks plain
// or paired, and the grid holds the lanes, one thread block each. So the
// single-lane kernels are N = 1 of the lane-batched ones.
//
// Input and output are (N, W * P, T) float32 planes, W = 1 for float and 2
// for Dual (the P primal planes, then the P tangent planes). P = 3D² + 2D for
// the filter (16 at D = 2, 33 at D = 3) and 2D² + D for the smoother (10, 21).
// The filter scans forward in time. The smoother scans backward: scan
// position i is time step T-1-i, read and written in place by index, so no
// flipped copy of the planes is ever made, and its combine takes the element
// later in time first.
//
// Each of the NT threads owns one contiguous chunk of ceil(T / NT) scan
// positions:
//   pass 1   the thread folds its chunk sequentially, writing the
//            within-chunk inclusive results to the output;
//   phase 2  a Hillis-Steele sweep over the NT chunk totals in shared memory
//            (filter_algebra.cuh::block_exclusive_scan_of) gives each thread
//            the combination of all chunks before its own;
//   pass 3   the thread folds that exclusive prefix into its stored partials.
// Positions at or beyond T belong to no chunk (a thread whose chunk is empty
// carries the identity), so no padding element is ever read.
//
// Bound on the H100: the scan reads each input plane once and writes each
// output plane once, 2 * N * W * P * T * 4 bytes (25.6 MB for the filter at
// N = 20, D = 2, T = 10,000), against one combine per step (about 150 FP32
// operations for the filter at D = 2, 48 for the smoother); so memory bytes
// bound the float instances, at about 7.6 us at 3.35 TB/s. This version keeps
// the simple chunk-per-thread layout: a thread walks its chunk with a stride
// of one float per plane, so a warp's loads are not coalesced, and the
// partials are written and read back once more in pass 3. N blocks fill N of
// the 132 SMs; spreading a lane over several blocks is left for a later
// change. A D = 3 filter element is 33 floats (66 as Dual) and one combine
// holds three of them, so those instances reach the 255-register limit and
// spill. The block scan's buffer is W * P * NT floats of dynamic shared
// memory (67.6 KB for the paired filter at D = 3), opted in per launch.
#include "filter_algebra.cuh"

namespace {

constexpr int NT = 256;

template <typename Alg>
__global__ void __launch_bounds__(NT) prefix_scan_kernel(const float* __restrict__ in,
                                                         float* __restrict__ out, int T) {
  using Elem = typename Alg::Elem;
  using Sc = eks::Scalar<typename Alg::Scalar>;
  constexpr int P = Alg::P;
  extern __shared__ float smem[];  // Sc::W * P * NT floats

  const size_t tangent = (size_t)P * T;  // from a primal plane to its tangent plane
  const size_t base = (size_t)blockIdx.x * Sc::W * tangent;
  const float* x = in + base;
  float* y = out + base;
  const int L = (T + NT - 1) / NT;
  const int lo = min((int)threadIdx.x * L, T);
  const int hi = min(lo + L, T);

  // pass 1: within-chunk inclusive results
  Elem carry = Alg::identity();
  for (int i = lo; i < hi; ++i) {
    const int t = Alg::REVERSED ? T - 1 - i : i;
    Elem e;
#pragma unroll
    for (int p = 0; p < P; ++p) e.x[p] = Sc::get(x + (size_t)p * T + t, tangent);
    carry = i == lo ? e : Alg::op(carry, e);
#pragma unroll
    for (int p = 0; p < P; ++p) Sc::put(y + (size_t)p * T + t, tangent, carry.x[p]);
  }

  // phase 2: combination of every chunk before this one
  const Elem excl = eks::block_exclusive_scan_of<Alg, NT>(carry, smem);

  // pass 3: fold the earlier chunks into the stored partials
  if (threadIdx.x == 0) return;
  for (int i = lo; i < hi; ++i) {
    const int t = Alg::REVERSED ? T - 1 - i : i;
    Elem e;
#pragma unroll
    for (int p = 0; p < P; ++p) e.x[p] = Sc::get(y + (size_t)p * T + t, tangent);
    e = Alg::op(excl, e);
#pragma unroll
    for (int p = 0; p < P; ++p) Sc::put(y + (size_t)p * T + t, tangent, e.x[p]);
  }
}

template <typename Alg>
int launch(const float* in, float* out, int N, int T, cudaStream_t s) {
  auto kernel = prefix_scan_kernel<Alg>;
  const int bytes = eks::Scalar<typename Alg::Scalar>::W * Alg::P * NT * (int)sizeof(float);
  // the paired filter at D = 3 passes 48 KB: opt in
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<N, NT, bytes, s>>>(in, out, T);
  return (int)cudaGetLastError();
}

template <typename S>
int dispatch(const float* in, float* out, int N, int T, int D, int smoother, cudaStream_t s) {
  // D = 2 (singlecam) and D = 3 (pupil, multi-camera) are instantiated; D = 1
  // comes from the same template once a path needs it
  if (D == 2) {
    return smoother ? launch<eks::SmootherAlgebra<S, 2>>(in, out, N, T, s)
                    : launch<eks::FilterAlgebra<S, 2>>(in, out, N, T, s);
  }
  if (D == 3) {
    return smoother ? launch<eks::SmootherAlgebra<S, 3>>(in, out, N, T, s)
                    : launch<eks::FilterAlgebra<S, 3>>(in, out, N, T, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// in, out: (N, W * P, T) float32 contiguous, distinct buffers; W = 2 with
// `paired` (primal planes, then tangent planes), else 1. `smoother` picks the
// RTS algebra and the backward direction, else the filter algebra forward.
// Returns the CUDA error of the launch (0 on success); an unsupported D
// returns cudaErrorInvalidValue without launching.
extern "C" int prefix_scan_f32(const float* in, float* out, int N, int T, int D, int smoother,
                               int paired, void* stream) {
  if (N <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return paired ? dispatch<eks::Dual>(in, out, N, T, D, smoother, s)
                : dispatch<float>(in, out, N, T, D, smoother, s);
}
