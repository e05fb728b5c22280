// Kernel A: fused constant-R Kalman filter log-likelihood, plain and paired.
//
// Replaces: eks_tpu/ops/pallas_nll.py::_make_fused_kernel (plain and
// paired=True), the s-optimizer's loss, reached through
// filter_nll_fused_batched.
//
// Per lane (one thread block each) it returns the marginal log-likelihood of
// a linear Kalman filter with constant diagonal R. The only T-sized input is
// y (N, O, T); every filtering element is built on the fly from y_t and the
// lane's scalar table (N, n_scal), whose layout is ops/pkalman.py::
// _scalar_offsets (46 floats at D = O = 2, 109 at D = 3, O = 4) and which is
// staged in shared memory. Instances: (D, O) = (2, 2), the singlecam family,
// and (3, 4), (3, 6), (3, 8), the linear multi-camera family with two to four
// cameras. Each of the NT threads owns one contiguous chunk of time steps:
//   pass 1   build the chunk's elements and fold them into the chunk total;
//   phase 2  exclusive prefix of the chunk totals across the block
//            (filter_algebra.cuh::block_exclusive_scan);
//   pass 3   re-walk the chunk with the carry as the t-1 filtered posterior:
//            evaluate each step's predictive moments, the unrolled O x O
//            innovation Cholesky and the log-density, then absorb the step's
//            element into the carry;
// then the per-thread sums reduce across the block in a fixed tree order, so
// the result is deterministic. Steps at or beyond T belong to no chunk: no
// padded step is built, and none can add a NaN to the sum.
//
// The paired form runs the same build, combine and epilogue on Dual numbers
// (value, tangent), the table's tangent d(table)/d(log s) supplied by the
// caller; one launch returns (ll, d ll / d log s) per lane.
//
// Bound on the H100: the function reads y once, N * O * T * 4 bytes (1.6 MB
// at N = 20, O = 2, T = 10,000, about 0.48 us at 3.35 TB/s), and needs one
// Kalman step per time step, about 130 FP32 operations (about 400 on Dual
// numbers); so bytes bound the plain form and operations (about 1.2 us at
// 67 TFLOP/s) the paired one. This kernel does about three times that work
// (two element builds, two combines and one epilogue per step) and runs each
// chunk sequentially, so it sits far above the bound. N = 20 blocks fill only
// 20 of the 132 SMs; spreading a lane over several blocks is left for a later
// change. At D = 3 an element is 33 floats (66 as Dual), so those instances
// sit at the register limit; the block scan's buffer (67.6 KB paired) is
// dynamic shared memory, opted in per launch.
#include "filter_algebra.cuh"

namespace {

constexpr int NT = 256;

template <int D, int O>
struct Layout {
  static constexpr int DD = D * D;
  static constexpr int A_EL = 0;
  static constexpr int K_C = A_EL + DD;
  static constexpr int C_EL = K_C + D * O;
  static constexpr int M_CT = C_EL + DD;
  static constexpr int J_EL = M_CT + D * O;
  static constexpr int B_FIRST = J_EL + DD;
  static constexpr int C_FIRST = B_FIRST + D;
  static constexpr int A = C_FIRST + DD;
  static constexpr int Q = A + DD;
  static constexpr int COBS = Q + DD;
  static constexpr int R = COBS + O * D;
  static constexpr int M0 = R + O;
  static constexpr int S0 = M0 + D;
  static constexpr int N_SCAL = S0 + DD;
};

// one step's filtering element (t0: the first step, which assimilates y_0
// against the prior with no transition)
template <typename S, int D, int O>
__device__ __forceinline__ eks::FilterElem<S, D> build(const S* tab, const float (&yv)[O], bool t0) {
  using Lt = Layout<D, O>;
  using Sc = eks::Scalar<S>;
  eks::FilterElem<S, D> e;
  if (t0) {
#pragma unroll
    for (int k = 0; k < D * D; ++k) {
      e.x[k] = Sc::c(0.f);
      e.x[D * D + D + k] = tab[Lt::C_FIRST + k];
      e.x[2 * D * D + 2 * D + k] = Sc::c(0.f);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      e.b(d) = tab[Lt::B_FIRST + d];
      e.eta(d) = Sc::c(0.f);
    }
    return e;
  }
#pragma unroll
  for (int k = 0; k < D * D; ++k) {
    e.x[k] = tab[Lt::A_EL + k];
    e.x[D * D + D + k] = tab[Lt::C_EL + k];
    e.x[2 * D * D + 2 * D + k] = tab[Lt::J_EL + k];
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    S b = tab[Lt::K_C + d * O] * Sc::c(yv[0]);
    S n = tab[Lt::M_CT + d * O] * Sc::c(yv[0]);
#pragma unroll
    for (int o = 1; o < O; ++o) {
      b = b + tab[Lt::K_C + d * O + o] * Sc::c(yv[o]);
      n = n + tab[Lt::M_CT + d * O + o] * Sc::c(yv[o]);
    }
    e.b(d) = b;
    e.eta(d) = n;
  }
  return e;
}

template <typename S, int D, int O>
__global__ void __launch_bounds__(NT) fused_nll_kernel(const float* __restrict__ y,
                                                       const float* __restrict__ table,
                                                       const float* __restrict__ dtable,
                                                       float* __restrict__ out, int N, int T) {
  using Lt = Layout<D, O>;
  using Sc = eks::Scalar<S>;
  using Elem = eks::FilterElem<S, D>;
  constexpr int W = Sc::W;
  __shared__ S tab[Lt::N_SCAL];
  __shared__ float red[W * NT];
  extern __shared__ float smem[];  // W * Elem::P * NT floats

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  for (int k = tid; k < Lt::N_SCAL; k += NT) {
    const size_t i = (size_t)lane * Lt::N_SCAL + k;
    tab[k] = Sc::make(table[i], dtable != nullptr ? dtable[i] : 0.f);
  }
  __syncthreads();

  const float* yl = y + (size_t)lane * O * T;
  const int L = (T + NT - 1) / NT;
  const int lo = min(tid * L, T);
  const int hi = min(lo + L, T);

  // pass 1: chunk total
  Elem carry = eks::identity<S, D>();
  for (int t = lo; t < hi; ++t) {
    float yv[O];
#pragma unroll
    for (int o = 0; o < O; ++o) yv[o] = yl[(size_t)o * T + t];
    const Elem e = build<S, D, O>(tab, yv, t == 0);
    carry = t == lo ? e : eks::combine<S, D>(carry, e);
  }

  // phase 2: combination of every earlier chunk (the identity for chunk 0)
  carry = eks::block_exclusive_scan<S, D, NT>(carry, smem);

  // pass 3: carry the posterior through the chunk, summing log-densities
  S rv[O];
#pragma unroll
  for (int o = 0; o < O; ++o) rv[o] = tab[Lt::R + o];
  S acc = Sc::c(0.f);
  for (int t = lo; t < hi; ++t) {
    float yv[O];
#pragma unroll
    for (int o = 0; o < O; ++o) yv[o] = yl[(size_t)o * T + t];
    acc = acc + eks::innovation_logpdf<S, S, D, O>(carry, tab + Lt::A, tab + Lt::Q, tab + Lt::COBS,
                                                   tab + Lt::M0, tab + Lt::S0, rv, yv, t == 0);
    carry = eks::combine<S, D>(carry, build<S, D, O>(tab, yv, t == 0));
  }

  // fixed-order tree reduction over the block
  eks::block_sum_to<S, NT>(acc, red, out, lane, N);
}

template <typename S, int D, int O>
int launch_shape(const float* y, const float* table, const float* dtable, float* out, int N, int T,
                 cudaStream_t s) {
  auto kernel = fused_nll_kernel<S, D, O>;
  // the block scan's buffer passes 48 KB in the paired form at D = 3: opt in
  const int scan_bytes = eks::Scalar<S>::W * eks::FilterElem<S, D>::P * NT * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, scan_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<N, NT, scan_bytes, s>>>(y, table, dtable, out, N, T);
  return (int)cudaGetLastError();
}

template <typename S>
int launch(const float* y, const float* table, const float* dtable, float* out, int N, int T, int D,
           int O, void* stream) {
  if (N <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 2 && O == 2) return launch_shape<S, 2, 2>(y, table, dtable, out, N, T, s);
  if (D == 3 && O == 4) return launch_shape<S, 3, 4>(y, table, dtable, out, N, T, s);
  if (D == 3 && O == 6) return launch_shape<S, 3, 6>(y, table, dtable, out, N, T, s);
  if (D == 3 && O == 8) return launch_shape<S, 3, 8>(y, table, dtable, out, N, T, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// y: (N, O, T); table: (N, n_scal); out: (N,). float32, contiguous.
// Returns the CUDA error of the launch (0 on success); an unsupported (D, O)
// returns cudaErrorInvalidValue without launching.
extern "C" int fused_nll_f32(const float* y, const float* table, float* out, int N, int T, int D,
                             int O, void* stream) {
  return launch<float>(y, table, nullptr, out, N, T, D, O, stream);
}

// As fused_nll_f32, with dtable (N, n_scal) the table's tangent; out is
// (2, N): row 0 the log-likelihoods, row 1 their derivatives.
extern "C" int fused_nll_paired_f32(const float* y, const float* table, const float* dtable,
                                    float* out, int N, int T, int D, int O, void* stream) {
  return launch<eks::Dual>(y, table, dtable, out, N, T, D, O, stream);
}
