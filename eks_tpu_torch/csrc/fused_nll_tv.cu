// Kernel C: fused Kalman filter log-likelihood with time-varying diagonal R,
// plain and paired.
//
// Replaces: eks_tpu/ops/pallas_nll.py::_make_fused_kernel_tv (plain and
// paired=True), the loss of the pupil optimizer and of its sessions twin,
// reached through filter_nll_fused_tv_batched.
//
// Per lane (one thread block each) it returns the marginal log-likelihood of
// a linear Kalman filter whose observation noise R_t = diag(r_t) changes
// every step. The T-sized input is yr (N, 2O, T): the O observation planes,
// then the O noise planes. Everything else is the lane's scalar table
// (N, n_scal), whose layout is ops/pkalman.py::_scalar_offsets_tv (84 floats
// at D = 3, O = 8), staged in shared memory. The three passes are kernel A's
// (fused_nll.cu): each of the NT threads owns one contiguous chunk of steps,
// folds its elements into a chunk total, takes the exclusive prefix of the
// totals across the block, and re-walks its chunk with the carry as the t-1
// posterior, summing the log-densities; the block sum is a fixed tree. A
// thread whose chunk lies past T owns no step, so no padded step exists.
//
// What differs from kernel A is the element build. R_t is not constant, so
// no element matrix can be precomputed: each step builds its element in the
// information form (ops/pkalman.py::_table_planes_tv, term for term),
//   W = Cᵀ R_t⁻¹ C,  v = Cᵀ R_t⁻¹ y_t,  M = (Q⁻¹ + W)⁻¹,
//   A_el = M Q⁻¹A,  b = M v,  C_el = M,
//   eta = Aᵀ (v - W b),  J = Aᵀ (W - W M W) A,
// which costs one closed-form D x D inverse in place of the covariance
// form's O x O solve. Step 0 assimilates y_0 against the prior: the same
// inverse with S0⁻¹ selected in the place of Q⁻¹ (by global index), S0⁻¹ m0
// added to v, and A_el, eta and J zero. The log-density keeps the covariance
// form: S_t = C P_pred Cᵀ + R_t and its unrolled O x O Cholesky
// (filter_algebra.cuh::innovation_logpdf). With 1/r as large as 1e12 a
// determinant-lemma epilogue in D x D would cancel badly.
//
// The paired form runs build, combine and epilogue on Dual numbers (value,
// tangent) along the table's tangent, which the caller supplies; y and r
// carry no tangent. One launch returns (ll, d ll) per lane.
//
// Bound on the H100: the function reads yr once, N * 2O * T * 4 bytes
// (1.28 MB at N = 2, O = 8, T = 10,000; 0.38 us at 3.35 TB/s), and needs one
// Kalman step with an 8 x 8 Cholesky per time step, about 1,500 FP32
// operations (about 4,600 on Dual numbers: 0.44 us and 1.4 us at 67 TFLOP/s
// for two lanes); so operations bound both forms, the plain one narrowly.
// The kernel sits far above that (0.32 ms plain, 0.85 ms paired): the pupil
// optimizer gives it two lanes, so two of the 132 SMs work; each thread
// walks its chunk sequentially, building every element twice; and a D = 3
// element is 33 floats (66 as Dual) beside the 36-entry Cholesky factor, more
// than a thread's 255 registers, so the paired form spills about 1.2 KB a
// thread to local memory (the plain form takes 222 registers and spills
// nothing). Spreading a lane over several blocks and staging the factor in
// shared memory are left for a later change.
#include "filter_algebra.cuh"

namespace {

constexpr int NT = 256;

template <int D, int O>
struct LayoutTv {
  static constexpr int DD = D * D;
  static constexpr int QI = 0;
  static constexpr int QIA = QI + DD;
  static constexpr int S0I = QIA + DD;
  static constexpr int S0I_M0 = S0I + DD;
  static constexpr int A = S0I_M0 + D;
  static constexpr int Q = A + DD;
  static constexpr int COBS = Q + DD;
  static constexpr int M0 = COBS + O * D;
  static constexpr int S0 = M0 + D;
  static constexpr int N_SCAL = S0 + DD;
};

// one step's filtering element in the information form (t0: the first step)
template <typename S, int D, int O>
__device__ __forceinline__ eks::FilterElem<S, D> build_tv(const S* tab, const float (&yv)[O],
                                                          const float (&rv)[O], bool t0) {
  using Lt = LayoutTv<D, O>;
  using Sc = eks::Scalar<S>;
  const S* Cm = tab + Lt::COBS;
  const S* Am = tab + Lt::A;
  float ri[O];
#pragma unroll
  for (int o = 0; o < O; ++o) ri[o] = 1.0f / rv[o];

  // W = Cᵀ R⁻¹ C (symmetric: the upper triangle, mirrored), v = Cᵀ R⁻¹ y
  S Wt[D][D], v[D];
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int b = a; b < D; ++b) {
      S s = Cm[a] * Cm[b] * ri[0];
#pragma unroll
      for (int o = 1; o < O; ++o) s = s + Cm[o * D + a] * Cm[o * D + b] * ri[o];
      Wt[a][b] = s;
      Wt[b][a] = s;
    }
    S s = Cm[a] * ri[0] * yv[0];
#pragma unroll
    for (int o = 1; o < O; ++o) s = s + Cm[o * D + a] * ri[o] * yv[o];
    v[a] = s;
  }

  // M = (W + Q⁻¹)⁻¹, or (W + S0⁻¹)⁻¹ at the first step
  const S* prior = tab + (t0 ? (int)Lt::S0I : (int)Lt::QI);
  S Min[D][D], M[D][D];
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = 0; b < D; ++b) Min[a][b] = Wt[a][b] + prior[a * D + b];
  eks::small_inv<S, D>(Min, M);

  eks::FilterElem<S, D> e;
  // b = M (v + S0⁻¹ m0 at the first step), C_el = M
  S bel[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    S s = Sc::c(0.f);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const S vk = t0 ? v[k] + tab[Lt::S0I_M0 + k] : v[k];
      s = k == 0 ? M[i][0] * vk : s + M[i][k] * vk;
    }
    bel[i] = s;
    e.b(i) = s;
#pragma unroll
    for (int j = 0; j < D; ++j) e.C(i, j) = M[i][j];
  }
  if (t0) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      e.eta(i) = Sc::c(0.f);
#pragma unroll
      for (int j = 0; j < D; ++j) {
        e.A(i, j) = Sc::c(0.f);
        e.J(i, j) = Sc::c(0.f);
      }
    }
    return e;
  }

  // A_el = M (Q⁻¹ A)
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S s = M[i][0] * tab[Lt::QIA + j];
#pragma unroll
      for (int k = 1; k < D; ++k) s = s + M[i][k] * tab[Lt::QIA + k * D + j];
      e.A(i, j) = s;
    }
  // eta = Aᵀ (v - W b)
  S w[D];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    S s = Wt[a][0] * bel[0];
#pragma unroll
    for (int k = 1; k < D; ++k) s = s + Wt[a][k] * bel[k];
    w[a] = v[a] - s;
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    S s = Am[i] * w[0];
#pragma unroll
    for (int k = 1; k < D; ++k) s = s + Am[k * D + i] * w[k];
    e.eta(i) = s;
  }
  // J = Aᵀ (W - W M W) A
  S MW[D][D], G[D][D];
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = 0; b < D; ++b) {
      S s = M[a][0] * Wt[0][b];
#pragma unroll
      for (int k = 1; k < D; ++k) s = s + M[a][k] * Wt[k][b];
      MW[a][b] = s;
    }
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = 0; b < D; ++b) {
      S s = Wt[a][0] * MW[0][b];
#pragma unroll
      for (int k = 1; k < D; ++k) s = s + Wt[a][k] * MW[k][b];
      G[a][b] = Wt[a][b] - s;
    }
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S s = Sc::c(0.f);
#pragma unroll
      for (int k = 0; k < D; ++k)
#pragma unroll
        for (int l = 0; l < D; ++l) {
          const S term = Am[k * D + i] * G[k][l] * Am[l * D + j];
          s = (k == 0 && l == 0) ? term : s + term;
        }
      e.J(i, j) = s;
    }
  return e;
}

// the step's observations and noise variances out of the lane's planes
template <int O>
__device__ __forceinline__ void load_step(const float* yrl, int T, int t, float (&yv)[O],
                                          float (&rv)[O]) {
#pragma unroll
  for (int o = 0; o < O; ++o) {
    yv[o] = yrl[(size_t)o * T + t];
    rv[o] = yrl[(size_t)(O + o) * T + t];
  }
}

template <typename S, int D, int O>
__global__ void __launch_bounds__(NT) fused_nll_tv_kernel(const float* __restrict__ yr,
                                                          const float* __restrict__ table,
                                                          const float* __restrict__ dtable,
                                                          float* __restrict__ out, int N, int T) {
  using Lt = LayoutTv<D, O>;
  using Sc = eks::Scalar<S>;
  using Elem = eks::FilterElem<S, D>;
  constexpr int W = Sc::W;
  __shared__ S tab[Lt::N_SCAL];
  __shared__ float red[W * NT];
  extern __shared__ float scan_buf[];  // W * Elem::P * NT floats

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  for (int k = tid; k < Lt::N_SCAL; k += NT) {
    const size_t i = (size_t)lane * Lt::N_SCAL + k;
    tab[k] = Sc::make(table[i], dtable != nullptr ? dtable[i] : 0.f);
  }
  __syncthreads();

  const float* yrl = yr + (size_t)lane * 2 * O * T;
  const int L = (T + NT - 1) / NT;
  const int lo = min(tid * L, T);
  const int hi = min(lo + L, T);
  float yv[O], rv[O];

  // pass 1: chunk total
  Elem carry = eks::identity<S, D>();
  for (int t = lo; t < hi; ++t) {
    load_step<O>(yrl, T, t, yv, rv);
    const Elem e = build_tv<S, D, O>(tab, yv, rv, t == 0);
    carry = t == lo ? e : eks::combine<S, D>(carry, e);
  }

  // phase 2: combination of every earlier chunk (the identity for chunk 0)
  carry = eks::block_exclusive_scan<S, D, NT>(carry, scan_buf);

  // pass 3: carry the posterior through the chunk, summing log-densities
  S acc = Sc::c(0.f);
  for (int t = lo; t < hi; ++t) {
    load_step<O>(yrl, T, t, yv, rv);
    acc = acc + eks::innovation_logpdf<S, float, D, O>(carry, tab + Lt::A, tab + Lt::Q,
                                                       tab + Lt::COBS, tab + Lt::M0,
                                                       tab + Lt::S0, rv, yv, t == 0);
    carry = eks::combine<S, D>(carry, build_tv<S, D, O>(tab, yv, rv, t == 0));
  }

  eks::block_sum_to<S, NT>(acc, red, out, lane, N);
}

template <typename S>
int launch(const float* yr, const float* table, const float* dtable, float* out, int N, int T,
           int D, int O, void* stream) {
  if (N <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  if (D != 3 || O != 8) return (int)cudaErrorInvalidValue;
  auto kernel = fused_nll_tv_kernel<S, 3, 8>;
  // the block scan's buffer passes 48 KB in the paired form: opt in
  const int scan_bytes = eks::Scalar<S>::W * eks::FilterElem<S, 3>::P * NT * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, scan_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<N, NT, scan_bytes, (cudaStream_t)stream>>>(yr, table, dtable, out, N, T);
  return (int)cudaGetLastError();
}

}  // namespace

// yr: (N, 2O, T), the y planes then the r planes; table: (N, n_scal);
// out: (N,). float32, contiguous. Returns the CUDA error of the launch (0 on
// success); an unsupported (D, O) returns cudaErrorInvalidValue without
// launching.
extern "C" int fused_nll_tv_f32(const float* yr, const float* table, float* out, int N, int T,
                                int D, int O, void* stream) {
  return launch<float>(yr, table, nullptr, out, N, T, D, O, stream);
}

// As fused_nll_tv_f32, with dtable (N, n_scal) the table's tangent; out is
// (2, N): row 0 the log-likelihoods, row 1 their derivatives.
extern "C" int fused_nll_tv_paired_f32(const float* yr, const float* table, const float* dtable,
                                       float* out, int N, int T, int D, int O, void* stream) {
  return launch<eks::Dual>(yr, table, dtable, out, N, T, D, O, stream);
}
