// Element algebras shared by the prefix-scan kernel (kernel B and its
// lane-batched form D, prefix_scan.cu) and the fused NLL kernels (kernel A,
// fused_nll.cu, and kernel C, fused_nll_tv.cu), the innovation log-density
// the two fused kernels end each step with, and the lane x segment machinery
// (at the end of the file) on which the scan and kernel C spread a lane over
// many thread blocks.
//
// An element of the parallel Kalman filter (Särkkä & García-Fernández 2021)
// is (A, b, C, eta, J), stored flat as P = 3D² + 2D values in the plane order
// of eks_tpu_torch/ops/pkalman.py: A row-major, b, C row-major, eta, J
// row-major. combine() is ops/pkalman.py::_combine_filter term for term,
// including Zt = Zᵀ, which equals inv(I + J2 C1) only because C1 and J2 are
// symmetric. An element of the parallel RTS smoother is (E, g, L), P = 2D² + D
// values (E row-major, g, L row-major); smoother_combine() is
// ops/pkalman.py::_combine_smoother. Everything is templated on the scalar
// type S (float, or Dual for the forward-mode pairing) and on D, and fully
// unrolled, so an element lives in registers. FilterAlgebra and
// SmootherAlgebra name an element type, its identity and its combine in scan
// order for the block scan and the scan kernel.
#pragma once

#include <cuda_runtime.h>

namespace eks {

// (value, tangent) pair: forward-mode derivative along one direction. The
// device-code counterpart of jax.jvp over the combine and the epilogue.
struct Dual {
  float v, d;
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) { return {a.v * b.v, a.d * b.v + a.v * b.d}; }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
// a plain float has a zero tangent (an observation or its noise variance)
__device__ __forceinline__ Dual operator+(Dual a, float b) { return {a.v + b, a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, float b) { return {a.v * b, a.d * b}; }
__device__ __forceinline__ Dual sqrt_(Dual a) {
  const float s = sqrtf(a.v);
  return {s, a.d * (0.5f / s)};
}
__device__ __forceinline__ Dual log_(Dual a) { return {logf(a.v), a.d / a.v}; }
__device__ __forceinline__ float sqrt_(float a) { return sqrtf(a); }
__device__ __forceinline__ float log_(float a) { return logf(a); }

// scalar traits: constants, and the float planes a scalar occupies in shared
// memory (W planes of `stride` floats each)
template <typename S>
struct Scalar;

template <>
struct Scalar<float> {
  static constexpr int W = 1;
  __device__ static float c(float v) { return v; }
  __device__ static float make(float v, float) { return v; }
  __device__ static void put(float* p, size_t, float s) { p[0] = s; }
  __device__ static float get(const float* p, size_t) { return p[0]; }
  __device__ static float value(float s) { return s; }
  __device__ static float tangent(float) { return 0.f; }
};

template <>
struct Scalar<Dual> {
  static constexpr int W = 2;
  __device__ static Dual c(float v) { return {v, 0.f}; }
  __device__ static Dual make(float v, float d) { return {v, d}; }
  __device__ static void put(float* p, size_t stride, Dual s) {
    p[0] = s.v;
    p[stride] = s.d;
  }
  __device__ static Dual get(const float* p, size_t stride) { return {p[0], p[stride]}; }
  __device__ static float value(Dual s) { return s.v; }
  __device__ static float tangent(Dual s) { return s.d; }
};

template <typename S, int D>
struct FilterElem {
  static constexpr int P = 3 * D * D + 2 * D;
  S x[P];
  __device__ S& A(int i, int j) { return x[i * D + j]; }
  __device__ S& b(int i) { return x[D * D + i]; }
  __device__ S& C(int i, int j) { return x[D * D + D + i * D + j]; }
  __device__ S& eta(int i) { return x[2 * D * D + D + i]; }
  __device__ S& J(int i, int j) { return x[2 * D * D + 2 * D + i * D + j]; }
};

template <typename S, int D>
__device__ __forceinline__ FilterElem<S, D> identity() {
  FilterElem<S, D> e;
#pragma unroll
  for (int p = 0; p < FilterElem<S, D>::P; ++p) e.x[p] = Scalar<S>::c(0.f);
#pragma unroll
  for (int i = 0; i < D; ++i) e.A(i, i) = Scalar<S>::c(1.f);
  return e;
}

// closed-form inverse (adjugate / det), as ops/pkalman.py::_pinv
template <typename S, int D>
__device__ __forceinline__ void small_inv(S (&a)[D][D], S (&out)[D][D]) {
  static_assert(D >= 1 && D <= 3, "closed-form inverse for D <= 3");
  if constexpr (D == 1) {
    out[0][0] = Scalar<S>::c(1.f) / a[0][0];
  } else if constexpr (D == 2) {
    const S inv = Scalar<S>::c(1.f) / (a[0][0] * a[1][1] - a[0][1] * a[1][0]);
    out[0][0] = a[1][1] * inv;
    out[0][1] = -a[0][1] * inv;
    out[1][0] = -a[1][0] * inv;
    out[1][1] = a[0][0] * inv;
  } else {
    const S c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1];
    const S c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2];
    const S c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0];
    const S inv = Scalar<S>::c(1.f) / (a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02);
    const S c10 = a[0][2] * a[2][1] - a[0][1] * a[2][2];
    const S c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0];
    const S c12 = a[0][1] * a[2][0] - a[0][0] * a[2][1];
    const S c20 = a[0][1] * a[1][2] - a[0][2] * a[1][1];
    const S c21 = a[0][2] * a[1][0] - a[0][0] * a[1][2];
    const S c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0];
    out[0][0] = c00 * inv; out[0][1] = c10 * inv; out[0][2] = c20 * inv;
    out[1][0] = c01 * inv; out[1][1] = c11 * inv; out[1][2] = c21 * inv;
    out[2][0] = c02 * inv; out[2][1] = c12 * inv; out[2][2] = c22 * inv;
  }
}

// e1 precedes e2 in time
template <typename S, int D>
__device__ __forceinline__ FilterElem<S, D> combine(FilterElem<S, D> e1, FilterElem<S, D> e2) {
  S M[D][D], Z[D][D], A2Z[D][D], A1tZt[D][D], T1[D][D], v[D];
  // Z = inv(I + C1 J2)
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S s = e1.C(i, 0) * e2.J(0, j);
#pragma unroll
      for (int k = 1; k < D; ++k) s = s + e1.C(i, k) * e2.J(k, j);
      M[i][j] = i == j ? s + Scalar<S>::c(1.f) : s;
    }
  small_inv<S, D>(M, Z);
  // A2Z = A2 Z;  A1tZt = A1ᵀ Zᵀ
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S s = e2.A(i, 0) * Z[0][j];
      S t = e1.A(0, i) * Z[j][0];
#pragma unroll
      for (int k = 1; k < D; ++k) {
        s = s + e2.A(i, k) * Z[k][j];
        t = t + e1.A(k, i) * Z[j][k];
      }
      A2Z[i][j] = s;
      A1tZt[i][j] = t;
    }
  FilterElem<S, D> out;
  // A = A2Z A1
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S s = A2Z[i][0] * e1.A(0, j);
#pragma unroll
      for (int k = 1; k < D; ++k) s = s + A2Z[i][k] * e1.A(k, j);
      out.A(i, j) = s;
    }
  // b = A2Z (b1 + C1 eta2) + b2
#pragma unroll
  for (int i = 0; i < D; ++i) {
    S s = e1.C(i, 0) * e2.eta(0);
#pragma unroll
    for (int k = 1; k < D; ++k) s = s + e1.C(i, k) * e2.eta(k);
    v[i] = e1.b(i) + s;
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    S s = A2Z[i][0] * v[0];
#pragma unroll
    for (int k = 1; k < D; ++k) s = s + A2Z[i][k] * v[k];
    out.b(i) = s + e2.b(i);
  }
  // C = (A2Z C1) A2ᵀ + C2
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S s = A2Z[i][0] * e1.C(0, j);
#pragma unroll
      for (int k = 1; k < D; ++k) s = s + A2Z[i][k] * e1.C(k, j);
      T1[i][j] = s;
    }
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S s = T1[i][0] * e2.A(j, 0);
#pragma unroll
      for (int k = 1; k < D; ++k) s = s + T1[i][k] * e2.A(j, k);
      out.C(i, j) = s + e2.C(i, j);
    }
  // eta = A1tZt (eta2 - J2 b1) + eta1
#pragma unroll
  for (int i = 0; i < D; ++i) {
    S s = e2.J(i, 0) * e1.b(0);
#pragma unroll
    for (int k = 1; k < D; ++k) s = s + e2.J(i, k) * e1.b(k);
    v[i] = e2.eta(i) - s;
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    S s = A1tZt[i][0] * v[0];
#pragma unroll
    for (int k = 1; k < D; ++k) s = s + A1tZt[i][k] * v[k];
    out.eta(i) = s + e1.eta(i);
  }
  // J = (A1tZt J2) A1 + J1
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S s = A1tZt[i][0] * e2.J(0, j);
#pragma unroll
      for (int k = 1; k < D; ++k) s = s + A1tZt[i][k] * e2.J(k, j);
      T1[i][j] = s;
    }
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S s = T1[i][0] * e1.A(0, j);
#pragma unroll
      for (int k = 1; k < D; ++k) s = s + T1[i][k] * e1.A(k, j);
      out.J(i, j) = s + e1.J(i, j);
    }
  return out;
}

// A filtered posterior (mean b, covariance C): what a combination of
// filtering elements that includes step 0 reduces to, since step 0's element
// has A = 0, eta = 0 and J = 0 and combine() keeps them 0 in every element
// that follows it. 2D + D² values where a full element has 3D² + 2D.
template <typename S, int D>
struct Posterior {
  S x[D + D * D];
  __device__ S& b(int i) { return x[i]; }
  __device__ S& C(int i, int j) { return x[D + i * D + j]; }
};

// combine(e1, e2) for an e1 with A1 = 0, eta1 = 0, J1 = 0: the b and C terms
// of combine() in the same order, so the two agree to the last bit wherever
// the compiler contracts them alike
template <typename S, int D>
__device__ __forceinline__ Posterior<S, D> posterior_combine(Posterior<S, D> p, FilterElem<S, D>& e2) {
  S M[D][D], Z[D][D], A2Z[D][D], v[D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S s = p.C(i, 0) * e2.J(0, j);
#pragma unroll
      for (int k = 1; k < D; ++k) s = s + p.C(i, k) * e2.J(k, j);
      M[i][j] = i == j ? s + Scalar<S>::c(1.f) : s;
    }
  small_inv<S, D>(M, Z);
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S s = e2.A(i, 0) * Z[0][j];
#pragma unroll
      for (int k = 1; k < D; ++k) s = s + e2.A(i, k) * Z[k][j];
      A2Z[i][j] = s;
    }
  Posterior<S, D> out;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    S s = p.C(i, 0) * e2.eta(0);
#pragma unroll
    for (int k = 1; k < D; ++k) s = s + p.C(i, k) * e2.eta(k);
    v[i] = p.b(i) + s;
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    S s = A2Z[i][0] * v[0];
#pragma unroll
    for (int k = 1; k < D; ++k) s = s + A2Z[i][k] * v[k];
    out.b(i) = s + e2.b(i);
  }
  S T1[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S s = A2Z[i][0] * p.C(0, j);
#pragma unroll
      for (int k = 1; k < D; ++k) s = s + A2Z[i][k] * p.C(k, j);
      T1[i][j] = s;
    }
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S s = T1[i][0] * e2.A(j, 0);
#pragma unroll
      for (int k = 1; k < D; ++k) s = s + T1[i][k] * e2.A(j, k);
      out.C(i, j) = s + e2.C(i, j);
    }
  return out;
}

template <typename S, int D>
__device__ __forceinline__ Posterior<S, D> posterior_of(FilterElem<S, D>& e) {
  Posterior<S, D> p;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    p.b(i) = e.b(i);
#pragma unroll
    for (int j = 0; j < D; ++j) p.C(i, j) = e.C(i, j);
  }
  return p;
}

// RTS smoothing element: the backward affine-Gaussian map x -> E x + g with
// covariance L
template <typename S, int D>
struct SmootherElem {
  static constexpr int P = 2 * D * D + D;
  S x[P];
  __device__ S& E(int i, int j) { return x[i * D + j]; }
  __device__ S& g(int i) { return x[D * D + i]; }
  __device__ S& L(int i, int j) { return x[D * D + D + i * D + j]; }
};

// `later` follows `earlier` in time: the earlier element's map is applied to
// the later suffix, (E_e E_l, E_e g_l + g_e, E_e L_l E_eᵀ + L_e)
template <typename S, int D>
__device__ __forceinline__ SmootherElem<S, D> smoother_combine(SmootherElem<S, D> later,
                                                               SmootherElem<S, D> earlier) {
  SmootherElem<S, D> out;
  S T1[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S e = earlier.E(i, 0) * later.E(0, j);
      S t = earlier.E(i, 0) * later.L(0, j);
#pragma unroll
      for (int k = 1; k < D; ++k) {
        e = e + earlier.E(i, k) * later.E(k, j);
        t = t + earlier.E(i, k) * later.L(k, j);
      }
      out.E(i, j) = e;
      T1[i][j] = t;
    }
    S s = earlier.E(i, 0) * later.g(0);
#pragma unroll
    for (int k = 1; k < D; ++k) s = s + earlier.E(i, k) * later.g(k);
    out.g(i) = s + earlier.g(i);
  }
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S s = T1[i][0] * earlier.E(j, 0);
#pragma unroll
      for (int k = 1; k < D; ++k) s = s + T1[i][k] * earlier.E(j, k);
      out.L(i, j) = s + earlier.L(i, j);
    }
  return out;
}

// An algebra for the scans: the element, its identity, and op(first, second)
// with `first` preceding `second` in SCAN order. The filter scans forward in
// time. The smoother scans backward (REVERSED: scan position i is time step
// T-1-i), so its first operand is the element later in time; its identity is
// E = I, g = 0, L = 0.
template <typename S, int D>
struct FilterAlgebra {
  using Scalar = S;
  using Elem = FilterElem<S, D>;
  static constexpr int P = Elem::P;
  static constexpr bool REVERSED = false;
  __device__ static Elem identity() { return eks::identity<S, D>(); }
  __device__ static Elem op(const Elem& first, const Elem& second) {
    return combine<S, D>(first, second);
  }
};

template <typename S, int D>
struct SmootherAlgebra {
  using Scalar = S;
  using Elem = SmootherElem<S, D>;
  static constexpr int P = Elem::P;
  static constexpr bool REVERSED = true;
  __device__ static Elem identity() {
    Elem e;
#pragma unroll
    for (int p = 0; p < P; ++p) e.x[p] = eks::Scalar<S>::c(0.f);
#pragma unroll
    for (int i = 0; i < D; ++i) e.E(i, i) = eks::Scalar<S>::c(1.f);
    return e;
  }
  __device__ static Elem op(const Elem& first, const Elem& second) {
    return smoother_combine<S, D>(first, second);
  }
};

// Exclusive prefix of the per-thread chunk totals across the block: a
// Hillis-Steele sweep of log2(NT) steps in shared memory with the algebra's
// op (the left operand is the earlier chunk in scan order). `smem` holds
// Scalar<S>::W * P * NT floats. Thread 0 gets the identity. On return smem
// holds every thread's inclusive prefix, float plane q of thread i at
// q * NT + i (the P value planes, then the P tangent planes), so the last
// thread's is the block's total.
template <typename Alg, int NT>
__device__ __forceinline__ typename Alg::Elem block_exclusive_scan_of(typename Alg::Elem total,
                                                                      float* smem) {
  using Elem = typename Alg::Elem;
  using Sc = Scalar<typename Alg::Scalar>;
  constexpr int P = Alg::P;
  constexpr size_t STRIDE = (size_t)P * NT;  // tangent planes follow the value planes
  const int tid = threadIdx.x;
#pragma unroll
  for (int p = 0; p < P; ++p) Sc::put(smem + p * NT + tid, STRIDE, total.x[p]);
  __syncthreads();
  for (int shift = 1; shift < NT; shift <<= 1) {
    Elem left;
    const bool has = tid >= shift;
    if (has) {
#pragma unroll
      for (int p = 0; p < P; ++p) left.x[p] = Sc::get(smem + p * NT + tid - shift, STRIDE);
    }
    __syncthreads();
    if (has) {
      total = Alg::op(left, total);
#pragma unroll
      for (int p = 0; p < P; ++p) Sc::put(smem + p * NT + tid, STRIDE, total.x[p]);
    }
    __syncthreads();
  }
  Elem excl = Alg::identity();
  if (tid > 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) excl.x[p] = Sc::get(smem + p * NT + tid - 1, STRIDE);
  }
  return excl;
}

// the filter algebra's block scan, as the fused NLL kernels call it
template <typename S, int D, int NT>
__device__ __forceinline__ FilterElem<S, D> block_exclusive_scan(FilterElem<S, D> total, float* smem) {
  return block_exclusive_scan_of<FilterAlgebra<S, D>, NT>(total, smem);
}

constexpr float LOG_2PI = 1.8378770664093453f;

// log N(y_t; C m_pred, C P_pred Cᵀ + diag(r)) from the carry before step t
// (the t-1 filtered posterior, a FilterElem or a Posterior, of which only b
// and C are read; the prior at t = 0): predict with (A, Q), then
// the O x O innovation Cholesky, built and consumed row by row (the forward
// substitution and the log-determinant need row i only while it is built),
// as ops/pkalman.py::_plane_nll_post. A, Q, Cobs, m0 and S0 point at the
// row-major blocks of the lane's table; rv is the step's diagonal noise, a
// table entry (S) or a plain float.
template <typename S, typename R, int D, int O, typename Carry = FilterElem<S, D>>
__device__ __forceinline__ S innovation_logpdf(Carry& prev, const S* A, const S* Q,
                                               const S* Cobs, const S* m0, const S* S0,
                                               const R (&rv)[O], const float (&yv)[O], bool t0) {
  using Sc = Scalar<S>;
  S pm[D], pP[D][D];
  if (t0) {
#pragma unroll
    for (int a = 0; a < D; ++a) {
      pm[a] = m0[a];
#pragma unroll
      for (int b = 0; b < D; ++b) pP[a][b] = S0[a * D + b];
    }
  } else {
#pragma unroll
    for (int a = 0; a < D; ++a) {
      S s = A[a * D] * prev.b(0);
#pragma unroll
      for (int k = 1; k < D; ++k) s = s + A[a * D + k] * prev.b(k);
      pm[a] = s;
    }
#pragma unroll
    for (int a = 0; a < D; ++a)
#pragma unroll
      for (int b = 0; b < D; ++b) {
        S s = Sc::c(0.f);
#pragma unroll
        for (int k = 0; k < D; ++k)
#pragma unroll
          for (int l = 0; l < D; ++l) s = s + A[a * D + k] * prev.C(k, l) * A[b * D + l];
        pP[a][b] = s + Q[a * D + b];
      }
  }
  S Lc[O][O], z[O];
  S quad = Sc::c(0.f), logdet = Sc::c(0.f);
#pragma unroll
  for (int i = 0; i < O; ++i) {
    // row i of the innovation covariance, reduced to row i of its factor
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      S s = Sc::c(0.f);
#pragma unroll
      for (int k = 0; k < D; ++k)
#pragma unroll
        for (int l = 0; l < D; ++l) s = s + Cobs[i * D + k] * pP[k][l] * Cobs[j * D + l];
      if (i == j) s = s + rv[i];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - Lc[i][k] * Lc[j][k];
      Lc[i][j] = i == j ? sqrt_(s) : s / Lc[j][j];
    }
    // residual, forward substitution, log-determinant
    S s = Sc::c(yv[i]);
#pragma unroll
    for (int k = 0; k < D; ++k) s = s - Cobs[i * D + k] * pm[k];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - Lc[i][k] * z[k];
    z[i] = s / Lc[i][i];
    logdet = logdet + log_(Lc[i][i]);
    quad = quad + z[i] * z[i];
  }
  return Sc::c(-0.5f) * quad - logdet - Sc::c(0.5f * O * LOG_2PI);
}

// Sum of the per-thread accumulators over the block in a fixed tree order
// (deterministic); thread 0 writes the lane's value to out[lane] and, for
// Dual, its tangent to out[N + lane]. `red` holds Scalar<S>::W * NT floats.
template <typename S, int NT>
__device__ __forceinline__ void block_sum_to(S acc, float* red, float* out, int lane, int N) {
  constexpr int W = Scalar<S>::W;
  const int tid = threadIdx.x;
  red[tid] = Scalar<S>::value(acc);
  if constexpr (W == 2) red[NT + tid] = Scalar<S>::tangent(acc);
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) {
      red[tid] += red[tid + s];
      if constexpr (W == 2) red[NT + tid] += red[NT + tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    out[lane] = red[0];
    if constexpr (W == 2) out[N + lane] = red[NT];
  }
}

// --------------------------------------------------------------------------
// The lane x segment grid: a deterministic segmented scan over many blocks.
//
// A lane's T scan positions are cut into G contiguous segments of
// L = ceil(T / G) positions (the last may be shorter, none is empty), one
// thread block each, and a scan runs as three stream-ordered launches:
//   reduce     each block but the last folds its segment into a segment
//              total (block_reduce_of) and writes it to a (N, G, W * P)
//              scratch buffer;
//   totals     one block per lane replaces total g by the combination of
//              totals 0 .. g-1 (scan_segment_totals);
//   downsweep  each block folds its segment again from that carry-in.
// Inside a block each of NT threads owns one contiguous chunk of the
// segment. Every association is fixed by (segment, thread) alone, never by
// timing (no look-back, no atomics), so two launches on the same inputs give
// the same bits. A block stages its segment's planes in shared memory with
// coalesced asynchronous copies (stage_async), consecutive threads on
// consecutive steps; a plane's row in shared memory is padded by one float
// every 32 (padded), so threads walking chunks of 2, 4 or 8 steps hit
// distinct banks.
// --------------------------------------------------------------------------

__device__ __forceinline__ int padded(int k) { return k + (k >> 5); }

// shared-memory floats a plane of up to n steps takes
__host__ __device__ constexpr int padded_stride(int n) { return n + (n >> 5) + 1; }

// element `slot` of a tile of W * P planes (the P value planes, then the P
// tangent planes), each `stride` floats, padded
template <typename Alg>
__device__ __forceinline__ typename Alg::Elem tile_get(const float* tile, int stride, int slot) {
  using Sc = Scalar<typename Alg::Scalar>;
  typename Alg::Elem e;
#pragma unroll
  for (int p = 0; p < Alg::P; ++p) e.x[p] = Sc::get(tile + p * stride + padded(slot), (size_t)Alg::P * stride);
  return e;
}

template <typename Alg>
__device__ __forceinline__ void tile_put(float* tile, int stride, int slot, const typename Alg::Elem& e) {
  using Sc = Scalar<typename Alg::Scalar>;
#pragma unroll
  for (int p = 0; p < Alg::P; ++p) Sc::put(tile + p * stride + padded(slot), (size_t)Alg::P * stride, e.x[p]);
}

// an element of a (G, W * P) row of segment totals in device memory
template <typename Alg>
__device__ __forceinline__ typename Alg::Elem total_get(const float* row) {
  using Sc = Scalar<typename Alg::Scalar>;
  typename Alg::Elem e;
#pragma unroll
  for (int p = 0; p < Alg::P; ++p) e.x[p] = Sc::get(row + p, Alg::P);
  return e;
}

template <typename Alg>
__device__ __forceinline__ void total_put(float* row, const typename Alg::Elem& e) {
  using Sc = Scalar<typename Alg::Scalar>;
#pragma unroll
  for (int p = 0; p < Alg::P; ++p) Sc::put(row + p, Alg::P, e.x[p]);
}

// Copy `planes` planes of n floats each from device memory (plane stride
// `gstride`) into shared memory (plane stride `sstride`, padded) with 4-byte
// cp.async, then wait for them and synchronise the block. Every float is one
// copy, consecutive threads on consecutive floats of a plane, so each warp's
// reads are coalesced whatever the alignment of the segment.
template <int NT>
__device__ __forceinline__ void stage_async(float* dst, int sstride, const float* src, size_t gstride,
                                            int planes, int n) {
#pragma unroll 1
  for (int q = 0; q < planes; ++q) {
    for (int k = threadIdx.x; k < n; k += NT) {
      const unsigned s = (unsigned)__cvta_generic_to_shared(dst + q * sstride + padded(k));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src + q * gstride + k)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// the inverse copy, with plain coalesced stores
template <int NT>
__device__ __forceinline__ void store_planes(float* dst, size_t gstride, const float* src, int sstride,
                                             int planes, int n) {
#pragma unroll 1
  for (int q = 0; q < planes; ++q)
    for (int k = threadIdx.x; k < n; k += NT) dst[q * gstride + k] = src[q * sstride + padded(k)];
}

// this thread's chunk [a, b) of a segment of n steps (empty past n)
template <int NT>
__device__ __forceinline__ void chunk_of(int n, int& a, int& b) {
  const int c = (n + NT - 1) / NT;
  a = min((int)threadIdx.x * c, n);
  b = min(a + c, n);
}

// The combination of the per-thread totals across the block in thread
// order, by an in-order pairwise tree of log2(NT) levels: at width w the
// thread i with i % 2w == w publishes its partial and thread i - w folds it
// in after its own. Thread 0 returns the block's total. `smem` holds
// Scalar<S>::W * P * NT floats; each slot is written once and read once.
template <typename Alg, int NT>
__device__ __forceinline__ typename Alg::Elem block_reduce_of(typename Alg::Elem total, float* smem) {
  using Sc = Scalar<typename Alg::Scalar>;
  constexpr int P = Alg::P;
  constexpr size_t STRIDE = (size_t)P * NT;
  const int tid = threadIdx.x;
#pragma unroll 1
  for (int w = 1; w < NT; w <<= 1) {
    const int r = tid & (2 * w - 1);
    if (r == w) {
#pragma unroll
      for (int p = 0; p < P; ++p) Sc::put(smem + p * NT + tid, STRIDE, total.x[p]);
    }
    __syncthreads();
    if (r == 0) {
      typename Alg::Elem right;
#pragma unroll
      for (int p = 0; p < P; ++p) right.x[p] = Sc::get(smem + p * NT + tid + w, STRIDE);
      total = Alg::op(total, right);
    }
  }
  return total;
}

// The totals phase, for the lane of this block: `totals` holds G rows of
// W * P floats per lane, rows 0 .. G-2 the segment totals (row G-1 is not
// read: no segment follows the last). Row g becomes the combination of
// totals 0 .. g-1, the identity for g = 0. Each thread folds a contiguous run
// of ceil(G / NT) rows, the block takes the exclusive prefix of the runs,
// and each thread re-walks its run, so G is not bounded by NT. `smem` holds
// Scalar<S>::W * P * NT floats. With TOTAL, row G-1 holds the last
// segment's total too, and the lane's inclusive total, the combination of
// all G rows in scan order, goes to the W * P floats of `total_out` for
// this lane, copied from the block scan's last inclusive prefix, so it adds
// no combine (the exclusive prefixes are the same bits either way).
template <typename Alg, int NT, bool TOTAL = false>
__device__ __forceinline__ void scan_segment_totals(float* totals, int G, float* smem,
                                                    float* total_out = nullptr) {
  using Elem = typename Alg::Elem;
  constexpr int WP = Scalar<typename Alg::Scalar>::W * Alg::P;
  float* rows = totals + (size_t)blockIdx.x * G * WP;
  const int n_read = TOTAL ? G : G - 1;
  int lo, hi;
  chunk_of<NT>(G, lo, hi);
  Elem carry = Alg::identity();
  for (int g = lo; g < hi && g < n_read; ++g) {
    const Elem e = total_get<Alg>(rows + (size_t)g * WP);
    carry = g == lo ? e : Alg::op(carry, e);
  }
  Elem excl = block_exclusive_scan_of<Alg, NT>(carry, smem);
  if constexpr (TOTAL) {
    for (int q = threadIdx.x; q < WP; q += NT) total_out[(size_t)blockIdx.x * WP + q] = smem[q * NT + NT - 1];
  }
  for (int g = lo; g < hi; ++g) {
    Elem e;
    if (g < n_read) e = total_get<Alg>(rows + (size_t)g * WP);  // read before it is overwritten
    total_put<Alg>(rows + (size_t)g * WP, excl);
    if (g + 1 < hi) excl = Alg::op(excl, e);
  }
}

// Host side: run `set`, an instance's cudaFuncSetAttribute calls, once per
// device. The attributes stay with the kernels, and a runtime call for each
// of them on every launch would add to every call's host time; `done` is the
// instance's own record, one flag per device.
constexpr int MAX_DEVICES = 64;

template <typename F>
cudaError_t once_per_device(bool (&done)[MAX_DEVICES], F&& set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < MAX_DEVICES && done[dev])) return err;
  err = set();
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

}  // namespace eks
