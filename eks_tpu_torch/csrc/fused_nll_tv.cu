// Kernel C: fused Kalman filter log-likelihood with time-varying diagonal R,
// plain and paired.
//
// Replaces: eks_tpu/ops/pallas_nll.py::_make_fused_kernel_tv (plain and
// paired=True), the loss of the pupil optimizer and of its sessions twin,
// reached through filter_nll_fused_tv_batched.
//
// Per lane it returns the marginal log-likelihood of a linear Kalman filter
// whose observation noise R_t = diag(r_t) changes every step. The T-sized
// input is yr (N, 2O, T): the O observation planes, then the O noise planes.
// Everything else is the lane's scalar table (N, n_scal), whose layout is
// ops/pkalman.py::_scalar_offsets_tv (84 floats at D = 3, O = 8), staged in
// shared memory.
//
// R_t is not constant, so no element matrix can be precomputed: each step
// builds its element in the information form (ops/pkalman.py::
// _table_planes_tv, term for term),
//   W = Cᵀ R_t⁻¹ C,  v = Cᵀ R_t⁻¹ y_t,  M = (Q⁻¹ + W)⁻¹,
//   A_el = M Q⁻¹A,  b = M v,  C_el = M,
//   eta = Aᵀ (v - W b),  J = Aᵀ (W - W M W) A,
// which costs one closed-form D x D inverse in place of the covariance
// form's O x O solve. Step 0 assimilates y_0 against the prior: the same
// inverse with S0⁻¹ selected in the place of Q⁻¹ (by global index), S0⁻¹ m0
// added to v, and A_el, eta and J zero. The log-density keeps the covariance
// form: S_t = C P_pred Cᵀ + R_t and its unrolled O x O Cholesky
// (filter_algebra.cuh::innovation_logpdf). With 1/r as large as 1e12 a
// determinant-lemma epilogue in D x D, or a covariance-form Kalman update
// through the innovation Cholesky, would cancel badly.
//
// The paired form runs build, combine and epilogue on Dual numbers (value,
// tangent) along the table's tangent, which the caller supplies; y and r
// carry no tangent. One call returns (ll, d ll) per lane.
//
// Bound on the H100: the function reads yr once, N * 2O * T * 4 bytes
// (1.28 MB at N = 2, O = 8, T = 10,000; 0.38 us at 3.35 TB/s), and needs one
// Kalman step with an 8 x 8 Cholesky per time step, about 1,500 FP32
// operations (about 4,600 on Dual numbers: 0.44 us and 1.4 us at 67 TFLOP/s
// for two lanes); so operations bound both forms, the plain one narrowly.
//
// Design: the lane x segment grid of filter_algebra.cuh. The pupil optimizer
// gives the kernel two lanes, so each lane's T steps are cut into G segments
// (the wrapper picks G from N, T and the card's SM count), one block of NT
// threads each, and a call is four stream-ordered launches:
//   reduce     each block but the last stages its segment's yr planes in
//              shared memory (coalesced cp.async), builds its elements and
//              folds them into the segment total, written to an (N, G, W * P)
//              scratch;
//   totals     one block per lane: the exclusive prefix of its totals;
//   downsweep  each block builds its elements again, takes the exclusive
//              prefix of its threads' chunk totals after the segment's
//              carry-in, and re-walks its chunk evaluating each step's
//              log-density; the block's sum, in a fixed tree, goes to a
//              (W, N, G) scratch;
//   sum        one thread per output sums its lane's G partials in segment
//              order.
// No association depends on timing, so two calls give the same bits. The
// downsweep carries a posterior (b, C), 12 floats (24 as Dual), not a full
// element: every exclusive prefix but the lane's first contains step 0,
// whose element has A = 0, eta = 0, J = 0, and combine() keeps them 0; the
// one thread that starts from the identity starts at step 0, where the
// posterior combine from (0, 0) gives step 0's (b, C) exactly. The
// innovation log-density reads only b and C. The step's element is rebuilt
// in the downsweep (three builds a step in all): keeping every element in
// an (N, W * P, T) buffer for the downsweep to read instead measured no
// faster at two lanes and slower at sixteen (PERF.md). Registers are
// the scarce resource (a Dual element is 66 floats beside the 36-entry
// Cholesky factor), so NT = 128 and two blocks share an SM. Tensor cores play no part: the products are D x D and O x D
// with D = 3, O = 8, inside a chain of dependent steps, and wgmma's smallest
// tile is 64 rows.
#include "filter_algebra.cuh"

namespace {

constexpr int NT = 128;
// steps per thread at most, and per segment: a segment's 2O planes staged in
// shared memory (67.6 KB at O = 8) beside the block scan's buffer, so that
// two blocks still share an SM
constexpr int CH = 8;
constexpr int TILE = NT * CH;
constexpr int STRIDE = eks::padded_stride(TILE);

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

// the step's observations and noise variances out of the staged planes
template <int O>
__device__ __forceinline__ void load_step(const float* tile, int slot, float (&yv)[O], float (&rv)[O]) {
  const int k = eks::padded(slot);
#pragma unroll
  for (int o = 0; o < O; ++o) {
    yv[o] = tile[o * STRIDE + k];
    rv[o] = tile[(O + o) * STRIDE + k];
  }
}

// what the reduce and the downsweep blocks share: the lane's table and the
// segment's yr planes in shared memory, the thread's chunk, and the step's
// element built from them
template <typename S, int D, int O>
struct Block {
  using Lt = LayoutTv<D, O>;
  using Elem = eks::FilterElem<S, D>;
  S* tab;
  float* tile;
  float* buf;
  int lo, a, b;

  __device__ Block(S* tab_, float* smem, const float* yr, const float* table, const float* dtable, int T,
                   int L)
      : tab(tab_), tile(smem), buf(smem + 2 * O * STRIDE) {
    const int lane = blockIdx.y;
    for (int k = threadIdx.x; k < Lt::N_SCAL; k += NT) {
      const size_t i = (size_t)lane * Lt::N_SCAL + k;
      tab[k] = eks::Scalar<S>::make(table[i], dtable != nullptr ? dtable[i] : 0.f);
    }
    lo = blockIdx.x * L;
    const int n = min(L, T - lo);
    eks::stage_async<NT>(tile, STRIDE, yr + ((size_t)lane * 2 * O * T + lo), T, 2 * O, n);
    eks::chunk_of<NT>(n, a, b);
  }

  __device__ Elem element(int j) const {
    float yv[O], rv[O];
    load_step<O>(tile, j, yv, rv);
    return build_tv<S, D, O>(tab, yv, rv, lo + j == 0);
  }

  // the fold of the thread's chunk
  __device__ Elem chunk_total() const {
    Elem tot = eks::identity<S, D>();
    for (int j = a; j < b; ++j) {
      const Elem e = element(j);
      tot = j == a ? e : eks::combine<S, D>(tot, e);
    }
    return tot;
  }
};

// launch 1: the totals of segments 0 .. G-2 (the last one's is never read)
template <typename S, int D, int O>
__global__ void __launch_bounds__(NT) nll_tv_reduce_kernel(const float* __restrict__ yr,
                                                           const float* __restrict__ table,
                                                           const float* __restrict__ dtable,
                                                           float* __restrict__ totals, int T, int L,
                                                           int G) {
  using Alg = eks::FilterAlgebra<S, D>;
  constexpr int WP = eks::Scalar<S>::W * Alg::P;
  __shared__ S tab[LayoutTv<D, O>::N_SCAL];
  extern __shared__ float smem[];  // the tile, then W * P * NT floats
  const Block<S, D, O> blk(tab, smem, yr, table, dtable, T, L);
  const auto tot = eks::block_reduce_of<Alg, NT>(blk.chunk_total(), blk.buf);
  if (threadIdx.x == 0) eks::total_put<Alg>(totals + ((size_t)blockIdx.y * G + blockIdx.x) * WP, tot);
}

// launch 2: each lane's exclusive prefix of its segment totals
template <typename S, int D>
__global__ void __launch_bounds__(NT) nll_tv_totals_kernel(float* __restrict__ totals, int G) {
  extern __shared__ float smem[];
  eks::scan_segment_totals<eks::FilterAlgebra<S, D>, NT>(totals, G, smem);
}

// launch 3: the posterior through every segment, each block's sum of
// log-densities into partials (W, N, G)
template <typename S, int D, int O>
__global__ void __launch_bounds__(NT) nll_tv_downsweep_kernel(const float* __restrict__ yr,
                                                              const float* __restrict__ table,
                                                              const float* __restrict__ dtable,
                                                              const float* __restrict__ totals,
                                                              float* __restrict__ partials, int N,
                                                              int T, int L, int G) {
  using Lt = LayoutTv<D, O>;
  using Sc = eks::Scalar<S>;
  using Alg = eks::FilterAlgebra<S, D>;
  using Elem = eks::FilterElem<S, D>;
  constexpr int WP = Sc::W * Alg::P;
  __shared__ S tab[Lt::N_SCAL];
  __shared__ float red[Sc::W * NT];
  extern __shared__ float smem[];
  const Block<S, D, O> blk(tab, smem, yr, table, dtable, T, L);
  const int lane = blockIdx.y, seg = blockIdx.x;

  // the t-1 posterior before this thread's first step: the segment's
  // carry-in (the identity for the lane's first segment), then every
  // earlier chunk of the segment
  Elem pre = eks::block_exclusive_scan_of<Alg, NT>(blk.chunk_total(), blk.buf);
  if (seg > 0) pre = eks::combine<S, D>(eks::total_get<Alg>(totals + ((size_t)lane * G + seg) * WP), pre);
  eks::Posterior<S, D> post = eks::posterior_of<S, D>(pre);

  S acc = Sc::c(0.f);
  for (int j = blk.a; j < blk.b; ++j) {
    float yv[O], rv[O];
    load_step<O>(blk.tile, j, yv, rv);
    const bool t0 = blk.lo + j == 0;
    acc = acc + eks::innovation_logpdf<S, float, D, O>(post, tab + Lt::A, tab + Lt::Q, tab + Lt::COBS,
                                                       tab + Lt::M0, tab + Lt::S0, rv, yv, t0);
    Elem e = blk.element(j);
    post = eks::posterior_combine<S, D>(post, e);
  }
  eks::block_sum_to<S, NT>(acc, red, partials, lane * G + seg, N * G);
}

// launch 4: out[r] = the sum of partials[r, 0 .. G-1] in segment order
__global__ void nll_tv_sum_kernel(const float* __restrict__ partials, float* __restrict__ out, int rows,
                                  int G) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* p = partials + (size_t)r * G;
  float s = p[0];
  for (int g = 1; g < G; ++g) s += p[g];
  out[r] = s;
}

template <typename S>
int launch(const float* yr, const float* table, const float* dtable, float* out, float* totals,
           float* partials, int N, int T, int D, int O, int G, void* stream) {
  if (N <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  if (D != 3 || O != 8) return (int)cudaErrorInvalidValue;
  const int L = (T + G - 1) / G;
  if (G < 1 || L > TILE || (G - 1) * L >= T) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  constexpr int WP = eks::Scalar<S>::W * eks::FilterElem<S, 3>::P;
  constexpr int scan_bytes = WP * NT * (int)sizeof(float);
  constexpr int smem_bytes = 2 * 8 * STRIDE * (int)sizeof(float) + scan_bytes;
  auto reduce = nll_tv_reduce_kernel<S, 3, 8>;
  auto totals_scan = nll_tv_totals_kernel<S, 3>;
  auto downsweep = nll_tv_downsweep_kernel<S, 3, 8>;
  // above 48 KB of dynamic shared memory: opt in, once per device
  static bool opted_in[eks::MAX_DEVICES];
  cudaError_t err = eks::once_per_device(opted_in, [&] {
    cudaError_t e = cudaFuncSetAttribute(reduce, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(downsweep, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(totals_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, scan_bytes);
    return e;
  });
  if (err != cudaSuccess) return (int)err;
  if (G > 1) {
    reduce<<<dim3(G - 1, N), NT, smem_bytes, s>>>(yr, table, dtable, totals, T, L, G);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    totals_scan<<<N, NT, scan_bytes, s>>>(totals, G);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  downsweep<<<dim3(G, N), NT, smem_bytes, s>>>(yr, table, dtable, totals, partials, N, T, L, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int rows = eks::Scalar<S>::W * N;
  nll_tv_sum_kernel<<<(rows + NT - 1) / NT, NT, 0, s>>>(partials, out, rows, G);
  return (int)cudaGetLastError();
}

}  // namespace

// The threads per block and the most steps a segment may hold: what the
// wrapper partitions by.
extern "C" int fused_nll_tv_geometry(int* threads, int* max_steps) {
  *threads = NT;
  *max_steps = TILE;
  return 0;
}

// yr: (N, 2O, T), the y planes then the r planes; table: (N, n_scal);
// out: (N,); totals: (N, G, P) and partials (N, G) float32 scratch, G
// segments per lane with none empty and none longer than
// fused_nll_tv_geometry's max_steps. float32, contiguous. Returns the CUDA
// error of the launches (0 on success); an unsupported (D, O) or partition
// returns cudaErrorInvalidValue without launching.
extern "C" int fused_nll_tv_f32(const float* yr, const float* table, float* out, float* totals,
                                float* partials, int N, int T, int D, int O, int G, void* stream) {
  return launch<float>(yr, table, nullptr, out, totals, partials, N, T, D, O, G, stream);
}

// As fused_nll_tv_f32, with dtable (N, n_scal) the table's tangent; out is
// (2, N): row 0 the log-likelihoods, row 1 their derivatives; totals is
// (N, G, 2P) and partials (2, N, G).
extern "C" int fused_nll_tv_paired_f32(const float* yr, const float* table, const float* dtable,
                                       float* out, float* totals, float* partials, int N, int T, int D,
                                       int O, int G, void* stream) {
  return launch<eks::Dual>(yr, table, dtable, out, totals, partials, N, T, D, O, G, stream);
}
