// Kernel A: fused constant-R Kalman filter log-likelihood, plain and paired.
//
// Replaces: eks_tpu/ops/pallas_nll.py::_make_fused_kernel (plain and
// paired=True), the s-optimizer's loss, reached through
// filter_nll_fused_batched.
//
// Per lane it returns the marginal log-likelihood of a linear Kalman filter
// with constant diagonal R. The only T-sized input is y (N, O, T); every
// filtering element is built on the fly from y_t and the lane's scalar table
// (N, n_scal), whose layout is ops/pkalman.py::_scalar_offsets (46 floats at
// D = O = 2, 109 at D = 3, O = 4) and which is staged in shared memory.
// Instances: every D in {1, 2, 3} with O in {2, 4, 6, 8}, what the JAX
// package's fused route admits (_use_fused_nll: D <= 3, O <= 8) with O an
// even count of (x, y) observations: the singlecam family at (2, 2), the
// linear multi-camera families at n_latent = D with O / 2 cameras.
//
// The paired form runs the same build, combine and epilogue on Dual numbers
// (value, tangent), the table's tangent d(table)/d(log s) supplied by the
// caller; one call returns (ll, d ll / d log s) per lane.
//
// Bound on the H100: the function reads y once, N * O * T * 4 bytes (1.6 MB
// at N = 20, O = 2, T = 10,000, about 0.48 us at 3.35 TB/s), and needs one
// Kalman step per time step, about 130 FP32 operations at (2, 2) (about 400
// on Dual numbers); so bytes bound the plain form at (2, 2) and operations
// the paired one and every D = 3 instance.
//
// Design: the lane x segment grid of filter_algebra.cuh, as kernel C's
// (fused_nll_tv.cu). Each lane's T steps are cut into G segments (the wrapper
// picks G from N, T and the card's SM count), one block of NT threads each,
// and a call is four stream-ordered launches:
//   reduce     each block but the last stages its segment's y planes in
//              shared memory (coalesced cp.async), builds its elements from
//              the table and folds them into the segment total, written to
//              an (N, G, W * P) scratch;
//   totals     one block per lane: the exclusive prefix of its totals;
//   downsweep  each block builds its elements again, takes the exclusive
//              prefix of its threads' chunk totals after the segment's
//              carry-in, and re-walks its chunk carrying the filtered
//              posterior (b, C) through each step's predictive moments,
//              unrolled O x O innovation Cholesky and log-density; the
//              block's sum, in a fixed tree, goes to a (W, N, G) scratch;
//   sum        one thread per output sums its lane's G partials in segment
//              order.
// No association depends on timing (no look-back, no atomics), so two calls
// give the same bits. Step 0 is picked by its global index: its element
// assimilates y_0 against the prior with A = 0, eta = 0, J = 0, so every
// exclusive prefix that includes it is a posterior (b, C), and the one
// thread that starts from the identity starts at step 0. Registers are the
// scarce resource (a Dual element at D = 3 is 66 floats beside the O x O
// Cholesky factor), so NT = 128 and two blocks share an SM. Tensor cores
// play no part: the products are D x D and O x D with D <= 3 inside a chain
// of dependent steps, and wgmma's smallest tile is 64 rows.
//
// FUSED_NLL_SHAPES is the one list of instances: the C dispatch,
// fused_nll_shapes() and the table kernel's dispatch expand it.
//
// The table kernel (nll_table_paired_kernel, the same instances): the
// s-optimizer's paired scalar table (table, dtable), d(table)/d(log s), for
// every lane straight from its block's log s. Replaces no Pallas kernel: the
// JAX package builds the table in eks_tpu/ops/pallas_nll.py::_pack_scalars
// under jax.jvp inside its jitted loss, which XLA fuses; eagerly, forward mode
// of ops/pkalman.py::_pack_scalars is some 230 host-dispatched operations an
// Adam iteration, this is one launch. It follows _pack_scalars step for step
// on Dual numbers: s Q and its tangent (torch's forward-mode clamp: the
// tangent passes where s_lo <= log s <= s_hi), S_c = C sQ Cᵀ + diag(r)
// symmetrized with 1e-9 on the diagonal, the unrolled Cholesky solve of
// ops/linalg.py::psd_solve, then K_c, I - K_c C, M_c, the element blocks;
// b_first and C_first, which depend on S0 alone, in float with zero
// tangents, and the verbatim blocks. Bound: a few hundred flops a lane, so
// the bytes, 2 N n_scal floats written (7.4 KB at 20 lanes, (2, 2)): well
// under a microsecond; one thread a lane, since the point is one launch.
//
// The Adam step kernel (adam_step_kernel): what the s-optimizer's loop does
// between kernel A's output and the next iteration's table launch, for every
// block lane in one launch. Replaces no Pallas kernel: the JAX package's
// optimizer (eks_tpu/core.py) runs this tail inside its jitted while loop,
// which XLA fuses; eagerly it is some 60 host-dispatched operations an
// iteration. One thread a block lane: the masked sum of its members' NLLs
// and derivatives in member order (a non-finite member counts 1e12 with a
// zero derivative), optax's Adam update of core.py (b1 0.9, b2 0.999, eps
// 1e-8, the count incremented before the bias correction), the stop rule
// against the previous loss, and the commits of the lane's state while it is
// active; then the block's count of lanes still active, written to a mapped
// host word that the host reads after its one sync an iteration. Every
// operation rounds as torch's separate CUDA kernels do (IEEE divide and sqrt,
// logf, powf, and __fmul_rn/__fadd_rn where nvcc would contract a product
// into a sum), so at one member a block the iterates are those of the plain
// version run on the card, bit for bit. Bound: the bytes, a few dozen a lane.
#include "filter_algebra.cuh"

// (D, O) instances of kernel A
#define FUSED_NLL_SHAPES(X) \
  X(1, 2) X(1, 4) X(1, 6) X(1, 8) X(2, 2) X(2, 4) X(2, 6) X(2, 8) X(3, 2) X(3, 4) X(3, 6) X(3, 8)

namespace {

constexpr int NT = 128;
// steps per thread at most, and per segment: a segment's O y planes staged in
// shared memory (33.8 KB at O = 8) beside the block scan's buffer, so that
// two blocks still share an SM
constexpr int CH = 8;
constexpr int TILE = NT * CH;
constexpr int STRIDE = eks::padded_stride(TILE);

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

// what the reduce and the downsweep blocks share: the lane's table and the
// segment's y planes in shared memory, the thread's chunk, and the step's
// element built from them
template <typename S, int D, int O>
struct Block {
  using Lt = Layout<D, O>;
  using Elem = eks::FilterElem<S, D>;
  S* tab;
  float* tile;
  float* buf;
  int lo, a, b;

  __device__ Block(S* tab_, float* smem, const float* y, const float* table, const float* dtable, int T, int L)
      : tab(tab_), tile(smem), buf(smem + O * STRIDE) {
    const int lane = blockIdx.y;
    for (int k = threadIdx.x; k < Lt::N_SCAL; k += NT) {
      const size_t i = (size_t)lane * Lt::N_SCAL + k;
      tab[k] = eks::Scalar<S>::make(table[i], dtable != nullptr ? dtable[i] : 0.f);
    }
    lo = blockIdx.x * L;
    const int n = min(L, T - lo);
    eks::stage_async<NT>(tile, STRIDE, y + ((size_t)lane * O * T + lo), T, O, n);
    eks::chunk_of<NT>(n, a, b);
  }

  __device__ void observations(int j, float (&yv)[O]) const {
    const int k = eks::padded(j);
#pragma unroll
    for (int o = 0; o < O; ++o) yv[o] = tile[o * STRIDE + k];
  }

  __device__ Elem element(int j) const {
    float yv[O];
    observations(j, yv);
    return build<S, D, O>(tab, yv, lo + j == 0);
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

template <typename S>
constexpr int scan_bytes(int D) {
  return eks::Scalar<S>::W * (3 * D * D + 2 * D) * NT * (int)sizeof(float);
}

// launch 1: the totals of segments 0 .. G-2 (the last one's is never read)
template <typename S, int D, int O>
__global__ void __launch_bounds__(NT) nll_reduce_kernel(const float* __restrict__ y,
                                                        const float* __restrict__ table,
                                                        const float* __restrict__ dtable,
                                                        float* __restrict__ totals, int T, int L, int G) {
  using Alg = eks::FilterAlgebra<S, D>;
  constexpr int WP = eks::Scalar<S>::W * Alg::P;
  __shared__ S tab[Layout<D, O>::N_SCAL];
  extern __shared__ float smem[];  // the tile, then W * P * NT floats
  const Block<S, D, O> blk(tab, smem, y, table, dtable, T, L);
  const auto tot = eks::block_reduce_of<Alg, NT>(blk.chunk_total(), blk.buf);
  if (threadIdx.x == 0) eks::total_put<Alg>(totals + ((size_t)blockIdx.y * G + blockIdx.x) * WP, tot);
}

// launch 2: each lane's exclusive prefix of its segment totals
template <typename S, int D>
__global__ void __launch_bounds__(NT) nll_totals_kernel(float* __restrict__ totals, int G) {
  extern __shared__ float smem[];
  eks::scan_segment_totals<eks::FilterAlgebra<S, D>, NT>(totals, G, smem);
}

// launch 3: the posterior through every segment, each block's sum of
// log-densities into partials (W, N, G)
template <typename S, int D, int O>
__global__ void __launch_bounds__(NT) nll_downsweep_kernel(const float* __restrict__ y,
                                                           const float* __restrict__ table,
                                                           const float* __restrict__ dtable,
                                                           const float* __restrict__ totals,
                                                           float* __restrict__ partials, int N, int T,
                                                           int L, int G) {
  using Lt = Layout<D, O>;
  using Sc = eks::Scalar<S>;
  using Alg = eks::FilterAlgebra<S, D>;
  using Elem = eks::FilterElem<S, D>;
  constexpr int WP = Sc::W * Alg::P;
  __shared__ S tab[Lt::N_SCAL];
  __shared__ float red[Sc::W * NT];
  extern __shared__ float smem[];
  const Block<S, D, O> blk(tab, smem, y, table, dtable, T, L);
  const int lane = blockIdx.y, seg = blockIdx.x;

  // the t-1 posterior before this thread's first step: the segment's
  // carry-in (the identity for the lane's first segment), then every
  // earlier chunk of the segment
  Elem pre = eks::block_exclusive_scan_of<Alg, NT>(blk.chunk_total(), blk.buf);
  if (seg > 0) pre = eks::combine<S, D>(eks::total_get<Alg>(totals + ((size_t)lane * G + seg) * WP), pre);
  eks::Posterior<S, D> post = eks::posterior_of<S, D>(pre);

  S rv[O];
#pragma unroll
  for (int o = 0; o < O; ++o) rv[o] = tab[Lt::R + o];
  S acc = Sc::c(0.f);
  for (int j = blk.a; j < blk.b; ++j) {
    float yv[O];
    blk.observations(j, yv);
    const bool t0 = blk.lo + j == 0;
    acc = acc + eks::innovation_logpdf<S, S, D, O>(post, tab + Lt::A, tab + Lt::Q, tab + Lt::COBS,
                                                   tab + Lt::M0, tab + Lt::S0, rv, yv, t0);
    Elem e = build<S, D, O>(tab, yv, t0);
    post = eks::posterior_combine<S, D>(post, e);
  }
  eks::block_sum_to<S, NT>(acc, red, partials, lane * G + seg, N * G);
}

// launch 4: out[r] = the sum of partials[r, 0 .. G-1] in segment order
__global__ void nll_sum_kernel(const float* __restrict__ partials, float* __restrict__ out, int rows, int G) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* p = partials + (size_t)r * G;
  float s = p[0];
  for (int g = 1; g < G; ++g) s += p[g];
  out[r] = s;
}

template <typename S, int D, int O>
int launch_shape(const float* y, const float* table, const float* dtable, float* out, float* totals,
                 float* partials, int N, int T, int G, cudaStream_t s) {
  const int L = (T + G - 1) / G;
  if (G < 1 || L > TILE || (G - 1) * L >= T) return (int)cudaErrorInvalidValue;
  constexpr int sbytes = scan_bytes<S>(D);
  constexpr int smem_bytes = O * STRIDE * (int)sizeof(float) + sbytes;
  auto reduce = nll_reduce_kernel<S, D, O>;
  auto totals_scan = nll_totals_kernel<S, D>;
  auto downsweep = nll_downsweep_kernel<S, D, O>;
  // above 48 KB of dynamic shared memory: opt in, once per device
  static bool opted_in[eks::MAX_DEVICES];
  cudaError_t err = eks::once_per_device(opted_in, [&] {
    cudaError_t e = cudaFuncSetAttribute(reduce, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(downsweep, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(totals_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, sbytes);
    return e;
  });
  if (err != cudaSuccess) return (int)err;
  if (G > 1) {
    reduce<<<dim3(G - 1, N), NT, smem_bytes, s>>>(y, table, dtable, totals, T, L, G);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    totals_scan<<<N, NT, sbytes, s>>>(totals, G);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  downsweep<<<dim3(G, N), NT, smem_bytes, s>>>(y, table, dtable, totals, partials, N, T, L, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int rows = eks::Scalar<S>::W * N;
  nll_sum_kernel<<<(rows + NT - 1) / NT, NT, 0, s>>>(partials, out, rows, G);
  return (int)cudaGetLastError();
}

template <typename S>
int launch(const float* y, const float* table, const float* dtable, float* out, float* totals,
           float* partials, int N, int T, int D, int O, int G, void* stream) {
  if (N <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FUSED_NLL_TRY(d, o) \
  if (D == d && O == o) return launch_shape<S, d, o>(y, table, dtable, out, totals, partials, N, T, G, s);
  FUSED_NLL_SHAPES(FUSED_NLL_TRY)
#undef FUSED_NLL_TRY
  return (int)cudaErrorInvalidValue;
}

// the s-optimizer's paired table: psd_solve (ops/linalg.py) of a (symmetric
// positive definite) O x O matrix against an O x D right-hand side, in its
// order: symmetrize, 1e-9 on the diagonal, the unrolled Cholesky factor row by
// row, then each column's forward and back substitution
template <typename S, int O, int D>
__device__ __forceinline__ void psd_solve(const S (&a)[O][O], const S (&b)[O][D], S (&x)[O][D]) {
  using Sc = eks::Scalar<S>;
  S L[O][O];
#pragma unroll
  for (int i = 0; i < O; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      S s = (a[i][j] + a[j][i]) * 0.5f;
      if (i == j) s = s + Sc::c(1e-9f);
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = i == j ? eks::sqrt_(s) : s / L[j][j];
    }
#pragma unroll
  for (int m = 0; m < D; ++m) {
    S y[O];
#pragma unroll
    for (int i = 0; i < O; ++i) {
      S s = b[i][m];
#pragma unroll
      for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
      y[i] = s / L[i][i];
    }
#pragma unroll
    for (int i = O - 1; i >= 0; --i) {
      S s = y[i];
#pragma unroll
      for (int k = i + 1; k < O; ++k) s = s - L[k][i] * x[k][m];
      x[i][m] = s / L[i][i];
    }
  }
}

// a (D, O) lane's paired table, ops/pkalman.py::_pack_scalars on Dual numbers
// with Q = s Q_base carrying the tangent along log s; one thread a lane
template <int D, int O>
__global__ void __launch_bounds__(NT) nll_table_paired_kernel(
    const float* __restrict__ s_log, const float* __restrict__ y0, const float* __restrict__ m0,
    const float* __restrict__ S0, const float* __restrict__ A, const float* __restrict__ Qb,
    const float* __restrict__ C, const float* __restrict__ r, float* __restrict__ table,
    float* __restrict__ dtable, int N, int b_max, float s_lo, float s_hi) {
  using Lt = Layout<D, O>;
  using eks::Dual;
  const int lane = blockIdx.x * NT + threadIdx.x;
  if (lane >= N) return;
  // s = exp(clamp(log s)); a NaN passes the clamp, as torch.clamp's, and gets
  // a zero tangent, as its forward mode gives
  const float x = s_log[lane / b_max];
  const float s = expf(x < s_lo ? s_lo : (x > s_hi ? s_hi : x));
  const bool inside = x >= s_lo && x <= s_hi;
  float Af[D][D], Cf[O][D], rf[O], m0f[D], S0f[D][D], yf[O];
  Dual Q[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    m0f[i] = m0[lane * D + i];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      Af[i][j] = A[(lane * D + i) * D + j];
      S0f[i][j] = S0[(lane * D + i) * D + j];
      const float q = s * Qb[(lane * D + i) * D + j];
      Q[i][j] = {q, inside ? q : 0.f};
    }
  }
#pragma unroll
  for (int o = 0; o < O; ++o) {
    rf[o] = r[lane * O + o];
    yf[o] = y0[lane * O + o];
#pragma unroll
    for (int k = 0; k < D; ++k) Cf[o][k] = C[(lane * O + o) * D + k];
  }
  // C sQ, C A, S_c = (C sQ) Cᵀ + diag(r)
  Dual CQ[O][D], S_c[O][O];
  float CA[O][D];
#pragma unroll
  for (int o = 0; o < O; ++o)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      Dual q = Q[0][j] * Cf[o][0];
      float a = Cf[o][0] * Af[0][j];
#pragma unroll
      for (int k = 1; k < D; ++k) {
        q = q + Q[k][j] * Cf[o][k];
        a = a + Cf[o][k] * Af[k][j];
      }
      CQ[o][j] = q;
      CA[o][j] = a;
    }
#pragma unroll
  for (int i = 0; i < O; ++i)
#pragma unroll
    for (int j = 0; j < O; ++j) {
      Dual v = CQ[i][0] * Cf[j][0];
#pragma unroll
      for (int k = 1; k < D; ++k) v = v + CQ[i][k] * Cf[j][k];
      S_c[i][j] = i == j ? v + rf[i] : v;
    }
  // X = S_c⁻¹ C sQ (K_c = Xᵀ) and M_c = S_c⁻¹ C A
  Dual CAd[O][D], X[O][D], M[O][D];
#pragma unroll
  for (int o = 0; o < O; ++o)
#pragma unroll
    for (int j = 0; j < D; ++j) CAd[o][j] = {CA[o][j], 0.f};
  psd_solve<Dual, O, D>(S_c, CQ, X);
  psd_solve<Dual, O, D>(S_c, CAd, M);
  // I - K_c C, then A_el = (I - K_c C) A, C_el = (I - K_c C) sQ, J_el = (C A)ᵀ M_c
  Dual IKC[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      Dual v = X[0][i] * Cf[0][j];
#pragma unroll
      for (int o = 1; o < O; ++o) v = v + X[o][i] * Cf[o][j];
      IKC[i][j] = Dual{i == j ? 1.f : 0.f, 0.f} - v;
    }
  float* tv = table + (size_t)lane * Lt::N_SCAL;
  float* td = dtable + (size_t)lane * Lt::N_SCAL;
  auto put = [&](int k, Dual v) {
    tv[k] = v.v;
    td[k] = v.d;
  };
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      Dual a = IKC[i][0] * Af[0][j];
      Dual c = IKC[i][0] * Q[0][j];
      Dual J = M[0][j] * CA[0][i];
#pragma unroll
      for (int k = 1; k < D; ++k) {
        a = a + IKC[i][k] * Af[k][j];
        c = c + IKC[i][k] * Q[k][j];
      }
#pragma unroll
      for (int o = 1; o < O; ++o) J = J + M[o][j] * CA[o][i];
      put(Lt::A_EL + i * D + j, a);
      put(Lt::C_EL + i * D + j, c);
      put(Lt::J_EL + i * D + j, J);
      put(Lt::Q + i * D + j, Q[i][j]);
    }
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int o = 0; o < O; ++o) {
      put(Lt::K_C + d * O + o, X[o][d]);
      put(Lt::M_CT + d * O + o, M[o][d]);
    }
  // the t = 0 posterior, from the prior alone: S_0 = (C S0) Cᵀ + diag(r),
  // K_0 = (S_0⁻¹ C S0)ᵀ, b_first = m0 + K_0 (y_0 - C m0), C_first = (I - K_0 C) S0
  float CS0[O][D], S_0[O][O], X0[O][D], innov[O];
#pragma unroll
  for (int o = 0; o < O; ++o) {
    float m = Cf[o][0] * m0f[0];
#pragma unroll
    for (int k = 1; k < D; ++k) m = m + Cf[o][k] * m0f[k];
    innov[o] = yf[o] - m;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float v = Cf[o][0] * S0f[0][j];
#pragma unroll
      for (int k = 1; k < D; ++k) v = v + Cf[o][k] * S0f[k][j];
      CS0[o][j] = v;
    }
  }
#pragma unroll
  for (int i = 0; i < O; ++i)
#pragma unroll
    for (int j = 0; j < O; ++j) {
      float v = CS0[i][0] * Cf[j][0];
#pragma unroll
      for (int k = 1; k < D; ++k) v = v + CS0[i][k] * Cf[j][k];
      S_0[i][j] = i == j ? v + rf[i] : v;
    }
  psd_solve<float, O, D>(S_0, CS0, X0);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float b = X0[0][i] * innov[0];
#pragma unroll
    for (int o = 1; o < O; ++o) b = b + X0[o][i] * innov[o];
    put(Lt::B_FIRST + i, {m0f[i] + b, 0.f});
    float IK[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float v = X0[0][i] * Cf[0][j];
#pragma unroll
      for (int o = 1; o < O; ++o) v = v + X0[o][i] * Cf[o][j];
      IK[j] = (i == j ? 1.f : 0.f) - v;
    }
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float v = IK[0] * S0f[0][j];
#pragma unroll
      for (int k = 1; k < D; ++k) v = v + IK[k] * S0f[k][j];
      put(Lt::C_FIRST + i * D + j, {v, 0.f});
      put(Lt::A + i * D + j, {Af[i][j], 0.f});
      put(Lt::S0 + i * D + j, {S0f[i][j], 0.f});
    }
    put(Lt::M0 + i, {m0f[i], 0.f});
  }
#pragma unroll
  for (int o = 0; o < O; ++o) {
    put(Lt::R + o, {rf[o], 0.f});
#pragma unroll
    for (int k = 0; k < D; ++k) put(Lt::COBS + o * D + k, {Cf[o][k], 0.f});
  }
}

// the Adam step: one block, each thread a lane at a time
constexpr int STEP_NT = 256;

__global__ void __launch_bounds__(STEP_NT) adam_step_kernel(
    const float* __restrict__ ll, const float* __restrict__ dll, const float* __restrict__ mask,
    float* __restrict__ s_log, float* __restrict__ mu, float* __restrict__ nu, int* __restrict__ count,
    float* __restrict__ prev_loss, int* __restrict__ iters, bool* __restrict__ done, int* __restrict__ n_active,
    int n, int b_max, float lr, float tol, int safety_cap) {
  // the Python constants as torch rounds them to float32
  constexpr float B1 = 0.9, B2 = 0.999, C1 = 1.0 - 0.9, C2 = 1.0 - 0.999, EPS = 1e-8;
  constexpr float FLOOR = 1e-12, PENALTY = 1e12, ABS_TOL = 1e-6;
  __shared__ int block_active;
  if (threadIdx.x == 0) block_active = 0;
  __syncthreads();
  int still_active = 0;
  for (int j = threadIdx.x; j < n; j += STEP_NT) {
    if (!done[j] && iters[j] < safety_cap) {
      float loss = 0.f, grad = 0.f;
      for (int m = j * b_max; m < (j + 1) * b_max; ++m) {
        const bool finite = isfinite(ll[m]);
        loss = __fadd_rn(loss, __fmul_rn(finite ? -ll[m] : PENALTY, mask[m]));
        grad = __fadd_rn(grad, __fmul_rn(finite ? -dll[m] : 0.f, mask[m]));
      }
      const float g = __fmul_rn(grad, lr);
      const float mu_new = __fadd_rn(__fmul_rn(C1, g), __fmul_rn(B1, mu[j]));
      const float nu_new = __fadd_rn(__fmul_rn(C2, __fmul_rn(g, g)), __fmul_rn(B2, nu[j]));
      const int c = count[j] + 1;
      const float mu_hat = __fdiv_rn(mu_new, __fsub_rn(1.f, powf(B1, (float)c)));
      const float nu_hat = __fdiv_rn(nu_new, __fsub_rn(1.f, powf(B2, (float)c)));
      const float step = __fdiv_rn(mu_hat, __fadd_rn(__fsqrt_rn(__fadd_rn(nu_hat, 0.f)), EPS));
      // the stop rule: torch.maximum keeps a NaN
      const float prev = prev_loss[j];
      const float floored = (isnan(prev) || prev > FLOOR) ? prev : FLOOR;
      const float threshold = __fadd_rn(__fmul_rn(fabsf(logf(floored)), tol), ABS_TOL);
      const bool stop = isfinite(prev) && fabsf(__fsub_rn(loss, prev)) < threshold;
      s_log[j] = __fadd_rn(s_log[j], -step);
      mu[j] = mu_new;
      nu[j] = nu_new;
      count[j] = c;
      prev_loss[j] = loss;
      iters[j] += 1;
      done[j] = stop;
    }
    still_active += !done[j] && iters[j] < safety_cap;
  }
  if (still_active) atomicAdd(&block_active, still_active);
  __syncthreads();
  if (threadIdx.x == 0) *n_active = block_active;
}

}  // namespace

// The threads per block and the most steps a segment may hold: what the
// wrapper partitions by.
extern "C" int fused_nll_geometry(int* threads, int* max_steps) {
  *threads = NT;
  *max_steps = TILE;
  return 0;
}

// The (D, O) instances the library builds, as D[i], O[i] for i < the
// returned count (at most cap are written).
extern "C" int fused_nll_shapes(int* D, int* O, int cap) {
  int n = 0;
#define FUSED_NLL_LIST(d, o)         \
  if (n < cap) D[n] = d, O[n] = o;   \
  ++n;
  FUSED_NLL_SHAPES(FUSED_NLL_LIST)
#undef FUSED_NLL_LIST
  return n;
}

// y: (N, O, T); table: (N, n_scal); out: (N,); totals (N, G, P) and partials
// (N, G) float32 scratch, G segments per lane with none empty and none longer
// than fused_nll_geometry's max_steps. float32, contiguous. Returns the CUDA
// error of the launches (0 on success); a (D, O) the library does not build,
// or a bad partition, returns cudaErrorInvalidValue without launching.
extern "C" int fused_nll_f32(const float* y, const float* table, float* out, float* totals, float* partials,
                             int N, int T, int D, int O, int G, void* stream) {
  return launch<float>(y, table, nullptr, out, totals, partials, N, T, D, O, G, stream);
}

// As fused_nll_f32, with dtable (N, n_scal) the table's tangent; out is
// (2, N): row 0 the log-likelihoods, row 1 their derivatives; totals is
// (N, G, 2P) and partials (2, N, G).
extern "C" int fused_nll_paired_f32(const float* y, const float* table, const float* dtable, float* out,
                                    float* totals, float* partials, int N, int T, int D, int O, int G,
                                    void* stream) {
  return launch<eks::Dual>(y, table, dtable, out, totals, partials, N, T, D, O, G, stream);
}

// The s-optimizer's paired scalar table: for each of N = n_blocks * b_max
// lanes, table and dtable (N, n_scal) in ops/pkalman.py::_scalar_offsets'
// layout, at Q = exp(clamp(s_log[lane / b_max], s_lo, s_hi)) Q_base and along
// log s. s_log (n_blocks,); y0 and r (N, O); m0 (N, D); S0, A and Q_base
// (N, D, D); C (N, O, D). float32, contiguous. Returns the CUDA error of the
// launch (0 on success); a (D, O) the library does not build, or a b_max
// that does not divide N, returns cudaErrorInvalidValue without launching.
extern "C" int nll_table_paired_f32(const float* s_log, const float* y0, const float* m0, const float* S0,
                                    const float* A, const float* Q_base, const float* C, const float* r,
                                    float* table, float* dtable, int N, int b_max, int D, int O, float s_lo,
                                    float s_hi, void* stream) {
  if (N <= 0 || b_max <= 0 || N % b_max) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define NLL_TABLE_TRY(d, o)                                                                             \
  if (D == d && O == o) {                                                                               \
    nll_table_paired_kernel<d, o><<<(N + NT - 1) / NT, NT, 0, s>>>(s_log, y0, m0, S0, A, Q_base, C, r, \
                                                                   table, dtable, N, b_max, s_lo, s_hi); \
    return (int)cudaGetLastError();                                                                     \
  }
  FUSED_NLL_SHAPES(NLL_TABLE_TRY)
#undef NLL_TABLE_TRY
  return (int)cudaErrorInvalidValue;
}

// One Adam step of the s-optimizer over n block lanes of b_max members each:
// ll, dll and mask (n * b_max) the members' log-likelihoods, their derivatives
// along log s and their weights; s_log, mu, nu, prev_loss (n) float32, count
// and iters (n) int32 and done (n) bool, the state, updated in place where a
// lane is active (!done && iters < safety_cap); n_active, a device pointer
// (adam_step_host_word) to the count of lanes active after the step. Launches
// on the stream with `device` current, restoring the caller's device.
// Returns the CUDA error of the launch (0 on success); n or b_max below 1
// returns cudaErrorInvalidValue without launching.
extern "C" int adam_step_f32(const float* ll, const float* dll, const float* mask, float* s_log, float* mu,
                             float* nu, int* count, float* prev_loss, int* iters, bool* done, int* n_active, int n,
                             int b_max, float lr, float tol, int safety_cap, int device, void* stream) {
  if (n <= 0 || b_max <= 0) return (int)cudaErrorInvalidValue;
  int current = device;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  adam_step_kernel<<<1, STEP_NT, 0, (cudaStream_t)stream>>>(ll, dll, mask, s_log, mu, nu, count, prev_loss, iters,
                                                            done, n_active, n, b_max, lr, tol, safety_cap);
  err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return (int)err;
}

// The device pointer of a pinned host word (page-locked by cudaHostAlloc or
// registered), for adam_step_f32's n_active. Returns the CUDA error.
extern "C" int adam_step_host_word(int* host, int** device_ptr) {
  return (int)cudaHostGetDevicePointer((void**)device_ptr, host, 0);
}

// Wait for `stream`: the Adam loop's one sync an iteration, after which the
// host reads the mapped word. Returns the CUDA error.
extern "C" int adam_step_wait(void* stream) { return (int)cudaStreamSynchronize((cudaStream_t)stream); }
