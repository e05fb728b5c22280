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
// FUSED_NLL_SHAPES is the one list of instances: the C dispatch and
// fused_nll_shapes() both expand it.
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
