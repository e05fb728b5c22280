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
// or paired. So the single-lane kernels are N = 1 of the lane-batched ones.
// It is instantiated at every D <= 3, where the JAX package runs its Pallas
// scan (_use_pallas); beyond, the wrapper runs the plain scan on the card,
// as the JAX package runs XLA's associative_scan. A second entry,
// carry_combine_f32, combines each chunk of a time-sharded scan with the
// carry of the chunks before it (see carry_combine_kernel).
//
// Input and output are (N, W * P, T) float32 planes, W = 1 for float and 2
// for Dual (the P primal planes, then the P tangent planes). P = 3D² + 2D for
// the filter (5 at D = 1, 16 at D = 2, 33 at D = 3) and 2D² + D for the
// smoother (3, 10, 21).
// The filter scans forward in time. The smoother scans backward: scan
// position i is time step T-1-i, read and written in place by index, so no
// flipped copy of the planes is ever made, and its combine takes the element
// later in time first.
//
// Bound on the H100: the scan reads each input plane once and writes each
// output plane once, 2 * N * W * P * T * 4 bytes (25.6 MB for the filter at
// N = 20, D = 2, T = 10,000; 52.8 MB for the paired filter at N = 10, D = 3),
// against one combine per step (about 150 FP32 operations for the float
// filter at D = 2, 1,556 for the Dual filter at D = 3); so memory bytes bound
// every instance, at 7.6 us and 15.8 us at 3.35 TB/s.
//
// Design: the lane x segment grid of filter_algebra.cuh. Each lane's T scan
// positions are cut into G segments (the wrapper picks G from N, T and the
// card's SM count, ops/fused_filter.py::segment_partition), one block of NT
// threads each, in three stream-ordered launches: reduce (each segment's
// total into an (N, G, W * P) scratch), totals (one block per lane, the
// exclusive prefix of its totals), downsweep (each segment again from its
// carry-in). A block stages its whole segment, W * P planes of at most TILE
// steps, in shared memory with coalesced cp.async copies; its threads walk
// contiguous chunks of at most CH steps out of it; the downsweep writes each
// result into the tile and stores the tile back coalesced, so every output
// position is written once. The input is read twice (reduce and downsweep),
// the price of a scan that spreads one lane over many SMs without
// timing-dependent look-back. TILE is chosen so that two blocks fit an SM's
// shared memory beside the block scan's W * P * NT floats. Registers are the
// scarce resource: a D = 3 Dual element is 66 floats and a combine holds
// three, so the Dual D = 3 instances sit at 255 registers and two 128-thread
// blocks per SM. Tensor cores play no part: the products are D x D with
// D <= 3 inside a chain of dependent combines, and wgmma's smallest tile is
// 64 rows.
#include "filter_algebra.cuh"

namespace {

constexpr int NT = 128;
// shared memory one block may take, so that two fit an SM
constexpr int SMEM_BUDGET = 110 * 1024;

template <typename Alg>
struct Geometry {
  static constexpr int WP = eks::Scalar<typename Alg::Scalar>::W * Alg::P;
  static constexpr int CH_FIT = (SMEM_BUDGET / (4 * WP) - NT) * 32 / (33 * NT);
  // steps per thread at most, and per segment (what a block stages)
  static constexpr int CH = CH_FIT < 1 ? 1 : (CH_FIT > 8 ? 8 : CH_FIT);
  static constexpr int TILE = NT * CH;
  static constexpr int STRIDE = eks::padded_stride(TILE);
  static constexpr int SCAN_FLOATS = WP * NT;
  static constexpr int SMEM = (WP * STRIDE + SCAN_FLOATS) * (int)sizeof(float);
};

// the segment of this block: scan positions [lo, lo + n); its tile slot k
// holds time step t0 + k, and scan position lo + j sits in slot slot(j)
template <typename Alg>
struct Segment {
  int lo, n, t0;
  __device__ Segment(int T, int L) {
    lo = blockIdx.x * L;
    n = min(L, T - lo);
    t0 = Alg::REVERSED ? T - lo - n : lo;
  }
  __device__ int slot(int j) const { return Alg::REVERSED ? n - 1 - j : j; }
};

template <typename Alg>
__device__ __forceinline__ typename Alg::Elem chunk_total(const float* tile, const Segment<Alg>& sg,
                                                          int a, int b) {
  using Geo = Geometry<Alg>;
  typename Alg::Elem tot = Alg::identity();
  for (int j = a; j < b; ++j) {
    const typename Alg::Elem e = eks::tile_get<Alg>(tile, Geo::STRIDE, sg.slot(j));
    tot = j == a ? e : Alg::op(tot, e);
  }
  return tot;
}

// launch 1: the totals of segments 0 .. G-2
template <typename Alg>
__global__ void __launch_bounds__(NT) scan_reduce_kernel(const float* __restrict__ in,
                                                         float* __restrict__ totals, int T, int L,
                                                         int G) {
  using Geo = Geometry<Alg>;
  extern __shared__ float smem[];
  float* tile = smem;
  float* buf = smem + Geo::WP * Geo::STRIDE;
  const int lane = blockIdx.y;
  const Segment<Alg> sg(T, L);
  eks::stage_async<NT>(tile, Geo::STRIDE, in + ((size_t)lane * Geo::WP * T + sg.t0), T, Geo::WP, sg.n);
  int a, b;
  eks::chunk_of<NT>(sg.n, a, b);
  const typename Alg::Elem tot = eks::block_reduce_of<Alg, NT>(chunk_total(tile, sg, a, b), buf);
  if (threadIdx.x == 0) eks::total_put<Alg>(totals + ((size_t)lane * G + blockIdx.x) * Geo::WP, tot);
}

// launch 2: each lane's exclusive prefix of its segment totals
template <typename Alg>
__global__ void __launch_bounds__(NT) scan_totals_kernel(float* __restrict__ totals, int G) {
  extern __shared__ float smem[];  // W * P * NT floats
  eks::scan_segment_totals<Alg, NT>(totals, G, smem);
}

// launch 3: every segment from its carry-in, each output position written once
template <typename Alg>
__global__ void __launch_bounds__(NT) scan_downsweep_kernel(const float* __restrict__ in,
                                                            float* __restrict__ out,
                                                            const float* __restrict__ totals, int T,
                                                            int L, int G) {
  using Geo = Geometry<Alg>;
  using Elem = typename Alg::Elem;
  extern __shared__ float smem[];
  float* tile = smem;
  float* buf = smem + Geo::WP * Geo::STRIDE;
  const int lane = blockIdx.y;
  const Segment<Alg> sg(T, L);
  const size_t base = (size_t)lane * Geo::WP * T + sg.t0;
  eks::stage_async<NT>(tile, Geo::STRIDE, in + base, T, Geo::WP, sg.n);
  int a, b;
  eks::chunk_of<NT>(sg.n, a, b);
  // the combination of every earlier chunk of the segment, after the
  // segment's carry-in (the identity for the lane's first segment)
  const Elem excl = eks::block_exclusive_scan_of<Alg, NT>(chunk_total(tile, sg, a, b), buf);
  Elem pre = blockIdx.x == 0
                 ? excl
                 : Alg::op(eks::total_get<Alg>(totals + ((size_t)lane * G + blockIdx.x) * Geo::WP), excl);
  for (int j = a; j < b; ++j) {
    const int k = sg.slot(j);
    pre = j == 0 && blockIdx.x == 0 ? eks::tile_get<Alg>(tile, Geo::STRIDE, k)
                                    : Alg::op(pre, eks::tile_get<Alg>(tile, Geo::STRIDE, k));
    eks::tile_put<Alg>(tile, Geo::STRIDE, k, pre);
  }
  __syncthreads();
  eks::store_planes<NT>(out + base, T, tile, Geo::STRIDE, Geo::WP, sg.n);
}

template <typename Alg>
int launch(const float* in, float* out, float* totals, int N, int T, int G, cudaStream_t s) {
  using Geo = Geometry<Alg>;
  const int L = (T + G - 1) / G;
  if (G < 1 || L > Geo::TILE || (G - 1) * L >= T) return (int)cudaErrorInvalidValue;
  auto reduce = scan_reduce_kernel<Alg>;
  auto totals_scan = scan_totals_kernel<Alg>;
  auto downsweep = scan_downsweep_kernel<Alg>;
  // above 48 KB of dynamic shared memory: opt in, once per device
  static bool opted_in[eks::MAX_DEVICES];
  cudaError_t err = eks::once_per_device(opted_in, [&] {
    cudaError_t e = cudaFuncSetAttribute(reduce, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(downsweep, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(totals_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Geo::SCAN_FLOATS * (int)sizeof(float));
    return e;
  });
  if (err != cudaSuccess) return (int)err;
  if (G > 1) {
    reduce<<<dim3(G - 1, N), NT, Geo::SMEM, s>>>(in, totals, T, L, G);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    totals_scan<<<N, NT, Geo::SCAN_FLOATS * sizeof(float), s>>>(totals, G);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  downsweep<<<dim3(G, N), NT, Geo::SMEM, s>>>(in, out, totals, T, L, G);
  return (int)cudaGetLastError();
}

// The cross-shard carry of a time-sharded scan: out[n, :, t] =
// op(carry[n], in[n, :, t]) for every step t of one shard's chunk, where `in`
// is the chunk's own inclusive scan and `carry` the combination of every
// earlier chunk in scan order (the chunks before it in time for the filter,
// after it for the smoother, whose op takes the later element first).
// Replaces no Pallas kernel: the JAX package shards the time axis through
// XLA's associative_scan under the SPMD partitioner, which carries these
// combines with collectives (eks_tpu/parallel/mesh.py::shard_time). One
// thread per (lane, step), consecutive threads on consecutive steps, so every
// plane is read and written coalesced; the carry is the same few floats for
// every thread of a lane. Bound on the H100: one elementwise pass, each plane
// read once and written once, 2 * N * W * P * T * 4 bytes (6.4 MB for the
// filter at N = 20, D = 2 over a 2,500-step chunk: 1.9 us at 3.35 TB/s),
// against one combine a step. Folding the carry into the scan's downsweep
// would save this pass.
template <typename Alg>
__global__ void __launch_bounds__(NT) carry_combine_kernel(const float* __restrict__ carry,
                                                           const float* __restrict__ in,
                                                           float* __restrict__ out, int T) {
  using Sc = eks::Scalar<typename Alg::Scalar>;
  using Elem = typename Alg::Elem;
  constexpr int P = Alg::P;
  const int t = blockIdx.x * NT + threadIdx.x;
  if (t >= T) return;
  const int lane = blockIdx.y;
  const Elem c = eks::total_get<Alg>(carry + (size_t)lane * Sc::W * P);
  const size_t base = (size_t)lane * Sc::W * P * T + t;
  Elem e;
#pragma unroll
  for (int p = 0; p < P; ++p) e.x[p] = Sc::get(in + base + (size_t)p * T, (size_t)P * T);
  const Elem r = Alg::op(c, e);
#pragma unroll
  for (int p = 0; p < P; ++p) Sc::put(out + base + (size_t)p * T, (size_t)P * T, r.x[p]);
}

template <typename Alg>
int launch_carry(const float* carry, const float* in, float* out, int N, int T, cudaStream_t s) {
  carry_combine_kernel<Alg><<<dim3((T + NT - 1) / NT, N), NT, 0, s>>>(carry, in, out, T);
  return (int)cudaGetLastError();
}

// f(Alg{}) for the instance (D, smoother, paired); every D <= 3, as the JAX
// package's Pallas scan: D = 2 (singlecam), D = 3 (pupil, multi-camera) and
// D = 1 (multi-camera at n_latent = 1)
template <typename S, typename F>
int with_scalar(int D, int smoother, F&& f) {
  if (D == 1) return smoother ? f(eks::SmootherAlgebra<S, 1>{}) : f(eks::FilterAlgebra<S, 1>{});
  if (D == 2) return smoother ? f(eks::SmootherAlgebra<S, 2>{}) : f(eks::FilterAlgebra<S, 2>{});
  if (D == 3) return smoother ? f(eks::SmootherAlgebra<S, 3>{}) : f(eks::FilterAlgebra<S, 3>{});
  return (int)cudaErrorInvalidValue;
}

template <typename F>
int with_algebra(int D, int smoother, int paired, F&& f) {
  return paired ? with_scalar<eks::Dual>(D, smoother, f) : with_scalar<float>(D, smoother, f);
}

}  // namespace

// The threads per block and the most steps a segment may hold for the
// instance (D, smoother, paired): what the wrapper partitions by. Returns
// cudaErrorInvalidValue for an instance that is not built.
extern "C" int prefix_scan_geometry(int D, int smoother, int paired, int* threads, int* max_steps) {
  return with_algebra(D, smoother, paired, [&](auto alg) {
    *threads = NT;
    *max_steps = Geometry<decltype(alg)>::TILE;
    return 0;
  });
}

// in, out: (N, W * P, T) float32 contiguous, distinct buffers; W = 2 with
// `paired` (primal planes, then tangent planes), else 1. `smoother` picks the
// RTS algebra and the backward direction, else the filter algebra forward.
// totals: (N, G, W * P) float32 scratch, G segments per lane with no empty
// segment and none longer than prefix_scan_geometry's max_steps. Returns the
// CUDA error of the launches (0 on success); an unsupported D or partition
// returns cudaErrorInvalidValue without launching.
extern "C" int prefix_scan_f32(const float* in, float* out, float* totals, int N, int T, int D,
                               int smoother, int paired, int G, void* stream) {
  if (N <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return with_algebra(D, smoother, paired,
                      [&](auto alg) { return launch<decltype(alg)>(in, out, totals, N, T, G, s); });
}

// carry: (N, W * P) float32, each lane's combination of the earlier chunks
// (W = 2 with `paired`: the P primal values, then the P tangents); in, out:
// (N, W * P, T) float32 contiguous, the chunk's own inclusive scan and the
// result (distinct buffers). Returns the CUDA error of the launch (0 on
// success); an unsupported D returns cudaErrorInvalidValue without launching.
extern "C" int carry_combine_f32(const float* carry, const float* in, float* out, int N, int T, int D,
                                 int smoother, int paired, void* stream) {
  if (N <= 0 || T <= 0 || N > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return with_algebra(D, smoother, paired,
                      [&](auto alg) { return launch_carry<decltype(alg)>(carry, in, out, N, T, s); });
}
