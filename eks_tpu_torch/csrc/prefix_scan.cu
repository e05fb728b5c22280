// Kernels B and D: inclusive scans of Kalman filtering and RTS smoothing
// elements over N lanes, on plain floats or on (primal, tangent) pairs; and
// the same scans of one chunk of a time-sharded sequence from its carry-in.
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
// as the JAX package runs XLA's associative_scan.
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
//
// The carried scan of a time-sharded sequence (parallel/mesh.py) is the
// same three launches cut into two phases, so that the host can combine the
// chunks' totals in between. It replaces no Pallas kernel: the JAX package
// shards the time axis through XLA's associative_scan under the SPMD
// partitioner, which carries the combines with collectives
// (eks_tpu/parallel/mesh.py::shard_time).
//   phase A, prefix_scan_total_f32: the reduce over all G segments, the last
//     one too, and the totals launch, which writes the exclusive prefixes as
//     above and each lane's inclusive total in scan order into an (N, W * P)
//     output: the chunk's total, copied from the block scan's last inclusive
//     prefix, so no combine is added. G = 1 is one reduce block and the total.
//   phase B, prefix_scan_carried_f32: the downsweep, from an (N, W * P)
//     carry, the combination of every chunk before this one in scan order
//     (for the smoother the chunks later in time, and op takes the later
//     element first). Segment g's carry-in is op(carry, excl_g), segment 0's
//     the carry itself, so scan position 0 gives op(carry, e_0) where the
//     uncarried scan gives e_0. Each thread combines the carry with its own
//     carry-in before the loop over its chunk, so no more elements are live
//     than in the loop: ptxas gives the carried Dual D = 3 downsweep the
//     uncarried one's 255 registers, and no instance spills. A null carry
//     runs the uncarried downsweep (the first chunk in scan order). Each
//     output position is still written once, from the tile.
// Bound of a carried chunk: the scan's own, each plane read once and written
// once, plus the carry read and the total written, 2 * N * W * P * (T + 1) * 4
// bytes; the separate carry pass this replaces read and wrote the chunk's
// output once more (2 * N * W * P * T * 4 bytes, 6.4 MB for the filter at
// N = 20, D = 2 over a 2,500-step chunk) in a launch of its own.
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

// launch 1: the totals of segments 0 .. G-2 (of all G in phase A of a
// carried scan: the grid decides)
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

// launch 2: each lane's exclusive prefix of its segment totals; with
// TOTAL (phase A of a carried scan) every segment's total is read and the
// lane's inclusive total goes to total_out, (N, W * P)
template <typename Alg, bool TOTAL>
__global__ void __launch_bounds__(NT) scan_totals_kernel(float* __restrict__ totals, int G,
                                                         float* __restrict__ total_out) {
  extern __shared__ float smem[];  // W * P * NT floats
  eks::scan_segment_totals<Alg, NT, TOTAL>(totals, G, smem, total_out);
}

// launch 3: every segment from its carry-in, each output position written
// once; with CARRIED, from the (N, W * P) carry of the chunks before this one
// in scan order
template <typename Alg, bool CARRIED>
__global__ void __launch_bounds__(NT) scan_downsweep_kernel(const float* __restrict__ in,
                                                            float* __restrict__ out,
                                                            const float* __restrict__ totals,
                                                            const float* __restrict__ carry, int T,
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
  // the carry before it all, before the loop, so that no more than three
  // elements are live at once (op with the identity, on the lane's first
  // position, returns the carry's own bits)
  if constexpr (CARRIED) pre = Alg::op(eks::total_get<Alg>(carry + (size_t)lane * Geo::WP), pre);
  for (int j = a; j < b; ++j) {
    const int k = sg.slot(j);
    pre = !CARRIED && j == 0 && blockIdx.x == 0 ? eks::tile_get<Alg>(tile, Geo::STRIDE, k)
                                                : Alg::op(pre, eks::tile_get<Alg>(tile, Geo::STRIDE, k));
    eks::tile_put<Alg>(tile, Geo::STRIDE, k, pre);
  }
  __syncthreads();
  eks::store_planes<NT>(out + base, T, tile, Geo::STRIDE, Geo::WP, sg.n);
}

// the instance's shared-memory opt-in above 48 KB, for all its kernels,
// once per device
template <typename Alg>
cudaError_t opt_in() {
  static bool done[eks::MAX_DEVICES];
  return eks::once_per_device(done, [] {
    using Geo = Geometry<Alg>;
    const int scan_bytes = Geo::SCAN_FLOATS * (int)sizeof(float);
    auto reduce = scan_reduce_kernel<Alg>;
    auto totals = scan_totals_kernel<Alg, false>;
    auto totals_carried = scan_totals_kernel<Alg, true>;
    auto downsweep = scan_downsweep_kernel<Alg, false>;
    auto downsweep_carried = scan_downsweep_kernel<Alg, true>;
    cudaError_t e = cudaFuncSetAttribute(reduce, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(downsweep, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(downsweep_carried, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(totals, cudaFuncAttributeMaxDynamicSharedMemorySize, scan_bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(totals_carried, cudaFuncAttributeMaxDynamicSharedMemorySize, scan_bytes);
    return e;
  });
}

// the segment length of a partition into G segments, or 0 where the
// instance does not take it (no segment, one past its tile, or an empty one)
template <typename Alg>
int segment_length(int T, int G) {
  if (G < 1) return 0;
  const int L = (T + G - 1) / G;
  return L > Geometry<Alg>::TILE || (G - 1) * L >= T ? 0 : L;
}

template <typename Alg>
int launch(const float* in, float* out, float* totals, int N, int T, int G, cudaStream_t s) {
  using Geo = Geometry<Alg>;
  const int L = segment_length<Alg>(T, G);
  if (L == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = opt_in<Alg>();
  if (err != cudaSuccess) return (int)err;
  if (G > 1) {
    scan_reduce_kernel<Alg><<<dim3(G - 1, N), NT, Geo::SMEM, s>>>(in, totals, T, L, G);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    scan_totals_kernel<Alg, false><<<N, NT, Geo::SCAN_FLOATS * sizeof(float), s>>>(totals, G, nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  scan_downsweep_kernel<Alg, false><<<dim3(G, N), NT, Geo::SMEM, s>>>(in, out, totals, nullptr, T, L, G);
  return (int)cudaGetLastError();
}

// phase A of a carried scan: every segment's total, their exclusive
// prefixes in `totals` and the lane's total in `total_out`
template <typename Alg>
int launch_total(const float* in, float* totals, float* total_out, int N, int T, int G, cudaStream_t s) {
  using Geo = Geometry<Alg>;
  const int L = segment_length<Alg>(T, G);
  if (L == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = opt_in<Alg>();
  if (err != cudaSuccess) return (int)err;
  scan_reduce_kernel<Alg><<<dim3(G, N), NT, Geo::SMEM, s>>>(in, totals, T, L, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scan_totals_kernel<Alg, true><<<N, NT, Geo::SCAN_FLOATS * sizeof(float), s>>>(totals, G, total_out);
  return (int)cudaGetLastError();
}

// phase B: the downsweep from phase A's prefixes and the carry (none: the
// uncarried downsweep)
template <typename Alg>
int launch_carried(const float* in, float* out, const float* totals, const float* carry, int N, int T,
                   int G, cudaStream_t s) {
  using Geo = Geometry<Alg>;
  const int L = segment_length<Alg>(T, G);
  if (L == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = opt_in<Alg>();
  if (err != cudaSuccess) return (int)err;
  if (carry == nullptr)
    scan_downsweep_kernel<Alg, false><<<dim3(G, N), NT, Geo::SMEM, s>>>(in, out, totals, nullptr, T, L, G);
  else
    scan_downsweep_kernel<Alg, true><<<dim3(G, N), NT, Geo::SMEM, s>>>(in, out, totals, carry, T, L, G);
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

// Phase A of the carried scan of one chunk: in is (N, W * P, T) as for
// prefix_scan_f32, totals the same (N, G, W * P) scratch, which phase B
// reads, and total_out (N, W * P) float32, each lane's inclusive total in
// scan order (W = 2 with `paired`: the P primal values, then the P
// tangents). G = 1 is allowed. Returns the CUDA error of the launches (0 on
// success); an unsupported D or partition returns cudaErrorInvalidValue
// without launching.
extern "C" int prefix_scan_total_f32(const float* in, float* totals, float* total_out, int N, int T, int D,
                                     int smoother, int paired, int G, void* stream) {
  if (N <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return with_algebra(D, smoother, paired, [&](auto alg) {
    return launch_total<decltype(alg)>(in, totals, total_out, N, T, G, s);
  });
}

// Phase B: out (N, W * P, T), distinct from in; totals as phase A left it on
// the same in, N, T, G and instance; carry (N, W * P) float32, each lane's
// combination of the chunks before this one in scan order, laid out as
// total_out, or null for the first chunk in scan order. Returns as phase A.
extern "C" int prefix_scan_carried_f32(const float* in, float* out, const float* totals, const float* carry,
                                       int N, int T, int D, int smoother, int paired, int G, void* stream) {
  if (N <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return with_algebra(D, smoother, paired, [&](auto alg) {
    return launch_carried<decltype(alg)>(in, out, totals, carry, N, T, G, s);
  });
}
