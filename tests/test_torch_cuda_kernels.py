"""Kernels A (every (D, O) instance), B (every instance of the scan: filter
and smoother algebra, plain and paired, over lanes, D = 1 to 3) and C of
the PyTorch port on the card, against
their plain versions on the same inputs, at the edge shapes the full-width runs of
chip_smoke.py do not reach: a single step, a single lane, fewer steps than
threads, time axes one either side of a multiple of the block and of a
segment, a long lane and a wide batch; whether two launches of each
kernel on the same inputs give the same bits; that the instances the
library of kernel A reports are the ones its wrapper takes; that scans
beyond D = 3 take the plain version on the card, counted, as the JAX
package takes XLA's scan there; and the carried scan of the time-sharded
scans (every instance of its two phases against its plain version, the
sharded scans against the unsharded kernel scan, one chunk against the
uncarried scan bit for bit, a loss evaluated by worker threads at once).

The kernels have no CPU mode, so every test here needs a CUDA card and
``nvcc``; on a machine without them each one skips. On the card (where JAX is
not installed, hence no conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from eks_tpu_torch import tracing
from eks_tpu_torch.ops import fused_filter, fused_nll, pkalman

pytestmark = pytest.mark.cuda

# the kernels combine the same elements as the plain versions in another
# association order (segments, per-thread chunks and block sweeps against a
# log-depth tree), in float32; entry by entry, relative to 1 + the entry's magnitude
RTOL = 1e-5
# kernel A's d ll/d log s on a lane against the float64 plain version,
# relative to 1 + the lane's own |d ll| (see test_kernel_a_instances_match_plain)
RTOL_DLL_LANE = 1e-4


def _kernel_a_launches() -> tuple:
    """Kernel A's launches, plain and paired, summed over its instances."""
    return tracing.launches("A", None, None, False), tracing.launches("A", None, None, True)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there; the CPU tests hold their plain versions")
    return torch.device("cuda")


def _steps(spec, key):
    """T for an edge case: an int, or "thr" / "tile" plus or minus one. A
    segment holds at least one step per thread ("thr") unless the lane is
    shorter, and at most what a block stages ("tile"); at N = 300 lanes the
    partition wants one segment, so T = tile + 1 is the least T with two
    full-size segments. ``key`` is a scan instance (kind, paired, D), "C"
    for kernel C, or ("A", D) for kernel A at D."""
    if isinstance(spec, int):
        return spec
    if key == "C":
        threads, tile = fused_nll._geometry("fused_nll_tv")
    elif key[0] == "A":
        threads, tile = fused_nll._geometry("fused_nll")
    else:
        threads, tile = fused_filter._geometry(*key)
    base, _, delta = spec.partition("+") if "+" in spec else spec.partition("-")
    sign = -1 if "-" in spec else 1
    return {"thr": threads, "tile": tile}[base] + sign * int(delta or 0)


# the lane x segment grid's edge cases, as (N, T): one segment of one step
# per thread and either side of it, the largest segment and one past it, T
# below the SM count, a long lane, a wide batch at the main paths' T
SEGMENT_CASES = [(3, "thr-1"), (3, "thr"), (3, "thr+1"), (300, "tile"), (300, "tile+1"), (2, 100),
                 (1, 100_000), (16, 10_000)]


def _close(got, want):
    err = float(((got - want).abs() / (1.0 + want.abs())).max())
    assert err <= RTOL, err


def _lanes(N, T, O, D, seed=0):
    rng = np.random.default_rng(seed)
    ys = (rng.normal(size=(N, T, O)).cumsum(axis=1) * 0.1).astype(np.float32)
    m0 = (rng.normal(size=(N, D)) * 0.3).astype(np.float32)
    S0 = np.tile(np.eye(D, dtype=np.float32) * 1.3, (N, 1, 1))
    A = np.tile(np.eye(D, dtype=np.float32), (N, 1, 1))
    Q = np.tile(np.eye(D, dtype=np.float32) * 0.7, (N, 1, 1))
    C = (np.tile(np.eye(O, D), (N, 1, 1)) + 0.05 * rng.normal(size=(N, O, D))).astype(np.float32)
    r = (np.abs(rng.normal(size=(N, O))) * 0.5 + 0.2).astype(np.float32)
    r_tv = (np.abs(rng.normal(size=(N, T, O))) * 0.5 + 0.2).astype(np.float32)
    return ys, m0, S0, A, Q, C, r, r_tv


def _ar1(N, T, O, seed):
    """A stationary AR(1) series (N, T, O): the long cases' observations,
    for the reason ``_nll_tv_operands`` gives."""
    e = np.random.default_rng(seed).normal(size=(N, T, O)).astype(np.float32)
    ys = np.empty_like(e)
    ys[:, 0] = e[:, 0]
    for t in range(1, T):
        ys[:, t] = 0.95 * ys[:, t - 1] + e[:, t]
    return ys


def _nll_operands(dev, N, T, O=2, D=2, walk=True):
    ys, m0, S0, A, Q, C, r, _ = _lanes(N, T, O, D)
    if not walk:
        ys = _ar1(N, T, O, seed=T)
    ys, m0, S0, A, Q, C, r = (torch.as_tensor(x, device=dev) for x in (ys, m0, S0, A, Q, C, r))
    s_log = torch.linspace(-1.0, 1.0, N, device=dev)

    def pack(sl):
        return pkalman._pack_scalars(ys[:, 0], m0, S0, A, torch.exp(sl)[:, None, None] * Q, C, r)

    table, dtable = torch.func.jvp(pack, (s_log,), (torch.ones_like(s_log),))
    return table.contiguous(), dtable.contiguous(), ys.transpose(1, 2).contiguous()


@pytest.mark.parametrize("N,T", [(1, 1), (3, 5), (4, 255), (2, 257), (20, 1000)])
def test_kernel_a_matches_plain(dev, N, T):
    table, dtable, y = _nll_operands(dev, N, T)
    before = _kernel_a_launches()
    ll = fused_nll.fused_nll(table, y)
    ll_p, dll_p = fused_nll.fused_nll_paired(table, dtable, y)
    torch.cuda.synchronize()
    assert _kernel_a_launches() == (before[0] + 1, before[1] + 1)
    want = fused_nll._fused_nll_plain(table, y)
    want_p, want_dp = fused_nll._fused_nll_paired_plain(table, dtable, y)
    _close(ll, want)
    _close(ll_p, want_p)
    _close(dll_p, want_dp)
    # the fixed-order block reduction makes the kernel deterministic
    assert torch.equal(fused_nll.fused_nll(table, y), ll)


@pytest.mark.parametrize("N,T,O", [(1, 1, 4), (3, 255, 4), (2, 257, 6), (10, 1000, 4), (3, 300, 8)])
def test_kernel_a_at_d3_matches_plain(dev, N, T, O):
    """The multi-camera instances, (D, O) = (3, 4), (3, 6), (3, 8)."""
    table, dtable, y = _nll_operands(dev, N, T, O=O, D=3)
    before = _kernel_a_launches()
    ll = fused_nll.fused_nll(table, y)
    ll_p, dll_p = fused_nll.fused_nll_paired(table, dtable, y)
    torch.cuda.synchronize()
    assert _kernel_a_launches() == (before[0] + 1, before[1] + 1)
    want_p, want_dp = fused_nll._fused_nll_paired_plain(table, dtable, y)
    _close(ll, want_p)
    _close(ll_p, want_p)
    _close(dll_p, want_dp)


@pytest.mark.parametrize("D,O", [shape for shape in fused_nll._CUDA_SHAPES if shape not in ((2, 2), (3, 4))])
@pytest.mark.parametrize("N,T,walk", [(1, 1, True), (3, "thr-1", True), (3, "thr", True), (3, "thr+1", True),
                                      (300, "tile", True), (300, "tile+1", True), (16, 10_000, False)])
def test_kernel_a_instances_match_plain(dev, D, O, N, T, walk):
    """Every other instance of kernel A (n_latent 1 and 2, and D = 3 at one
    camera's O = 2) on the grid's edge cases: one step, one segment of one
    step per thread and either side of it, the largest segment and one past
    it over 300 lanes, and a wide batch of long lanes (AR(1) observations).
    d ll/d log s is held two ways. Against the float32 plain version at RTOL
    of 1 + the batch's largest |d ll|: the lanes' s run from e^-1 to e, so on
    the lane nearest its optimum d ll is a sum of 10,000 terms of the batch's
    size that cancel to a few units, and two float32 orders of that sum
    differ by about 1e-4 there. And lane by lane against the float64 plain
    version at RTOL_DLL_LANE of 1 + the lane's own |d ll|, so that a lane of
    a few units cannot hide an error at the batch's scale: the kernel's
    largest such gap measured on an H100 was 1.7e-5, at (1, 8) on the 16
    AR(1) lanes (the float32 plain version's 2.3e-6 there)."""
    T = _steps(T, ("A", D))
    table, dtable, y = _nll_operands(dev, N, T, O=O, D=D, walk=walk)
    before = (tracing.launches("A", D, O, False), tracing.launches("A", D, O, True))
    ll = fused_nll.fused_nll(table, y)
    ll_p, dll_p = fused_nll.fused_nll_paired(table, dtable, y)
    torch.cuda.synchronize()
    assert (tracing.launches("A", D, O, False), tracing.launches("A", D, O, True)) == (
        before[0] + 1, before[1] + 1)
    want_p, want_dp = fused_nll._fused_nll_paired_plain(table, dtable, y)
    _close(ll, want_p)
    _close(ll_p, want_p)
    err = float((dll_p - want_dp).abs().max() / (1.0 + want_dp.abs().max()))
    assert err <= RTOL, err
    want_64 = fused_nll._fused_nll_paired_plain(table.double(), dtable.double(), y.double())[1]
    lane_err = float(((dll_p.double() - want_64).abs() / (1.0 + want_64.abs())).max())
    assert lane_err <= RTOL_DLL_LANE, lane_err


def test_kernel_a_library_builds_what_its_wrapper_takes(dev):
    """The instances the library of kernel A reports (``FUSED_NLL_SHAPES``
    in csrc/fused_nll.cu, which its C dispatch expands too) are the
    wrapper's ``_CUDA_SHAPES``."""
    assert fused_nll.built_shapes() == fused_nll._CUDA_SHAPES


def test_staged_nll_at_n_latent_4_takes_the_plain_route(dev):
    """Beyond D = 3 (n_latent 4 at two cameras: D = 4, O = 4) the loss is the
    staged plane NLL, and its paired scan the plain version on the card,
    counted as the plain route; no kernel launches. The final pass's two
    scans too."""
    table, dtable, y = _nll_operands(dev, 3, 300, O=4, D=4)
    def counts():
        return tracing.launches("A", None, None, True), tracing.launches("scan"), tracing.launches("scan_plain_route")

    before = counts()
    ll, dll = pkalman.filter_nll_paired_batched(table, dtable, y)
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1], before[2] + 1)
    assert ll.device.type == "cuda"
    want, want_d = pkalman._staged_nll_paired(table.cpu(), dtable.cpu(), y.cpu())
    _close(ll.cpu(), want)
    _close(dll.cpu(), want_d)
    ys, m0, S0, A, Q, C, _, r_tv = (torch.as_tensor(x, device=dev) for x in _lanes(3, 300, 4, 4))
    res = pkalman.kalman_smoother_parallel(ys, m0, S0, 0.95 * A, Q, C, r_tv)
    torch.cuda.synchronize()
    assert tracing.launches("scan_plain_route") == before[2] + 3 and tracing.launches("scan") == before[1]
    want_s = pkalman.kalman_smoother_parallel(*(x.cpu() for x in (ys, m0, S0, 0.95 * A, Q, C, r_tv)))
    _close(res.smoothed_means.cpu(), want_s.smoothed_means)


def test_staged_nll_at_12_observations_matches_plain(dev):
    """Beyond kernel A's sizes (six cameras: O = 12) the loss is the staged
    plane NLL: one paired lane-batched scan launch, no kernel A launch."""
    table, dtable, y = _nll_operands(dev, 3, 300, O=12, D=3)
    before = (tracing.launches("A", None, None, True), tracing.launches("scan", "filter", True, 3))
    ll, dll = pkalman._staged_nll_paired(table, dtable, y)
    torch.cuda.synchronize()
    assert (tracing.launches("A", None, None, True), tracing.launches("scan", "filter", True, 3)) == (
        before[0], before[1] + 1)
    want, want_d = pkalman._staged_nll_paired(table.cpu(), dtable.cpu(), y.cpu())
    _close(ll.cpu(), want)
    _close(dll.cpu(), want_d)
    _close(pkalman._staged_nll(table, y).cpu(), want)


def _nll_tv_operands(dev, N, T, walk=True):
    """Kernel C's operands at the pupil family's D = 3, O = 8: the table and
    its tangent along log s (s scaling Q), and the y-then-r planes. With
    ``walk`` False the observations are a stationary AR(1) series in place of
    a random walk, as the pupil's are: on sixteen lanes of 10,000 random-walk
    steps, s from e^-1 to e, d ll/d log s becomes a sum of terms that cancel
    on some lanes, and float32 leaves it 3e-5 to 4e-5 from its float64 value
    whichever way it is computed, the plain version further than the kernel
    (scripts/torch_kernel_c_ab.py --precision prints both gaps)."""
    ys, m0, S0, A, Q, C, _, r_tv = _lanes(N, T, 8, 3)
    if not walk:
        ys = _ar1(N, T, 8, seed=T)
    ys, m0, S0, A, Q, C, r_tv = (torch.as_tensor(x, device=dev) for x in (ys, m0, S0, A, Q, C, r_tv))
    s_log = torch.linspace(-1.0, 1.0, N, device=dev)

    def pack(sl):
        return pkalman._pack_scalars_tv(m0, S0, 0.95 * A, torch.exp(sl)[:, None, None] * Q, C)

    table, dtable = torch.func.jvp(pack, (s_log,), (torch.ones_like(s_log),))
    yr = torch.cat([ys.transpose(1, 2), r_tv.transpose(1, 2)], dim=1)
    return table.contiguous(), dtable.contiguous(), yr.contiguous()


@pytest.mark.parametrize("N,T,walk", [(N, T, True) for N, T in [(1, 1), (1, 5), (3, 255), (2, 257), (1, 300),
                                                                  (16, 1000)]]
                         + [(N, T, False) for N, T in SEGMENT_CASES])
def test_kernel_c_matches_plain(dev, N, T, walk):
    table, dtable, yr = _nll_tv_operands(dev, N, _steps(T, "C"), walk)
    before = (tracing.launches("C", False), tracing.launches("C", True))
    ll = fused_nll.fused_nll_tv(table, yr)
    ll_p, dll_p = fused_nll.fused_nll_tv_paired(table, dtable, yr)
    torch.cuda.synchronize()
    assert (tracing.launches("C", False), tracing.launches("C", True)) == (before[0] + 1, before[1] + 1)
    want = fused_nll._fused_nll_tv_plain(table, yr)
    want_p, want_dp = fused_nll._fused_nll_tv_paired_plain(table, dtable, yr)
    _close(ll, want)
    _close(ll_p, want_p)
    _close(dll_p, want_dp)
    assert torch.equal(fused_nll.fused_nll_tv(table, yr), ll)


def test_kernel_c_clipped_noise_stays_in_step_with_plain(dev):
    """Noise variances clipped at 1e-12, as the pupil path clips an ensemble
    variance of zero, put 1/r = 1e12 into the information-form elements. The
    kernel and its plain version are finite on the same lanes and agree
    there; the optimizer maps a non-finite value to 1e12."""
    table, dtable, yr = _nll_tv_operands(dev, 4, 300)
    yr[2:, 8::3, 50::60] = 1e-12
    ll, dll = fused_nll.fused_nll_tv_paired(table, dtable, yr)
    want, want_d = fused_nll._fused_nll_tv_paired_plain(table, dtable, yr)
    finite = torch.isfinite(want) & torch.isfinite(want_d)
    assert torch.equal(torch.isfinite(ll) & torch.isfinite(dll), finite) and bool(finite[:2].all())
    _close(ll[finite], want[finite])
    _close(dll[finite], want_d[finite])


@pytest.mark.parametrize("N,T,O,D", [(3, T, O, D) for T, O, D in [
    (1, 2, 2), (7, 2, 2), (255, 2, 2), (257, 2, 2), (300, 2, 2), (1, 8, 3), (7, 8, 3), (257, 8, 3),
    (300, 8, 3)]] + [(N, T, 8, 3) for N, T in SEGMENT_CASES] + [(3, "thr+1", 2, 2), (300, "tile+1", 2, 2)]
    + [(N, T, 4, 1) for N, T in SEGMENT_CASES] + [(1, 1, 2, 1)])
def test_kernel_b_matches_plain(dev, N, T, O, D):
    T = _steps(T, ("filter", False, D))
    ys, m0, S0, A, Q, C, _, r_tv = (torch.as_tensor(x, device=dev) for x in _lanes(N, T, O, D, seed=T))
    planes = pkalman._make_filter_elements(ys, m0, S0, A, Q, C, r_tv)
    before = tracing.launches("scan")
    out = fused_filter.filter_prefix(planes)
    torch.cuda.synchronize()
    assert tracing.launches("scan") == before + 1
    _close(out, fused_filter.filter_prefix_plain(planes))


def _smoother_planes(dev, N, T, O, D, seed):
    """Smoothing elements of a filtered random walk, and a tangent for them."""
    ys, m0, S0, A, Q, C, _, r_tv = (torch.as_tensor(x, device=dev) for x in _lanes(N, T, O, D, seed=seed))
    fr = pkalman.kalman_filter_parallel(ys, m0, S0, 0.95 * A, Q, C, r_tv, compute_ll=False)
    planes = pkalman._make_smoother_elements(fr.filtered_means, fr.filtered_covs, 0.95 * A, Q)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    tangents = (0.1 * torch.randn(planes.shape, generator=gen)).to(dev)
    return planes, tangents


@pytest.mark.parametrize("N,T,O,D", [(3, T, O, D) for T, O, D in [
    (1, 2, 2), (7, 2, 2), (255, 2, 2), (256, 2, 2), (257, 2, 2), (1, 4, 3), (255, 4, 3), (256, 4, 3),
    (257, 4, 3), (1000, 4, 3)]] + [(N, T, 4, 3) for N, T in SEGMENT_CASES]
    + [(3, "thr+1", 2, 2), (300, "tile+1", 2, 2)] + [(N, T, 4, 1) for N, T in SEGMENT_CASES] + [(1, 1, 2, 1)])
def test_smoother_kernel_matches_plain(dev, N, T, O, D):
    T = _steps(T, ("smoother", False, D))
    planes, _ = _smoother_planes(dev, N, T, O, D, seed=T)
    key = ("smoother", False, D)
    before = tracing.launches("scan", *key)
    out = fused_filter.smoother_suffix(planes)
    torch.cuda.synchronize()
    assert tracing.launches("scan", *key) == before + 1
    _close(out, fused_filter.smoother_suffix_plain(planes))
    # the last step is the last element itself (E = 0, g = m_T, L = P_T)
    assert torch.equal(out[..., -1], planes[..., -1])


def _symmetric_cj(tangents, D):
    """A filter element's C and J are symmetric, and its combine is
    associative only on such elements (it takes Zᵀ for inv(I + J2 C1)), so a
    tangent direction must keep them symmetric for two association orders to
    agree."""
    dd = D * D
    out = tangents.clone()
    for off in (dd + D, 2 * dd + 2 * D):
        blk = tangents[:, off:off + dd].reshape(-1, D, D, tangents.shape[-1])
        out[:, off:off + dd] = (0.5 * (blk + blk.transpose(1, 2))).reshape(-1, dd, tangents.shape[-1])
    return out


@pytest.mark.parametrize("kind", ["filter", "smoother"])
@pytest.mark.parametrize("N,T,O,D", [(3, T, O, D) for T, O, D in [
    (1, 2, 2), (255, 2, 2), (257, 2, 2), (1, 4, 3), (256, 4, 3), (257, 4, 3), (1000, 12, 3)]]
    + [(N, T, 4, 3) for N, T in SEGMENT_CASES] + [(3, "thr+1", 2, 2), (300, "tile+1", 2, 2)]
    + [(N, T, 4, 1) for N, T in SEGMENT_CASES])
def test_paired_scan_kernels_match_plain(dev, kind, N, T, O, D):
    T = _steps(T, (kind, True, D))
    if kind == "smoother":
        planes, tangents = _smoother_planes(dev, N, T, O, D, seed=T)
        scan, plain = fused_filter.smoother_suffix_paired, fused_filter.smoother_suffix_plain
    else:
        ys, m0, S0, A, Q, C, _, r_tv = (torch.as_tensor(x, device=dev) for x in _lanes(N, T, O, D, seed=T))
        planes = pkalman._make_filter_elements(ys, m0, S0, A, Q, C, r_tv)
        gen = torch.Generator(device="cpu").manual_seed(T)
        tangents = _symmetric_cj((0.1 * torch.randn(planes.shape, generator=gen)).to(dev), D)
        scan, plain = fused_filter.filter_prefix_paired, fused_filter.filter_prefix_plain
    key = (kind, True, D)
    before = tracing.launches("scan", *key)
    out, dout = scan(planes, tangents)
    torch.cuda.synchronize()
    assert tracing.launches("scan", *key) == before + 1
    want, dwant = torch.func.jvp(plain, (planes,), (tangents,))
    _close(out, want)
    _close(dout, dwant)


@pytest.mark.parametrize("instance", [(k, p, d) for k in ("filter", "smoother") for p in (False, True)
                                      for d in (1, 2, 3)] + ["C", "C paired"]
                         + [("A", d, o, p) for d, o in fused_nll._CUDA_SHAPES for p in (False, True)])
def test_redesigned_kernels_are_bit_deterministic(dev, instance):
    """Two launches on the same inputs give the same bits: every
    association is fixed by (segment, thread), none by timing. Two lanes of
    10,000 steps: many segments per lane."""
    N, T = 2, 10_000
    if instance in ("C", "C paired"):
        table, dtable, yr = _nll_tv_operands(dev, N, T, walk=False)
        if instance == "C":
            run = lambda: fused_nll.fused_nll_tv(table, yr)  # noqa: E731
        else:
            run = lambda: torch.stack(fused_nll.fused_nll_tv_paired(table, dtable, yr))  # noqa: E731
        assert fused_nll.tv_plan(N, T, dev)["G"] > 1
    elif instance[0] == "A":
        _, D, O, paired = instance
        table, dtable, y = _nll_operands(dev, N, T, O=O, D=D, walk=False)
        if paired:
            run = lambda: torch.stack(fused_nll.fused_nll_paired(table, dtable, y))  # noqa: E731
        else:
            run = lambda: fused_nll.fused_nll(table, y)  # noqa: E731
        assert fused_nll.nll_plan(N, T, dev)["G"] > 1
    else:
        kind, paired, D = instance
        if kind == "smoother":
            planes, tangents = _smoother_planes(dev, N, T, max(2 * D - 2, 2), D, seed=1)
        else:
            ys, m0, S0, A, Q, C, _, r_tv = (
                torch.as_tensor(x, device=dev) for x in _lanes(N, T, max(2 * D - 2, 2), D))
            planes = pkalman._make_filter_elements(ys, m0, S0, A, Q, C, r_tv)
            tangents = _symmetric_cj(0.1 * torch.ones_like(planes), D)
        wrapper = {"filter": (fused_filter.filter_prefix, fused_filter.filter_prefix_paired),
                   "smoother": (fused_filter.smoother_suffix, fused_filter.smoother_suffix_paired)}[kind][paired]
        if paired:
            run = lambda: torch.cat(wrapper(planes, tangents), dim=1)  # noqa: E731
        else:
            run = lambda: wrapper(planes)  # noqa: E731
        assert fused_filter.scan_plan(N, T, kind, paired, D, dev)["G"] > 1
    first, second = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(dev):
    table, dtable, y = _nll_operands(dev, 2, 16)
    with pytest.raises(TypeError):
        fused_nll.fused_nll(table.double(), y.double())
    with pytest.raises(ValueError):
        fused_nll.fused_nll(table, y.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        fused_nll.fused_nll_paired(table, dtable[:1], y)
    table, dtable, yr = _nll_tv_operands(dev, 2, 16)
    with pytest.raises(TypeError):
        fused_nll.fused_nll_tv(table.double(), yr.double())
    with pytest.raises(ValueError):
        fused_nll.fused_nll_tv(table, yr[:, :15].contiguous())  # not O y planes and O r planes
    with pytest.raises(ValueError):
        fused_nll.fused_nll_tv_paired(table, dtable[:1], yr)
    with pytest.raises(NotImplementedError):  # built for (D, O) = (3, 8) only
        fused_nll.fused_nll_tv(torch.zeros(2, pkalman._scalar_offsets_tv(2, 2)[1], device=dev),
                               torch.ones(2, 4, 16, device=dev))
    planes = torch.zeros(2, 16, 8, device=dev)
    with pytest.raises(TypeError):
        fused_filter.filter_prefix(planes.double())
    with pytest.raises(ValueError):
        fused_filter.filter_prefix(planes.transpose(1, 2))
    with pytest.raises(ValueError):  # 16 planes is no smoothing element
        fused_filter.smoother_suffix(planes)
    with pytest.raises(NotImplementedError):  # the kernel stops at D = 3 (the wrappers take the plain route)
        fused_filter._scan_cuda(torch.zeros(2, 36, 8, device=dev), "smoother", False)
    with pytest.raises(NotImplementedError):  # kernel A is built for D <= 3 and even O <= 8
        fused_nll.fused_nll(torch.zeros(2, pkalman._scalar_offsets(4, 4)[1], device=dev),
                            torch.ones(2, 4, 16, device=dev))
    with pytest.raises(ValueError):
        fused_filter.filter_prefix_paired(planes, planes[:1])
    # a scratch buffer of the wrong shape is refused before any launch
    G = fused_filter.scan_plan(2, 8, "filter", False, 2, dev)["G"]
    before = tracing.launches("scan")
    with pytest.raises(ValueError):
        fused_filter._scan_cuda(planes, "filter", False, scratch=torch.empty(2, G + 1, 16, device=dev))
    assert tracing.launches("scan") == before
    table, dtable, yr = _nll_tv_operands(dev, 2, 16)
    G = fused_nll.tv_plan(2, 16, dev)["G"]
    with pytest.raises(ValueError):
        fused_nll._launch(table, dtable, yr, tv=True, scratch=(torch.empty(2, G, 66, device=dev),
                                                               torch.empty(1, 2, G, device=dev)))


# --------------------------------------------------------------------------- #
# the carried scan of a time-sharded sequence (prefix_scan.cu's phases A and B)
# --------------------------------------------------------------------------- #
def _carry_operands(dev, kind, N, T, D, seed):
    """(carry, local) and symmetric tangents for them: the total of the five
    steps before the chunk in scan order (after it in time, for the
    smoother) and the chunk's own T elements, from a filtered random walk."""
    if kind == "smoother":
        planes, tangents = _smoother_planes(dev, N, T + 5, 2 * D if D > 1 else 2, D, seed=seed)
        total, local = planes[..., T:].contiguous(), planes[..., :T].contiguous()
        dtotal, dlocal = tangents[..., T:].contiguous(), tangents[..., :T].contiguous()
        plain, edge = fused_filter.smoother_suffix_plain, 0
    else:
        ys, m0, S0, A, Q, C, _, r_tv = (torch.as_tensor(x, device=dev)
                                        for x in _lanes(N, T + 5, max(2 * D - 2, 2), D, seed=seed))
        planes = pkalman._make_filter_elements(ys, m0, S0, A, Q, C, r_tv)
        gen = torch.Generator(device="cpu").manual_seed(seed)
        tangents = _symmetric_cj((0.1 * torch.randn(planes.shape, generator=gen)).to(dev), D)
        total, local = planes[..., :5].contiguous(), planes[..., 5:].contiguous()
        dtotal, dlocal = tangents[..., :5].contiguous(), tangents[..., 5:].contiguous()
        plain, edge = fused_filter.filter_prefix_plain, -1
    tot, dtot = torch.func.jvp(plain, (total,), (dtotal,))
    return tot[..., edge].contiguous(), dtot[..., edge].contiguous(), local, dlocal


@pytest.mark.parametrize("kind", ["filter", "smoother"])
@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("N,T", [(1, 1), (3, 127), (3, 128), (2, 129), (4, 1000)])
def test_carry_kernel_matches_plain(dev, kind, paired, D, N, T):
    """Every instance of the carried scan (phase A, then the downsweep from
    a carry) against its plain version, counted once as a scan and once as
    a carried downsweep, and its chunk total against the plain scan's edge,
    at a single step and at step counts either side of a block of 128
    threads; a second call gives the same bits."""
    c, dc, x, dx = _carry_operands(dev, kind, N, T, D, seed=T + D)
    key = (kind, paired, D)
    before = (tracing.launches("scan_carried", *key), tracing.launches("scan", *key))
    if paired:
        def run():
            return torch.cat(fused_filter.scan_carried(x, c, kind, dx, dc), dim=1)

        out = run()
        want = torch.cat(torch.func.jvp(lambda a, b: fused_filter.scan_carried_plain(a, b, kind), (x, c), (dx, dc)),
                         dim=1)
        total = torch.cat(fused_filter.scan_total(x, kind, dx), dim=1)
        want_total = torch.cat(torch.func.jvp(lambda a: fused_filter.scan_total_plain(a, kind), (x,), (dx,)), dim=1)
    else:
        def run():
            return fused_filter.scan_carried(x, c, kind)

        out = run()
        want = fused_filter.scan_carried_plain(x, c, kind)
        total, want_total = fused_filter.scan_total(x, kind), fused_filter.scan_total_plain(x, kind)
    torch.cuda.synchronize()
    assert (tracing.launches("scan_carried", *key), tracing.launches("scan", *key)) == (
        before[0] + 1, before[1] + 1)
    _close(out, want)
    _close(total, want_total)
    again = run()
    torch.cuda.synchronize()
    assert torch.equal(again, out)


def _scan_operands(dev, kind, N, T, D):
    """(planes, tangents) of N lanes of T steps, symmetric tangents for the
    filter, and the instance's whole-sequence and sharded scans, float and
    paired."""
    from eks_tpu_torch.parallel import mesh

    if kind == "smoother":
        planes, tangents = _smoother_planes(dev, N, T, 2 * D if D > 1 else 2, D, seed=D)
        return (planes, tangents, fused_filter.smoother_suffix, fused_filter.smoother_suffix_paired,
                mesh.smoother_suffix_sharded, mesh.smoother_suffix_paired_sharded)
    ys, m0, S0, A, Q, C, _, r_tv = (torch.as_tensor(x, device=dev) for x in _lanes(N, T, max(2 * D - 2, 2), D))
    planes = pkalman._make_filter_elements(ys, m0, S0, A, Q, C, r_tv)
    tangents = _symmetric_cj(0.1 * torch.ones_like(planes), D)
    return (planes, tangents, fused_filter.filter_prefix, fused_filter.filter_prefix_paired,
            mesh.filter_prefix_sharded, mesh.filter_prefix_paired_sharded)


@pytest.mark.parametrize("kind", ["filter", "smoother"])
@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("sizes", [(1, 300), (257, 1, 40, 2), (2500, 2500, 2500, 2500)])
def test_sharded_scans_match_the_unsharded_kernel_scan(dev, kind, D, sizes):
    """Chunks of uneven length, each scanned by phase A, then from its carry
    by phase B, against the kernel's scan of the whole sequence, float and
    paired (the tangents keep C and J symmetric)."""
    planes, tangents, whole, whole_p, sharded, sharded_p = _scan_operands(dev, kind, 2, sum(sizes), D)
    chunks = [x.contiguous() for x in torch.split(planes, list(sizes), dim=-1)]
    dchunks = [x.contiguous() for x in torch.split(tangents, list(sizes), dim=-1)]
    before = tracing.launches("scan_carried", kind, False, D)
    got = torch.cat(sharded(chunks), dim=-1)
    got_p = [torch.cat(x, dim=-1) for x in zip(*sharded_p(chunks, dchunks))]
    want, want_p = whole(planes), whole_p(planes, tangents)
    torch.cuda.synchronize()
    assert tracing.launches("scan_carried", kind, False, D) == before + len(sizes) - 1
    _close(got, want)
    _close(got_p[0], want_p[0])
    _close(got_p[1], want_p[1])


@pytest.mark.parametrize("kind", ["filter", "smoother"])
@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("D", [1, 2, 3])
def test_uncarried_scan_is_the_one_chunk_sharded_scan_bit_for_bit(dev, kind, paired, D):
    """The uncarried scan of one input gives the same bits in two launches,
    the same bits as the sharded scan of that input as one chunk, and the
    same bits as its two phases with no carry (phase A over every segment,
    then the uncarried downsweep: the first chunk in scan order of a sharded
    scan), whose extra total changes no exclusive prefix."""
    planes, tangents, whole, whole_p, sharded, sharded_p = _scan_operands(dev, kind, 3, 3000, D)
    if paired:
        first, second = torch.cat(whole_p(planes, tangents), 1), torch.cat(whole_p(planes, tangents), 1)
        one_chunk = torch.cat(sharded_p([planes], [tangents])[0], 1)
        phases = torch.cat(fused_filter.chunk_scan(fused_filter.chunk_total(planes, kind, tangents)), 1)
    else:
        first, second, one_chunk = whole(planes), whole(planes), sharded([planes])[0]
        phases = fused_filter.chunk_scan(fused_filter.chunk_total(planes, kind))
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, one_chunk)
    assert torch.equal(first, phases)


def test_carry_wrappers_refuse_what_the_kernel_does_not_take(dev):
    c, dc, x, dx = _carry_operands(dev, "filter", 2, 16, 2, seed=0)
    with pytest.raises(TypeError):
        fused_filter.scan_carried(x, c.double(), "filter")
    with pytest.raises(TypeError):
        fused_filter.scan_carried(x.double(), c, "filter")
    with pytest.raises(ValueError):
        fused_filter.scan_carried(x, c[:1], "filter")
    with pytest.raises(ValueError):
        fused_filter.scan_carried(x, c.cpu(), "filter")
    with pytest.raises(ValueError):
        fused_filter.scan_carried(x, c, "filter", dx, dc[:, :3])
    with pytest.raises(NotImplementedError):  # the kernel stops at D = 3 (the wrapper takes the plain route)
        fused_filter._total_cuda(torch.zeros(2, 36, 8, device=dev), "smoother", False)
    # beyond D = 3 the wrapper runs the plain version on the card: the
    # chunk's plain scan counted on the scans' plain route, its carry
    # combine apart
    before = (tracing.launches("scan_carried_plain_route"), tracing.launches("scan_plain_route"))
    x = torch.zeros(2, 3 * 16 + 8, 8, device=dev)
    fused_filter.scan_carried(x, x[..., 0].contiguous(), "filter")
    assert (tracing.launches("scan_carried_plain_route"), tracing.launches("scan_plain_route")) == (before[0] + 1,
                                                                                            before[1] + 1)


def test_time_sharded_loss_in_a_worker_thread_gives_the_main_threads_bits(dev):
    """The paired staged loss over four time shards on the card, evaluated by
    two worker threads at once (each under ``torch.cuda.device``) and by
    the main thread, gives the same bits: forward mode's dual level is taken
    in turns, and the launch counts add up under their lock."""
    import threading

    from eks_tpu_torch.parallel import mesh

    table, dtable, y = _nll_operands(dev, 3, 2000, O=2, D=2, walk=True)
    shards = mesh.TimeShards((dev,) * 4, y.shape[-1])
    main = torch.stack(pkalman._staged_nll_paired(table, dtable, y, shards))
    before = tracing.launches("scan", "filter", True, 2)
    seen = []

    def work():
        with torch.cuda.device(dev):
            seen.append(torch.stack(pkalman._staged_nll_paired(table, dtable, y, shards)))

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert len(seen) == 2 and all(torch.equal(s, main) for s in seen)
    assert tracing.launches("scan", "filter", True, 2) == before + 8
