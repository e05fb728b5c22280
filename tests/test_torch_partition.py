"""The lane x segment grid of the scan kernel and kernels A and C, on the
CPU: the partition of a lane's steps into segments (one thread block each)
and the wrappers' check of their scratch buffers. The kernels themselves run
only on a card (tests/test_torch_cuda_kernels.py)."""

import re
from pathlib import Path

import pytest
import torch

from eks_tpu_torch.ops.fused_filter import check_scratch, segment_partition

# (threads per block, most steps per segment) of the built instances: the
# scan's float filter at D = 2 and its Dual filter at D = 3, and kernels C
# and A (every instance of A shares one geometry)
GEOMETRIES = [(128, 1024), (128, 256), (128, 1024), (128, 1024)]
CSRC = Path(__file__).resolve().parent.parent / "eks_tpu_torch" / "csrc"


def _source_geometry(name: str) -> tuple:
    """(NT, NT * CH) as a fused NLL source declares them: what its
    ``*_geometry`` entry point returns to the wrapper on a card."""
    text = (CSRC / name).read_text()
    nt = int(re.search(r"constexpr int NT = (\d+);", text).group(1))
    ch = int(re.search(r"constexpr int CH = (\d+);", text).group(1))
    return nt, nt * ch


@pytest.mark.parametrize("min_steps,max_steps", GEOMETRIES)
@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("N", [1, 2, 10, 16, 500])
def test_segments_cover_every_step_once(N, sms, min_steps, max_steps):
    for T in (1, 2, 5, sms - 1, sms, min_steps - 1, min_steps, min_steps + 1, 10_000, 100_003):
        if T < 1:
            continue
        G, L = segment_partition(N, T, sms, min_steps, max_steps)
        starts = [g * L for g in range(G)]
        ends = [min(s + L, T) for s in starts]
        # contiguous, in order, every step in exactly one segment, none empty
        assert starts[0] == 0 and ends[-1] == T
        assert all(e == s for e, s in zip(ends[:-1], starts[1:]))
        assert all(e > s for s, e in zip(starts, ends))
        # no segment longer than a block stages, and G within its caps
        assert 1 <= L <= max_steps
        assert G <= -(-T // min_steps) and G <= max(2 * sms // N, 1, -(-T // max_steps))
        # one wave of two blocks per SM unless the lanes or the tile ask more
        assert N * G <= max(2 * sms, N, N * -(-T // max_steps))
        # a pure function of its arguments
        segment_partition(N + 1, T + 7, sms + 3, min_steps, max_steps)
        assert segment_partition(N, T, sms, min_steps, max_steps) == (G, L)


def test_partition_aims_at_two_blocks_per_sm():
    # two pupil lanes at 10,000 steps on 132 SMs: segments of one step per
    # thread, as many as the least segment allows (79 of the 132 wanted)
    assert segment_partition(2, 10_000, 132, 128, 1024) == (79, 127)
    # sixteen lanes: 16 segments each, 256 blocks in one wave
    assert segment_partition(16, 10_000, 132, 128, 1024) == (16, 625)
    # ten lanes: 26 wanted, 40 needed to fit 256-step tiles
    assert segment_partition(10, 10_000, 132, 128, 256) == (40, 250)
    # a short lane is one segment; a wide batch one segment per lane
    assert segment_partition(3, 100, 132, 128, 512) == (1, 100)
    assert segment_partition(500, 300, 132, 128, 512) == (1, 300)


@pytest.mark.parametrize("source", ["fused_nll.cu", "fused_nll_tv.cu"])
def test_fused_nll_sources_declare_the_geometry_held_here(source):
    assert _source_geometry(source) == (128, 1024)


def test_kernel_a_partition_at_the_main_paths():
    """Kernel A's plan (``fused_nll.nll_plan``: the partition at the
    geometry of csrc/fused_nll.cu and the card's SM count; 132 on an H100
    SXM) for the optimizers' lanes."""
    geo = _source_geometry("fused_nll.cu")
    # the headline's 20 lanes: 13 segments of 770 steps (6 a thread), 260
    # blocks in one wave; the multi-camera sessions' 10 lanes: 26 of 385
    assert segment_partition(20, 10_000, 132, *geo) == (13, 770)
    assert segment_partition(10, 10_000, 132, *geo) == (26, 385)
    # edges: a lane shorter than a block's threads is one segment; one step
    # a thread caps G below the lanes' share; a long lane is cut into
    # segments no longer than the tile; a wide batch takes one segment each
    assert segment_partition(20, 127, 132, *geo) == (1, 127)
    assert segment_partition(20, 129, 132, *geo) == (2, 65)
    assert segment_partition(10, 128 * 26, 132, *geo) == (26, 128)
    assert segment_partition(10, 128 * 26 - 1, 132, *geo) == (26, 128)
    assert segment_partition(1, 1_000_000, 132, *geo) == (977, 1024)
    assert segment_partition(500, 10_000, 132, *geo) == (10, 1000)


@pytest.mark.parametrize("args", [(0, 10, 132, 128, 512), (2, 0, 132, 128, 512), (2, 10, 0, 128, 512),
                                  (2, 10, 132, 0, 512), (2, 10, 132, 256, 128)])
def test_partition_refuses_bad_arguments(args):
    with pytest.raises(ValueError):
        segment_partition(*args)


@pytest.mark.parametrize("bad", ["shape", "dtype", "layout", "device"])
def test_wrappers_refuse_a_wrong_scratch(bad):
    shape = (2, 79, 66)
    good = torch.empty(shape)
    check_scratch("prefix_scan", good, shape, good.device)
    wrong = {
        "shape": lambda: torch.empty(2, 78, 66),
        "dtype": lambda: torch.empty(shape, dtype=torch.float64),
        "layout": lambda: torch.empty(66, 79, 2).transpose(0, 2),
        "device": lambda: torch.empty(shape, device="meta"),
    }[bad]()
    with pytest.raises(ValueError):
        check_scratch("prefix_scan", wrong, shape, good.device)
