"""The lane x segment grid of the scan kernel and kernel C, on the CPU: the
partition of a lane's steps into segments (one thread block each) and the
wrappers' check of their scratch buffers. The kernels themselves run only on
a card (tests/test_torch_cuda_kernels.py)."""

import pytest
import torch

from eks_tpu_torch.ops.fused_filter import check_scratch, segment_partition

# (threads per block, most steps per segment) of the built instances: the
# scan's float filter at D = 2 and its Dual filter at D = 3, and kernel C
GEOMETRIES = [(128, 1024), (128, 256), (128, 1024)]


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
