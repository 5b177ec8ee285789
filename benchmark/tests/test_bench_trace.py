"""The trace reduction on a made-up trace: busy time, idle time by what
the launching thread was doing, device time of each bracket's kernels."""

import pytest
import torch

from benchmark.roofline import DenseWork, ModelWork
from benchmark.trace import Span, Spans, breakdown, reduce

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, kind, name, start, dur, corr, tid=0):
        self.kind, self.n, self.s, self.d, self.c, self.t = kind, name, start, dur, corr, tid

    def device_type(self):
        return self.kind

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def correlation_id(self):
        return self.c

    def device_resource_id(self):
        return self.t


def test_reduce():
    sp = Spans()
    work = DenseWork("int8", 8, 1000, 64, 10)
    # thread 7 (native 7, handle 70) in a dense bracket [100, 400]; thread 9
    # (native 9, handle 90) in a fuse bracket [500, 700]
    sp.spans += [Span("dense", (7, 70), 100, 400, 3e-7, work),
                 Span("fuse", (9, 90), 500, 700, 2e-7)]
    events = [
        Ev(CPU, "cudaLaunchKernel", 150, 5, 1, 70),    # launched in the dense bracket
        Ev(CUDA, "scan", 200, 100, 1),
        Ev(CPU, "cudaLaunchKernel", 550, 5, 2, 9),     # in the fuse bracket (native id)
        Ev(CUDA, "unique", 600, 50, 2),
        Ev(CPU, "cudaLaunchKernel", 800, 5, 3, 9),     # outside any bracket
        Ev(CUDA, "copy", 850, 50, 3),
        Ev(CUDA, "lost", 920, 10, 4),                  # its launch is not in the trace
    ]
    tr = reduce(events, 0, 1000, sp, ("dense", "bm25", "fuse", "dispatch"))
    assert tr.window_s == 1e-6 and tr.busy_s == 210e-9
    assert tr.bracket_device_s == {"dense": 100e-9, "fuse": 50e-9}
    assert tr.bracket_work_s == {"dense": work.least_s()}
    assert tr.bracket_calls == {"dense": 1, "fuse": 1}
    # gaps: [0, 200) ends with a dense launch, [300, 600) a fuse one,
    # [650, 850) a launch outside brackets, [900, 920) unlinked, [930, 1000) the end
    assert tr.idle_by == pytest.approx({"dense": 200e-9, "fuse": 300e-9, "host": 290e-9})
    assert tr.unlinked == 1 and tr.kernels == 4
    bd = breakdown(tr)
    assert bd["device_ops"][0] == ["scan", 100e-9]
    assert bd["idle_gaps"][0] == ["fuse", 300e-9]


def test_reduce_sums_a_models_operations():
    """Every bracketed model call wholly inside the window adds its
    operations, tied to a device operation or not."""
    sp = Spans()
    sp.spans += [Span("encoder", (7, 70), 100, 300, 2e-7, ModelWork(5e9, 1e6, "bf16")),
                 Span("encoder", (7, 70), 400, 600, 2e-7, ModelWork(3e9, 1e6, "bf16")),
                 Span("encoder", (7, 70), 900, 1100, 2e-7, ModelWork(7e9, 1e6, "bf16")),
                 Span("dense", (7, 70), 600, 700, 1e-7, DenseWork("bf16", 8, 100, 64, 10))]
    events = [Ev(CPU, "cudaLaunchKernel", 150, 5, 1, 70), Ev(CUDA, "gemm", 200, 80, 1)]
    tr = reduce(events, 0, 1000, sp, ("encoder", "dense"))
    assert tr.bracket_flops == {"encoder": 8e9}
    assert tr.bracket_peak_s == {"encoder": pytest.approx(8e9 / 989e12, rel=1e-12)}
    assert tr.bracket_calls == {"encoder": 1}
    assert tr.bracket_work_s == {"encoder": ModelWork(5e9, 1e6, "bf16").least_s()}
