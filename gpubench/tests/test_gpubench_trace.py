"""The reduction of a profiler trace, and the per-layer readers, on events
made by hand."""

import dataclasses

import pytest
from torch.autograd import DeviceType

from gpubench import readers
from gpubench.trace import breakdown, summarize


@dataclasses.dataclass
class Range:
    start: float
    end: float


@dataclasses.dataclass
class Event:
    name: str
    device_type: object
    time_range: Range
    is_user_annotation: bool = False


def cpu(name, a, b):
    return Event(name, DeviceType.CPU, Range(a, b), True)


def gpu(name, a, b, annotation=False):
    return Event(name, DeviceType.CUDA, Range(a, b), annotation)


EVENTS = [
    cpu("gpubench.window", 100, 1100),
    cpu("gpubench.enqueue", 100, 300),
    cpu("gpubench.fetch", 300, 700),
    cpu("gpubench.strings", 700, 800),
    gpu("void fwd_fma_kernel<LstmCell, 16>(P)", 150, 400),
    gpu("void bwd_fma_kernel<LstmCell, 16>(P)", 350, 500),  # overlaps
    gpu("ampere_sgemm_128x64_nn", 600, 650),
    gpu("ctc_fwd_kernel", 900, 1000),
    gpu("Memcpy DtoH", 1000, 1050),
    gpu("gpubench.fetch", 300, 700, annotation=True),  # drawn on the device
    gpu("void fwd_fma_kernel<LstmCell, 16>(P)", 50, 120),  # before the window
]


def test_busy_is_the_union_inside_the_window():
    t = summarize(EVENTS)
    assert t.window_s == pytest.approx(1000e-6)
    # 100-120 (the kernel that began before the window), 150-500, 600-650,
    # 900-1050
    assert t.busy_s == pytest.approx((20 + 350 + 50 + 150) * 1e-6)
    assert t.by_name["void fwd_fma_kernel<LstmCell, 16>(P)"] == pytest.approx(
        (250 + 20) * 1e-6)


def test_gaps_are_labelled_by_the_host_span():
    gaps = summarize(EVENTS).gaps
    # 120-150, 500-600, 650-900 and 1050-1100, labelled by their middles
    assert [n for n, _ in gaps] == ["enqueue", "fetch", "strings", "other"]
    assert [s for _, s in gaps] == pytest.approx([30e-6, 100e-6, 250e-6,
                                                  50e-6])
    top = breakdown(summarize(EVENTS), top=2)
    assert [n for n, _ in top["idle_gaps"]] == ["strings", "fetch"]
    assert len(top["device_ops"]) == 2


def test_readers():
    ctx = readers.LayerContext(
        trace=summarize(EVENTS), steps=2, model_flops=989e12 * 1e-3 * 0.5,
        peak_flops=989e12, recurrence_least_s=27e-6,
        spans={"enqueue": 2e-3},
        kernel_tables={"recurrence": ["fwd_fma_kernel", "bwd_fma_kernel"],
                       "ctc": ["ctc_fwd_kernel"]})
    assert readers.idle_share(ctx) == pytest.approx(43.0)
    assert readers.mfu(ctx) == pytest.approx(50.0)
    # recurrence kernels 270 + 150 us
    assert readers.roofline_share(ctx, "recurrence", 42e-6, "m") == \
        pytest.approx(10.0)
    # the sgemm and the copy are named by no table
    assert readers.per_step_ms(readers.unnamed_seconds(ctx), ctx) == \
        pytest.approx(0.05)
    with pytest.raises(RuntimeError, match="took no device time"):
        readers.roofline_share(ctx, "frontend", 1e-6, "m")


def test_a_trace_without_its_window_fails():
    with pytest.raises(RuntimeError):
        summarize(EVENTS[1:])
