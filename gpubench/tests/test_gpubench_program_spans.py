"""The reduction of the program's own spans (``program_spans.py``) on events
made by hand, beside ``trace.summarize``'s reduction of the same events."""

import pytest

from gpubench import program_spans as ps
from gpubench.tests.test_gpubench_trace import cpu, gpu
from gpubench.trace import summarize

# a window of 1000 us: two steps, each with a replay, a plan and an upload
# before them, a fetch after; the card runs 150-260, 330-420 and 600-700
EVENTS = [
    cpu("gpubench.window", 100, 1100),
    cpu("gpubench.enqueue", 100, 500),
    cpu("ctc.loader.plan", 110, 140),
    cpu("ctc.runner.upload", 140, 160),
    cpu("ctc.runner.step", 160, 300),
    cpu("ctc.graphs.replay", 170, 250),
    cpu("ctc.runner.step", 300, 450),
    cpu("ctc.graphs.replay", 310, 330),
    cpu("ctc.graphs.replay", 340, 360),  # a second child: both subtracted
    cpu("ctc.runner.fetch", 550, 620),
    cpu("aten::copy_", 560, 610),  # not a program span
    cpu("ctc.loader.plan", 40, 90),  # before the window
    gpu("void fwd_fma_kernel<LstmCell, 16>(P)", 150, 260),
    gpu("ampere_sgemm_128x64_nn", 330, 420),
    gpu("Memcpy DtoH", 600, 700),
    gpu("ctc.runner.step", 160, 300, annotation=True),  # drawn on the device
]


def test_idle_splits_by_the_innermost_span_and_adds_up():
    got = ps.reduce(EVENTS, steps=2)
    # idle 100-150: plan 110-140, upload 140-150, none 100-110; 260-330:
    # step 260-300 and 300-310, replay 310-330; 420-600: step 420-450,
    # none 450-550, fetch 550-600; 700-1100: none
    assert got.idle_s == pytest.approx({
        "none": (10 + 100 + 400) * 1e-6, "ctc.loader.plan": 30e-6,
        "ctc.runner.upload": 10e-6, "ctc.runner.step": (40 + 10 + 30) * 1e-6,
        "ctc.graphs.replay": 20e-6, "ctc.runner.fetch": 50e-6})
    trace = summarize(EVENTS)
    assert sum(got.idle_s.values()) == pytest.approx(
        trace.window_s - trace.busy_s, abs=1e-12)
    assert got.idle_share(ps.RUNNER) + got.idle_share(ps.PLAN) + (
        100 * got.idle_s[ps.NONE] / got.window_s) == pytest.approx(
        100 * (1 - trace.busy_s / trace.window_s))
    assert got.idle_share(ps.PLAN) == pytest.approx(3.0)
    assert got.idle_share(ps.RUNNER) == pytest.approx(16.0)


def test_host_seconds_counts_and_step_self_time():
    got = ps.reduce(EVENTS, steps=2)
    assert got.counts == {"ctc.loader.plan": 1, "ctc.runner.upload": 1,
                          "ctc.runner.step": 2, "ctc.graphs.replay": 3,
                          "ctc.runner.fetch": 1}
    assert got.seconds["ctc.runner.step"] == pytest.approx(290e-6)
    # 140 - 80 and 150 - 20 - 20
    assert got.step_self_s == pytest.approx((60 + 110) * 1e-6)
    assert got.per_step_ms(got.seconds["ctc.graphs.replay"]) == \
        pytest.approx(0.06)


def test_a_capture_or_a_step_count_unlike_the_runners_fails_by_name():
    with pytest.raises(RuntimeError, match="ctc.runner.step: 2 ranges"):
        ps.reduce(EVENTS, steps=3)
    with pytest.raises(RuntimeError, match="ctc.graphs.capture: 1 capture"):
        ps.reduce(EVENTS + [cpu("ctc.graphs.capture", 180, 240)], steps=2)


def test_a_program_without_spans_gives_nothing():
    plain = [ev for ev in EVENTS if not ev.name.startswith("ctc.")]
    assert ps.reduce(plain, steps=2) is None
    with pytest.raises(RuntimeError, match="no gpubench.window"):
        ps.reduce(EVENTS[1:], steps=2)
