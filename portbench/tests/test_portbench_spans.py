"""The program's spans on the device trace's clock (``portbench/spans.py``)
and the readers of the per-layer metrics they give, on synthetic traces:
anchors that agree give the clocks' offset and ones that do not give no
number, device items go to the innermost span open where their launch
began (autograd's thread falling back to the step's thread), idle gaps go
to the span of the launch that ends them, and the refills' cost to the
steps they overlap."""
from types import SimpleNamespace

import pytest
import torch

from portbench import spans
from portbench.registry import Registry

MAIN, AUTOGRAD, FEED = 101, 202, 303                  # OS thread ids
OFF = 5_000.0                                         # µs, program -> prof
# three anchors before the step and three after: (start, length, the µs
# from the sync's end to the span's end); the host reaches each sync after
# a lag of its own, and the fifth returns late
ANCHORS = ((-40, 10, 0), (-25, 25, 5), (-10, 8, 3), (1010, 12, 4),
           (1025, 40, 20), (1070, 9, 0))


def _x(cat, name, ts, dur, tid, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid, "args": args}


def _program():
    """A step of one microbatch on the program's clock (µs)."""
    return [_x("clock", "clock.anchor", t, d, MAIN) for t, d, _ in ANCHORS] + [
        _x("train", "train.step", 20, 980, MAIN, step=0, microbatches=1),
        _x("train", "train.microbatch", 25, 575, MAIN, step=0, k=0),
        _x("model", "model.forward", 30, 170, MAIN, step=0, k=0),
        _x("model", "model.backward", 210, 380, MAIN, step=0, k=0),
        _x("train", "train.grad_accum", 300, 10, AUTOGRAD, step=0),
        _x("train", "train.update", 650, 300, MAIN, step=0, pieces=3),
        _x("transfer", "data.stage", 400, 50, FEED, batch=7, bytes=64),
    ]


def _profiler(tid_of=lambda t: t, late=0.0):
    """Launches and their device items on the profiler's clock, which
    reads ``OFF`` µs more than the program's (``late`` more after the
    step); the profiler's own sync when it stops."""
    ev = []
    for t, d, back in ANCHORS:
        end = OFF + (late if t > 0 else 0) + t + d - back
        ev.append(_x("cuda_runtime", "cudaDeviceSynchronize", end - 4, 4,
                     tid_of(MAIN)))
    ev.append(_x("cuda_runtime", "cudaDeviceSynchronize", OFF + 1200, 6,
                 tid_of(MAIN)))
    launches = [  # (program time of the launch, thread, device start, dur)
        (40, MAIN, 60, 100),       # forward
        (150, MAIN, 170, 30),      # forward, after a gap of 10
        (250, AUTOGRAD, 220, 50),  # backward: no span on its thread
        (305, AUTOGRAD, 320, 20),  # the accumulator's add, after 50 idle
        (320, AUTOGRAD, 340, 60),  # backward again
        (420, FEED, 430, 5),       # the batch's copy, overlapping
        (700, MAIN, 720, 200),     # the update, after 285 idle
        (1000, MAIN, 930, 10),     # the loss read, outside every span
    ]
    for corr, (t, tid, start, dur) in enumerate(launches, start=1):
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", OFF + t, 3,
                     tid_of(tid), correlation=corr))
        ev.append(_x("kernel", f"k{corr}", OFF + start, dur, "stream 7",
                     correlation=corr))
    return ev


def test_anchors_give_the_clocks_offset():
    """Each side's anchor that returned soonest; the profiler's sync when
    it stops, after the last anchor, is paired with none."""
    clock = spans.align(_program(), _profiler())
    assert clock["offsets"] == [pytest.approx(OFF)] * 2
    assert clock["offset"] == pytest.approx(OFF)
    late = spans.align(_program(), _profiler(late=30))
    assert late["offsets"] == [pytest.approx(OFF), pytest.approx(OFF + 30)]
    assert late["offset"] == pytest.approx(OFF + 15)


def test_items_go_to_the_innermost_span_of_their_launch():
    attr = spans.attribute(_program(), _profiler(), window_s=1e-3)
    assert attr["aligned"] and attr["steps"] == 1
    dev = {k: round(v * 1e6, 6) for k, v in attr["device_s"].items()}
    assert dev == {"model.forward": 130, "model.backward": 110,
                   "train.grad_accum": 20, "data.stage": 5,
                   "train.update": 200, spans.OUTSIDE: 10}
    idle = {k: round(v * 1e6, 6) for k, v in attr["idle_s"].items()}
    # 475 µs busy, 405 idle between items: 120 at the window's edges
    assert idle == {"model.forward": 10, "model.backward": 20,
                    "train.grad_accum": 50, "data.stage": 30,
                    "train.update": 285, spans.OUTSIDE: 10, spans.EDGE: 120}
    assert attr["items_s"] == pytest.approx(475e-6)
    assert attr["wait_s"] == 0.0
    assert spans.idle_by_span(attr) == [
        [n, pytest.approx(s * 1e-6)] for n, s in (
            ("train.update", 285), ("train.grad_accum", 50),
            ("data.stage", 30), ("model.backward", 20),
            ("model.forward", 10), (spans.OUTSIDE, 10), (spans.EDGE, 120))]


def test_other_thread_ids_fall_back_to_the_step_thread():
    """A profiler writing ids of its own: the anchors map the main thread;
    the others' launches fall back to the step's thread."""
    other = {MAIN: 9, AUTOGRAD: 8, FEED: 7}
    attr = spans.attribute(_program(), _profiler(lambda t: other[t]), 1e-3)
    dev = {k: round(v * 1e6, 6) for k, v in attr["device_s"].items()}
    assert dev == {"model.forward": 130, "model.backward": 135,
                   "train.update": 200, spans.OUTSIDE: 10}


def test_anchors_that_disagree_give_no_number():
    attr = spans.attribute(_program(), _profiler(late=60), 1e-3)
    assert not attr["aligned"] and "device_s" not in attr
    assert attr["offsets"] == [pytest.approx(OFF), pytest.approx(OFF + 60)]
    run = SimpleNamespace(trace={"program": {"attribution": attr}})
    assert spans.device_ms(run, "model.forward") is None
    assert spans.attribute(_program(), _profiler(late=45), 1e-3)["aligned"]


READERS = {"forward_device_ms.train": 0.13, "backward_device_ms.train": 0.11,
           "grad_accum_device_ms.train": 0.02,
           "update_device_ms.train": 0.2}


def test_the_readers_read_the_program_session():
    reg = Registry()
    attr = spans.attribute(_program(), _profiler(), 1e-3)
    run = SimpleNamespace(trace={"program": {"attribution": attr,
                                             "window_events": []}})
    for name, want in READERS.items():
        assert reg.metric(name).read(run) == pytest.approx(want)
    # a program without spans (the parent of this change) gives nothing
    for trace in (None, {"busy_s": 1.0},
                  {"program": {"attribution": spans.attribute(
                      _program()[:6], _profiler(), 1e-3),
                      "window_events": []}}):
        run = SimpleNamespace(trace=trace)
        for name in (*READERS, "input_interference_ms.train"):
            assert reg.metric(name).read(run) is None, (name, trace)


def _window(steps, refills):
    """``prefetch.get`` at each step start (ms), refills as (start, end)."""
    ev = [_x("wait", "prefetch.get", t * 1e3, 10, MAIN, batch=k, depth=2)
          for k, t in enumerate(steps)]
    return ev + [_x("data", "data.refill", s * 1e3, (e - s) * 1e3, FEED,
                    window=i, rows=9) for i, (s, e) in enumerate(refills)]


def test_input_interference_counts_the_steps_a_refill_overlaps():
    # steps of 100, 100, 250 (a refill), 102, 98, 300 (a refill) ms
    ev = _window([0, 100, 200, 450, 552, 650, 950], [(210, 400), (700, 800)])
    # the clean steps' median is 100: (150 + 200) over 6 steps
    assert spans.input_interference_ms(ev) == pytest.approx(350 / 6)
    assert spans.input_interference_ms(
        _window([0, 100, 200, 450, 552, 650], [(700, 800)])) == 0.0
    # a refill step quicker than the median costs nothing
    assert spans.input_interference_ms(
        _window([0, 100, 200, 290, 400], [(210, 250)])) == 0.0
    reg = Registry()
    run = SimpleNamespace(trace={"program": {"window_events": ev,
                                             "attribution": {}}})
    assert reg.metric("input_interference_ms.train").read(run) \
        == pytest.approx(350 / 6)


def test_input_interference_needs_three_clean_steps():
    assert spans.input_interference_ms(
        _window([0, 100, 300, 400], [(150, 250)])) is None
    assert spans.input_interference_ms([]) is None


def test_program_session_on_the_cpu():
    """The session's steps and anchors on the CPU, where no device item
    or ``cudaDeviceSynchronize`` exists: the attribution is unaligned and
    the readers give nothing."""
    from repro_torch.obs import trace
    tr = trace.Tracer(measuring=False, max_events=0)
    x = torch.ones(64, 64)
    ran = []

    def step():
        with trace.span("train", "train.step"):
            ran.append(float((x @ x).sum()))
    out = spans.program_session(step, lambda: None, tr, cuda=False)
    assert len(ran) == 2 and out["window_s"] > 0
    assert out["attribution"] == {"offsets": [], "aligned": False}
    names = [e["name"] for e in tr.events]
    assert names == ["train.step"] + ["clock.anchor"] * 3 + [
        "train.step"] + ["clock.anchor"] * 3
