"""The port's spans (cornelis_tpu_torch/utils/trace.py) on the CPU: off by
default and free there; on, one tree a frame and one a step, with the
backward's checkpoint recompute under the step; and each span on the
profiler's clock. Tiny shapes: the whole file takes a few seconds."""

import sys
import threading
import time
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cornelis_tpu_torch import RenderOptions, compile_scene, render_scene, scene_arrays
from cornelis_tpu_torch.diff import InverseRenderer, render_diff
from cornelis_tpu_torch.rng import make_key
from cornelis_tpu_torch.scene.library import sphere_on_plane
from cornelis_tpu_torch.utils import trace

FRAME_SPANS = {"ct.frame", "ct.session.setup", "ct.scene.compile", "ct.session.key",
               "ct.session.lights", "ct.session.dispatch", "ct.film.fetch", "ct.film.tonemap",
               "ct.png.deflate"}


def _frame(tmp_path):
    # 8x8 of this scene compresses, so the PNG's deflate has something to gain.
    opts = RenderOptions(width=8, height=8, samples_aa=2, max_depth=2, integrator="nee",
                         device="cpu", output=str(tmp_path / "frame.png"))
    render_scene(sphere_on_plane(), opts)


def _inverse():
    scene = scene_arrays(compile_scene(sphere_on_plane(), device="cpu"))
    with torch.no_grad():
        target = render_diff(scene, make_key(9), width=4, height=4, spp=2, max_depth=2)
    return InverseRenderer(scene, target, fields=("mat_albedo",), width=4, height=4, spp=2,
                           max_depth=2)


def _profiled(work):
    """Run work() under the profiler with the spans on: (spans, the
    profiler's ct.* host events as (name, start_ns, end_ns))."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.collect() as spans:
            work()
    events = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
              if e.name().startswith("ct.")]
    return list(spans), events


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The spans and profiler events of one frame and of one Adam step."""
    inv = _inverse()
    tmp = tmp_path_factory.mktemp("trace")
    return {"frame": _profiled(lambda: _frame(tmp)), "step": _profiled(inv.step)}


def test_off_by_default_keeps_nothing_and_opens_no_range(tmp_path):
    assert trace.span("ct.a") is trace.span("ct.b")  # the shared no-op
    kept = trace.enable()
    trace.disable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _frame(tmp_path)
    assert kept == []
    assert not [e for e in prof.profiler.kineto_results.events() if e.name().startswith("ct.")]


def test_off_a_span_reads_no_clock_opens_no_range_and_allocates_nothing(monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("called while tracing is off")

    for name in ("time_ns", "perf_counter", "perf_counter_ns", "monotonic", "monotonic_ns"):
        monkeypatch.setattr(time, name, refused)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    noop = trace.span("ct.x")
    with trace.span("ct.x", 7) as s:
        s.set("bytes", 1)
    assert s is noop and s.request is None

    def constant(name, request=None):
        return noop

    def peak(fn):
        """The traced peak over 1000 calls of fn, above the memory at the start."""
        tracemalloc.start()
        try:
            for _ in range(1000):
                fn("ct.x")
            return tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()

    peak(trace.span), peak(constant)  # warm both paths
    assert peak(trace.span) == peak(constant)


def test_the_frames_spans_form_one_tree_with_one_id(traced):
    spans, _ = traced["frame"]
    assert {s.name for s in spans} == FRAME_SPANS
    assert len({s.request for s in spans}) == 1
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["ct.frame"]
    for s in spans:
        if s.parent is not None:
            parent = by_id[s.parent]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    setup = next(s for s in spans if s.name == "ct.session.setup")
    parts = {s.name for s in spans if s.parent == setup.id}
    assert parts == {"ct.scene.compile", "ct.session.key", "ct.session.lights"}
    deflate = next(s for s in spans if s.name == "ct.png.deflate")
    assert deflate.attrs["bytes_in"] > deflate.attrs["bytes_out"] > 0
    fetch = next(s for s in spans if s.name == "ct.film.fetch")
    assert fetch.attrs["bytes"] == 8 * 8 * 3 * 4


def test_a_steps_phases_and_bounces_share_its_id(traced):
    spans, _ = traced["step"]
    by_id = {s.id: s for s in spans}
    step = next(s for s in spans if s.name == "ct.inverse.step")
    assert step.parent is None and step.request == 0  # the step count before the step
    assert {s.request for s in spans} == {step.request}
    phases = {s.name: s for s in spans if s.parent == step.id}
    assert set(phases) == {"ct.inverse.forward", "ct.inverse.backward", "ct.inverse.adam"}

    def phase_of(s):
        while s.parent != step.id:
            s = by_id[s.parent]
        return s.name

    bounces = [s for s in spans if s.name == "ct.integrator.bounce"]
    assert {phase_of(s) for s in bounces} == {"ct.inverse.forward", "ct.inverse.backward"}
    assert {s.attrs["depth"] for s in bounces} == {0, 1}
    draws = [s for s in spans if s.name == "ct.rng.draws"]
    assert any(by_id[s.parent].name == "ct.integrator.bounce" for s in draws)


@pytest.mark.parametrize("work", ["frame", "step"])
def test_each_span_lies_on_the_profilers_clock(traced, work):
    spans, events = traced[work]
    assert len(events) == len(spans)
    for name in {s.name for s in spans}:
        kept = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
        seen = sorted((start, end) for n, start, end in events if n == name)
        assert len(kept) == len(seen), name
        for (start, end), (p_start, p_end) in zip(kept, seen):
            assert abs(start - p_start) < 5e6 and abs(end - p_end) < 5e6, name


def test_the_parent_stack_is_per_thread_and_the_request_shared():
    seen = {}

    def helper():
        with trace.span("ct.helper") as s:
            seen["span"] = s

    with trace.collect() as spans:
        with trace.span("ct.outer", 42) as outer:
            thread = threading.Thread(target=helper)
            thread.start()
            thread.join(timeout=30)
    assert not thread.is_alive()
    helper_span = seen["span"]
    assert helper_span.parent == outer.id and helper_span.request == 42
    assert helper_span.thread != outer.thread
    assert {s.name for s in spans} == {"ct.outer", "ct.helper"}


def test_spans_of_many_threads_are_all_kept_with_unique_ids():
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def work():
        for _ in range(40):
            with trace.span("ct.outer"):
                with trace.span("ct.inner"):
                    pass

    threads = [threading.Thread(target=work) for _ in range(16)]
    try:
        with trace.collect() as spans:
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    assert len(spans) == 16 * 80 and len({s.id for s in spans}) == len(spans)
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "ct.inner":
            parent = by_id[s.parent]
            assert parent.name == "ct.outer" and parent.thread == s.thread


def test_a_collection_falls_between_no_span_and_its_profiler_range():
    """A garbage collection (slow here: a callback sleeps 10 ms, and every
    allocation starts one) can run between two Python statements; none
    runs between a span's clock reading and its range's stamp, so the
    bar above holds through it."""
    import gc

    def slow(phase, info):
        if phase == "start":
            time.sleep(0.01)

    threshold = gc.get_threshold()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.collect() as spans:
            gc.callbacks.append(slow)
            gc.set_threshold(1)
            try:
                for _ in range(5):
                    with trace.span("ct.outer"):
                        with trace.span("ct.inner") as inner:
                            inner.set("bytes", 1)
            finally:
                gc.set_threshold(*threshold)
                gc.callbacks.remove(slow)
    events = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                    if e.name() in ("ct.outer", "ct.inner"))
    kept = sorted((s.start_ns, s.end_ns) for s in spans)
    assert len(kept) == len(events) == 10
    for (start, end), (p_start, p_end) in zip(kept, events):
        assert abs(start - p_start) < 5e6 and abs(end - p_end) < 5e6
