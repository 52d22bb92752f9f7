"""The port's render session against the JAX package's: progress, abort,
checkpoint/resume and the time budget (tests/test_render.py less its
schedule and backend cases), and checkpoints that cross between the two
packages.

The port renders on CPU tables (the kernel's plain version); the JAX
sessions run its Pallas megakernel in interpret mode, whose draws are the
port's bit for bit (tests/test_torch_render.py). Both render
sphere_on_plane at 16x16, 4 spp in chunks of 2, max_depth 6.

Bars, and why:
  * within one package, a resumed render against a straight one: rtol
    1e-4, atol 1e-5, and a budgeted one-chunk render against a 2-spp
    render: rtol 1e-5, atol 1e-6 (tests/test_render.py's; the draws are
    keyed by (pixel, sample), so only the float order of the sums moves);
  * across packages: at least 99% of pixels within rtol = atol = 1e-4 and
    each channel's mean within 1% (tests/test_torch_render.py's: a
    knife-edge path may go elsewhere under the other rounding).

On CPU tables a chunk is complete when it returns, so the session's
polling of completions (one CUDA event per chunk on the card) is driven
here by stand-in events that complete some polls after they are recorded.
"""

import numpy as np
import pytest

from cornelis_tpu.options import RenderOptions as JOptions
from cornelis_tpu.render import RenderCommand as JCommand
from cornelis_tpu.render import RenderSession as JSession
from cornelis_tpu.render import RenderStatus as JStatus
from cornelis_tpu.scene.library import sphere_on_plane as jsphere_on_plane
from cornelis_tpu_torch import render as render_mod
from cornelis_tpu_torch.film import Film
from cornelis_tpu_torch.options import RenderOptions
from cornelis_tpu_torch.render import (
    RenderCommand,
    RenderProgress,
    RenderSession,
    RenderStatus,
    render_scene,
)
from cornelis_tpu_torch.scene.library import sphere_on_plane

SIZE = dict(samples_aa=4, width=16, height=16, max_depth=6, spp_chunk=2, output=None)


def _opts(**kw):
    return RenderOptions(**{**SIZE, "device": "cpu", **kw})


def _abort_while_running(progress, status):
    return RenderCommand.ABORT if status == RenderStatus.RUNNING else RenderCommand.CONTINUE


@pytest.fixture
def jax_render(monkeypatch):
    """render(**options) -> the JAX session's result on its interpreted
    megakernel, with an optional progress callback `on_progress`."""
    from cornelis_tpu.ops import pallas_integrator as pk

    monkeypatch.setenv("CORNELIS_PALLAS_INTERPRET", "1")
    # A completed Pallas render marks the process warm; undo restores it.
    monkeypatch.setattr(pk, "_PROCESS_WARM", pk._PROCESS_WARM)

    def render(on_progress=None, **kw):
        opts = JOptions(**{**SIZE, "backend": "pallas", **kw})
        return JSession(jsphere_on_plane(), opts).render(on_progress)

    return render


def _agree_across_packages(a: np.ndarray, b: np.ndarray) -> None:
    assert a.shape == b.shape and np.isfinite(a).all()
    ok = np.isclose(a, b, rtol=1e-4, atol=1e-4).all(-1)
    assert ok.mean() >= 0.99, f"only {ok.mean():.2%} of pixels agree"
    rel = np.abs(a.mean((0, 1)) - b.mean((0, 1))) / b.mean((0, 1))
    assert (rel <= 1e-2).all(), f"channel means differ by {rel}"


class TestOptions:
    def test_auto_chunking(self):
        big = _opts(samples_aa=16, width=4096, height=4096, spp_chunk=0)
        assert big.resolved_spp_chunk() == 1
        assert _opts(spp_chunk=0).resolved_spp_chunk() == 4

    @pytest.mark.parametrize("budget", [-1.0, -1e-9])
    def test_negative_budget_rejected(self, budget):
        with pytest.raises(ValueError):
            _opts(time_budget_s=budget).validate()

    def test_new_fields_default_as_jax(self):
        o, j = RenderOptions(), JOptions()
        assert (o.checkpoint, o.time_budget_s, o.standard_srgb) == (
            j.checkpoint, j.time_budget_s, j.standard_srgb)


class TestSession:
    def test_render_completes(self, tmp_path):
        out = tmp_path / "out.png"
        result = render_scene(sphere_on_plane(), _opts(output=str(out)))
        assert result.status == RenderStatus.DONE
        assert result.image.shape == (16, 16, 3) and np.isfinite(result.image).all()
        assert result.progress.samples_completed == 4
        assert result.chunks == 2
        assert out.exists()

    def test_progress_record_matches_jax(self, jax_render):
        t = render_scene(sphere_on_plane(), _opts()).progress
        j = jax_render().progress
        fields = ("chunks_target", "chunks_completed", "chunks_dispatched",
                  "primary_rays_target", "primary_rays_traced", "samples_target",
                  "samples_completed")
        assert [getattr(t, f) for f in fields] == [getattr(j, f) for f in fields]
        assert t.fraction_complete == j.fraction_complete == 1.0
        assert RenderProgress().fraction_complete == 0.0

    def test_progress_callback(self):
        events = []

        def cb(progress, status):
            events.append((progress.chunks_completed, status))
            return RenderCommand.CONTINUE

        result = render_scene(sphere_on_plane(), _opts(), on_progress=cb)
        assert result.status == RenderStatus.DONE
        # Called at least once (Render.hpp:38) + final Done.
        assert any(s == RenderStatus.RUNNING for _, s in events)
        assert events[-1] == (2, RenderStatus.DONE)  # 4 spp / 2 per chunk

    def test_progress_counts_completed_not_dispatched(self):
        events = []

        def cb(p, status):
            events.append((p.chunks_dispatched, p.chunks_completed, status))
            return RenderCommand.CONTINUE

        result = render_scene(sphere_on_plane(), _opts(), on_progress=cb)
        assert result.status == RenderStatus.DONE
        prev_done = 0
        for dispatched, done, _ in events:
            assert done <= dispatched <= result.progress.chunks_target
            assert done >= prev_done
            prev_done = done
        assert result.progress.chunks_completed == result.progress.chunks_target
        assert result.progress.samples_completed == result.progress.samples_target
        assert result.progress.rays_per_second > 0

    def test_abort(self):
        result = render_scene(sphere_on_plane(), _opts(), on_progress=_abort_while_running)
        assert result.status == RenderStatus.ABORTED
        # The partial image is usable: the film keeps the dispatched chunk.
        assert result.film.sample_count == 2 and result.chunks == 1
        assert np.isfinite(result.image).all() and result.image.max() > 0

    def test_checkpoint_resume_matches_straight_run(self, tmp_path):
        ckpt = str(tmp_path / "c.npz")
        render_scene(sphere_on_plane(), _opts(checkpoint=ckpt), on_progress=_abort_while_running)
        _, next_sample, seed = Film.load_checkpoint(ckpt)
        assert (next_sample, seed) == (2, _opts().seed)
        resumed = render_scene(sphere_on_plane(), _opts(checkpoint=ckpt))
        assert resumed.film.sample_count == 4
        assert resumed.chunks == 1 and resumed.progress.chunks_target == 1
        straight = render_scene(sphere_on_plane(), _opts())
        assert np.allclose(resumed.image, straight.image, rtol=1e-4, atol=1e-5)

    def test_checkpoint_of_another_size_rejected(self, tmp_path):
        ckpt = str(tmp_path / "c.npz")
        Film(8, 8).save_checkpoint(ckpt, next_sample=2)
        with pytest.raises(ValueError):
            render_scene(sphere_on_plane(), _opts(checkpoint=ckpt))

    def test_session_reuse(self):
        session = RenderSession(sphere_on_plane(), _opts())
        a = session.render()
        b = session.render()
        assert np.array_equal(a.image, b.image)


class TestTimeBudget:
    def test_budget_stops_early_and_normalizes(self):
        result = render_scene(sphere_on_plane(), _opts(samples_aa=64, time_budget_s=1e-6))
        assert result.status == RenderStatus.DONE
        assert result.film.sample_count == 2  # exactly one 2-spp chunk
        full = render_scene(sphere_on_plane(), _opts(samples_aa=2))
        assert np.allclose(result.image, full.image, rtol=1e-5, atol=1e-6)

    def test_zero_budget_renders_everything(self):
        result = render_scene(sphere_on_plane(), _opts(time_budget_s=0.0))
        assert result.film.sample_count == 4


class TestCheckpointsCrossPackages:
    def test_npz_keys_match_jax(self, tmp_path, jax_render):
        ours, theirs = tmp_path / "t.npz", tmp_path / "j.npz"
        render_scene(sphere_on_plane(), _opts(checkpoint=str(ours)),
                     on_progress=_abort_while_running)
        jax_render(checkpoint=str(theirs),
                   on_progress=lambda p, s: JCommand.ABORT if s == JStatus.RUNNING
                   else JCommand.CONTINUE)
        with np.load(ours) as a, np.load(theirs) as b:
            assert sorted(a.files) == sorted(b.files) == [
                "next_sample", "radiance_sum", "sample_count", "seed"]
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            for k in ("next_sample", "sample_count", "seed"):
                assert int(a[k]) == int(b[k]), k

    def test_jax_checkpoint_resumes_in_the_port(self, tmp_path, jax_render):
        ckpt = str(tmp_path / "j.npz")
        aborted = jax_render(
            checkpoint=ckpt,
            on_progress=lambda p, s: JCommand.ABORT if s == JStatus.RUNNING else JCommand.CONTINUE,
        )
        assert aborted.status == JStatus.ABORTED and aborted.film.sample_count == 2
        resumed = render_scene(sphere_on_plane(), _opts(checkpoint=ckpt))
        assert resumed.status == RenderStatus.DONE and resumed.film.sample_count == 4
        assert resumed.chunks == 1
        _agree_across_packages(resumed.image, jax_render().image)

    def test_port_checkpoint_resumes_in_jax(self, tmp_path, jax_render):
        ckpt = str(tmp_path / "t.npz")
        aborted = render_scene(sphere_on_plane(), _opts(checkpoint=ckpt),
                               on_progress=_abort_while_running)
        assert aborted.status == RenderStatus.ABORTED and aborted.film.sample_count == 2
        resumed = jax_render(checkpoint=ckpt)
        assert resumed.status == JStatus.DONE and resumed.film.sample_count == 4
        assert resumed.progress.chunks_target == 1
        _agree_across_packages(resumed.image, render_scene(sphere_on_plane(), _opts()).image)


class _LaggingEvent:
    """Stands in for a chunk's CUDA event: complete from its `lag`-th query
    on, or once synchronized."""

    def __init__(self, lag: int):
        self.left = lag

    def query(self) -> bool:
        self.left -= 1
        return self.left < 0

    def synchronize(self) -> None:
        self.left = -1


@pytest.fixture
def lagging_chunks(monkeypatch):
    """Every chunk completes three polls after it is dispatched."""

    def record(self, num_samples, on_cuda):
        self._events.append(_LaggingEvent(3))
        self._samples.append(num_samples)

    monkeypatch.setattr(render_mod._Completions, "record", record)


class TestCompletions:
    def test_drain_reports_completions_as_they_come(self, lagging_chunks):
        events = []

        def cb(p, status):
            events.append((p.chunks_dispatched, p.chunks_completed, status))
            return RenderCommand.CONTINUE

        result = render_scene(sphere_on_plane(), _opts(samples_aa=8), on_progress=cb)
        assert result.status == RenderStatus.DONE and result.film.sample_count == 8
        running = [e for e in events if e[2] == RenderStatus.RUNNING]
        # The dispatch loop runs ahead of the completions ...
        assert running[0] == (1, 0, RenderStatus.RUNNING)
        # ... the drain reports each completion once, after the last dispatch ...
        drain = [done for dispatched, done, _ in running[4:]]
        assert running[3][:2] != (4, 4) and drain == sorted(set(drain))
        prev = 0
        for dispatched, done, _ in events:
            assert done <= dispatched and done >= prev
            prev = done
        # ... and the final record is complete.
        assert events[-1] == (4, 4, RenderStatus.DONE)

    def test_late_abort_only_sets_the_status(self, lagging_chunks):
        calls = []

        def cb(p, status):
            calls.append(p.chunks_dispatched)
            # Abort in the drain: the second call at the dispatch frontier.
            if status == RenderStatus.RUNNING and calls.count(p.chunks_target) == 2:
                return RenderCommand.ABORT
            return RenderCommand.CONTINUE

        result = render_scene(sphere_on_plane(), _opts(samples_aa=8), on_progress=cb)
        assert result.status == RenderStatus.ABORTED
        # Dispatched work cannot be recalled: the film holds all of it.
        assert result.film.sample_count == 8 and result.chunks == 4
        assert result.progress.chunks_completed == 4
        straight = render_scene(sphere_on_plane(), _opts(samples_aa=8))
        assert np.array_equal(result.image, straight.image)

    def test_budget_waits_for_each_chunk(self, lagging_chunks):
        seen = []

        def cb(p, status):
            seen.append((p.chunks_dispatched, p.chunks_completed))
            return RenderCommand.CONTINUE

        result = render_scene(sphere_on_plane(), _opts(samples_aa=8, time_budget_s=1e3),
                              on_progress=cb)
        assert result.status == RenderStatus.DONE and result.film.sample_count == 8
        # With a budget, each chunk is complete before the clock is read.
        assert all(done == dispatched for dispatched, done in seen)
