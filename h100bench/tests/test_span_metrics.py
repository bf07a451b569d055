"""The readers of the program's spans (``h100bench/spans.py``), on the CPU.

Run: ``python -m pytest h100bench/tests -q`` from the repository root.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from h100bench import harness  # noqa: E402
from tpu_mednet_torch.utils import tracing  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# each new metric: its span, and the span that counts its unit
SPAN_METRICS = {
    "prepare_ms_per_request.serve": ("serve.prepare", "serve.copy_back"),
    "upload_ms_per_request.serve": ("serve.upload", "serve.copy_back"),
    "launch_ms_per_request.serve": ("serve.launch", "serve.copy_back"),
    "wait_ms_per_request.serve": ("serve.wait", "serve.copy_back"),
    "copy_back_ms_per_request.serve": ("serve.copy_back", "serve.copy_back"),
    "sampler_draw_ms_per_step.train": ("sampler.draw", "train.step"),
    "sampler_render_ms_per_step.train": ("sampler.render", "train.step"),
    "augment_ms_per_step.train": ("train.augment", "train.step"),
    "forward_backward_ms_per_step.train": ("train.forward_backward", "train.step"),
    "update_ms_per_step.train": ("train.update", "train.step"),
}


@pytest.fixture(autouse=True)
def _fresh():
    tracing.reset()
    yield
    tracing.reset()


def test_every_span_metric_is_declared():
    declared = {m["name"]: m for m in BENCH["per_layer"]}
    for name in SPAN_METRICS:
        m = declared[name]
        assert (m["unit"], m["better"]) == ("ms", "lower")
        assert m["moves"] == ("serve_volumes_per_min" if name.endswith(".serve")
                              else "train_patches_per_s")


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_nothing_recorded_reads_none(name):
    assert harness.reader(name)({}) is None


def _record(roots: int, unit: str):
    """``roots`` calls or steps under a CPU profiler, each with every span
    once (serving: two volumes a call), sleeping in each leaf."""
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(roots):
            if unit == "serve.copy_back":
                with tracing.span("serve.call"):
                    with tracing.span("serve.prepare"):
                        time.sleep(0.001)
                    for i in range(2):
                        for name in ("serve.upload", "serve.launch", "serve.wait",
                                     "serve.copy_back"):
                            with tracing.span(name, request=i):
                                time.sleep(0.001)
            else:
                with tracing.span("sampler.batch"):
                    for name in ("sampler.draw", "sampler.render"):
                        with tracing.span(name):
                            time.sleep(0.001)
                with tracing.span("train.step"):
                    for name in ("train.augment", "train.forward_backward", "train.update"):
                        with tracing.span(name):
                            time.sleep(0.001)


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_a_reader_gives_its_span_per_request_or_step(name):
    span, unit = SPAN_METRICS[name]
    _record(3, unit)
    recs = tracing.spans()
    want = 1e-6 * sum(s.end_ns - s.start_ns for s in recs if s.name == span) / sum(
        s.name == unit for s in recs)
    got = harness.reader(name)({})
    assert got == pytest.approx(want, rel=1e-12)
    # every leaf sleeps 1 ms; a call prepares once for its two volumes
    assert got >= (0.5 if span == "serve.prepare" else 1.0)


def test_a_missing_unit_reads_none():
    """Spans of a layer without its unit (a batch drawn, no step) read nothing."""
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("sampler.batch"):
            with tracing.span("sampler.draw"):
                pass
    assert harness.reader("sampler_draw_ms_per_step.train")({}) is None


def test_a_program_without_the_tracer_reads_none(monkeypatch):
    """The parent of the tracer's change: no module to import, no reading."""
    import tpu_mednet_torch.utils

    _record(1, "train.step")
    monkeypatch.setitem(sys.modules, "tpu_mednet_torch.utils.tracing", None)
    monkeypatch.delattr(tpu_mednet_torch.utils, "tracing")
    assert harness.reader("augment_ms_per_step.train")({}) is None
