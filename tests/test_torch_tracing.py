"""The port's spans (``utils/tracing.py``), on the CPU with tiny models.

Held here: without a profiler nothing is recorded and ``span`` hands out one
shared no-op; under ``torch.profiler`` a serving call records its five steps
per volume inside ``serve.call``, a device-sampler batch and a train step
record theirs, every child lies inside its parent, the profiler's trace holds
each span as a user annotation, self time is a span's time less its
children's, a second thread keeps its own stack, and masks and losses are
the same bits with the profiler on and off.
"""

import threading
import time
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_mednet_torch.data import DevicePatchSampler, MemoryReader
from tpu_mednet_torch.inference import device_sliding
from tpu_mednet_torch.inference.common import predict_on_device
from tpu_mednet_torch.models import ResidualUNet3D
from tpu_mednet_torch.ops.augment import AugmentConfig
from tpu_mednet_torch.tasks import LandmarkTask, SegmentationTask
from tpu_mednet_torch.train import create_train_state, make_train_step
from tpu_mednet_torch.utils import tracing

SERVE_KW = dict(patch_size=[8, 8, 8], patch_overlap=[1, 1, 1], batch_size=4)
PER_VOLUME = ("serve.upload", "serve.launch", "serve.wait", "serve.copy_back")
PATCH = (8, 8, 8)
LANDMARKS = 2


@pytest.fixture(autouse=True)
def _fresh():
    tracing.reset()
    yield
    tracing.reset()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _model(out_channels):
    return ResidualUNet3D(1, out_channels, f_maps=4, num_levels=2, num_groups=2,
                          dtype=torch.float32, device="cpu",
                          generator=torch.Generator().manual_seed(0))


def _serve_store():
    rng = np.random.default_rng(0)
    store, attrs = {"images": {}}, {"images": {}}
    for i, shape in enumerate(((16, 16, 16), (11, 13, 10))):
        img = rng.normal(0, 0.1, size=(1, *shape)).astype(np.float32)
        img[0, 4:10, 4:10, 4:10] += 2.0
        store["images"][f"s{i}"] = img
        attrs["images"][f"s{i}"] = {"affine": np.eye(4)}
    return MemoryReader(store, attrs)


def _serve(task):
    out = device_sliding.predict_volumes_on_device(task, None, ["s0", "s1"],
                                                   reader=_serve_store(), device="cpu",
                                                   **SERVE_KW)
    return {k: np.asarray(out[k]) for k in ("s0", "s1")}


def _sampler(landmarks: bool):
    rng = np.random.default_rng(1)
    store = {"images": {}, "labels": {}, "landmarks": {}}
    for i, shape in enumerate(((16, 14, 12), (12, 16, 14))):
        lbl = np.zeros((1, *shape), np.uint8)
        lbl[0, 2:8, 3:9, 2:7] = 1
        store["images"][f"s{i}"] = (rng.normal(size=(1, *shape)) + lbl).astype(np.float32)
        store["labels"][f"s{i}"] = lbl
        store["landmarks"][f"s{i}"] = rng.uniform(2, 10, size=(LANDMARKS, 3)).astype(np.float32)
    kw = dict(landmark_group="landmarks", heatmap_sigma=2.0) if landmarks else {}
    return DevicePatchSampler(None, ["s0", "s1"], 2, PATCH, reader=MemoryReader(store),
                              class_probabilities=[0.5, 0.5], seed=3, device="cpu", **kw)


def _task(landmarks: bool):
    if landmarks:
        return LandmarkTask(model=_model(LANDMARKS + 2), loss_regression_weight=[0.01] * LANDMARKS,
                            loss_class_weight=[0.5, 1.0])
    return SegmentationTask(model=_model(2), loss="DICE")


def _by_name(recs):
    out = {}
    for s in recs:
        out.setdefault(s.name, []).append(s)
    return out


def _assert_nested(recs):
    """Every child inside its recorded parent, with its parent's request."""
    ids = {s.id: s for s in recs}
    for s in recs:
        if s.parent is not None:
            p = ids[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (p, s)
            assert s.request == p.request


def test_untraced_spans_record_nothing_and_share_one_object():
    assert not tracing.enabled()
    a, b = tracing.span("serve.call"), tracing.span("serve.upload", request=1)
    assert a is b
    with a, b:
        pass
    _serve(SegmentationTask(model=_model(2)))
    assert tracing.spans() == [] and tracing.totals() == {}


def test_a_serving_call_records_its_steps_per_volume():
    task = SegmentationTask(model=_model(2))
    with _profiled() as prof:
        _serve(task)
    recs = tracing.spans()
    names = _by_name(recs)
    assert len(names["serve.call"]) == len(names["serve.prepare"]) == 1
    (call,) = names["serve.call"]
    assert call.parent is None
    for name in PER_VOLUME:
        assert sorted(s.item for s in names[name]) == [0, 1], name
        assert all(s.parent == call.id and s.request == call.request for s in names[name])
    assert set(names) == {"serve.call", "serve.prepare", *PER_VOLUME}
    _assert_nested(recs)
    children = sum(s.end_ns - s.start_ns for s in recs if s.parent == call.id)
    assert children >= 0.9 * (call.end_ns - call.start_ns)
    # the same spans in the profiler's trace, as user annotations (not work)
    mirrored = [e for e in prof.events() if e.name.startswith(tracing.PREFIX)]
    assert sorted(e.name for e in mirrored) == sorted(tracing.PREFIX + s.name for s in recs)
    assert all(e.is_user_annotation for e in mirrored)


@pytest.mark.parametrize("landmarks", [True, False])
def test_a_sampler_batch_and_a_train_step_record_their_phases(landmarks):
    sampler, task = _sampler(landmarks), _task(landmarks)
    state = create_train_state(task.model, learning_rate=1e-3, seed=0)
    step = make_train_step(task, augment=AugmentConfig(mirror_axes=(1, 2, 3)))
    with _profiled():
        batch = next(iter(sampler.batches(2)))
        state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["train_loss"]))
    recs = tracing.spans()
    names = _by_name(recs)
    want = {"sampler.batch", "sampler.draw", "train.step", "train.augment",
            "train.forward_backward", "train.update"} | ({"sampler.render"} if landmarks else set())
    assert set(names) == want
    assert all(len(v) == 1 for v in names.values())
    (root,), (step_span,) = names["sampler.batch"], names["train.step"]
    assert root.parent is None and step_span.parent is None
    assert root.request != step_span.request
    for name in want - {"sampler.batch", "train.step"}:
        assert names[name][0].parent == (root if name.startswith("sampler") else step_span).id
    _assert_nested(recs)


def test_self_time_is_a_span_less_its_children():
    with _profiled():
        with tracing.span("outer"):
            time.sleep(0.01)
            with tracing.span("inner"):
                time.sleep(0.005)
            with tracing.span("inner"):
                with tracing.span("leaf"):
                    time.sleep(0.002)
    names = _by_name(tracing.spans())
    tot = tracing.totals()
    (outer,), inner, (leaf,) = names["outer"], names["inner"], names["leaf"]
    dur = [s.end_ns - s.start_ns for s in inner]
    assert tot["outer"].count == 1 and tot["inner"].count == 2 and tot["leaf"].count == 1
    assert tot["outer"].seconds == (outer.end_ns - outer.start_ns) / 1e9
    assert tot["outer"].self_seconds == (outer.end_ns - outer.start_ns - sum(dur)) / 1e9
    assert tot["outer"].self_seconds >= 0.01
    assert tot["inner"].seconds == sum(dur) / 1e9
    assert tot["inner"].self_seconds == (sum(dur) - (leaf.end_ns - leaf.start_ns)) / 1e9
    assert tot["leaf"].self_seconds == tot["leaf"].seconds >= 0.002
    tracing.reset()
    assert tracing.spans() == [] and tracing.totals() == {}


def test_a_second_thread_keeps_its_own_stack():
    opened = threading.Event()

    def worker():
        with tracing.span("worker"):
            with tracing.span("worker.child"):
                opened.set()

    with _profiled():
        with tracing.span("main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            with tracing.span("main.child"):
                pass
    assert opened.is_set() and not t.is_alive()
    names = _by_name(tracing.spans())
    (main,), (work,) = names["main"], names["worker"]
    assert work.parent is None and work.request != main.request
    assert names["worker.child"][0].parent == work.id
    assert names["main.child"][0].parent == main.id


def _steps(n=2):
    torch.manual_seed(0)
    sampler, task = _sampler(True), _task(True)
    state = create_train_state(task.model, learning_rate=1e-3, seed=0)
    step = make_train_step(task, augment=AugmentConfig(mirror_axes=(1, 2, 3)))
    losses = []
    for batch, _ in zip(sampler.batches(2), range(n)):
        state, metrics = step(state, batch)
        losses.append(metrics["train_loss"].item())
    return losses


def test_masks_and_losses_are_the_same_bits_traced_or_not():
    task = SegmentationTask(model=_model(2))
    plain_masks, plain_losses = _serve(task), _steps()
    assert tracing.spans() == []
    with _profiled():
        masks, losses = _serve(task), _steps()
    assert tracing.spans()
    for k in plain_masks:
        np.testing.assert_array_equal(masks[k], plain_masks[k])
    assert losses == plain_losses


@pytest.mark.parametrize("profiled", [False, True])
def test_the_predictor_alone_holds_the_uploaded_volume(profiled):
    """Between the upload's span and the launch's, the unpadded volume is
    handed to the predictor without a reference kept beside it, so it is
    freed once the predictor has padded it (a device volume's memory)."""
    freed = []

    def make_predictor(task):
        def run(volume, corners, n_tiles, pads):
            gone = weakref.ref(volume)
            volume = torch.zeros(2)  # the predictor pads into a new tensor
            freed.append(gone() is None)
            return torch.zeros((1, 4, 4, 4), dtype=torch.uint8)
        return run

    store = MemoryReader({"images": {"a": np.zeros((1, 4, 4, 4), np.float32)}},
                         {"images": {"a": {"affine": np.eye(4)}}})
    task = SegmentationTask(model=_model(2))
    with (_profiled() if profiled else _Nothing()):
        predict_on_device(task, None, ["a"], [4, 4, 4], [0, 0, 0], 1, "images", None, store,
                          "cpu", (), "off", None, stitch="device",
                          make_predictor=make_predictor, spill=None)
    assert freed == [True]


class _Nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
