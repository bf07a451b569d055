"""The port's native batch pipeline against the JAX package's and the numpy sampler.

``tpu_mednet_torch/native`` builds its own copy of ``patchloader.cpp`` with
g++ (present here), and ``data/native_loader.py`` drives it.  On the same
seeded stores and seed its batches are held byte-equal to the JAX
package's ``NativeBatchPipeline.batches`` and to the port's numpy
``PatchSampler.batches``, with heatmaps on and off, read directly and
through ``device_prefetch`` (the producer thread that runs the native pass
in the Trainer: the port's "prefetch on").  The f16 -> f32 table is held
bitwise to numpy's cast over all 65536 bit patterns (NaN equal to NaN).
The Trainer's auto, require and numpy routes, the refusal message, the
buffer pools (a held batch is never overwritten; a pinned pair only after
its copy's event), prompt abandonment, surfaced worker errors, and
``train_seg`` with per-step losses bit-equal to ``--no_native_loader`` are
checked on the CPU.
"""

import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_mednet.data.native_loader import NativeBatchPipeline as JaxNativeBatchPipeline
from tpu_mednet.data.patch_sampler import PatchSampler as JaxPatchSampler
from tpu_mednet.data.readers import MemoryReader as JaxMemoryReader
from tpu_mednet_torch import native
from tpu_mednet_torch.data import MemoryReader, PatchSampler
from tpu_mednet_torch.data import native_loader
from tpu_mednet_torch.data.native_loader import (NativeBatchPipeline, PinnedPool,
                                                 make_batch_source)
from tpu_mednet_torch.data.prefetch import ON_COPIED, device_prefetch

REPO = Path(__file__).resolve().parent.parent
KW = dict(samples_per_subject=4, patch_size=(12, 10, 8), class_probabilities=[0.2, 0.4, 0.4])


def make_groups(n_subjects=3, size=24, heatmaps=False, seed=0):
    rng = np.random.default_rng(seed)
    images, labels, hms = {}, {}, {}
    for i in range(n_subjects):
        key = f"s{i}"
        shape = (size, size + 2, size + 4)
        images[key] = rng.normal(0, 1, size=(2, *shape)).astype(np.float16)
        labels[key] = rng.integers(0, 3, size=(1, *shape)).astype(np.uint8)
        if heatmaps:
            hms[key] = rng.integers(0, 255, size=(2, *shape)).astype(np.uint8)
    groups = {"images": images, "labels": labels}
    if heatmaps:
        groups["heatmaps"] = hms
    return groups


def build_sampler(heatmaps=False, seed=7):
    groups = make_groups(heatmaps=heatmaps)
    return PatchSampler(None, list(groups["images"]), reader=MemoryReader(groups),
                        heatmap_group="heatmaps" if heatmaps else None, seed=seed, **KW)


def build_jax_sampler(heatmaps=False, seed=7):
    groups = make_groups(heatmaps=heatmaps)
    return JaxPatchSampler(data_path=None, subject_keys=list(groups["images"]),
                           reader=JaxMemoryReader(groups),
                           heatmap_group="heatmaps" if heatmaps else None, seed=seed, **KW)


def _jax_layout(t: torch.Tensor) -> np.ndarray:
    """The port's logical (N, C, X, Y, Z) batch as JAX's (N, X, Y, Z, C)."""
    return t.permute(0, 2, 3, 4, 1).numpy()


def _assert_same(port_batch, jax_batch):
    for k in ("data", "label"):
        got = _jax_layout(port_batch[k])
        assert got.dtype == jax_batch[k].dtype
        np.testing.assert_array_equal(got, jax_batch[k])
    assert port_batch["subject_key"] == jax_batch["subject_key"]
    np.testing.assert_array_equal(port_batch["selected_class"], jax_batch["selected_class"])


@pytest.fixture(autouse=True)
def native_enabled(monkeypatch):
    monkeypatch.delenv("TPU_MEDNET_NO_NATIVE", raising=False)
    assert native.available(), native.BUILD_ERROR


@pytest.mark.parametrize("heatmaps", [False, True])
@pytest.mark.parametrize("prefetch", [False, True])
def test_native_matches_jax_and_numpy_bytes(heatmaps, prefetch):
    """Same seed => the port's native batches equal JAX's native pipeline's
    and the port's numpy sampler's (data, label, metadata), batch for
    batch; through ``device_prefetch`` on the CPU as well."""
    ref = list(build_sampler(heatmaps).batches(batch_size=4))
    jax_batches = list(JaxNativeBatchPipeline(build_jax_sampler(heatmaps),
                                              prefetch=prefetch).batches(batch_size=4))
    pipe = NativeBatchPipeline(build_sampler(heatmaps))
    before = native.ASSEMBLE_CALLS
    it = pipe.batches(batch_size=4)
    got = list(device_prefetch(it, "cpu") if prefetch else it)
    assert len(got) == len(ref) == len(jax_batches) == 3
    assert native.ASSEMBLE_CALLS - before == 3
    for b_nat, b_ref, b_jax in zip(got, ref, jax_batches):
        _assert_same(b_nat, b_jax)
        for k in ("data", "label"):
            assert torch.equal(b_nat[k], b_ref[k])
            assert b_nat[k].is_contiguous(memory_format=torch.channels_last_3d)
        assert b_nat["subject_key"] == b_ref["subject_key"]


def test_fortran_ordered_volumes():
    """A reader may preload volumes in another layout (NIfTI volumes are
    Fortran-ordered): the pipeline copies them to C order once and its
    batches still equal the numpy sampler's."""
    def fortran_sampler():
        groups = make_groups(heatmaps=True)
        groups = {g: {k: np.asfortranarray(v) for k, v in vols.items()}
                  for g, vols in groups.items()}
        return PatchSampler(None, list(groups["images"]), reader=MemoryReader(groups),
                            heatmap_group="heatmaps", seed=7, **KW)

    sampler = fortran_sampler()
    assert not sampler.images[0].flags.c_contiguous
    got = list(device_prefetch(NativeBatchPipeline(sampler).batches(4), "cpu"))
    assert all(v.flags.c_contiguous for v in [*sampler.images, *sampler.labels,
                                                *sampler.heatmaps])
    ref = list(fortran_sampler().batches(4))
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        assert torch.equal(a["data"], b["data"]) and torch.equal(a["label"], b["label"])


def test_native_f16_conversion_exact():
    """The f16 -> f32 table against numpy's cast for all 65536 bit patterns:
    bitwise, NaN counted equal to NaN; into a numpy array and into a tensor."""
    bits = np.arange(65536, dtype=np.uint16)
    halves = bits.view(np.float16).reshape(1, 16, 64, 64)  # (C,X,Y,Z)
    want = halves.astype(np.float32)
    lbl = np.zeros((1, 16, 64, 64), np.uint8)
    for out_d in (np.empty((1, 16, 64, 64, 1), np.float32),
                  torch.empty((1, 16, 64, 64, 1), dtype=torch.float32)):
        out_l = torch.empty((1, 16, 64, 64, 1), dtype=torch.uint8)
        native.assemble_batch([halves], [lbl], None, np.zeros((1, 3), np.int64),
                              (16, 64, 64), out_d, out_l)
        got = np.moveaxis(np.asarray(out_d)[0], -1, 0)
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_array_equal(got.view(np.uint32)[~nan], want.view(np.uint32)[~nan])


def test_half_table_first_use_from_many_threads():
    """The table's first fill raced in the original; in a fresh process, 16
    threads make the library's first calls together and every result is
    numpy's cast (time-bounded)."""
    code = textwrap.dedent("""
        import sys, threading
        import numpy as np
        from tpu_mednet_torch import native
        native.load()
        halves = np.arange(65536, dtype=np.uint16).view(np.float16).reshape(1, 16, 64, 64)
        want = halves.astype(np.float32)
        lbl = np.zeros((1, 16, 64, 64), np.uint8)
        sys.setswitchinterval(1e-6)
        go, bad = threading.Barrier(16), []
        def run():
            d = np.empty((1, 16, 64, 64, 1), np.float32)
            l = np.empty((1, 16, 64, 64, 1), np.uint8)
            go.wait()
            native.assemble_batch([halves], [lbl], None, np.zeros((1, 3), np.int64),
                                  (16, 64, 64), d, l)
            got = np.moveaxis(d[0], -1, 0)
            fin = ~np.isnan(want)
            if not (np.array_equal(got[fin], want[fin]) and np.isnan(got[~fin]).all()):
                bad.append(1)
        ts = [threading.Thread(target=run) for _ in range(16)]
        [t.start() for t in ts]
        [t.join(timeout=60) for t in ts]
        assert not any(t.is_alive() for t in ts) and not bad, bad
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stdout + proc.stderr


def test_make_batch_source_auto_require_and_numpy(monkeypatch):
    """Auto and require pick the pipeline, False the numpy sampler; with the
    library unavailable auto falls back and require refuses with the JAX
    package's message."""
    s = build_sampler()
    assert isinstance(make_batch_source(s), NativeBatchPipeline)
    assert isinstance(make_batch_source(s, use_native=True), NativeBatchPipeline)
    assert make_batch_source(s, use_native=False) is s
    pinned = make_batch_source(s, pinned=True)
    assert isinstance(pinned, NativeBatchPipeline) and pinned.pinned

    # JAX's refusal, reached there through its transform hook
    from tpu_mednet.data.native_loader import make_batch_source as jax_make_batch_source
    groups = make_groups()
    jax_s = JaxPatchSampler(data_path=None, subject_keys=list(groups["images"]),
                            reader=JaxMemoryReader(groups), transform=lambda **kw: kw, **KW)
    with pytest.raises(RuntimeError) as jax_err:
        jax_make_batch_source(jax_s, use_native=True)
    monkeypatch.setenv("TPU_MEDNET_NO_NATIVE", "1")
    assert make_batch_source(s) is s
    with pytest.raises(RuntimeError) as err:
        make_batch_source(s, use_native=True)
    assert str(err.value) == str(jax_err.value)


def test_failed_build_warns_with_the_compiler_error(monkeypatch, tmp_path, caplog):
    """A source g++ refuses: ``build`` raises with the compiler's error; auto
    logs it once as a warning and takes the numpy sampler; require raises
    with the error chained."""
    bad = tmp_path / "patchloader.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_ERROR", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on patchloader.cpp"):
        native.build()
    s = build_sampler()
    with caplog.at_level("WARNING", logger="tpu_mednet_torch.native"):
        assert make_batch_source(s) is s
    assert "g++ failed on patchloader.cpp" in caplog.text and "error" in caplog.text
    assert not list((tmp_path / "build").glob("*.tmp"))
    with pytest.raises(RuntimeError, match="native loader requested") as err:
        make_batch_source(s, use_native=True)
    assert "g++ failed" in str(err.value.__cause__)


def test_unusable_pipeline_yields_the_numpy_stream(monkeypatch):
    """The counterpart of JAX's fallback to the numpy stream: with the
    library unavailable, ``make_batch_source`` (the one place that picks
    the route) hands back the numpy sampler, whose stream is unchanged and
    makes no native call; the pipeline itself never falls back."""
    def failed_build():
        raise RuntimeError("g++ failed on patchloader.cpp (exit 1):\nerror: simulated")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_ERROR", None)
    monkeypatch.setattr(native, "build", failed_build)
    s = build_sampler()
    before = native.ASSEMBLE_CALLS
    src = make_batch_source(s)
    assert src is s
    got = list(src.batches(4))
    ref = list(build_sampler().batches(4))
    assert len(got) == len(ref) == 3 and native.ASSEMBLE_CALLS == before
    for a, b in zip(got, ref):
        assert torch.equal(a["data"], b["data"]) and torch.equal(a["label"], b["label"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on patchloader.cpp"):
        next(NativeBatchPipeline(build_sampler()).batches(4))


def test_prefetch_propagates_worker_errors():
    """An error in the producer thread surfaces at the consumer; a window
    outside its volume is refused before the native pass reads it."""
    s = build_sampler()
    pipe = NativeBatchPipeline(s)
    s.patch_size = np.asarray([999, 999, 999], dtype=np.int64)  # out of range
    with pytest.raises(ValueError):
        list(device_prefetch(pipe.batches(batch_size=4), "cpu"))
    img = np.zeros((1, 8, 8, 8), np.float16)
    with pytest.raises(ValueError, match="outside its image volume"):
        native.assemble_batch([img], [img.astype(np.uint8)], None,
                              np.asarray([[1, 0, 0]]), (8, 8, 8),
                              np.empty((1, 8, 8, 8, 1), np.float32),
                              np.empty((1, 8, 8, 8, 1), np.uint8))


def test_fallback_env_var(monkeypatch):
    """TPU_MEDNET_NO_NATIVE forces the numpy path through make_batch_source."""
    monkeypatch.setenv("TPU_MEDNET_NO_NATIVE", "1")
    assert not native.available()
    s = build_sampler()
    src = make_batch_source(s)
    assert src is s
    batches = list(src.batches(batch_size=4))
    assert batches and batches[0]["data"].dtype == torch.float32


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "tpu-mednet-prefetch" and t.is_alive()]


def test_prefetch_early_abandon_stops_worker():
    """Breaking out of an epoch mid-iteration must not leak or block the
    producer thread that runs the native pass."""
    assert not _prefetch_threads()
    it = device_prefetch(NativeBatchPipeline(build_sampler()).batches(batch_size=2), "cpu")
    next(it)
    assert _prefetch_threads()
    it.close()  # GeneratorExit -> finally: stop + drain + join
    assert not _prefetch_threads()


@pytest.mark.parametrize("prefetch", [False, True])
def test_held_batches_never_overwritten(prefetch):
    """The host pool never reuses a buffer the consumer still holds: hold
    every yielded tensor, then each still equals its snapshot (a reuse would
    corrupt it); 12 samples in batches of 5 drop the trailing 2 as JAX's
    ``drop_last=True`` (its Trainer's call) and the numpy sampler do."""
    pipe = NativeBatchPipeline(build_sampler())
    it = pipe.batches(batch_size=5)
    held, snaps = [], []
    for b in (device_prefetch(it, "cpu") if prefetch else it):
        held.append((b["data"], b["label"]))
        snaps.append((b["data"].clone(), b["label"].clone()))
    jax_batches = list(JaxNativeBatchPipeline(build_jax_sampler(), prefetch=False)
                       .batches(batch_size=5, drop_last=True))
    ref = list(build_sampler().batches(batch_size=5))
    assert len(held) == len(jax_batches) == len(ref) == 2
    assert held[0][0].data_ptr() != held[1][0].data_ptr()
    for (d, l), (sd, sl), jb, rb in zip(held, snaps, jax_batches, ref):
        assert d.shape[0] == 5
        assert torch.equal(d, sd) and torch.equal(l, sl)
        assert torch.equal(d, rb["data"]) and torch.equal(l, rb["label"])
        np.testing.assert_array_equal(_jax_layout(d), jb["data"])
        np.testing.assert_array_equal(_jax_layout(l), jb["label"])


def test_early_abandon_terminates_promptly():
    """Abandoning epochs after one batch, 30 times: the producer thread ends
    each time (a watchdog turns a hang into a failure)."""
    done = threading.Event()

    def run():
        for i in range(30):
            gen = device_prefetch(NativeBatchPipeline(build_sampler(seed=i))
                                  .batches(2, shuffle=True), "cpu")
            next(gen)
            gen.close()
        done.set()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert done.wait(timeout=120), "early-abandon shutdown hung (deadlock)"
    assert not _prefetch_threads()


class FakeEvent:
    def __init__(self):
        self.done = False
        self.waited = False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = True
        self.done = True


def test_pinned_pool_reuses_a_pair_only_after_its_copy(monkeypatch):
    """The pinned pool's gate, with stand-in events (no card here): a pair
    is handed out again only once its copy's event has completed; it never
    holds more than its limit, waiting on the oldest copy instead; a pair
    handed out without a reported copy is refused."""
    monkeypatch.setattr(PinnedPool, "_new_pair", lambda self: (
        torch.empty(4), torch.empty(4)))
    pool = PinnedPool(None, limit=3)
    events, pairs = [], []
    for _ in range(3):
        d, _, copied = pool.acquire()
        pairs.append(d)
        events.append(FakeEvent())
        copied(events[-1])
    assert len({p.data_ptr() for p in pairs}) == 3
    # all three copies in flight: the fourth waits on the oldest and reuses it
    d, _, copied = pool.acquire()
    assert events[0].waited and not events[1].waited and d is pairs[0]
    copied(FakeEvent())
    events[2].done = True
    d, _, copied = pool.acquire()
    assert d is pairs[2] and not events[1].waited
    with pytest.raises(RuntimeError, match="device_prefetch"):
        pool.acquire()
    assert native_loader.PINNED_POOL_LIMIT == 5


def test_pinned_batches_report_their_copy(monkeypatch):
    """A pinned pipeline's batch carries the copy hook; assembling the next
    batch before the hook ran is refused."""
    monkeypatch.setattr(PinnedPool, "_new_pair", lambda self: tuple(
        torch.empty(shape, dtype={np.float32: torch.float32, np.uint8: torch.uint8}[dt])
        for shape, dt in self.shapes))
    it = NativeBatchPipeline(build_sampler(), pinned=True).batches(4)
    first = next(it)
    assert callable(first[ON_COPIED])
    with pytest.raises(RuntimeError, match="not copied"):
        next(it)


def test_trainer_routes(monkeypatch):
    """The Trainer routes host samplers as the JAX Trainer does: None =
    auto, True = require (refused when unusable), False = numpy; a device
    sampler is left alone."""
    from tpu_mednet_torch.models import ResidualUNet3D
    from tpu_mednet_torch.tasks import SegmentationTask
    from tpu_mednet_torch.train import Trainer

    task = SegmentationTask(model=ResidualUNet3D(2, 3, f_maps=4, num_levels=2,
                                                 dtype=torch.float32, device="cpu"))
    s, v = build_sampler(), build_sampler(seed=1)
    auto = Trainer(task, s, v, batch_size=2)
    assert isinstance(auto.train_sampler, NativeBatchPipeline)
    assert isinstance(auto.val_sampler, NativeBatchPipeline)
    assert auto.train_sampler.sampler is s and not auto.train_sampler.pinned
    assert isinstance(Trainer(task, s, native_loader=True).train_sampler,
                      NativeBatchPipeline)
    numpy_route = Trainer(task, s, v, native_loader=False)
    assert numpy_route.train_sampler is s and numpy_route.val_sampler is v
    monkeypatch.setenv("TPU_MEDNET_NO_NATIVE", "1")
    assert Trainer(task, s).train_sampler is s
    with pytest.raises(RuntimeError, match="native loader requested but unavailable"):
        Trainer(task, s, native_loader=True)


def test_train_seg_native_losses_equal_numpy(tmp_path, monkeypatch):
    """``train_seg`` through ``main(argv)`` on the CPU: under the default
    (auto -> native) every step's loss is bit-equal to
    ``--no_native_loader``'s, one native call per batch drawn (training and
    validation), none under ``--no_native_loader``."""
    from tests.test_torch_cli import _train_argv, _write_store
    from tpu_mednet_torch.cli import train_seg
    from tpu_mednet_torch.train import Trainer

    _write_store(tmp_path)
    losses, batches = [], []
    orig_init, orig_batches = Trainer.__init__, Trainer._batches

    def init(self, *args, **kw):
        orig_init(self, *args, **kw)
        step = self.train_step

        def recorded(state, arrays):
            state, metrics = step(state, arrays)
            losses[-1].append(float(metrics["train_loss"]))
            return state, metrics
        self.train_step = recorded

    def counted(self, sampler, shuffle):
        for b in orig_batches(self, sampler, shuffle):
            batches[-1] += 1
            yield b

    monkeypatch.setattr(Trainer, "__init__", init)
    monkeypatch.setattr(Trainer, "_batches", counted)
    calls = []
    for tag, extra in (("native", ()), ("numpy", ("--no_native_loader",))):
        losses.append([])
        batches.append(0)
        before = native.ASSEMBLE_CALLS
        argv = _train_argv(tmp_path, "--max_epochs", "2", "--model_dir",
                           str(tmp_path / tag), "--log_dir", str(tmp_path / f"{tag}_logs"),
                           *extra)
        assert train_seg.main(argv) == 0
        calls.append(native.ASSEMBLE_CALLS - before)
    assert len(losses[0]) == 6 and losses[0] == losses[1]
    assert calls == [batches[0], 0] and batches[0] == batches[1] == 8
