"""The port's DevicePatchSampler against the JAX package's, on the CPU.

The same in-memory store (3 subjects of different shapes, 3 classes), the
same seed and class probabilities: the host draws the same subjects and
corners (the port's own copy of ``data/sampling.py`` draws from the numpy
generator in the same order), and K2's plain version cuts the same
windows, so the batches are byte-equal: ``data`` in bf16, ``label`` uint8.
"""

import numpy as np
import pytest
import torch

from tpu_mednet.data import MemoryReader as JaxMemoryReader
from tpu_mednet.data.device_sampler import DevicePatchSampler as JaxSampler
from tpu_mednet_torch.data import DevicePatchSampler, MemoryReader

SHAPES = ((20, 18, 16), (16, 22, 17), (18, 16, 24))
PATCH = (8, 6, 10)


def _store():
    rng = np.random.default_rng(0)
    store = {"images": {}, "labels": {}}
    for i, shape in enumerate(SHAPES):
        lbl = np.zeros((1, *shape), np.uint8)
        lbl[0, 3:9, 4:10, 2:8] = 1
        lbl[0, 10:14, 8:12, 9:15] = 2
        img = rng.normal(size=(1, *shape)).astype(np.float32) + lbl
        store["images"][f"s{i}"] = img
        store["labels"][f"s{i}"] = lbl
    return store


def _samplers(samples_per_subject, probs=(0.2, 0.4, 0.4), seed=3):
    keys = [f"s{i}" for i in range(len(SHAPES))]
    store = _store()
    kw = dict(subject_keys=keys, samples_per_subject=samples_per_subject,
              patch_size=PATCH, class_probabilities=probs, seed=seed)
    ref = JaxSampler(None, reader=JaxMemoryReader(store), **kw)
    port = DevicePatchSampler(None, reader=MemoryReader(store), device="cpu", **kw)
    return ref, port


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    assert t.is_contiguous(memory_format=torch.channels_last_3d)
    return t.permute(0, 2, 3, 4, 1)


@pytest.mark.parametrize("probs", [(0.2, 0.4, 0.4), None])
def test_batches_are_byte_equal_to_jax(probs):
    ref, port = _samplers(4, probs)
    assert port.images.dtype == torch.bfloat16 and port.labels.dtype == torch.uint8
    assert tuple(port.images.shape) == tuple(ref.images.shape)
    n = 0
    for a, b in zip(ref.batches(4), port.batches(4)):
        data, label = _channels_last(b["data"]), _channels_last(b["label"])
        assert data.shape == a["data"].shape and label.shape == a["label"].shape
        np.testing.assert_array_equal(data.contiguous().view(torch.int16).numpy(),
                                      np.asarray(a["data"]).view(np.int16))
        np.testing.assert_array_equal(label.numpy(), np.asarray(a["label"]))
        n += 1
    assert n == 3


def test_trailing_partial_batch_is_dropped_like_jax():
    ref, port = _samplers(3)  # 9 items, batch 4: two full batches
    got, want = list(port.batches(4)), list(ref.batches(4))
    assert len(got) == len(want) == 2
    for a, b in zip(want, got):
        np.testing.assert_array_equal(_channels_last(b["label"]).numpy(), np.asarray(a["label"]))


def test_short_epoch_raises():
    _, port = _samplers(1)  # 3 items, batch 5
    with pytest.raises(ValueError, match="shorter than one batch"):
        next(port.batches(5))


def test_sample_indices_match_jax():
    ref, port = _samplers(4)
    for _ in range(3):
        s_ref, c_ref = ref.sample_indices(6)
        s, c = port.sample_indices(6)
        assert s.dtype == c.dtype == np.int32
        np.testing.assert_array_equal(s, np.asarray(s_ref))
        np.testing.assert_array_equal(c, np.asarray(c_ref))


def test_unported_groups_and_bad_stores_raise():
    store = _store()
    with pytest.raises(NotImplementedError, match="heatmap"):
        DevicePatchSampler(None, ["s0"], 1, PATCH, heatmap_group="hm",
                           reader=MemoryReader(store), device="cpu")
    store["labels"]["s0"] = store["labels"]["s0"][:, :-1]
    with pytest.raises(ValueError, match="does not match image extent"):
        DevicePatchSampler(None, ["s0"], 1, PATCH, reader=MemoryReader(store), device="cpu")
    with pytest.raises(ValueError, match="smaller than the patch"):
        DevicePatchSampler(None, ["s1"], 1, (32, 8, 8), reader=MemoryReader(_store()),
                           device="cpu")
