"""The HBM guard of the port's on-device stitches, against the JAX package.

The geometry of the estimate (the padded extent and every exact volume
term: input, padded copy, result, crop copy, accumulators) and the
parameter bytes are equal to JAX's; the working-set constants are the
port's own, refit on the card (``tpu_mednet_torch/utils/memory.py``).
Then the guard's three modes on both stitches: ``error`` raises before
any volume is read and closes a reader the pipeline opened, ``warn``
spills to the host stitch with the same TTA, whose results are equal to
the on-device ones, ``off`` lets every volume through.
"""

import logging

import numpy as np
import pytest
import torch

from tests.test_torch_tta import KW, SHAPES, make_pair, make_store
from tpu_mednet.utils import memory as jax_memory
from tpu_mednet_torch.data import MemoryReader
from tpu_mednet_torch.inference import (predict_volumes_on_device,
                                        predict_volumes_weighted_on_device)
from tpu_mednet_torch.utils import memory
from tpu_mednet_torch.utils.memory import HBMBudgetError

EXACT_TERMS = ("input_volume_f16", "padded_volume_f16", "params", "accumulator_f32",
               "weight_accumulator_f32", "result_u8", "crop_copy_u8")
PIPELINES = {"device": predict_volumes_on_device,
             "gaussian": predict_volumes_weighted_on_device}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The small models' many small ops run fastest on one thread; with
    several test workers on the host, more threads oversubscribe its cores
    (a spill test took 456 s instead of 25 s, six copies at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("stitch", ["device", "gaussian"])
@pytest.mark.parametrize("img,patch,overlap,c_in,out_c,acc_c", [
    ((24, 24, 24), (8, 8, 8), (2, 2, 2), 1, 1, 2),
    ((17, 19, 23), (8, 8, 8), (2, 2, 2), 4, 4, None),
    ((160, 160, 136), (96, 96, 96), (16, 16, 16), 4, 1, 4),
    ((512, 512, 512), (96, 96, 96), (16, 16, 16), 1, 4, 5),
])
def test_stitch_geometry_matches_jax(stitch, img, patch, overlap, c_in, out_c, acc_c):
    np.testing.assert_array_equal(memory._padded_extent(img, patch, overlap),
                                  jax_memory._padded_extent(img, patch, overlap))
    kw = dict(stitch=stitch, params_bytes=1234, acc_channels=acc_c)
    args = (img, patch, overlap, 8, c_in, out_c, (32, 64, 128, 256, 512))
    _, got = memory.device_stitch_bytes(*args, **kw)
    _, want = jax_memory.device_stitch_bytes(*args, **kw)
    assert set(got) == set(want)
    for term in EXACT_TERMS:
        assert got.get(term) == want.get(term), term
    for level in range(4):
        assert memory._unit_bytes(8, patch, level, 32, 2) == jax_memory._unit_bytes(
            8, patch, level, 32, 2)


def test_estimate_grows_with_volume_tta_and_model_channels():
    kw = dict(patch_size=(96,) * 3, patch_overlap=(16,) * 3, batch_size=8, in_channels=1,
              out_channels=1, feature_maps=(32, 64, 128, 256, 512))
    small, _ = memory.device_stitch_bytes((192,) * 3, **kw)
    large, _ = memory.device_stitch_bytes((512,) * 3, **kw)
    tta, _ = memory.device_stitch_bytes((192,) * 3, n_tta=8, **kw)
    gauss, _ = memory.device_stitch_bytes((192,) * 3, stitch="gaussian", **kw)
    wide, _ = memory.device_stitch_bytes((192,) * 3, stitch="gaussian", acc_channels=4, **kw)
    wide_tta, _ = memory.device_stitch_bytes((192,) * 3, n_tta=8, acc_channels=4, **kw)
    assert small < large and small < tta < wide_tta and small < gauss < wide
    with pytest.raises(ValueError, match="stitch"):
        memory.device_stitch_bytes((192,) * 3, stitch="crop", **kw)


def test_param_bytes_is_jax_tree_bytes():
    _, variables, task = make_pair("landmark")
    assert memory.param_bytes(task.model) == jax_memory.tree_bytes(variables) > 0


def test_budget_from_the_environment_or_the_host(monkeypatch):
    monkeypatch.setenv("TPU_MEDNET_HBM_GB", "2.5")
    assert memory.hbm_budget_bytes() == int(2.5 * 2**30)
    monkeypatch.delenv("TPU_MEDNET_HBM_GB")
    assert memory.hbm_budget_bytes("cpu") > 2**30  # the host's physical memory


def test_card_budget_is_what_the_allocator_can_reach(monkeypatch):
    """On the card the budget is the free memory plus the allocator's own
    reservation, not the card's total: the CUDA context, memory libraries
    take outside the allocator and other processes hold the rest."""
    monkeypatch.delenv("TPU_MEDNET_HBM_GB", raising=False)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (50 * 2**30, 80 * 2**30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: 3 * 2**30)
    assert memory.hbm_budget_bytes("cuda:0") == 53 * 2**30
    assert memory.hbm_budget_bytes() == 53 * 2**30  # the default device is the card


def test_check_stitch_budget_modes(caplog):
    args = ("s0", (64, 64, 64), (16, 16, 16), (4, 4, 4), 4, 1, 1, (4, 8))
    total, _ = memory.device_stitch_bytes(*args[1:])
    assert memory.check_stitch_budget(*args, budget_bytes=total)
    with pytest.raises(HBMBudgetError, match=r"volume 's0' \(64, 64, 64\) needs an estimated"):
        memory.check_stitch_budget(*args, budget_bytes=total - 1)
    with caplog.at_level(logging.WARNING):
        assert not memory.check_stitch_budget(*args, budget_bytes=total - 1, guard="warn")
    assert "Falling back to host stitching" in caplog.text
    assert memory.check_stitch_budget(*args, budget_bytes=1, guard="off")
    with pytest.raises(ValueError, match="error|warn|off"):
        memory.check_stitch_budget(*args, budget_bytes=1, guard="maybe")


@pytest.mark.parametrize("stitch", ["device", "gaussian"])
def test_guard_spills_to_the_host_stitch_with_the_same_results(stitch, caplog):
    _, _, task = make_pair("segmentation")
    store, attrs = make_store()
    keys = list(SHAPES)
    run = PIPELINES[stitch]
    kw = dict(KW, device="cpu", tta_flips=(1,))
    on_device = run(task, None, keys, reader=MemoryReader(store, attrs), **kw)
    assert list(run(task, None, ["s0"], reader=MemoryReader(store, attrs), hbm_guard="off",
                    hbm_budget=1, **KW, device="cpu")) == ["s0"]
    with caplog.at_level(logging.WARNING):
        spilled = run(task, None, keys, reader=MemoryReader(store, attrs), hbm_guard="warn",
                      hbm_budget=1, **kw)
    assert caplog.text.count("Falling back to host stitching") == len(keys)
    for key in keys:
        np.testing.assert_array_equal(spilled[key].array, on_device[key].array)
        assert spilled[key].attrs == on_device[key].attrs


class _TrackedReader(MemoryReader):
    def __init__(self, store, attrs):
        super().__init__(store, attrs)
        self.closed, self.reads = False, 0

    def read(self, *args, **kw):
        self.reads += 1
        return super().read(*args, **kw)

    def close(self):
        self.closed = True


@pytest.mark.parametrize("stitch", ["device", "gaussian"])
def test_guard_error_raises_before_reading_and_closes_the_owned_reader(stitch):
    _, _, task = make_pair("segmentation")
    store, attrs = make_store()
    holder = {}

    def factory(path):
        holder["r"] = _TrackedReader(store, attrs)
        return holder["r"]

    with pytest.raises(HBMBudgetError, match=f"'{stitch}' stitch path"):
        PIPELINES[stitch](task, "unused", list(SHAPES), reader_cls=factory, device="cpu",
                          hbm_budget=1 << 16, **KW)
    assert holder["r"].closed and holder["r"].reads == 0


def test_weighted_guard_counts_the_model_channels():
    """The Gaussian accumulator is the model's out_channels wide (2 here),
    not the uint8 result's 1: a budget between the two estimates refuses."""
    _, _, task = make_pair("segmentation")
    store, attrs = make_store()
    kw = dict(img_size=SHAPES["s0"], patch_size=KW["patch_size"],
              patch_overlap=KW["patch_overlap"], batch_size=KW["batch_size"], in_channels=1,
              out_channels=1, feature_maps=task.model.config.feature_maps, dtype_bytes=4,
              params_bytes=memory.param_bytes(task.model), stitch="gaussian")
    lo, _ = memory.device_stitch_bytes(**kw)
    hi, _ = memory.device_stitch_bytes(acc_channels=2, **kw)
    assert hi > lo
    with pytest.raises(HBMBudgetError):
        predict_volumes_weighted_on_device(task, None, ["s0"], reader=MemoryReader(store, attrs),
                                           device="cpu", hbm_budget=(lo + hi) // 2, **KW)
    with torch.inference_mode():
        out = predict_volumes_weighted_on_device(task, None, ["s0"], device="cpu",
                                                 reader=MemoryReader(store, attrs),
                                                 hbm_budget=hi, **KW)
    assert out["s0"].shape == (1, *SHAPES["s0"])


# -- the training half ----------------------------------------------------------

FLAGSHIP = dict(patch=(96, 96, 96), feature_maps=[32, 64, 128, 256, 512], in_channels=1,
                out_channels=2, n_params=35_316_738)
CONFIG4 = dict(patch=(128, 128, 128), feature_maps=[32, 64, 128, 256, 512], in_channels=4,
               out_channels=4, n_params=35_318_000)


@pytest.mark.parametrize("batch,kw,remat", [
    (36, FLAGSHIP, 1), (32, FLAGSHIP, 1), (16, FLAGSHIP, 1), (8, FLAGSHIP, 1),
    (8, FLAGSHIP, 0), (32, FLAGSHIP, 0), (32, FLAGSHIP, 2), (32, FLAGSHIP, True),
    (2, CONFIG4, 0), (2, CONFIG4, 1), (4, dict(FLAGSHIP, feature_maps=[64, 128, 256, 512, 1024],
                                                out_channels=5, n_params=141_246_661), 1),
])
def test_train_estimate_is_jax_with_jax_constants(monkeypatch, batch, kw, remat):
    """At the points of ``tests/test_memory.py`` (and the landmark model's),
    the port's structure with the JAX package's constants is JAX's estimate."""
    monkeypatch.setattr(memory, "TRAIN_OVERHEAD", jax_memory.XLA_OVERHEAD)
    monkeypatch.setattr(memory, "GN_F32_UNITS", jax_memory.GN_F32_UNITS)
    monkeypatch.setattr(memory, "TRAIN_WORK_UNITS", 0.0)  # JAX folds it into the overhead
    assert memory.unet_train_peak_bytes(batch, remat=remat, **kw) == \
        jax_memory.unet_train_peak_bytes(batch, remat=remat, **kw)


def test_train_estimate_falls_with_remat_and_refuses_the_double_family():
    """The double family has its branch since the UNet3D port
    (``tests/test_torch_unet3d.py`` holds it against JAX's); a family
    neither residual nor double is refused."""
    est = [memory.unet_train_peak_bytes(32, remat=r, **FLAGSHIP) for r in (0, 1, 2, True)]
    assert est == sorted(est, reverse=True) and len(set(est)) == 4
    assert memory.unet_train_peak_bytes(16, remat=1, **FLAGSHIP) < est[1]
    assert memory.unet_train_peak_bytes(8, block="double", **FLAGSHIP) > 0
    with pytest.raises(ValueError, match="'residual' or 'double'"):
        memory.unet_train_peak_bytes(8, block="packed", **FLAGSHIP)
