"""Swin UNETR v1 (``models/swin_unetr.py``) against its plain reference on the CPU.

The reference is the benchmark's ``h100bench/reference/swin_unetr.py``,
loaded by its path: plain ``torch``, float32, MONAI's steps written out
(pad, roll, partition, materialised softmax attention, reverse), importing
nothing of the port.  A small model (``feature_size`` 12, 3 classes)
on 64^3 inputs exercises every path of the published one: stage 0 pads
32 -> 35, stage 1 16 -> 21, stage 2 pads 8 -> 14 and is shifted, stage 3
clamps its window to 4^3 (the ``[:n, :n]`` bias slice, no shift).  The port
runs in fp32 here, so every gap is summation order.
"""

from __future__ import annotations

import copy
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpu_mednet_torch.models import SwinUNETR, SwinUNETRConfig
from tpu_mednet_torch.models.swin_unetr import StageGeometry, _instance_norm
from tpu_mednet_torch.ops import groupnorm as gn
from tpu_mednet_torch.tasks import SegmentationTask
from tpu_mednet_torch.train import OptimizerConfig, create_train_state
from tpu_mednet_torch.train.step import apply_gradients

REPO = Path(__file__).resolve().parents[1]
_SPEC = importlib.util.spec_from_file_location(
    "swin_unetr_reference", REPO / "h100bench" / "reference" / "swin_unetr.py")
plain = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(plain)
CFG = dict(in_channels=1, out_channels=3, feature_size=12, depths=[2, 2, 2, 2],
           num_heads=[3, 6, 12, 24], window_size=7, patch_size=2, mlp_ratio=4)
BTCV = dict(CFG, out_channels=14, feature_size=48)
LR, WD = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One thread: the same summation order on any host and with any number
    of test workers (and no oversubscribed cores among them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(cfg: dict, seed: int):
    g = torch.Generator().manual_seed(seed)
    return plain.init_from_uniform(cfg, torch.rand(plain.param_count(cfg), generator=g))


def _model(params, dtype=torch.float32) -> SwinUNETR:
    m = SwinUNETR(SwinUNETRConfig(1, 3, 12, dtype=dtype), device="cpu")
    m.load_state_dict(params, strict=True)
    return m


@pytest.fixture(scope="module")
def run():
    """One forward and backward of the port (fp32) and of the plain
    reference, Dice + CE over a batch of two 64^3 samples."""
    torch.manual_seed(0)
    params = _params(CFG, 3)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 1, 64, 64, 64, generator=g)
    classes = torch.randint(0, 3, (2, 64, 64, 64), generator=g)
    model = _model(params)
    task = SegmentationTask(model=model, loss="DICE_CE")
    logits = model(x)
    loss, _ = task.loss_fn(logits, {"label": classes[:, None].to(torch.uint8)})
    loss.backward()
    ref_p = {k: v.clone().requires_grad_() for k, v in params.items()}
    ref_logits = plain.forward(CFG, ref_p, x)
    ref_loss = plain.dice_ce_loss(ref_logits, classes)
    ref_loss.backward()
    return types.SimpleNamespace(params=params, x=x, classes=classes, model=model, task=task,
                                 logits=logits.detach(), loss=loss.detach(),
                                 ref_logits=ref_logits.detach(), ref_loss=ref_loss.detach(),
                                 ref_grads={k: v.grad for k, v in ref_p.items()})


def test_logits_equal_the_plain_reference(run):
    # fp32 both sides: SDPA's fused softmax and the gathers against the
    # materialised scores and the rolls; observed gap ~3e-6 of logits ~4
    assert run.logits.shape == (2, 3, 64, 64, 64) and run.logits.dtype == torch.float32
    torch.testing.assert_close(run.logits, run.ref_logits, rtol=0, atol=1e-4)


def test_dice_ce_loss_equals_the_plain_reference(run):
    # the same logits into both losses: one fp32 summation order apart
    again = plain.dice_ce_loss(run.logits, run.classes)
    torch.testing.assert_close(run.task.loss_fn(run.logits, {"label": run.classes[:, None]})[0],
                               again, rtol=1e-6, atol=0)
    dice = float(again - F.cross_entropy(run.logits, run.classes))
    assert 0.0 < dice < 1.0  # both terms are in it
    torch.testing.assert_close(run.loss, run.ref_loss, rtol=1e-5, atol=0)


def test_every_leafs_gradient_equals_the_plain_reference(run):
    """Each leaf's gradient against the reference's, as a gap over the
    larger of its own and the median leaf's norm: the median gap under
    1e-2, every gap under 5e-2.  K1's plain path takes its statistics in
    fp32 as the kernels do, the variance as E[x^2] - E[x]^2, which one
    thread sums in order where the reference's ``F.instance_norm`` does
    not; the InstanceNorms of the deep levels (2^3 voxels at 64^3) and
    the leaves whose gradient an affine-free norm's backward nearly
    cancels amplify that rounding (observed on one thread: median 3.6e-3,
    worst 1.7e-2; on eight: 6.6e-4 and 1.5e-3).  The rest of the model
    is exact: ``test_the_model_is_monais_in_float64``."""
    grads = {k: p.grad for k, p in run.model.named_parameters()}
    assert set(grads) == set(run.ref_grads)
    med = float(np.median([float(g.norm()) for g in run.ref_grads.values()]))
    gaps = {k: float((grads[k] - want).norm()) / max(float(want.norm()), med)
            for k, want in run.ref_grads.items()}
    assert float(np.median(list(gaps.values()))) < 1e-2
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] < 5e-2, (worst, gaps[worst])


def test_the_model_is_monais_in_float64(monkeypatch):
    """With K1 (fp32 statistics by design) swapped for a float64
    ``F.instance_norm``, the port's logits and every leaf's gradient equal
    the reference's to float64 rounding: the windows' gathers, the fused
    attention with its bias and mask, the merging, the hidden states and
    the decoder are MONAI's arithmetic (observed 4e-15 and 2e-13)."""
    from tpu_mednet_torch.models import blocks

    def exact(self, x, residual=None, act=None):
        z = F.instance_norm(x, eps=self.eps) + (0.0 if residual is None else residual)
        return F.leaky_relu(z, self.slope) if act == "l" else z

    monkeypatch.setattr(blocks.GroupNorm, "forward", exact)
    cfg = dict(CFG, feature_size=6)  # head dim 2: the arithmetic, not the width, is checked
    g = torch.Generator().manual_seed(5)
    params = {k: v.double() for k, v in _params(cfg, 5).items()}
    model = SwinUNETR(SwinUNETRConfig(1, 3, 6, dtype=torch.float64), device="cpu").double()
    model.load_state_dict(params, strict=True)
    x = torch.randn(1, 1, 64, 64, 64, generator=g, dtype=torch.float64)
    w = torch.randn(1, 3, 64, 64, 64, generator=g, dtype=torch.float64)
    monkeypatch.setattr(torch.Tensor, "float", lambda t: t)  # both ends keep float64
    threads = torch.get_num_threads()
    torch.set_num_threads(4)  # float64 on the CPU is slow; its order does not matter here
    try:
        got = model(x)
        (got * w).sum().backward()
        ref_p = {k: v.clone().requires_grad_() for k, v in params.items()}
        want = plain.forward(cfg, ref_p, x)
        (want * w).sum().backward()
    finally:
        torch.set_num_threads(threads)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=0, atol=1e-11)
    for k, p in model.named_parameters():
        ref = ref_p[k].grad
        assert float((p.grad - ref).norm()) <= 1e-10 * float(ref.norm()) + 1e-14, k


def test_the_one_channel_conv3_gradient_is_exact_for_what_reaches_it(monkeypatch):
    """encoder1's residual branch, norm3(conv3(x)) from one channel, in a
    bf16 block: conv3's weight gradient is what a float64 instance norm of
    x * w gives for the gradient that reaches the branch.  Only the eps
    term of the norm is left of it, so a bf16 z or dz leaves noise of the
    gradient's size (observed 0.38 of it; the fp32 branch 1.1e-4)."""
    from tpu_mednet_torch.models import blocks, swin_unetr

    blk = swin_unetr.UnetResBlock(1, 8, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.rand(p.shape, generator=g) * 2 - 1)
    x = torch.randn(2, 1, 24, 24, 24, generator=g).to(torch.bfloat16)
    seen = {}
    norm = blocks.GroupNorm.forward

    def spy(self, z, residual=None, act=None):
        if residual is not None:
            residual.register_hook(lambda d: seen.update(dr=d.double()))
        return norm(self, z, residual=residual, act=act)
    monkeypatch.setattr(blocks.GroupNorm, "forward", spy)
    out = blk(x.contiguous(memory_format=torch.channels_last_3d))
    (out.float() * torch.randn(out.shape, generator=g)).sum().backward()
    w = blk.conv3.conv.weight.detach().double().view(1, -1, 1, 1, 1).requires_grad_()
    (F.instance_norm(x.double() * w, eps=1e-5) * seen["dr"]).sum().backward()
    got = blk.conv3.conv.weight.grad.double().flatten()
    assert float((got - w.grad.flatten()).norm()) <= 1e-3 * float(w.grad.norm())


def test_one_adamw_step_equals_the_plain_update(run):
    """The port's optimizer chain (``OptimizerConfig`` AdamW, the train
    step's ``apply_gradients``) against AdamW's first step written out
    (decay p by 1 - lr wd, then lr g / (|g| + eps)) from the same
    gradients, the port's, which the test above holds to the reference's:
    fp32 elementwise, within two roundings of the parameter (the decay
    and the step, each rounded to fp32) and 1e-6 of lr.
    The same gradients, since Adam's first step divides each by its own
    magnitude: a gradient of round-off size (the key bias's, which the
    softmax's shift invariance makes zero) moves by a full lr either way."""
    model = copy.deepcopy(run.model)
    for p, q in zip(model.parameters(), run.model.parameters()):
        p.grad = q.grad.clone()
    state = create_train_state(model, optimizer=OptimizerConfig(
        name="adamw", learning_rate=LR, weight_decay=WD))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    assert apply_gradients(state)
    moved = 0.0
    for k, p in model.named_parameters():
        g = p.grad
        want = before[k] * (1 - LR * WD) - LR * g / (g.abs() + 1e-8)
        torch.testing.assert_close(p.detach(), want, rtol=2.4e-7, atol=1e-6 * LR, msg=k)
        moved = max(moved, float((p.detach() - before[k]).abs().max()))
    assert moved > 0.9 * LR


def test_the_published_size_and_monais_names():
    m = SwinUNETR(SwinUNETRConfig(1, 14, 48), device="meta")
    names = dict(m.named_parameters())
    assert sum(p.numel() for p in names.values()) == 62_187_296 == plain.param_count(BTCV)
    assert list(names) == [name for name, *_ in plain.param_specs(BTCV)]
    assert names["swinViT.layers1.0.blocks.0.attn.qkv.weight"].shape == (144, 48)
    assert names["swinViT.layers4.0.blocks.1.attn.relative_position_bias_table"].shape == \
        (2197, 24)
    assert names["encoder1.layer.conv3.conv.weight"].shape == (48, 1, 1, 1, 1)
    assert names["decoder5.transp_conv.conv.weight"].shape == (768, 384, 2, 2, 2)
    assert "encoder2.layer.conv3.conv.weight" not in names  # 48 -> 48: the input is r
    swin = sum(p.numel() for k, p in names.items() if k.startswith("swinViT."))
    assert swin == 8_062_002
    # MONAI's checkpoints hold the (derived) bias index; it loads and is dropped
    sd = {k: torch.zeros(v.shape) for k, v in _model(_params(CFG, 1)).state_dict().items()}
    sd["swinViT.layers1.0.blocks.0.attn.relative_position_index"] = torch.zeros(343, 343)
    _model(_params(CFG, 1)).load_state_dict(sd, strict=True)


def test_stage_geometry_is_pad_roll_partition():
    """One gather and one scatter do MONAI's pad, roll, partition and its
    reverse: at 8^3 (padded to 14^3, shifted by 3) and at 4^3 (one window)."""
    x = torch.randn(2, 8, 8, 8, 5)
    for extent, shift in (((8, 8, 8), 3), ((8, 8, 8), 0), ((4, 4, 4), 3)):
        geo = StageGeometry(extent, 7, shift, "cpu")
        xe = x[:, :extent[0], :extent[1], :extent[2]]
        ws, ss = plain._window(extent, 7, shift)
        pads = [(w - e % w) % w for e, w in zip(extent, ws)]
        y = F.pad(xe, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        if any(ss):
            y = torch.roll(y, shifts=tuple(-s for s in ss), dims=(1, 2, 3))
        want = plain._partition(y, ws).reshape(2, -1, 5)
        padded = F.pad(xe, (0, 0, 0, geo.pad[2], 0, geo.pad[1], 0, geo.pad[0]))
        got = padded.reshape(2, -1, 5).index_select(1, geo.gather)
        assert torch.equal(got, want)
        back = got.index_select(1, geo.scatter).view(xe.shape)
        assert torch.equal(back, xe)
        assert geo.shifted == any(ss)
        if geo.shifted:
            assert torch.equal(geo.mask, plain._mask(y.shape[1:4], ws, ss, "cpu")[:, :, :])


@pytest.mark.parametrize("residual", [False, True])
def test_k1_plain_instance_norm_with_leaky_relu(residual):
    """K1's plain path at one channel a group, affine-free, LeakyReLU 0.01
    (the residual block's norm1, and norm2 with its residual): forward and
    gradients against ``F.instance_norm`` and ``F.leaky_relu`` in float64."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 6, 5, 6, 7, generator=g).contiguous(memory_format=torch.channels_last_3d)
    r = torch.randn(2, 6, 5, 6, 7, generator=g).contiguous(memory_format=torch.channels_last_3d)
    dy = torch.randn(2, 6, 5, 6, 7, generator=g)
    norm = _instance_norm(6, "cpu")
    assert not list(norm.parameters()) and not norm.state_dict()
    xa = x.clone().requires_grad_()
    ra = r.clone().requires_grad_() if residual else None
    y = norm(xa, residual=ra, act="l")
    y.backward(dy)
    xb = x.double().requires_grad_()
    rb = r.double().requires_grad_() if residual else None
    z = F.instance_norm(xb, eps=1e-5) + (rb if residual else 0.0)
    want = F.leaky_relu(z, 0.01)
    want.backward(dy.double())
    torch.testing.assert_close(y.double(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(xa.grad.double(), xb.grad, rtol=1e-4, atol=1e-5)
    if residual:
        torch.testing.assert_close(ra.grad.double(), rb.grad, rtol=1e-5, atol=1e-6)
    # the slope is the call's: the plain apply at 0.01 is not the default's 0.1
    stats = gn.group_norm_moments_plain(x, 6, torch.ones(6), 1e-5)
    a = gn.group_norm_apply_plain(x, stats.mean, stats.mul, torch.zeros(6), act="l", slope=0.01)
    b = gn.group_norm_apply_plain(x, stats.mean, stats.mul, torch.zeros(6), act="l")
    assert not torch.equal(a, b)
    torch.testing.assert_close(a.double(), F.leaky_relu(F.instance_norm(x.double(), eps=1e-5),
                                                        0.01), rtol=1e-5, atol=1e-5)


def test_segmentation_task_builds_swin_unetr_from_the_cli():
    from tpu_mednet_torch.cli import train_seg
    from tpu_mednet_torch.config import parse_with_config

    hp = parse_with_config(train_seg.build_parser(), [
        "-c", str(REPO / "configs" / "seg_btcv_swinunetr.yaml"), "--feature_size", "12",
        "--out_channels", "3", "--no_bf16"])
    assert (hp.arch, hp.feature_size, hp.loss, hp.optimizer) == ("SwinUNETR", 12, "DICE_CE",
                                                                 "adamw")
    task = SegmentationTask.from_hparams(hp, device="cpu",
                                         generator=torch.Generator().manual_seed(0))
    assert isinstance(task.model, SwinUNETR)
    assert task.model.config.feature_size == 12 and task.out_channels == 3
    assert task.model.config.dtype == torch.float32
    # seeded: the same generator seed, the same weights
    again = SegmentationTask.from_hparams(hp, device="cpu",
                                          generator=torch.Generator().manual_seed(0))
    for a, b in zip(task.model.parameters(), again.model.parameters()):
        assert torch.equal(a, b)
    logits = torch.randn(1, 3, 4, 4, 4, generator=torch.Generator().manual_seed(1))
    classes = torch.randint(0, 3, (1, 4, 4, 4), generator=torch.Generator().manual_seed(2))
    loss, _ = task.loss_fn(logits, {"label": classes[:, None]})
    torch.testing.assert_close(loss, plain.dice_ce_loss(logits, classes), rtol=1e-6, atol=0)
    # without --arch the task is the residual U-Net's, as before
    hp_default = parse_with_config(train_seg.build_parser(), ["--no_bf16", "--fmaps", "4"])
    assert not hasattr(hp_default, "arch")
    assert not isinstance(SegmentationTask.from_hparams(hp_default, device="cpu").model,
                          SwinUNETR)
    with pytest.raises(ValueError, match="remat"):
        SegmentationTask.from_hparams(types.SimpleNamespace(**dict(vars(hp), remat="1")))


def test_a_resume_across_architectures_is_refused():
    from tpu_mednet_torch.train.loop import _check_resume_architecture

    config = SwinUNETRConfig(1, 3, 12)
    _check_resume_architecture({"arch": "SwinUNETR", "feature_size": 12, "fmaps": 64,
                                "in_channels": 1, "out_channels": 3}, config, "ckpt")
    with pytest.raises(ValueError, match="feature_size"):
        _check_resume_architecture({"arch": "SwinUNETR", "feature_size": 48}, config, "ckpt")
    with pytest.raises(ValueError, match="arch"):
        _check_resume_architecture({"fmaps": 12}, config, "ckpt")


def test_predict_volumes_on_device_serves_swin_unetr(run):
    """One volume of 64^3 through the device stitch (one tile): the mask is
    the argmax of the model's own logits."""
    from tpu_mednet_torch.data import MemoryReader
    from tpu_mednet_torch.inference.device_sliding import predict_volumes_on_device

    vol = run.x[0].numpy().astype(np.float16)
    reader = MemoryReader({"images": {"v": vol}})
    out = predict_volumes_on_device(run.task, None, ["v"], patch_size=[64, 64, 64],
                                    patch_overlap=[0, 0, 0], batch_size=1, reader=reader,
                                    device="cpu")
    mask = np.asarray(out["v"].array)
    assert mask.shape == (1, 64, 64, 64) and mask.dtype == np.uint8
    with torch.no_grad():
        want = run.model(torch.from_numpy(vol.astype(np.float32))[None]).argmax(1)
    assert float((torch.from_numpy(mask[0].astype(np.int64)) == want[0]).float().mean()) > 0.999


def test_train_seg_and_predict_run_the_btcv_config(tmp_path):
    """``train_seg -c configs/seg_btcv_swinunetr.yaml`` (device sampler,
    mirror flips, Dice + CE, AdamW) one epoch on the CPU at a small width,
    then ``predict -c configs/predict.yaml`` from its best checkpoint,
    whose hparams rebuild the Swin UNETR: no side script."""
    from tpu_mednet_torch.cli import predict, train_seg
    from tpu_mednet_torch.data import zarrlite
    from tpu_mednet_torch.train import CheckpointManager

    rng = np.random.default_rng(0)
    z = zarrlite.open(str(tmp_path / "data.zarr"), mode="w")
    for key, shape in {"a": (64, 68, 72), "b": (72, 64, 66), "c": (64, 64, 64)}.items():
        lbl = np.zeros((1, *shape), np.uint8)
        lbl[0, 10:30, 12:34, 8:28] = 1
        lbl[0, 36:60, 30:50, 40:60] = 2
        img = (rng.normal(0, 0.5, size=(1, *shape)) + lbl).astype(np.float32)
        z.require_group("images").create_dataset(key, data=img).attrs["affine"] = \
            np.diag([1.5, 1.5, 2.0, 1.0])
        z.require_group("labels").create_dataset(key, data=lbl)
    for name, keys in (("train", "a\n"), ("val", "c\n"), ("test", "c\n")):
        (tmp_path / f"{name}.txt").write_text(keys)
    assert train_seg.main([
        "--device", "cpu", "-c", str(REPO / "configs" / "seg_btcv_swinunetr.yaml"),
        "--data_path", str(tmp_path / "data.zarr"), "--train_set", str(tmp_path / "train.txt"),
        "--val_set", str(tmp_path / "val.txt"), "--model_dir", str(tmp_path / "model"),
        "--log_dir", str(tmp_path / "logs"), "--feature_size", "12", "--out_channels", "3",
        "--class_probabilities", "0.5", "0.25", "0.25", "--patch_size", "64", "64", "64",
        "--patches_per_subject", "1", "--batch_size", "1", "--max_epochs", "1",
        "--no_bf16"]) == 0
    hp = CheckpointManager(tmp_path / "model" / "best").restore_hparams()
    assert (hp["arch"], hp["feature_size"], hp["loss"]) == ("SwinUNETR", 12, "DICE_CE")
    assert predict.main([
        "--device", "cpu", "-c", str(REPO / "configs" / "predict.yaml"),
        f"base.data={tmp_path / 'data.zarr'}", f"prediction.test_set={tmp_path / 'test.txt'}",
        f"prediction.checkpoint={tmp_path / 'model' / 'best'}",
        f"prediction.data={tmp_path / 'pred.zarr'}", "prediction.patch_size=[64, 64, 64]",
        "prediction.patch_overlap=[0, 0, 0]", "prediction.batch_size=1",
        "prediction.stitch=device"]) == 0
    mask = np.asarray(zarrlite.open(str(tmp_path / "pred.zarr"), mode="r")["prediction"]["c"])
    assert mask.shape == (1, 64, 64, 64) and mask.max() < 3


def test_the_serving_guard_takes_the_models_own_estimate():
    """The guard sizes a Swin UNETR's forward by its config's
    ``infer_peak_bytes``: the features it holds, the fitted full-resolution
    units and the shifted stages' masks (at 96^3: stages 0-2 shifted with
    343, 64 and 8 windows of 343 tokens; stage 3 one window, unshifted),
    and sends a volume the estimate does not fit to the host."""
    from tpu_mednet_torch.inference.common import budget_split
    from tpu_mednet_torch.utils import memory

    cfg = SwinUNETRConfig(1, 14, 48)
    masks = (343 + 64 + 8) * 343 ** 2 * 2 + 343 * 3 * 343 ** 2 * 2
    unit = 8 * 96 ** 3 * 48 * 2
    held = unit + sum(2 * 8 * (96 >> lvl) ** 3 * (48 << (lvl - 1)) * 2 for lvl in (1, 2, 3))
    held += 8 * 6 ** 3 * 384 * 2 + 8 * 3 ** 3 * 768 * 2
    assert cfg.infer_peak_bytes(8, (96, 96, 96)) == int(
        held + memory.SWIN_INFER_WORK_UNITS * unit + masks)
    task = SegmentationTask(model=SwinUNETR(SwinUNETRConfig(1, 3, 12), device="cpu"))
    est, _ = memory.device_stitch_bytes(
        (64, 64, 64), (64, 64, 64), (0, 0, 0), 1, 1, 1, stitch="device",
        params_bytes=memory.param_bytes(task.model), acc_channels=3,
        net_bytes=task.model.config.infer_peak_bytes(1, (64, 64, 64)))
    shapes = {"v": (1, 64, 64, 64)}
    for budget, fits in ((est, True), (est - 1, False)):
        fit, spill = budget_split(task, shapes, ["v"], (64, 64, 64), (0, 0, 0), 1, "device",
                                  (), "warn", budget, "cpu")
        assert (fit, spill) == ((["v"], []) if fits else ([], ["v"]))


def test_inspect_describes_a_swin_unetr_checkpoint(tmp_path, capsys):
    from tpu_mednet_torch.cli import inspect_ckpt
    from tpu_mednet_torch.train import CheckpointManager

    task = SegmentationTask(model=SwinUNETR(SwinUNETRConfig(1, 3, 12), device="cpu"))
    state = create_train_state(task.model, optimizer=OptimizerConfig(name="adamw"))
    CheckpointManager(tmp_path / "ckpt").save(1, state, hparams={
        "arch": "SwinUNETR", "feature_size": 12, "in_channels": 1, "out_channels": 3,
        "bf16": False})
    info = inspect_ckpt.inspect_checkpoint(tmp_path / "ckpt")
    assert info["model"]["arch"] == "SwinUNETR" and info["model"]["feature_size"] == 12
    assert info["model"]["params"] == sum(p.numel() for p in task.model.parameters())
    inspect_ckpt._print_text(info)
    assert "Swin UNETR, feature_size=12" in capsys.readouterr().out
