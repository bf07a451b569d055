"""Swin UNETR v1's family (``families/SwinUNETRv1.py``) on the CPU.

Its counts at the BTCV cell's 96^3 and its seeded weights are pinned; the
train loop runs through a tiny Swin configuration kept under
``tests/configs/``; its kernel name parts leave every kernel of the
residual cells in its group.

Run: ``python -m pytest h100bench/tests/test_swin_family.py -q`` from the
repository root.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from h100bench import counting, data, harness, trace  # noqa: E402
from h100bench.reference import swin_unetr  # noqa: E402
from h100bench.tests.test_families import KERNELS  # noqa: E402
from h100bench.tests.test_h100bench_yardstick import BENCH  # noqa: E402

TESTS = Path(__file__).resolve().parent
CELL = "swinunetr_btcv_train_b4"
CFG = json.loads((ROOT / "h100bench" / "configs" / "swinunetr_btcv_f48.json").read_text())
TINY = json.loads((TESTS / "configs" / "swin_unetr_tiny.json").read_text())
FAM = harness.family_of(CFG, "swinunetr_btcv_f48.json")
PATCH = (96, 96, 96)

# conv, Linear and attention FLOPs of one 96^3 sample's forward; K1's
# forward and backward bytes of a batch-4 step; the sha256 of data.weights
# at seed 12345678901 on the CPU (each name, then its fp32 bytes)
PINNED_TERMS = {"conv": 587280678912.0, "linear": 24843386880.0, "attention": 22867466880.0}
PINNED_K1 = (5430675456.0, 8541904896.0)
PINNED_WEIGHTS = "e9afe1980b093135866cc04e416009b462580c289ded2c93786853edfea8e3d0"


def test_the_counts_at_96():
    assert FAM._terms(CFG, PATCH) == PINNED_TERMS
    assert FAM.forward_flops(CFG, PATCH) == sum(PINNED_TERMS.values())
    assert FAM.conv_flops(CFG, PATCH) == PINNED_TERMS["conv"]
    norms = FAM.norm_layers(CFG, PATCH)
    assert (counting.k1_forward_bytes(CFG, norms, 4),
            counting.k1_backward_bytes(CFG, norms, 4)) == PINNED_K1
    work = FAM.group_work(CFG, PATCH, True)
    assert work["attn"]["flops"] == 3 * PINNED_TERMS["attention"]
    assert work["linear"]["flops"] == 3 * PINNED_TERMS["linear"]
    assert FAM.group_work(CFG, PATCH, False)["linear"]["flops"] == PINNED_TERMS["linear"]
    assert CFG["parameters"] == FAM.param_count(CFG) == 62_187_296


def test_the_attention_bytes_at_96():
    """A sample: twelve bf16 tensors of the padded tokens (49^3 x 48, 28^3
    x 96, 14^3 x 192, 6^3 x 384) in each of a stage's two blocks.  A step,
    whatever the batch, in each of its two passes: every block's bias
    (heads x n^2) and the shifted blocks' masks (windows x n^2) of stages 0
    to 2 (343, 64 and 8 windows of 343 tokens; stage 3 is one window)."""
    attn = FAM.group_work(CFG, PATCH, True)["attn"]
    tokens = 49 ** 3 * 48 + 28 ** 3 * 96 + 14 ** 3 * 192 + 6 ** 3 * 384
    assert attn["bytes"] == 12 * 2 * 2 * tokens
    bias = 2 * (3 * 343 ** 2 + 6 * 343 ** 2 + 12 * 343 ** 2 + 24 * 216 ** 2)
    masks = (343 + 64 + 8) * 343 ** 2
    assert attn["step_bytes"] == 2 * 2 * (bias + masks)
    # serving: the forward's four tensors, one pass
    attn = FAM.group_work(CFG, PATCH, False)["attn"]
    assert attn["bytes"] == 4 * 2 * 2 * tokens and attn["step_bytes"] == 2 * (bias + masks)


def test_the_attention_roofline_reads_the_step_bytes_once():
    """The reader divides the scaled ``step_bytes`` back by the batch: 10
    steps of batch 4 read the masks and biases 10 times, not 40."""
    from h100bench.metrics import attn_roofline

    steps, batch = 10, 4
    work = counting.scaled(FAM.group_work(CFG, PATCH, True), steps * batch)
    least = (steps * batch * FAM.group_work(CFG, PATCH, True)["attn"]["bytes"]
             + steps * FAM.group_work(CFG, PATCH, True)["attn"]["step_bytes"]) \
        / counting.PEAK_HBM_BYTES
    record = {"patches": 100 * batch, "attempted": 100,
              "stretch": {"groups": {"attn": 4 * least}, "work": work}}
    assert attn_roofline.read(record) == pytest.approx(25.0, rel=1e-12)
    assert attn_roofline.read({"patches": 4, "attempted": 1}) is None


@pytest.mark.parametrize("patch", [(96, 96, 96), (64, 64, 64), (128, 96, 160)])
def test_flops_equal_the_program_count(patch):
    from tpu_mednet_torch.utils import flops

    want = flops.swin_unetr_forward_terms(
        CFG["in_channels"], CFG["out_channels"], CFG["feature_size"], patch,
        depths=CFG["depths"], num_heads=CFG["num_heads"], window=CFG["window_size"],
        patch_size=CFG["patch_size"], mlp_ratio=CFG["mlp_ratio"])
    assert FAM._terms(CFG, patch) == want
    assert FAM.forward_flops(CFG, patch) == flops.swin_unetr_forward_flops(
        CFG["in_channels"], CFG["out_channels"], CFG["feature_size"], patch)


def test_the_weights_are_pinned():
    h = hashlib.sha256()
    for k, v in data.weights(FAM, CFG, 12345678901, torch.device("cpu")).items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    assert h.hexdigest() == PINNED_WEIGHTS


def test_k1_bytes_are_the_layers_own():
    """Every InstanceNorm of the program's model, hooked in a forward: its
    input, residual and output give the layers ``norm_layers`` lists."""
    from tpu_mednet_torch.models.blocks import GroupNorm

    patch, batch = (64, 64, 64), 1
    task = FAM.port_task(dict(TINY, dtype="float32"),
                         data.weights(FAM, TINY, 1, torch.device("cpu")), "cpu")
    seen = []

    def hook(mod, args, kwargs, out):
        x, res = args[0], kwargs.get("residual")
        assert mod.num_groups == mod.num_channels and not list(mod.parameters())
        seen.append((x.shape[1], x[0, 0].numel(), res is not None))
    for m in task.model.modules():
        if isinstance(m, GroupNorm):
            m.register_forward_hook(hook, with_kwargs=True)
    with torch.no_grad():
        task.model(torch.zeros(batch, 1, *patch))
    assert sorted(seen) == sorted(FAM.norm_layers(TINY, patch))


def test_the_reference_loss_is_dice_plus_ce():
    """The family's ``Loss`` (terms, value, linearised) against the
    reference's ``dice_ce_loss`` and the program's DICE_CE, and its blocks'
    linearised gradient against the whole batch's."""
    from tpu_mednet_torch.ops import losses as L

    g = torch.Generator().manual_seed(1)
    logits = torch.randn(4, 3, 6, 6, 6, generator=g)
    label = torch.randint(0, 3, (4, 1, 6, 6, 6), generator=g).to(torch.uint8)
    loss = FAM.reference_loss(TINY)
    value = loss.value(loss.terms(logits, label))
    torch.testing.assert_close(value, swin_unetr.dice_ce_loss(logits, label[:, 0]),
                               rtol=1e-6, atol=0)
    port = L.dice_loss(logits, label[:, 0].long()) + L.ce_loss(logits, label[:, 0].long())
    torch.testing.assert_close(value, port, rtol=1e-6, atol=0)
    a = logits.clone().requires_grad_()
    loss.value(loss.terms(a, label)).backward()
    b = logits.clone().requires_grad_()
    total = loss.terms(b.detach(), label)
    for s in (slice(0, 1), slice(1, 4)):
        loss.linearised(loss.terms(b[s], label[s]), total).backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-9)


# kernel names of the Swin cell's step as the profiler gave them on the
# H100 (torch 2.11, cu128), with the group each belongs to
SWIN_KERNELS = [
    ("fmha_cutlassF_bf16_aligned_64x64_rf_sm80(PyTorchMemEffAttention::AttentionKernel<cutlass::"
     "bfloat16_t, cutlass::arch::Sm80, true, 64, 64, 64, true, true>::Params)", "attn"),
    ("fmha_cutlassB_bf16_aligned_64x64_k32_sm80(PyTorchMemEffAttention::AttentionBackwardKernel<"
     "cutlass::arch::Sm80, cutlass::bfloat16_t, true, false, true, 64, 64, 32, false>::Params)",
     "attn"),
    ("nvjet_tst_48x512_64x3_1x2_h_ssched_bz_coopA_TNN", "linear"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16_128x128_32x4_nn_align2>("
     "cutlass_80_tensorop_bf16_s16816gemm_bf16_128x128_32x4_nn_align2::Params)", "linear"),
    ("void cutlass::Kernel2<cutlass_75_tensorop_bf16_s1688gemm_bf16_128x64_nn_align1>("
     "cutlass_75_tensorop_bf16_s1688gemm_bf16_128x64_nn_align1::Params)", "linear"),
    ("sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize256x32x32_stage4_"
     "warpsize4x1x1_g1_tensor16x8x16_execute_kernel__5x_cudnn", "conv"),
    ("sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x64x64_"
     "warpgroupsize1x1x1_g1_execute_segment_k_on_kernel__5x_cudnn", "conv"),
    ("void implicit_convolveNd_sgemm<__nv_bfloat16, 3, 1024, 5, 5, 3, 3, 3, 1, false, false, "
     "true>(int, int, int, __nv_bfloat16 const*, int, __nv_bfloat16*)", "conv"),
    ("void (anonymous namespace)::gn_bwd_apply_kernel<__nv_bfloat16, 8, true>(__nv_bfloat16 "
     "const*, __nv_bfloat16 const*)", "k1"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<c10::BFloat16, float, "
     "false>(int, float, c10::BFloat16 const*)", "other"),
]


@pytest.mark.parametrize("name,group,label", KERNELS)
def test_the_name_parts_take_no_residual_kernel(name, group, label):
    assert trace.group_of(name, FAM.KERNEL_GROUPS) == group


@pytest.mark.parametrize("name,group", SWIN_KERNELS)
def test_the_swin_kernels_fall_in_their_groups(name, group):
    assert trace.group_of(name, FAM.KERNEL_GROUPS) == group


# the tiny configuration's cell: the benchmark's cell name (its traffic and
# limits files) over the test configuration
TEST_BENCH = dict(BENCH, configs=[{"name": "swin_unetr_tiny",
                                   "file": "h100bench/tests/configs/swin_unetr_tiny.json"}],
                  workloads=[{"name": CELL, "config": "swin_unetr_tiny",
                              "traffic": "btcv_train_p96_b4", "chips": 1}])


def _tiny_cell(fault):
    cell = harness.load_cell(CELL, 12345678901, 0.5, False, "cpu", bench=TEST_BENCH)
    cell.traffic = dict(cell.traffic, batch=2, patch=[64, 64, 64], samples_per_subject=2,
                        subjects=[[72, 68, 70], [68, 72, 76]],
                        class_probabilities=[0.5, 0.25, 0.25], reference_rows=1,
                        warmup_steps=0, first_steps=2)
    cell.fault = fault
    return cell


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch", "convs_unmoved"])
def test_a_tiny_swin_runs_through_the_train_loop(fault):
    """At 64^3 (the least extent whose deepest stage holds more than one
    voxel for its InstanceNorm), two samples, the reference in blocks of
    one row (its linearised Dice + CE), judged by the cell's own limits:
    correct, and not with a fault planted under the timed path.  The tiny
    configuration computes in fp32: at feature_size 12 the bf16 program's
    smallest leaves (stage 0's LayerNorm biases) read a worst-leaf gradient
    gap of 0.23 against the published width's 0.02-0.07 (PERF.md §2), a
    width effect the fp32 program, fed the sampler's bf16 image, does not
    have (0.06)."""
    out = harness.execute(_tiny_cell(fault))
    assert out["correct"] == (fault is None), out["checks"]
    assert out["attempted"] > 0
