"""Model families as files (``families/<model>.py``), on the CPU.

The counts and seeded weights of the residual family are pinned to what the
harness gave before it read them through its family module; a family kept
under ``tests/families/`` runs through both loops with no file outside the
tests naming it.

Run: ``python -m pytest h100bench/tests -q`` from the repository root.
"""

from __future__ import annotations

import hashlib
import json
import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from h100bench import counting, data, harness, trace  # noqa: E402
from h100bench.reference import train as ref_train  # noqa: E402
from h100bench.tests.test_h100bench_yardstick import (BENCH, CONFIGS, TRAFFIC,  # noqa: E402
                                                      tiny_cell)

TESTS = Path(__file__).resolve().parent
TEST_FAMILIES = TESTS / "families"

# forward_flops, train_step_flops, k1_forward_bytes, k1_backward_bytes and
# k2_bytes (tiles: the batch) at each cell's patch and batch, and the sha256
# of data.weights at seed 12345678901 on the CPU (each name, then its fp32
# bytes, in the state dict's order): the harness's readings before the
# residual family moved into its module
PINNED_COUNTS = {
    "organ_train_p128": [1214670438400.0, 14576045260800.0, 9997123584.0, 15709765632.0,
                         33554432.0],
    "organ_serve_128": [512439091200.0, 12298538188800.0, 8435073024.0, 13255114752.0,
                        28311552.0],
    "landmarks_train_b4": [2046132486144.0, 24553589833728.0, 8435073024.0, 13255114752.0,
                           14155776.0],
}
PINNED_WEIGHTS = {
    "resunet3d_organ_f32": "73cad15a730a537b9eb3570e2cf444a265d4eb44486a336bc0f4f3dbd56bf36a",
    "resunet3d_landmarks_f64": "f3ccdab613d2d68b29c3b33bbe103fb7a8ab17c1ab257065cc63219ee0c8b77c",
}
CONFIG_OF = {w["name"]: w["config"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("workload", sorted(PINNED_COUNTS))
def test_the_counts_are_the_parents(workload):
    cfg, t = CONFIGS[CONFIG_OF[workload]], TRAFFIC[workload]
    fam = harness.family_of(cfg, workload)
    patch, batch = tuple(t["patch"]), int(t["batch"])
    norms = fam.norm_layers(cfg, patch)
    got = [fam.forward_flops(cfg, patch),
           counting.train_step_flops(fam.forward_flops(cfg, patch), batch),
           counting.k1_forward_bytes(cfg, norms, batch),
           counting.k1_backward_bytes(cfg, norms, batch),
           counting.k2_bytes(cfg, patch, batch)]
    assert got == PINNED_COUNTS[workload]
    assert fam.conv_flops(cfg, patch) == got[0]


@pytest.mark.parametrize("name", sorted(PINNED_WEIGHTS))
def test_the_weights_are_the_parents(name):
    cfg = CONFIGS[name]
    h = hashlib.sha256()
    for k, v in data.weights(harness.family_of(cfg, name), cfg, 12345678901,
                             torch.device("cpu")).items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    assert h.hexdigest() == PINNED_WEIGHTS[name]


def test_a_model_without_a_family_is_refused_naming_the_path(tmp_path):
    cfg = dict(CONFIGS["resunet3d_organ_f32"], model="SwinUNETR")
    with pytest.raises(SystemExit, match=r"model 'SwinUNETR'.*families/SwinUNETR\.py"):
        harness.family_of(cfg, "configs/x.json")
    # a search path of the caller's own: the residual family is not there
    with pytest.raises(SystemExit, match=str(tmp_path / "ResidualUNet3D.py")):
        harness.family_of(CONFIGS["resunet3d_organ_f32"], "configs/x.json", tmp_path)


# names of device operations as the profiler gives them, each with the
# group and the breakdown's label that the shared rule gave them before
# families had groups of their own (the residual cells' kernels, as in the
# ledger's breakdowns: cuDNN's conv kernels, K1, K2, elementwise kernels,
# pooling, Adam's multi-tensor kernel, the softmax, layout kernels, copies)
KERNELS = [
    ("sm90_xmma_wgrad_implicit_gemm_bf16bf16_bf16f32_f32_ndhwckrsc_ndhwc_tilesize128x128x64_"
     "warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn", "conv", "conv wgrad"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_ndhwckrsc_ndhwc_tilesize128x256x64_"
     "warpgroupsize2x1x1_execute_segment_k_off_kernel__5x_cudnn", "conv", "conv fprop"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_ndhwckrsc_ndhwc_tilesize128x128x64_"
     "kernel__5x_cudnn", "conv", "conv dgrad"),
    ("void cudnn::cnn::wgrad_alg0_engine<float, 128, 6, 7, 3, 3, 5, false, 512>(int, int, int, "
     "float const*, int, float*, float const*, kernel_grad_params, unsigned long long, int, "
     "float, int, int, int, int)", "conv", "conv wgrad"),
    ("void gn_bwd_apply_kernel<__nv_bfloat16, true>(GnApplyArgs)", "k1", "K1 gn_bwd_apply"),
    ("void gn_apply_kernel<__nv_bfloat16>(GnApplyArgs)", "k1", "K1 gn_apply"),
    ("void gn_bwd_reduce_kernel<__nv_bfloat16>(GnReduceArgs)", "k1", "K1 gn_bwd_reduce"),
    ("void gn_moments_kernel<__nv_bfloat16, 8>(GnMomentsArgs)", "k1", "K1 gn_moments"),
    ("void gather_stores_kernel<__half, __nv_bfloat16>(GatherArgs)", "k2", "K2 gather_stores"),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}>(int)", "other",
     "void at::native::elementwise_kernel<128, 4, at::native::gpu_"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunctor_add<c10::BFloat16>"
     ", std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<c10::BFloat16>, "
     "std::array<char*, 3ul>)", "other",
     "void at::native::vectorized_elementwise_kernel<8, at::native"),
    ("void at::native::(anonymous namespace)::max_pool3d_with_indices_single_out_frame<c10::"
     "BFloat16>(c10::BFloat16 const*, int, int)", "other",
     "void at::native::(anonymous namespace)::max_pool3d_with_indi"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::(anonymous "
     "namespace)::TensorListMetadata<4>, at::native::(anonymous namespace)::FusedAdamMathFunctor"
     "<float, 4, (at::native::ADAM_MODE)0, false>>(...)", "other",
     "void at::native::(anonymous namespace)::multi_tensor_apply_k"),
    ("void at::native::(anonymous namespace)::cunn_SpatialSoftMaxForward<float, float, float, "
     "at::native::(anonymous namespace)::SoftMaxForwardEpilogue>(float*, float const*, "
     "unsigned int, unsigned int, unsigned int)", "other",
     "void at::native::(anonymous namespace)::cunn_SpatialSoftMaxF"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, float, "
     "false, true, (cudnnKernelDataType_t)0>(cudnn::engines_precompiled::nchwToNhwc_params_t"
     "<float>, __nv_bfloat16 const*, __nv_bfloat16*)", "other",
     "void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloa"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::"
     "func_wrapper_t<float, at::native::sum_functor<float, float, float>>, unsigned int, float, "
     "4> >(...)", "other", "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<"),
    ("Memcpy HtoD (Pinned -> Device)", "other", "Memcpy"),
    ("Memset (Device)", "other", "Memset"),
]


@pytest.mark.parametrize("name,group,label", KERNELS)
def test_the_residual_kernels_keep_their_groups(name, group, label):
    fam = harness.family_of(CONFIGS["resunet3d_organ_f32"], "x")
    assert trace.group_of(name, fam.KERNEL_GROUPS) == group
    assert trace.op_label(name, fam.KERNEL_GROUPS) == label


@pytest.mark.parametrize("name", [
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1_cublas",
    "fmha_cutlassF_bf16_aligned_64x64_rf_sm80(PyTorchMemEffAttention::AttentionKernel<cutlass::"
    "bfloat16_t, cutlass::arch::Sm80, true, 64, 64, 64, true, true>::Params)",
])
def test_a_familys_name_parts_come_first(name):
    """A family's matmuls and fused attention, which the shared rule counts
    as convolutions, go to the family's own groups."""
    assert trace.group_of(name) == "conv"
    parts = {"xmma_gemm": "linear", "fmha": "attn"}
    own = trace.group_of(name, parts)
    assert own in ("linear", "attn")
    assert trace.op_label(name, parts).startswith(own + " ")


def _event(name, start, end, device=False):
    kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(name=name, device_type=kind, is_user_annotation=False,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def test_idle_gaps_are_named_by_the_innermost_program_span():
    events = [_event("h100bench.request", 0, 100),
              _event("tpu_mednet_torch.serve.call", 1, 99),
              _event("tpu_mednet_torch.serve.upload", 10, 30),
              _event("aten::copy_", 8, 28),
              _event("gemm_kernel", 0, 10, device=True),
              _event("gn_apply_kernel", 25, 40, device=True),
              _event("h100bench.request", 50, 60),
              _event("gn_apply_kernel", 70, 80, device=True)]
    r = trace.reduce_events(events, 1e-4, 0, {"gemm": "linear"})
    assert r["busy_s"] == pytest.approx(35e-6)
    assert r["groups"] == {"linear": pytest.approx(10e-6), "k1": pytest.approx(25e-6)}
    assert dict(r["idle_gaps"]) == {
        "tpu_mednet_torch.serve.upload / aten::copy_": pytest.approx(15e-6),
        "tpu_mednet_torch.serve.call / no host op": pytest.approx(30e-6)}


def test_adamw_reference_is_torchs():
    g = torch.Generator().manual_seed(3)
    start = {"a": torch.randn(7, 3, generator=g), "b": torch.randn(5, generator=g)}
    grads = [{k: torch.randn(v.shape, generator=g) for k, v in start.items()} for _ in range(3)]
    mine = {k: v.clone() for k, v in start.items()}
    m = {k: torch.zeros_like(v) for k, v in mine.items()}
    v_ = {k: torch.zeros_like(v) for k, v in mine.items()}
    theirs = [start[k].clone().requires_grad_() for k in start]
    opt = torch.optim.AdamW(theirs, lr=0.01, weight_decay=0.5)
    for step, gr in enumerate(grads, 1):
        ref_train.adam_(mine, gr, m, v_, step, 0.01, weight_decay=0.5)
        for p, k in zip(theirs, start):
            p.grad = gr[k]
        opt.step()
    for p, k in zip(theirs, start):
        assert torch.allclose(mine[k], p.detach(), rtol=1e-5, atol=1e-7), k
    # the decay is what moves them apart from Adam's
    assert not torch.allclose(mine["a"], _adam(start, grads)["a"], rtol=1e-4)


def _adam(start, grads):
    p = {k: v.clone() for k, v in start.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v_ = {k: torch.zeros_like(v) for k, v in p.items()}
    for step, gr in enumerate(grads, 1):
        ref_train.adam_(p, gr, m, v_, step, 0.01)
    return p


# the test family's cells: its configuration under the present cells'
# names, so that the cells' traffic and limits files serve it unchanged
TEST_BENCH = dict(
    BENCH,
    configs=[{"name": "two_conv_net", "file": "h100bench/tests/configs/two_conv_net.json"}],
    workloads=[{"name": "organ_train_p128", "config": "two_conv_net",
                "traffic": "seg_organ_p128_b4", "chips": 1},
               {"name": "organ_serve_128", "config": "two_conv_net",
                "traffic": "predict_128", "chips": 1}])


@pytest.mark.parametrize("workload,fault", [
    ("organ_train_p128", None), ("organ_train_p128", "unchanged"),
    ("organ_train_p128", "half_batch"), ("organ_serve_128", None),
    ("organ_serve_128", "altered")])
def test_a_family_kept_in_the_tests_runs_through_both_loops(workload, fault):
    """Found by the same discovery under another search path, its program
    in bf16 against its fp32 reference, through AdamW: correct; with a
    fault planted under the timed path: not correct."""
    cell = tiny_cell(workload, fault=fault, bench=TEST_BENCH, families=TEST_FAMILIES)
    assert cell.family.__name__.endswith("TwoConvNet")
    out = harness.execute(cell)
    assert out["correct"] == (fault is None), out["checks"]
    assert out["attempted"] > 0


def test_the_test_family_is_no_family_of_the_benchmark():
    cfg = json.loads((TESTS / "configs" / "two_conv_net.json").read_text())
    with pytest.raises(SystemExit, match="TwoConvNet"):
        harness.family_of(cfg, "two_conv_net.json")


SHARED = ["harness.py", "data.py", "counting.py", "loops/train.py", "loops/serve.py",
          "reference/train.py", "reference/serve.py", "control.py", "trace.py"]


@pytest.mark.parametrize("path", SHARED)
def test_shared_code_names_no_family(path):
    text = (ROOT / "h100bench" / path).read_text()
    for word in ("ResidualUNet3D", "TwoConvNet", "feature_maps", "unet.forward",
                 "reference import unet"):
        assert word not in text, (path, word)
