"""The benchmark's yardstick on the CPU: its counts, its reference, its imports.

Run: ``python -m pytest h100bench/tests -q`` from the repository root.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from h100bench import counting, data, harness  # noqa: E402
from h100bench.reference import train as ref_train  # noqa: E402
from h100bench.reference import unet  # noqa: E402
from h100bench.reference.precision import fp8_round  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text()) for c in BENCH["configs"]}
TRAFFIC = {w["name"]: json.loads((ROOT / "h100bench" / "traffic" / f"{w['traffic']}.json")
                                 .read_text()) for w in BENCH["workloads"]}
CELLS = [(w["name"], w["config"]) for w in BENCH["workloads"]]
FAMILY = {name: harness.family_of(cfg, name) for name, cfg in CONFIGS.items()}


def tiny_cfg(name: str, **kw) -> dict:
    return dict(CONFIGS[name], f_maps=4, num_levels=3, **kw)


@pytest.mark.parametrize("workload,config", CELLS)
def test_flops_equal_the_program_count(workload, config):
    from tpu_mednet_torch.utils import flops

    cfg, t, fam = CONFIGS[config], TRAFFIC[workload], FAMILY[config]
    fm = unet.feature_maps(cfg)
    patch = tuple(t["patch"])
    want = flops.unet_forward_flops(cfg["in_channels"], cfg["out_channels"], fm, patch)
    assert fam.forward_flops(cfg, patch) == want
    assert fam.conv_flops(cfg, patch) == want
    batch = t["batch"]
    assert counting.train_step_flops(fam.forward_flops(cfg, patch), batch) == \
        flops.unet_train_step_flops(cfg["in_channels"], cfg["out_channels"], fm, patch, batch)


def test_the_published_sizes():
    assert unet.param_count(CONFIGS["resunet3d_landmarks_f64"]) == 141_246_661
    for name, cfg in CONFIGS.items():
        assert cfg["parameters"] == unet.param_count(cfg), name
    # the organ step's 3 x forward of 32 samples (PR 9's 512.44 GFLOP a 96^3 sample)
    organ = "resunet3d_organ_f32"
    assert abs(FAMILY[organ].forward_flops(CONFIGS[organ], (96,) * 3) / 1e9 - 512.44) < 0.01


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_k1_bytes_are_the_layers_own(name):
    """Every GroupNorm of the program's model, hooked in a forward: its
    input, residual and output sizes give the bytes ``counting`` counts."""
    from tpu_mednet_torch.models.blocks import GroupNorm

    cfg, fam = dict(CONFIGS[name], f_maps=8, num_levels=3), FAMILY[name]
    patch, batch = (16, 16, 16), 2
    task = fam.port_task(dict(cfg, dtype="float32"),
                         data.weights(fam, cfg, 1, torch.device("cpu")), "cpu")
    seen = []

    def hook(mod, args, kwargs, out):
        x = args[0]
        res = kwargs.get("residual")
        seen.append((x.shape[1], x[0, 0].numel(), res is not None,
                     x.numel() + (res.numel() if res is not None else 0) + out.numel()))
    for m in task.model.modules():
        if isinstance(m, GroupNorm):
            m.register_forward_hook(hook, with_kwargs=True)
    with torch.no_grad():
        task.model(torch.zeros(batch, 1, *patch))
    norms = fam.norm_layers(cfg, patch)
    assert sorted(s[:3] for s in seen) == sorted(norms)
    elems = sum(s[3] for s in seen)
    assert counting.k1_forward_bytes(dict(cfg, dtype="float32"), norms, batch) == 4 * elems
    assert counting.k1_forward_bytes(cfg, norms, batch) == 2 * elems
    # backward: x and dy (and the residual) in, dx (and its gradient) out
    back = sum(x[0] * x[1] * batch * (5 if x[2] else 3) for x in seen)
    assert counting.k1_backward_bytes(cfg, norms, batch) == 2 * back


def test_k2_bytes():
    cfg = CONFIGS["resunet3d_organ_f32"]
    assert counting.k2_bytes(cfg, (96, 96, 96), 8) == 8 * 96 ** 3 * (2 + 2)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_forward_equals_the_program(name):
    cfg, fam = tiny_cfg(name, dtype="float32"), FAMILY[name]
    params = data.weights(fam, cfg, 5, torch.device("cpu"))
    task = fam.port_task(cfg, params, "cpu")
    x = torch.randn(2, 1, 16, 16, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = task.model(x)
        want = unet.forward(cfg, params, x)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_loss_equals_the_program(name):
    cfg, fam = tiny_cfg(name, dtype="float32"), FAMILY[name]
    task = fam.port_task(cfg, data.weights(fam, cfg, 5, torch.device("cpu")), "cpu")
    g = torch.Generator().manual_seed(1)
    logits = torch.randn(4, cfg["out_channels"], 8, 8, 8, generator=g)
    n_hm = len(cfg.get("loss_regression_weight") or [])
    classes = torch.randint(0, cfg["out_channels"] - n_hm, (4, 1, 8, 8, 8), generator=g)
    label = torch.cat([torch.randint(0, 255, (4, n_hm, 8, 8, 8), generator=g), classes], 1)
    label = label.to(torch.uint8)
    got, _ = task.loss_fn(logits, {"label": label})
    loss = ref_train.Loss(cfg)
    assert torch.allclose(got, loss.value(loss.terms(logits, label)), rtol=1e-5)
    # the linearised blocks give the whole batch's gradient
    a = logits.clone().requires_grad_()
    loss.value(loss.terms(a, label)).backward()
    b = logits.clone().requires_grad_()
    total = loss.terms(b.detach(), label)
    for s in (slice(0, 2), slice(2, 4)):
        t = loss.terms(b[s], label[s])
        t.pop("count", None)
        loss.linearised(t, total).backward()
    assert torch.allclose(a.grad, b.grad, rtol=1e-4, atol=1e-9)


def tiny_cell(workload: str, fault=None, seed=12345678901, bench=BENCH,
              families=harness.FAMILIES, **cfg_kw):
    cell = harness.load_cell(workload, seed, 1.0, False, "cpu", bench=bench, families=families)
    cell.cfg = dict(cell.cfg, f_maps=4, num_levels=3, **cfg_kw)
    t = dict(cell.traffic)
    if t["loop"] == "train":
        t.update(batch=4, patch=[16, 16, 16], samples_per_subject=4, reference_rows=2,
                 warmup_steps=1,
                 subjects=[[24, 24, 20], [20, 24, 24], [24, 20, 24], [20, 20, 24]])
    else:
        t.update(patch=[24, 24, 24], overlap=[4, 4, 4], batch=2, warmup_requests=1,
                 pool=[[24, 24, 24], [32, 24, 40], [40, 40, 40]], judged=2, reference_rows=2)
    cell.traffic = t
    cell.fault = fault
    return cell


@pytest.mark.parametrize("workload", [w for w, _ in CELLS])
def test_a_sound_run_is_correct(workload):
    """The whole run at a tiny size on the CPU, the program in the configured
    bf16 against the fp32 reference."""
    out = harness.execute(tiny_cell(workload))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("workload", [w for w, _ in CELLS])
def test_the_program_in_fp32_agrees_closely(workload):
    out = harness.execute(tiny_cell(workload, dtype="float32"))
    for name, c in out["checks"].items():
        assert c["value"] < c["limit"] / 10, (name, c)


FAULTS = [(w, f) for w, _ in CELLS
          for f in (("altered",) if TRAFFIC[w]["loop"] == "serve" else ("unchanged", "half_batch", "convs_unmoved"))]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(workload, fault):
    """Each fault the cell can have, planted under the timed path: a step
    that leaves the state unchanged, half the batch left out of the loss,
    every convolution's weight left unmoved by the update, a served mask
    altered where it is produced."""
    out = harness.execute(tiny_cell(workload, fault=fault))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", [w for w, _ in CELLS])
def test_the_precision_control_is_not_correct(workload):
    """The reference with every conv operand rounded through float8 e4m3
    (the precision below the configured bf16), in the program's place,
    fails one of the cell's limits (as ``control.py`` reads it on the card
    at the cell's own size)."""
    from h100bench.loops import train
    from h100bench.reference import serve as ref_serve

    cell = tiny_cell(workload)
    t, cfg, dev = cell.traffic, cell.cfg, cell.device
    if t["loop"] == "train":
        n_classes = cfg["out_channels"] - len(cfg.get("loss_regression_weight") or [])
        store = data.training_subjects(t, n_classes, cell.seed, dev)
        ref = train.reference_readings(cell, store)
        low = train.reference_readings(cell, store, quant=fp8_round)
        checks = ref_train.compare(low, ref)
    else:
        pool = data.serving_pool(t, cell.seed, dev)
        params = data.weights(cell.family, cfg, cell.seed, dev)
        checks = {"logit_gap": max(ref_serve.control_gap(cell.family, cfg, params, v, t["patch"],
                                                         t["overlap"], 2, dev, fp8_round)
                                   for v in pool.values())}
    judged = harness.judge(checks, cell.limits)
    assert any(c["value"] > c["limit"] for c in judged.values()), judged


def test_unmoved_convs_pass_the_median_leaf_and_fail_the_worst():
    """The fault the worst leaf's change is compared for: the median leaf is
    a GroupNorm leaf, which still moves."""
    out = harness.execute(tiny_cell("organ_train_p128", fault="convs_unmoved"))
    checks = out["checks"]
    assert checks["change_gap"]["value"] < checks["change_gap"]["limit"], checks
    assert checks["change_gap_worst"]["value"] > 0.99, checks


@pytest.mark.parametrize("key,value", [("model", "UNet3D"), ("join", "concat"),
                                       ("layer_order", "gcr"), ("optimizer", "sgd"),
                                       ("task", "multitask"), ("loss", "CE")])
def test_a_configuration_the_harness_lacks_is_refused(key, value):
    cfg = dict(CONFIGS["resunet3d_organ_f32"], **{key: value})
    with pytest.raises(SystemExit, match=key):
        harness.family_of(cfg, "configs/x.json")
    harness.family_of(CONFIGS["resunet3d_organ_f32"], "configs/x.json")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    files = [p for p in (ROOT / "h100bench").rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        for mod in _imports(p):
            assert mod.split(".")[0] not in harness.FORBIDDEN, (p, mod)
    for p in (ROOT / "h100bench" / "reference").rglob("*.py"):
        for mod in _imports(p):
            assert mod.split(".")[0] not in ("tpu_mednet_torch", "tpu_mednet", "jax"), (p, mod)


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from h100bench.tests.test_h100bench_yardstick import tiny_cell\n"
            "from h100bench import harness\n"
            "harness.execute(tiny_cell('organ_serve_128'))\n"
            "print(harness.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload", "organ_train_p128",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(ROOT)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w for w, _ in CELLS])
def test_each_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload", workload,
                          "--seed", "3", "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
