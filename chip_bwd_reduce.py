#!/usr/bin/env python3
"""K1's backward reduce, or its moments, of several checkouts, measured in
turns on one NVIDIA card.

    python3 chip_bwd_reduce.py [--variants] TREE [TREE ...]
    python3 chip_bwd_reduce.py --moments TREE [TREE ...]

Runs one child process per TREE, in the order given (for a parent and a
change: ``_archive/parent . . _archive/parent``), each importing
``tpu_mednet_torch`` from its TREE and building that tree's kernels.  Each
child times ``gn_bwd_reduce_kernel`` alone (``torch.profiler`` device time
a launch, ``chip_smoke.kernel_ms``), one launch of ``_bwd_reduce_cuda`` a
call, at the shapes the main path gives it:

- ``step``: the five level shapes of the full-width ResidualUNet3D's bf16
  training step at batch 32 (ELU; with and without the residual), summed
  over its 27 GroupNorms as ``chip_smoke.check_gn_backward`` sums them;
- ``ldmk``: the same at f_maps 64, batch 4 (the landmark model);
- ``u3``: the gcr UNet3D's 11 GroupNorm shapes at batch 8 (no activation,
  no residual; C = 1 at 96^3 among them), summed over its 14;
- ``slab``: the fold-off route (A and B alone) at seg_organ's five level
  shapes at two space ranks, bf16 and fp32.

Every call is held against ``backward_terms_plain`` (or
``backward_sums_plain`` with the fold off) within 1e-4 x max |ref| before
it is timed.  With ``--variants`` a tree that has ``plan_bwd_reduce`` also
times each shape on the walk, and on the ring where it takes the shape,
and times the reduce's floor (``floor``) beside K1's forward kernels.
Every plan is timed in ``ROUNDS`` rounds over the plans of a shape, and
the least time kept (the first launches after the plain version's large
temporaries read up to 18 % slow on an H100).  Each child prints one JSON line (times,
bounds by the bytes each call must read, and, where the tree's build ran
in the child, the compiler's registers per instance); then a table.  Exits
non-zero without a result when CUDA is unavailable.

With ``--moments`` each child times ``gn_moments_kernel`` instead, one
launch a call, at the shapes the main path gives it:

- ``fwd``: the five level shapes of the full-width ResidualUNet3D's bf16
  forward at batch 8, summed over its 27 GroupNorms;
- ``ldmk``: the same at f_maps 64, batch 4 (the landmark model);
- ``u3``: the gcr UNet3D's 11 GroupNorm shapes at batch 8 (C = 1 at 96^3
  among them), summed over its 14;
- ``extra_bf16``, ``extra_fp32``: configs/seg_tiny.yaml's 8 channels in 8
  groups (batch 1 of 64^3);
- ``c1_fp32``: the gcr input's C = 1 in fp32 (batch 8 of 96^3);
- ``slab_bf16``, ``slab_fp32``: the fold-off route (the per-(n, c) sums)
  at seg_organ's five level shapes at two space ranks.

Every call is held against ``group_norm_moments_plain`` at rtol 1e-5 (the
sums with the fold off within 1e-4 x max |ref|) and must be bitwise equal
to a second call before it is timed; each shape is timed in ``ROUNDS``
rounds and the least time kept; bounds by the bytes each call must move.
Either way the last table sets each tree's least time a shape against the
first tree's, flagging any more than 3 % slower.
"""

from __future__ import annotations

import functools
import json
import re
import subprocess
import sys
from pathlib import Path

# (name, dtype, batch, levels of (channels, extent or (D, H, W), GroupNorms
# a step), act, fold, residual shares): a third of a step's GroupNorms add
# the residual on the residual models, none on the gcr UNet3D
STEP = [(32 * 2**i, 96 // 2**i, 6 if i < 4 else 3) for i in range(5)]
LDMK = [(64 * 2**i, 96 // 2**i, 6 if i < 4 else 3) for i in range(5)]
U3 = [(1, 96, 1), (32, 96, 1), (64, 48, 2), (128, 24, 2), (256, 12, 2), (768, 24, 1),
      (256, 24, 1), (384, 48, 1), (128, 48, 1), (192, 96, 1), (64, 96, 1)]
SLAB = [(32 * 2**i, (64 >> i, 128 >> i, 128 >> i), 1) for i in range(5)]
SETS = (("step", "bf16", 32, STEP, "e", True, True),
        ("ldmk", "bf16", 4, LDMK, "e", True, True),
        ("u3", "bf16", 8, U3, None, True, False),
        ("slab_bf16", "bf16", 4, SLAB, "e", False, False),
        ("slab_fp32", "fp32", 4, SLAB, "e", False, False))
# the same with --moments: (name, dtype, batch, levels, fold), the first
# two sets at the forward's batch
MOMENT_SETS = (("fwd", "bf16", 8, STEP, True),
               ("ldmk", "bf16", 4, LDMK, True),
               ("u3", "bf16", 8, U3, True),
               ("extra_bf16", "bf16", 1, [(8, 64, 1)], True),
               ("extra_fp32", "fp32", 1, [(8, 64, 1)], True),
               ("c1_fp32", "fp32", 8, [(1, 96, 1)], True),
               ("slab_bf16", "bf16", 4, SLAB, False),
               ("slab_fp32", "fp32", 4, SLAB, False))
GROUPS = 8
VARIANTS = (("walk", dict(ring=False)), ("ring", dict(ring=True)))
ROUNDS = 2


def registers(log: str) -> dict:
    """ptxas's registers per gn_bwd_reduce_kernel instance in a build log."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if "gn_bwd_reduce_kernel" in m.group(1) else None
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry] = int(m.group(1))
            entry = None
    return out


def tree_groupnorm(tree: Path):
    """TREE's ``ops._build`` and ``ops.groupnorm``, its kernels built."""
    sys.path.insert(0, str(tree))
    import tpu_mednet_torch

    if Path(tpu_mednet_torch.__file__).resolve().parent.parent != tree:
        raise RuntimeError(f"imported {tpu_mednet_torch.__file__}, not {tree}'s")
    from tpu_mednet_torch.ops import _build
    from tpu_mednet_torch.ops import groupnorm as gn

    _build.build()
    return _build, gn


def child(tree: Path, variants: bool) -> dict:
    import torch

    from chip_smoke import HBM_BYTES_PER_S, kernel_ms

    _build, gn = tree_groupnorm(tree)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    planned = hasattr(gn, "plan_bwd_reduce")
    res = dict(tree=str(tree), device=torch.cuda.get_device_name(0), planned=planned,
               registers=registers(_build.BUILD_LOG), sets={})
    for name, dt_name, batch, levels, act, fold, with_res in SETS:
        dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dt_name]
        rows, total = [], {}
        for c, ext, count in levels:
            ext = (ext,) * 3 if isinstance(ext, int) else ext
            shape = (batch, *ext, c)
            act_t = lambda: torch.randn(shape, generator=gen, device=dev).to(dtype).permute(
                0, 4, 1, 2, 3)
            x, dy = act_t() + 0.5, act_t()
            w = torch.rand(c, generator=gen, device=dev) + 0.5
            b = torch.rand(c, generator=gen, device=dev) - 0.5
            stats = gn.group_norm_moments(x, min(GROUPS, c), w, 1e-5)
            groups = min(GROUPS, c)
            for res_t in ((None, act_t()) if with_res else (None,)):
                inputs = gn._backward_inputs(x, dy, stats.mean, stats.rstd, w, b, res_t)
                if fold:
                    ref = gn.backward_terms_plain(x, dy, stats.mean, stats.rstd, w, b, groups,
                                                  res_t, act)[3]
                else:
                    *_, a_p, b_p = gn.backward_sums_plain(x, dy, stats.mean, stats.rstd, w, b,
                                                          res_t, act)
                    ref = torch.stack((a_p, b_p))
                plans = [("auto", {})] + (list(VARIANTS) if variants and planned else [])
                row = dict(c=c, extent=list(ext), residual=res_t is not None, ms={})
                ops = 2 if res_t is None else 3
                row["bound_ms"] = 1e3 * (ops * x.numel() * x.element_size()
                                         + 6 * batch * c * 4) / HBM_BYTES_PER_S
                calls = {}
                for tag, kw in plans:
                    extra = {}
                    if planned:
                        try:
                            plan = gn.reduce_plan(x, dy, res_t, act, **kw)
                        except ValueError:
                            continue
                        extra = dict(plan=plan)
                        row.setdefault("plans", {})[tag] = plan._asdict()
                        row.setdefault("info", {})[tag] = gn.reduce_info(x, groups, plan,
                                                                         res_t is not None)
                    call = functools.partial(gn._bwd_reduce_cuda, x, dy, inputs, groups, res_t,
                                             act, fold=fold, **extra)
                    got, again = call(), call()
                    err = float((got - ref).abs().max())
                    if err > 1e-4 * float(ref.abs().max()) or not torch.equal(got, again):
                        raise AssertionError(f"{name} {tag} C={c} {ext}: max|err| {err} of "
                                             f"{float(ref.abs().max())}, repeat "
                                             f"{torch.equal(got, again)}")
                    if int(gn._BWD_TICKETS[dev].abs().sum()):
                        raise AssertionError(f"{name} {tag}: tickets left non-zero")
                    calls[tag] = call
                for _ in range(ROUNDS):
                    for tag, call in calls.items():
                        ms = kernel_ms(torch, call, "gn_bwd_reduce", reps=10)[0]
                        row["ms"][tag] = min(ms, row["ms"].get(tag, ms))
                share = (count // 3 if row["residual"] else count - count // 3) if with_res \
                    else count
                row["count"] = share
                for tag, ms in row["ms"].items():
                    total[tag] = total.get(tag, 0.0) + share * ms
                total["bound"] = total.get("bound", 0.0) + share * row["bound_ms"]
                rows.append(row)
            del x, dy, stats
            torch.cuda.empty_cache()
        res["sets"][name] = dict(rows=rows, total=total)
    if variants and planned:
        res["floor"] = floor(torch, gn, dev, gen, kernel_ms)
    return res


def moments_child(tree: Path) -> dict:
    import torch

    from chip_smoke import HBM_BYTES_PER_S, kernel_ms

    _, gn = tree_groupnorm(tree)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res = dict(tree=str(tree), device=torch.cuda.get_device_name(0), sets={})
    for name, dt_name, batch, levels, fold in MOMENT_SETS:
        dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dt_name]
        rows, total = [], {"ms": 0.0, "bound": 0.0}
        for c, ext, count in levels:
            ext = (ext,) * 3 if isinstance(ext, int) else ext
            groups = min(GROUPS, c)
            x = (torch.randn((batch, *ext, c), generator=gen, device=dev) + 0.5).to(
                dtype).permute(0, 4, 1, 2, 3)
            w = torch.rand(c, generator=gen, device=dev) + 0.5
            if fold:
                call = lambda: gn.group_norm_moments(x, groups, w, 1e-5)
                got, again = call(), call()
                for u, v in zip(got, gn.group_norm_moments_plain(x, groups, w, 1e-5)):
                    torch.testing.assert_close(u, v, rtol=1e-5, atol=0)
            else:
                call = lambda: gn.group_norm_sums(x)
                got, again = (call(),), (call(),)
                ref = torch.stack(gn.group_norm_stats_plain(x))
                if float((got[0] - ref).abs().max()) > 1e-4 * float(ref.abs().max()):
                    raise AssertionError(f"{name} C={c} {ext}: sums off the plain version")
            if not all(torch.equal(u, v) for u, v in zip(got, again)):
                raise AssertionError(f"{name} C={c} {ext}: two calls differ")
            plan = gn.plan_moments(batch, x.numel() // (batch * c), c, x.element_size(),
                                   x.data_ptr() % 16 == 0, sms)
            # a tree from before the packed route plans ``bulk`` or not
            route = getattr(plan, "route", None) or ("bulk" if plan.bulk else "register")
            ms = min(kernel_ms(torch, call, "gn_moments", reps=20)[0] for _ in range(ROUNDS))
            bound = 1e3 * (x.numel() * x.element_size() + 3 * batch * c * 4 + c * 4) \
                / HBM_BYTES_PER_S
            rows.append(dict(c=c, extent=list(ext), route=route, blocks=plan.blocks,
                             ms=ms, bound_ms=bound, count=count))
            total["ms"] += count * ms
            total["bound"] += count * bound
            del x, got, again
            torch.cuda.empty_cache()
        res["sets"][name] = dict(dtype=dt_name, batch=batch, rows=rows, total=total)
    return res


# (batch, extent, channels): one block's worth of rows, the batch-32 step's
# level 4, the f_maps-64 level 4
FLOOR_SHAPES = ((1, 2, 32), (32, 6, 512), (4, 6, 1024))


def floor(torch, gn, dev, gen, kernel_ms) -> list:
    """Device ms a call at tiny and level-4 bf16 shapes: the reduce folded,
    unfolded and with one block a sample and chunk, beside K1's forward
    kernels at the same shape (what a launch of each costs where the bytes
    do not)."""
    out = []
    for batch, e, c in FLOOR_SHAPES:
        shape = (batch, e, e, e, c)
        act_t = lambda: torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16).permute(0, 4, 1, 2, 3)
        x, dy = act_t() + 0.5, act_t()
        w = torch.rand(c, generator=gen, device=dev) + 0.5
        b = torch.rand(c, generator=gen, device=dev) - 0.5
        stats = gn.group_norm_moments(x, GROUPS, w, 1e-5)
        inputs = gn._backward_inputs(x, dy, stats.mean, stats.rstd, w, b, None)
        plan = gn.reduce_plan(x, dy)
        one = plan._replace(rows_per_block=plan.rows, blocks=1)
        calls = dict(
            reduce=lambda: gn._bwd_reduce_cuda(x, dy, inputs, GROUPS, None, "e"),
            reduce_unfolded=lambda: gn._bwd_reduce_cuda(x, dy, inputs, GROUPS, None, "e",
                                                        fold=False),
            reduce_one_block=lambda: gn._bwd_reduce_cuda(x, dy, inputs, GROUPS, None, "e",
                                                         plan=one),
            moments=lambda: gn.group_norm_moments(x, GROUPS, w, 1e-5),
            apply=lambda: gn.group_norm_apply(x, stats.mean, stats.mul, b, None, "e"))
        row = dict(shape=list(x.shape), plan=plan._asdict(), ms={})
        for tag, fn in calls.items():
            fn()
            name = {"moments": "gn_moments", "apply": "gn_apply"}.get(tag, "gn_bwd_reduce")
            row["ms"][tag] = min(kernel_ms(torch, fn, name, reps=20)[0] for _ in range(2))
        out.append(row)
        del x, dy, stats, inputs
    return out


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them, printed."""
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    return smi


def run_trees(script: Path, trees: list, args: list, stem: str, smi: str):
    """One child process per TREE, in turns (``script --child TREE *args``,
    whose last line is one JSON result): the results, each with the card
    and written to ``chiprun_out/<stem>_<i>.json``; or the exit code of the
    first child that failed."""
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    results = []
    for i, tree in enumerate(trees):
        proc = subprocess.run([sys.executable, str(script), "--child", str(tree), *args],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        results[-1]["card"] = smi
        (out_dir / f"{stem}_{i}.json").write_text(json.dumps(results[-1], indent=1))
    return results


def against_first(results: list, ms, label) -> None:
    """Each tree's least time a shape over its runs (``ms(row)``) against
    the first tree's, flagging any more than 3 % slower, and the sums a
    pass; ``label(first_row, row)`` names the shape's other columns."""
    best, rows = {}, {}
    for r in results:
        for name, st in r["sets"].items():
            for i, row in enumerate(st["rows"]):
                key = (r["tree"], name, i)
                best[key] = min(ms(row), best.get(key, float("inf")))
                rows.setdefault(key, row)
    first = results[0]["tree"]
    for tree in dict.fromkeys(r["tree"] for r in results):
        if tree == first:
            continue
        print(f"{tree} against {first}, least of each tree's runs (ms):")
        for name, st in results[0]["sets"].items():
            for i, row in enumerate(st["rows"]):
                a, b = best[(first, name, i)], best[(tree, name, i)]
                print(f"    {name:<10} C={row['c']:<5} {str(row['extent']):<15} "
                      f"{label(row, rows[(tree, name, i)])} {a:.4f} -> {b:.4f} ({b / a:.3f})"
                      + ("  SLOWER by more than 3 %" if b > 1.03 * a else ""))
            tot = lambda t: sum(best[(t, name, i)] * row["count"]
                                for i, row in enumerate(st["rows"]))
            print(f"    {name:<10} per step/pass {tot(first):.4f} -> {tot(tree):.4f}")


def print_moments(results: list) -> None:
    for r in results:
        for name, st in r["sets"].items():
            print(f"{r['tree'][-24:]:<24} {name:<10} per pass {st['total']['ms']:.4f} ms "
                  f"(bound {st['total']['bound']:.4f})")
            for row in st["rows"]:
                print(f"    C={row['c']:<5} {str(row['extent']):<15} {row['route']:<8} "
                      f"blocks {row['blocks']:<4} {row['ms']:.4f} (bound {row['bound_ms']:.4f}, "
                      f"{row['bound_ms'] / row['ms']:.0%})")
    against_first(results, lambda row: row["ms"],
                  lambda row, other: f"{row['route']} -> {other['route']}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_bwd_reduce: CUDA is not available; this run needs an NVIDIA card",
              file=sys.stderr)
        return 2
    if len(sys.argv) > 3 and sys.argv[1] == "--child":
        tree = Path(sys.argv[2]).resolve()
        res = moments_child(tree) if sys.argv[3] == "moments" else child(tree,
                                                                         sys.argv[3] == "1")
        print(json.dumps(res), flush=True)
        return 0
    args = sys.argv[1:]
    variants, moments = "--variants" in args, "--moments" in args
    trees = [Path(t).resolve() for t in args if t not in ("--variants", "--moments")]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    mode = "moments" if moments else str(int(variants))
    results = run_trees(Path(__file__).resolve(), trees, [mode],
                        "moments" if moments else "bwd_reduce", card())
    if isinstance(results, int):
        return results
    if moments:
        print_moments(results)
        return 0
    for r in results:
        print(f"tree {r['tree']}: registers {r['registers']}", flush=True)
        for name, st in r["sets"].items():
            print(f"{r['tree'][-24:]:<24} {name:<10} per step/pass: " + ", ".join(
                f"{k} {v:.4f}" for k, v in st["total"].items()))
            for row in st["rows"]:
                info = row.get("info", {}).get("auto", {})
                plan = row.get("plans", {}).get("auto", {})
                print(f"    C={row['c']:<5} {str(row['extent']):<15} res={int(row['residual'])}"
                      f" bound {row['bound_ms']:.4f} " + " ".join(
                          f"{k} {v:.4f}" for k, v in row["ms"].items())
                      + (f"  [{plan.get('route')} blocks {plan.get('blocks')} chunks "
                         f"{plan.get('chunks')} stage {plan.get('stage_rows')} regs "
                         f"{info.get('registers')} per SM {info.get('blocks_per_sm')}]"
                         if plan else ""))
    against_first(results, lambda row: row["ms"]["auto"],
                  lambda row, _: f"res={int(row['residual'])}")
    for r in results:
        for row in r.get("floor", []):
            print(f"floor {row['shape']}: " + ", ".join(f"{k} {v:.4f}"
                                                        for k, v in row["ms"].items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
