"""A short profiled stretch of the measured window, reduced to numbers.

``Stretch`` runs ``torch.profiler`` (host and device activity) between two
device synchronisations.  Its reading: the device's busy seconds (the
union of every kernel's and copy's interval), device seconds by layer
group (the family's own groups first, then the shared ones), the share of
K1's counted statistics launches whose records the profiler kept (it
drops records now and then; a reading that kept too few is not used), the
top device operations and the idle gaps named by what the host was doing
in them (the innermost ``h100bench.*`` or program (``tpu_mednet_torch.*``)
span and host operator open at the gap's start).
"""

from __future__ import annotations

import time
from typing import Dict, List, Mapping, Tuple

import torch

MIN_KEPT = 0.9
NAMED_GAPS = 200  # the longest gaps named by host activity; the rest summed
SPAN = "h100bench."
PROGRAM_SPAN = "tpu_mednet_torch."  # the program's spans (its utils/tracing.py)

# conv kernels are matched by these name parts, unless a layout-copy part
# also appears (cuDNN's NCDHW <-> NDHWC transposes are "other")
CONV_PARTS = ("conv", "xmma", "gemm", "cudnn", "cutlass", "fprop", "dgrad", "wgrad",
              "implicit", "sm90_", "sm80_")
COPY_PARTS = ("tonhwc", "tonchw", "transpose", "elementwise", "copy", "nchwto", "nhwcto",
              "reduce", "memcpy", "memset")


def _own_group(low: str, parts: Mapping[str, str]):
    """The group of the first of the family's name ``parts`` in ``low``."""
    return next((g for p, g in parts.items() if p.lower() in low), None)


def group_of(name: str, parts: Mapping[str, str] = {}) -> str:
    """The layer group of a device operation's name: the family's own group
    where one of its name ``parts`` matches, else the shared rule's."""
    low = name.lower()
    own = _own_group(low, parts)
    if own is not None:
        return own
    if "gn_" in low:
        return "k1"
    if "gather_stores" in low:
        return "k2"
    if any(p in low for p in CONV_PARTS) and not any(p in low for p in COPY_PARTS):
        return "conv"
    return "other"


def op_label(name: str, parts: Mapping[str, str] = {}) -> str:
    """A short label of a device operation for the breakdown."""
    low = name.lower()
    own = _own_group(low, parts)
    if own is not None:
        return f"{own} {name[:56]}"
    for part, label in (("gn_bwd_reduce", "K1 gn_bwd_reduce"), ("gn_bwd_apply", "K1 gn_bwd_apply"),
                        ("gn_moments", "K1 gn_moments"), ("gn_apply", "K1 gn_apply"),
                        ("gather_stores", "K2 gather_stores")):
        if part in low:
            return label
    if group_of(name) == "conv":
        for kind in ("wgrad", "dgrad"):
            if kind in low:
                return f"conv {kind}"
        return "conv fprop"
    if low.startswith(("memcpy", "memset")):
        return name.split(" ")[0][:40]
    return name[:60]


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Stretch:
    """``with Stretch(counter, parts) as s: ...`` profiles the block;
    ``s.read()`` reduces it, after the window has closed.  ``counter()``
    returns K1's count of statistics launches so far; ``parts`` are the
    family's kernel name parts and their groups; ``s.host_s`` is the
    block's whole time after the work queued before it, the profiler's
    start and stop included."""

    def __init__(self, counter, parts: Mapping[str, str] = {}):
        self.counter = counter
        self.parts = parts

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()  # the queued work before it is the window's, not the stretch's
        self.entered = time.perf_counter()
        self.launches = self.counter()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.wall = time.perf_counter() - self.t0
        self.launched = self.counter() - self.launches
        self.prof.__exit__(*exc)
        self.host_s = time.perf_counter() - self.entered
        return False

    def read(self) -> dict:
        return dict(reduce_events(self.prof.events(), self.wall, self.launched, self.parts),
                    host_s=self.host_s)


def reduce_events(events, wall: float, k1_launched: int,
                  parts: Mapping[str, str] = {}) -> dict:
    device, host = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not _annotation(e):
                device.append((start, end, e.name))
        elif e.name.startswith((SPAN, PROGRAM_SPAN, "aten::")):
            host.append((start, end, e.name))
    busy_iv = _merge([(a, b) for a, b, _ in device])
    busy = sum(b - a for a, b in busy_iv) / 1e6
    groups: Dict[str, float] = {}
    ops: Dict[str, float] = {}
    seen = 0
    for a, b, name in device:
        s = (b - a) / 1e6
        g = group_of(name, parts)
        groups[g] = groups.get(g, 0.0) + s
        label = op_label(name, parts)
        ops[label] = ops.get(label, 0.0) + s
        seen += "gn_moments" in name
    gaps: Dict[str, float] = {}
    idle = sorted(((nxt - end, end) for (_, end), (nxt, _) in zip(busy_iv, busy_iv[1:])),
                  reverse=True)
    for length, at in idle[:NAMED_GAPS]:
        name = _host_at(host, at)
        gaps[name] = gaps.get(name, 0.0) + length / 1e6
    rest = sum(length for length, _ in idle[NAMED_GAPS:]) / 1e6
    if rest:
        gaps[f"the {len(idle) - NAMED_GAPS} shorter gaps"] = rest
    kept = seen / k1_launched if k1_launched else 1.0
    return {"wall_s": wall, "busy_s": busy, "groups": groups, "kept": kept,
            "device_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10]}


def _annotation(e) -> bool:
    """A host range the profiler mirrors on the device's timeline (a
    ``record_function`` span, the optimizer's step), not device work."""
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith(
        (SPAN, "Optimizer.", "ProfilerStep"))


def _host_at(host, t: float) -> str:
    """The innermost benchmark or program span and host operator open at
    time ``t``."""
    span, op = "", ""
    span_len = op_len = float("inf")
    for a, b, name in host:
        if a <= t <= b:
            if name.startswith((SPAN, PROGRAM_SPAN)) and b - a < span_len:
                span, span_len = name, b - a
            elif name.startswith("aten::") and b - a < op_len:
                op, op_len = name, b - a
    return f"{span or 'outside spans'} / {op or 'no host op'}"
