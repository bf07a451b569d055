"""The window attention's least time over the profiled stretch, the larger
of its logical FLOPs at 989 TFLOP/s bf16 and its least bytes at 3.35 TB/s
(the family's ``group_work``: ``attn``; its ``step_bytes``, read once a
step, come scaled by the samples and are divided back by the batch), over
the device time of the fused attention kernels (the family's ``attn``
group), in percent.  Nothing where the configuration's family has no such
group."""

from h100bench.counting import PEAK_BF16_FLOPS, PEAK_HBM_BYTES


def read(record):
    s = record.get("stretch")
    if s is None or not s["groups"].get("attn") or "attn" not in s.get("work", {}):
        return None
    w = s["work"]["attn"]
    batch = record["patches"] / record["attempted"]
    least = max(w["flops"] / PEAK_BF16_FLOPS,
                (w["bytes"] + w.get("step_bytes", 0.0) / batch) / PEAK_HBM_BYTES)
    return 100.0 * least / s["groups"]["attn"]
