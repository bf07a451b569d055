"""Device milliseconds a step of every operation that is neither a conv
kernel nor K1 nor K2 (the augmentation, the loss, Adam, layout copies,
pooling, the gradients' adds), over the profiled stretch."""


def read(record):
    s = record.get("stretch")
    if s is None or "steps" not in s:
        return None
    return 1e3 * s["groups"].get("other", 0.0) / s["steps"]
