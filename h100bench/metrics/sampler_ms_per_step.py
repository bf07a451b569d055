"""Host milliseconds a step spent drawing its batch from the device sampler
(corner draws, K2's launch, the heatmaps' launches), over every step of
the window outside the profiled stretch."""


def read(record):
    if not record.get("sampled_steps"):
        return None
    return 1e3 * record["sampler_s"] / record["sampled_steps"]
