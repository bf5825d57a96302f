"""The share of the traced segment in which no device operation ran, %
(``torch.profiler``: the union of kernel, copy and set intervals over the
segment's length on the host clock)."""


def read(rec):
    trace = rec.get("trace")
    if not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
