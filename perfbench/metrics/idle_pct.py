"""The share of the traced segment in which no device operation ran, %
(``torch.profiler``: the union of kernel, copy and set intervals over the
segment's length on the host clock); on a grid, the largest of the
ranks'."""


def read(rec):
    trace = rec.get("trace")
    if not trace or any(busy <= 0 for busy, _ in trace["ranks"]):
        return None
    return max(100.0 * (1.0 - busy / span) for busy, span in trace["ranks"])
