"""The device memory's peak over set-up and window, GB
(``torch.cuda.max_memory_allocated``)."""


def read(rec):
    return rec["peak_bytes"] / 1e9 if rec["peak_bytes"] else None
