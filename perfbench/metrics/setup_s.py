"""Seconds from the process's start to the window: imports, CUDA start,
kernel build or load, the inputs, ``prepare_state`` and a warm-up segment
(host clock)."""


def read(rec):
    return rec["setup_s"]
