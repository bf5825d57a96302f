"""ms an iteration: the whole window's time over every iteration completed
in it, restarts and read-backs included (host clock)."""


def read(rec):
    return 1e3 * rec["window_s"] / rec["iters"]
