"""The whole iteration's counted least time (``counts.py``; BPP's pivoting
not counted, so there a lower bound) over the traced run's unprofiled ms
an iteration, %: the iteration's share of the chip's roofline."""


def read(rec):
    least = rec.get("least_ms", {}).get("iteration")
    if least is None or "unprofiled_iter_ms" not in rec:
        return None
    return 100.0 * least / rec["unprofiled_iter_ms"]
