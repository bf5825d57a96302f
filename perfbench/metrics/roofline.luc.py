"""The luc phases' counted least time (``counts.py``) over their
measured time, %; nothing where the work is not counted."""


def read(rec):
    least = rec.get("least_ms", {}).get("luc")
    phases = rec.get("phase_ms", {})
    keys = ("luc_w", "luc_h")
    if least is None or not all(k in phases for k in keys):
        return None
    return 100.0 * least / sum(phases[k] for k in keys)
