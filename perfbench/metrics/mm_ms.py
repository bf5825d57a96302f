"""ms an iteration in the mm phases (mm_w + mm_h) of
``obs.phases.run_profiled``, each phase between two device
synchronisations."""


def read(rec):
    phases = rec.get("phase_ms", {})
    keys = ("mm_w", "mm_h")
    if not all(k in phases for k in keys):
        return None
    return sum(phases[k] for k in keys)
