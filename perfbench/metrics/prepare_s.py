"""Seconds of ``NMFSolver.prepare_state`` in set-up (host clock, the device
synchronised before and after): ‖A‖², and for sparse A the blockify and
the sort."""


def read(rec):
    return rec["prepare_s"]
