"""flow_host_ms (ms/step, lower, program_span; layer: stages): host time
of the program's ``frontend/flow`` range a step in the traced stretch.
Moves frame_ms_p90."""

from slambench.lib.trace import host_range_s


def read(run):
    rec = run.record
    s = None if rec is None else host_range_s(rec, "frontend/flow")
    return None if s is None else s * 1e3 / rec.steps
