"""flow_decide_host_ms (ms/step, lower, program_span; layer: stages): host
time of the program's ``flow/decide`` range a step in the traced stretch:
the magnitude test and the wait at the regime decision's host reads.
Moves frame_ms_p90."""

from slambench.lib.trace import host_range_s


def read(run):
    rec = run.record
    s = None if rec is None else host_range_s(rec, "flow/decide")
    return None if s is None else s * 1e3 / rec.steps
