"""unspanned_host_ms (ms/step, lower, program_span; layer: entry): the
host time of the harness's ``slambench/call`` ranges that no range of the
program covers (every other host range of the record), summed over the
traced stretch, a step: what the program's spans leave unnamed. Moves
frame_ms_p90."""

from slambench.lib.trace import union_s


def read(run):
    rec = run.record
    if rec is None:
        return None
    host = [e for e in rec.events if not e.device]
    calls = [e for e in host if e.name == "slambench/call"]
    if not calls:
        return None
    spans = [e for e in host if e.name != "slambench/call"]
    left = 0.0
    for c in calls:
        inside = [(max(s.start_us, c.start_us), min(s.end_us, c.end_us))
                  for s in spans
                  if s.start_us < c.end_us and s.end_us > c.start_us]
        left += (c.end_us - c.start_us) - union_s(inside)
    return left * 1e-3 / rec.steps
