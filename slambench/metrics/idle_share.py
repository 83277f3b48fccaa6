"""idle_share (%, lower, device_trace; layer: device): the share of the
traced stretch's wall time in which no operation ran on the card (1 - the
union of device intervals over the stretch). Moves frame_ms_p90."""

from slambench.lib.trace import busy_s


def read(run):
    rec = run.record
    if rec is None or not any(e.device for e in rec.events):
        return None
    return 100.0 * (1.0 - busy_s(rec) / rec.wall_s)
