"""launches_per_step (launches/step, lower, device_trace; layer: device):
operations on the card (kernels, copies, sets) in the traced stretch, a
step. Moves frame_ms_p90."""

from slambench.lib.trace import device_events


def read(run):
    rec = run.record
    if rec is None:
        return None
    n = len(device_events(rec))
    return n / rec.steps if n else None
