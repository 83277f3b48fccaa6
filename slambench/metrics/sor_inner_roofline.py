"""sor_inner_roofline (%, higher, device_trace; layer: kernels): K1's
least time on the card for the calls of the traced stretch (their shapes
from the program's ``SOR_INNER_CUDA_LAUNCHES`` counter, the work from
``lib.roofline.sor_inner_work``) over K1's device time in the trace
(``sor_tile_kernel``). Moves frame_ms_p90."""

from slambench.lib.roofline import bound_s, sor_inner_work
from slambench.lib.trace import device_events


def read(run):
    rec = run.record
    if rec is None or not rec.sor_inner_calls:
        return None
    dev_us = sum(e.end_us - e.start_us for e in device_events(rec)
                 if "sor_tile_kernel" in e.name)
    if dev_us <= 0:
        return None
    flow = rec.cfg.flow
    least = sum(n * bound_s(*sor_inner_work(shape, flow.inner_iterations,
                                            flow.solver_iterations))
                for shape, n in rec.sor_inner_calls.items())
    return 100.0 * least / (dev_us * 1e-6)
