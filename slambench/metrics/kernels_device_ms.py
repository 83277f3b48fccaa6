"""kernels_device_ms (ms/step, lower, device_trace; layer: kernels):
device time of the port's hand-written kernels K1-K4 (``csrc/*.cu``) a
step in the traced stretch, found by their CUDA function names. Moves
frame_ms_p90."""

from slambench.lib.trace import device_events

KERNEL_FUNCTIONS = ("sor_tile_kernel", "cc_tile_kernel", "fast_nms_kernel",
                    "brief_kernel", "patches_kernel")


def read(run):
    rec = run.record
    if rec is None:
        return None
    spans = [e.end_us - e.start_us for e in device_events(rec)
             if any(k in e.name for k in KERNEL_FUNCTIONS)]
    return sum(spans) * 1e-3 / rec.steps if spans else None
