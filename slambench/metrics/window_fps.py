"""window_fps (frames/s, higher, host_clock; layer: entry): frames
completed over the whole window (lane-frames in a lane cell), each call
closed by a synchronise. Per layer, not end to end: its runs spread wider
than the largest bound allows. Moves frame_ms_p90."""


def read(run):
    return run.window.frames / run.window.seconds
