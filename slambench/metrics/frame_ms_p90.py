"""frame_ms_p90 (ms, lower, host_clock): the 90th percentile of the time
of every entry call in the window, the loop closed (the next frame is
handed in when the call returns and the card has finished)."""

from slambench.lib.harness import p90


def read(run):
    return p90(run.window.call_s) * 1e3 if len(run.window.call_s) >= 2 \
        else None
