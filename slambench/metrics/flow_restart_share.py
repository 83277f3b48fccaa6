"""flow_restart_share (%, lower, program_counter; layer: stages): the share
of the run's front-end steps, warm-up and window, whose flow restarted its
pyramid against the other target. A descriptor of the traffic more than of
the program: it counts the regime decisions, which no change that keeps
the results can move. The restarts are the program's host counter
``flow_restarts`` in ``sindslam_tpu_torch.utils.profiling``, which counts
over the process, so the reading assumes one run a process, as
``slambench/run.py`` makes; the steps are the harness's own count, the
warm-up calls and the window's, times the steps a call (the traced
stretch's steps over its calls). Over the whole run, not the traced
stretch, which is too short to see a restart on one frame in ten. None
where the program has no such counter, the run no traced stretch, or no
step was made. Moves frame_ms_p90."""

from sindslam_tpu_torch.utils import profiling


def read(run):
    restarts = getattr(profiling, "flow_restarts", None)
    rec = run.record
    if restarts is None or rec is None:
        return None
    per_call = rec.steps // int(run.cell["trace"]["calls"])
    steps = (int(run.cell["warmup_calls"]) + len(run.window.call_s)) \
        * per_call
    return 100.0 * restarts / steps if steps else None
