"""flow_graph_share (%, higher, program_counter; layer: stages): the share
of the level ranges the flow's fallback solved over the run, warm-up and
window, that a replay of a CUDA graph served. The program's host counters
``flow_graph_replays`` over ``flow_range_solves`` in
``sindslam_tpu_torch.utils.profiling``, which count over the process, so
the reading assumes one run a process, as ``slambench/run.py`` makes. Over
the whole run, as ``flow_restart_share``; a graph's first range is
solved eagerly while it is captured, so the captures keep it under 100 %.
Where graphs engage at all it reads near 100 %, where they do not 0: it
tells whether the mechanism is on. None where the program has no
such counters, the run no traced stretch, or no range was solved. Moves
frame_ms_p90."""

from sindslam_tpu_torch.utils import profiling


def read(run):
    replays = getattr(profiling, "flow_graph_replays", None)
    solves = getattr(profiling, "flow_range_solves", None)
    if replays is None or solves is None or run.record is None or not solves:
        return None
    return 100.0 * replays / solves
