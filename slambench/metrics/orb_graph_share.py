"""orb_graph_share (%, higher, program_counter; layer: stages): the share
of the program's ORB extractions (``frontend/orb.py::extract_orb``: the
atlas and K3, the IC-angle fields, the per-level selection and K4) over
the run, warm-up and window, that a replay of a CUDA graph served. The
program's host counters ``orb_graph_replays`` over ``orb_solves`` in
``sindslam_tpu_torch.utils.profiling``, which count over the process, so
the reading assumes one run a process, as ``slambench/run.py`` makes. Over
the whole run, as ``geometry_graph_share``; a graph's first run is eager
while it is captured, so the capture keeps it under 100 %. Where the graph
engages it reads near 100 %, where it does not 0: it tells whether the
mechanism is on. None where the program has no such counters, the run no
traced stretch, or ORB never ran. Moves frame_ms_p90."""

from sindslam_tpu_torch.utils import profiling


def read(run):
    replays = getattr(profiling, "orb_graph_replays", None)
    solves = getattr(profiling, "orb_solves", None)
    if replays is None or solves is None or run.record is None or not solves:
        return None
    return 100.0 * replays / solves
