"""geometry_host_ms (ms/step, lower, program_span; layer: stages): host
time of the program's ``frontend/geometry`` range (the geometry branch:
k-means, edges, RAG merge) a step in the traced stretch. Where the program
has no such range, the sum of its three stage ranges, ``frontend/kmeans``,
``frontend/edges`` and ``frontend/rag_merge``, which it held before. Moves
frame_ms_p90."""

from slambench.lib.trace import host_range_s

STAGES = ("frontend/kmeans", "frontend/edges", "frontend/rag_merge")


def read(run):
    rec = run.record
    if rec is None:
        return None
    s = host_range_s(rec, "frontend/geometry")
    if s is None:
        parts = [host_range_s(rec, name) for name in STAGES]
        if any(p is None for p in parts):
            return None
        s = sum(parts)
    return s * 1e3 / rec.steps
