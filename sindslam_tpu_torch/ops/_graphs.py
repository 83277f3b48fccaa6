"""CUDA graphs of the front-end's launch-bound stretches.

A stretch is a function of a few tensors that launches hundreds of small
operations and reads nothing back on the host: the flow's level ranges
(``ops/flow.py::_solve_range``), the geometry branch
(``frontend/pipeline.py::_geometry``) and ORB extraction
(``frontend/orb.py::extract_orb``). ``solve`` runs it as one CUDA graph:
the host then launches the stretch at once instead of operation by
operation. A graph replays the very kernels the eager call launches, so
every value is the same bit for bit.
"""

from __future__ import annotations

import torch

from sindslam_tpu_torch.ops import cuda_kernels as ck

# the memory pool each pool key's graphs share, and the side stream each
# device captures on
_POOLS: dict = {}
_STREAMS: dict = {}


def _tensors(x):
    """Every tensor inside ``x`` (a tensor, or tuples and named tuples of
    them)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, tuple):
        for y in x:
            yield from _tensors(y)


class _Graph:
    """``fn(*inputs)`` as one CUDA graph: static copies of the inputs, the
    captured call and its outputs, and the kernel wrapper calls one replay
    makes.

    ``first`` calls ``fn`` on a side stream from the static copies
    (first-use uploads, cuBLAS's workspace on that stream), and returns
    that call's outputs; its kernel calls count as they launch. Then it
    captures the same call there, which launches nothing and counts
    nothing: each replay adds to ``cuda_kernels``' counters what the
    capture's calls counted, as the same calls made eagerly add it. No host
    synchronisation."""

    def __init__(self, fn, inputs):
        self.fn = fn
        self.inputs = tuple(t.clone() for t in inputs)
        self.graph = torch.cuda.CUDAGraph()

    def first(self, pool, stream: torch.cuda.Stream):
        main = torch.cuda.current_stream()
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            out = self.fn(*self.inputs)
            counts = ck.launch_counts()
            ck.reset_launch_counts()
            try:
                self.graph.capture_begin(pool,
                                         capture_error_mode="thread_local")
                try:
                    self.out = self.fn(*self.inputs)
                finally:
                    self.graph.capture_end()
                self.launches = ck.launch_counts()
            finally:
                ck.reset_launch_counts()
                ck.add_launch_counts(counts)
        main.wait_stream(stream)
        for t in _tensors(out):
            t.record_stream(main)
        return out

    def replay(self, inputs):
        for static, t in zip(self.inputs, inputs):
            static.copy_(t)
        self.graph.replay()
        ck.add_launch_counts(self.launches)
        return self.out


def solve(graphs: dict, key: tuple, pool_key: tuple, fn, inputs):
    """``fn(*inputs)`` of CUDA tensors through the graph ``graphs`` keeps
    for ``key``: the first call with a key calls ``fn`` and captures the
    graph, every later call copies ``inputs`` into the graph's static
    copies and replays it. Both keys are completed with what the capture
    ran under: the device, the float32 product precision and the
    deterministic-algorithms setting. The graphs of one pool key share a
    memory pool. A replay returns the graph's own outputs, which the next
    replay of the key overwrites: the caller copies what leaves it.
    Returns the outputs and whether a replay gave them."""
    dev = inputs[0].device
    ran_under = (dev, torch.get_float32_matmul_precision(),
                 torch.are_deterministic_algorithms_enabled())
    key, pool_key = (*key, *ran_under), (*pool_key, *ran_under)
    with torch.cuda.device(dev):
        graph = graphs.get(key)
        if graph is not None:
            return graph.replay(inputs), True
        if pool_key not in _POOLS:
            _POOLS[pool_key] = torch.cuda.graph_pool_handle()
        if dev not in _STREAMS:
            _STREAMS[dev] = torch.cuda.Stream(dev)
        graph = graphs[key] = _Graph(fn, inputs)
        return graph.first(_POOLS[pool_key], _STREAMS[dev]), False


def replayable(dev: torch.device) -> bool:
    """Whether a call on ``dev`` may go through ``solve``: on CUDA, outside
    another capture (on the CPU, and inside a capture, the eager call)."""
    return dev.type == "cuda" and not torch.cuda.is_current_stream_capturing()
