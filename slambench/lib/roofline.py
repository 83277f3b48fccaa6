"""Peaks of the card and the work of the port's kernels, kept with the
benchmark so that a later change to the program cannot move them.

The peaks are NVIDIA's published H100 SXM figures (dense): HBM bandwidth
and the float32 rate outside the tensor cores; 32-bit integer and
compare/select work is counted against the same rate. The work of K1 is the
arithmetic of ``chip_smoke.lane_work`` for ``sor_inner``.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: the larger of bytes over the
    bandwidth and operations over the float32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def sor_inner_work(shape, inner: int, sweeps: int):
    """(bytes, operations) of one K1 call on an (h, w) level or a (B, h, w)
    stack: the 10 fields read and (du, dv) written, 12 float32 a pixel; a
    pixel and re-weighting ~150 operations (robust weights, the smoothness
    weight, the 2x2 system, the folded terms), a pixel and sweep ~42."""
    lanes = shape[0] if len(shape) == 3 else 1
    px = lanes * shape[-2] * shape[-1]
    return 12 * px * 4, px * inner * (150 + 42 * sweeps)
