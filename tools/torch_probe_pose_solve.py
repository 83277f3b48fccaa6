#!/usr/bin/env python3
"""What one 6x6 solve of the pose optimiser costs on the card, by method.

    python3 tools/torch_probe_pose_solve.py

``pose_optimization`` solves ``H dx = b`` (H 6x6, symmetric positive definite
after its ridge) once a Gauss-Newton step, 80 times in a ``full_track_step``.
For each way of solving it in PyTorch this prints, per call: the host
synchronisations and device kernels under ``torch.profiler``, the CUDA-event
time, and the largest difference from ``torch.linalg.solve`` in float64.
The optimiser uses ``solve_ex``; the last method, Gauss-Jordan elimination
in plain tensor operations (no pivoting: H is positive definite), is here as
the candidate with no library call at all. Needs a CUDA device.
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import torch

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def methods():
    def solve(H, b):
        return torch.linalg.solve(H, b)

    def solve_ex(H, b):
        return torch.linalg.solve_ex(H, b)[0]

    def cholesky_ex(H, b):
        L = torch.linalg.cholesky_ex(H)[0]
        return torch.cholesky_solve(b[:, None], L)[:, 0]

    def inv_ex(H, b):
        return torch.linalg.inv_ex(H)[0] @ b

    def lu_ex(H, b):
        LU, piv, _info = torch.linalg.lu_factor_ex(H)
        return torch.linalg.lu_solve(LU, piv, b[:, None])[:, 0]

    def gauss_jordan(H, b):
        A = torch.cat([H, b[:, None]], dim=1)             # (6, 7)
        rows = torch.eye(6, dtype=torch.bool, device=H.device)
        for k in range(6):
            row = A[k] / A[k, k]
            A = torch.where(rows[k][:, None], row[None, :],
                            A - A[:, k:k + 1] * row[None, :])
        return A[:, 6]

    return {"linalg.solve": solve, "linalg.solve_ex": solve_ex,
            "cholesky_ex + cholesky_solve": cholesky_ex,
            "inv_ex @ b": inv_ex, "lu_factor_ex + lu_solve": lu_ex,
            "Gauss-Jordan in tensor ops": gauss_jordan}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_probe_pose_solve: no CUDA device available", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    J = torch.randn((900, 6), generator=gen)
    H = (J.T @ J + 1e-6 * torch.eye(6)).to(dev)
    b = torch.randn(6, generator=gen).to(dev)
    ref = torch.linalg.solve(H.double(), b.double())
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n = 40
    for name, fn in methods().items():
        fn(H, b)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                x = fn(H, b)
            torch.cuda.synchronize()
        syncs = sum(e.name in SYNC_CALLS for e in prof.events()) - 1
        kernels = sum(e.device_type == torch.autograd.DeviceType.CUDA
                      for e in prof.events())
        times = []
        for _ in range(n):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn(H, b)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        err = float((x.double() - ref).abs().max() / ref.abs().max())
        print(f"{name}: {syncs / n:.2f} host synchronisations and "
              f"{kernels / n:.1f} device events a call, "
              f"{statistics.median(times):.4f} ms a call by CUDA events, "
              f"relative error {err:.2e} against float64", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
