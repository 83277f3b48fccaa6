"""sindslam_tpu_torch — the PyTorch/CUDA port of sindslam_tpu for NVIDIA Hopper.

The JAX package ``sindslam_tpu`` is the reference: every module here keeps
the name of its JAX counterpart and is held against it by the parity tests
in ``tests/test_torch_*.py``. The four Pallas TPU kernels of
``sindslam_tpu/ops/pallas_kernels.py`` are hand-written CUDA C++ for
``sm_90a`` in ``csrc/``, built with ``nvcc`` at first use and bound with
``ctypes`` (``ops/_build.py``, ``ops/cuda_kernels.py``).

Device rule: entry points run on CUDA unless the caller passes
``device="cpu"``; with no CUDA device and no explicit ``"cpu"`` they raise.
fp32 everywhere with TF32 off (long-horizon drift tripled when image and
pose math ran through low-precision matmul passes on the TPU).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from sindslam_tpu_torch.config import (  # noqa: E402,F401
    CameraConfig,
    DynaConfig,
    FlowConfig,
    MappingConfig,
    ORBConfig,
    SystemConfig,
    TrackingConfig,
)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says
    otherwise. Raises when CUDA is asked for (explicitly or by default) and
    there is none — the port never falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sindslam_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev
