"""The port's monocular and stereo example scripts
(``examples/{mono,stereo}_odometry_torch.py``) as subprocesses on the CPU
(``--device cpu``) at a few frames: each writes a TUM trajectory and prints
its ATE; without ``--device cpu`` and without a card each (and
``ar_demo_torch.py``) raises instead of running on the CPU.
"""

import numpy as np
import pytest

from test_torch_cli import _run


@pytest.mark.parametrize("script,args,ate", [
    ("mono_odometry_torch.py", ("--frames", "6"), "ATE (scale-aligned)"),
    ("stereo_odometry_torch.py", ("--frames", "4"), "ATE (metric)"),
])
def test_mono_and_stereo_scripts_on_the_cpu(tmp_path, script, args, ate):
    out = tmp_path / "traj.txt"
    run = _run(script, "--synthetic", *args, "--eval-ate", "--device", "cpu",
               "--out", str(out), cwd=tmp_path)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "on cpu" in run.stdout and ate in run.stdout
    rows = np.loadtxt(out)
    assert rows.ndim == 2 and rows.shape[1] == 8 and np.isfinite(rows).all()


def test_scripts_raise_without_a_card_unless_asked_for_the_cpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for script, args in (("ar_demo_torch.py", ("--synthetic", "--frames", "1",
                                               "--out-dir", str(tmp_path))),
                         ("mono_odometry_torch.py", ("--synthetic",)),
                         ("stereo_odometry_torch.py", ("--synthetic",))):
        run = _run(script, *args, cwd=tmp_path)
        assert run.returncode != 0 and "no CUDA device" in run.stderr, script
