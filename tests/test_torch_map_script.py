"""``--map`` of ``examples/rgbd_odometry_torch.py`` on the CPU, in each of
its loops: odometry, ``--slam`` and the ``track_fused`` loop of ``--dyna
--fused --slam`` (the flagship drive ``chip_smoke.py`` runs on the card at
16 frames). Each run writes a ``.pcd`` whose point count is the one it
prints. On 16 frames of the flagship drive the port's map (44,208 voxels
after the outlier filter, 53,405 before) and the JAX package's (44,056 and
53,148, ``tools/torch_modes_reference.py``) are within 0.5 % on the CPU.
"""

import pytest

from test_torch_odometry import _run_script


@pytest.mark.parametrize("mode", [(), ("--slam",), ("--dyna", "--fused", "--slam")])
def test_odometry_script_builds_a_dense_map(tmp_path, mode):
    """``--map``: every 5th frame goes into the ``DenseMapper`` (frames 0
    and 5 of 6), and the filtered map is saved as a ``.pcd``."""
    pcd = tmp_path / "map.pcd"
    run = _run_script("--synthetic", "--frames", "6", "--device", "cpu", *mode,
                      "--map", str(pcd), "--out", str(tmp_path / "t.txt"),
                      cwd=tmp_path)
    assert run.returncode == 0, run.stderr[-2000:]
    line = next(ln for ln in run.stdout.splitlines()
                if ln.startswith("dense map:"))
    n_voxels = int(line.split()[2])
    assert n_voxels > 5000 and "2 keyframes inserted" in line, line
    head = pcd.read_bytes()[:400].decode(errors="replace")
    assert f"POINTS {n_voxels}" in head and head.startswith("# .PCD")
