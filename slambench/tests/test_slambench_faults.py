"""A whole run of each cell, past the harness's look for a card, on the CPU
at 1/8 scale with the timed path broken underneath: ``correct`` comes out
false for each fault the cell can have. Sound, the same run is correct."""

import time

import pytest
import torch

from slambench.lib import harness
from slambench.tests.small import scaled

CELLS = {"tum3_walk.frontend": "tum_fr3_walking",
         "bonn_lanes8.precompute": "bonn_crowd"}


def _run(cell, seed=2 ** 31 + 11):
    out, _acc, _log = harness.run_cell(cell, seed, 1.0, False, time.perf_counter(),
                                 device="cpu",
                                 config=scaled(CELLS[cell], 0.125, 60))
    return out


def _state_unchanged(monkeypatch):
    from sindslam_tpu_torch.frontend import pipeline
    step = pipeline.frontend_step

    def broken(rgb, depth, state, cfg, **kw):
        out, _next = step(rgb, depth, state, cfg, **kw)
        return out, state
    monkeypatch.setattr(pipeline, "frontend_step", broken)


def _mask_altered(monkeypatch):
    from sindslam_tpu_torch.frontend import pipeline
    step = pipeline.frontend_step

    def broken(rgb, depth, state, cfg, **kw):
        out, nxt = step(rgb, depth, state, cfg, **kw)
        mask = out.dyna_mask.clone()
        h, w = mask.shape[-2:]
        mask[..., : h // 4, : w // 4] = cfg.dyna.mask_dynamic
        return out._replace(dyna_mask=mask), nxt._replace(prev_mask=mask)
    monkeypatch.setattr(pipeline, "frontend_step", broken)


def _flow_nan(monkeypatch):
    from sindslam_tpu_torch.frontend import pipeline
    step = pipeline.frontend_step

    def broken(rgb, depth, state, cfg, **kw):
        out, nxt = step(rgb, depth, state, cfg, **kw)
        u = nxt.flow_u_w.clone()
        u[..., 0, 0] = float("nan")
        return out, nxt._replace(flow_u_w=u)
    monkeypatch.setattr(pipeline, "frontend_step", broken)


def _half_the_lanes(monkeypatch):
    from sindslam_tpu_torch.parallel import batch_frontend as bf
    build = bf.batch_temporal_frontend

    def broken(cfg, device=None, mesh=None):
        run = build(cfg, device=device, mesh=mesh)

        def half(rgbs, depths, jitter=None, gumbel=None):
            b = rgbs.shape[0] // 2
            masks, large, n = run(rgbs[:b], depths[:b])
            return (torch.cat([masks, torch.zeros_like(masks)]),
                    torch.cat([large, torch.zeros_like(large)]),
                    torch.cat([n, torch.zeros_like(n)]))
        return half
    monkeypatch.setattr(bf, "batch_temporal_frontend", broken)


FAULTS = [("tum3_walk.frontend", _state_unchanged),
          ("tum3_walk.frontend", _mask_altered),
          ("tum3_walk.frontend", _flow_nan),
          ("bonn_lanes8.precompute", _state_unchanged),
          ("bonn_lanes8.precompute", _mask_altered),
          ("bonn_lanes8.precompute", _half_the_lanes)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(cell)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_a_reading_that_is_not_finite_fails():
    from slambench.reference import compare
    a = torch.zeros(3, 3)
    b = a.clone()
    b[1, 1] = float("nan")
    assert compare.gap(a, b) == float("inf")
    assert compare.gap(b, b) == 0.0
    worst = compare.worst([{"flow_gap_px": 0.0}, {"flow_gap_px": float("nan")}])
    assert worst["flow_gap_px"] == float("inf")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_path_is_correct(cell):
    out = _run(cell)
    assert out["correct"] is True
    assert all(c["value"] == 0 for c in out["checks"].values())
