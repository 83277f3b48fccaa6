"""The front-end's settings as plain dataclasses, frozen here: the
camera, ORB, flow and dynamic-region groups of the port's ``SystemConfig``,
with the same field names. ``from_groups`` builds one from a deployment
file's groups, so that the reference reads the very numbers the program is
given.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole RGB-D camera intrinsics.

    Reference: ``ORB_SLAM2/Examples/RGB-D/TUM3.yaml:8-33`` and the reads in
    ``Examples/RGB-D/rgbd_tum_noros.cc:82-86`` / ``src/Tracking.cc`` ctor.
    """

    fx: float = 535.4
    fy: float = 539.2
    cx: float = 320.1
    cy: float = 247.6
    width: int = 640
    height: int = 480
    # TUM depth PNGs store depth*5000 (``DepthMapFactor`` in the YAMLs).
    depth_factor: float = 5000.0
    # Radial/tangential distortion (k1, k2, p1, p2, k3). TUM3 is rectified.
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    fps: float = 30.0
    # Virtual-stereo baseline*fx used for the RGB-D "stereo" formulation
    # (reference ``Camera.bf`` in the YAMLs, e.g. TUM3.yaml).
    bf: float = 40.0
    # Close/far point threshold in virtual-stereo units (``ThDepth``).
    th_depth: float = 40.0
    rgb: bool = True  # color order flag (``Camera.RGB``)
    # Depth-discontinuity veto for per-keypoint depth (slam/frame.py::
    # _depth_ur): a keypoint whose radius-2 depth window spans more than
    # max(abs, rel * z) — or touches an invalid pixel — becomes a MONO
    # observation. OFF by default (thresholds at inf): measured on the
    # benchmark suite the near-side edge depth is valid and those close
    # high-parallax corners are the most informative (masked ATE regressed
    # 3-5x with the veto on). Kept configurable for sensors with flying-
    # pixel edge artifacts (ToF) where the reference implicitly relies on
    # the sensor invalidating boundary pixels (``Frame.cc:714``).
    depth_edge_abs_m: float = float("inf")
    depth_edge_rel: float = float("inf")

    @property
    def baseline(self) -> float:
        return self.bf / self.fx

    def intrinsics(self) -> Tuple[float, float, float, float]:
        return (self.fx, self.fy, self.cx, self.cy)


@dataclass(frozen=True)
class ORBConfig:
    """ORB extractor parameters.

    Reference: ``ORB_SLAM2/Examples/RGB-D/TUM3.yaml:41-54`` (1500 features, 8
    levels, scale 1.2, FAST thresholds 15/5) and the lost-prevention revert
    threshold in ``src/ORBextractor.cc:1105-1115``.
    """

    n_features: int = 1500
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 15
    min_th_fast: int = 5
    # If fewer than this many keypoints survive dynamic-mask erasure, the
    # erasure is reverted (reference ``src/ORBextractor.cc:1105-1115``).
    min_keypoints_after_mask: int = 250
    # Static per-level candidate cap before spatial suppression (TPU static
    # shapes; generous multiple of n_features per level).
    max_candidates_per_level: int = 4096


@dataclass(frozen=True)
class FlowConfig:
    """Variational dense optical-flow solver parameters.

    Parity target: ``cv::cuda::BroxOpticalFlow(0.197, 50.0, 0.8, 10, 77, 10)``
    + ``cv::VariationalRefinement`` (reference ``src/DynaDetect.cc:1028-1033,
    1133-1143``), computed at 0.6x scale (``src/DynaDetect.cc:1033``).
    """

    alpha: float = 0.197       # smoothness weight
    gamma: float = 50.0        # gradient-constancy weight
    # The reference CUDA solver uses scale 0.8 with 77 cheap outer warps; on
    # TPU each level pays fixed per-iteration costs, and a 0.65 pyramid with
    # the strong VMEM inner solver measured both FASTER (13.2 -> 9.9 ms) and
    # more accurate (EPE mean 1.35 -> 1.17 px at 23 px motion) than 0.8.
    pyramid_scale: float = 0.65
    n_levels: int = 10         # pyramid depth cap
    # TPU cost structure: each outer iteration pays one full-image gather
    # (the warp); inner iterations and SOR sweeps run inside one VMEM-resident
    # Pallas kernel and are nearly free. So the budget leans on inner/sweeps
    # rather than the reference CUDA solver's 77 outer warps.
    outer_iterations: int = 3  # warp + lagged-nonlinearity updates per level
    # the finest levels only refine subpixel residuals, so they get fewer
    # warps (each warp at full working res is the most expensive gather)
    outer_iterations_fine: int = 2
    n_fine_levels: int = 2
    inner_iterations: int = 5  # linearization updates per outer (in-kernel)
    solver_iterations: int = 8   # red-black relaxation sweeps per inner
    sor_omega: float = 1.9
    # Large-motion fallback pre-test (flow_with_fallback): the n->n-2 solve
    # pauses after this pyramid level (0 = finest) for the magnitude test;
    # only the chosen target frame gets the expensive fine levels. 2 keeps
    # the pre-test at roughly the cost of levels >= 122x162 at working res.
    fallback_pretest_level: int = 2
    working_scale: float = 0.6  # flow computed at 0.6x then upscaled
    # Working-resolution canvas (0.6 * 640x480). Static for XLA.
    working_width: int = 384
    working_height: int = 288
    use_pallas: Optional[bool] = None  # None = auto (TPU only)


@dataclass(frozen=True)
class DynaConfig:
    """Dynamic-region detector (DynaDetect equivalent) parameters.

    Reference constants: ``src/DynaDetect.cc:43-48`` (640x480, 3x4 cluster
    grid, depth weight 1.5), thresholds ``:1309-1367``, fusion ``:1560-1634``,
    driver dilation ``Examples/RGB-D/rgbd_tum_noros.cc:108,138``.
    """

    # --- k-means re-clustering (SegByKmeans, DynaDetect.cc:315-420)
    n_clusters: int = 12
    cluster_grid_rows: int = 3
    cluster_grid_cols: int = 4
    depth_weight: float = 1.5
    max_depth_m: float = 6.0
    kmeans_iters: int = 4
    kmeans_pyramid_levels: int = 3
    kmeans_pyramid_scale: float = 0.5
    # Padded maximum number of post-merge clusters (static shapes on TPU).
    max_clusters: int = 16

    # --- depth/plane edges (CalOccluded, DynaDetect.cc:429-642)
    depth_edge_rel: float = 0.03      # 3% of depth
    depth_edge_abs_mm: float = 400.0  # floor in millimetres
    median_ksize: int = 5
    endpoint_nms_radius: int = 6

    # --- plane segmentation (PEAC equivalent)
    plane_block: int = 16
    plane_min_support: int = 2000
    plane_z_min_mm: float = 500.0
    plane_z_max_mm: float = 6000.0
    plane_merge_cos: float = 0.966    # cos(15 deg) similarity to merge
    plane_mse_tol_mm: float = 17.0

    # --- RAG merge (SegAndMergeV2, DynaDetect.cc:653-1018)
    rag_adjacency_min_overlap: float = 200.0
    rag_adjacency_frac: float = 0.4
    rag_hist_reject: float = 0.19
    rag_fake_edge_overlap: float = 0.62
    rag_small_cluster_weight: float = 2.0
    rag_near_cluster_weight: float = 0.7
    rag_merge_score_min: float = 0.9
    min_cluster_area: int = 80

    # --- flow-residual masking (DynaDetect.cc:1023-1374)
    sample_grid_step: int = 10
    large_motion_flow_px: float = 10.0
    # quantile semantics: "large motion" fires when the fraction of sampled
    # pixels BELOW large_motion_flow_px drops under this (i.e. the 30th
    # percentile of flow exceeds ~10 px, DynaDetect.cc:1196-1211)
    large_motion_frac: float = 0.30
    # wide-baseline flow composition on large-motion frames is disabled when
    # the 30th-percentile magnitude also exceeds this (full-res n-2-
    # equivalent px): at extreme motion the composed field reconstructs
    # exactly the untrackable baseline the n-1 fallback exists to avoid
    # (measured: composing at 4x walking speed floods the mask and loses
    # tracking, while at 1-2x it restores the mover's residual SNR)
    compose_max_flow_px: float = 30.0
    ransac_iters: int = 512
    ransac_thresh_px: float = 1.5
    low_thresh_min: float = 1.7
    low_thresh_max: float = 3.0
    high_thresh_min_scale: float = 1.2  # high >= max(3, 1.2*low)
    high_thresh_floor: float = 3.0
    high_thresh_max: float = 10.0
    low_refire_frac: float = 0.5  # re-raise low if >50% of pixels fire
    # --- parallax-consistency exclusion (BEYOND the reference: static
    # close-range structure whose homography residual matches the
    # camera-translation * inverse-depth law is never masked — protects the
    # 3-10 px gray zone between the threshold ladder and the large-motion
    # fallback; see frontend/flow_mask.py::_parallax_consistency)
    parallax_filter: bool = True
    parallax_max_px: float = 8.0     # only residuals below this can be parallax
    # absolute consistency tolerance: set AT the flow solver's own EPE
    # (~1.2 px) — below it, far-background flow noise reads as "inconsistent
    # with parallax" and floods the mask (r3 dyn_walk frames 6-9); movers sit
    # several px off the depth-coupled prediction either way
    parallax_tol_px: float = 1.3
    parallax_tol_rel: float = 0.35   # relative tolerance vs predicted parallax
    parallax_fit_med_px: float = 1.5  # median fit error above this -> model off
    w_invalid: float = 1.0
    w_static: float = 1.2
    w_dynamic: float = 0.4
    sample_jitter_std: float = 0.5

    # --- fusion (DynaDetect.cc:1560-1634)
    fuse_dilate_iters: int = 5
    # Final mask dilation. The reference dilates 9x here AND the driver adds
    # a 15x15 ellipse before feature erasure (rgbd_tum_noros.cc:138) — a
    # double margin. Here the safety margin is REDISTRIBUTED: the returned/
    # mapped mask keeps a tight 4-iteration dilation (the detector's actual
    # segmentation: measured zero missed mover pixels on the benchmark, the
    # IoU deficit was pure boundary overshoot), while the feature-erasure
    # path compensates with a larger ellipse (mask_dilate_ksize 21), so the
    # total erasure margin matches the reference's ~16 px.
    final_dilate_iters: int = 4
    flood_min_area: float = 100.0
    flood_roundness: float = 0.2
    # "big blob" bypass of the roundness gate (ref DynaDetect.cc:1566-1608
    # uses 2000). Raised to 8000 here: residual parallax at depth edges
    # forms ELONGATED bands of several thousand px at 640x480 that fail
    # roundness but sailed through the 2000 bypass and seeded false fills;
    # genuine movers at these resolutions are tens of thousands of px.
    flood_big_area: float = 8000.0
    # A cluster promoted to fully-dynamic for the FIRST time (no decayed
    # history support) must have this fraction of its area covered by
    # high-residual evidence — low-mask-only fills (parallax carpets) are
    # not enough. Sustained promotion rides the decayed persistence score.
    promote_min_high_cover: float = 0.25
    # Per-frame ramp limit on the cluster evidence ratio: a genuine mover
    # accumulates support over >= 2 frames (fills already mask it on frame
    # one), while a single-frame residual burst (flow glitch, parallax
    # breakout) can then never reach the promotion threshold before its
    # evidence vanishes again.
    promote_ratio_ramp: float = 0.4
    cluster_dynamic_frac: float = 0.5
    # Cluster-level temporal persistence: a cluster whose (decayed) dynamic
    # ratio from previous frames still exceeds cluster_dynamic_frac stays
    # masked even when the instantaneous flow residual vanishes (a walking
    # person pausing mid-stride has zero residual for a few frames but is
    # still a dynamic object). The decay releases a genuinely stopped
    # object after ~ log(0.5)/log(decay) ~ 4 evidence-free frames.
    persist_ratio_decay: float = 0.85
    # Photometric reliability gate: pixels where warping the flow's target
    # frame by the solved flow fails to reproduce the current frame
    # (normalized [0, 1] intensity error above this) have no real
    # correspondence — disocclusion bands behind movers, occlusion
    # boundaries — so their flow residual is NOT motion evidence and they
    # are excluded from the low/high masks.
    photo_filter: bool = True
    photo_err_max: float = 0.08
    # Driver-side post-dilation of the final mask (rgbd_tum_noros.cc:108,138);
    # raised 15 -> 21 to keep the total feature-erasure margin at the
    # reference's level after final_dilate_iters was tightened (see above).
    mask_dilate_ksize: int = 21

    # Mask encoding (DynaDetect.cc:1622,1633-1634).
    mask_dynamic: int = 255
    mask_static: int = 125
    mask_invalid: int = 0


@dataclass(frozen=True)
class SystemConfig:
    """The groups the front-end reads."""

    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: ORBConfig = field(default_factory=ORBConfig)
    flow: FlowConfig = field(default_factory=FlowConfig)
    dyna: DynaConfig = field(default_factory=DynaConfig)


def from_groups(groups: dict) -> SystemConfig:
    """A ``SystemConfig`` from ``{"camera": {...}, "orb": {...}, "flow":
    {...}, "dyna": {...}}``; a missing field keeps its default."""
    return SystemConfig(camera=CameraConfig(**groups.get("camera", {})),
                        orb=ORBConfig(**groups.get("orb", {})),
                        flow=FlowConfig(**groups.get("flow", {})),
                        dyna=DynaConfig(**groups.get("dyna", {})))
