"""Typed configuration for the PyTorch engine.

Field for field the same dataclass as ``sfm_tpu.config.SfMConfig`` (same
names, same defaults), so one config round-trips between the two packages.
Static capacities keep their meaning: they fix the tensor shapes of every
store, which is what lets a later step run under a captured CUDA graph.

Knobs that only chose between TPU formulations are accepted and ignored
here (no-ops), documented where they stand:

- ``feature_dtype`` / ``patch_int8``: bf16 and int8 MXU selection matmuls.
  The port computes the descriptor in float32 from gathered patches.
- ``detector_approx_topk``: the TPU PartialReduce top-k.  The port always
  takes the exact (stable) top-k.
- ``use_pallas_matcher``: on a CUDA tensor every matcher call goes through
  the hand-written Hamming kernel; on a CPU tensor through its plain
  version (the two are exact-equal).
- ``use_pallas_ba``: ``ba_solver="large"`` always runs the JAX package's
  fused route: on a CUDA tensor through the hand-written K2 / K3 kernels,
  on a CPU tensor through their plain versions.
- ``mesh_axis_map`` / ``mesh_axis_data``: JAX mesh axis names.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SfMConfig:
    # ---- static capacities (tensor shape constants) ----
    max_keypoints: int = 512
    max_keyframes: int = 64
    max_landmarks: int = 16384
    desc_bits: int = 512
    image_height: int = 480
    image_width: int = 640
    pyramid_levels: int = 4

    # ---- detector ----
    fast_threshold: float = 20.0
    feature_dtype: str = "float32"      # no-op here (TPU bf16 MXU path)
    patch_int8: bool = False            # no-op here (TPU int8 MXU path)
    nms_radius: int = 2
    detector_approx_topk: bool = False  # no-op here (exact top-k always)

    # ---- matcher ----
    match_ratio: float = 0.8
    match_min_radius: float = 1.5
    match_max_radius: float = 40.0
    match_max_distance: int = 90
    min_features: int = 5

    # ---- two-view init ----
    h_inlier_threshold: float = 5.99
    f_inlier_threshold: float = 3.84
    hf_model_ratio: float = 0.45
    ransac_hypotheses: int = 128
    min_init_matches: int = 40

    # ---- tracking / PnP ----
    max_reproj_error: float = 7.0
    pnp_hypotheses: int = 32
    pnp_sample_size: int = 6
    pnp_solver: str = "dlt"             # "dlt" | "p3p"
    pnp_refine_iters: int = 6
    pnp_fast_path_ratio: float = 0.0
    track_refine_iters: int = 4
    max_lost_frames: int = 10

    # ---- relocalization ----
    reloc_solver: str = "p3p"
    reloc_min_inliers: int = 10

    # ---- flow-assisted tracking ----
    track_with_flow: bool = False
    flow_levels: int = 3
    flow_iters: int = 10
    flow_assoc_dist: float = 2.0

    # compact the widen matcher's landmark axis to the in-view candidates
    # (0 = off, full landmark axis)
    track_widen_capacity: int = 0

    # ---- keyframe policy ----
    keyframe_time_lag: int = 10
    keyframe_min_tracked: int = 50
    keyframe_track_ratio: float = 0.9

    # ---- mapping ----
    mapping_max_radius: float = 120.0
    mapping_tri_keyframes: int = 8
    mapping_reobs_keyframes: int = 16
    mapping_use_covisibility: bool = True
    mapping_reobs_capacity: int = 0

    # ---- culling ----
    cull_min_views: int = 3
    cull_young_kf_age: int = 3
    cull_view_ratio: float = 0.25
    kf_cull_redundancy: float = 0.9
    kf_cull_min_others: int = 3
    epipolar_max_error: float = 7.0

    # ---- bundle adjustment ----
    ba_iterations: int = 20
    ba_lambda_init: float = 1e-3
    ba_lambda_up: float = 4.0
    ba_lambda_down: float = 2.0
    ba_huber_delta: float = 0.0
    ba_tol: float = 3e-4
    ba_solver: str = "dense"            # "dense" | "large" | "cg"
    ba_kmax: int = 16
    use_pallas_ba: bool = False         # no-op here (see module doc)
    ba_cg_iterations: int = 15
    ba_landmark_capacity: int = 0
    ba_local_window: int = 0
    global_ba_every: int = 0
    global_ba_iterations: int = 10
    global_ba_cg_iterations: int = 25
    global_ba_kmax: int = 0
    global_ba_huber_delta: float = 0.0

    # ---- loop closure ----
    loop_detect_every: int = 0
    loop_min_age: int = 30
    loop_min_inliers: int = 25
    loop_min_drift: float = 0.05
    loop_use_scale: bool = True
    loop_scale_min_pairs: int = 8
    loop_scale_max_dispersion: float = 0.15

    # ---- scan guidance (RGB input) ----
    guidance_enabled: bool = True
    guidance_downscale: int = 4
    guidance_hist_bins_h: int = 60
    guidance_hist_bins_s: int = 50
    guidance_ema_alpha: float = 0.9
    guidance_backproj_threshold: float = 0.01

    # ---- kernels ----
    use_pallas_matcher: bool = False    # no-op here (see module doc)

    # ---- parallel / distributed ----
    mesh_axis_map: str = "map"
    mesh_axis_data: str = "scan"

    @property
    def desc_words(self) -> int:
        """Descriptor width in packed 32-bit words."""
        return self.desc_bits // 32

    @property
    def image_size(self) -> Tuple[int, int]:
        return (self.image_height, self.image_width)


DEFAULT_CONFIG = SfMConfig()

# The flagship single-scan configuration (the JAX package's
# __graft_entry__.FLAGSHIP, field for field: 480x640, 512 keypoints, 32
# keyframes, 8192 landmarks, the large implicit-Schur BA solver) with a
# float32 descriptor: the bf16 / int8 descriptor paths were TPU MXU choices.
FLAGSHIP = dict(
    max_keypoints=512, max_keyframes=32, max_landmarks=8192,
    image_height=480, image_width=640, pyramid_levels=4,
    use_pallas_matcher=True, detector_approx_topk=True,
    ba_landmark_capacity=2048, feature_dtype="float32", patch_int8=False,
    track_widen_capacity=2048, mapping_reobs_capacity=2048,
    ba_huber_delta=2.0, ba_solver="large", ba_kmax=8, ba_cg_iterations=12,
    ba_iterations=15, use_pallas_ba=True)

# The flagship with the dense BA solver in place of the large one (the
# first slice of the port; kept as the dense solver's end-to-end case).
SLICE = dict(FLAGSHIP, ba_solver="dense", use_pallas_ba=False)

# The long-scan configuration (benchmarks/bench_longscan.py's LARGE, field
# for field; its TPU knobs are no-ops here): 512 keyframes, 65536
# landmarks, a keyframe every 4 frames at most, windowed-local mapping BA
# on the large solver over a compacted axis of 16384 landmarks, and a
# global BA every 32 keyframe insertions (10 LM x 25 CG iterations, 16
# observation slots per landmark, Huber 7).
LONGSCAN = dict(
    max_keypoints=512, max_keyframes=512, max_landmarks=65536,
    image_height=480, image_width=640, pyramid_levels=4,
    use_pallas_matcher=True, detector_approx_topk=True,
    feature_dtype="bfloat16", ba_huber_delta=2.0,
    keyframe_time_lag=4, keyframe_min_tracked=15,
    ba_solver="large", ba_kmax=8, ba_iterations=3, ba_cg_iterations=12,
    ba_local_window=24, use_pallas_ba=True, ba_landmark_capacity=16384,
    global_ba_every=32, global_ba_iterations=10, global_ba_cg_iterations=25,
    global_ba_kmax=16, global_ba_huber_delta=7.0,
    mapping_tri_keyframes=8, mapping_reobs_keyframes=16,
    mapping_reobs_capacity=8192)

# The loop-closure ring (benchmarks/bench_loop_closure.py's configuration,
# field for field): LONGSCAN with a loop probe every 8 keyframe insertions
# against landmarks at least 60 keyframes old, a closure at >= 25 PnP
# inliers and > 0.3 m of drift, the sim(3) scale on first contact, and
# covisibility windows in mapping.
RING = dict(LONGSCAN, loop_detect_every=8, loop_min_age=60,
            loop_min_inliers=25, loop_min_drift=0.3, loop_use_scale=True,
            mapping_use_covisibility=True)
