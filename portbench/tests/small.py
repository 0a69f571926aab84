"""Each cell cut to a size the CPU runs in seconds, for the tests: the
kernels' plain versions, 240x320 frames and small stores, a 20-camera
bundle-adjustment problem."""

SCAN = dict(
    config={"image_size": [240, 320],
            "K": [[250.0, 0, 160.0], [0, 250.0, 120.0], [0, 0, 1.0]]},
    engine=dict(max_keypoints=192, max_keyframes=8, max_landmarks=1024,
                image_height=240, image_width=320, pyramid_levels=3,
                ransac_hypotheses=64, ba_iterations=6,
                keyframe_min_tracked=15, keyframe_time_lag=6,
                min_init_matches=25, ba_landmark_capacity=512,
                track_widen_capacity=512, mapping_reobs_capacity=512),
    traffic=dict(frames_per_scan=24, chunk=6, scenes=1, warm_frames=6,
                 bootstrap_frames=6, map_frames=24))

BA = dict(config={"problem": {"cameras": 20, "landmarks": 600,
                              "obs_per_landmark": 6}})


def overrides(cell: str) -> dict:
    return BA if cell.startswith("ba1k") else SCAN
