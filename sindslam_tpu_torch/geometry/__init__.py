from sindslam_tpu_torch.geometry import camera, se3  # noqa: F401
