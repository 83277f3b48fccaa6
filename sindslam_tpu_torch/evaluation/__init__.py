from sindslam_tpu_torch.evaluation.ate import ATEResult, evaluate_ate, evaluate_ate_files, horn_align  # noqa: F401
from sindslam_tpu_torch.evaluation.rpe import RPEResult, evaluate_rpe  # noqa: F401
