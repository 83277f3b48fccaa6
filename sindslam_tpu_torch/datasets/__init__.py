from sindslam_tpu_torch.datasets.associate import associate, associate_window, read_file_list  # noqa: F401
from sindslam_tpu_torch.datasets.tum import TUMSequence, load_tum_sequence, write_tum_trajectory  # noqa: F401
