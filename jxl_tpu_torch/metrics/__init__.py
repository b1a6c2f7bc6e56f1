from jxl_tpu_torch.metrics.quality import (  # noqa: F401
    calculate_mse,
    calculate_psnr,
    calculate_ssim,
    calculate_ms_ssim,
    file_size_ratio,
)
from jxl_tpu_torch.metrics.perceptual import (  # noqa: F401
    calculate_butteraugli,
    calculate_ssimulacra2,
)
from jxl_tpu_torch.metrics.battery import metric_battery  # noqa: F401
