from jxl_tpu_torch.core.xyb import srgb_to_xyb, xyb_to_srgb  # noqa: F401
from jxl_tpu_torch.core.image import ImageFileData, ColorType, ImageFormat  # noqa: F401
