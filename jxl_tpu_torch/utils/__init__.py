from jxl_tpu_torch.utils.fs import exists_or_create_dir, dir_exists  # noqa: F401
