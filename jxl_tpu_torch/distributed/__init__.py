from jxl_tpu_torch.distributed.mesh import make_mesh  # noqa: F401
