from jxl_tpu_torch.transforms.dct import dct_matrix, dct2d, idct2d, zigzag_order  # noqa: F401
