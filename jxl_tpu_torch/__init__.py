"""jxl_tpu_torch — the PyTorch + CUDA port of the jxl_tpu codec.

The same sub-packages and module names as `jxl_tpu`, written as plain
functions on torch tensors. Every public function takes an explicit
`device` argument or takes the device from its input tensor; nothing picks
a device on its own. The two rANS scans the TPU package ran as Pallas
kernels are CUDA C++ kernels for Hopper (`csrc/`, bound in
`entropy/cuda_rans.py` and `entropy/cuda_rans_enc.py`); on a CPU tensor
their wrappers run the plain torch versions instead.

The package imports torch and numpy, never jax: the numpy-only contract
pieces (constants, tables, layouts, the container) are copies, held equal
to the reference by the tests.

Covered so far: single-image lossy VarDCT encode and decode at efforts
1-7 with the BASELINE strategy (`codec.encode.encode_image`,
`codec.decode.decode_bytes`).
"""

__version__ = "0.1.0"
