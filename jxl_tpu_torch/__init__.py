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

Covered: the codec (lossy VarDCT at efforts 1-9 under every strategy, the
modular family: d = 0 lossless, modular-lossy, palette, the
VarDCT-vs-modular pick), single image and grid rows (`codec.encode`,
`codec.decode`); the metric battery (`metrics`); the RD-sweep harness with
its CSVs and A/B comparison (`bench`); striped JXTS containers for images
above the single-section cap (`codec.tiled`); the stable analysis entry
(`codec.analysis`); the device mesh, the sharded batch / grid / striped
encodes and the halo-exchange EPF (`distributed`, `bench --mesh`); the
CLI, `python -m jxl_tpu_torch {encode,decode,serve,bench,compare}
--device ...` (`cli.main`), with the persistent server (`cli.server`); the
standalone interleaved rANS coder and the mantissa packers (`entropy`), and
the binding of the native C++ core they are held to (`native`). Every
public name of `jxl_tpu` has its counterpart here, apart from the TPU-only
pieces that tests/test_torch_surface.py lists with their reasons.

`CodecConfig` and `Strategy` load lazily (PEP 562): the CLI's forwarding
client imports this package and must not load torch.
"""

import importlib

__version__ = "0.1.0"


def __getattr__(name: str):
    if name in ("CodecConfig", "Strategy"):
        return getattr(importlib.import_module("jxl_tpu_torch.codec.config"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
