"""The codec. Its re-exports load lazily (PEP 562), so that importing a
light module of the package, such as `codec.config`, loads no torch."""

import importlib

_EXPORTS = {
    "CodecConfig": "jxl_tpu_torch.codec.config",
    "Strategy": "jxl_tpu_torch.codec.config",
    "encode_image": "jxl_tpu_torch.codec.encode",
    "decode_bytes": "jxl_tpu_torch.codec.decode",
}


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
