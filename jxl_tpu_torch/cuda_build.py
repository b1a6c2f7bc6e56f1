"""Build, load and launch the port's CUDA kernels (`csrc/*.cu`).

Each source has a plain C interface and is compiled on first use with
nvcc for sm_90a into a shared library under the repository's `build/cuda/`
directory, then loaded with ctypes. The library name carries a hash of
the source and the flags, so an edited kernel is rebuilt and an unchanged
one is reused. Nothing is built when the package is imported.

The launch seam: `ENTRIES` declares every C entry once (its source, symbol
and argument types; the stream is the last argument of each), `launch`
calls one on a device's current stream and counts it (`launch_counts`),
and `route` picks a wrapper's kernel or plain version by the device.
`KERNEL_SOURCES` are the program's kernel libraries, which `load_kernels`
loads before the first request. `check_tensor` validates the tensors the
kernels' wrappers pass.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# compiler output (ptxas register / shared-memory report) per built source
BUILD_LOGS: dict[str, str] = {}

_P, _I = ctypes.c_void_p, ctypes.c_int


class Entry(NamedTuple):
    """One C entry of csrc/<source>.cu: `int symbol(*argtypes, void* stream)`,
    0 on success, else a CUDA error code."""

    source: str
    symbol: str
    argtypes: tuple
    probe: bool = False  # measures the card; no kernel of the program


_DECODE = (_P, _I, _P, _I, _P, _I, _P, _P, _I)  # words, capw, mant, capm, rows, T, states, ptrs, G

ENTRIES = {
    "rans_decode": Entry("rans_dec", "jxl_rans_decode", _DECODE + (_P, _P, _P)),
    "rans_decode_batched": Entry("rans_dec", "jxl_rans_decode_batched", _DECODE + (_I, _P, _P, _P)),
    "rans_encode": Entry("rans_enc", "jxl_rans_encode", (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P)),
    "screen": Entry("screen", "jxl_screen_count", (_P, _I, _I, _I, _P)),
    "dct2d": Entry("dct", "jxl_dct2d", (_P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong))),
    "hist": Entry("hist", "jxl_hist", (_P, _P, _I, _I, _I, _I, _P)),
    "chain_probe": Entry("chain_probe", "jxl_chain_probe", (_I, ctypes.c_uint32, _P, _P), probe=True),
}
KERNEL_SOURCES = tuple(dict.fromkeys(e.source for e in ENTRIES.values() if not e.probe))

_launches = dict.fromkeys(ENTRIES, 0)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (looked in {cand} and on PATH)")
    return found


def build(name: str) -> Path:
    """Compile csrc/<name>.cu (if not already built) and return the .so path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        BUILD_LOGS.setdefault(name, "(cached)")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    BUILD_LOGS[name] = proc.stdout + proc.stderr
    return out


def check_tensor(name: str, t, dtype, shape, device):
    """Raise ValueError unless t has the dtype, shape (None = any extent),
    device and contiguity the kernels take."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


@lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, loaded once per process."""
    return ctypes.CDLL(str(build(name)))


def load_kernels(device) -> None:
    """On a CUDA device, build or load every library of KERNEL_SOURCES, so
    that no request pays for it; on another device, nothing."""
    if torch.device(device).type == "cuda":
        for name in KERNEL_SOURCES:
            load(name)


@lru_cache(maxsize=None)
def bind(lib: ctypes.CDLL, name: str):
    """Entry `name`'s function in `lib`, its argument and result types set."""
    entry = ENTRIES[name]
    fn = getattr(lib, entry.symbol)
    fn.argtypes = [*entry.argtypes, _P]
    fn.restype = _I
    return fn


def launch(name: str, device, *args, lib: ctypes.CDLL | None = None) -> None:
    """Call entry `name` with `args` on `device`'s current stream, from the
    package's build of its source or from `lib` (another build of it);
    raises RuntimeError on a CUDA error, and counts the launch."""
    fn = bind(load(ENTRIES[name].source) if lib is None else lib, name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch ({ENTRIES[name].symbol}) failed: CUDA error {err}")
    _launches[name] += 1


def launch_counts() -> dict:
    """Launches of each entry so far in this process (take differences)."""
    return dict(_launches)


def route(name: str, device, kernel, plain=None):
    """`kernel` on a CUDA device, `plain` on the CPU; raises ValueError on
    any other device, and on the CPU where there is no plain version."""
    kind = torch.device(device).type
    if kind == "cuda":
        return kernel
    if kind == "cpu" and plain is not None:
        return plain
    raise ValueError(f"{name}: unsupported device {device}")
