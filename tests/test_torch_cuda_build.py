"""The launch seam of the port's CUDA kernels (`jxl_tpu_torch/cuda_build.py`),
on the CPU: every kernel source is registered and loaded before the first
request, each C entry is declared as its source defines it, and every
kernel wrapper refuses an unsupported device before any work. No nvcc is
needed: `load` is replaced where a test would load a library."""

import ctypes
import os
import re
import threading
import time

import pytest
import torch

from jxl_tpu_torch import cuda_build
from jxl_tpu_torch.codec.histogram import ac_counts4, histogram_stepped
from jxl_tpu_torch.codec.screen import screen_count
from jxl_tpu_torch.cuda_build import CSRC, ENTRIES, KERNEL_SOURCES, launch_counts
from jxl_tpu_torch.entropy.cuda_rans import decode_grouped_batched_cuda, decode_grouped_cuda
from jxl_tpu_torch.entropy.cuda_rans_enc import encode_grouped_cuda
from jxl_tpu_torch.entropy.kernel_bounds import measure_chain_cycles
from jxl_tpu_torch.transforms.dct import dct2d, idct2d


def test_registry_holds_every_kernel_source():
    """Every csrc/*.cu but the chain probe is a kernel library of the
    program, and every entry names a source that exists."""
    sources = {p.stem for p in CSRC.glob("*.cu")}
    assert set(KERNEL_SOURCES) == sources - {"chain_probe"}
    assert {e.source for e in ENTRIES.values()} == sources
    assert [n for n, e in ENTRIES.items() if e.probe] == ["chain_probe"]


def _c_argtypes(source: str, symbol: str) -> list:
    """The ctypes of each parameter of `extern "C" int symbol(...)` in
    csrc/<source>.cu."""
    text = (CSRC / f"{source}.cu").read_text()
    found = re.findall(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert len(found) == 1, symbol
    out = []
    for param in found[0].split(","):
        kind = param.rsplit(None, 1)[0].replace("const ", "").strip()
        if kind == "long long*":
            out.append(ctypes.POINTER(ctypes.c_longlong))
        elif kind.endswith("*"):
            out.append(ctypes.c_void_p)
        else:
            out.append({"int": ctypes.c_int, "uint32_t": ctypes.c_uint32}[kind])
    return out


@pytest.mark.parametrize("name", list(ENTRIES))
def test_entry_is_declared_as_its_source_defines_it(name):
    """Each entry's argument types, with the stream last, are the C
    parameters of its symbol in its source."""
    entry = ENTRIES[name]
    assert _c_argtypes(entry.source, entry.symbol) == [*entry.argtypes, ctypes.c_void_p]


@pytest.fixture
def loads(monkeypatch):
    """`cuda_build.load` replaced by a recorder: the names asked for, in order."""
    seen = []
    monkeypatch.setattr(cuda_build, "load", seen.append)
    return seen


def test_load_kernels_loads_every_registered_kernel(loads):
    cuda_build.load_kernels(torch.device("cpu"))
    assert loads == []
    cuda_build.load_kernels(torch.device("cuda", 0))
    assert loads == list(KERNEL_SOURCES)


@pytest.fixture
def fake_card(monkeypatch, loads):
    """cuda:0 as the device, where a tiny tensor made for it lands on the
    CPU: enough for a warm-up to reach its kernel loads without a card."""
    from jxl_tpu_torch.core import device as core_device

    monkeypatch.setattr(core_device, "resolve_device", torch.device)
    for fn in ("ones", "empty"):
        real = getattr(torch, fn)
        monkeypatch.setattr(torch, fn, lambda *a, device=None, _real=real, **k: _real(*a, **k))
    return loads


def test_serve_warm_up_loads_every_kernel(fake_card, tmp_path):
    """`serve --device cuda:0` loads every registered kernel before it
    listens."""
    from jxl_tpu_torch.cli import server

    sock = str(tmp_path / "s.sock")
    t = threading.Thread(target=server.serve, args=(sock,), kwargs={"device": "cuda:0"}, daemon=True)
    t.start()
    deadline = time.monotonic() + 60
    while not os.path.exists(sock) and t.is_alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert fake_card == list(KERNEL_SOURCES)
    assert server._request({"cmd": "shutdown"}, sock)["ok"]
    t.join(60)
    assert not t.is_alive()


def test_profile_startup_loads_every_kernel(fake_card, monkeypatch, tmp_path):
    """profile_startup on cuda:0 loads every registered kernel under its
    `kernel_build_or_load` mark."""
    from jxl_tpu_torch import tools
    from jxl_tpu_torch.codec import encode
    from jxl_tpu_torch.tools import profile_startup

    monkeypatch.setattr(encode, "encode_image", lambda *a, **k: b"jxt")
    monkeypatch.setattr(tools, "card_line", lambda dev: str(dev))
    marks = []
    monkeypatch.setattr(profile_startup, "mark", lambda name: marks.append((name, list(fake_card))))
    res = profile_startup.main(["--device", "cuda:0", "--out", str(tmp_path / "x.jxt")])
    assert res["device"] == "cuda:0"
    loaded = dict(marks)
    assert loaded["first_tiny_launch"] == [] and loaded["kernel_build_or_load"] == list(KERNEL_SOURCES)


WRAPPERS = {
    "decode_grouped_cuda": lambda m: decode_grouped_cuda(m, m, m, m, m, T=1, lanes=128),
    "decode_grouped_batched_cuda": lambda m: decode_grouped_batched_cuda(m, m, m, m, m, T=1, lanes=128),
    "encode_grouped_cuda": lambda m: encode_grouped_cuda(m, m, m, T=1, lanes=128, capw=128, capm=128),
    "screen_count": screen_count,
    "dct2d": dct2d,
    "idct2d": idct2d,
    "histogram_stepped": lambda m: histogram_stepped(m, m, 128, 1),
    "ac_counts4": lambda m: ac_counts4(m, m),
    "measure_chain_cycles": lambda m: measure_chain_cycles(m.device),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_unsupported_device_raises_before_any_work(name, loads):
    """A meta tensor raises ValueError naming the function and the device
    before any argument check, read-back, build or launch (the arguments
    are empty, so any check would raise first with its own message)."""
    c0 = launch_counts()
    with pytest.raises(ValueError, match=f"^{name}: unsupported device meta$"):
        WRAPPERS[name](torch.empty(0, device="meta"))
    assert loads == [] and launch_counts() == c0


def test_chain_probe_has_no_plain_version(loads):
    with pytest.raises(ValueError, match="^measure_chain_cycles: unsupported device cpu$"):
        measure_chain_cycles("cpu")
    assert loads == []


def test_launch_counts_is_a_snapshot():
    """One count per entry; the dict is a copy the caller may keep."""
    c0 = launch_counts()
    assert set(c0) == set(ENTRIES) and all(isinstance(v, int) and v >= 0 for v in c0.values())
    c0["rans_encode"] += 5
    assert launch_counts()["rans_encode"] == c0["rans_encode"] - 5
