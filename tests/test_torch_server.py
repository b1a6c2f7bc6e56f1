"""The port's persistent codec server (jxl_tpu_torch/cli/server.py): a real
subprocess server on a unix socket with `--device cpu`, driven through the
forwarding client path the CLI uses (mirrors tests/test_server.py).

Bars: a forwarded encode writes the bytes of the local encode and a
forwarded decode the local decode's pixels; the client imports no torch."""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from jxl_tpu_torch.cli.main import main
from jxl_tpu_torch.cli.server import _handle, _same_device, default_socket, try_forward
from jxl_tpu_torch.codec.config import CodecConfig
from jxl_tpu_torch.codec.decode import decode_bytes
from jxl_tpu_torch.codec.encode import encode_image
from jxl_tpu_torch.codec.tiled import encode_image_striped, is_striped
from jxl_tpu_torch.core.io import read_image, write_image

from tests.conftest import make_test_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH" and not k.startswith("JXL_TPU_TORCH_")}
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("srv") / "jxl.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "jxl_tpu_torch", "serve", "--device", "cpu", "--socket", sock],
        env=_clean_env(), stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, cwd=REPO, text=True,
    )
    deadline = time.time() + 120
    while time.time() < deadline and not os.path.exists(sock):
        if proc.poll() is not None:
            pytest.fail("server exited early")
        time.sleep(0.2)
    assert os.path.exists(sock), "server socket never appeared"
    assert proc.stdout.readline().startswith(f"[serve] ready on {sock} (device: cpu)")
    yield sock
    rep = try_forward({"cmd": "shutdown"}, socket_path=sock)
    if rep is None:
        proc.kill()
    proc.wait(timeout=30)
    assert rep == {"ok": True, "msg": "bye", "_shutdown": True}
    assert proc.returncode == 0 and not os.path.exists(sock)  # the socket is unlinked at exit


@pytest.fixture(autouse=True)
def _forwarding_on(monkeypatch):
    monkeypatch.delenv("JXL_TPU_TORCH_NO_SERVER", raising=False)


def test_server_ping(server):
    assert try_forward({"cmd": "ping"}, socket_path=server) == {"ok": True, "msg": "pong", "device": "cpu"}
    rep = try_forward({"cmd": "frobnicate"}, socket_path=server)
    assert rep == {"ok": False, "error": "unknown cmd 'frobnicate'"}


def test_server_encode_decode_roundtrip(server, tmp_path):
    img = make_test_image(48, 64, seed=21)
    src, jxt, back = (str(tmp_path / n) for n in ("in.png", "out.jxt", "back.png"))
    write_image(src, img)
    rep = try_forward({"cmd": "encode", "input": src, "output": jxt, "distance": 2.0, "effort": 3}, socket_path=server)
    assert rep and rep["ok"] and "bpp" in rep["msg"], rep
    with open(jxt, "rb") as f:
        data = f.read()
    assert data == encode_image(img, CodecConfig(distance=2.0, effort=3), "in.png", device="cpu")

    rep = try_forward({"cmd": "decode", "input": jxt, "output": back}, socket_path=server)
    assert rep and rep["ok"] and "64x48" in rep["msg"], rep
    out = read_image(back)
    np.testing.assert_array_equal(out, decode_bytes(data, device="cpu"))
    mse = np.mean((out.astype(np.float64) - img.astype(np.float64)) ** 2)
    assert 10 * np.log10(255.0**2 / mse) > 28.0

    striped = str(tmp_path / "s.jxt")
    rep = try_forward(
        {"cmd": "encode", "input": src, "output": striped, "distance": 2.0, "effort": 3, "stripes": 2}, socket_path=server
    )
    assert rep and rep["ok"], rep
    with open(striped, "rb") as f:
        sdata = f.read()
    assert is_striped(sdata)
    assert sdata == encode_image_striped(img, CodecConfig(distance=2.0, effort=3), 2, "in.png", device="cpu")


def test_cli_forwards_to_the_server(server, tmp_path, capsys, monkeypatch):
    """`encode` / `decode` through main(): forwarded when --device is the
    server's, local (same bytes) when it is not reachable."""
    img = make_test_image(32, 40, seed=5)
    src, a, b, back = (str(tmp_path / n) for n in ("in.png", "a.jxt", "b.jxt", "back.png"))
    write_image(src, img)
    monkeypatch.setenv("JXL_TPU_TORCH_SOCKET", server)
    assert main(["encode", src, a, "--device", "cpu", "--effort", "3"]) == 0
    fwd_line = capsys.readouterr().out
    assert main(["decode", a, back, "--device", "cpu"]) == 0
    capsys.readouterr()
    monkeypatch.setenv("JXL_TPU_TORCH_NO_SERVER", "1")
    assert main(["encode", src, b, "--device", "cpu", "--effort", "3"]) == 0
    local_line = capsys.readouterr().out
    with open(a, "rb") as fa, open(b, "rb") as fb:
        data = fa.read()
        assert data == fb.read()
    assert fwd_line.split(" bpp")[0].replace(a, "") == local_line.split(" bpp")[0].replace(b, "")
    np.testing.assert_array_equal(read_image(back), decode_bytes(data, device="cpu"))


def test_server_error_is_clean(server):
    rep = try_forward({"cmd": "decode", "input": "/nonexistent.jxt", "output": "/nonexistent.png"}, socket_path=server)
    assert rep is not None and not rep["ok"]
    assert rep["error"].startswith("FileNotFoundError")


def test_no_server_returns_none(server, tmp_path, monkeypatch):
    assert try_forward({"cmd": "ping"}, socket_path=str(tmp_path / "no.sock")) is None
    assert try_forward({"cmd": "ping"}, socket_path=str(tmp_path)) is None  # exists, not a socket
    # a client on another device than the server's runs locally
    assert try_forward({"cmd": "ping"}, socket_path=server, device="cuda:0") is None
    assert try_forward({"cmd": "ping"}, socket_path=server, device="cpu")["ok"]
    assert _same_device("cuda", "cuda:0") and _same_device("cpu:0", "cpu") and not _same_device("cuda:1", "cuda:0")
    monkeypatch.setenv("JXL_TPU_TORCH_NO_SERVER", "1")
    assert try_forward({"cmd": "ping"}, socket_path=server) is None


def test_server_survives_client_disconnect(server):
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(server)
    c.close()
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(server)
    c.sendall(b'{"cmd": "enc')
    c.close()
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(server)
    c.sendall(b"not json\n")
    assert json.loads(c.makefile("rb").readline())["ok"] is False
    c.close()
    assert try_forward({"cmd": "ping"}, socket_path=server)["ok"]


def test_codec_env_knobs_disable_forwarding(server, monkeypatch):
    """A client steering the codec via JXL_TPU_* env runs locally (the
    server's environment would otherwise govern the encode); the port's own
    socket name and the JAX package's transport switches are not codec knobs."""
    monkeypatch.setenv("JXL_TPU_MODULAR", "0")
    assert try_forward({"cmd": "ping"}, socket_path=server) is None
    monkeypatch.delenv("JXL_TPU_MODULAR")
    monkeypatch.setenv("JXL_TPU_EPF_FORCE", "1")
    assert try_forward({"cmd": "ping"}, socket_path=server) is None
    monkeypatch.delenv("JXL_TPU_EPF_FORCE")
    for name in ("JXL_TPU_PLATFORM", "JXL_TPU_TORCH_SOCKET", "JXL_TPU_CACHE_DIR"):
        monkeypatch.setenv(name, "x")
    assert try_forward({"cmd": "ping"}, socket_path=server)["ok"]


def test_client_imports_no_torch(server, tmp_path):
    """A fresh `encode` client that is forwarded never imports torch, and
    reaches the server through the port's own socket name."""
    img = make_test_image(32, 40, seed=6)
    src, out = str(tmp_path / "in.png"), str(tmp_path / "o.jxt")
    write_image(src, img)
    code = (
        "import sys\n"
        "from jxl_tpu_torch.cli.main import main\n"
        f"rc = main(['encode', {src!r}, {out!r}, '--device', 'cpu', '--effort', '3'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'numpy'))\n"
        "assert rc == 0 and not bad, (rc, bad)\n"
    )
    env = _clean_env(JXL_TPU_TORCH_SOCKET=server, JXL_TPU_SOCKET="/nonexistent/jax.sock")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    with open(out, "rb") as f:
        assert f.read() == encode_image(img, CodecConfig(effort=3), "in.png", device="cpu")


def test_handle_without_a_socket(tmp_path, monkeypatch):
    """The request handler itself, in process; and the default meeting
    point, which lies under the environment's temporary directory."""
    import tempfile

    monkeypatch.delenv("JXL_TPU_TORCH_SOCKET", raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    assert default_socket() == str(tmp_path / f"jxl_tpu_torch.{os.getuid()}.sock")
    monkeypatch.setenv("JXL_TPU_TORCH_SOCKET", str(tmp_path / "mine.sock"))
    assert default_socket() == str(tmp_path / "mine.sock")
    assert _handle({"cmd": "ping"}, "cpu") == {"ok": True, "msg": "pong", "device": "cpu"}
    assert _handle({"cmd": "shutdown"}, "cpu")["_shutdown"] is True
    assert _handle({}, "cpu") == {"ok": False, "error": "unknown cmd None"}
    with pytest.raises(KeyError):
        _handle({"cmd": "encode", "input": "x.png", "output": "y.jxt", "strategy": "NOPE"}, "cpu")
