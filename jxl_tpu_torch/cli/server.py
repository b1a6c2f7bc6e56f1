"""Persistent codec server (port of `jxl_tpu/cli/server.py`).

A fresh `python -m jxl_tpu_torch encode/decode` process pays its fixed
cost before any pixel moves: importing torch, creating the CUDA context
and building or loading the kernels. The server keeps one process, its
device context and its loaded kernels alive behind a unix socket; later
`encode` / `decode` invocations forward to it when the socket exists and
pay only a light client process that imports no torch, plus the codec
work itself.

  python -m jxl_tpu_torch serve --device cuda:0 [--socket PATH] &
  python -m jxl_tpu_torch encode in.png out.jxt --device cuda:0   # forwarded
  JXL_TPU_TORCH_NO_SERVER=1 python -m jxl_tpu_torch encode ...    # force local

The server owns the device: a forwarded request carries none, and a
client whose `--device` differs from the server's (the `ping` reply names
it) runs locally instead. The socket and the opt-out switch are the
port's own (`JXL_TPU_TORCH_SOCKET`, `JXL_TPU_TORCH_NO_SERVER`), so a
client of `jxl_tpu` never reaches this server nor the reverse. With no
path given, server and client meet at `default_socket()`: a per-user name
in the temporary directory of their environment (`TMPDIR`), so processes
under different temporary directories never meet by accident.

Protocol: one JSON request line per connection
  {"cmd": "encode"|"decode"|"ping"|"shutdown", ...}
reply: {"ok": true, "msg": "..."} | {"ok": false, "error": "..."}.
Paths are resolved server-side: client and server share a filesystem.
"""

from __future__ import annotations

import json
import os
import socket
import tempfile
import time


def default_socket() -> str:
    """$JXL_TPU_TORCH_SOCKET, else jxl_tpu_torch.<uid>.sock in the
    temporary directory (`tempfile.gettempdir()`, which honours TMPDIR).
    Read at call time, not at import."""
    return os.environ.get("JXL_TPU_TORCH_SOCKET") or os.path.join(
        tempfile.gettempdir(), f"jxl_tpu_torch.{os.getuid()}.sock"
    )


# JXL_TPU_* names that do not steer the codec: set in a client's
# environment, they leave forwarding on
_NON_CODEC_ENV = {
    "JXL_TPU_TORCH_NO_SERVER", "JXL_TPU_TORCH_SOCKET",
    # the JAX package's transport and cache switches, which the port never reads
    "JXL_TPU_NO_SERVER", "JXL_TPU_SOCKET", "JXL_TPU_PLATFORM", "JXL_TPU_CACHE_DIR", "JXL_TPU_NO_CACHE",
    "JXL_TPU_CPU_DEVICES",
}


def _handle(req: dict, device) -> dict:
    cmd = req.get("cmd")
    if cmd == "ping":
        return {"ok": True, "msg": "pong", "device": str(device)}
    if cmd == "encode":
        from jxl_tpu_torch.codec.config import CodecConfig, Strategy
        from jxl_tpu_torch.core.io import read_image

        cfg = CodecConfig(
            distance=float(req.get("distance", 1.0)),
            effort=int(req.get("effort", 7)),
            strategy=Strategy[req.get("strategy", "BASELINE")],
            lanes=int(req.get("lanes", 256)),
        )
        rgb = read_image(req["input"])
        t0 = time.perf_counter()
        if int(req.get("stripes", 0)):
            from jxl_tpu_torch.codec.tiled import encode_image_striped

            data = encode_image_striped(
                rgb, cfg, n_stripes=int(req["stripes"]), orig_name=os.path.basename(req["input"]), device=device
            )
            with open(req["output"], "wb") as f:
                f.write(data)
            size = len(data)
        else:
            from jxl_tpu_torch.codec.encode import encode_file

            size = encode_file(req["input"], req["output"], cfg, device=device)
        dt = time.perf_counter() - t0
        h, w = rgb.shape[:2]
        return {
            "ok": True,
            "msg": f"{req['output']}: {size} bytes, {size * 8 / (h * w):.3f} bpp, {h * w / 1e6 / dt:.2f} MP/s",
        }
    if cmd == "decode":
        from jxl_tpu_torch.codec.decode import decode_file
        from jxl_tpu_torch.core.io import write_image

        t0 = time.perf_counter()
        px = decode_file(req["input"], device=device)
        dt = time.perf_counter() - t0
        write_image(req["output"], px)
        h, w = px.shape[:2]
        return {"ok": True, "msg": f"{req['output']}: {w}x{h}, {h * w / 1e6 / dt:.2f} MP/s"}
    if cmd == "shutdown":
        return {"ok": True, "msg": "bye", "_shutdown": True}
    return {"ok": False, "error": f"unknown cmd {cmd!r}"}


def serve(socket_path: str | None = None, *, device, warm: bool = True) -> int:
    """Serve requests on `socket_path` (default `default_socket()`), computing on `device`, until a
    `shutdown` request. `warm` runs one tiny op on the device first and, on
    CUDA, builds and loads the kernels, so the first request pays neither."""
    from jxl_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    socket_path = socket_path or default_socket()
    if warm:
        import torch

        torch.add(torch.ones((), device=dev), 1.0).item()
        if dev.type == "cuda":
            from jxl_tpu_torch.cuda_build import load

            for name in ("rans_dec", "rans_enc"):
                load(name)
    try:
        os.unlink(socket_path)
    except FileNotFoundError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(socket_path)
    srv.listen(4)
    print(f"[serve] ready on {socket_path} (device: {dev}{'' if warm else ', lazy'})", flush=True)
    try:
        while True:
            conn, _ = srv.accept()
            with conn:
                try:
                    # a silent client must not wedge the single-threaded
                    # accept loop; codec work itself runs with no deadline
                    conn.settimeout(10.0)
                    f = conn.makefile("rwb")
                    line = f.readline()
                    if not line:
                        continue
                    conn.settimeout(None)
                    try:
                        rep = _handle(json.loads(line), dev)
                    except Exception as e:  # clean error back to the client
                        rep = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                    f.write((json.dumps(rep) + "\n").encode())
                    f.flush()
                    if rep.get("_shutdown"):
                        return 0
                except OSError:
                    # client vanished mid-request (Ctrl-C, kill, timeout):
                    # drop the connection, keep serving
                    continue
    finally:
        srv.close()
        try:
            os.unlink(socket_path)
        except FileNotFoundError:
            pass


def _request(req: dict, socket_path: str):
    """One request / reply exchange; None when no server answers."""
    try:
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.settimeout(5.0)
        c.connect(socket_path)
        c.settimeout(3600.0)  # codec work can legitimately take a while
        f = c.makefile("rwb")
        f.write((json.dumps(req) + "\n").encode())
        f.flush()
        line = f.readline()
        c.close()
        return json.loads(line) if line else None
    except (OSError, json.JSONDecodeError):
        return None


def try_forward(req: dict, socket_path: str | None = None, device=None):
    """Forward a request to a running server (at `socket_path`, default
    `default_socket()`); returns the reply dict, or
    None when the caller should run locally: no server is reachable,
    forwarding is switched off, or `device` (the client's --device) is not
    the one the server computes on. The client side imports no torch:
    skipping its start-up is the whole point."""
    if os.environ.get("JXL_TPU_TORCH_NO_SERVER"):
        return None
    # A/B and calibration workflows steer the codec with JXL_TPU_* knobs;
    # the SERVER's environment would govern a forwarded request instead.
    # Any codec knob set client-side disables forwarding, so the
    # invocation runs locally under the requested configuration.
    if any(k.startswith("JXL_TPU_") and k not in _NON_CODEC_ENV for k in os.environ):
        return None
    socket_path = socket_path or default_socket()
    if not os.path.exists(socket_path):
        return None
    if device is not None:
        pong = _request({"cmd": "ping"}, socket_path)
        if pong is None or not _same_device(str(device), pong.get("device", "")):
            return None
    return _request(req, socket_path)


def _same_device(a: str, b: str) -> bool:
    """Device names equal, with a bare type meaning its index 0 ("cuda" is
    "cuda:0"; every "cpu" is the same device)."""

    def norm(s: str) -> str:
        if s.startswith("cpu"):
            return "cpu"
        return s if ":" in s else f"{s}:0"

    return norm(a) == norm(b)
