"""Stage-level codec profiler (port of `tools/profile_codec.py`).

Usage: python -m jxl_tpu_torch.tools.profile_codec [HxW] [--device cuda:0]

Times, on the given device, the bench image (`bench.headline.synth_kodak`)
of that size (default 512x768) at d=1, e7:
  - encoder stage 1 (pixels -> tokens, `encode_tokens_for_analysis`)
  - the entropy tail: the tables (`entropy_inputs`: padding, stepped
    histogram, clustering, 12-bit tables) and the rANS encode with its
    mantissa pack (kernel B3, one launch does both)
  - the full encode (`encode_image`), and its steady state with four
    encodes in flight (`encode_image_async`, eight images)
  - the device-resident decode (`decode_bytes_device`) and its
    reconstruction alone (from decoded values)
Rows as in `jxl_tpu_torch.tools.stage_time`: median warm wall, and on CUDA
busy ms and kernels of a traced run.
"""

from __future__ import annotations

import time

import numpy as np

from jxl_tpu_torch.tools import card_line, parse, parser, stage_row, stage_time, sync

STAGES = (
    "stage1: pixels -> tokens",
    "entropy inputs: tables",
    "rANS encode + mantissa pack (B3)",
    "full encode (single, incl host)",
    "pipelined encode steady state",
    "decode (device-resident)",
    "decode reconstruction",
)
DEPTH = 4  # encodes in flight in the steady-state row
N_PIPE = 8  # images through the steady-state row


def pipelined_ms(img, cfg, dev, n: int = N_PIPE, depth: int = DEPTH) -> float:
    """Milliseconds per image of n encodes with up to `depth` finalizers
    pending (the oldest finalized when the window is full), after two warm
    ones; ends in a synchronise."""
    from jxl_tpu_torch.codec.encode import encode_image_async

    for _ in range(2):
        encode_image_async(img, cfg, device=dev)()
    sync(dev)
    t0 = time.perf_counter()
    pending = []
    for _ in range(n):
        pending.append(encode_image_async(img, cfg, device=dev))
        if len(pending) == depth:
            pending.pop(0)()
    for fin in pending:
        fin()
    sync(dev)
    return (time.perf_counter() - t0) / n * 1e3


def profile(img: np.ndarray, dev, reps: int = 5) -> dict:
    """{"stages": {name: stage_time dict}, "bytes": encode_image's container,
    "lanes"}; the steady-state row holds only "ms" (per image)."""
    from jxl_tpu_torch.codec.analysis import encode_tokens_for_analysis
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.container import read_container
    from jxl_tpu_torch.codec.decode import _reconstruct_stream, decode_bytes_device, decode_values
    from jxl_tpu_torch.codec.encode import _step_ctx_v8, encode_image, encoder_knobs, entropy_inputs, pick_lanes
    from jxl_tpu_torch.codec.layout import padded_layout, token_layout
    from jxl_tpu_torch.entropy.cuda_rans_enc import enc_caps, encode_grouped_cuda

    h, w = img.shape[:2]
    cfg = CodecConfig(distance=1.0, effort=7)
    lanes = pick_lanes(token_layout(h, w)["n_tokens"], cfg.lanes)
    lay = padded_layout(h, w, lanes)
    T = lay["T"]
    capw, capm = enc_caps(T, lanes)

    def stage1():
        return encode_tokens_for_analysis(img, 1.0, height=h, width=w, device=dev)

    stages = {"stage1: pixels -> tokens": stage_time(stage1, dev, reps)}
    token, _nbits, mant, _params, q_sorted = stages["stage1: pixels -> tokens"]["out"]
    step_ctx = _step_ctx_v8(lay, q_sorted)
    greedy = not encoder_knobs().no_greedy
    stages["entropy inputs: tables"] = stage_time(
        lambda: entropy_inputs(token, mant, step_ctx, lay, lanes, greedy=greedy), dev, reps
    )
    tokp, mantp, rows, _freq = stages["entropy inputs: tables"]["out"]
    stages["rANS encode + mantissa pack (B3)"] = stage_time(
        lambda: encode_grouped_cuda(tokp, mantp, rows, T=T, lanes=lanes, capw=capw, capm=capm), dev, reps
    )
    stages["full encode (single, incl host)"] = stage_time(lambda: encode_image(img, cfg, device=dev), dev, reps)
    stages["pipelined encode steady state"] = {
        "ms": pipelined_ms(img, cfg, dev), "min_ms": None, "busy_ms": None, "kernels": None, "out": None,
    }
    data = stages["full encode (single, incl host)"]["out"]
    stream = read_container(data)
    stages["decode (device-resident)"] = stage_time(lambda: decode_bytes_device(data, device=dev), dev, reps)
    values = decode_values(stream, dev)
    stages["decode reconstruction"] = stage_time(lambda: _reconstruct_stream(values, stream), dev, reps)
    return {"stages": stages, "bytes": data, "lanes": lanes}


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("size", nargs="?", default="512x768", help="HxW")
    args = parse(ap, argv)

    from jxl_tpu_torch.bench.headline import synth_kodak

    h, w = (int(v) for v in args.size.split("x"))
    mp = h * w / 1e6
    print(f"device={card_line(args.dev)} image={h}x{w} ({mp:.2f} MP)")
    res = profile(synth_kodak(h, w), args.dev)
    st = res["stages"]
    for name in STAGES:
        note = f"({mp / st[name]['ms'] * 1e3:.1f} MP/s)" if name == "pipelined encode steady state" else ""
        print(stage_row(name, st[name], note))
    t_full, t_dec = st["full encode (single, incl host)"]["ms"], st["decode (device-resident)"]["ms"]
    print(f"encode {mp / t_full * 1e3:.1f} MP/s single, decode {mp / t_dec * 1e3:.1f} MP/s")
    return res


if __name__ == "__main__":
    main()
