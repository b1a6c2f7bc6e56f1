"""Fresh-process latency attribution (port of `tools/profile_startup.py`).

Stamps the wall clock at every phase of one fresh process that encodes or
decodes a file on the given device, so a cold CLI call's seconds can be
attributed:

  python -m jxl_tpu_torch.tools.profile_startup in.jxt            # decode profile
  python -m jxl_tpu_torch.tools.profile_startup --encode in.png   # encode profile
  python -m jxl_tpu_torch.tools.profile_startup                   # encode of the bench image

Phases: import torch, import the port, device context (on CUDA the first
allocation creates it), first tiny launch, the rANS kernels' build or load
(`cuda_build.load`; nothing to build on the CPU, where the plain versions
run), read the input, first and second encode / decode, write the output
(under benchmarks/tools/profile_startup/ unless --out). Prints one JSON
line: {"total_s", "phase_s": {phase: seconds since the previous mark},
"device": the card's name and power limit, or "cpu"}.
"""

import time
from pathlib import Path

T0 = time.perf_counter()
MARKS = [("proc_start", 0.0)]
OUT = str(Path(__file__).resolve().parents[2] / "benchmarks" / "tools" / "profile_startup")


def mark(name):
    MARKS.append((name, time.perf_counter() - T0))


def main(argv=None):
    import json
    import os

    from jxl_tpu_torch.tools import card_line, parser

    ap = parser(__doc__)
    ap.add_argument("path", nargs="?", help="input: a .jxt to decode, or an image with --encode")
    ap.add_argument("--encode", action="store_true")
    ap.add_argument("--out", help="output file (default under benchmarks/tools/profile_startup/)")
    args = ap.parse_args(argv)
    encode_mode = args.encode or args.path is None

    import torch  # noqa: F401

    mark("import_torch")
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.container import read_container
    from jxl_tpu_torch.codec.decode import decode_stream
    from jxl_tpu_torch.codec.encode import encode_image
    from jxl_tpu_torch.core.device import resolve_device
    from jxl_tpu_torch.core.io import read_image, write_image

    mark("import_jxl_tpu_torch")
    dev = resolve_device(args.device)
    torch.empty(1, device=dev)
    mark(f"device_context[{dev.type}]")
    torch.add(torch.ones((), device=dev), 1.0).cpu()
    mark("first_tiny_launch")
    if dev.type == "cuda":
        from jxl_tpu_torch.cuda_build import load

        load("rans_enc")
        load("rans_dec")
    mark("kernel_build_or_load")

    if encode_mode:
        if args.path is None:
            from jxl_tpu_torch.bench.headline import synth_kodak

            rgb = synth_kodak()
        else:
            rgb = read_image(args.path)
        mark("read_input")
        data = encode_image(rgb, CodecConfig(distance=1.0), device=dev)
        mark("encode_1_first")
        encode_image(rgb, CodecConfig(distance=1.0), device=dev)
        mark("encode_2_steady")
        out = args.out or os.path.join(OUT, f"profile_startup_{os.getpid()}.jxt")
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "wb") as f:
            f.write(data)
        mark("write_output")
    else:
        with open(args.path, "rb") as f:
            blob = f.read()
        stream = read_container(blob)
        mark("read+parse_container")
        px = decode_stream(stream, device=dev)
        mark("decode_1_first")
        decode_stream(stream, device=dev)
        mark("decode_2_steady")
        out = args.out or os.path.join(OUT, f"profile_startup_{os.getpid()}.png")
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        write_image(out, px)
        mark("write_output")

    deltas = {n1: t1 - t0 for (_n0, t0), (n1, t1) in zip(MARKS, MARKS[1:])}
    res = {"total_s": MARKS[-1][1], "phase_s": deltas, "device": card_line(dev)}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
