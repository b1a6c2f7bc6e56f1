"""CLI — encode / decode / serve / bench / compare subcommands (port of
`jxl_tpu/cli/main.py`).

Every subcommand that computes takes a required `--device` (e.g.
`cuda:0` or `cpu`); there is no default and no fallback.

Usage:
  python -m jxl_tpu_torch encode in.png out.jxt --device cuda:0 --distance 1.0 --effort 7
  python -m jxl_tpu_torch encode big.ppm big.jxt --device cuda:0 --stripes 9
  python -m jxl_tpu_torch decode out.jxt back.png --device cuda:0
  python -m jxl_tpu_torch serve --device cuda:0 &
  python -m jxl_tpu_torch bench --device cuda:0 --test-image-dir ./test_images --grid rust
  python -m jxl_tpu_torch bench --device cuda:0 --mesh data=2
  python -m jxl_tpu_torch bench --device cuda:0 --strategy HOMOGENEITY_PARTITIONING --compare-to BASELINE
  python -m jxl_tpu_torch compare a/comparisons.csv b/comparisons.csv out_dir

`encode` and `decode` forward to a running `serve` process on the same
device when its socket exists (`cli/server.py`); `--stripes N` writes the
striped JXTS format (`codec/tiled.py`); `--mesh` encodes image batches
over a mesh of `--device` slots (`distributed/`).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

_PROC_T0 = time.perf_counter()


def _suggest_serve():
    """After a slow one-shot invocation, point at the persistent server
    (a fresh process pays torch's import, the device context and the
    kernels' build or load before any pixel moves)."""
    if time.perf_counter() - _PROC_T0 > 30 and not os.environ.get("JXL_TPU_TORCH_NO_SERVER"):
        print(
            "[hint] much of that was per-process start-up; run `python -m jxl_tpu_torch serve --device <device> &` "
            "once and repeat invocations skip it",
            file=sys.stderr,
        )


def _forwarded(rep) -> int:
    print(rep.get("msg") or rep.get("error"))
    return 0 if rep.get("ok") else 1


def _add_device_arg(p):
    p.add_argument("--device", required=True, help="torch device to compute on, e.g. cuda:0 or cpu (no default)")


def _add_codec_args(p):
    p.add_argument("--distance", type=float, default=1.0, help="quality (cjxl --distance analog)")
    p.add_argument("--effort", type=int, default=7, help="encode effort 1-9 (cjxl --effort analog)")
    p.add_argument(
        "--strategy",
        default="BASELINE",
        help="codec variant: BASELINE | HOMOGENEITY_PARTITIONING | HOMOGENEITY_FACTORED_ENTROPY | COMBINED | "
        "HOMOGENEITY_RD_GATED",
    )
    p.add_argument(
        "--lanes",
        type=int,
        default=256,
        help="interleaved rANS streams (128-multiple). The default 256 grows to 512/1024 for >= 2/4 MP images; "
        "any other value pins the count",
    )


def cmd_encode(args) -> int:
    # forward to a running server on the same device (`serve`): a fresh
    # process pays the whole start-up on every invocation
    from jxl_tpu_torch.cli.server import try_forward

    rep = try_forward(
        dict(
            cmd="encode", input=os.path.abspath(args.input), output=os.path.abspath(args.output),
            distance=args.distance, effort=args.effort, strategy=args.strategy, lanes=args.lanes,
            stripes=args.stripes,
        ),
        device=args.device,
    )
    if rep is not None:
        return _forwarded(rep)

    from jxl_tpu_torch.codec.config import CodecConfig, Strategy
    from jxl_tpu_torch.codec.encode import encode_file
    from jxl_tpu_torch.core.io import read_image

    cfg = CodecConfig(distance=args.distance, effort=args.effort, strategy=Strategy[args.strategy], lanes=args.lanes)
    t0 = time.perf_counter()
    if args.stripes:
        from jxl_tpu_torch.codec.tiled import encode_image_striped

        rgb = read_image(args.input)
        data = encode_image_striped(
            rgb, cfg, n_stripes=args.stripes, orig_name=os.path.basename(args.input), device=args.device
        )
        with open(args.output, "wb") as f:
            f.write(data)
        size, npx = len(data), rgb.shape[0] * rgb.shape[1]
    else:
        size = encode_file(args.input, args.output, cfg, device=args.device)
        npx = _pixels_of(args.output)
    dt = time.perf_counter() - t0
    print(f"{args.output}: {size} bytes, {size * 8 / npx:.3f} bpp, {npx / 1e6 / dt:.2f} MP/s")
    _suggest_serve()
    return 0


def _pixels_of(jxt_path: str) -> int:
    """Pixel count of a written .jxt, from its header alone (a JXTS
    wrapper's or a single section's)."""
    from jxl_tpu_torch.codec.container import read_container_header
    from jxl_tpu_torch.codec.tiled import is_striped, read_striped_header

    with open(jxt_path, "rb") as f:
        head = f.read(64 * 1024)
    if is_striped(head):
        height, width, _n = read_striped_header(head)
        return height * width
    hdr = read_container_header(head)
    return hdr.height * hdr.width


def cmd_decode(args) -> int:
    from jxl_tpu_torch.cli.server import try_forward

    rep = try_forward(
        dict(cmd="decode", input=os.path.abspath(args.input), output=os.path.abspath(args.output)),
        device=args.device,
    )
    if rep is not None:
        return _forwarded(rep)

    from jxl_tpu_torch.codec.decode import decode_file
    from jxl_tpu_torch.core.io import write_image

    t0 = time.perf_counter()
    rgb = decode_file(args.input, device=args.device)
    dt = time.perf_counter() - t0
    write_image(args.output, rgb)
    mp = rgb.shape[0] * rgb.shape[1] / 1e6
    print(f"{args.output}: {rgb.shape[1]}x{rgb.shape[0]}, {mp / dt:.2f} MP/s")
    _suggest_serve()
    return 0


def cmd_serve(args) -> int:
    from jxl_tpu_torch.cli.server import serve

    return serve(args.socket, device=args.device)


def cmd_bench(args) -> int:
    from jxl_tpu_torch.bench.sweep import SweepConfig

    # refuse what cannot run before any work: --graph without matplotlib,
    # a malformed --mesh, an unavailable device
    if args.graph:
        from jxl_tpu_torch.bench.plots import require_matplotlib

        require_matplotlib()
    cfg = SweepConfig(
        benchmark_dir=args.benchmark_dir,
        test_image_dir=args.test_image_dir,
        strategy=_strategy(args.strategy),
        mesh=args.mesh,
        decompress=args.decompress,
        compare_images=args.compare_images,
        device=args.device,
    )
    if args.compare_to:
        _strategy(args.compare_to)
    from jxl_tpu_torch.core.device import resolve_device

    dev = resolve_device(args.device)
    if not args.profile:
        return _cmd_bench_inner(args, cfg)
    # torch.profiler trace of the whole sweep (Chrome trace format), with
    # the codec's stage spans (recorded while the profiler runs) as a track
    from torch.profiler import ProfilerActivity, profile

    from jxl_tpu_torch.utils import trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    trace.drain()
    with profile(activities=acts) as prof:
        rc = _cmd_bench_inner(args, cfg)
    os.makedirs(args.profile, exist_ok=True)
    path = os.path.join(args.profile, "trace.json")
    prof.export_chrome_trace(path)
    n_dropped = trace.dropped()
    spans_path = trace.add_to_chrome_trace(path, trace.drain(), n_dropped)
    print(f"[bench] profiler trace written to {path}")
    if spans_path != path:
        print(f"[bench] stage spans written to {spans_path}")
    return rc


def _strategy(name: str):
    from jxl_tpu_torch.codec.config import Strategy

    return Strategy[name]


def _cmd_bench_inner(args, cfg) -> int:
    from dataclasses import replace

    from jxl_tpu_torch.bench.compare import compare_results
    from jxl_tpu_torch.bench.sweep import (
        LEGACY_DISTANCES,
        LEGACY_EFFORTS,
        RUST_DISTANCES,
        RUST_EFFORTS,
        SweepRunner,
        discover_test_sets,
    )

    bench_dir = args.benchmark_dir
    if args.temp:  # --temp: suffix the dir (main.rs:50-58)
        i = 0
        while os.path.exists(f"{bench_dir}-{i}"):
            i += 1
        bench_dir = f"{bench_dir}-{i}"
    if args.clean and os.path.exists(args.benchmark_dir):  # --clean (main.rs:61-66)
        shutil.rmtree(args.benchmark_dir)

    grid = {
        "rust": (RUST_DISTANCES, RUST_EFFORTS),
        "legacy": (LEGACY_DISTANCES, LEGACY_EFFORTS),
    }[args.grid]
    distances = tuple(args.distances) if args.distances else grid[0]
    efforts = tuple(args.efforts) if args.efforts else grid[1]

    cfg = replace(cfg, benchmark_dir=bench_dir, distances=distances, efforts=efforts)
    test_sets = discover_test_sets(args.test_image_dir)
    if not test_sets:
        print(f"no test sets under {args.test_image_dir}", file=sys.stderr)
        return 1
    runner = SweepRunner(cfg)

    strategies = [cfg.strategy]
    if args.compare_to:
        strategies.append(_strategy(args.compare_to))

    for ts in test_sets:
        csvs = []
        for strat in strategies:
            runner.run_test_set(ts, strat)
            csvs.append(runner.comparisons_csv(ts, strat))
            if args.graph:
                from jxl_tpu_torch.bench.plots import boxplot_size_percent, rd_curves

                base = runner.out_dirs(ts, strat)["results"]
                boxplot_size_percent(csvs[-1], os.path.join(base, "boxplot.png"))
                rd_curves(csvs[-1], os.path.join(base, "rd_curves.png"))
        if len(csvs) == 2:  # exactly-2 rule (benchmark.rs:554-563)
            out = os.path.join(runner.run_dir, ts)
            diffs, summary = compare_results(csvs[0], csvs[1], out)
            print(f"[bench] wrote {diffs} and {summary}")
    print(f"[bench] run dir: {runner.run_dir}")
    return 0


def cmd_compare(args) -> int:
    from jxl_tpu_torch.bench.compare import compare_results

    diffs, summary = compare_results(args.csv1, args.csv2, args.out_dir)
    print(f"wrote {diffs}\nwrote {summary}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="jxl_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("encode", help="encode an image to .jxt")
    pe.add_argument("input")
    pe.add_argument("output")
    pe.add_argument(
        "--stripes",
        type=int,
        default=0,
        help="encode as N independent full-height stripes (the striped JXTS container; 0 = single-section)",
    )
    _add_device_arg(pe)
    _add_codec_args(pe)
    pe.set_defaults(fn=cmd_encode)

    pd = sub.add_parser("decode", help="decode a .jxt to an image")
    pd.add_argument("input")
    pd.add_argument("output")
    _add_device_arg(pd)
    pd.set_defaults(fn=cmd_decode)

    ps = sub.add_parser(
        "serve",
        help="persistent codec server: later encode/decode invocations on the same --device forward over a unix "
        "socket instead of paying start-up per process (JXL_TPU_TORCH_NO_SERVER=1 opts a client out)",
    )
    ps.add_argument("--socket", default=None, help="unix socket path (default: $JXL_TPU_TORCH_SOCKET, else a per-user name under the temporary directory)")
    _add_device_arg(ps)
    ps.set_defaults(fn=cmd_serve)

    pb = sub.add_parser("bench", help="run the RD sweep benchmark")
    pb.add_argument("--benchmark-dir", default="./benchmarks")
    pb.add_argument("--test-image-dir", default="./test_images")
    pb.add_argument("--clean", action="store_true", help="delete benchmark dir first")
    pb.add_argument("--temp", action="store_true", help="use a fresh suffixed dir")
    pb.add_argument("--grid", choices=("rust", "legacy"), default="rust")
    pb.add_argument("--distances", type=float, nargs="*", default=None)
    pb.add_argument("--efforts", type=int, nargs="*", default=None)
    pb.add_argument("--compare-to", default=None, help="second strategy for A/B diff")
    pb.add_argument("--graph", action="store_true", help="write boxplots + RD curves (needs matplotlib)")
    pb.add_argument("--decompress", action="store_true", help="write decoded PNGs + decompressed-size table")
    pb.add_argument("--compare-images", action="store_true", help="write amplified |orig-decoded| diff images")
    pb.add_argument(
        "--mesh", default=None, metavar="SPEC",
        help="encode image batches across a mesh of --device slots, e.g. 'data=4' or 'data=4,space=2' (images over "
        "data, width over space)",
    )
    pb.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a torch.profiler Chrome trace of the sweep, with the codec's stage spans as a track, into DIR",
    )
    _add_device_arg(pb)
    _add_codec_args(pb)
    pb.set_defaults(fn=cmd_bench)

    pc = sub.add_parser("compare", help="diff two comparisons.csv files")
    pc.add_argument("csv1")
    pc.add_argument("csv2")
    pc.add_argument("out_dir")
    pc.set_defaults(fn=cmd_compare)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
