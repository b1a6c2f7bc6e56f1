"""Readings that the judge's limits are set from, for one cell, on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11 12 13 --seconds 5 [--sides ...] [--out FILE]

For each seed, in one process (set-up is paid once): the cell's images for
that seed, a short window of the cell's own loop at its own load, and the
judge's numbers over the requests it keeps, for each side:

- "program": the program's readings, the lower end of each limit;
- "fp32_reordered": the frozen reference in the program's place with its
  DCT products and filter passes in another order, a sound float32
  variant, also a lower-end reading;
- "control": the reference in the program's place with every DCT operand
  rounded to TF32 and the battery's filters in bfloat16, one step below
  the float32 that the configurations state: the upper end;
- "word_fault": one rANS word in the middle of each kept container
  flipped, decoded by the program: a fault of the encode kernel's output.

One JSON line per seed and side goes to standard output and, with --out, to
that file. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def word_fault(judge, p, dev):
    """The point with one rANS word of its container flipped, decoded by the
    program."""
    from jxl_tpu_torch.codec.decode import decode_bytes_device

    from perfbench.reference.container import read_container, write_container

    s = read_container(p.container)
    w = bytearray(s.stream_words)
    mid = (len(w) // 4) * 2
    w[mid] ^= 0x55
    s.stream_words = bytes(w)
    data = write_container(s)
    return judge.Point(p.orig, p.distance, p.effort, decode_bytes_device(data, device=dev), p.strategy,
                       container=data, battery=p.battery)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda:0")
    sides = ["program", "fp32_reordered", "control", "word_fault"]
    ap.add_argument("--sides", nargs="+", default=sides, choices=sides)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import harness, load

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("[calibrate] no CUDA card", file=sys.stderr)
        return 1
    cell = harness.resolve(ROOT, harness.load_manifest(ROOT), args.workload)
    judge = harness.judge_of(cell)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            images = harness.images_of(cell, seed, dev)
            loop = harness.make_loop(cell, images, dev)
            if seed == args.seeds[0]:
                loop.warm()
            sample = load.Reservoir(int(cell.config.get("judged", harness.JUDGED)), seed)
            win = load.run_window(loop, args.seconds, sample)
            points = harness.points_of(judge, sample.items, images)
            for side in args.sides:
                t0 = time.perf_counter()
                if side == "program":
                    pts = points
                elif side == "word_fault":
                    pts = [word_fault(judge, p, dev) for p in points]
                else:
                    pts = judge.control_points(points, side)
                rec = {"workload": args.workload, "seed": seed, "side": side, "judged": len(pts),
                       "window_units": win.units, "failed": win.failed, **judge.judge(pts, detail=True),
                       "judge_s": round(time.perf_counter() - t0, 2)}
                line = json.dumps(rec)
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
