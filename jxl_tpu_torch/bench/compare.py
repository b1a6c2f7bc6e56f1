"""A/B comparison of two sweep runs — `compare_results` parity (port of
`jxl_tpu/bench/compare.py`, output byte-identical to it).

Reference: `benchmark.rs:723-871`. Reads two comparisons.csv files (two
codec variants), sorts rows by original image name, asserts row alignment
(same image/distance/effort per row), writes per-row metric diffs (r2 - r1)
to `comparison_diffs.csv` and the mean over all rows to `summary.csv` —
the thesis's judgment artifact.
"""

from __future__ import annotations

import os

from jxl_tpu_torch.bench.csv_schema import (
    COMPARISON_DIFF_HEADER,
    ComparisonResult,
    ComparisonResultDiff,
    append_rows,
    comparison_result_from_row,
    read_csv_rows,
    write_csv_header,
)

_DIFF_FIELDS = [
    ("diff_orig_file_size", "orig_file_size"),
    ("diff_comp_file_size", "comp_file_size"),
    ("diff_orig_raw_size", "orig_raw_size"),
    ("diff_comp_raw_size", "comp_raw_size"),
    ("diff_comp_file_size_ratio", "comp_file_size_ratio"),
    ("diff_raw_file_size_ratio", "raw_file_size_ratio"),
    ("diff_mse", "mse"),
    ("diff_psnr", "psnr"),
    ("diff_ssim", "ssim"),
    ("diff_ms_ssim", "ms_ssim"),
    ("diff_butteraugli", "butteraugli"),
    ("diff_butteraugli_pnorm", "butteraugli_pnorm"),
    ("diff_ssimulacra2", "ssimulacra2"),
]


def _read_results(path: str) -> list[ComparisonResult]:
    _, rows = read_csv_rows(path)
    return [comparison_result_from_row(r) for r in rows]


def compare_results(csv_1: str, csv_2: str, out_dir: str) -> tuple[str, str]:
    """Diff two runs' comparisons.csv; returns (diffs_path, summary_path)."""
    r1 = _read_results(csv_1)
    r2 = _read_results(csv_2)
    key = lambda r: (r.orig_image_name, r.distance, r.effort)  # noqa: E731
    r1.sort(key=key)
    r2.sort(key=key)
    if len(r1) != len(r2):
        raise ValueError(f"row count mismatch: {len(r1)} vs {len(r2)}")

    diffs = []
    for a, b in zip(r1, r2):
        if key(a) != key(b):
            raise ValueError(f"row mismatch: {key(a)} vs {key(b)}")
        d = ComparisonResultDiff(
            orig_image_name=a.orig_image_name,
            comp_image_name=a.comp_image_name,
            distance=a.distance,
            effort=a.effort,
        )
        for df, sf in _DIFF_FIELDS:
            setattr(d, df, getattr(b, sf) - getattr(a, sf))
        diffs.append(d)

    os.makedirs(out_dir, exist_ok=True)
    diffs_path = os.path.join(out_dir, "comparison_diffs.csv")
    summary_path = os.path.join(out_dir, "summary.csv")

    write_csv_header(diffs_path, COMPARISON_DIFF_HEADER)
    append_rows(diffs_path, [d.row() for d in diffs])

    # summary = mean over rows of every numeric diff (benchmark.rs:801-851)
    summary = ComparisonResultDiff(
        orig_image_name="MEAN",
        comp_image_name="MEAN",
        distance=0.0,
        effort=0,
    )
    n = max(1, len(diffs))
    for df, _ in _DIFF_FIELDS:
        setattr(summary, df, sum(getattr(d, df) for d in diffs) / n)
    write_csv_header(summary_path, COMPARISON_DIFF_HEADER)
    append_rows(summary_path, [summary.row()])
    return diffs_path, summary_path
