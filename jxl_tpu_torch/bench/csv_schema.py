"""CSV schemas — column-exact parity with `benchmark-jpegxl/src/csv_writer.rs`.

Three record types, same columns in the same order:
- ImageFileData: 13 cols (`csv_writer.rs:455-469`)
- ComparisonResult: 17 cols (`csv_writer.rs:125-143`)
- ComparisonResultDiff: 17 cols (`csv_writer.rs:193-211`)

Same write semantics as the reference: headers are written idempotently
(only when the file is missing/empty, `csv_writer.rs:114-123`), rows are
appended. Unlike the reference — where six worker threads append to the same
CSV with no lock (`benchmark.rs:628-633,693-699`, flagged as an interleaving
hazard in SURVEY §5.2) — all writes in this framework flow through a single
writer in the sweep runner.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, fields
from typing import Optional

IMAGE_FILE_DATA_HEADER = [
    "Image Name",
    "Commit",
    "Test Set",
    "File Path",
    "Image Width",
    "Image Height",
    "File Size",
    "Raw Image Size",
    "Image Color Space",
    "File Format",
    "JXL Original Image Name",
    "JXL Distance",
    "JXL Effort",
]

COMPARISON_RESULT_HEADER = [
    "Original Image Name",
    "Compressed Image Name",
    "Distance",
    "Effort",
    "Original File Size",
    "Compressed File Size",
    "Original Raw Size",
    "Compressed Raw Size",
    "File Size Ratio",
    "Raw Size Ratio",
    "MSE",
    "PSNR",
    "SSIM",
    "MS-SSIM",
    "Butteraugli",
    "Butteraugli 3-Norm",
    "SSIMULACRA2",
]

COMPARISON_DIFF_HEADER = [
    "Original Image Name",
    "Compressed Image Name",
    "Distance",
    "Effort",
    "Diff Original File Size",
    "Diff Compressed File Size",
    "Diff Original Raw Size",
    "Diff Compressed Raw Size",
    "Diff File Size Ratio",
    "Diff Raw Size Ratio",
    "Diff MSE",
    "Diff PSNR",
    "Diff SSIM",
    "Diff MS-SSIM",
    "Diff Butteraugli",
    "Diff Butteraugli 3-Norm",
    "Diff SSIMULACRA2",
]


@dataclass
class ComparisonResult:
    """One (image, distance, effort) sweep point — 17-column record."""

    orig_image_name: str = ""
    comp_image_name: str = ""
    distance: float = 0.0
    effort: int = 0
    orig_file_size: int = 0
    comp_file_size: int = 0
    orig_raw_size: int = 0
    comp_raw_size: int = 0
    comp_file_size_ratio: float = 0.0
    raw_file_size_ratio: float = 0.0
    mse: float = 0.0
    psnr: float = 0.0
    ssim: float = 0.0
    ms_ssim: float = 0.0
    butteraugli: float = 0.0
    butteraugli_pnorm: float = 0.0
    ssimulacra2: float = 0.0

    def row(self) -> list:
        return [getattr(self, f.name) for f in fields(self)]

    NUMERIC_FIELDS = (
        "orig_file_size",
        "comp_file_size",
        "orig_raw_size",
        "comp_raw_size",
        "comp_file_size_ratio",
        "raw_file_size_ratio",
        "mse",
        "psnr",
        "ssim",
        "ms_ssim",
        "butteraugli",
        "butteraugli_pnorm",
        "ssimulacra2",
    )


@dataclass
class ComparisonResultDiff:
    """Row-wise metric difference between two runs (r2 - r1),
    `benchmark.rs:741-799` semantics."""

    orig_image_name: str = ""
    comp_image_name: str = ""
    distance: float = 0.0
    effort: int = 0
    diff_orig_file_size: float = 0.0
    diff_comp_file_size: float = 0.0
    diff_orig_raw_size: float = 0.0
    diff_comp_raw_size: float = 0.0
    diff_comp_file_size_ratio: float = 0.0
    diff_raw_file_size_ratio: float = 0.0
    diff_mse: float = 0.0
    diff_psnr: float = 0.0
    diff_ssim: float = 0.0
    diff_ms_ssim: float = 0.0
    diff_butteraugli: float = 0.0
    diff_butteraugli_pnorm: float = 0.0
    diff_ssimulacra2: float = 0.0

    def row(self) -> list:
        return [getattr(self, f.name) for f in fields(self)]


def write_csv_header(path: str, header: list) -> None:
    """Idempotent header write (reference: `csv_writer.rs:114-123`)."""
    if os.path.exists(path) and os.path.getsize(path) > 0:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        csv.writer(f).writerow(header)


def append_rows(path: str, rows: list) -> None:
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        for r in rows:
            w.writerow(r)


def read_csv_rows(path: str) -> tuple[list, list]:
    """Returns (header, rows) as lists of strings."""
    with open(path, newline="") as f:
        r = list(csv.reader(f))
    if not r:
        return [], []
    return r[0], r[1:]


def find_entry(path: str, column: str, value: str) -> Optional[list]:
    """Row lookup by column value (reference: `csv_writer.rs:283-319`)."""
    header, rows = read_csv_rows(path)
    if column not in header:
        return None
    idx = header.index(column)
    for row in rows:
        if row[idx] == value:
            return row
    return None


def comparison_result_from_row(row: list) -> ComparisonResult:
    return ComparisonResult(
        orig_image_name=row[0],
        comp_image_name=row[1],
        distance=float(row[2]),
        effort=int(row[3]),
        orig_file_size=int(float(row[4])),
        comp_file_size=int(float(row[5])),
        orig_raw_size=int(float(row[6])),
        comp_raw_size=int(float(row[7])),
        comp_file_size_ratio=float(row[8]),
        raw_file_size_ratio=float(row[9]),
        mse=float(row[10]),
        psnr=float(row[11]),
        ssim=float(row[12]),
        ms_ssim=float(row[13]),
        butteraugli=float(row[14]),
        butteraugli_pnorm=float(row[15]),
        ssimulacra2=float(row[16]),
    )
