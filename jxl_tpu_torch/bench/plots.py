"""Plotting (port of `jxl_tpu/bench/plots.py`): size-% boxplots grouped by
effort and faceted by distance, and PSNR-vs-bpp rate-distortion curves per
effort.

matplotlib is imported inside the functions: the machine that runs the
port on the card has none, and the sweep itself never needs it.
`require_matplotlib` lets a caller refuse `--graph` before any work.
"""

from __future__ import annotations

import os

from jxl_tpu_torch.bench.csv_schema import comparison_result_from_row, read_csv_rows


def require_matplotlib() -> None:
    """Raise RuntimeError unless matplotlib imports."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise RuntimeError("--graph needs matplotlib, which is not installed") from e


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _load(path: str):
    _, rows = read_csv_rows(path)
    return [comparison_result_from_row(r) for r in rows]


def boxplot_size_percent(comparisons_csv: str, out_path: str, title: str = "") -> str:
    """Size-% of original grouped by effort, faceted by distance (dpi=300)."""
    plt = _pyplot()
    results = _load(comparisons_csv)
    distances = sorted({r.distance for r in results})
    ncol = 3
    nrow = -(-len(distances) // ncol)
    fig, axes = plt.subplots(nrow, ncol, figsize=(4 * ncol, 3 * nrow), squeeze=False)
    for i, d in enumerate(distances):
        ax = axes[i // ncol][i % ncol]
        efforts = sorted({r.effort for r in results if r.distance == d})
        data = [
            [100.0 * r.comp_file_size / max(1, r.orig_file_size) for r in results if r.distance == d and r.effort == e]
            for e in efforts
        ]
        ax.boxplot(data, tick_labels=[str(e) for e in efforts])
        ax.set_title(f"distance={d}")
        ax.set_xlabel("effort")
        ax.set_ylabel("size % of original")
    for j in range(len(distances), nrow * ncol):
        axes[j // ncol][j % ncol].axis("off")
    fig.suptitle(title or os.path.basename(comparisons_csv))
    fig.tight_layout()
    fig.savefig(out_path, dpi=300)
    plt.close(fig)
    return out_path


def rd_curves(comparisons_csv: str, out_path: str, title: str = "") -> str:
    """PSNR vs bpp per effort — the thesis's rate-distortion view."""
    plt = _pyplot()
    results = _load(comparisons_csv)
    efforts = sorted({r.effort for r in results})
    fig, ax = plt.subplots(figsize=(7, 5))
    for e in efforts:
        pts = sorted((8.0 * r.comp_file_size / max(1, r.orig_raw_size // 3), r.psnr) for r in results if r.effort == e)
        if pts:
            ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o", label=f"e{e}")
    ax.set_xlabel("bits per pixel")
    ax.set_ylabel("PSNR (dB)")
    ax.set_title(title or "rate-distortion")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=300)
    plt.close(fig)
    return out_path
