"""Filesystem helpers (reference: `benchmark-jpegxl/src/utils.rs`)."""

import os


def exists_or_create_dir(path: str) -> None:
    """Create dir if missing (`utils.rs:11-16`)."""
    os.makedirs(path, exist_ok=True)


def dir_exists(path: str) -> bool:
    """`utils.rs:25-40`."""
    return os.path.isdir(path)
