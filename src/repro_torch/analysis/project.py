"""Where the repository lies, for the passes that read its files."""
from __future__ import annotations

from pathlib import Path


def repo_root() -> Path:
    """The checkout holding this package (…/src/repro_torch/analysis)."""
    return Path(__file__).resolve().parents[3]
