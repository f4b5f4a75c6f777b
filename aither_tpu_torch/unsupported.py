"""Deck settings the port does not cover yet, with the ROADMAP.md item that
carries each.  The port raises instead of silently taking another path."""

from __future__ import annotations

_Q1 = "ROADMAP.md queue 1 item"

ITEMS = {
    "thermallyPerfectRoe": f"{_Q1} 5c (the thermally perfect approximateRoe "
                           "forms of the CUDA sweeps)",
    "species": f"{_Q1} 9 (species counts above 5 in the CUDA sweeps)",
}


def refuse(feature: str, detail: str = "") -> None:
    """Raise NotImplementedError naming the ROADMAP item for ``feature``."""
    what = f"{feature} ({detail})" if detail else feature
    raise NotImplementedError(
        f"{what} is not in the PyTorch port yet: see {ITEMS[feature]}")
