"""Deck settings the port does not cover yet, with the ROADMAP.md item that
carries each.  The port raises instead of silently taking another path."""

from __future__ import annotations

_Q1 = "ROADMAP.md queue 1 item"

ITEMS = {
    "faceReconstruction": f"{_Q1} 5 (remaining physics: WENO)",
    "viscousFaceReconstruction": f"{_Q1} 5 (remaining physics: centralFourth)",
    "inviscidFlux": f"{_Q1} 5 (remaining physics: AUSM)",
    "thermallyPerfect": f"{_Q1} 5 (remaining physics: thermallyPerfect)",
    "species": f"{_Q1} 9 (species counts above 5 in the CUDA sweeps)",
}


def refuse(feature: str, detail: str = "") -> None:
    """Raise NotImplementedError naming the ROADMAP item for ``feature``."""
    what = f"{feature} ({detail})" if detail else feature
    raise NotImplementedError(
        f"{what} is not in the PyTorch port yet: see {ITEMS[feature]}")
