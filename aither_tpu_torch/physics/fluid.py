"""Per-species fluid property database.

Mirrors the reference's fluid class + ``fluidDatabase/*.dat`` files
(reference: src/fluid.cpp, include/fluid.hpp).  Properties are stored
dimensional and nondimensionalized once per run (fluid.cpp:143-156).
"""

from __future__ import annotations

import dataclasses
import os

UNIVERSAL_GAS_CONSTANT = 8.3144598  # J / mol-K

# Bundled species data, transcribed from the public NIST-derived values the
# reference ships in fluidDatabase/*.dat.  Format per species:
#   n (DoF/2), molarMass (g/mol), vibrationalTemperatures (K),
#   heatOfFormation (J/mol), refP (Pa), refT (K), refS (J/mol-K),
#   sutherland viscosity (C1, S), sutherland conductivity (C1, S)
_DATABASE = {
    "air": (2.5, 28.97, [3056.0], 0.0, 101325.0, 298.15, 0.0,
            (1.458e-6, 110.4), (2.495e-3, 194.0)),
    "Ar":  (1.5, 39.948, [], 0.0, 101325.0, 298.15, 154.85,
            (2.0343e-6, 160.53), (1.5877e-3, 160.53)),
    "CH4": (3.0, 16.0425,
            [4196.38, 2207.18, 2207.18, 4343.43, 4343.43, 4343.43,
             1879.13, 1879.13, 1879.13], -74600.0, 101325.0, 298.15, 186.37,
            (1.0166e-6, 164.71), (1.768e-2, 2308.3)),
    "CO":  (2.5, 28.0101, [3121.5], -110530.0, 101325.0, 298.15, 197.66,
            (1.45e-6, 128.82), (2.688e-3, 276.17)),
    "CO2": (2.5, 44.0095, [960.1, 960.1, 1932.1, 3380.1], -393510.0,
            101325.0, 298.15, 213.79, (1.6491e-6, 269.68),
            (4.1247e-3, 880.20)),
    "H":   (1.5, 1.00794, [], 218000.0, 101325.0, 298.15, 114.72,
            (8.4958e-7, 167.75), (2.6278e-2, 167.75)),
    "H2":  (2.5, 2.01588, [6338.3], 0.0, 101325.0, 298.15, 130680.0,
            (6.8021e-7, 100.31), (1.5056e-2, 132.07)),
    "H2O": (3.0, 18.0153, [2294.3, 5261.7, 5403.8], -241810.0,
            101325.0, 298.15, 188.84, (1.9293e-6, 702.74),
            (1.12e-2, 2072.8)),
    "He":  (1.5, 4.002602, [], 0.0, 101325.0, 298.15, 126.15,
            (1.4872e-6, 97.629), (1.1584e-2, 97.629)),
    "N":   (1.5, 14.0067, [], 472680.0, 101325.0, 298.15, 153.3,
            (1.2953e-6, 111.90), (2.8831e-3, 111.90)),
    "N2":  (2.5, 28.0134, [3392.0], 0.0, 101325.0, 298.15, 191.61,
            (1.4742e-6, 128.46), (2.6834e-3, 256.15)),
    "NO":  (2.5, 30.0061, [2739.0], 91040.0, 101325.0, 298.15, 210.76,
            (1.5257e-6, 128.46), (2.7255e-3, 270.27)),
    "O":   (1.5, 15.9994, [], 2.4699e5, 101325.0, 298.15, 161.069,
            (1.9664e-6, 116.49), (3.8319e-3, 116.49)),
    "O2":  (2.5, 31.9988, [2273.0], 0.0, 101325.0, 298.15, 205.15,
            (1.7146e-6, 136.10), (3.0048e-3, 306.10)),
    "OH":  (2.5, 17.0073, [5374.2], 37360.0, 101325.0, 298.15, 183.74,
            (2.0274e-6, 116.49), (4.8939e-3, 144.71)),
}


@dataclasses.dataclass
class Fluid:
    """One species' properties; starts dimensional, `nondimensionalize()`
    converts in place semantics via returning a new instance."""

    name: str
    n: float                      # DoF / 2
    molar_mass: float             # kg / mol
    vib_temps: tuple              # K (or nondim)
    heat_of_formation: float      # J / mol (or nondim per-mass)
    ref_p: float
    ref_t: float
    ref_s: float
    visc_c1: float
    visc_s: float
    cond_c1: float
    cond_s: float
    universal_r: float = UNIVERSAL_GAS_CONSTANT
    nondimensional: bool = False

    @property
    def gas_constant(self) -> float:
        return self.universal_r / self.molar_mass

    def nondimensionalize(self, t_ref, r_ref, a_ref, l_ref) -> "Fluid":
        """Reference: fluid.cpp:143-156."""
        if self.nondimensional:
            return self
        return dataclasses.replace(
            self,
            vib_temps=tuple(v / t_ref for v in self.vib_temps),
            heat_of_formation=self.heat_of_formation
            / (self.molar_mass * a_ref * a_ref),
            ref_s=self.ref_s / (self.molar_mass / t_ref * a_ref * a_ref),
            molar_mass=self.molar_mass / (r_ref / l_ref**3),
            ref_p=self.ref_p / (r_ref * a_ref * a_ref),
            ref_t=self.ref_t / t_ref,
            universal_r=self.universal_r
            / (a_ref * a_ref * r_ref / (t_ref * l_ref**3)),
            nondimensional=True,
        )


def _from_dat_text(name: str, text: str) -> Fluid:
    vals = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        key, _, val = line.partition(":")
        vals[key.strip()] = val.strip()

    def flt(k, default=0.0):
        return float(vals.get(k, default))

    vib = []
    if "vibrationalTemperature" in vals:
        inner = vals["vibrationalTemperature"].strip("[]")
        vib = [float(v) for v in inner.split(",") if v.strip()]
    return Fluid(
        name=name, n=flt("n"), molar_mass=flt("molarMass") / 1000.0,
        vib_temps=tuple(vib), heat_of_formation=flt("heatOfFormation"),
        ref_p=flt("referencePressure", 101325.0),
        ref_t=flt("referenceTemperature", 298.15),
        ref_s=flt("referenceEntropy"),
        visc_c1=flt("sutherlandViscosityC1"),
        visc_s=flt("sutherlandViscosityS"),
        cond_c1=flt("sutherlandConductivityC1"),
        cond_s=flt("sutherlandConductivityS"),
    )


def load_fluid(name: str, search_dirs: tuple = ()) -> Fluid:
    """Load species data: a `<name>.dat` file on disk (cwd, search_dirs, or
    $AITHER_INSTALL_DIRECTORY/fluidDatabase) wins; else the bundled table."""
    candidates = [f"{name}.dat"]
    for d in search_dirs:
        candidates.append(os.path.join(d, f"{name}.dat"))
    env = os.environ.get("AITHER_INSTALL_DIRECTORY")
    if env:
        candidates.append(os.path.join(env, "fluidDatabase", f"{name}.dat"))
    for c in candidates:
        if os.path.isfile(c):
            with open(c) as f:
                return _from_dat_text(name, f.read())
    if name in _DATABASE:
        (n, mm, vib, hf, rp, rt, rs, (vc1, vs), (cc1, cs)) = _DATABASE[name]
        return Fluid(name, n, mm / 1000.0, tuple(vib), hf, rp, rt, rs,
                     vc1, vs, cc1, cs)
    raise FileNotFoundError(f"no fluid database entry for species {name!r}")
