"""Input-deck parser for the aither `.inp` grammar.

Parses the same key/value + ``<...>`` list grammar as the reference solver
(reference: src/input.cpp:167-643), so the stock ``testCases/*.inp`` decks run
unchanged.  This is host-side setup code that runs once; it is deliberately
plain Python.

Grammar summary:
  * ``key: value`` pairs, one per line; ``#`` starts a comment.
  * list values are wrapped in ``<...>`` and may span multiple lines;
    elements are state objects ``name(k=v; k=[a,b,c]; ...)``.
  * the ``boundaryConditions`` key starts a block-structured section:
    an integer block count, then per block a line with the number of
    i/j/k surfaces followed by one line per surface:
    ``type imin imax jmin jmax kmin kmax tag``.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

# ---------------------------------------------------------------------------
# low-level tokenizing helpers


def strip_comment(line: str) -> str:
    idx = line.find("#")
    if idx >= 0:
        line = line[:idx]
    return line.strip()


def _parse_scalar(tok: str) -> Any:
    tok = tok.strip().rstrip(",")
    if tok.startswith("[") and tok.endswith("]"):
        inner = tok[1:-1].strip()
        if not inner:
            return []
        return [_parse_scalar(t) for t in inner.split(",")]
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok


@dataclasses.dataclass
class StateObject:
    """A ``name(k=v; ...)`` object from the deck (icState, fluid, BC states)."""

    name: str
    params: dict[str, Any]

    def get(self, key, default=None):
        return self.params.get(key, default)

    def __getitem__(self, key):
        return self.params[key]

    def __contains__(self, key):
        return key in self.params


def parse_state_object(text: str) -> StateObject:
    """Parse ``name(key=value; key=value)``.

    ``value`` may be a scalar, a bracketed list ``[a, b, c]``, or for
    ``massFractions`` a bracketed mapping ``[O2=0.2, N2=0.8]``.
    """
    m = re.match(r"\s*(\w+)\s*\((.*)\)\s*$", text, re.S)
    if not m:
        raise ValueError(f"malformed state object: {text!r}")
    name, body = m.group(1), m.group(2)
    params: dict[str, Any] = {}
    # split on ';' at top level (no ';' appears inside brackets in the grammar)
    for piece in body.split(";"):
        piece = piece.strip()
        if not piece:
            continue
        key, _, val = piece.partition("=")
        key = key.strip()
        val = val.strip()
        if val.startswith("[") and "=" in val:
            # mapping form: [O2=0.2, N2=0.8]
            inner = val.strip("[]")
            mapping = {}
            for item in inner.split(","):
                k, _, v = item.partition("=")
                if k.strip():
                    mapping[k.strip()] = float(v)
            params[key] = mapping
        else:
            params[key] = _parse_scalar(val)
    return StateObject(name, params)


def _split_objects(body: str) -> list[str]:
    """Split the interior of a ``<...>`` list into ``name(...)`` object
    strings, tracking paren depth manually."""
    out = []
    i = 0
    n = len(body)
    while i < n:
        m = re.compile(r"\w+\s*\(").search(body, i)
        if not m:
            break
        j = m.end()
        depth = 1
        while j < n and depth:
            if body[j] == "(":
                depth += 1
            elif body[j] == ")":
                depth -= 1
            j += 1
        out.append(body[m.start():j])
        i = j
    return out


# ---------------------------------------------------------------------------
# boundary surfaces


@dataclasses.dataclass(frozen=True)
class BoundarySurface:
    """One boundary surface of a block (reference: boundaryConditions.hpp:55).

    Index ranges are in face indices (0..ncells along each axis).  For an
    i-surface ``imin == imax`` is the face location; likewise j/k.
    ``direction`` is 'i', 'j' or 'k'.  Surface 1 = lower side, 2 = upper side
    within its direction (used for orientation of interblock matches).
    """

    bc_type: str
    imin: int
    imax: int
    jmin: int
    jmax: int
    kmin: int
    kmax: int
    tag: int
    direction: str

    @property
    def is_lower(self) -> bool:
        return {
            "i": self.imin == 0 and self.imax == 0,
            "j": self.jmin == 0 and self.jmax == 0,
            "k": self.kmin == 0 and self.kmax == 0,
        }[self.direction]

    @property
    def face_index(self) -> int:
        return {"i": self.imin, "j": self.jmin, "k": self.kmin}[self.direction]

    def ranges(self):
        """((imin,imax),(jmin,jmax),(kmin,kmax)) face-index ranges."""
        return ((self.imin, self.imax), (self.jmin, self.jmax),
                (self.kmin, self.kmax))


@dataclasses.dataclass
class BlockBC:
    """All boundary surfaces for one block."""

    num_i: int
    num_j: int
    num_k: int
    surfaces: list[BoundarySurface]

    def surfaces_in_dir(self, d: str) -> list[BoundarySurface]:
        return [s for s in self.surfaces if s.direction == d]


# ---------------------------------------------------------------------------
# the deck itself

_DEFAULTS = dict(
    gridName="",
    timeStep=-1.0,
    iterations=1,
    referenceDensity=-1.0,
    referenceTemperature=-1.0,
    referenceLength=1.0,
    timeIntegration="explicitEuler",
    faceReconstruction="constant",
    viscousFaceReconstruction="central",
    limiter="none",
    outputFrequency=1,
    restartFrequency=0,
    equationSet="euler",
    matrixSolver="lusgs",
    matrixSweeps=1,
    matrixRelaxation=1.0,
    nonlinearIterations=1,
    cflMax=1.0,
    cflStep=0.0,
    cflStart=1.0,
    inviscidFluxJacobian="rusanov",
    dualTimeCFL=-1.0,
    inviscidFlux="roe",
    decompositionMethod="cubic",
    turbulenceModel="none",
    thermodynamicModel="caloricallyPerfect",
    equationOfState="idealGas",
    transportModel="sutherland",
    diffusionModel="none",
    chemistryModel="frozen",
    chemistryMechanism="none",
    schmidtNumber=0.9,
    freezingTemperature=0.0,
    multigridLevels=1,
    # pre/post sweeps are parsed for deck compatibility but intentionally
    # unconsumed — the REFERENCE also never consumes them: its MG cycle
    # hardcodes max(matrixSweeps/2, 1) pre/post relaxations
    # (mgSolution.cpp:171-195; MultigridPreSweeps() is only echoed at
    # input.cpp:442-450).  The cycle here replicates that (driver._mg_cycle)
    multigridPreSweeps=2,
    multigridPostSweeps=1,
    multigridCycle="V",
    outputNodalVariables=False,
)

_INT_KEYS = {"iterations", "outputFrequency", "restartFrequency",
             "matrixSweeps", "nonlinearIterations", "multigridLevels",
             "multigridPreSweeps", "multigridPostSweeps"}
_FLOAT_KEYS = {"timeStep", "referenceDensity", "referenceTemperature",
               "referenceLength", "matrixRelaxation", "cflMax", "cflStep",
               "cflStart", "dualTimeCFL", "schmidtNumber",
               "freezingTemperature"}

# kappa per faceReconstruction (reference: input.cpp:272-296)
_KAPPA = {"upwind": -1.0, "fromm": 0.0, "quick": 0.5, "central": 1.0,
          "thirdOrder": 1.0 / 3.0}

# the full key registry (reference: input.cpp:111-155 vars_); unknown keys
# are rejected like the reference's parser does
_LIST_KEYS = {"fluids", "initialConditions", "boundaryStates",
              "outputVariables", "wallOutputVariables",
              "boundaryConditions"}
_KNOWN_KEYS = set(_DEFAULTS) | _LIST_KEYS

# accepted enumerated values (reference: input.cpp:272-560 per-key parsing)
_ENUM_VALUES = {
    "faceReconstruction": {"constant", "upwind", "fromm", "quick", "central",
                           "thirdOrder", "weno", "wenoZ"},
    "viscousFaceReconstruction": {"central", "centralFourth"},
    "limiter": {"none", "minmod", "vanAlbada"},
    "timeIntegration": {"explicitEuler", "rk4", "implicitEuler",
                        "crankNicholson", "bdf2"},
    "equationSet": {"euler", "navierStokes", "rans", "largeEddySimulation"},
    "matrixSolver": {"lusgs", "blusgs", "dplur", "bdplur"},
    "inviscidFlux": {"roe", "ausm"},
    # the reference's implicit off-diagonal recognizes only these two and
    # exits for anything else (fluxJacobian.cpp:196-237 OffDiagonal); the
    # parser here rejects unsupported values up front instead of at the
    # first implicit iteration
    "inviscidFluxJacobian": {"rusanov", "approximateRoe"},
    "decompositionMethod": {"cubic", "manual"},
    "turbulenceModel": {"none", "kOmegaWilcox2006", "sst2003", "sstdes",
                        "wale"},
    "thermodynamicModel": {"caloricallyPerfect", "thermallyPerfect"},
    "equationOfState": {"idealGas"},
    "transportModel": {"sutherland"},
    "diffusionModel": {"none", "schmidt"},
    "chemistryModel": {"frozen", "reacting"},
    "multigridCycle": {"V", "W"},
}


class Deck:
    """Parsed input deck with reference-consistent defaults and derived
    quantities (nondimensionalization refs, equation counts, CFL ramp)."""

    def __init__(self, sim_name: str = "input.inp"):
        self.sim_name = sim_name
        self.values: dict[str, Any] = dict(_DEFAULTS)
        self.fluids: list[StateObject] = [
            StateObject("fluid", {"name": "air", "referenceMassFraction": 1.0})
        ]
        self.ics: list[StateObject] = []
        self.bc_states: list[StateObject] = []
        self.bcs: list[BlockBC] = []
        self.output_variables = ["density", "vel_x", "vel_y", "vel_z",
                                 "pressure"]
        self.wall_output_variables: list[str] = []
        # filled by finalize()
        self.a_ref = 0.0
        self.iteration_start = 0

    # -- simple accessors ---------------------------------------------------
    def __getitem__(self, key):
        return self.values[key]

    def get(self, key, default=None):
        return self.values.get(key, default)

    @property
    def kappa(self) -> float:
        return _KAPPA.get(self.values["faceReconstruction"], -2.0)

    @property
    def num_species(self) -> int:
        return len(self.fluids)

    @property
    def species_names(self) -> list[str]:
        return [f["name"] for f in self.fluids]

    def species_index(self, name: str) -> int:
        return self.species_names.index(name)

    @property
    def is_rans(self) -> bool:
        return self.values["equationSet"] == "rans"

    @property
    def is_les(self) -> bool:
        return self.values["equationSet"] == "largeEddySimulation"

    @property
    def is_turbulent(self) -> bool:
        return self.is_rans or self.is_les

    @property
    def is_viscous(self) -> bool:
        return self.values["equationSet"] == "navierStokes" or self.is_turbulent

    @property
    def is_implicit(self) -> bool:
        return self.values["timeIntegration"] in ("implicitEuler",
                                                  "crankNicholson", "bdf2")

    @property
    def is_block_matrix(self) -> bool:
        return self.is_implicit and self.values["matrixSolver"] in (
            "bdplur", "blusgs")

    @property
    def num_flow_equations(self) -> int:
        return self.num_species + 4

    @property
    def num_turb_equations(self) -> int:
        return 2 if self.is_rans else 0

    @property
    def num_equations(self) -> int:
        return self.num_flow_equations + self.num_turb_equations

    @property
    def is_multilevel_in_time(self) -> bool:
        return self.values["timeIntegration"] == "bdf2"

    @property
    def theta(self) -> float:
        return {"crankNicholson": 0.5}.get(self.values["timeIntegration"], 1.0)

    @property
    def zeta(self) -> float:
        return {"bdf2": 0.5}.get(self.values["timeIntegration"], 0.0)

    @property
    def num_ghosts(self) -> int:
        """Ghost layers (reference: input.cpp:1127-1143)."""
        fr = self.values["faceReconstruction"]
        if fr == "constant":
            layers = 1
        elif fr in _KAPPA:
            layers = 2
        else:  # weno / wenoZ
            layers = 3
        visc = 2 if self.values["viscousFaceReconstruction"] == "centralFourth" else 1
        return max(layers, visc)

    def viscous_cfl_coefficient(self) -> float:
        if self.kappa == 1.0:
            return 4.0
        if self.kappa == -2.0:
            return 2.0
        return 1.0

    def cfl(self, step: int) -> float:
        return min(self.values["cflStart"] + step * self.values["cflStep"],
                   self.values["cflMax"])

    @property
    def using_dual_time(self) -> bool:
        return self.values["dualTimeCFL"] > 0.0

    # -- nondimensional references -------------------------------------------
    @property
    def r_ref(self) -> float:
        return self.values["referenceDensity"]

    @property
    def t_ref(self) -> float:
        return self.values["referenceTemperature"]

    @property
    def l_ref(self) -> float:
        return self.values["referenceLength"]

    def ic_for_block(self, block: int) -> StateObject:
        """Exact-tag match beats the default tag=-1 (input.cpp:1146-1171)."""
        found = None
        for ic in self.ics:
            tag = ic.get("tag", -1)
            if tag == block:
                return ic
            if tag == -1 and found is None:
                found = ic
        if found is None:
            raise ValueError(f"no initial condition for block {block}")
        return found

    def bc_data(self, tag: int) -> StateObject:
        for st in self.bc_states:
            if st.get("tag") == tag or st.get("endTag") == tag:
                return st
        raise KeyError(f"no boundaryState with tag {tag}")

    def matrix_requires_initialization(self) -> bool:
        return (self.values["matrixSolver"] in ("dplur", "bdplur")
                or self.values["matrixSweeps"] > 1)

    # -- validation mirrored from the reference -------------------------------
    def finalize(self, fluid_db=None):
        """Apply reference-equivalent validation/derivations
        (input.cpp:602-643, :878-1000 consistency checks)."""
        import sys

        ti = self.values["timeIntegration"]
        if ti == "rk4" and self.values["nonlinearIterations"] != 4:
            print("WARNING: For RK4 method, nonlinear iterations should be "
                  f"set to 4, changing value from "
                  f"{self.values['nonlinearIterations']} to 4",
                  file=sys.stderr)
            self.values["nonlinearIterations"] = 4
        elif ti == "explicitEuler" \
                and self.values["nonlinearIterations"] != 1:
            print("WARNING: For euler method, nonlinear iterations should "
                  f"be set to 1, changing value from "
                  f"{self.values['nonlinearIterations']} to 1",
                  file=sys.stderr)
            self.values["nonlinearIterations"] = 1

        # turbulence model vs equation set (reference: input.cpp:963-985
        # CheckTurbulenceModel)
        turb = self.values["turbulenceModel"]
        if self.is_turbulent and turb == "none":
            raise ValueError("If solving RANS or LES equations, must "
                             "specify turbulence model")
        if not self.is_turbulent and turb != "none":
            raise ValueError("Turbulence models are only valid for the "
                             "RANS and LES equation sets")
        if self.is_rans and turb == "wale":
            raise ValueError("Equation set is RANS, but turbulence model "
                             "is not")
        if self.is_les and turb != "wale":
            raise ValueError("Equation set is LES, but turbulence model "
                             "is not")

        # prune output variables unavailable for this equation set
        # (reference: input.cpp:894-960 Check(Wall)OutputVariables)
        def prune(names, drop, what):
            kept = []
            for v in names:
                if drop(v):
                    print(f"WARNING: Variable {v} is not available for "
                          f"{what} simulations.", file=sys.stderr)
                else:
                    kept.append(v)
            return kept

        rans_vars = ("tke", "sdr", "resid_tke", "resid_sdr", "f1", "f2")
        if not self.is_rans:
            self.output_variables = prune(
                self.output_variables,
                lambda v: (v in rans_vars or v.startswith("tkeGrad_")
                           or v.startswith("sdrGrad_")), "non-RANS")
            self.wall_output_variables = prune(
                self.wall_output_variables, lambda v: v in ("tke", "sdr"),
                "non-RANS")
        if not self.is_turbulent:
            self.output_variables = prune(
                self.output_variables,
                lambda v: v in ("viscosityRatio", "turbulentViscosity"),
                "laminar")
            self.wall_output_variables = prune(
                self.wall_output_variables, lambda v: v == "viscosityRatio",
                "laminar")
        if not self.is_viscous:
            self.output_variables = prune(
                self.output_variables, lambda v: v == "viscosity",
                "inviscid")
            self.wall_output_variables = prune(
                self.wall_output_variables,
                lambda v: v in ("yplus", "heatFlux", "shearStress",
                                "frictionVelocity", "viscosity"), "inviscid")
        self.output_variables = prune(
            self.output_variables,
            lambda v: v.startswith("mf_")
            and v[3:] not in self.species_names, "missing-species")
        # the reference stores output variables in a std::set<string>, so
        # the .fun column order is ASCII-lexicographic, not deck order
        # (reference: input.hpp:105-106, output.cpp:228 loop over the set)
        self.output_variables = sorted(set(self.output_variables))
        self.wall_output_variables = sorted(set(self.wall_output_variables))

        # reference speed of sound: a = sqrt(sum_s mf_s * gamma_s R_s Tref)
        # assuming calorically perfect for gamma (input.cpp:616-621)
        from ..physics.fluid import load_fluid  # lazy import
        mf = [f.get("referenceMassFraction", 1.0) for f in self.fluids]
        tot = sum(mf)
        mf = [m / tot for m in mf]
        self.mixture_ref = mf
        a2 = 0.0
        self._fluid_props = []
        for frac, f in zip(mf, self.fluids):
            props = load_fluid(f["name"]) if fluid_db is None else fluid_db[f["name"]]
            self._fluid_props.append(props)
            gamma = (props.n + 1.0) / props.n
            a2 += frac * gamma * props.gas_constant * self.t_ref
        self.a_ref = math.sqrt(a2)
        self.values["freezingTemperature"] /= self.t_ref
        return self


def parse_deck(path: str) -> Deck:
    with open(path) as f:
        text = f.read()
    return parse_deck_text(text, sim_name=path)


def _read_list_value(lines: list[str], i: int, first_val: str):
    """Accumulate a `<...>` list that may span lines. Returns (body, next_i)."""
    buf = first_val
    while "<" in buf and ">" not in buf:
        i += 1
        buf += " " + strip_comment(lines[i])
    body = buf[buf.index("<") + 1: buf.rindex(">")]
    return body, i


def parse_deck_text(text: str, sim_name: str = "input.inp") -> Deck:
    deck = Deck(sim_name)
    lines = text.splitlines()
    i = 0
    n = len(lines)
    while i < n:
        line = strip_comment(lines[i])
        if not line:
            i += 1
            continue
        key, sep, val = line.partition(":")
        key = key.strip()
        val = val.strip()
        if not sep:
            i += 1
            continue

        if key == "boundaryConditions":
            num_blocks = int(val)
            blocks: list[BlockBC] = []
            i += 1
            while len(blocks) < num_blocks and i < n:
                row = strip_comment(lines[i])
                if not row:
                    i += 1
                    continue
                counts = row.split()
                ni, nj, nk = int(counts[0]), int(counts[1]), int(counts[2])
                surfs: list[BoundarySurface] = []
                want = ni + nj + nk
                i += 1
                while len(surfs) < want and i < n:
                    row = strip_comment(lines[i])
                    i += 1
                    if not row:
                        continue
                    toks = row.split()
                    d = "i" if len(surfs) < ni else ("j" if len(surfs) < ni + nj else "k")
                    surfs.append(BoundarySurface(
                        toks[0], *(int(t) for t in toks[1:7]),
                        tag=int(toks[7]), direction=d))
                blocks.append(BlockBC(ni, nj, nk, surfs))
            deck.bcs = blocks
            continue

        if key in ("fluids", "initialConditions", "boundaryStates"):
            body, i = _read_list_value(lines, i, val)
            objs = [parse_state_object(o) for o in _split_objects(body)]
            if key == "fluids":
                deck.fluids = objs
            elif key == "initialConditions":
                deck.ics = objs
            else:
                deck.bc_states = objs
            i += 1
            continue

        if key in ("outputVariables", "wallOutputVariables"):
            body, i = _read_list_value(lines, i, val)
            names = [t.strip() for t in body.split(",") if t.strip()]
            if key == "outputVariables":
                # reference stores these in a std::set -> sorted unique
                # (input.hpp:105-106)
                deck.output_variables = sorted(set(names))
            else:
                deck.wall_output_variables = sorted(set(names))
            i += 1
            continue

        if key in _INT_KEYS:
            deck.values[key] = int(val)
        elif key in _FLOAT_KEYS:
            deck.values[key] = float(val)
        elif key == "outputNodalVariables":
            deck.values[key] = val in ("yes", "true")
        elif key in _DEFAULTS:
            if key in _ENUM_VALUES and val not in _ENUM_VALUES[key]:
                raise ValueError(
                    f"input deck value {val!r} for key {key!r} is not "
                    f"recognized; choose one of "
                    f"{sorted(_ENUM_VALUES[key])}")
            deck.values[key] = val
        else:
            # unknown keys are rejected against the registry exactly like
            # the reference parser (reference: input.cpp:111-155 vars_)
            raise ValueError(
                f"unknown input deck key {key!r} (line {i + 1})")
        i += 1

    return deck
