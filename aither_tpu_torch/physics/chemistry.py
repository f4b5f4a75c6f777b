"""Finite-rate chemistry: .mch mechanism parsing and reacting source terms.

Port of ``aither_tpu/physics/chemistry.py`` (reference: src/chemistry.cpp,
src/reactions.cpp, include/reactions.hpp) with torch in place of
``jax.numpy``; the mechanism text is parsed on the host.

- reactions: ``2 O2 <=> 2 O + O2 : forwardRate=arrhenius(C=..,eta=..,theta=..)``
- forward rate kf = C t^eta exp(-theta/t)  (reactions.hpp:68-70)
- backward rate kb = kf / Keq with Keq from Gibbs free-energy minimization
  (reactions.cpp:204-218)
- species source w_s = MW_s sum_rx (nu''-nu')(kf prod c^nu' - kb prod c^nu'')
  with c_s = rho_s/MW_s  (chemistry.cpp:81-125)
- source spectral radius = min_s [-MW_s/mf_s sum_rx (nu''-nu') kb prod c^nu'']
- block Jacobian: finite differences with respect to the species
  densities at fixed t and Gibbs term, step 1e-10 rho; the energy column
  is zero (chemistry.cpp:127-176)

A mechanism ``<name>.mch`` is searched in the given directories (the
working directory for a deck), then in
``$AITHER_INSTALL_DIRECTORY/chemistryMechanisms``.  The JAX loader's last
fallback, a fixed path into a reference source tree outside the
repository, is left out.
"""

from __future__ import annotations

import dataclasses
import os
import re

import torch


@dataclasses.dataclass(frozen=True)
class Reaction:
    stoich_react: tuple       # per-species nu'
    stoich_prod: tuple        # per-species nu''
    c: float
    eta: float
    theta: float
    forward_only: bool
    modify_react: tuple = ()


@dataclasses.dataclass(frozen=True)
class Chemistry:
    """Reacting-chemistry configuration (nondimensional)."""

    reactions: tuple
    molar_mass: tuple          # nondim molar masses
    ref_p: float               # nondim reference pressure
    universal_r: float         # nondim universal gas constant
    freezing_t: float          # nondim freezing temperature


def _split_terms(side: str):
    for term in side.split("+"):
        term = term.strip()
        m = re.match(r"^([0-9.]*)\s*(\S+)$", term)
        coeff = float(m.group(1)) if m.group(1) else 1.0
        yield coeff, m.group(2)


def parse_mechanism_text(text: str, species: list, t_ref: float,
                         l_ref: float, a_ref: float):
    """Parse a .mch mechanism into nondimensionalized Reactions
    (reference: reactions.cpp:33-156, chemistry.cpp:46-79)."""
    ns = len(species)
    idx = {s: i for i, s in enumerate(species)}
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        rx_str, _, rate_str = line.partition(":")
        if "<=>" in rx_str:
            forward_only = False
            lhs, rhs = rx_str.split("<=>")
        elif "=>" in rx_str:
            forward_only = True
            lhs, rhs = rx_str.split("=>")
        else:
            raise ValueError(f"reaction type not recognized: {line!r}")
        nu_r = [0.0] * ns
        nu_p = [0.0] * ns
        for coeff, name in _split_terms(lhs):
            if name not in idx:
                raise ValueError(f"species {name} not in simulation")
            nu_r[idx[name]] += coeff
        for coeff, name in _split_terms(rhs):
            if name not in idx:
                raise ValueError(f"species {name} not in simulation")
            nu_p[idx[name]] += coeff
        c = eta = theta = None
        modify = [0.0] * ns
        for rt in rate_str.split(";"):
            key, _, val = rt.strip().partition("=")
            if key == "forwardRate":
                inner = val[val.find("(") + 1:val.find(")")]
                for kv in inner.split(","):
                    k, _, v = kv.strip().partition("=")
                    if k == "C":
                        c = float(v)
                    elif k == "eta":
                        eta = float(v)
                    elif k == "theta":
                        theta = float(v)
            elif key == "modifyReactants":
                inner = val[val.find("[") + 1:val.find("]")]
                for kv in inner.split(","):
                    k, _, v = kv.strip().partition("=")
                    modify[idx[k]] = float(v)
        # nondimensionalize (reactions.hpp:79-92)
        theta = theta / t_ref
        tau_ref = l_ref / a_ref
        nu_reac_sum = sum(nu_r)
        con_ref = (1.0 / l_ref ** 3) ** (1.0 - nu_reac_sum)
        c = c * tau_ref * t_ref ** eta / con_ref
        out.append(Reaction(tuple(nu_r), tuple(nu_p), c, eta, theta,
                            forward_only, tuple(modify)))
    return tuple(out)


def load_mechanism(name: str, species: list, t_ref: float, l_ref: float,
                   a_ref: float, search_dirs=()):
    fname = name + ".mch"
    candidates = [os.path.join(d, fname) for d in search_dirs]
    env = os.environ.get("AITHER_INSTALL_DIRECTORY")
    if env:
        candidates.append(os.path.join(env, "chemistryMechanisms", fname))
    for cand in candidates:
        if os.path.isfile(cand):
            with open(cand) as f:
                return parse_mechanism_text(f.read(), species, t_ref, l_ref,
                                            a_ref)
    raise FileNotFoundError(f"mechanism {fname} not found in {candidates}")


def gibbs_minimization(phys, t):
    """g_s = GibbsMinStdState(t,s)/(R_s t) per species, shape (ns, ...)
    (reference: thermodynamic.cpp:115-128, thermodynamic.hpp:181-186)."""
    terms = []
    for ss in range(phys.ns):
        R = phys.R[ss]
        g = R * t * (1.0 + phys.n[ss]) * (1.0 - torch.log(t)) \
            + phys.hf[ss] - phys.s0[ss] * t
        if phys.thermally_perfect:
            vib = 0.0
            for tv in phys.vib[ss]:
                vib = vib + torch.log(1.0 - torch.exp(-tv / t))
            g = g + R * (vib * t)
        terms.append(g / (R * t))
    return torch.stack(terms, dim=0)


def source_terms(phys, chem: Chemistry, rho_s, t, gibbs=None):
    """Species sources and (negative) destruction spectral radius
    (reference: chemistry.cpp:81-125).  rho_s: (ns, ...), t: (...)."""
    ns = phys.ns
    if gibbs is None:
        gibbs = gibbs_minimization(phys, t)
    mm = chem.molar_mass
    rho = rho_s.sum(dim=0)
    conc = [rho_s[ss] / mm[ss] for ss in range(ns)]
    src = [torch.zeros_like(t) for _ in range(ns)]
    destr = [torch.zeros_like(t) for _ in range(ns)]
    for rx in chem.reactions:
        kf = rx.c * t ** rx.eta * torch.exp(-rx.theta / t)
        pmr_sum = sum(rx.stoich_prod) - sum(rx.stoich_react)
        exp_term = sum(gibbs[ss] * (rx.stoich_prod[ss] - rx.stoich_react[ss])
                       for ss in range(ns))
        keq = (chem.ref_p / (chem.universal_r * t)) ** pmr_sum \
            * torch.exp(-exp_term)
        kb = torch.zeros_like(t) if rx.forward_only else kf / keq
        fwd = 1.0
        bck = 1.0
        for ss in range(ns):
            if rx.stoich_react[ss] != 0.0:
                fwd = fwd * conc[ss] ** rx.stoich_react[ss]
            if rx.stoich_prod[ss] != 0.0:
                bck = bck * conc[ss] ** rx.stoich_prod[ss]
        for ss in range(ns):
            pmr = rx.stoich_prod[ss] - rx.stoich_react[ss]
            if pmr != 0.0:
                src[ss] = src[ss] + pmr * (kf * fwd - kb * bck)
                destr[ss] = destr[ss] - pmr * kb * bck
    mf = [rho_s[ss] / rho for ss in range(ns)]
    for ss in range(ns):
        src[ss] = src[ss] * mm[ss]
        destr[ss] = destr[ss] * mm[ss] / torch.clamp(mf[ss], min=1.0e-300)
    spec_rad = destr[0]
    for ss in range(1, ns):
        spec_rad = torch.minimum(spec_rad, destr[ss])
    frozen = t < chem.freezing_t
    src_arr = torch.stack([torch.where(frozen, 0.0, s) for s in src], dim=0)
    spec_rad = torch.where(frozen, 0.0, spec_rad)
    return src_arr, spec_rad


def source_jacobian(phys, chem: Chemistry, rho_s, t, src):
    """Finite-difference chemistry Jacobian with respect to the species
    densities at fixed t and Gibbs term (reference: chemistry.cpp:127-176).
    Returns (..., N, N) with N = ns+4; momentum and energy rows and the
    energy column are zero."""
    ns = phys.ns
    N = ns + 4
    gibbs = gibbs_minimization(phys, t)
    rho = rho_s.sum(dim=0)
    h = 1.0e-10 * rho
    cols = []
    for cc in range(ns):
        pert = rho_s.clone()
        pert[cc] = pert[cc] + h
        w_p, _ = source_terms(phys, chem, pert, t, gibbs=gibbs)
        cols.append((w_p - src) / h[None])
    zero = torch.zeros_like(t)
    rows = [[zero] * N for _ in range(N)]
    for rr in range(ns):
        for cc in range(ns):
            rows[rr][cc] = cols[cc][rr]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def from_deck(deck, search_dirs=()) -> Chemistry | None:
    """The Chemistry configuration of the deck (None unless reacting)."""
    if deck["chemistryModel"] != "reacting":
        return None
    fluids = [f.nondimensionalize(deck.t_ref, deck.r_ref, deck.a_ref,
                                  deck.l_ref) for f in deck._fluid_props]
    reactions = load_mechanism(deck["chemistryMechanism"],
                               list(deck.species_names), deck.t_ref,
                               deck.l_ref, deck.a_ref,
                               search_dirs=search_dirs)
    return Chemistry(
        reactions=reactions,
        molar_mass=tuple(f.molar_mass for f in fluids),
        ref_p=fluids[0].ref_p,
        universal_r=fluids[0].universal_r,
        freezing_t=deck["freezingTemperature"],
    )
