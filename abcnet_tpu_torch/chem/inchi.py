"""InChI reader: ``InChI=1S/...`` strings -> Mol -> canonical SMILES.

Parity surface: the reference ingests InChI ground truth with RDKit's
``Chem.inchi.MolFromInchi`` and compares predictions against
``MolToSmiles(mol, isomericSmiles=False)``
(reference src/multi_proc_img2smiles2.py:329-352). RDKit and the
IUPAC InChI toolkit are not installed in this environment, so the
reader is built from scratch:

* formula, /c connectivity and /h hydrogen layers are parsed exactly;
* bond orders — which InChI does not store — are reconstructed by a
  valence-constrained search (iterative-deepening charge placement +
  backtracking bond-order matching against the chem-stack valence
  model, periodic.default_valences);
* mobile-H groups ``(Hn,a,b,...)`` use deterministic
  lowest-canonical-number placement. On tautomeric systems the chosen
  placement can differ from the InChI software's; the tautomer-exact
  metric (eval/scoring.py) absorbs exactly this class of divergence.
* /q (component charge) and /p (protonation) are honored; stereo
  layers (/b /t /m /s) and isotopes (/i) are intentionally ignored
  because the reference comparison target is non-isomeric SMILES.

InChI canonical numbering facts used here: heavy atoms are numbered
per component with carbon first, then the remaining elements in
alphabetical order, each element's atoms contiguous; hydrogens are
never numbered.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from . import periodic
from .mol import Atom, Mol, MolError

__all__ = ["parse_inchi", "inchi_to_smiles", "write_inchi",
           "smiles_to_inchi", "InchiError"]


class InchiError(MolError):
    pass


# Search budget for the bond-order / charge reconstruction: generous for
# any real molecule, bounded for adversarial graphs.
_NODE_BUDGET = 200_000


# ---------------------------------------------------------------------------
# Layer splitting
# ---------------------------------------------------------------------------

_FORMULA_TOKEN = re.compile(r"([A-Z][a-z]?)(\d*)")


def _parse_formula_component(f: str) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    pos = 0
    for m in _FORMULA_TOKEN.finditer(f):
        if m.start() != pos:
            raise InchiError(f"bad formula {f!r}")
        pos = m.end()
        counts[m.group(1)] = counts.get(m.group(1), 0) + int(m.group(2) or 1)
    if pos != len(f):
        raise InchiError(f"bad formula {f!r}")
    return counts


def _formula_components(formula: str) -> List[Dict[str, int]]:
    """Split ``2C2H6O.H2O`` into per-component element counts."""
    out: List[Dict[str, int]] = []
    for part in formula.split("."):
        m = re.match(r"^(\d+)([A-Z].*)$", part)
        mult, body = (int(m.group(1)), m.group(2)) if m else (1, part)
        counts = _parse_formula_component(body)
        if not counts:
            raise InchiError(f"empty formula component in {formula!r}")
        out.extend(dict(counts) for _ in range(mult))
    return out


def _layer_components(layer: Optional[str], n: int) -> List[Optional[str]]:
    """Split a ;-separated layer into exactly n component strings,
    expanding ``k*body`` multipliers; missing/empty slots become None."""
    if layer is None:
        return [None] * n
    out: List[Optional[str]] = []
    for part in layer.split(";"):
        m = re.match(r"^(\d+)\*(.*)$", part)
        mult, body = (int(m.group(1)), m.group(2)) if m else (1, part)
        out.extend([body if body else None] * mult)
    if len(out) < n:
        out.extend([None] * (n - len(out)))
    if len(out) != n:
        raise InchiError(f"layer has {len(out)} components, formula has {n}")
    return out


def _split_layers(s: str) -> Tuple[str, Dict[str, str]]:
    s = s.strip()
    if not s.startswith("InChI="):
        raise InchiError("missing InChI= prefix")
    body = s[len("InChI="):]
    m = re.match(r"^1S?/", body)
    if not m:
        raise InchiError(f"unsupported InChI version in {s[:20]!r}")
    parts = body[m.end():].split("/")
    formula = parts[0]
    layers: Dict[str, str] = {}
    for p in parts[1:]:
        if not p:
            continue
        tag = p[0]
        if tag in layers:
            # /i ... /h (isotopic H sublayer) etc. — keep the first
            # occurrence (the main layer); later duplicates belong to
            # ignored sublayers.
            continue
        layers[tag] = p[1:]
    return formula, layers


# ---------------------------------------------------------------------------
# Component layers
# ---------------------------------------------------------------------------

def _atom_symbols(counts: Dict[str, int]) -> List[str]:
    """InChI canonical element order: C first, then alphabetical; H is
    not a numbered atom."""
    symbols: List[str] = []
    if "C" in counts:
        symbols.extend(["C"] * counts["C"])
    for el in sorted(counts):
        if el in ("C", "H"):
            continue
        symbols.extend([el] * counts[el])
    return symbols


def _parse_connections(c: str, n_atoms: int) -> List[Tuple[int, int]]:
    """Parse a /c component: DFS spanning tree + inline ring closures.

    Grammar: atom numbers joined by '-', '(' pushes the current atom,
    ')' pops, ',' separates siblings inside parentheses (the current
    atom reverts to the branch point: ``5(2,3)4`` bonds 5-2, 5-3, 5-4).
    A number already seen closes a ring and leaves the current atom
    unchanged; a new number becomes the current atom.
    """
    bonds: List[Tuple[int, int]] = []
    seen = set()
    stack: List[int] = []
    cur: Optional[int] = None
    i = 0
    while i < len(c):
        ch = c[i]
        if ch.isdigit():
            j = i
            while j < len(c) and c[j].isdigit():
                j += 1
            num = int(c[i:j])
            i = j
            if not 1 <= num <= n_atoms:
                raise InchiError(f"atom {num} outside formula in /c{c}")
            if cur is not None:
                a, b = min(cur, num), max(cur, num)
                if a == b:
                    raise InchiError(f"self bond in /c{c}")
                bonds.append((a, b))
            if num not in seen:
                seen.add(num)
                cur = num
        elif ch == "(":
            stack.append(cur)
            i += 1
        elif ch == ")":
            if not stack:
                raise InchiError(f"unbalanced ) in /c{c}")
            cur = stack.pop()
            i += 1
        elif ch == ",":
            if not stack:
                raise InchiError(f"comma outside parentheses in /c{c}")
            cur = stack[-1]
            i += 1
        elif ch == "-":
            i += 1
        else:
            raise InchiError(f"unexpected {ch!r} in /c{c}")
    if stack:
        raise InchiError(f"unbalanced ( in /c{c}")
    # Duplicate bonds can only arise from malformed input.
    if len(set(bonds)) != len(bonds):
        raise InchiError(f"duplicate bond in /c{c}")
    return bonds


_H_SPEC = re.compile(r"^H(\d*)$")


def _expand_atom_list(tokens: Sequence[str]) -> List[int]:
    out: List[int] = []
    for t in tokens:
        if "-" in t:
            lo, hi = t.split("-")
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(t))
    return out


def _parse_h_layer(h: str, n_atoms: int) -> Tuple[List[int],
                                                  List[Tuple[int, List[int]]]]:
    """Parse a /h component into (fixed H per atom, mobile-H groups).

    Fixed grammar: comma-separated atom tokens where a token ending in
    ``H``/``H2``/``H3`` closes one spec — e.g. ``1-5H,7H2,9,10H3``.
    Mobile groups are parenthesized: ``(H2,9,10)`` = two H shared among
    atoms 9 and 10; a leading ``H-`` count also appears for charged
    mobile groups (``(H3-,...)``) — the sign is carried by /q|/p and is
    ignored here.
    """
    fixed = [0] * (n_atoms + 1)      # 1-based
    mobile: List[Tuple[int, List[int]]] = []
    rest = h
    for grp in re.finditer(r"\(([^)]*)\)", h):
        body = grp.group(1)
        parts = body.split(",")
        m = re.match(r"^H(\d*)-?$", parts[0])
        if not m:
            raise InchiError(f"bad mobile-H group ({body})")
        count = int(m.group(1) or 1)
        atoms = _expand_atom_list(parts[1:])
        mobile.append((count, atoms))
    rest = re.sub(r"\([^)]*\)", "", h).strip(",")
    pending: List[str] = []
    for tok in filter(None, rest.split(",")):
        m = re.match(r"^([0-9-]+)H(\d*)$", tok)
        if m:
            pending.append(m.group(1))
            n_h = int(m.group(2) or 1)
            for a in _expand_atom_list(pending):
                if not 1 <= a <= n_atoms:
                    raise InchiError(f"H on atom {a} outside formula")
                fixed[a] = n_h
            pending = []
        else:
            pending.append(tok)
    if pending:
        raise InchiError(f"trailing tokens in /h{h}")
    return fixed, mobile


def _parse_signed(layer: Optional[str]) -> int:
    if not layer:
        return 0
    return int(layer)


# ---------------------------------------------------------------------------
# Bond order + charge reconstruction
# ---------------------------------------------------------------------------

def _valence_options(sym: str, charge: int) -> Tuple[int, ...]:
    vals = periodic.default_valences(sym, charge)
    if not vals:
        # Unknown element: accept whatever connectivity it has (parity
        # with the molblock path's leave-hypervalent-alone behavior).
        return ()
    return vals


# Charge-placement preference: negative charges go to O/S first,
# positive to N first — matching how the InChI software re-protonates.
_NEG_PREF = {"O": 0, "S": 1, "Se": 1, "N": 2, "C": 3, "P": 3}
_POS_PREF = {"N": 0, "P": 1, "S": 2, "O": 3, "C": 4}


class _Budget:
    __slots__ = ("n",)

    def __init__(self, n: int) -> None:
        self.n = n

    def tick(self) -> bool:
        self.n -= 1
        return self.n > 0


def _match_orders(n_atoms: int, bonds: List[Tuple[int, int]],
                  unsat: List[Optional[int]],
                  budget: _Budget) -> Optional[List[int]]:
    """Find per-bond extra order x_e in {0,1,2} with, for every atom
    with a pinned unsaturation target u_i, sum over incident bonds = u_i.
    unsat[i] = None means unconstrained (unknown element). Returns the
    bond ORDER list (1 + extra) or None."""
    adj: List[List[int]] = [[] for _ in range(n_atoms)]
    for e, (a, b) in enumerate(bonds):
        adj[a - 1].append(e)
        adj[b - 1].append(e)
    rem = list(unsat)
    free = [len(adj[i]) for i in range(n_atoms)]
    extra = [0] * len(bonds)

    # Order bonds so both-constrained, low-degree atoms resolve first.
    def bond_key(e: int) -> Tuple[int, int]:
        a, b = bonds[e]
        ca = 0 if unsat[a - 1] is not None else 1
        cb = 0 if unsat[b - 1] is not None else 1
        return (ca + cb, min(len(adj[a - 1]), len(adj[b - 1])))

    order = sorted(range(len(bonds)), key=bond_key)

    def feasible(i: int) -> bool:
        r = rem[i]
        return r is None or 0 <= r <= 2 * free[i]

    def rec(k: int) -> bool:
        if not budget.tick():
            return False
        if k == len(order):
            return all(r is None or r == 0 for r in rem)
        e = order[k]
        a, b = bonds[e][0] - 1, bonds[e][1] - 1
        free[a] -= 1
        free[b] -= 1
        cap = 2
        if rem[a] is not None:
            cap = min(cap, rem[a])
        if rem[b] is not None:
            cap = min(cap, rem[b])
        for x in range(cap + 1):
            if rem[a] is not None:
                rem[a] -= x
            if rem[b] is not None:
                rem[b] -= x
            if feasible(a) and feasible(b):
                extra[e] = x
                if rec(k + 1):
                    return True
            if rem[a] is not None:
                rem[a] += x
            if rem[b] is not None:
                rem[b] += x
        extra[e] = 0
        free[a] += 1
        free[b] += 1
        return False

    if not all(feasible(i) for i in range(n_atoms)):
        return None
    if rec(0):
        return [1 + x for x in extra]
    return None


def _perceive(symbols: List[str], h: List[int],
              bonds: List[Tuple[int, int]],
              q: int) -> Tuple[List[int], List[int]]:
    """Reconstruct (charges, bond orders) for one component.

    Iterative deepening on the number of charged atoms (starting at the
    minimum |q| requires), then for each charge vector enumerate valence
    choices implicitly inside the bond-order matching by trying each
    allowed valence per atom (smallest first, multi-valent S/P/Se).
    """
    n = len(symbols)
    deg = [0] * (n + 1)
    for a, b in bonds:
        deg[a] += 1
        deg[b] += 1

    def unsat_options(i: int, charge: int) -> List[int]:
        vals = _valence_options(symbols[i], charge)
        if not vals:
            return [-1]  # sentinel: unconstrained
        out = [v - deg[i + 1] - h[i + 1] for v in vals]
        return [u for u in out if 0 <= u <= 2 * deg[i + 1] or
                (u == 0 and deg[i + 1] == 0)]

    # Candidate charge sites, cheapest first.
    def site_rank(i: int, c: int) -> int:
        pref = _NEG_PREF if c < 0 else _POS_PREF
        return pref.get(symbols[i], 9)

    budget = _Budget(_NODE_BUDGET)

    def try_charges(charged: List[Tuple[int, int]]) -> Optional[
            Tuple[List[int], List[int]]]:
        charges = [0] * n
        for i, c in charged:
            charges[i] = c
        per_atom = [unsat_options(i, charges[i]) for i in range(n)]
        if any(not opts for opts in per_atom):
            return None

        # Enumerate multi-valent choices lazily: DFS over atoms with >1
        # option (rare — S/P), pinning an unsat target per atom.
        multi = [i for i in range(n) if len(per_atom[i]) > 1]

        def rec_val(k: int, unsat: List[Optional[int]]) -> Optional[List[int]]:
            if k == len(multi):
                return _match_orders(n, bonds, unsat, budget)
            i = multi[k]
            for u in per_atom[i]:
                unsat[i] = None if u < 0 else u
                res = rec_val(k + 1, unsat)
                if res is not None:
                    return res
            unsat[i] = None
            return None

        base: List[Optional[int]] = [
            None if per_atom[i][0] < 0 else per_atom[i][0]
            if len(per_atom[i]) == 1 else 0
            for i in range(n)]
        orders = rec_val(0, base)
        if orders is None:
            return None
        return charges, orders

    # Forced-pattern pre-pass, keeping the general search small:
    #   * N with more bonds+H than its neutral valence -> +1 (quaternary
    #     N, N-oxide nitrogen);
    #   * nitro (N with >=2 terminal O, no H anywhere) -> N+ and one O-
    #     (InChI software reconstructs nitro charge-separated too).
    # Without this, a poly-nitro molecule needs 2 placed charges per
    # group and the subset search exhausts its node budget.
    adj_atoms: List[List[int]] = [[] for _ in range(n)]
    for a, b in bonds:
        adj_atoms[a - 1].append(b - 1)
        adj_atoms[b - 1].append(a - 1)
    forced: List[Tuple[int, int]] = []
    forced_set = set()

    def force(i: int, c: int) -> None:
        if i not in forced_set:
            forced.append((i, c))
            forced_set.add(i)

    for i in range(n):
        if symbols[i] != "N":
            continue
        if deg[i + 1] + h[i + 1] > 3:
            force(i, +1)
            continue
        if deg[i + 1] == 3 and h[i + 1] == 0:
            term_o = sorted(
                j for j in adj_atoms[i]
                if symbols[j] == "O" and deg[j + 1] == 1 and h[j + 1] == 0)
            if len(term_o) >= 2:
                force(i, +1)
                force(term_o[0], -1)

    if forced:
        q_rem = q - sum(c for _, c in forced)
        try:
            return _search_charges(symbols, h, bonds, q_rem, deg,
                                   unsat_options, site_rank, budget,
                                   try_charges, n, forced, forced_set)
        except InchiError:
            # The pattern guess was wrong for this molecule — fall back
            # to the unconstrained search below, with a fresh budget.
            budget.n = _NODE_BUDGET

    return _search_charges(symbols, h, bonds, q, deg, unsat_options,
                           site_rank, budget, try_charges, n, [], set())


def _search_charges(symbols, h, bonds, q, deg, unsat_options, site_rank,
                    budget, try_charges, n, forced, forced_set):
    """Iterative-deepening charge-site search around a fixed `forced`
    assignment; q is the REMAINING charge to distribute."""
    # Depth 0..: number of charged sites beyond the minimum. The cap
    # must cover poly-nitro molecules (each nitro forces a +/- pair):
    # 8 extra pairs = 4 nitro groups beyond the |q| minimum.
    min_sites = abs(q)
    free_sites = [i for i in range(n) if i not in forced_set]
    for extra_pairs in range(0, 9):
        n_sites = min_sites + 2 * extra_pairs
        if n_sites == 0:
            res = try_charges(list(forced))
            if res is not None:
                return res
            continue
        if n_sites > len(free_sites):
            break
        # n_pos - n_neg = q, n_pos + n_neg = n_sites.
        n_pos = (n_sites + q) // 2
        n_neg = n_sites - n_pos
        if n_pos < 0 or n_neg < 0 or (n_sites + q) % 2:
            continue
        pos_sites = sorted(free_sites, key=lambda i: (site_rank(i, +1), i))
        neg_sites = sorted(free_sites, key=lambda i: (site_rank(i, -1), i))

        found: List[Optional[Tuple[List[int], List[int]]]] = [None]

        def rec_sites(pi: int, ni: int, chosen: List[Tuple[int, int]],
                      np_left: int, nn_left: int) -> bool:
            if not budget.tick():
                return False
            if np_left == 0 and nn_left == 0:
                res = try_charges(list(forced) + chosen)
                if res is not None:
                    found[0] = res
                    return True
                return False
            if np_left > 0:
                for k in range(pi, len(pos_sites)):
                    i = pos_sites[k]
                    if any(i == j for j, _ in chosen):
                        continue
                    chosen.append((i, +1))
                    if rec_sites(k + 1, ni, chosen, np_left - 1, nn_left):
                        return True
                    chosen.pop()
                return False
            for k in range(ni, len(neg_sites)):
                i = neg_sites[k]
                if any(i == j for j, _ in chosen):
                    continue
                chosen.append((i, -1))
                if rec_sites(pi, k + 1, chosen, np_left, nn_left - 1):
                    return True
                chosen.pop()
            return False

        if rec_sites(0, 0, [], n_pos, n_neg):
            return found[0]  # type: ignore[return-value]
    raise InchiError("no consistent bond-order/charge assignment")


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def parse_inchi(s: str) -> Mol:
    """Parse a standard InChI string into a sanitized Mol (kekulized
    orders, charges, pinned H counts). Raises InchiError on failure."""
    formula, layers = _split_layers(s)
    comps = _formula_components(formula)
    ncomp = len(comps)
    c_layers = _layer_components(layers.get("c"), ncomp)
    h_layers = _layer_components(layers.get("h"), ncomp)
    q_layers = _layer_components(layers.get("q"), ncomp)
    p_layers = _layer_components(layers.get("p"), ncomp)

    from .aromaticity import perceive_aromaticity

    mol = Mol()
    for ci in range(ncomp):
        counts = comps[ci]
        symbols = _atom_symbols(counts)
        n = len(symbols)
        if n == 0:
            # H-only components (e.g. free protons via /p): skip the
            # numbered-atom machinery.
            if counts.get("H"):
                for _ in range(counts["H"]):
                    mol.add_atom(Atom("H", charge=0, num_explicit_hs=0))
            continue
        bonds = (_parse_connections(c_layers[ci], n)
                 if c_layers[ci] else [])
        if h_layers[ci]:
            fixed, mobile = _parse_h_layer(h_layers[ci], n)
        else:
            fixed, mobile = [0] * (n + 1), []
        # Mobile H: deterministic capacity-fill placement — atoms in
        # canonical order each take H up to their neutral-valence
        # capacity before the next atom gets any (urea's (H4,2,3,4)
        # puts 2H on each nitrogen, none on the oxygen). Leftovers
        # round-robin.
        deg = [0] * (n + 1)
        for a, b in bonds:
            deg[a] += 1
            deg[b] += 1
        for count, atoms in mobile:
            if not atoms:
                raise InchiError("empty mobile-H group")
            ordered = sorted(atoms)
            left = count
            for a in ordered:
                if left == 0:
                    break
                vals = periodic.default_valences(symbols[a - 1], 0)
                cap = (max(vals) - deg[a] - fixed[a]) if vals else 0
                take = min(left, max(cap, 0))
                fixed[a] += take
                left -= take
            for k in range(left):
                fixed[ordered[k % len(ordered)]] += 1
        q = _parse_signed(q_layers[ci])
        p = _parse_signed(p_layers[ci])
        # Protonation: /p adds (removes) H+ — adjust an eligible
        # heteroatom's H count; the charge lands with the proton.
        if p:
            q += p
            need = abs(p)
            pref = _POS_PREF if p > 0 else _NEG_PREF
            sites = sorted((i for i in range(n) if symbols[i] != "C"),
                           key=lambda i: (pref.get(symbols[i], 9), i)) or \
                list(range(n))
            for i in sites:
                if need == 0:
                    break
                if p > 0:
                    fixed[i + 1] += 1
                    need -= 1
                elif fixed[i + 1] > 0:
                    fixed[i + 1] -= 1
                    need -= 1
            if need:
                raise InchiError("cannot apply /p protonation")
        h_list = [0] + [fixed[a] for a in range(1, n + 1)]
        charges, orders = _perceive(symbols, h_list, bonds, q)
        base = mol.num_atoms
        for i in range(n):
            mol.add_atom(Atom(symbols[i], charge=charges[i],
                              num_explicit_hs=h_list[i + 1]))
        for (a, b), o in zip(bonds, orders):
            mol.add_bond(base + a - 1, base + b - 1, order=o)
    mol.sanitize()
    perceive_aromaticity(mol)
    return mol


def inchi_to_smiles(inchi: Optional[str]) -> Optional[str]:
    """InChI -> non-isomeric canonical SMILES; None on any failure.

    Reference parity: inchi2smiles (multi_proc_img2smiles2.py:329-346)
    = MolFromInchi + MolToSmiles(isomericSmiles=False)."""
    if inchi is None:
        return None
    from .smiles import to_smiles
    try:
        mol = parse_inchi(inchi)
        mol = mol.remove_explicit_h_atoms()
        return to_smiles(mol, canonical=True, isomeric=False)
    except MolError:
        return None


# ---------------------------------------------------------------------------
# Writer (reader-compatible, non-official numbering)
# ---------------------------------------------------------------------------

def _ranges(atoms: List[int]) -> str:
    """Compress a sorted 1-based atom list into InChI range notation."""
    out = []
    i = 0
    while i < len(atoms):
        j = i
        while j + 1 < len(atoms) and atoms[j + 1] == atoms[j] + 1:
            j += 1
        out.append(str(atoms[i]) if j == i
                   else f"{atoms[i]}-{atoms[j]}")
        i = j + 1
    return ",".join(out)


def write_inchi(mol: Mol) -> str:
    """Serialize a Mol into a reader-compatible InChI string.

    The element-block numbering rule (C first, then alphabetical) is
    honored, but WITHIN a block atoms are ordered by the chem stack's
    canonical ranks, not by the IUPAC InChI canonicalization — and
    mobile (tautomeric) hydrogens are written at their fixed positions
    rather than as (Hn,...) groups. The output is therefore a valid
    connectivity/H/charge description that parse_inchi round-trips
    exactly, but NOT byte-identical to the official InChI of the same
    molecule (the reference's smiles2inchi emits official strings via
    the IUPAC library, multi_proc_img2smiles2.py:311-326; replicating
    its normalization + canonical numbering is out of scope). Used for
    round-trip fuzz validation of the reader and for InChI export where
    official canonicality is not required. Stereo and isotopes are not
    written (matching the reader's scope).
    """
    from .smiles import canonical_ranks, _adjacency

    mol = mol.remove_explicit_h_atoms()
    n = mol.num_atoms
    if n == 0:
        raise InchiError("empty molecule")
    if any(a.symbol == "H" for a in mol.atoms):
        # Hydrogens are never numbered atoms in InChI; charged/bridging
        # H (e.g. a bare proton) would need /p bookkeeping this writer
        # does not produce.
        raise InchiError("explicit H atom not representable")
    ranks = canonical_ranks(mol, _adjacency(mol))

    # Connected components, then per-component numbering: carbons
    # first, heteroatoms alphabetical, canonical rank within a block.
    comp = [-1] * n
    comps: List[List[int]] = []
    for s in range(n):
        if comp[s] >= 0:
            continue
        ci = len(comps)
        stack, members = [s], []
        comp[s] = ci
        while stack:
            a = stack.pop()
            members.append(a)
            for b in mol.neighbors(a):
                if comp[b] < 0:
                    comp[b] = ci
                    stack.append(b)
        comps.append(members)
    # Component order: by formula string (deterministic).
    def comp_formula(members: List[int]) -> str:
        counts: Dict[str, int] = {}
        nh = 0
        for a in members:
            counts[mol.atoms[a].symbol] = counts.get(
                mol.atoms[a].symbol, 0) + 1
            nh += mol.atoms[a].total_hs
        parts = []
        order = ([("C", counts["C"])] if "C" in counts else [])
        if "C" in counts and nh:
            order.append(("H", nh))
        rest = sorted(k for k in counts if k not in ("C", "H"))
        if "C" not in counts:
            # Hill order without carbon: everything alphabetical, H
            # merged into the element list.
            allc = dict(counts)
            if nh:
                allc["H"] = allc.get("H", 0) + nh
            order = [(k, allc[k]) for k in sorted(allc)]
            rest = []
        for sym, c in order + [(k, counts[k]) for k in rest]:
            parts.append(sym + (str(c) if c > 1 else ""))
        return "".join(parts)

    comps.sort(key=lambda m: (comp_formula(m), min(ranks[a] for a in m)))

    formulas, c_parts, h_parts, q_parts = [], [], [], []
    for members in comps:
        formulas.append(comp_formula(members))
        order = sorted(members, key=lambda a: (
            0 if mol.atoms[a].symbol == "C" else 1,
            mol.atoms[a].symbol, ranks[a]))
        num = {a: i + 1 for i, a in enumerate(order)}
        # /c: DFS from atom 1; branches parenthesized, ring closures
        # emitted once at first encounter from the lower-visit side.
        visited = set()
        emitted = set()

        def visit(a: int) -> str:
            visited.add(a)
            nbrs = sorted(mol.neighbors(a), key=lambda b: num[b])
            segs = []
            for b in nbrs:
                e = (min(a, b), max(a, b))
                if e in emitted:
                    continue
                emitted.add(e)
                if b in visited:
                    segs.append(str(num[b]))      # ring closure
                else:
                    segs.append(visit(b))
            if not segs:
                return str(num[a])
            return (str(num[a])
                    + "".join(f"({s})" for s in segs[:-1])
                    + "-" + segs[-1])

        root = order[0]
        c_parts.append(visit(root) if len(members) > 1 else None)
        if len(visited) != len(members):
            raise InchiError("disconnected component during /c write")
        # /h: group by H count.
        by_h: Dict[int, List[int]] = {}
        for a in members:
            th = mol.atoms[a].total_hs
            if th > 0:
                by_h.setdefault(th, []).append(num[a])
        h_parts.append(",".join(
            _ranges(sorted(by_h[c])) + "H" + (str(c) if c > 1 else "")
            for c in sorted(by_h)) or None)
        q = sum(mol.atoms[a].charge for a in members)
        q_parts.append(f"{q:+d}" if q else None)

    out = ["InChI=1S", ".".join(formulas)]
    for tag, parts in (("c", c_parts), ("h", h_parts), ("q", q_parts)):
        if any(p for p in parts):
            out.append(tag + ";".join(p or "" for p in parts))
    return "/".join(out)


def smiles_to_inchi(smiles: Optional[str]) -> Optional[str]:
    """SMILES -> reader-compatible InChI; None on failure. Role parity
    with the reference's smiles2inchi (multi_proc_img2smiles2.py:311),
    with the non-official-numbering caveat of write_inchi."""
    if smiles is None:
        return None
    from .smiles import from_smiles
    try:
        return write_inchi(from_smiles(smiles))
    except MolError:
        return None
