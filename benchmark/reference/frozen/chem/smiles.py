"""SMILES parsing and canonical writing.

Standalone replacement for the RDKit entry points the reference uses:
``Chem.MolFromSmiles`` + ``Chem.MolToSmiles(canonical=True)``
(reference src/img2smiles2.py:106-107, src/cal_acc.py:34-36).

Canonicalization is Morgan-style iterative refinement with a branching
tie-break (candidate canonical strings are generated for each member of
the first ambiguous equivalence class and the lexicographically smallest
wins), which yields a true canonical form for all chemically reasonable
graphs while staying deterministic and bounded on pathological ones.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from . import periodic
from .aromaticity import perceive_aromaticity
from . import ez as _ez
from . import stereo as _stereo
from .mol import Atom, Bond, Mol, MolError

_BRACKET_RE = re.compile(
    r"\[(?P<isotope>\d+)?"
    r"(?P<symbol>se|as|te|si|[A-Z][a-z]?|[bcnops])"
    r"(?P<chiral>@{1,2}(?:TH\d|AL\d|SP\d|TB\d+|OH\d+)?)?"
    r"(?P<hcount>H\d*)?"
    r"(?P<charge>\+\d+|-\d+|\++|-+)?"
    r"(?::(?P<map>\d+))?\]"
)

_ORGANIC_AROMATIC = {"b", "c", "n", "o", "p", "s"}
_BOND_CHARS = {"-": 1, "=": 2, "#": 3, ":": 1, "/": 1, "\\": 1}
_DIR_CHARS = {"/": 1, "\\": -1}


class SmilesError(MolError):
    pass


def from_smiles(s: str, sanitize: bool = True) -> Mol:
    """Parse a SMILES string into a sanitized Mol."""
    mol = Mol()
    s = s.strip()
    if not s:
        raise SmilesError("empty SMILES")

    prev_atom: Optional[int] = None
    pending_bond: Optional[int] = None       # explicit bond order
    pending_aromatic_bond = False
    pending_dir = 0                          # +1 '/', -1 '\\' (rise p->q)
    # bond idx -> (written p, written q, rise)
    dir_bonds: Dict[int, Tuple[int, int, int]] = {}
    stack: List[int] = []
    ring_open: Dict[int, tuple] = {}
    aromatic_flags: List[bool] = []
    # Chiral bookkeeping: atom -> (tag 1/2, neighbor-encounter order);
    # ring-closure slots hold a placeholder patched when the ring closes.
    chiral: Dict[int, Tuple[int, list]] = {}

    def _note_neighbor(atom: Optional[int], entry) -> None:
        if atom is not None and atom in chiral:
            chiral[atom][1].append(entry)

    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        atom_idx = None

        if c == "(":
            if prev_atom is None:
                raise SmilesError("branch before any atom")
            stack.append(prev_atom)
            i += 1
            continue
        if c == ")":
            if not stack:
                raise SmilesError("unmatched ')'")
            prev_atom = stack.pop()
            i += 1
            continue
        if c == ".":
            prev_atom = None
            pending_bond = None
            pending_aromatic_bond = False
            i += 1
            continue
        if c in _BOND_CHARS:
            pending_bond = _BOND_CHARS[c]
            pending_aromatic_bond = c == ":"
            pending_dir = _DIR_CHARS.get(c, 0)
            i += 1
            continue
        if c.isdigit() or c == "%":
            if c == "%":
                if i + 2 >= n or not s[i + 1:i + 3].isdigit():
                    raise SmilesError(f"bad ring closure at {i}")
                num = int(s[i + 1:i + 3])
                i += 3
            else:
                num = int(c)
                i += 1
            if prev_atom is None:
                raise SmilesError("ring closure before any atom")
            if num in ring_open:
                other, open_order, open_arom, token, open_dir = \
                    ring_open.pop(num)
                order = pending_bond if pending_bond is not None else open_order
                arom = (aromatic_flags[prev_atom] and aromatic_flags[other]
                        and order is None) or pending_aromatic_bond or open_arom
                new_bi = mol.add_bond(prev_atom, other,
                                      order=order if order is not None else 1,
                                      aromatic=arom)
                if pending_dir:
                    dir_bonds[new_bi] = (prev_atom, other, pending_dir)
                elif open_dir:
                    dir_bonds[new_bi] = (other, prev_atom, open_dir)
                _note_neighbor(prev_atom, other)
                if other in chiral:  # patch the open-time placeholder
                    lst = chiral[other][1]
                    for k, e in enumerate(lst):
                        if e is token:
                            lst[k] = prev_atom
            else:
                token = object()
                ring_open[num] = (prev_atom, pending_bond,
                                  pending_aromatic_bond, token,
                                  pending_dir)
                _note_neighbor(prev_atom, token)
            pending_bond = None
            pending_aromatic_bond = False
            pending_dir = 0
            continue

        # Atom token
        if c == "[":
            m = _BRACKET_RE.match(s, i)
            if not m:
                raise SmilesError(f"bad bracket atom at {i}: {s[i:i+12]}")
            sym = m.group("symbol")
            aromatic = sym[0].islower()
            sym = sym.capitalize() if aromatic else sym
            if sym not in periodic.ATOMIC_NUMBERS:
                raise SmilesError(f"unknown element {sym!r}")
            h = m.group("hcount")
            hcount = 0 if h is None else (1 if h == "H" else int(h[1:]))
            ch = m.group("charge") or ""
            if ch.startswith("+"):
                charge = int(ch[1:]) if ch[1:].isdigit() else len(ch)
            elif ch.startswith("-"):
                charge = -(int(ch[1:]) if ch[1:].isdigit() else len(ch))
            else:
                charge = 0
            iso = int(m.group("isotope")) if m.group("isotope") else 0
            atom_idx = mol.add_atom(Atom(sym, charge=charge,
                                         num_explicit_hs=hcount,
                                         aromatic=aromatic, isotope=iso))
            aromatic_flags.append(aromatic)
            ch_tag = m.group("chiral")
            if ch_tag:
                base = 2 if ch_tag.startswith("@@") or \
                    ch_tag.endswith(("TH2",)) else 1
                order0: list = []
                if prev_atom is not None:
                    order0.append(prev_atom)
                if hcount >= 1:
                    order0.append(_stereo.VIRTUAL)
                chiral[atom_idx] = (base, order0)
            i = m.end()
        else:
            two = s[i:i + 2]
            if two in ("Cl", "Br"):
                sym, aromatic = two, False
                i += 2
            elif c in "BCNOPSFI":
                sym, aromatic = c, False
                i += 1
            elif c in _ORGANIC_AROMATIC:
                sym, aromatic = c.upper(), True
                i += 1
            else:
                raise SmilesError(f"unexpected character {c!r} at {i}")
            atom_idx = mol.add_atom(Atom(sym, aromatic=aromatic))
            aromatic_flags.append(aromatic)

        if prev_atom is not None:
            order = pending_bond
            arom = (aromatic_flags[prev_atom] and aromatic_flags[atom_idx]
                    and order is None) or pending_aromatic_bond
            new_bi = mol.add_bond(prev_atom, atom_idx,
                                  order=order if order is not None else 1,
                                  aromatic=arom)
            if pending_dir:
                dir_bonds[new_bi] = (prev_atom, atom_idx, pending_dir)
            _note_neighbor(prev_atom, atom_idx)
        prev_atom = atom_idx
        pending_bond = None
        pending_aromatic_bond = False
        pending_dir = 0

    if ring_open:
        raise SmilesError(f"unclosed ring bonds: {sorted(ring_open)}")
    if stack:
        raise SmilesError("unclosed branch")

    # Resolve cis/trans from directional bonds (chem/ez.py).
    if dir_bonds:
        def _norm_dir(bi: int, nbr: int, end: int) -> int:
            """Rise normalized to nbr->end orientation; 0 if untagged."""
            if bi not in dir_bonds:
                return 0
            p, q, rise = dir_bonds[bi]
            return rise if (p, q) == (nbr, end) else -rise

        for dbi, dbond in enumerate(mol.bonds):
            if dbond.order != 2 or dbond.aromatic:
                continue
            da = db = 0
            xa = ya = None
            for sbi in mol.bond_indices_of(dbond.a):
                nbr = mol.bonds[sbi].other(dbond.a)
                d = _norm_dir(sbi, nbr, dbond.a)
                if d:
                    da, xa = d, nbr
                    break
            for sbi in mol.bond_indices_of(dbond.b):
                nbr = mol.bonds[sbi].other(dbond.b)
                d = _norm_dir(sbi, nbr, dbond.b)
                if d:
                    db, ya = d, nbr
                    break
            if da and db:
                rel = _ez.EZ_CIS if da == db else _ez.EZ_TRANS
                _ez.set_ez_from_pair(mol, dbi, xa, ya, rel)

    # Resolve chiral tags into reference-order parities (chem/stereo.py).
    for idx, (base, order0) in chiral.items():
        parsed = [e for e in order0 if isinstance(e, int)]
        if len(parsed) == 3 and _stereo.VIRTUAL not in parsed:
            parsed.append(_stereo.VIRTUAL)   # lone pair, last by convention
        ref = _stereo.reference_order(mol, idx)
        mol.atoms[idx].parity = _stereo.map_parity(base, parsed, ref)

    if sanitize:
        mol.sanitize()
    return mol


# ---------------------------------------------------------------------------
# Canonical ranks (Morgan-style refinement with branching tie-break)
# ---------------------------------------------------------------------------

def _initial_invariants(mol: Mol) -> List[Tuple]:
    ring_atoms = mol.ring_atom_flags()
    inv = []
    for i, a in enumerate(mol.atoms):
        inv.append((a.atomic_number, mol.degree(i), a.charge, a.total_hs,
                    a.aromatic, ring_atoms[i], a.isotope))
    return inv


def _adjacency(mol: Mol) -> List[List[Tuple[int, int]]]:
    """(bond_key, neighbor) rows, precomputed once per ranking call:
    _refine iterates to a fixpoint and the tie-break search re-refines
    up to _MAX_CANON_ATTEMPTS times, so hoisting the Mol accessor calls
    out of the loop matters (host-assembly profile: to_smiles is ~2/3
    of per-molecule decode cost, most of it inside _refine)."""
    return [[(4 if b.aromatic else b.order, b.other(i))
             for b in mol.bonds_of(i)] for i in range(mol.num_atoms)]


def _refine(mol: Mol, ranks: List[int],
            adj: Optional[List[List[Tuple[int, int]]]] = None) -> List[int]:
    n = mol.num_atoms
    if adj is None:
        adj = _adjacency(mol)
    while True:
        keys = []
        for i in range(n):
            nbrs = [(bk, ranks[j]) for bk, j in adj[i]]
            nbrs.sort()
            keys.append((ranks[i], nbrs))
        order = sorted(range(n), key=keys.__getitem__)
        new_ranks = [0] * n
        r = 0
        for j, i in enumerate(order):
            if j > 0 and keys[i] != keys[order[j - 1]]:
                r = j
            new_ranks[i] = r
        if new_ranks == ranks:
            return ranks
        ranks = new_ranks


def canonical_ranks(mol: Mol,
                    adj: Optional[List[List[Tuple[int, int]]]] = None
                    ) -> List[int]:
    n = mol.num_atoms
    inv = _initial_invariants(mol)
    order = sorted(range(n), key=lambda i: inv[i])
    ranks = [0] * n
    r = 0
    for j, i in enumerate(order):
        if j > 0 and inv[i] != inv[order[j - 1]]:
            r = j
        ranks[i] = r
    return _refine(mol, ranks, adj)


_MAX_CANON_ATTEMPTS = 128


def to_smiles(mol: Mol, canonical: bool = True,
              kekule: bool = False, isomeric: bool = True) -> str:
    """Write a (canonical) SMILES string.

    isomeric=False strips all stereo (parities, E/Z) before writing —
    MolToSmiles(isomericSmiles=False) parity (cal_acc.py:35-36)."""
    if mol.num_atoms == 0:
        return ""
    if not isomeric:
        mol = mol.strip_stereo()
    if not canonical:
        ranks = list(range(mol.num_atoms))
        return _write(mol, ranks, kekule)
    budget = [_MAX_CANON_ATTEMPTS]
    adj = _adjacency(mol)
    ranks = canonical_ranks(mol, adj)
    ctx = _write_ctx(mol, kekule)
    aut = list(range(mol.num_atoms))
    s, _ = _canon_search(mol, ranks, kekule, budget, adj, ctx, aut, 0)
    return s


def _aut_find(aut: List[int], i: int) -> int:
    root = i
    while aut[root] != root:
        root = aut[root]
    while aut[i] != root:
        aut[i], i = root, aut[i]
    return root


def _aut_union(aut: List[int], a: int, b: int) -> None:
    ra, rb = _aut_find(aut, a), _aut_find(aut, b)
    if ra != rb:
        aut[max(ra, rb)] = min(ra, rb)


def _canon_search(mol: Mol, ranks: List[int], kekule: bool,
                  budget: List[int],
                  adj: Optional[List[List[Tuple[int, int]]]] = None,
                  ctx: Optional["_WriteCtx"] = None,
                  aut: Optional[List[int]] = None,
                  depth: int = 0) -> Tuple[str, List[int]]:
    n = mol.num_atoms
    if len(set(ranks)) == n or budget[0] <= 0:
        return _write(mol, ranks, kekule, ctx), ranks
    # First tied class (smallest rank value with multiple members).
    by_rank: Dict[int, List[int]] = {}
    for i, r in enumerate(ranks):
        by_rank.setdefault(r, []).append(i)
    tied_rank = min(r for r, members in by_rank.items() if len(members) > 1)
    members = by_rank[tied_rank]
    best: Optional[Tuple[str, List[int]]] = None
    tried: List[int] = []
    for m in members:
        if budget[0] <= 0 and best is not None:
            break
        # Automorphism orbit pruning (nauty-style, ROOT level only:
        # there the stabilizer is the full automorphism group, so two
        # orbit-mates' subtrees are guaranteed to produce identical
        # minimal strings; at deeper nodes full-group orbits would
        # over-prune). Orbits are discovered below, from byte-equal
        # candidate strings.
        if aut is not None and depth == 0 and tried:
            fm = _aut_find(aut, m)
            if any(_aut_find(aut, t) == fm for t in tried):
                continue
        tried.append(m)
        budget[0] -= 1
        trial = list(ranks)
        # Promote one member strictly ahead of its class, then re-refine.
        for i in range(n):
            trial[i] = trial[i] * 2
        trial[m] -= 1
        trial = _refine(mol, trial, adj)
        cand = _canon_search(mol, trial, kekule, budget, adj, ctx,
                             aut, depth + 1)
        if best is None or cand[0] < best[0]:
            best = cand
        elif aut is not None and cand[0] == best[0] \
                and cand[1] is not best[1]:
            # Equal complete strings under two discrete labelings: the
            # composition best_labeling^-1 . cand_labeling is a graph
            # automorphism (the string fully encodes the labeled graph,
            # stereo tags re-expressed per labeling included). Record
            # its atom orbits for root pruning.
            rb, rc = best[1], cand[1]
            if len(set(rb)) == n and len(set(rc)) == n:
                inv_b = [0] * n
                for i, r in enumerate(rb):
                    inv_b[r] = i
                for i in range(n):
                    _aut_union(aut, i, inv_b[rc[i]])
    assert best is not None
    return best


# ---------------------------------------------------------------------------
# SMILES generation from ranks
# ---------------------------------------------------------------------------

def _atom_token(mol: Mol, idx: int, kekule: bool,
                chiral_tag: str = "") -> str:
    a = mol.atoms[idx]
    sym = a.symbol
    aromatic = a.aromatic and not kekule
    order_sum = mol.bond_order_sum(idx)
    bare_ok = False
    if a.charge == 0 and a.isotope == 0 and not chiral_tag:
        if aromatic:
            deg = mol.degree(idx)
            if sym == "C":
                bare_ok = a.total_hs == max(0, 3 - deg)
            elif sym in ("N", "P"):
                bare_ok = a.total_hs == 0
            elif sym in ("O", "S"):
                bare_ok = a.total_hs == 0 and sym in periodic.ORGANIC_SUBSET
            elif sym == "B":
                bare_ok = a.total_hs == 0
        elif sym in periodic.ORGANIC_SUBSET:
            bare_ok = a.total_hs == periodic.implicit_hydrogens(
                sym, 0, order_sum)
    if bare_ok:
        tok = sym.lower() if aromatic else sym
        return tok
    # Bracket form.
    body = sym.lower() if (aromatic and sym in periodic.AROMATIC_OK) else sym
    if a.isotope:
        body = f"{a.isotope}{body}"
    body += chiral_tag
    h = a.total_hs
    if h == 1:
        body += "H"
    elif h > 1:
        body += f"H{h}"
    if a.charge == 1:
        body += "+"
    elif a.charge == -1:
        body += "-"
    elif a.charge > 1:
        body += f"+{a.charge}"
    elif a.charge < -1:
        body += f"-{-a.charge}"
    return f"[{body}]"


def _bond_token(mol: Mol, bond: Bond, kekule: bool) -> str:
    if bond.aromatic and not kekule:
        return ""
    order = bond.order
    if order == 1:
        a_arom = mol.atoms[bond.a].aromatic
        b_arom = mol.atoms[bond.b].aromatic
        if a_arom and b_arom and not bond.aromatic and not kekule:
            return "-"  # biphenyl-style explicit single between rings
        return ""
    if order == 2:
        if bond.aromatic and kekule:
            return "="
        return "="
    if order == 3:
        return "#"
    return ""


class _WriteCtx:
    """Rank-independent emission state, computed ONCE per to_smiles call
    and reused across every candidate write of the canonical tie-break
    search (~6 writes/molecule on decoded aromatics — host-assembly
    profile: _atom_token + neighbor-list rebuilds were ~45% of
    canonicalization after the _refine adjacency hoist):
    - nbr[v]: (neighbor, bond_index) pairs in bond-index order, so a
      stable sort by ranks[u] alone reproduces the (ranks[u], bi) order.
    - atom_tok[v]: the emitted token for parity-free atoms (chiral tags
      are the only rank-dependent part of an atom token); None => derive
      per write via _chiral_tag.
    - bond_tok[bi]: _bond_token is rank-independent always.
    """

    __slots__ = ("nbr", "atom_tok", "bond_tok")

    def __init__(self, mol: Mol, kekule: bool):
        n = mol.num_atoms
        self.nbr: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
        for bi, b in enumerate(mol.bonds):
            self.nbr[b.a].append((b.b, bi))
            self.nbr[b.b].append((b.a, bi))
        self.atom_tok: List[Optional[str]] = [
            None if mol.atoms[v].parity else _atom_token(mol, v, kekule)
            for v in range(n)
        ]
        self.bond_tok: List[str] = [
            _bond_token(mol, b, kekule) for b in mol.bonds
        ]


def _write_ctx(mol: Mol, kekule: bool) -> "_WriteCtx":
    return _WriteCtx(mol, kekule)


def _write(mol: Mol, ranks: List[int], kekule: bool,
           ctx: Optional[_WriteCtx] = None) -> str:
    n = mol.num_atoms
    if ctx is None:
        ctx = _WriteCtx(mol, kekule)
    visited = [False] * n
    # Ring-closure bookkeeping.
    ring_bond_digit: Dict[int, int] = {}
    digit_free = list(range(1, 100))
    closures_at: Dict[int, List[Tuple[int, int]]] = {i: [] for i in range(n)}

    # Determine DFS trees and back edges per fragment, in canonical order.
    fragments: List[str] = []
    order_all = sorted(range(n), key=lambda i: ranks[i])
    for root in order_all:
        if visited[root]:
            continue
        # First pass: discover back edges with an explicit-stack DFS that
        # mirrors the writing pass exactly.
        frag = _write_fragment(mol, root, ranks, visited, kekule,
                               ring_bond_digit, digit_free, closures_at,
                               ctx)
        fragments.append(frag)
    return ".".join(fragments)


def _write_fragment(mol: Mol, root: int, ranks, visited, kekule,
                    ring_bond_digit, digit_free, closures_at,
                    ctx: _WriteCtx) -> str:
    # Pass 1: find spanning tree + back edges in deterministic rank order.
    parent_bond: Dict[int, int] = {}
    parent_of: Dict[int, int] = {}
    children: Dict[int, List[Tuple[int, int]]] = {}
    back_edges_at: Dict[int, List[Tuple[int, int]]] = {}
    seen = {root}
    seen_bonds = set()
    stack = [root]
    visit_order = []
    while stack:
        v = stack.pop()
        visit_order.append(v)
        # ctx.nbr[v] is in bond-index order; the stable sort by rank
        # reproduces the (ranks[u], bi) order of the original genexpr.
        nbrs = sorted(ctx.nbr[v], key=lambda t: ranks[t[0]])
        for (u, bi) in reversed(nbrs):
            if bi in seen_bonds:
                continue
            if u in seen:
                seen_bonds.add(bi)
                back_edges_at.setdefault(v, []).append((u, bi))
                back_edges_at.setdefault(u, []).append((v, bi))
            else:
                seen_bonds.add(bi)
                seen.add(u)
                parent_bond[u] = bi
                parent_of[u] = v
                children.setdefault(v, []).append((u, bi))
                stack.append(u)

    # Direction assignment for cis/trans double bonds (chem/ez.py):
    # dir_map[bond] = +1 '/' or -1 '\' as written parent->child.
    dir_map: Dict[int, int] = {}

    def _end_candidate(end: int, skip_bi: int):
        """Preferred tree single bond at a double-bond end: the parent
        bond, else the lowest-rank child. Returns (nbr, bi, sign) where
        normalized(nbr->end) = sign * dir_map[bi]."""
        pb = parent_bond.get(end)
        if pb is not None and pb != skip_bi:
            bond = mol.bonds[pb]
            if bond.order == 1 and not bond.aromatic:
                return parent_of[end], pb, +1
        for (u, bi) in sorted(children.get(end, []),
                              key=lambda t: ranks[t[0]]):
            bond = mol.bonds[bi]
            if bi != skip_bi and bond.order == 1 and not bond.aromatic:
                return u, bi, -1
        return None

    doubles = [bi for bi in seen_bonds
               if mol.bonds[bi].order == 2 and not mol.bonds[bi].aromatic
               and mol.bonds[bi].ez]
    for dbi in sorted(doubles, key=lambda bi: sorted(
            (ranks[mol.bonds[bi].a], ranks[mol.bonds[bi].b]))):
        dbond = mol.bonds[dbi]
        ca = _end_candidate(dbond.a, dbi)
        cb = _end_candidate(dbond.b, dbi)
        if ca is None or cb is None:
            continue
        xa, ba_, sa = ca
        yb, bb_, sb = cb
        rel = _ez.ez_for_pair(mol, dbi, xa, yb)
        if rel == _ez.EZ_NONE:
            continue
        # normalized(xa->a) == normalized(yb->b)  <=>  cis
        want_equal = rel == _ez.EZ_CIS
        na = dir_map.get(ba_, 0) * sa
        nb = dir_map.get(bb_, 0) * sb
        if na == 0 and nb == 0:
            na = 1
            dir_map[ba_] = sa  # sign * dir = +1
            dir_map[bb_] = (1 if want_equal else -1) * sb
        elif na != 0 and nb == 0:
            dir_map[bb_] = (na if want_equal else -na) * sb
        elif nb != 0 and na == 0:
            dir_map[ba_] = (nb if want_equal else -nb) * sa
        else:
            if (na == nb) != want_equal:
                # over-constrained conjugated system: leave as is
                continue

    # Pass 2: emit string via recursive descent in rank order.
    out: List[str] = []

    def _chiral_tag(v: int, ring_list, kid_list) -> str:
        """Re-express the atom's reference parity in the emission order:
        preceding atom, bracket H, ring-closure partners (digit
        positions), then children (chem/stereo.py conventions)."""
        parity = mol.atoms[v].parity
        if not parity:
            return ""
        emission: List[int] = []
        if v in parent_of:
            emission.append(parent_of[v])
        if mol.atoms[v].total_hs > 0:
            emission.append(_stereo.VIRTUAL)
        emission.extend(u for (u, _bi) in ring_list)
        emission.extend(u for (u, _bi) in kid_list)
        if len(emission) == 3 and _stereo.VIRTUAL not in emission:
            emission.append(_stereo.VIRTUAL)
        tag = _stereo.map_parity(parity, _stereo.reference_order(mol, v),
                                 emission)
        return {0: "", 1: "@", 2: "@@"}[tag]

    def emit(v: int) -> None:
        visited[v] = True
        ring_list = sorted(back_edges_at.get(v, []),
                           key=lambda t: ranks[t[0]])
        kid_list = sorted(children.get(v, []), key=lambda t: ranks[t[0]])
        tok = ctx.atom_tok[v]
        if tok is None:
            tok = _atom_token(mol, v, kekule,
                              _chiral_tag(v, ring_list, kid_list))
        out.append(tok)
        # Ring closures at this atom, in first-seen order.
        for (u, bi) in ring_list:
            if bi in ring_bond_digit:
                d = ring_bond_digit.pop(bi)
                digit_free.insert(0, d)
                digit_free.sort()
                out.append(_digit_str(d))
            else:
                d = digit_free.pop(0)
                ring_bond_digit[bi] = d
                out.append(ctx.bond_tok[bi])
                out.append(_digit_str(d))
        kids = kid_list
        for k, (u, bi) in enumerate(kids):
            bond_tok = ctx.bond_tok[bi]
            if bi in dir_map and mol.bonds[bi].order == 1 \
                    and not mol.bonds[bi].aromatic:
                bond_tok = "/" if dir_map[bi] > 0 else "\\"
            if k < len(kids) - 1:
                out.append("(")
                out.append(bond_tok)
                emit(u)
                out.append(")")
            else:
                out.append(bond_tok)
                emit(u)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        emit(root)
    finally:
        sys.setrecursionlimit(old)
    return "".join(out)


def _digit_str(d: int) -> str:
    return str(d) if d < 10 else f"%{d:02d}"


def canonical_smiles(s: str, isomeric: bool = True) -> str:
    """Parse, re-perceive aromaticity, and emit canonical SMILES."""
    mol = from_smiles(s)
    # Re-perceive from the kekulized structure so equivalent aromatic and
    # kekule inputs converge to one form.
    perceive_aromaticity(mol)
    return to_smiles(mol, canonical=True, isomeric=isomeric)
