"""V2000 MolBlock writer/parser.

The decoder-side writer mirrors the MolBlock text the reference assembles
by hand (reference src/generate_smiles.py:10-105): counts line, atom
block with pixel-derived coordinates, bond block with wedge/hash stereo
flags, an ``M  CHG`` line, and Marvin-style ``MRV_IMPLICIT_H`` data
Sgroups marking aromatic heteroatoms that carry one implicit hydrogen.

The parser replaces ``Chem.MolFromMolBlock`` (generate_smiles.py:115):
it reads atoms/bonds/charges/Sgroups back into a Mol, kekulizes aromatic
(type-4) bonds, and resolves implicit hydrogens — honoring the
``IMPL_H1`` Sgroup exactly the way RDKit's Marvin extension does.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

from .aromaticity import perceive_aromaticity
from .mol import Atom, Mol, MolError, STEREO_HASH, STEREO_NONE, STEREO_WEDGE


def write_molblock(
    atom_symbols: Sequence[str],
    bonds: Sequence[Sequence[int]],        # 1-based [begin, end] pairs
    atom_charges: Sequence[int],
    bond_types: Sequence[int],             # 1..4 orders; 5=wedge, 6=hash
    atom_positions: Optional[Sequence[Sequence[float]]] = None,
    implicit_h_atoms: Sequence[int] = (),  # 1-based atoms with IMPL_H1
    coord_scale: float = 60.0,
) -> str:
    """Assemble a V2000 MolBlock string from decoded graph lists.

    Argument semantics are one-to-one with the reference's ``sdf2smiles``
    (generate_smiles.py:10): positions are decoder grid coordinates which
    get mapped to Angstrom-ish floats via x/coord_scale - 1.
    """
    lines = ["", "     abcnet", ""]
    lines.append(f"{len(atom_symbols):>3d}{len(bonds):>3d}"
                 "  0  0  0  0  0  0  0  0999 V2000")

    for i, sym in enumerate(atom_symbols):
        if atom_positions is not None:
            x = atom_positions[i][0] / coord_scale - 1.0
            y = atom_positions[i][1] / coord_scale - 1.0
        else:
            x = y = 0.0
        lines.append(f"{x:>10.4f}{y:>10.4f}{0.0:>10.4f} {sym:<3s} 0  0  0  0"
                     "  0  0  0  0  0  0  0  0")

    for i, (begin, end) in enumerate(bonds):
        btype = int(bond_types[i])
        if btype <= 4:
            stereo = 0
        else:
            stereo = 1 if btype == 5 else 6
            btype = 1
        lines.append(f"{int(begin):>3d}{int(end):>3d}{btype:>3d}{stereo:>3d}")

    charged = [(i + 1, c) for i, c in enumerate(atom_charges) if c != 0]
    if charged:
        body = "".join(f"{i:>4d}{c:>4d}" for i, c in charged)
        lines.append(f"M  CHG{len(charged):>3d}{body}")

    hs = list(implicit_h_atoms)
    if hs:
        lines.append("M  STY  {}".format(len(hs)) +
                     "".join(f"   {k + 1} DAT" for k in range(len(hs))))
        lines.append("M  SLB  {}".format(len(hs)) +
                     "".join(f"   {k + 1}   {k + 1}" for k in range(len(hs))))
        for k, atom_1based in enumerate(hs):
            lines.append(f"M  SAL   {k + 1}  1  {atom_1based}  ")
            lines.append(f"M  SDT   {k + 1} MRV_IMPLICIT_H    ")
            lines.append(f"M  SDD   {k + 1}     0.0000    0.0000    "
                         "DA    ALL  1       1    ")
            lines.append(f"M  SED   {k + 1} IMPL_H1")

    lines.append("M  END")
    lines.append("$$$$")
    return "\n".join(lines)


_IMPL_H_RE = re.compile(r"IMPL_H(\d+)")


def parse_molblock(text: str) -> Mol:
    """Parse a V2000 MolBlock into a sanitized Mol.

    Aromatic (type 4) bonds are kekulized; ``MRV_IMPLICIT_H IMPL_Hn``
    Sgroups pin the hydrogen count of the referenced atoms before
    kekulization, so aromatic nitrogens resolve pyrrole- vs pyridine-type
    exactly as RDKit resolves them for the reference pipeline.
    """
    lines = text.splitlines()
    if len(lines) < 4:
        raise MolError("molblock too short")
    counts = lines[3]
    try:
        num_atoms = int(counts[0:3])
        num_bonds = int(counts[3:6])
    except ValueError as e:
        raise MolError(f"bad counts line: {counts!r}") from e

    mol = Mol()
    for i in range(num_atoms):
        line = lines[4 + i]
        x = float(line[0:10])
        y = float(line[10:20])
        sym = line[31:34].strip()
        mol.add_atom(Atom(sym, x=x, y=y))

    aromatic_bonds: List[int] = []
    for i in range(num_bonds):
        line = lines[4 + num_atoms + i]
        a = int(line[0:3]) - 1
        b = int(line[3:6]) - 1
        btype = int(line[6:9])
        stereo = 0
        if len(line) >= 12:
            st = line[9:12].strip()
            stereo = int(st) if st else 0
        if stereo == 1:
            stereo = STEREO_WEDGE
        elif stereo == 6:
            stereo = STEREO_HASH
        else:
            stereo = STEREO_NONE
        if btype == 4:
            bi = mol.add_bond(a, b, order=1, aromatic=True, stereo=stereo)
            aromatic_bonds.append(bi)
        else:
            mol.add_bond(a, b, order=btype, aromatic=False, stereo=stereo)

    # Property block: charges and MRV_IMPLICIT_H Sgroups.
    sgroup_atoms: Dict[int, int] = {}    # sgroup id -> 1-based atom
    impl_h_sgroups: Dict[int, int] = {}  # sgroup id -> H count
    for line in lines[4 + num_atoms + num_bonds:]:
        if line.startswith("M  CHG"):
            fields = line.split()
            cnt = int(fields[2])
            vals = fields[3:3 + 2 * cnt]
            for k in range(cnt):
                idx = int(vals[2 * k]) - 1
                mol.atoms[idx].charge = int(vals[2 * k + 1])
        elif line.startswith("M  SAL"):
            fields = line.split()
            sid = int(fields[2])
            natoms = int(fields[3])
            if natoms >= 1:
                sgroup_atoms[sid] = int(fields[4])
        elif line.startswith("M  SED"):
            fields = line.split(None, 3)
            sid = int(fields[2])
            m = _IMPL_H_RE.search(line)
            if m:
                impl_h_sgroups[sid] = int(m.group(1))
        elif line.startswith("M  END"):
            break

    # Pin explicit H counts from Sgroups on atoms in aromatic systems —
    # this is what decides pyrrole- vs pyridine-type N at kekulization.
    arom_atoms = {a for bi in aromatic_bonds
                  for a in (mol.bonds[bi].a, mol.bonds[bi].b)}
    for sid, hcount in impl_h_sgroups.items():
        atom_1based = sgroup_atoms.get(sid)
        if atom_1based is None:
            continue
        idx = atom_1based - 1
        if 0 <= idx < mol.num_atoms:
            mol.atoms[idx].num_explicit_hs = hcount

    # Aromatic atoms NOT pinned by an Sgroup get zero hydrogens if they are
    # hetero (N/P) — matching RDKit's MolFromMolBlock treatment where an
    # aromatic N without the Marvin Sgroup is pyridine-type.
    for idx in arom_atoms:
        mol.atoms[idx].aromatic = True

    mol.sanitize()
    return mol


def molblock_to_smiles(text: str) -> Optional[str]:
    """MolBlock → canonical SMILES; None on failure (reference behavior:
    generate_smiles.py:115-117 returns None when RDKit rejects the block)."""
    from .smiles import to_smiles
    try:
        mol = parse_molblock(text)
        mol = mol.remove_explicit_h_atoms()
        perceive_aromaticity(mol)
        return to_smiles(mol, canonical=True)
    except MolError:
        return None
