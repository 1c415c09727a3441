"""Element data and valence model for the standalone chemistry core.

The valence semantics mirror what the reference obtains from RDKit:
implicit hydrogen counts follow the SMILES "organic subset" rule (fill up
to the smallest standard valence that accommodates the explicit bond
order sum), and the decoder-side sanity table matches
reference src/img2smiles2.py:32-34 (`atom_max_valence`).
"""

from __future__ import annotations

# Atomic numbers for every element the pipeline can meet. The detector
# vocabulary is the 14-class subset (see data/vocab.py).
ATOMIC_NUMBERS = {
    "H": 1, "B": 5, "C": 6, "N": 7, "O": 8, "F": 9,
    "Si": 14, "P": 15, "S": 16, "Cl": 17, "Ca": 20, "Zn": 30,
    "Se": 34, "Br": 35, "Ag": 47, "I": 53, "Te": 52, "As": 33, "Al": 13,
    # Salt counterions seen in external ground truth (ChEMBL-style
    # corpora ingested via SMILES or InChI, chem/inchi.py). No entry in
    # DEFAULT_VALENCES = no implicit hydrogens = bracket-atom semantics,
    # which is exactly right for bare metal ions.
    "Li": 3, "Na": 11, "Mg": 12, "K": 19, "Mn": 25, "Fe": 26, "Co": 27,
    "Ni": 28, "Cu": 29, "Rb": 37, "Sr": 38, "Pd": 46, "Cd": 48,
    "Sn": 50, "Sb": 51, "Cs": 55, "Ba": 56, "Pt": 78, "Au": 79,
    "Hg": 80, "Pb": 82, "Bi": 83,
}

SYMBOLS = {v: k for k, v in ATOMIC_NUMBERS.items()}

# Standard valence lists (ascending). Used for implicit-H computation:
# the smallest entry >= bond order sum wins; above the largest entry the
# atom gets zero implicit hydrogens (hypervalent, left as-is).
DEFAULT_VALENCES = {
    "H": (1,),
    "B": (3,),
    "C": (4,),
    "N": (3,),
    "O": (2,),
    "F": (1,),
    "Si": (4,),
    "P": (3, 5),
    "S": (2, 4, 6),
    "Cl": (1,),
    "Se": (2, 4, 6),
    "Br": (1,),
    "I": (1,),
    "Te": (2, 4, 6),
    "As": (3, 5),
    "Al": (3,),
    "Zn": (2,),
    "Ca": (2,),
    "Ag": (1,),
}

# Organic-subset elements that may be written without brackets in SMILES.
ORGANIC_SUBSET = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}

# Elements allowed in lowercase (aromatic) form in SMILES.
AROMATIC_OK = {"B", "C", "N", "O", "P", "S", "Se", "Si", "As", "Te"}

# Decoder-side max-valence sanity table; parity with the reference decode
# (reference src/img2smiles2.py:32-34).
ATOM_MAX_VALENCE = {
    "<unknow>": 4, "O": 2, "C": 4, "N": 3, "F": 1, "H": 1, "S": 6,
    "Cl": 1, "P": 5, "Br": 1, "B": 3, "I": 1, "Si": 4, "Se": 6,
    "Te": 6, "As": 3, "Al": 3, "Zn": 2, "Ca": 2, "Ag": 1,
}


def default_valences(symbol: str, charge: int = 0) -> tuple:
    """Valence list for (symbol, charge).

    Charge shifts the bonding capacity the same way RDKit's default model
    does for main-group elements: a positive charge on N/O/S/P adds one
    bonding slot; a negative charge removes one (O-, N-, C- etc.).
    Carbanion/carbocation both end at 3.
    """
    base = DEFAULT_VALENCES.get(symbol)
    if base is None:
        return ()
    if charge == 0:
        return base
    if symbol == "C":
        # C+ and C- both have three bonds.
        return (3,) if abs(charge) == 1 else base
    if symbol in ("N", "P", "As"):
        if charge > 0:
            return tuple(v + charge for v in base)
        return tuple(max(v + charge, 0) for v in base)
    if symbol in ("O", "S", "Se", "Te"):
        if charge > 0:
            return tuple(v + charge for v in base)
        return tuple(max(v + charge, 0) for v in base)
    if symbol == "B":
        if charge < 0:
            return (4,)
        return base
    if symbol in ("F", "Cl", "Br", "I"):
        if charge < 0:
            return (0,)
        if charge > 0:
            return (2,)
        return base
    return base


def implicit_hydrogens(symbol: str, charge: int, bond_order_sum: int) -> int:
    """Implicit hydrogen count under the organic-subset SMILES rule."""
    for v in default_valences(symbol, charge):
        if bond_order_sum <= v:
            return v - bond_order_sum
    return 0
