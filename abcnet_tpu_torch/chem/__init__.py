"""Standalone chemistry core (no RDKit/Indigo dependency).

Provides the molecular graph, SMILES I/O, aromaticity model, MolBlock
I/O and fingerprints the rest of the framework builds on.
"""

from .mol import Atom, Bond, Mol, MolError, STEREO_NONE, STEREO_WEDGE, STEREO_HASH
from .smiles import from_smiles, to_smiles, canonical_smiles, SmilesError
from .aromaticity import kekulize, perceive_aromaticity

__all__ = [
    "Atom", "Bond", "Mol", "MolError",
    "STEREO_NONE", "STEREO_WEDGE", "STEREO_HASH",
    "from_smiles", "to_smiles", "canonical_smiles", "SmilesError",
    "kekulize", "perceive_aromaticity",
]
