"""Detection vocabularies — parity with reference src/utils.py:12-16.

The misspelled '<unkonw>' key is intentionally preserved as '<unknow>'-free
alias: we expose UNKNOWN = 0 and map unknown symbols there, as the
reference's ``atom_vocab.get(atom, 0)`` does.
"""

ATOM_VOCAB = {
    "<unknown>": 0, "C": 1, "N": 2, "O": 3, "P": 4, "F": 5, "Cl": 6,
    "S": 7, "Br": 8, "B": 9, "Se": 10, "I": 11, "H": 12, "Si": 13,
}
ATOM_DEVOCAB = {v: k for k, v in ATOM_VOCAB.items()}
ATOM_DEVOCAB[0] = "C"  # reference maps unknown back to carbon (img2smiles2.py:25)

CHARGE_VOCAB = {0: 0, 1: 1, -1: 2}
CHARGE_DEVOCAB = {v: k for k, v in CHARGE_VOCAB.items()}

BOND_VOCAB = {1: 0, 2: 1, 3: 2, 4: 3}
# Decoder mapping: class -> molblock bond type (5=wedge, 6=hash),
# parity with img2smiles2.py:28.
BOND_DEVOCAB = {0: 1, 1: 2, 2: 3, 3: 4, 4: 5, 5: 6}

NUM_ATOM_CLASSES = 14
NUM_CHARGE_CLASSES = 3
NUM_HS_CLASSES = 2
NUM_BOND_CLASSES = 6       # single, double, triple, aromatic, wedge, hash
NUM_OMEGA_BINS = 60        # 30 angular bins x 2 directions
GRID = 128                 # stride-4 output grid for 512x512 inputs
STRIDE = 4

# Production head widths (train.py:47): bond_type head is 6*60=360 wide.
HEAD_WIDTHS = (1, NUM_ATOM_CLASSES, NUM_CHARGE_CLASSES, NUM_HS_CLASSES,
               1, NUM_BOND_CLASSES * NUM_OMEGA_BINS, NUM_OMEGA_BINS,
               NUM_OMEGA_BINS)

# Focal-loss per-class weights for rare elements (train.py:16).
ATOM_TYPE_WEIGHTS = (1, 0.1, 0.1, 0.1, 1, 1, 1, 1, 1, 10, 10, 10, 10, 10)
