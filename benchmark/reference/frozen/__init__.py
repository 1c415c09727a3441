"""Frozen copies of the port's host assembler and the chemistry it needs.

`infer/assemble.py` (graph assembly from peak arrays to canonical
SMILES, its Python path: `assemble_smiles`), `chem/` (aromaticity, E/Z,
the molecule record, MolBlock, the periodic table, SMILES, stereo) and
`data/vocab.py`, copied from abcnet_tpu_torch as they stood when the
benchmark was defined, with the native (C++) path and the process pool
left out. The benchmark judges the program's SMILES with them, so a
change to the program cannot move the yardstick. Nothing here imports
the program.
"""
