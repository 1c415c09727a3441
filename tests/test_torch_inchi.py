"""chem/inchi.py of the port against abcnet_tpu's, on the CPU: the cases
of tests/test_inchi.py read to the same SMILES by both packages, and
random molecules from random_molecule write the same InChI strings and
read back to the same SMILES. Then `cal-acc` with an InChI truth column
prints what the JAX package's cal-acc prints."""

import random

import pytest

from abcnet_tpu.chem import inchi as jinchi
from abcnet_tpu.chem.random_mol import random_molecule as jax_random_molecule
from abcnet_tpu_torch.chem import inchi as tinchi
from abcnet_tpu_torch.chem.random_mol import random_molecule
from test_inchi import CHARGED, GOLDENS, MULTI

CASES = GOLDENS + CHARGED + MULTI + [
    ("alanine-stereo",
     "InChI=1S/C3H7NO2/c1-2(4)3(5)6/h2H,4H2,1H3,(H,5,6)/t2-/m0/s1",
     "CC(N)C(=O)O"),
    ("garbage", "not an inchi", None),
    ("empty", "InChI=1S/", None),
    ("mismatch", "InChI=1S/CH4/c1-2/h1H4", None),
]


@pytest.mark.parametrize("name,inchi,smiles", CASES,
                         ids=[c[0] for c in CASES])
def test_reader_cases_equal(name, inchi, smiles):
    got = tinchi.inchi_to_smiles(inchi)
    assert got == jinchi.inchi_to_smiles(inchi)
    assert (got is None) == (smiles is None)
    if smiles is not None:
        assert tinchi.smiles_to_inchi(smiles) == jinchi.smiles_to_inchi(smiles)


def test_random_molecules_write_and_read_equal():
    r_t, r_j = random.Random(20260818), random.Random(20260818)
    for _ in range(40):
        m_t, m_j = random_molecule(r_t), jax_random_molecule(r_j)
        s_t, s_j = tinchi.write_inchi(m_t), jinchi.write_inchi(m_j)
        assert s_t == s_j
        assert tinchi.inchi_to_smiles(s_t) == jinchi.inchi_to_smiles(s_j)
        p_t, p_j = tinchi.parse_inchi(s_t), jinchi.parse_inchi(s_j)
        assert [(a.symbol, a.charge) for a in p_t.atoms] == \
            [(a.symbol, a.charge) for a in p_j.atoms]
        assert [(b.a, b.b, b.order) for b in p_t.bonds] == \
            [(b.a, b.b, b.order) for b in p_j.bonds]


def test_cal_acc_inchi_column_prints_what_jax_prints(tmp_path, capsys):
    import pandas as pd

    from abcnet_tpu.__main__ import main as jax_main
    from abcnet_tpu_torch.__main__ import main as torch_main

    csv = tmp_path / "r.csv"
    pd.DataFrame({
        "InChI": ["InChI=1S/C2H6O/c1-2-3/h3H,2H2,1H3",
                  "InChI=1S/C6H6/c1-2-4-6-5-3-1/h1-6H",
                  "InChI=1S/C3H7NO2/c1-2(4)3(5)6/h2H,4H2,1H3,(H,5,6)"
                  "/t2-/m0/s1",
                  "InChI=1S/C2H4O2/c1-2(3)4/h1H3,(H,3,4)/p-1", ""],
        "smiles_pred": ["CCO", "c1ccccc1", "C[C@@H](N)C(=O)O", "CC(=O)O",
                        "C"],
    }).to_csv(csv)
    jax_main(["cal-acc", str(csv)])
    want = capsys.readouterr().out
    torch_main(["cal-acc", str(csv)])
    assert capsys.readouterr().out == want
    assert "n=5" in want
