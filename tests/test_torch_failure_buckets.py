"""eval/classify_results.py and eval/failure_taxonomy.py against the JAX
package's scripts/classify_results.py and scripts/failure_taxonomy.py, on
the CPU: the printout of each script's main() (sys.argv set; it reads the
CSV with pandas and imports JAX through scripts/decode_ceiling.py) and of
the port's main(argv) (the csv module) are equal line for line,
  * on logs/final_eval_step43100.csv (the TPU's 512 answers of the n=256
    evaluation), with max_prints 20 and 0 and n_per_lineage 256 and 100;
  * on a crafted CSV that reaches every `classify` bucket (ok, decode0,
    struct, stereo+, stereo-, stereo~, parse:<Exception> from a bad
    prediction and from an NA truth) with prediction cells that are
    empty, NA, None, nan, NULL and n/a, and every taxonomy axis (atoms+k
    and -k, fragmented, elem-swap, bond-order, rings, charge, hnum,
    aromatic-form) and the connectivity fallback; with n_per_lineage 256
    (one lineage) and 9 (both), and with a parse failure inside the
    taxonomy (its from_smiles made to raise on one SMILES on both sides:
    `classify` parses every struct row with the same from_smiles first,
    so a real parser never reaches that branch).
The digests chip_smoke.py holds the card's printouts of the 512-row file
to are those of the scripts' printouts. Every default NA string of
pandas.read_csv is read as pandas reads it, by both modules and by
cal-acc's reader (eval/scoring.py:read_results_csv, which read them as
predictions before).
"""

import hashlib
import os

import pytest

import chip_smoke
from abcnet_tpu_torch.eval import classify_results as cr
from abcnet_tpu_torch.eval import failure_taxonomy as ft
from abcnet_tpu_torch.eval import scoring
from abcnet_tpu_torch.eval.scoring import PANDAS_NA
from torch_parity import REPO, load_script, run_script_main

RESULTS = os.path.join(REPO, "logs", "final_eval_step43100.csv")

CRAFTED = """,smiles,smiles_pred
0,CCO,OCC
1,CCO,
2,CCO,NA
3,CCO,None
4,CCO,nan
5,CCCO,CCCCO
6,CCCO,CCO
7,CCOC,CC.OC
8,CCO,CCN
9,CC=C,CCC
10,C1CC1.C,CCCC
11,CC(=O)[O-],CC(=O)O
12,CCC,C[CH]C
13,Cc1ccccc1C,CC1=CC=C(C)C=C1
14,Cc1ccccc1C,Cc1ccc(C)cc1
15,CC(N)O,C[C@H](N)O
16,C[C@H](N)O,CC(N)O
17,C[C@H](N)O,C[C@@H](N)O
18,CCO,C((
19,NA,C
20,,CC
21,ClCCCCCl,BrCCCCBr
22,CCCCCC,CCCCCCC
23,c1ccccc1,C1CCCCC1
24,CCN,CCO
25,CCCl,CCBr
26,CC,NULL
27,CCS,n/a
28,CCCCN,CCCCO
"""
UNPARSED = "BrCCCCBr"      # the taxonomy's from_smiles raises on it


class ValenceError(Exception):
    pass


def raising_on_unparsed(from_smiles):
    def parse(smiles):
        if smiles == UNPARSED:
            raise ValenceError(smiles)
        return from_smiles(smiles)
    return parse


@pytest.fixture(scope="module")
def crafted(tmp_path_factory):
    path = tmp_path_factory.mktemp("crafted") / "results.csv"
    path.write_text(CRAFTED)
    return str(path)


_SCRIPT_OUT = {}


def script_lines(name, argv, capsys, unparsed=False):
    """The script's printed lines (cached by arguments)."""
    key = (name, tuple(argv), unparsed)
    if key not in _SCRIPT_OUT:
        mod = load_script(name)
        if unparsed:
            mod.from_smiles = raising_on_unparsed(mod.from_smiles)
        _SCRIPT_OUT[key] = run_script_main(mod, argv, capsys)
    return _SCRIPT_OUT[key]


def port_out(main, argv, capsys):
    capsys.readouterr()
    main([str(a) for a in argv])
    return capsys.readouterr().out


def assert_same_printout(name, main, argv, capsys, unparsed=False):
    want = script_lines(name, argv, capsys, unparsed)
    got = port_out(main, argv, capsys)
    assert got == "".join(x + "\n" for x in want)
    return got


def sha256(lines):
    return hashlib.sha256("".join(x + "\n" for x in lines).encode()
                          ).hexdigest()


@pytest.mark.parametrize("max_prints", [20, 0])
def test_classify_results_on_the_tpu_csv(capsys, max_prints):
    got = assert_same_printout("classify_results", cr.main,
                               [RESULTS, max_prints], capsys)
    lines = got.splitlines()
    assert lines[0] == "429/512 exact isomeric (0.838)"
    assert lines[1:5] == ["  stereo+: 1", "  stereo-: 9", "  stereo~: 7",
                          "  struct: 66"]
    assert got.count("  FAIL [") == min(max_prints, 512 - 429)


@pytest.mark.parametrize("max_prints", [20, 0, 3])
def test_classify_results_on_a_crafted_csv(crafted, capsys, max_prints):
    assert_same_printout("classify_results", cr.main,
                         [crafted, max_prints], capsys)
    buckets, fails, n = cr.classify_rows(
        list(zip(*cr.read_results_csv(crafted))))
    assert n == 29 and sum(buckets.values()) == n
    assert buckets == {"ok": 1, "decode0": 6, "struct": 16, "stereo+": 1,
                       "stereo-": 1, "stereo~": 1,
                       "parse:SmilesError": 1, "parse:AttributeError": 2}
    assert len(fails) == n - buckets["ok"]


@pytest.mark.parametrize("n_per_lineage", [256, 100])
def test_failure_taxonomy_on_the_tpu_csv(capsys, n_per_lineage):
    got = assert_same_printout("failure_taxonomy", ft.main,
                               [RESULTS, n_per_lineage], capsys)
    heads = [x for x in got.splitlines() if x.startswith("== ")]
    if n_per_lineage == 256:
        assert heads[0] == "== rdkit: 21 struct failures =="
    assert sum(int(h.split()[2]) for h in heads) == 66
    assert got.count("  EX [") == 6 * len(heads)


@pytest.mark.parametrize("n_per_lineage,unparsed",
                         [(256, False), (9, False), (256, True)])
def test_failure_taxonomy_on_a_crafted_csv(crafted, capsys, monkeypatch,
                                           n_per_lineage, unparsed):
    if unparsed:
        monkeypatch.setattr(ft, "from_smiles",
                            raising_on_unparsed(ft.from_smiles))
    got = assert_same_printout("failure_taxonomy", ft.main,
                               [crafted, n_per_lineage], capsys, unparsed)
    lineages = ft.taxonomy(list(zip(*cr.read_results_csv(crafted))),
                           n_per_lineage)
    assert sum(r["n"] for r in lineages.values()) == 16
    primary = sum((r["primary"] for r in lineages.values()),
                  start=ft.Counter())
    for axis in ("atoms+1", "atoms-1", "fragmented", "elem-swap",
                 "bond-order", "rings-1", "charge", "hnum",
                 "aromatic-form", "connectivity"):
        assert primary[axis] >= 1, axis
    assert ("parse:ValenceError" in got) == unparsed
    if n_per_lineage == 9:
        assert list(lineages) == ["rdkit", "indigo"]


def test_the_smoke_runs_digests_are_the_scripts_printouts(capsys):
    """chip_smoke.py holds the card's printouts of the 512-row file at
    the default arguments to these digests; here they are the scripts'."""
    want = chip_smoke.FAILURE_BUCKET_DIGESTS
    assert sorted(want) == ["classify_results", "failure_taxonomy"]
    assert want["classify_results"] == sha256(script_lines(
        "classify_results", [RESULTS, 20], capsys))
    assert want["failure_taxonomy"] == sha256(script_lines(
        "failure_taxonomy", [RESULTS, 256], capsys))


def test_na_cells_read_as_pandas_reads_them(tmp_path):
    """Every default NA string of pandas.read_csv, in either column, read
    as the scripts read it, and as the JAX package's cal-acc reads it
    (eval/scoring.py:read_results_csv, `smiles` or `InChI` truths); a
    missing smiles_pred column (the scripts' row.get)."""
    import math

    import pandas as pd

    cells = sorted(PANDAS_NA) + ["C", "na", "Nan", " NA"]
    path = tmp_path / "na.csv"
    path.write_text("smiles,smiles_pred\n" + "".join(
        f'"{c}","{c}"\n' for c in cells))
    df = pd.read_csv(path)
    truths, preds = cr.read_results_csv(str(path))
    assert len(truths) == len(df) == len(cells)
    for got, want in zip(truths, df["smiles"]):
        assert (math.isnan(got) and math.isnan(want)) if isinstance(
            want, float) else got == want
    assert preds == [p if isinstance(p, str) and p else None
                     for p in df["smiles_pred"]]
    cal_truths, cal_preds = scoring.read_results_csv(str(path))
    assert cal_preds == preds
    assert [t if isinstance(t, str) else "NaN" for t in cal_truths] == \
        [t if isinstance(t, str) else "NaN" for t in truths]
    path.write_text("InChI,smiles_pred\n" + "".join(
        f'"{c}","{c}"\n' for c in cells))
    from abcnet_tpu.chem.inchi import inchi_to_smiles
    df = pd.read_csv(path)
    assert scoring.read_results_csv(str(path)) == (
        [inchi_to_smiles(x) if isinstance(x, str) else None
         for x in df["InChI"]], preds)
    path.write_text("smiles\nCCO\nNA\n")
    truths, preds = cr.read_results_csv(str(path))
    assert truths[0] == "CCO" and math.isnan(truths[1])
    assert preds == [None, None]
