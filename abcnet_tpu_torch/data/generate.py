"""Synthetic dataset generation: molecules -> images + label strings.

Parity surface with the reference generators:
  * label-string format  sym:x,y,charge[,hnums];...  and
    type:x,y,dx,dy,stereo,direction;...  exactly as produced by
    reference rdkit_img_generate.py:131-180 and
    indigo_img_generator.py:215-281 (x = row, y = col, deltas are half
    the bond vector with the dx>=0 / direction canonicalization applied
    downstream by the encoder).
  * two render lineages: "rdkit" mode draws kekulized structures and
    records kekule bond orders; "indigo" mode randomly dearomatizes and
    otherwise records aromatic bonds as type 4 with per-atom aromatic
    implicit-H counts (hnums) on hetero atoms.
  * CSV columns Smiles / ID / atoms_string / bonds_string / path with a
    two-level m/n image directory tree (rdkit_img_generate.py:219-246).

Unlike the reference this generator needs no ChEMBL input: molecules come
from chem.random_mol.

Own copy of abcnet_tpu/data/generate.py: the same draws from the same
`random.Random` stream, so a seed gives the JAX package's samples (bit
for bit where Pillow and FreeType are the same builds), and the dataset
CSV is written with the `csv` module in the bytes pandas writes.
"""

from __future__ import annotations

import csv
import math
import os
import random
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..chem import from_smiles, perceive_aromaticity, to_smiles
from ..chem.mol import Atom, Mol, STEREO_HASH, STEREO_NONE, STEREO_WEDGE
from ..chem.random_mol import random_molecule
from .layout import layout
from .render import RenderResult, RenderStyle, render


@dataclass
class Sample:
    """One labelled drawing, as the generator and the dataset CSV give it."""
    image: np.ndarray          # (512, 512) uint8 grayscale
    atoms_string: str
    bonds_string: str
    smiles: str                # canonical ground truth


def _add_explicit_hs(mol: Mol, rng: random.Random) -> Mol:
    """Add explicit H atoms (AddHs parity, rdkit_img_generate.py:66-67)."""
    out = mol.copy()
    out.assign_implicit_hydrogens()
    for i in range(mol.num_atoms):
        h = out.atoms[i].total_hs
        for _ in range(h):
            j = out.add_atom(Atom("H"))
            out.add_bond(i, j, 1)
        if out.atoms[i].num_explicit_hs is None:
            out.atoms[i].num_explicit_hs = None  # recomputed by sanitize
    out.assign_implicit_hydrogens()
    return out


def _wedges_from_parities(mol: Mol, coords) -> int:
    """Choose wedge/hash bonds that depict the molecule's tetrahedral
    parities — the role RDKit's wedge assignment plays when the
    reference renders an input corpus molecule (rdkit_img_generate.py
    draws whatever stereo the SMILES carries). ``coords`` are layout
    (x, y); orientation is decided in the pixel frame (row=y, col=x —
    render.py:137-139) that GT perception will later use, so the
    re-perceived parity equals the input parity by construction.
    Returns the number of centers successfully depicted."""
    from ..chem.stereo import (VIRTUAL, parity_from_positions,
                               reference_order)
    ring_bonds = mol.ring_bond_flags()
    done = 0
    for idx, a in enumerate(mol.atoms):
        if not a.parity:
            continue
        cands = []
        for bi in mol.bond_indices_of(idx):
            b = mol.bonds[bi]
            if b.order != 1 or b.aromatic or b.stereo:
                continue
            j = b.other(idx)
            # Prefer: neighbor not itself a stereocenter, acyclic bond,
            # terminal neighbor.
            badness = (mol.atoms[j].parity != 0, ring_bonds[bi],
                       mol.degree(j) > 1)
            cands.append((badness, bi, j))
        placed = False
        for _, bi, j in sorted(cands, key=lambda t: t[0]):
            order = reference_order(mol, idx)
            for z in (1.0, -1.0):
                positions = []
                for nb in order:
                    if nb == VIRTUAL:
                        positions.append(None)
                    else:
                        x, y = coords[nb]
                        positions.append((y, x, z if nb == j else 0.0))
                cx, cy = coords[idx]
                tag = parity_from_positions((cy, cx, 0.0), positions)
                if tag == a.parity:
                    b = mol.bonds[bi]
                    if b.a != idx:
                        b.a, b.b = b.b, b.a
                    b.stereo = STEREO_WEDGE if z > 0 else STEREO_HASH
                    placed = True
                    break
            if placed:
                break
        done += placed
    return done


def _decorate_stereo(mol: Mol, rng: random.Random) -> None:
    """Mark a few eligible single bonds as wedge/hash.

    The reference's stereo comes from real stereocenters via the SD block
    (rdkit_img_generate.py:77-87); here wedge/hash decorations train the
    same bond classes. Eligibility: acyclic single bond whose begin atom
    is a carbon with >= 3 heavy neighbors.
    """
    ring_bonds = mol.ring_bond_flags()
    for bi, b in enumerate(mol.bonds):
        if ring_bonds[bi] or b.order != 1 or b.aromatic or b.stereo:
            continue
        for begin in (b.a, b.b):
            a = mol.atoms[begin]
            # Only true sp3 candidates: every bond at the narrow end
            # single and non-aromatic, so the drawn wedge is a
            # perceivable stereocenter on both the GT and decode side.
            if a.symbol == "C" and mol.degree(begin) >= 3 and \
                    all(nb.order == 1 and not nb.aromatic
                        for nb in mol.bonds_of(begin)) and \
                    rng.random() < 0.06:
                if begin != b.a:
                    b.a, b.b = b.b, b.a
                b.stereo = STEREO_WEDGE if rng.random() < 0.5 else STEREO_HASH
                break


def generate_sample(rng: random.Random, size: int = 512,
                    mode: str = "mixed",
                    max_layout_tries: int = 3,
                    smiles: Optional[str] = None,
                    max_atoms: Optional[int] = None,
                    engine: str = "a") -> Optional[Sample]:
    """Generate one (image, labels, smiles) sample, or None on rejection.

    ``engine`` selects the drawing program: "a" (data/render.py, the
    PIL/TTF engine), "b" (data/render2.py, the stroke-font scanline
    engine), or "mix" (coin flip per sample) — the two-renderer pixel
    diversity of the reference's RDKit-SVG vs Indigo-PNG corpus
    (rdkit_img_generate.py:89-126 vs indigo_img_generator.py:51-294).
    ``mode`` (rdkit/indigo) stays independent: it controls the LABEL
    RECORD lineage (kekulized vs aromatic bond records), so all four
    mode x engine combinations are valid.

    smiles=None draws a random molecule; a given SMILES renders that
    molecule instead — the reference's given-corpus mode
    (rdkit_img_generate.py:219-246 renders an input ChEMBL CSV). Input
    tetrahedral stereo is depicted with wedges chosen to reproduce the
    parity (_wedges_from_parities); input E/Z tags are replaced by what
    the depicted geometry shows (the drawing IS the ground truth).

    Ground-truth SMILES are isomeric (the reference's GT comes from
    RDKit canonical SMILES, stereo included): after a successful render
    the wedge/hash bonds and double-bond geometry are perceived against
    the depicted coordinates, non-stereogenic tags pruned, and the
    canonical SMILES carries the resulting stereo — exactly what the
    decoder reproduces from the image (infer/assemble.py
    perceive_stereo)."""
    corpus = smiles is not None
    if corpus:
        try:
            mol = from_smiles(smiles)
        except Exception:
            return None
    else:
        # max_atoms caps random-molecule complexity — the
        # "reference-conditions" configuration uses drug-like ChEMBL
        # heavy-atom stats (the reference trains on renders of real
        # ChEMBL molecules, rdkit_img_generate.py:221, mean ~27 heavy
        # atoms) instead of this generator's default 8-40 range.
        if max_atoms is not None:
            mol = random_molecule(rng, max_atoms=max_atoms)
        else:
            mol = random_molecule(rng)
    perceive_aromaticity(mol)

    if mode == "mixed":
        mode = "rdkit" if rng.random() < 0.5 else "indigo"
    # Indigo lineage randomly dearomatizes (indigo_img_generator.py:68-69)
    # and renders at a random canvas size 320-512
    # (indigo_img_generator.py:53-55); the pipeline re-center-pads to 512.
    aromatic_records = mode == "indigo" and rng.random() < 0.5
    full_size = size
    if mode == "indigo":
        size = rng.randint(min(320, size), size)

    has_parities = any(a.parity for a in mol.atoms)
    if not corpus:
        _decorate_stereo(mol, rng)

    render_mol = mol
    if mode == "rdkit" and rng.random() < 0.2 and mol.num_atoms < 20 \
            and not has_parities:
        # (skipped for parity-carrying corpus molecules: adding explicit
        # H neighbors would change the reference order under the tags)
        render_mol = _add_explicit_hs(mol, rng)

    if engine == "mix":
        engine = "a" if rng.random() < 0.5 else "b"

    result: Optional[RenderResult] = None
    for t in range(max_layout_tries):
        coords = layout(render_mol, random.Random(rng.getrandbits(32)))
        if corpus and has_parities:
            for b in render_mol.bonds:   # re-chosen per layout try
                b.stereo = STEREO_NONE
            _wedges_from_parities(render_mol, coords)
        if engine == "b":
            from .render2 import RenderStyleB, render_b
            result = render_b(render_mol, coords,
                              RenderStyleB.random(rng, size), rng,
                              aromatic_render=aromatic_records)
        else:
            style = RenderStyle.random(rng, size)
            result = render(render_mol, coords, style, rng,
                            aromatic_render=aromatic_records)
        if result is not None and _stereo_ambiguous(render_mol, result):
            # Near-vertical wedge bonds sit on the omega direction-bit
            # margin (encode.py direction canonicalization); re-rotate.
            if t + 1 < max_layout_tries:
                result = None
                continue
        if result is not None:
            break
    if result is None:
        return None

    # Center-pad smaller canvases to the full size so downstream batch
    # stacking sees one shape; label coords shift with the pad (the
    # reference's dataset does this at load time, utils.py:56-61).
    full = full_size
    if result.image.shape != (full, full):
        h, w = result.image.shape
        ddx, ddy = (full - h) // 2, (full - w) // 2
        canvas = np.full((full, full), 255, np.uint8)
        canvas[ddx:ddx + h, ddy:ddy + w] = result.image
        result = RenderResult(canvas,
                              [(r + ddx, c + ddy) for r, c in result.atom_rc],
                              result.bond_px)

    atoms_string = _atoms_string(render_mol, result, aromatic_records)
    bonds_string = _bonds_string(render_mol, result, aromatic_records)

    # Isomeric ground truth: perceive the depicted wedges AND the drawn
    # double-bond geometry against the final pixel coordinates (same
    # convention the decoder sees; RDKit's MolFromMolBlock does both for
    # the reference). Pre-existing tags are cleared first — the drawing
    # is the ground truth.
    from ..chem.ez import assign_ez_from_coords, clear_ez
    from ..chem.stereo import (assign_parities_from_wedges,
                               clear_parities, prune_nonstereogenic)
    # Perceive at the DECODER's resolution: stride-4 grid cells, the
    # same int(px)//4 mapping the encoder uses (encode.py:89-90). GT
    # and decode then evaluate the same orientation functions on
    # identical coordinates, so quantization can never flip a parity
    # or cis/trans tag between the two sides (the residual 'stereo~'
    # ceiling bucket).
    from . import vocab as _vocab
    for i, (r, c) in enumerate(result.atom_rc):
        render_mol.atoms[i].x = float(int(r) // _vocab.STRIDE)
        render_mol.atoms[i].y = float(int(c) // _vocab.STRIDE)
    # H-removal BEFORE perception, matching the decode order
    # (assemble._graph_to_smiles perceives on the H-removed graph): an
    # AddHs-rendered stereocenter must be judged with the implicit-H
    # convention (virtual neighbor at the center) on BOTH sides — the
    # explicit H's drawn position is a 4th point that can judge a
    # near-flat configuration differently.
    gt_mol = render_mol.remove_explicit_h_atoms()
    clear_parities(gt_mol)
    clear_ez(gt_mol)
    assign_parities_from_wedges(gt_mol)
    assign_ez_from_coords(gt_mol)
    prune_nonstereogenic(gt_mol)
    out_smiles = to_smiles(gt_mol, canonical=True)
    return Sample(result.image, atoms_string, bonds_string, out_smiles)


def generate_samples(n: int, seed: int = 0,
                     mode: str = "mixed") -> List[Sample]:
    """The first n accepted samples of `mode` (engine a) from
    random.Random(seed): the corpus of `train --synthetic`
    (abcnet_tpu/__main__.py:57-64) and the held-out pools of the n=256
    evaluation (scripts/final_eval.py:35-42)."""
    rng = random.Random(seed)
    out: List[Sample] = []
    while len(out) < n:
        s = generate_sample(rng, mode=mode)
        if s is not None:
            out.append(s)
    return out


def _min_altitude(pts) -> float:
    """Smallest altitude of a triangle given 3 (r, c) points."""
    (ax, ay), (bx, by), (cx, cy) = pts
    area2 = abs((bx - ax) * (cy - ay) - (by - ay) * (cx - ax))
    sides = [math.hypot(bx - ax, by - ay), math.hypot(cx - bx, cy - by),
             math.hypot(ax - cx, ay - cy)]
    longest = max(sides)
    return area2 / longest if longest > 0 else 0.0


def _stereo_ambiguous(mol: Mol, result: RenderResult,
                      margin: float = 0.08,
                      min_alt_px: float = 5.0) -> bool:
    """True when the depicted stereo is quantization-fragile:

    * a wedge/hash bond within ~4.5 degrees of vertical in row
      coordinates — where the encoded direction bit and the omega bin
      disagree at quantization margins; or
    * the perceived parity's sign is a triangle area that stride-4
      grid rounding (+-2 px per coordinate) could flip. The 4-point
      determinant's z-term is +-z times the 2-D area of the three
      NON-wedge neighbors (4-neighbor centers) or of (center, n1, n2)
      (3-neighbor centers); require that triangle's minimum altitude
      to exceed min_alt_px.
    """
    for b in mol.bonds:
        if not b.stereo:
            continue
        r1, c1 = result.atom_rc[b.a]
        r2, c2 = result.atom_rc[b.b]
        length = math.hypot(r2 - r1, c2 - c1)
        if length > 0 and abs(r2 - r1) < margin * length:
            return True
        begin, far = b.a, b.b
        others = [result.atom_rc[nb] for nb in mol.neighbors(begin)
                  if nb != far]
        if len(others) >= 3:
            tri = others[:3]
        elif len(others) == 2:
            tri = [result.atom_rc[begin]] + others
        else:
            continue
        if _min_altitude(tri) < min_alt_px:
            return True
    return False


def _atoms_string(mol: Mol, result: RenderResult,
                  aromatic_records: bool) -> str:
    out = []
    for i, a in enumerate(mol.atoms):
        r, c = result.atom_rc[i]
        fields = f"{a.symbol}:{int(r)},{int(c)},{a.charge}"
        if aromatic_records:
            hnums = -1
            if a.aromatic and a.symbol != "C":
                hnums = min(a.total_hs, 1)
            fields += f",{hnums}"
        out.append(fields + ";")
    return "".join(out)


def _bonds_string(mol: Mol, result: RenderResult,
                  aromatic_records: bool) -> str:
    out = []
    for b in mol.bonds:
        r1, c1 = result.atom_rc[b.a]
        r2, c2 = result.atom_rc[b.b]
        x, y = (r1 + r2) / 2, (c1 + c2) / 2
        if b.aromatic and aromatic_records:
            btype = 4
        else:
            btype = b.order
        stereo = int(b.stereo)
        # Reference canonicalization: direction refers to whether the
        # stereo begin atom sits at larger row (rdkit_img_generate:166-176).
        if r1 <= r2:
            direction = 0
            dx, dy = (r2 - r1) / 2, (c2 - c1) / 2
        else:
            direction = 1
            dx, dy = (r1 - r2) / 2, (c1 - c2) / 2
        out.append(f"{btype}:{int(x)},{int(y)},{int(dx)},{int(dy)},"
                   f"{stereo},{direction};")
    return "".join(out)


def generate_dataset(out_dir: str, n: int, seed: int = 0,
                     mode: str = "mixed", size: int = 512,
                     verbose: bool = True,
                     smiles_list: Optional[List[str]] = None,
                     engine: str = "a") -> List[dict]:
    """Generate a dataset tree + CSV; returns the CSV's rows.

    smiles_list renders a GIVEN corpus instead of random molecules —
    the reference's main-loop role over its filtered ChEMBL CSV
    (rdkit_img_generate.py:219-246, indigo_img_generator.py:296-328);
    unrenderable entries are skipped like the reference's rejects. With
    a corpus, ``n`` caps the output (0 = all)."""
    from . import raster

    rng = random.Random(seed)
    rows: List[dict] = []
    made = 0
    attempt = 0
    if smiles_list is not None:
        limit = n if n else len(smiles_list)
    while made < (limit if smiles_list is not None else n):
        if smiles_list is not None:
            if attempt >= len(smiles_list):
                break
            smi = smiles_list[attempt]
        else:
            smi = None
        attempt += 1
        sample = generate_sample(rng, size=size, mode=mode, smiles=smi,
                                 engine=engine)
        if sample is None:
            continue
        m = made % 100
        nn = m % 10
        m = m // 10
        rel_dir = f"images/{m}/{nn}"
        abs_dir = os.path.join(out_dir, rel_dir)
        os.makedirs(abs_dir, exist_ok=True)
        mol_id = f"ABCT{made:08d}"
        rel_path = f"{rel_dir}/{mol_id}.png"
        raster.imwrite(os.path.join(out_dir, rel_path), sample.image)
        rows.append({
            "Smiles": sample.smiles,
            "ID": mol_id,
            "atoms_string": sample.atoms_string,
            "bonds_string": sample.bonds_string,
            "path": rel_path,
        })
        made += 1
        if verbose and made % 1000 == 0:
            print(f"generated {made}/{n} (attempts {attempt})")
    os.makedirs(out_dir, exist_ok=True)
    write_dataset_csv(os.path.join(out_dir, "dataset.csv"), rows)
    return rows


CSV_COLUMNS = ("Smiles", "ID", "atoms_string", "bonds_string", "path")


def write_dataset_csv(path: str, rows: List[dict]) -> None:
    """dataset.csv in the bytes of pandas' `DataFrame(rows).to_csv(path,
    index=False)`: minimal quoting, "\n" line ends; with no rows pandas
    writes one empty line, and so does this."""
    with open(path, "w", newline="") as f:
        if not rows:
            f.write("\n")
            return
        w = csv.writer(f, quoting=csv.QUOTE_MINIMAL, lineterminator="\n")
        w.writerow(CSV_COLUMNS)
        for r in rows:
            w.writerow([r[k] for k in CSV_COLUMNS])
