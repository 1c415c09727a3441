"""Perfect-target decode ceiling: classify every failure by stage.

    python -m abcnet_tpu_torch.eval.decode_ceiling [n_per_mode] [seed0]
        [oracle] [--device cuda]

Counterpart of the JAX package's scripts/decode_ceiling.py. Generated
molecules' ground-truth labels are encoded into dense targets, lifted to
perfect logits, sent to the device and run through the full decode
(`infer/decode.py:extract_peaks`, whose NMS/top-K runs in the CUDA
kernel there: one launch per sample) and the host assembly; each miss is
bucketed:

  struct   - non-isomeric canonicals differ (graph/connectivity error)
  stereo+  - constitution right, prediction has EXTRA stereo
  stereo-  - constitution right, prediction MISSING stereo
  stereo~  - constitution right, stereo tags conflict
  decode0  - assembly returned None
  parse    - canonicalization of one side raised (parse:<Exception>)

Targets come from the production target code (ops/targets.py, max-combine),
what the model is trained on; a third argument "oracle" uses the
sequential-overwrite numpy encoder (data/encode.py:encode_targets_np)
instead. For each mode (rdkit, then indigo) the seeds seed0, seed0+1,
... are drawn until n samples are accepted. Prints the JAX script's
per-mode table, then every failure with its seed. There are no weights,
so there is no --ckpt.
"""

from __future__ import annotations

import argparse
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..chem import canonical_smiles
from ..data.encode import (encode_targets_np, parse_atoms_string,
                           parse_bonds_string)
from ..data.generate import generate_sample
from ..infer.assemble import assemble_batch
from ..infer.decode import extract_peaks
from ..utils.device import resolve_device
from ..utils.diagnostics import (fake_logits_from_targets,
                                 perfect_logits_production)

MODES = ("rdkit", "indigo")


def classify(truth: str, pred: Optional[str]) -> str:
    if pred is None:
        return "decode0"
    try:
        iso_t, iso_p = canonical_smiles(truth), canonical_smiles(pred)
        non_t = canonical_smiles(truth, isomeric=False)
        non_p = canonical_smiles(pred, isomeric=False)
    except Exception as e:
        return f"parse:{type(e).__name__}"
    if iso_t == iso_p:
        return "ok"
    if non_t != non_p:
        return "struct"
    has_t = ("@" in iso_t) or ("/" in iso_t) or ("\\" in iso_t)
    has_p = ("@" in iso_p) or ("/" in iso_p) or ("\\" in iso_p)
    if has_p and not has_t:
        return "stereo+"
    if has_t and not has_p:
        return "stereo-"
    return "stereo~"


@dataclass
class ModeResult:
    """One mode's run: samples made, bucket counts, and every failure as
    (seed, bucket, truth, prediction); `outcomes` holds (seed, bucket,
    prediction) of every sample in order."""
    mode: str
    made: int = 0
    buckets: Dict[str, int] = field(default_factory=dict)
    fails: List[Tuple[int, str, str, Optional[str]]] = field(
        default_factory=list)
    outcomes: List[Tuple[int, str, Optional[str]]] = field(
        default_factory=list)

    def lines(self) -> List[str]:
        """The JAX script's printout of this mode."""
        out = [f"== {self.mode}: {self.buckets.get('ok', 0)}/{self.made} =="]
        out += [f"  {k}: {self.buckets[k]}" for k in sorted(self.buckets)
                if k != "ok"]
        out += [f"  FAIL {s} [{b}]\n    T {t}\n    P {p}"
                for s, b, t, p in self.fails]
        return out


def perfect_logits(sample, oracle: bool = False) -> Dict[str, torch.Tensor]:
    """The (1, G, G, C) perfect logits of a sample, on the CPU."""
    if oracle:
        atoms = parse_atoms_string(sample.atoms_string)
        bonds = parse_bonds_string(sample.bonds_string)
        return fake_logits_from_targets(encode_targets_np(atoms, bonds))
    return perfect_logits_production(sample)


def decode_one(logits: Dict[str, torch.Tensor], device) -> Optional[str]:
    """The SMILES the decode assembles from one sample's logits, with the
    logits moved to `device` first (the peaks are picked there)."""
    peaks = extract_peaks({k: v.to(device) for k, v in logits.items()})
    return assemble_batch({k: v.cpu().numpy()
                           for k, v in peaks.items()})[0]


def ceiling(n: int = 150, seed0: int = 1000, oracle: bool = False,
            device="cuda", modes: Sequence[str] = MODES,
            verbose: bool = True) -> Dict[str, ModeResult]:
    """{mode: ModeResult} over the first n accepted samples of each mode
    from seeds seed0, seed0 + 1, ...; each mode's lines are printed as it
    ends when `verbose`."""
    dev = resolve_device(device)
    out = {}
    for mode in modes:
        res = ModeResult(mode)
        seed = seed0
        while res.made < n:
            sample = generate_sample(random.Random(seed), mode=mode)
            seed += 1
            if sample is None:
                continue
            res.made += 1
            pred = decode_one(perfect_logits(sample, oracle), dev)
            b = classify(sample.smiles, pred)
            res.buckets[b] = res.buckets.get(b, 0) + 1
            res.outcomes.append((seed - 1, b, pred))
            if b != "ok":
                res.fails.append((seed - 1, b, sample.smiles, pred))
        if verbose:
            for line in res.lines():
                print(line, flush=True)
        out[mode] = res
    return out


def main(argv=None) -> Dict[str, ModeResult]:
    p = argparse.ArgumentParser(prog="python -m abcnet_tpu_torch.eval."
                                     "decode_ceiling")
    p.add_argument("n_per_mode", nargs="?", type=int, default=150)
    p.add_argument("seed0", nargs="?", type=int, default=1000)
    p.add_argument("oracle", nargs="?", default="",
                   help='"oracle": the numpy encoder\'s targets')
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return ceiling(args.n_per_mode, args.seed0, args.oracle == "oracle",
                   args.device)


if __name__ == "__main__":
    main()
