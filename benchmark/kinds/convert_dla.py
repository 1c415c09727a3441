"""Traffic kind `convert_dla`: the conversion loop of kind `convert` for the
DLA-34 + DCN configuration (`dla34_dcn_bf16`), whose weights are seeded.

Set-up first exits, with a message, where the program has no
`abcnet_tpu_torch/models/dla_dcn.py` (a checkout that cannot serve the
model). It then builds the configuration's snapshot in a temporary
directory (benchmark/dla_weights.py: the seeded kernels, the committed
BatchNorm statistics and head biases, checked by their sha256) and runs
`convert.run` with the configuration's `weights` pointing at it: the
program (`convert.Program`) loads it through
models/weights.py:load_weights, the CLI's path, and the comparison's
plain reference (reference/dla_dcn.py) loads the same file. The mix file
holds what convert's does.

`compare` judges the program's peaks and SMILES with check.Tally,
check._compare_image, reference/decode.py and the frozen assembler,
against the DLA reference in float32. A control (`variant` "no_offset",
"no_mask" or "fp8" of the reference) takes the program's place in
`ControlProgram`, for the readings that set the limits
(benchmark/tools/readings_dla.py) and the tests.
"""

from __future__ import annotations

import importlib.util
import shutil
import tempfile
from typing import Dict, List, Optional

import numpy as np

from .. import check, dla_weights
from ..reference import decode as ref_decode
from ..reference import dla_dcn as ref_dla
from . import convert
from .convert import Program  # noqa: F401  (run.py builds it by kind)

PROGRAM_MODEL = "abcnet_tpu_torch.models.dla_dcn"


def require_model() -> None:
    """Exit at once where the program has no DLA-34 + DCN model."""
    try:
        found = importlib.util.find_spec(PROGRAM_MODEL) is not None
    except ImportError:
        found = False
    if not found:
        raise SystemExit(f"error: this program has no {PROGRAM_MODEL} "
                         "(abcnet_tpu_torch/models/dla_dcn.py): it cannot "
                         "serve the configuration dla34_dcn_bf16")


def run(ctx) -> Dict:
    """One run of the cell: the model looked for, the snapshot built, then
    `convert.run`."""
    require_model()
    tmp = tempfile.mkdtemp(prefix="seeded_weights_")
    try:
        ctx.cfg = dict(ctx.cfg, weights=dla_weights.build_snapshot(
            ctx.cfg, tmp))
        return convert.run(ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def reference_peaks(w: Dict, images_u8: np.ndarray,
                    variant: Optional[str] = None, chunk: int = 16):
    """Yield (row offset, reference peaks, device maps) over `images_u8`
    in chunks: the DLA reference (or its control `variant`) and the
    reference decode, on the weights' device."""
    dev = next(iter(w.values())).device
    for lo in range(0, len(images_u8), chunk):
        heads = ref_dla.forward(w, ref_decode.binarize(
            images_u8[lo:lo + chunk], dev), variant)
        R, maps = ref_decode.decode(heads)
        del heads
        yield lo, R, maps


def compare(cfg: Dict, calib, batches: List[Dict], device) -> Dict:
    """check.compare_batches' numbers with the DLA reference."""
    w = ref_dla.load_snapshot(cfg["weights"], device)
    assemble = check.frozen_assembler()
    t = check.Tally()
    for batch in batches:
        P, smiles = batch["peaks"], batch.get("smiles")
        for lo, R, maps in reference_peaks(w, batch["images"]):
            for b in range(R["atom_valid"].shape[0]):
                check._compare_image(t, P, R, b, lo + b, maps)
                if smiles is not None:
                    t.smiles_ref_bad += assemble(R, b) != smiles[lo + b]
            del maps
        if smiles is not None:
            for i, s in enumerate(smiles):
                t.smiles_bad += assemble(P, i) != s
    return t.numbers()


class ControlProgram:
    """A control of the reference in the program's place: a pipeline
    whose dispatch runs the reference's `variant` and decode and whose
    fetch hands back its peak dict; assembly by the frozen copy."""

    def __init__(self, cfg: Dict, variant: str, device):
        self.w = ref_dla.load_snapshot(cfg["weights"], device)
        self.variant = variant
        self._assemble = check.frozen_assembler()
        self.run = self

    def dispatch(self, images_u8):
        return [R for _, R, _ in reference_peaks(self.w, images_u8,
                                                 self.variant)]

    @staticmethod
    def fetch(parts):
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def assemble(self, peaks):
        return [self._assemble(peaks, i)
                for i in range(peaks["atom_valid"].shape[0])]

    def close(self):
        self.run = self.w = None
