"""Traffic kind `convert_seeded`: the conversion loop of kind `convert`
for a configuration whose weights are seeded, not trained (the CBAM
U-Net, `unet_cbam_bf16`).

Set-up first builds the configuration's snapshot in a temporary
directory (benchmark/cbam_weights.py: the seeded kernels, the committed
BatchNorm statistics and head biases, checked by their sha256), then
runs `convert.run` with the configuration's `weights` pointing at it:
the program (`convert.Program`) loads it through
models/weights.py:load_weights, the CLI's path, and the comparison's
plain reference (reference/unet_cbam.py) loads the same file. The mix
file holds what convert's does.

`compare` judges the program's peaks and SMILES with check.Tally,
check._compare_image, reference/decode.py and the frozen assembler,
against the CBAM reference in float32. A control (`variant` "no_max" or
"fp8" of the reference) takes the program's place in
`ControlProgram`, for the readings that set the limits
(benchmark/tools/readings_seeded.py) and the tests.
"""

from __future__ import annotations

import inspect
import shutil
import tempfile
from typing import Dict, List, Optional

import numpy as np

from .. import cbam_weights, check
from ..reference import decode as ref_decode
from ..reference import unet_cbam as ref_cbam
from . import convert
from .convert import Program  # noqa: F401  (run.py builds it by kind)


def require_serving_contract() -> None:
    """Exit at once where the program cannot serve the model through its
    pipeline (a checkout whose UNetCBAM has no `dense_heads`)."""
    from abcnet_tpu_torch.models.unet_cbam import UNetCBAM

    if "dense_heads" not in inspect.signature(UNetCBAM.forward).parameters:
        raise SystemExit("error: this program's UNetCBAM has no serving "
                         "contract (dense_heads, return_features)")


def run(ctx) -> Dict:
    """One run of the cell: the snapshot built, then `convert.run`."""
    require_serving_contract()
    tmp = tempfile.mkdtemp(prefix="seeded_weights_")
    try:
        ctx.cfg = dict(ctx.cfg, weights=cbam_weights.build_snapshot(
            ctx.cfg, tmp))
        return convert.run(ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def reference_peaks(w: Dict, images_u8: np.ndarray,
                    variant: Optional[str] = None, chunk: int = 16):
    """Yield (row offset, reference peaks, device maps) over `images_u8`
    in chunks: the CBAM reference (or its control `variant`) and the
    reference decode, on the weights' device."""
    dev = next(iter(w.values())).device
    for lo in range(0, len(images_u8), chunk):
        heads = ref_cbam.forward(w, ref_decode.binarize(
            images_u8[lo:lo + chunk], dev), variant)
        R, maps = ref_decode.decode(heads)
        del heads
        yield lo, R, maps


def compare(cfg: Dict, calib, batches: List[Dict], device) -> Dict:
    """check.compare_batches' numbers with the CBAM reference."""
    w = ref_cbam.load_snapshot(cfg["weights"], device)
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
        self.w = ref_cbam.load_snapshot(cfg["weights"], device)
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
