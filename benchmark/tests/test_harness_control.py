"""The lower-precision control comes out not correct, and so does a run
whose timed path is broken underneath: each driven through the rest of a
run on the CPU at a size a test can hold (the look for a card skipped).

Controls: for the bf16 configuration the program's own int8 backbone;
for the int8 backbone the reference quantized at 4 bits, put in the
program's place. Faults: half of each batch left out (its second half
served the first half's drawings); an answer altered where it is
produced: one SMILES changed in assembly, or in the device program's
peaks the sub-cell offsets zeroed, every bond's rho halved, or the atom
type head's channels rolled by one. The bf16 cell holds no rho or class
number (its control does not separate them from sound runs), so the
faults in the heads that both configurations share are planted in the
int8 cell, which holds them."""

import pytest
import torch

from .cpu_run import cpu_context, cpu_run
from benchmark import readings
from benchmark.kinds import convert

torch.set_num_threads(4)


def test_sound_run_is_correct():
    line, checks = cpu_run(cpu_context("unet_bf16.convert_b64"))
    assert line["correct"], checks
    assert line["attempted"] == 2 and line["failed"] <= 2


def test_bf16_control_fails():
    ctx = cpu_context("unet_bf16.convert_b64")
    ctx.make_program = lambda cfg, mix, calib: convert.Program(
        cfg, mix, calib, "cpu", backbone="int8")
    line, checks = cpu_run(ctx)
    assert not line["correct"], checks


def test_int8_control_fails():
    ctx = cpu_context("unet_int8.convert_b64")
    ctx.make_program = lambda cfg, mix, calib: readings.ReferenceProgram(
        cfg, calib, "cpu", cfg["int8"]["bits"] // 2)
    line, checks = cpu_run(ctx)
    assert not line["correct"], checks


class Broken(convert.Program):
    """The program with one fault planted in its timed path."""

    fault = None

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        run, fault = self.run, self.fault

        def dispatch(x):
            if fault == "half_batch":
                x = x.copy()
                half = len(x) // 2
                x[half:] = x[:len(x) - half]
            return run.dispatch(x)

        def fetch(h):
            peaks = dict(run.fetch(h))
            if fault == "rho_halved":
                peaks["bond_delta"] = peaks["bond_delta"] * 0.5
            elif fault == "sub_zeroed":
                for key in ("atom_sub", "bond_sub"):
                    peaks[key] = peaks[key] * 0
            elif fault == "class_rolled":
                peaks["atom_type"] = (peaks["atom_type"] + 1) % 14
            return peaks
        self.run = type("Run", (), {"dispatch": staticmethod(dispatch),
                                    "fetch": staticmethod(fetch)})

    def assemble(self, peaks):
        out = super().assemble(peaks)
        if self.fault == "answer_altered":
            out = list(out)
            out[0] = (out[0] or "") + "C"
        return out


@pytest.mark.parametrize("cell,fault", [
    ("unet_bf16.convert_b64", "half_batch"),
    ("unet_bf16.convert_b64", "answer_altered"),
    ("unet_bf16.convert_b64", "sub_zeroed"),
    ("unet_int8.convert_b64", "rho_halved"),
    ("unet_int8.convert_b64", "class_rolled"),
    ("unet_int8.convert_b64", "sub_zeroed"),
])
def test_fault_fails(cell, fault):
    ctx = cpu_context(cell)

    def make(cfg, mix, calib):
        Broken.fault = fault
        return Broken(cfg, mix, calib, "cpu")
    ctx.make_program = make
    line, checks = cpu_run(ctx)
    assert not line["correct"], checks
