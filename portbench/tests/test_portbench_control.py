"""The comparison has to fail what it guards against.  On the CPU at small
geometries, whole runs of the harness (the look for a card skipped) with the
cells' own limits: the sound program passes; a step that returns its state
unchanged, an answer altered where it is produced, and the PnP injection
left out each come out not correct; and so does each cell's control (the
bf16 program with its int8 path on in its full selection; a w4a4 reference
in the int8 program's place).  The cells have no batch mean to halve and one chip, so
no other fault of the contract's list applies."""

import dataclasses

import pytest
import torch

from portbench import run as RUN
from portbench.tests.conftest import tiny_geometry

SEED = 2 ** 32 + 99
# (int8, dtype, widen): the bf16 cell's numbers are in units of what bf16
# rounding moves the reference, so its runs take bf16 and widths at which
# the int8 path stands to bf16 as at the published widths
CELLS = {"composite-720p": (False, "bfloat16", 4),
         "composite-512-stream-int8": (True, "float32", 1)}


def state_unchanged(pipe):
    pipe.ddim.step = lambda model_output, timestep, sample, *a, **k: sample


def answer_altered(pipe):
    step = pipe.ddim.step
    gen = torch.Generator().manual_seed(5)

    def altered(*a, **k):
        out = step(*a, **k)
        return out + 0.01 * out.std() * torch.randn(out.shape, generator=gen).to(out)
    pipe.ddim.step = altered


def injection_left_out(pipe):
    forward = pipe.unet.forward

    def without(*a, pnp=None, **k):
        if pnp is not None and not k.get("pnp_capture"):  # the edit branches' sites
            pnp = dataclasses.replace(pnp, gate_spatial=False, gate_temporal=False,
                                      gate_conv=False)
        return forward(*a, pnp=pnp, **k)
    pipe.unet.forward = without


def run(cell, **kw):
    int8, dtype, widen = CELLS[cell]
    return RUN.run_cell(cell, SEED, 0.0, False, device="cpu",
                        geometry=tiny_geometry(int8, dtype, widen=widen), **kw)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_program_passes(cell):
    res = run(cell)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [state_unchanged, answer_altered, injection_left_out],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_is_caught(cell, fault):
    res = run(cell, fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(cell):
    control = {"qmax": 7.0} if CELLS[cell][0] else {"int8": {"mode": "full"}}
    res = run(cell, control=control)
    assert not res["correct"], res["checks"]
