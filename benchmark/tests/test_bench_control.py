"""The control: the plain reference in fp8 (e4m3 forward, e5m2
gradients) put in the program's place fails the cells' limits: here at
tiny sizes against the tiny cells' limits, on the card at the cells' own
sizes against theirs."""

import os
import subprocess
import sys

import pytest
import torch

from benchmark.harness import core
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


def _fails(cell, readings):
    return any(readings[k] > limit for k, limit in cell.limits.items())


@pytest.mark.parametrize("name", ["tiny.sp", "tiny_remat.sp", "tiny.tts"])
@pytest.mark.parametrize("seed", [3, 2 ** 36 + 5, 77])
def test_the_fp8_control_fails_the_limits(root, name, seed):
    torch.set_num_threads(1)
    cell = core.Cell(root, name)
    assert _fails(cell, cell.entry().control(cell, seed, "cpu", "fp8"))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["flagship_d256.sp_warmup"])
def test_the_fp8_control_fails_the_limits_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("the control at a cell's own size runs on the card")
    cell = core.Cell(tiny.ROOT, name)
    for seed in (101, 202, 303):
        assert _fails(cell, cell.entry().control(cell, seed, "cuda", "fp8"))
