"""The frozen rooflines equal the chip smoke test's, and the model FLOP
counts equal what torch counts on the plain reference and on the port."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import chip_smoke
from benchmark.reference import bounds as B
from benchmark.reference import flops as FL
from benchmark.reference import model as RM
from benchmark.reference import serve as RS
from benchmark.tests.tiny import TINY_WIDTHS, BENCH

CASES = [((4, 816, 4, 64), [816, 500, 272, 90], True, 0, torch.bfloat16),
         ((4, 304, 4, 64), [304, 40, 7, 300], False, 0, torch.bfloat16),
         ((8, 408, 8, 128), [816] * 8, True, 408, torch.bfloat16),
         ((2, 12, 2, 16), [12, 5], True, 0, torch.float32)]


@pytest.mark.parametrize("shape,lens,causal,q_start,dtype", CASES)
def test_bounds_equal_the_chip_smoke_test_s(shape, lens, causal, q_start, dtype):
    q = torch.zeros(shape, dtype=dtype)
    k = torch.zeros((shape[0], max(lens), shape[2], shape[3]), dtype=dtype)
    kv = torch.tensor(lens)
    name = str(dtype).split(".")[-1]
    assert B.attention_bound(shape, name, lens, causal, q_start) == pytest.approx(
        chip_smoke.attention_bound(q, k, kv, causal, q_start)[:2], rel=1e-12)
    assert B.backward_bound(shape, name, lens, causal, q_start) == pytest.approx(
        chip_smoke.backward_bound(q, kv, causal, q_start), rel=1e-12)


def _config():
    with open(os.path.join(BENCH, "configs", "flagship_d256.json")) as f:
        return dict(json.load(f), **TINY_WIDTHS)


def _counted(fn):
    with FlopCounterMode(display=False) as m:
        fn()
    return m.get_total_flops()


def test_sp_flops_equal_torch_s_count_of_the_reference():
    torch.manual_seed(0)
    c = _config()
    b, t, s = 3, 11, 19
    params = RM.make_weights(RM.unast_spec(c), 1, "cpu")
    text = torch.randint(3, 46, (b, t))
    mel = torch.randn(b, s, c["num_mels"])
    lens_t, lens_s = torch.full((b,), t), torch.full((b,), s)
    with torch.no_grad():
        got = _counted(lambda: RM.sp_loss(params, RM.unast_state(c),
                                          torch.Generator().manual_seed(2),
                                          (text, mel, lens_t, lens_s), c))
    assert got == b * FL.sp_forward(c, t, s, full_square=True)
    assert FL.sp_step(c, [t] * b, [s] * b) == 3 * b * FL.sp_forward(c, t, s)


def test_fastspeech_flops_equal_torch_s_count_of_the_reference():
    c = _config()
    p = RM.make_weights(RS.fastspeech_spec(c), 3, "cpu")
    t, frames = 7, 24
    ids = torch.randint(3, 46, (1, t))
    d = torch.tensor([[4, 3, 3, 4, 3, 4, 3]])
    with torch.no_grad():
        got = _counted(lambda: RS.fastspeech(p, RS.fastspeech_state(c), c, ids,
                                             torch.tensor([t]), d, frames))
    assert got == FL.fastspeech_forward(c, t, frames)


def test_melgan_flops_equal_torch_s_count_of_the_port():
    from unast_tpu_torch.models import melgan as MG
    p = MG.generator_init(torch.Generator().manual_seed(0), "melgan", base=64)
    mel = torch.randn(2, 9, 80)
    with torch.no_grad():
        got = _counted(lambda: MG.generator_forward(p, mel))
    assert got == 2 * FL.melgan_forward(9, 80, 64)
