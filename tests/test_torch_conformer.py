"""The port's conformer speech encoder (models/conformer.py, the
networks.py dispatch, the CTC model over it) against the JAX package on
the CPU.

The same weights go to both sides: the port's inits as numpy trees
(tests/torch_family_golden.py), bridged into the port's trees. The JAX
side comes from the hash-guarded golden tests/goldens/torch_family.npz.
Tolerances, float32: outputs and BN statistics 1e-5; the CTC ids and
lengths exactly equal, with every greedy frame's top-1 / top-2 margin
asserted.
"""

import numpy as np
import pytest
import torch

from unast_tpu_torch import nn as tnn
from unast_tpu_torch.bridge import _to_torch
from unast_tpu_torch.models import TINY, conformer as TC, ctc as TCT
from unast_tpu_torch.models import networks as TN, transformer as TT

import torch_family_golden as FG

ECTX = tnn.Ctx.eval()
TOL = dict(rtol=1e-5, atol=1e-5)
MIN_MARGIN = 1e-3   # least top-1 / top-2 logit gap of a greedy CTC frame


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    return FG.load("conformer", "ctc")


def _case():
    x, pad, _, _, _ = FG.seq_case()
    return torch.from_numpy(x), torch.from_numpy(pad)


def test_conformer_layer_matches_jax(golden):
    """One layer (the asymmetric 'same' pad of an even kernel, pad frames
    zeroed before the depthwise window) in eval mode, 1e-5."""
    p, s = (_to_torch(t) for t in FG.conformer_trees())
    x, pad = _case()
    y, ns = TC.conformer_layer(p["layers"][0], s["layers"][0], ECTX, x, pad,
                               TT.padding_bias(pad), FG.H, 0.1, FG.CONF_KERNEL)
    np.testing.assert_allclose(y.numpy(), golden["conformer/layer"], **TOL)
    assert ns["bn"] is s["layers"][0]["bn"]   # eval mode keeps the state


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_conformer_encoder_matches_jax(golden, impl):
    """The encoder in eval mode, through attention_core and through the
    flash path's plain version, 1e-5."""
    p, s = (_to_torch(t) for t in FG.conformer_trees())
    x, pad = _case()
    y, _ = TC.conformer_encoder(p, s, ECTX, x, pad, FG.H, 0.1, FG.CONF_KERNEL,
                                impl=impl)
    np.testing.assert_allclose(y.numpy(), golden[f"conformer/eval/{impl}"], **TOL)


def check_conformer_train_mode(golden, form):
    """Train mode with dropout 0 (batch BN statistics) under `form` (a key
    of FG.STACK_FORMS): the output and the new running statistics against
    JAX's, 1e-5; off the unrolled form, the gradient equal to the unrolled
    run's. Under remat the backward recomputes each layer, and the state
    returned is the forward's, moved once."""
    p, s = (_to_torch(t) for t in FG.conformer_trees())
    leaves = [t.requires_grad_(True) for t in FG.tree_leaves(p)]
    x, pad = _case()
    scan, remat, policy = FG.STACK_FORMS[form]
    ctx = tnn.Ctx(generator=torch.Generator().manual_seed(0), train=True)
    y, ns = TC.conformer_encoder(p, s, ctx, x, pad, FG.H, 0.0, FG.CONF_KERNEL,
                                 scan_layers=scan, remat=remat,
                                 remat_policy=policy)
    grads = torch.autograd.grad((y ** 2).sum(), leaves)
    np.testing.assert_allclose(y.detach().numpy(), golden["conformer/train"],
                               **TOL)
    ref = FG.sub(golden, "conformer/train_state/")
    mine = FG.flat(FG.to_np(ns))
    assert mine.keys() == ref.keys()
    for k, r in ref.items():
        np.testing.assert_allclose(mine[k], r, err_msg=k, **TOL)
    if form != "unrolled":
        y0, _ = TC.conformer_encoder(p, s, tnn.Ctx(train=True), x, pad, FG.H,
                                     0.0, FG.CONF_KERNEL)
        for a, b in zip(grads, torch.autograd.grad((y0 ** 2).sum(), leaves)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("form", ["unrolled", "scan"])
def test_conformer_train_mode_and_bn_state_match_jax(golden, form):
    """check_conformer_train_mode unrolled and scanned (the remat form is in
    tests/test_torch_remat.py, with the other checkpointed stacks)."""
    check_conformer_train_mode(golden, form)


def test_speech_encoder_dispatch_and_ctc_over_conformer_match_jax(golden):
    """speech_encoder='conformer' through networks.speech_tr_encode (the CTC
    model calls it): the CTC logits 1e-5 and the one-pass greedy ids and
    lengths equal to JAX's, every frame's greedy margin asserted; an
    extra_bias (the streaming chunk mask) raises, as JAX asserts."""
    cfg = TINY.replace(**FG.CONF_KW)
    p, s = (_to_torch(t) for t in FG.ctc_trees())
    text, tl, mel, ml = (torch.from_numpy(a) for a in FG.tts_case())
    logits, pad, new_s = TCT.ctc_logits(p, s, ECTX, cfg, mel, ml)
    np.testing.assert_allclose(logits.numpy(), golden["ctc/logits"], **TOL)
    assert set(new_s) == {"encoder"}
    top2 = torch.topk(logits, 2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1])[~pad]
    assert gap.min() > MIN_MARGIN, gap.min()
    (ids, lens), _ = TCT.ctc_asr_infer(p, s, ECTX, cfg, mel, ml)
    assert np.array_equal(ids.numpy(), golden["ctc/ids"])
    assert np.array_equal(lens.numpy(), golden["ctc/lens"])
    with pytest.raises(ValueError, match="transformer"):
        TN.speech_tr_encode(p, s, ECTX, cfg, mel, ml,
                            extra_bias=TT.chunk_bias(12, 4, 1))
