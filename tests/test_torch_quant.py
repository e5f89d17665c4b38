"""The port's int8 weight-only quantization (nn/quant.py, nn.core.weight
and embedding, Synthesizer(quantize='int8')) against the JAX package on
the CPU.

The same weights go to both sides: the port's unast_init at TINY (torch
seed 0) as numpy trees (tests/torch_family_golden.py). The JAX side comes
from the hash-guarded golden tests/goldens/torch_family.npz. Tolerances:
int8 trees bit-equal and scales exactly equal; the quantized TTS forward
1e-5 (float32); the served mels 1e-4 and ids equal with every greedy
choice's margin asserted, as tests/test_torch_serve.py holds them.
"""

import numpy as np
import pytest
import torch

from unast_tpu_torch import nn as tnn
from unast_tpu_torch.audio.params import AudioParams
from unast_tpu_torch.bridge import params_from_jax
from unast_tpu_torch.infer.serve import Synthesizer
from unast_tpu_torch.models import TINY, modules as TMod, networks as TN
from unast_tpu_torch.models import transformer as TT, unast as TU
from unast_tpu_torch.nn import quant as Q
from unast_tpu_torch.train import losses as TL

import torch_family_golden as FG

ECTX = tnn.Ctx.eval()
MIN_MARGIN = 1e-3   # least top-1 / top-2 logit gap a greedy choice may have


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
    return FG.load("model", "moe", "mlp")


@pytest.fixture(scope="module")
def model():
    return params_from_jax(*FG.model_trees())


def test_quantize_params_bit_equal_to_jax(golden, model):
    """quantize_params of the model tree and of an MoE FFN (one scale per
    output channel across all experts): the same keys, int8 bit-equal,
    scales exactly equal; dequantize_params inverts it within half a step
    of each channel; quantized_bytes counts the int8 and scale bytes."""
    for name, tree in (("model", model[0]),
                       ("moe", params_from_jax(FG.moe_tree(), {})[0])):
        mine = FG.flat(FG.to_np(Q.quantize_params(tree)))
        ref = FG.sub(golden, f"quant/{name}/")
        assert mine.keys() == ref.keys()
        for k, r in ref.items():
            assert mine[k].dtype == r.dtype and np.array_equal(mine[k], r), k
    moe = params_from_jax(FG.moe_tree(), {})[0]
    q = Q.quantize_params(moe)
    assert q["lin1"]["w_scale"].shape == (FG.F,)
    back = Q.dequantize_params(q)
    err = (back["lin1"]["w"] - moe["lin1"]["w"]).abs()
    assert (err <= q["lin1"]["w_scale"] / 2 + 1e-7).all()
    n = FG.N_EXPERTS * FG.D * FG.F
    assert (Q.quantized_bytes(q["lin1"])
            == n + 4 * FG.F + 4 * FG.N_EXPERTS * FG.F)


def test_weight_dequantizes_in_compute_dtype():
    """nn.weight rounds the scale to the compute dtype before the product,
    as JAX's q.astype(dtype) * scale.astype(dtype); in bfloat16 that is not
    dequantizing in float32 and rounding after. An int8 embedding takes
    its rows first, then scales them in float32."""
    g = torch.Generator().manual_seed(5)
    p = Q.quantize_params({"w": torch.randn(64, 48, generator=g)})
    w = tnn.weight(p, torch.bfloat16)
    want = p["w_q"].to(torch.bfloat16) * p["w_scale"].to(torch.bfloat16)
    assert w.dtype == torch.bfloat16 and torch.equal(w, want)
    assert not torch.equal(w, (p["w_q"].float() * p["w_scale"]).to(torch.bfloat16))
    ids = torch.tensor([[3, 0, 63]])
    e = tnn.embedding(p, ids)
    assert e.dtype == torch.float32
    assert torch.equal(e, p["w_q"][ids].float() * p["w_scale"])


def test_quantized_tts_forward_matches_jax(golden, model):
    """U.tts teacher-forced on the quantized tree in float32: pre, post and
    stop within 1e-5 of JAX's."""
    text, tl, mel, ml = (torch.from_numpy(a) for a in FG.tts_case())
    (pre, post, stop, _), _ = TU.tts(Q.quantize_params(model[0]), model[1],
                                     ECTX, TINY, text.long(), tl, mel, ml)
    for name, a in (("pre", pre), ("post", post), ("stop", stop)):
        np.testing.assert_allclose(a.numpy(), golden[f"qtts/{name}"],
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def _greedy_margins(tp, cfg, memory, pad_mask, ids):
    """Top-1 minus top-2 logit at every step of a greedy text decode that
    followed `ids` (the arithmetic of networks.text_tr_infer)."""
    b, n = ids.shape
    cache = TT.init_cache(tp["decoder"], memory, cfg.max_text_len, cfg.nhead)
    bias = TT.padding_bias(pad_mask)
    tok = torch.full((b, 1), 1, dtype=torch.long)
    gaps = []
    for i in range(n):
        x = TMod.positional_encoding(
            ECTX, TMod.text_embed(tp["prenet"], ECTX, tok, cfg), offset=i)
        h, cache = TT.decoder_step(tp["decoder"], ECTX, x, i, cache, bias,
                                   cfg.nhead, 0.0)
        top2 = torch.topk(TMod.text_postnet(tp["postnet"], ECTX, h, cfg)[:, -1],
                          2).values
        gaps.append((top2[:, 0] - top2[:, 1]).numpy())
        tok = ids[:, i:i + 1]
    return np.stack(gaps, axis=1)


def test_synthesizer_int8_matches_jax(golden):
    """Synthesizer(quantize='int8') against the JAX one's golden on the
    same weights (the stop bias lowered so every request decodes the full
    max_mel_len): tts_mels 1e-4; asr_ids equal, every greedy choice's
    margin asserted on the quantized tree. Any other quantize raises."""
    params, state = params_from_jax(*FG.serve_trees())
    syn = Synthesizer(params, state, TINY, audio_params=AudioParams(n_iter=2),
                      quantize="int8", device="cpu", **FG.SYN_KW)
    assert syn.params["text_m"]["prenet"]["embed"]["w_q"].dtype == torch.int8
    for i, m in enumerate(syn.tts_mels(FG.TEXTS)):
        a = golden[f"qsyn/tts_mels/{i}"]
        assert a.shape == m.shape
        np.testing.assert_allclose(m, a, atol=1e-4, rtol=1e-4)
    mels = FG.asr_mels()
    got = syn.asr_ids(mels)
    padded = np.zeros((2, 24, 80), np.float32)
    for i, m in enumerate(mels):
        padded[i, :len(m)] = m
    qp = syn.params
    with torch.inference_mode():
        (enc, mask), _ = TN.speech_tr_encode(
            qp["speech_m"], syn.net_state["speech_m"], ECTX, TINY,
            torch.from_numpy(padded), torch.tensor([len(m) for m in mels]))
        ids, _ = TN.text_tr_infer(qp["text_m"], ECTX, TINY, enc, mask)
        gaps = _greedy_margins(qp["text_m"], TINY, enc, mask, ids)
    for i, (b, g) in enumerate(zip(got, gaps)):
        assert g[:len(b)].min() > MIN_MARGIN, g.min()
        assert np.array_equal(golden[f"qsyn/asr_ids/{i}"], np.asarray(b))
    with pytest.raises(ValueError, match="int8"):
        Synthesizer(params, state, TINY, quantize="int4", device="cpu")


def test_leftovers_match_jax(golden, model):
    """soft_cross_entropy (mean and sum), mlp_discriminator and num_params
    against JAX's, float32 1e-6."""
    logits, targets = (torch.from_numpy(a) for a in FG.ce_case())
    for avg in (True, False):
        np.testing.assert_allclose(
            float(TL.soft_cross_entropy(logits, targets, avg)),
            float(golden[f"soft_ce/{int(avg)}"]), rtol=1e-6)
    x = torch.from_numpy(FG.seq_case()[0])
    out = TU.mlp_discriminator(params_from_jax(FG.mlp_tree(), {})[0], ECTX, x)
    np.testing.assert_allclose(out.numpy(), golden["mlp_disc"], rtol=1e-6,
                               atol=1e-6)
    assert TU.num_params(model[0]) == int(golden["num_params"])
