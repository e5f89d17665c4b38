"""The port's serving slice (unast_tpu_torch) against the JAX package on the
CPU at TINY width: nn ops, the encoders under both attention impls, one
cached decode step, the greedy decodes, the Synthesizer end to end, the
wav->mel DSP and the text frontend.

The same weights go to both sides: JAX init, leaves as numpy, then
bridge.params_from_jax. Inputs are made with numpy from a seed. Everything
runs in float32 in eval mode (no dropout), with JAX's Pallas kernel in
interpret mode as its own tests run it. Tolerances: 1e-5 where both sides
do the same float32 ops, 1e-4 for mels after the greedy loops, 2e-3 of the
peak for Griffin-Lim waveforms (see test_synthesizer_matches_jax), 5e-4
for wav->mel (the dft_high path's stated tolerance), and exact ids and
stop_lens where every greedy choice has a margin the test asserts.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from unast_tpu import nn as jnn
from unast_tpu.audio import dsp as jdsp
from unast_tpu.models import TINY as JTINY, networks as JN, transformer as JT
from unast_tpu.models import unast as JU
from unast_tpu.text import raw_text_to_phoneme_ids as j_text_ids
from unast_tpu.text import sequence_to_text as j_seq_to_text

from unast_tpu_torch import nn as tnn
from unast_tpu_torch.audio import dsp as tdsp
from unast_tpu_torch.audio.params import AudioParams as TAudioParams
from unast_tpu_torch.bridge import params_from_jax
from unast_tpu_torch.infer.serve import Synthesizer as TSynthesizer
from unast_tpu_torch.models import TINY as TTINY, modules as TM
from unast_tpu_torch.models import networks as TN, transformer as TT
from unast_tpu_torch.text import raw_text_to_phoneme_ids as t_text_ids
from unast_tpu_torch.text import sequence_to_text as t_seq_to_text

import torch_serve_golden as SG
import torch_train_golden as G

ECTX_J = jnn.Ctx.eval()
ECTX_T = tnn.Ctx.eval()
MIN_MARGIN = 1e-3   # least top-1 / top-2 logit gap a greedy choice may have


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    test workers share the host's cores (with a thread pool each, torch's
    small ops run many times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


@functools.lru_cache(maxsize=2)
def _models(stop_bias: float = 0.0):
    """(JAX params, JAX state, port params, port state) at TINY, seed 0."""
    params, state = JU.unast_init(jax.random.PRNGKey(0), JTINY)
    params["speech_m"]["postnet"]["stop_proj"]["b"] = (
        params["speech_m"]["postnet"]["stop_proj"]["b"] + stop_bias)
    np_p = jax.tree_util.tree_map(np.asarray, params)
    np_s = jax.tree_util.tree_map(np.asarray, state)
    tp, ts = params_from_jax(np_p, np_s)
    return params, state, tp, ts


@pytest.fixture(scope="module")
def serve_golden():
    z = np.load(SG.GOLDEN)
    assert str(z["source_hash"]) == SG.source_hash(), (
        "tests/goldens/torch_serve.npz is stale: the JAX package, "
        "tests/torch_serve_golden.py or a library version changed; run "
        "`JAX_PLATFORMS=cpu python tests/torch_serve_golden.py`")
    return {k: z[k] for k in z.files}


def _inputs(seed=0, b=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 46, size=(b, JTINY.max_text_len)).astype(np.int32)
    tlens = np.array([JTINY.max_text_len, 9][:b], np.int32)
    mel = rng.uniform(0, 1, size=(b, JTINY.max_mel_len, 80)).astype(np.float32)
    mlens = np.array([JTINY.max_mel_len, 13][:b], np.int32)
    return ids, tlens, mel, mlens


def _greedy_margins(tp, cfg, memory, pad_mask, ids):
    """Top-1 minus top-2 logit at every step of a greedy text decode that
    followed `ids`, from the port's decode step (the same arithmetic as
    text_tr_infer)."""
    b, n = ids.shape
    cache = TT.init_cache(tp["decoder"], memory, cfg.max_text_len, cfg.nhead)
    bias = TT.padding_bias(pad_mask)
    tok = torch.full((b, 1), 1, dtype=torch.long)
    gaps = []
    for i in range(n):
        x = TM.positional_encoding(ECTX_T, TM.text_embed(tp["prenet"], ECTX_T,
                                                         tok, cfg), offset=i)
        h, cache = TT.decoder_step(tp["decoder"], ECTX_T, x, i, cache, bias,
                                   cfg.nhead, 0.0)
        top2 = torch.topk(TM.text_postnet(tp["postnet"], ECTX_T, h, cfg)[:, -1],
                          2).values
        gaps.append((top2[:, 0] - top2[:, 1]).numpy())
        tok = torch.as_tensor(ids[:, i:i + 1], dtype=torch.long)
    return np.stack(gaps, axis=1)


def test_nn_ops_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 6)).astype(np.float32)
    lin = {"w": rng.normal(size=(6, 5)).astype(np.float32),
           "b": rng.normal(size=(5,)).astype(np.float32)}
    conv = {"w": rng.normal(size=(5, 6, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32)}
    bn_p = {"scale": rng.uniform(0.5, 2, 6).astype(np.float32),
            "bias": rng.normal(size=6).astype(np.float32)}
    bn_s = {"mean": rng.normal(size=6).astype(np.float32),
            "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    ids = np.array([[0, 3, 5], [7, 0, 1]], np.int32)
    emb = {"w": rng.normal(size=(9, 6)).astype(np.float32)}
    jt = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    tt = lambda d: {k: _t(v) for k, v in d.items()}
    pairs = [
        (jnn.linear(jt(lin), x), tnn.linear(tt(lin), _t(x))),
        (jnn.conv1d(jt(conv), x, (4, 0)), tnn.conv1d(tt(conv), _t(x), (4, 0))),
        (jnn.conv1d(jt(conv), x, 2), tnn.conv1d(tt(conv), _t(x), 2)),
        (jnn.embedding(jt(emb), ids), tnn.embedding(tt(emb), _t(ids).long())),
        (jnn.layernorm(jt(bn_p), x), tnn.layernorm(tt(bn_p), _t(x))),
    ]
    for train in (False, True):
        yj, sj = jnn.batchnorm(jt(bn_p), jt(bn_s), x, train)
        yt, st = tnn.batchnorm(tt(bn_p), tt(bn_s), _t(x), train)
        pairs += [(yj, yt), (sj["mean"], st["mean"]), (sj["var"], st["var"])]
    for a, b in pairs:
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cross", [False, True])
def test_mha_matches_jax(cross):
    """Self-attention under a causal + padding bias, and cross-attention
    (q alone, fused k/v) under a padding bias."""
    params, _, tp, _ = _models()
    jp = params["speech_m"]["decoder"]["layers"][0]["cross" if cross else "self"]
    tpp = tp["speech_m"]["decoder"]["layers"][0]["cross" if cross else "self"]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 6, JTINY.e_in)).astype(np.float32)
    kv = rng.normal(size=(2, 9, JTINY.e_in)).astype(np.float32) if cross else x
    pad = np.zeros((2, kv.shape[1]), bool)
    pad[1, -3:] = True
    jb, tb = JT.padding_bias(pad), TT.padding_bias(_t(pad))
    if not cross:
        jb, tb = jb + JT.causal_bias(6), tb + TT.causal_bias(6)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    tx = _t(x)
    yj = JT.mha(jp, ECTX_J, x, kv, jb, JTINY.nhead, 0.0)
    yt = TT.mha(tpp, ECTX_T, tx, _t(kv) if cross else tx, tb, JTINY.nhead, 0.0)
    np.testing.assert_allclose(_np(yt), np.asarray(yj), atol=1e-5, rtol=1e-5)


def test_bridge_unstacks_layer_stacks():
    """A layer list stacked over a leading [L] axis (transformer.py::
    _stack_layers, as scan_layers builds it) comes out as the same list."""
    params, state, tp, _ = _models()
    stacked = jax.tree_util.tree_map(np.asarray, params)
    enc = stacked["text_m"]["encoder"]
    enc["layers"] = jax.tree_util.tree_map(np.asarray,
                                           JT._stack_layers(enc["layers"]))
    got, _ = params_from_jax(stacked, jax.tree_util.tree_map(np.asarray, state))
    want = tp["text_m"]["encoder"]["layers"]
    assert len(got["text_m"]["encoder"]["layers"]) == len(want)
    for a, b in zip(jax.tree_util.tree_leaves(got["text_m"]["encoder"]["layers"]),
                    jax.tree_util.tree_leaves(want)):
        assert torch.equal(a, b)


@functools.partial(jax.jit, static_argnums=0)
def _jax_encoders(cfg, params, state, ids, tlens, mel, mlens):
    (tm, tmask), _ = JN.text_tr_encode(params["text_m"], state["text_m"],
                                       ECTX_J, cfg, ids, tlens)
    (sm, _), _ = JN.speech_tr_encode(params["speech_m"], state["speech_m"],
                                     ECTX_J, cfg, mel, mlens)
    return tm, tmask, sm


@functools.partial(jax.jit, static_argnums=0)
def _jax_decodes(cfg, params, state, ids, tlens, mel, mlens):
    (t_enc, t_mask), _ = JN.text_tr_encode(params["text_m"], state["text_m"],
                                           ECTX_J, cfg, ids, tlens)
    speech, _ = JN.speech_tr_infer(params["speech_m"], state["speech_m"],
                                   ECTX_J, cfg, t_enc, t_mask)
    (s_enc, s_mask), _ = JN.speech_tr_encode(
        params["speech_m"], state["speech_m"], ECTX_J, cfg, mel, mlens)
    return speech, JN.text_tr_infer(params["text_m"], ECTX_J, cfg, s_enc,
                                    s_mask)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_encoders_match_jax(impl):
    params, state, tp, ts = _models()
    jcfg, tcfg = JTINY.replace(attn_impl=impl), TTINY.replace(attn_impl=impl)
    ids, tlens, mel, mlens = _inputs()
    jm, jmask, jsm = _jax_encoders(jcfg, params, state, ids, tlens, mel, mlens)
    (tm, tmask), _ = TN.text_tr_encode(tp["text_m"], ts["text_m"], ECTX_T,
                                       tcfg, _t(ids).long(), _t(tlens).long())
    np.testing.assert_allclose(_np(tm), np.asarray(jm), atol=1e-5, rtol=1e-5)
    assert np.array_equal(tmask.numpy(), np.asarray(jmask))
    (tsm, _), _ = TN.speech_tr_encode(tp["speech_m"], ts["speech_m"], ECTX_T,
                                      tcfg, _t(mel), _t(mlens).long())
    np.testing.assert_allclose(_np(tsm), np.asarray(jsm), atol=1e-5, rtol=1e-5)


def test_decoder_step_matches_jax():
    params, _, tp, _ = _models()
    rng = np.random.default_rng(2)
    d, h, max_len, pos = JTINY.e_in, JTINY.nhead, 10, 4
    memory = rng.normal(size=(2, 7, d)).astype(np.float32)
    pad = np.array([[False] * 7, [False] * 4 + [True] * 3])
    x = rng.normal(size=(2, 1, d)).astype(np.float32)
    jp, tdec = params["speech_m"]["decoder"], tp["speech_m"]["decoder"]
    prior = rng.normal(size=(JTINY.num_layers, 2, max_len, h, d // h))
    prior = prior.astype(np.float32)

    @jax.jit
    def jax_step(jp, memory, prior, x):
        jc = JT.init_cache(jp, memory, max_len, h)
        jc = jc._replace(self_k=prior, self_v=-prior)
        return JT.decoder_step(jp, ECTX_J, x, jnp.int32(pos), jc,
                               JT.padding_bias(pad), h, 0.0)

    yj, jc = jax_step(jp, memory, prior, x)
    tc = TT.init_cache(tdec, _t(memory), max_len, h)
    tc.self_k.copy_(_t(prior))
    tc.self_v.copy_(_t(-prior))
    yt, tc = TT.decoder_step(tdec, ECTX_T, _t(x), pos, tc,
                             TT.padding_bias(_t(pad)), h, 0.0)
    np.testing.assert_allclose(_np(yt), np.asarray(yj), atol=1e-5, rtol=1e-5)
    for a, b in ((jc.self_k, tc.self_k), (jc.self_v, tc.self_v),
                 (jc.cross_k, tc.cross_k)):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("stop_bias", [-100.0, 100.0])
def test_greedy_decodes_match_jax(stop_bias):
    """stop_bias -100: every row decodes the full max_mel_len frames;
    +100: every row stops on the first frame (the early exit)."""
    params, state, tp, ts = _models(stop_bias)
    ids, tlens, mel, mlens = _inputs(seed=3)
    jcfg, tcfg = JTINY.replace(attn_impl="flash"), TTINY.replace(attn_impl="flash")
    (jpre, jpost, jstops, jsl), (jids, jtl) = _jax_decodes(
        jcfg, params, state, ids, tlens, mel, mlens)
    with torch.inference_mode():
        (t_enc, t_mask), _ = TN.text_tr_encode(
            tp["text_m"], ts["text_m"], ECTX_T, tcfg, _t(ids).long(),
            _t(tlens).long())
        (tpre, tpost, tstops, tsl), _ = TN.speech_tr_infer(
            tp["speech_m"], ts["speech_m"], ECTX_T, tcfg, t_enc, t_mask)
        (s_enc, s_mask), _ = TN.speech_tr_encode(
            tp["speech_m"], ts["speech_m"], ECTX_T, tcfg, _t(mel),
            _t(mlens).long())
        tids, ttl = TN.text_tr_infer(tp["text_m"], ECTX_T, tcfg, s_enc, s_mask)
        gaps = _greedy_margins(tp["text_m"], tcfg, s_enc, s_mask,
                               tids.numpy())
    assert gaps[:, :int(ttl.max())].min() > MIN_MARGIN, gaps.min()
    assert np.array_equal(tsl.numpy(), np.asarray(jsl))
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    assert np.array_equal(ttl.numpy(), np.asarray(jtl))
    for a, b in ((jpre, tpre), (jpost, tpost), (jstops, tstops)):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=1e-4,
                                   rtol=1e-4)


def test_synthesizer_matches_jax(serve_golden):
    """The port's Synthesizer against the JAX one's golden
    (tests/torch_serve_golden.py) on the same weights and requests."""
    params, state, tp, ts = _models(SG.STOP_BIAS)
    assert str(serve_golden["init_hash"]) == G.init_hash(params), (
        "tests/goldens/torch_serve.npz is stale: the JAX init changed; run "
        "`JAX_PLATFORMS=cpu python tests/torch_serve_golden.py`")
    tsyn = TSynthesizer(tp, ts, TTINY, audio_params=TAudioParams(n_iter=2),
                        device="cpu", **SG.KW)
    texts = SG.TEXTS
    for i, b in enumerate(tsyn.tts_mels(texts)):
        a = serve_golden[f"tts_mels/{i}"]
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4)
    # Griffin-Lim normalizes the phase est/|est| also at bins whose
    # magnitude sits at the 1e-8 clip, where float32 rounding turns the
    # phase freely: after 2 iterations JAX's own float32 waveform lies
    # 1.6e-3 of its peak from a float64 run (the port's 2.2e-3). So the
    # waveforms (same trim bounds, hence same lengths) are held at 2e-3 of
    # their peak; after de-emphasis they differ by under 2e-4 of it here.
    tw = tsyn.tts(texts)
    tw.append(tsyn.tts_long(SG.LONG_TEXT))   # 3 segments at TINY
    for i, b in enumerate(tw):
        a = serve_golden[f"tts/{i}"]
        assert a.shape == b.shape and len(a) > 0
        np.testing.assert_allclose(b, a, atol=2e-3 * np.abs(a).max(), rtol=0)
    mels = SG.asr_mels()
    tids = tsyn.asr_ids(mels)
    padded = np.zeros((2, 24, 80), np.float32)
    for i, m in enumerate(mels):
        padded[i, :len(m)] = m
    with torch.inference_mode():
        (enc, mask), _ = TN.speech_tr_encode(
            tp["speech_m"], ts["speech_m"], ECTX_T, TTINY, _t(padded),
            torch.tensor([len(m) for m in mels]))
        ids, _ = TN.text_tr_infer(tp["text_m"], ECTX_T, TTINY, enc, mask)
        gaps = _greedy_margins(tp["text_m"], TTINY, enc, mask, ids.numpy())
    for i, (b, g) in enumerate(zip(tids, gaps)):
        assert g[:len(b)].min() > MIN_MARGIN, g.min()
        assert np.array_equal(serve_golden[f"asr_ids/{i}"], np.asarray(b))


def test_wav_to_mel_matches_jax():
    rng = np.random.default_rng(5)
    t = np.arange(30000) / 22050.0
    wav = (0.4 * np.sin(2 * np.pi * 220 * t) * (t > 0.2)
           + 0.01 * rng.normal(size=t.shape)).astype(np.float32)
    jmel, jmag, jn = jdsp.wav_to_mel_mag(wav)
    tmel, tmag, tn = tdsp.wav_to_mel_mag(wav, device="cpu")
    assert jn == tn and tmel.shape == jmel.shape
    np.testing.assert_allclose(_np(tmel), np.asarray(jmel), atol=5e-4)
    np.testing.assert_allclose(_np(tmag), np.asarray(jmag), atol=5e-4)


def test_text_ids_match():
    for s in ["Dr. Smith paid $5 in 1920.", "Hello, world!",
              "The quick brown fox jumps over 13 lazy dogs."]:
        ids = t_text_ids(s)
        assert ids == j_text_ids(s)
        assert t_seq_to_text(ids) == j_seq_to_text(ids)
