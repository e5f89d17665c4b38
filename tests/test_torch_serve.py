"""The port's serving slice (unast_tpu_torch) against the JAX package on the
CPU at TINY width: nn ops, the encoders under both attention impls, one
cached decode step, the greedy decodes, the Synthesizer end to end, the
wav->mel DSP and the text frontend.

The same weights go to both sides: JAX's init from PRNGKey(0), leaves as
numpy (kept in the golden below), then bridge.params_from_jax. Inputs are made with numpy from a seed. Everything runs
in float32 in eval mode (no dropout), with JAX's Pallas kernel in
interpret mode as its own tests run it. What JAX compiles slowly (the
Synthesizer, the encoders, the greedy decodes, and the init, which JAX
runs op by op) comes from the hash-guarded golden
tests/goldens/torch_serve.npz (tests/torch_serve_golden.py). Tolerances: 1e-5 where both sides
do the same float32 ops, 1e-4 for mels after the greedy loops, 2e-3 of the
peak for Griffin-Lim waveforms (see test_synthesizer_matches_jax), 5e-4
for wav->mel (the dft_high path's stated tolerance), and exact ids and
stop_lens where every greedy choice has a margin the test asserts.
"""

import functools

import numpy as np
import pytest
import jax
import torch

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

import torch_ops_golden as OG
import torch_serve_golden as SG
import torch_train_golden as G

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
    """(numpy params, numpy state, port params, port state) at TINY: JAX's
    init from PRNGKey(0), as tests/goldens/torch_serve.npz keeps it, which
    the bridge turns into the port's."""
    params, state = SG.models_np(_golden(), stop_bias)
    tp, ts = params_from_jax(params, state)
    return params, state, tp, ts


@functools.lru_cache(maxsize=1)
def _golden():
    z = np.load(SG.GOLDEN)
    assert str(z["source_hash"]) == SG.source_hash(), (
        "tests/goldens/torch_serve.npz is stale: the JAX package, "
        "tests/torch_serve_golden.py or a library version changed; run "
        "`JAX_PLATFORMS=cpu python tests/torch_serve_golden.py`")
    return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def serve_golden():
    return _golden()


_inputs = SG.inputs


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


@pytest.fixture(scope="module")
def ops_golden():
    return OG.load()


def test_nn_ops_match_jax(ops_golden):
    """linear, both conv paddings, embedding, layernorm and BatchNorm in
    eval and train mode (with its new state) against JAX's
    (tests/torch_ops_golden.py::nn_ops), 1e-5."""
    x, lin, conv, bn_p, bn_s, ids, emb = OG.nn_ops_case()
    tt = lambda d: {k: _t(v) for k, v in d.items()}
    got = OG.nn_ops(tnn, _t(x), tt(lin), tt(conv), tt(bn_p), tt(bn_s),
                    _t(ids).long(), tt(emb))
    for i, b in enumerate(got):
        np.testing.assert_allclose(_np(b), ops_golden[f"nn_ops/{i}"],
                                   atol=1e-5, rtol=1e-5, err_msg=str(i))


@pytest.mark.parametrize("cross", [False, True])
def test_mha_matches_jax(ops_golden, cross):
    """Self-attention under a causal + padding bias, and cross-attention
    (q alone, fused k/v) under a padding bias, against JAX's
    (tests/torch_ops_golden.py::mha_case): the biases equal, the output
    1e-5."""
    tp, _ = params_from_jax(OG.mha_params(), {})
    x, kv, pad = OG.mha_case(cross)
    tb = TT.padding_bias(_t(pad))
    if not cross:
        tb = tb + TT.causal_bias(6)
    np.testing.assert_array_equal(tb.numpy(), ops_golden[f"mha/{int(cross)}/bias"])
    tx = _t(x)
    yt = TT.mha(tp, ECTX_T, tx, _t(kv) if cross else tx, tb, OG.NHEAD, 0.0)
    np.testing.assert_allclose(_np(yt), ops_golden[f"mha/{int(cross)}/out"],
                               atol=1e-5, rtol=1e-5)


def test_bridge_unstacks_layer_stacks(ops_golden):
    """A layer list stacked over a leading [L] axis (JAX's transformer.py::
    _stack_layers, as scan_layers builds it; tests/goldens/torch_ops.npz
    keeps its stack of OG.encoder_params()) comes out as the same list."""
    layers = OG.encoder_params()["layers"]
    stacked = SG.unflatten({k[len("stack/"):]: v for k, v in ops_golden.items()
                            if k.startswith("stack/")})
    assert set(stacked) == set(layers[0])
    got, _ = params_from_jax({"text_m": {"encoder": {"layers": stacked}}}, {})
    want, _ = params_from_jax({"text_m": {"encoder": {"layers": layers}}}, {})
    got, want = got["text_m"]["encoder"]["layers"], want["text_m"]["encoder"]["layers"]
    assert len(got) == len(want) == len(layers)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("impl", SG.IMPLS)
def test_encoders_match_jax(serve_golden, impl):
    _, _, tp, ts = _models()
    tcfg = TTINY.replace(attn_impl=impl)
    ids, tlens, mel, mlens = _inputs()
    (tm, tmask), _ = TN.text_tr_encode(tp["text_m"], ts["text_m"], ECTX_T,
                                       tcfg, _t(ids).long(), _t(tlens).long())
    g = f"encoders/{impl}/"
    np.testing.assert_allclose(_np(tm), serve_golden[g + "text"], atol=1e-5, rtol=1e-5)
    assert np.array_equal(tmask.numpy(), serve_golden[g + "text_mask"])
    (tsm, _), _ = TN.speech_tr_encode(tp["speech_m"], ts["speech_m"], ECTX_T,
                                      tcfg, _t(mel), _t(mlens).long())
    np.testing.assert_allclose(_np(tsm), serve_golden[g + "speech"], atol=1e-5,
                               rtol=1e-5)


def test_decoder_step_matches_jax(ops_golden):
    """One KV-cached decoder_step from a filled cache against JAX's jitted
    step (tests/goldens/torch_ops.npz, OG.decoder_step_case): output and
    the self and cross caches within 1e-5."""
    tdec, _ = params_from_jax(OG.decoder_params(), {})
    memory, pad, x, prior = OG.decoder_step_case()
    h = OG.NHEAD
    tc = TT.init_cache(tdec, _t(memory), OG.DEC_MAX_LEN, h)
    tc.self_k.copy_(_t(prior))
    tc.self_v.copy_(_t(-prior))
    yt, tc = TT.decoder_step(tdec, ECTX_T, _t(x), OG.DEC_POS, tc,
                             TT.padding_bias(_t(pad)), h, 0.0)
    np.testing.assert_allclose(_np(yt), ops_golden["dec_step/y"], atol=1e-5, rtol=1e-5)
    for name in ("self_k", "self_v", "cross_k"):
        np.testing.assert_allclose(_np(getattr(tc, name)), ops_golden[f"dec_step/{name}"],
                                   atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("stop_bias", SG.GREEDY_STOP_BIASES)
def test_greedy_decodes_match_jax(serve_golden, stop_bias):
    """stop_bias -100: every row decodes the full max_mel_len frames;
    +100: every row stops on the first frame (the early exit)."""
    _, _, tp, ts = _models(stop_bias)
    ids, tlens, mel, mlens = _inputs(seed=3)
    tcfg = TTINY.replace(attn_impl="flash")
    ref = {k.split("/")[-1]: v for k, v in serve_golden.items()
           if k.startswith(f"greedy/{stop_bias}/")}
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
    assert np.array_equal(tsl.numpy(), ref["stop_lens"])
    assert np.array_equal(tids.numpy(), ref["ids"])
    assert np.array_equal(ttl.numpy(), ref["text_lens"])
    for name, b in (("pre", tpre), ("post", tpost), ("stops", tstops)):
        np.testing.assert_allclose(_np(b), ref[name], atol=1e-4, rtol=1e-4)


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


def test_wav_to_mel_matches_jax(ops_golden):
    """wav_to_mel_mag of OG.wav_case() against JAX's (tests/goldens/
    torch_ops.npz), 5e-4."""
    jmel, jmag = ops_golden["wav_to_mel/mel"], ops_golden["wav_to_mel/mag"]
    jn = int(ops_golden["wav_to_mel/n"])
    tmel, tmag, tn = tdsp.wav_to_mel_mag(OG.wav_case(), device="cpu")
    assert jn == tn and tmel.shape == jmel.shape
    np.testing.assert_allclose(_np(tmel), np.asarray(jmel), atol=5e-4)
    np.testing.assert_allclose(_np(tmag), np.asarray(jmag), atol=5e-4)


def test_text_ids_match():
    for s in ["Dr. Smith paid $5 in 1920.", "Hello, world!",
              "The quick brown fox jumps over 13 lazy dogs."]:
        ids = t_text_ids(s)
        assert ids == j_text_ids(s)
        assert t_seq_to_text(ids) == j_seq_to_text(ids)
