"""The port's RNN backbone (model_type='rnn': the GRU and LSTM cells,
location-sensitive and additive attention, the LSTM decoders, the RNN text
decoder's incremental prenet, the greedy decodes, the six task methods, the
joint train step, the Synthesizer and the trainer) against the JAX package
on the CPU at TINY width, under each decoder attention ('lsa', 'luong',
none).

The same weights go to both sides: the port's init from torch seed 0, as
numpy trees that JAX takes as they are and the bridge turns into the
port's (tests/torch_rnn_golden.py). Inputs are made with numpy from a seed.
The JAX side comes from the hash-guarded goldens tests/goldens/
torch_rnn.npz (cells, attention, decoder step, prenet step, decoders,
greedy decodes, tasks, the Synthesizer) and torch_rnn_step.npz (the train
step). Tolerances, float32
throughout: 1e-5 for the cells, the attention, the decoder step, the
prenet step, the teacher-forced decoders and the tasks in eval mode (1e-4
after the greedy decodes of the cm tasks and the Synthesizer's mels);
exact ids and stop_lens where every greedy choice has a margin the test
asserts; 2e-3 of the peak for Griffin-Lim waveforms (see
tests/test_torch_serve.py::test_synthesizer_matches_jax); the train step
as tests/test_torch_train.py::test_train_step_matches_jax holds it.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

from unast_tpu_torch import nn as tnn
from unast_tpu_torch.audio.params import AudioParams as TAudioParams
from unast_tpu_torch.bridge import params_from_jax
from unast_tpu_torch.infer.serve import Synthesizer
from unast_tpu_torch.models import TINY, modules as TM, networks as TN
from unast_tpu_torch.models import rnn as TR, unast as TU
from unast_tpu_torch.ops.attention import flash_attention
from unast_tpu_torch.train import optim as TO, steps as TS
from unast_tpu_torch.train.config import train_args

import torch_ops_golden as OG
import torch_rnn_golden as RG
import torch_serve_golden as SG
import torch_train_golden as G

ECTX_T = tnn.Ctx.eval()
MIN_MARGIN = 1e-3   # least top-1 / top-2 logit gap (or |stop logit|) a greedy choice may have
ATTN_IDS = ["lsa", "luong", "none"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _close(a, b, tol, what=""):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol, err_msg=what)


def _cfg(attn, mode=None):
    return TINY.replace(**RG.model_overrides(attn, mode))


@functools.lru_cache(maxsize=4)
def _models(attn):
    """(numpy params, numpy state, port params, port state) of the case."""
    params, state = RG.init_trees(attn)
    return (params, state) + params_from_jax(params, state)


def _golden(path, module):
    z = np.load(path)
    assert str(z["source_hash"]) == module.source_hash(), (
        f"{path.name} is stale: the JAX package, a golden module, the config "
        "or a library version changed; run "
        "`JAX_PLATFORMS=cpu python tests/torch_rnn_golden.py`")
    return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def golden():
    return _golden(RG.GOLDEN, RG)


@pytest.fixture(scope="module")
def step_golden():
    return _golden(RG.STEP_GOLDEN, RG)


def _check_init(golden, key, params):
    assert str(golden[f"{key}/init_hash"]) == G.init_hash(params), (
        "the port's init changed; run `JAX_PLATFORMS=cpu python "
        "tests/torch_rnn_golden.py`")


# ---------------------------------------------------------------------------
# Cells, attention, the decoder step and the prenet step
# ---------------------------------------------------------------------------


def test_gru_cell_matches_jax(golden):
    """Three chained steps of torch's GRU equations (the port's input half
    of the gates taken over the whole sequence at once)."""
    p, x, h = RG.gru_case()
    p, h = {k: _t(v) for k, v in p.items()}, _t(h)
    gates = tnn.gru_gates_in(p, _t(x))
    for i in range(3):
        h = tnn.gru_cell(p, gates[i], h)
        _close(h, golden[f"cells/gru/{i}"], 1e-5, f"step {i}")


@pytest.mark.parametrize("attn", ["lsa", "luong"])
def test_attention_matches_jax(golden, attn):
    """Three chained attention steps over a padded memory: the context
    vectors and, for 'lsa', the state (its weights and their running sum)
    that the location conv reads back."""
    _, _, tp, _ = _models(attn)
    p = tp["text_m"]["decoder"]["attn"]
    _, _, _, _, (_, enc_out), pad = RG.inputs()
    enc_out, pad = _t(enc_out), _t(pad)
    st = TR.lsa_init_state(p, enc_out) if attn == "lsa" else None
    for i, q in enumerate(RG.attn_queries()):
        if attn == "lsa":
            c, st = TR.lsa_attend(p, st, _t(q), enc_out, pad)
            _close(st.attn_weights, golden[f"cells/lsa/{i}/weights"], 1e-5, f"step {i}")
            _close(st.attn_cum, golden[f"cells/lsa/{i}/cum"], 1e-5, f"step {i}")
        else:
            c = TR.additive_attend(p, _t(q), enc_out, pad)
        _close(c, golden[f"cells/{attn}/{i}/ctxt"], 1e-5, f"step {i} ctxt")
    if attn == "lsa":
        assert not st.attn_weights[1, 6:].any()      # no weight on pads


@pytest.mark.parametrize("attn", ["lsa", "luong", None], ids=ATTN_IDS)
def test_decoder_step_matches_jax(golden, attn):
    """Two chained rnn_decoder_step calls (attention on the previous top
    hidden, the LSTM stack, proj), eval mode."""
    _, _, tp, _ = _models(attn)
    p = tp["speech_m"]["decoder"]
    _, _, _, _, ((h, c), enc_out), pad = RG.inputs()
    enc_out, pad = _t(enc_out), _t(pad)
    st = TR.lsa_init_state(p["attn"], enc_out) if attn == "lsa" else None
    hc = (_t(h), _t(c))
    for i, x in enumerate(RG.step_inputs()):
        o, hc, st = TR.rnn_decoder_step(p, ECTX_T, _t(x), hc, enc_out, pad, st, 0.3,
                                        attn)
        for name, a in (("out", o), ("h", hc[0]), ("c", hc[1])):
            _close(a, golden[f"cells/step/{attn}/{i}/{name}"], 1e-5, f"step {i} {name}")
    assert ("proj" in p) == (attn is not None)


def test_text_prenet_step_matches_jax_and_the_causal_convs(golden):
    """text_prenet_step, position by position over 7 positions with BN on
    running statistics that are not the init's, against JAX's and against
    the port's own text_prenet_convs(causal=True) over the sequence."""
    cfg = _cfg("lsa")
    _, ns, tp, _ = _models("lsa")
    p = tp["text_m"]["prenet"]
    s, emb = RG.prenet_case(ns["text_m"]["prenet"]["bn"])
    s = {"bn": {k: {n: _t(v) for n, v in d.items()} for k, d in s["bn"].items()}}
    bufs = TM.text_prenet_step_init(p, 2, cfg, torch.float32)
    ys = []
    for i in range(emb.shape[1]):
        y, bufs = TM.text_prenet_step(p, s, ECTX_T, _t(emb[:, i]), bufs, cfg)
        ys.append(y)
    ys = torch.stack(ys, dim=1)
    _close(ys, golden["cells/prenet_step"], 1e-5, "against JAX")
    whole, _ = TM.text_prenet_convs(p, s, ECTX_T, _t(emb), cfg, causal=True)
    _close(ys, whole, 1e-5, "against the causal convs")


# ---------------------------------------------------------------------------
# Decoders, greedy decodes and tasks (JAX from the golden)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def _port_tasks(attn):
    _, _, tp, ts = _models(attn)
    text, tlens, mel, mlens, ((h, c), enc_out), pad = RG.inputs()
    with torch.no_grad():
        return RG.run_tasks(TU, TN, tp, ts, ECTX_T, _cfg(attn), _t(text),
                            _t(tlens), _t(mel), _t(mlens),
                            ((_t(h), _t(c)), _t(enc_out)), _t(pad))


def _golden_leaves(golden, key):
    n = sum(1 for k in golden if k.startswith(key + "/"))
    return [golden[f"{key}/{i}"] for i in range(n)]


@pytest.mark.parametrize("side", ["text", "speech"])
@pytest.mark.parametrize("attn", ["lsa", "luong", None], ids=ATTN_IDS)
def test_decode_sequence_matches_jax(golden, attn, side):
    """The teacher-forced decoders over the same memory: text logits, or
    speech (pre, post, stop)."""
    _check_init(golden, attn, _models(attn)[0])
    out = RG.leaves(_port_tasks(attn)[f"{side}_decode"])
    ref = _golden_leaves(golden, f"{attn}/{side}_decode")
    assert len(out) == len(ref)
    for i, (a, r) in enumerate(zip(out, ref)):
        _close(a, r, 1e-5, f"output {i}")


def _text_margins(p, s, cfg, enc_outputs, pad, ids):
    """Top-1 minus top-2 logit at every step of a greedy RNN text decode
    that followed `ids`, from the port's steps (text_rnn_infer's
    arithmetic)."""
    (hc, enc_out), b = enc_outputs, ids.shape[0]
    bufs = TM.text_prenet_step_init(p["prenet"], b, cfg, torch.float32)
    emb = TM.text_embed(p["prenet"], ECTX_T, torch.full((b,), 1), cfg)
    attn = TN._init_attn_state(p, cfg, enc_out)
    gaps = []
    for i in range(ids.shape[1]):
        x, bufs = TM.text_prenet_step(p["prenet"], s["prenet"], ECTX_T, emb, bufs, cfg)
        out, hc, attn = TR.rnn_decoder_step(p["decoder"], ECTX_T, x, hc, enc_out,
                                            pad, attn, 0.0, cfg.d_attn)
        top2 = torch.topk(TM.text_postnet(p["postnet"], ECTX_T, out, cfg), 2).values
        gaps.append((top2[:, 0] - top2[:, 1]).numpy())
        emb = TM.text_embed(p["prenet"], ECTX_T, torch.as_tensor(ids[:, i]), cfg)
    return np.stack(gaps, axis=1)


@pytest.mark.parametrize("attn", ["lsa", "luong", None], ids=ATTN_IDS)
def test_greedy_decodes_match_jax(golden, attn):
    """text_rnn_infer and speech_rnn_infer over the same memory: ids and
    stop_lens equal, every greedy choice (each token, each stop test up to
    a row's stop) with a margin; pre, post and stops within 1e-4."""
    _, _, tp, ts = _models(attn)
    cfg = _cfg(attn)
    port = _port_tasks(attn)
    ids, tl = port["text_infer"]
    rids, rtl = _golden_leaves(golden, f"{attn}/text_infer")
    text, tlens, mel, mlens, ((h, c), enc_out), pad = RG.inputs()
    with torch.no_grad():
        gaps = _text_margins(tp["text_m"], ts["text_m"], cfg,
                             ((_t(h), _t(c)), _t(enc_out)), _t(pad), ids.numpy())
    for g, n in zip(gaps, tl.numpy()):
        assert g[:n].min() > MIN_MARGIN, g.min()
    assert np.array_equal(ids.numpy(), rids) and np.array_equal(tl.numpy(), rtl)
    pre, post, stops, sl = port["speech_infer"]
    ref = _golden_leaves(golden, f"{attn}/speech_infer")
    assert np.array_equal(sl.numpy(), ref[3])
    for row, n in zip(stops.numpy(), sl.numpy()):
        assert np.abs(row[:n]).min() > MIN_MARGIN, row[:n]
    for a, r in zip((pre, post, stops), ref[:3]):
        _close(a, r, 1e-4)


@pytest.mark.parametrize("name", RG.TASKS)
@pytest.mark.parametrize("attn", ["lsa", "luong", None], ids=ATTN_IDS)
def test_task_matches_jax_in_eval_mode(golden, attn, name):
    out = RG.leaves(_port_tasks(attn)[name])
    ref = _golden_leaves(golden, f"{attn}/{name}")
    assert len(out) == len(ref)
    tol = 1e-4 if name.startswith("cm") else 1e-5
    for i, (a, r) in enumerate(zip(out, ref)):
        assert tuple(a.shape) == r.shape, (i, a.shape, r.shape)
        _close(a, r, tol, f"output {i}")


def test_bridge_carries_the_rnn_trees():
    """params_from_jax carries a JAX unast_init tree of the RNN backbone
    (encoders, decoder cells, attention, proj, discriminator; its shapes
    from JAX's init, kept in tests/goldens/torch_ops.npz) name for name
    and value for value, with the port's init's names and shapes."""
    ops_golden = OG.load()
    for attn in OG.RNN_ATTNS:
        # JAX's init shapes (tests/goldens/torch_ops.npz)
        pre = f"rnn_shapes/{attn}/"
        shapes = SG.unflatten({k[len(pre):]: np.empty(tuple(v)) for k, v in
                               ops_golden.items() if k.startswith(pre)})
        rng = np.random.default_rng(15)
        jp, js = (TO.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32),
                              shapes[k]) for k in (0, 1))
        ref = G.flatten({"p": jp, "s": js})
        tp, ts = params_from_jax(jp, js)
        mine = G.flatten({"p": tp, "s": ts})
        assert mine.keys() == ref.keys() == G.flatten(
            {"p": _models(attn)[0], "s": _models(attn)[1]}).keys()
        assert {f"p/text_m/decoder/cells/1/wh", "p/text_m/decoder/attn/fc2/w"
                if attn == "luong" else "p/speech_m/decoder/attn/loc_conv/w",
                "p/speech_m/decoder/proj/w", "p/text_m/encoder/reduce_c/w",
                "s/text_m/prenet/bn/bn3/var"} <= mine.keys()
        for k in ref:
            np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
    with pytest.raises(AssertionError, match="reduction_factor"):
        TN.speech_rnn_init(torch.Generator(), _cfg("lsa").replace(reduction_factor=2))


# ---------------------------------------------------------------------------
# The joint train step (JAX from the golden)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", RG.MODES)
@pytest.mark.parametrize("attn", RG.STEP_ATTNS)
def test_rnn_train_step_matches_jax(step_golden, attn, mode):
    """One make_train_step step on the RNN backbone with the discriminator
    (no guided attention, no flash call), against the JAX step's golden,
    with tests/test_torch_train.py::test_train_step_matches_jax's
    tolerances: metrics 1e-5 relative, new BN state 1e-5, Adam's first
    moments 1e-4 relative plus 1e-5 of their tree's largest, new params as
    the normalised first update (new - old) / lr to 1e-3 where JAX's first
    moment is above 1e-7 and to 2 (a sign flip of a tiny gradient)
    elsewhere."""
    params, _, tp, ts = _models(attn)
    _check_init(step_golden, attn, params)
    cfg = _cfg(attn, mode)
    args = train_args(RG.CONFIG, objective_eval_mode=mode == "eval")
    assert TS.flash_calls_per_step(cfg, args) == (0, 0)
    assert TS.flash_calls_per_eval_batch(cfg) == 0
    batches = {k: tuple(_t(a) for a in v) for k, v in RG.batches_np().items()}
    before = (flash_attention.launches, flash_attention.backward_calls)
    patch = TS.zero_fixed_dropouts() if mode == "train" else contextlib.nullcontext()
    with patch:
        new, metrics = TS.make_train_step(cfg, args)(
            TS.train_state(tp, ts, cfg, args), torch.Generator().manual_seed(0),
            batches)
    assert (flash_attention.launches, flash_attention.backward_calls) == before
    pre = f"{attn}/{mode}/"

    def tree(name):
        p = f"{pre}{name}/"
        return {k[len(p):]: v for k, v in step_golden.items() if k.startswith(p)}
    ref_metrics = tree("metrics")
    assert sorted(metrics) == sorted(ref_metrics)
    for k, r in ref_metrics.items():
        np.testing.assert_allclose(_np(metrics[k]), r, rtol=1e-5, err_msg=k)
    for k, r in tree("state").items():
        np.testing.assert_allclose(G.flatten(new.net_state)[k], r, atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    for name, opt in (("gen_mu", new.gen_opt), ("disc_mu", new.disc_opt)):
        mine, ref = G.flatten(opt.mu), tree(name)
        assert mine.keys() == ref.keys()
        top = max(np.abs(r).max() for r in ref.values())
        for k, r in ref.items():
            np.testing.assert_allclose(mine[k], r, rtol=1e-4, atol=1e-5 * top,
                                       err_msg=k)
    old, mine, ref = G.flatten(tp), G.flatten(new.params), tree("params")
    mu = {**tree("gen_mu"), **{"discriminator/" + k: v
                               for k, v in tree("disc_mu").items()}}
    assert mine.keys() == ref.keys()
    for k, r in ref.items():
        u_mine, u_ref = (mine[k] - old[k]) / args.lr, (r - old[k]) / args.lr
        big = np.abs(mu[k]) > 1e-7
        np.testing.assert_allclose(u_mine[big], u_ref[big], atol=1e-3, err_msg=k)
        assert (np.abs(u_mine - u_ref) <= 2 + 1e-3).all(), k


# ---------------------------------------------------------------------------
# The Synthesizer (JAX from the golden) and the trainer
# ---------------------------------------------------------------------------


def test_synthesizer_matches_jax(golden):
    """The port's Synthesizer on the RNN backbone against the JAX one's
    golden, on the same weights and requests (tests/torch_serve_golden.py's
    texts, buckets and mels): mels 1e-4, waveforms 2e-3 of their peak, ASR
    ids equal with every greedy margin asserted."""
    params, state = RG.serve_trees()
    _check_init(golden, "serve", params)
    cfg = _cfg("lsa")
    tp, ts = params_from_jax(params, state)
    syn = Synthesizer(tp, ts, cfg, audio_params=TAudioParams(n_iter=2),
                      device="cpu", **SG.KW)
    for i, b in enumerate(syn.tts_mels(SG.TEXTS)):
        a = golden[f"serve/tts_mels/{i}"]
        assert a.shape == b.shape
        _close(b, a, 1e-4, f"tts_mels {i}")
    wavs = syn.tts(SG.TEXTS) + [syn.tts_long(SG.LONG_TEXT)]
    for i, b in enumerate(wavs):
        a = golden[f"serve/tts/{i}"]
        assert a.shape == b.shape and len(a) > 0
        np.testing.assert_allclose(b, a, atol=2e-3 * np.abs(a).max(), rtol=0)
    mels = SG.asr_mels()
    ids = syn.asr_ids(mels)
    padded = np.zeros((2, 24, 80), np.float32)
    for i, m in enumerate(mels):
        padded[i, :len(m)] = m
    with torch.no_grad():
        (enc, mask), _ = TN.speech_encode(tp["speech_m"], ts["speech_m"], ECTX_T, cfg,
                                          _t(padded), torch.tensor([len(m) for m in mels]))
        gaps = _text_margins(tp["text_m"], ts["text_m"], cfg, enc, mask,
                             np.stack([np.pad(b, (0, 16 - len(b))) for b in ids]))
    for i, (b, g) in enumerate(zip(ids, gaps)):
        assert g[:len(b)].min() > MIN_MARGIN, g.min()
        assert np.array_equal(golden[f"serve/asr_ids/{i}"], np.asarray(b))
    with pytest.raises(ValueError, match="transformer backbone"):
        syn.asr_ids(mels, beam=2)


def test_trainer_runs_the_rnn_config(tmp_path):
    """`python -m unast_tpu_torch.train.loop --config configs/rnn_d_test.json
    --synthetic` (its main, in this process) for one short epoch on the
    CPU: every metric it logs is finite and the checkpoints are written."""
    import json
    from unast_tpu_torch.train import loop
    ck = tmp_path / "ck"
    loop.main(["--config", str(RG.CONFIG), "--synthetic", "--device", "cpu",
               "--epochs", "1", "--epoch_steps", "1", "--synthetic_size", "8",
               "--eval_batch_size", "2", "--checkpoint_path", str(ck),
               "--tb_log_path", ""])
    records = [json.loads(line) for line in (ck / "metrics.jsonl").read_text().splitlines()]
    values = [v for r in records for k, v in r.items() if k not in ("step", "time")]
    assert records and values and np.isfinite(values).all(), records
    assert any("train/" in k for r in records for k in r), records
    assert (ck / "model_best.ckpt").exists()
