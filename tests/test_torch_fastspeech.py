"""The port's FastSpeech family (models/fastspeech.py, train/fastspeech.py,
Synthesizer(nar_pv=), bridge.fastspeech_from_jax and load_jax_nar_pickle)
against the JAX package on the CPU.

The same weights go to both sides: the port's fastspeech_init from torch
seed 0 as numpy trees (tests/torch_fastspeech_golden.py), which
bridge.fastspeech_from_jax turns into the port's; the teacher is
torch_ctc_golden's joint model. The JAX side comes from the hash-guarded
golden tests/goldens/torch_fastspeech.npz. Tolerances, float32
throughout: forwards, predictors and variance targets 1e-5 (relative
where values are large); integer durations and output lengths exactly
equal, with the free-running rounding margins asserted; one distillation
step per duration source: durations equal, metrics 1e-5 relative, params
and BN state 1e-4 relative plus 1e-6 (as test_train_step_matches_jax),
except where JAX's first moment is rounding noise, nonzero and at most
FG.MU_FLOOR (test_torch_ctc.py's rule: within 2 lr there); such noise
covers at most MAX_NOISE_SHARE of a leaf unless the leaf's gradient is 0
in exact arithmetic (EXACT_ZERO_GRAD).
"""

import pickle
import re

import numpy as np
import pytest
import torch

import unast_tpu_torch.models as TMs
from unast_tpu_torch import nn as tnn
from unast_tpu_torch.bridge import (fastspeech_from_jax, load_jax_nar_pickle,
                                    params_from_jax)
from unast_tpu_torch.infer.serve import Synthesizer
from unast_tpu_torch.models import fastspeech as TF
from unast_tpu_torch.models.modules import lens_to_mask
from unast_tpu_torch.train import fastspeech as TFT
from unast_tpu_torch.train.config import parse_with_config
from unast_tpu_torch.train.optim import tree_paths
from unast_tpu_torch.train.steps import ZERO_DROPOUTS, zero_fixed_dropouts

import torch_ctc_golden as CG
import torch_fastspeech_golden as FG
import torch_train_golden as G

ECTX = tnn.Ctx.eval()
ROUND_MARGIN = 1e-3   # least distance of a free-running duration from .5
MAX_NOISE_SHARE = 0.2   # of a leaf's elements where JAX's gradient is rounding noise
# leaves whose gradient is 0 in exact arithmetic: softmax cancels the
# attention key biases, train-mode BatchNorm the biases of the postnet
# convs that feed it
EXACT_ZERO_GRAD = re.compile(r"attn/k/b$|postnet/(conv1|convs/\d+)/b$")


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
    z = np.load(FG.GOLDEN)
    assert str(z["source_hash"]) == FG.source_hash(), (
        "tests/goldens/torch_fastspeech.npz is stale: the JAX package, a "
        "golden module or a library version changed; run "
        "`JAX_PLATFORMS=cpu python tests/torch_fastspeech_golden.py`")
    out = {k: z[k] for k in z.files}
    for key, tree in (("init_hash", FG.fs_trees("fwd")[0]),
                      ("step_init_hash", FG.fs_trees("step")[0]),
                      ("joint_init_hash", CG.joint_trees()[0])):
        assert str(out[key]) == G.init_hash(tree), (
            f"the port's init behind {key} changed; run the golden module again")
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=atol)


def _fwd_model():
    return fastspeech_from_jax(*FG.fs_trees("fwd"))


def _text():
    text, lens = FG.text_case()
    return _t(text).long(), _t(lens).long()


def test_duration_predictor_and_length_regulate_match_jax(golden):
    p, _ = _fwd_model()
    text, tl = _text()
    x = _t(np.random.default_rng(27).normal(size=(2, 8, 32)).astype(np.float32))
    got = TF.duration_predictor(p["dur"], ECTX, x, ~lens_to_mask(tl, 8))
    assert got.dtype == torch.float32
    _close(got, golden["dur_pred"])
    assert not got[1, 5:].any()
    rx, rdur, rmax = FG.regulate_case()
    frames, lens = TF.length_regulate(_t(rx), _t(rdur).long(), rmax)
    assert np.array_equal(_np(lens), golden["regulate/lens"]) and lens.tolist() == [11, 14]
    assert np.array_equal(_np(frames), golden["regulate/frames"])


@pytest.mark.parametrize("case", ["random", "tied"])
def test_duration_sources_over_attention_match_jax(golden, case):
    """Hard and soft counts and MAS: integer durations equal, rows summing
    to mel_len; the tied case's quarters tie fractional parts, which the
    stable sort must rank as jnp.argsort does."""
    attns, ml, tl = FG.attn_cases()
    a, ml, tl = _t(attns[case]), _t(ml).long(), _t(tl).long()
    for soft in (False, True):
        d = TF.durations_from_attention(a, ml, tl, soft=soft)
        assert np.array_equal(_np(d), golden[f"attn_dur/{case}/{int(soft)}"]), soft
        assert d.sum(1).tolist() == ml.tolist()
    if case == "tied":
        frac = (_np(a).mean(axis=(0, 2)).sum(1)) % 1.0
        assert (np.bincount((frac[0, :8] * 4).astype(int)) > 1).any()
    d = TF.mas_durations(a, ml, tl)
    assert np.array_equal(_np(d), golden[f"mas/{case}"])
    assert d.sum(1).tolist() == ml.tolist()
    assert (d[lens_to_mask(tl, 8)] >= 1).all()


def test_variance_targets_match_jax(golden):
    mel, f0 = FG.variance_case()
    _, _, tl = FG.attn_cases()
    spans = _t(golden["attn_dur/random/0"]).long()
    tv = lens_to_mask(_t(tl).long(), 8).float()
    _close(TF.token_energy_in_graph(_t(mel), spans, tv), golden["energy_tgt"])
    _close(TF.token_log_f0_in_graph(_t(f0), spans, tv), golden["log_f0_tgt"])


def test_forward_teacher_and_free_running_match_jax(golden):
    """fastspeech_forward with teacher durations and pitch / energy targets,
    and free-running with speed, pitch_shift and energy_scale: mels 1e-5,
    lengths and the rounded durations equal (each expm1(log_dur) / speed
    at least ROUND_MARGIN from a rounding tie), and predict_variances."""
    p, s = _fwd_model()
    cfg = FG.cfg("fwd", TMs)
    text, tl = _text()
    dur, f0, en = FG.fwd_targets()
    (pre, post, lens, logd), _ = TF.fastspeech_forward(
        p, s, ECTX, cfg, text, tl, durations=_t(dur).long(), max_len=32,
        pitch_target=_t(f0), energy_target=_t(en))
    for k, v in dict(pre=pre, post=post, log_dur=logd).items():
        _close(v, golden[f"fwd_teacher/{k}"])
    assert np.array_equal(_np(lens), golden["fwd_teacher/lens"])
    (pre, post, lens, logd), _ = TF.fastspeech_forward(
        p, s, ECTX, cfg, text, tl, max_len=64, **FG.FREE)
    scaled = np.expm1(golden["fwd_free/log_dur"]) / FG.FREE["speed"]
    assert np.abs(np.abs(scaled - np.floor(scaled)) - 0.5).min() > ROUND_MARGIN
    assert np.array_equal(_np(lens), golden["fwd_free/lens"])
    for k, v in dict(pre=pre, post=post, log_dur=logd).items():
        _close(v, golden[f"fwd_free/{k}"])
    for name, v in zip(("log_dur", "log_f0", "energy"),
                       TF.predict_variances(p, s, cfg, text, tl)):
        _close(v, golden[f"var/{name}"])


@pytest.mark.parametrize("source", FG.SOURCES)
def test_distill_step_matches_jax(golden, source):
    """One make_distill_step step from the same student per duration
    source (the teacher's argmax, soft, MAS or CTC alignment, the uniform
    split, or durations in the batch) with every dropout at 0: the
    teacher's durations equal; metrics 1e-5 relative; params 1e-4 relative
    plus 1e-6 except where JAX's first moment is rounding noise (grad
    class 1 in the golden: within 2 lr there), BN state 1e-4 relative plus
    1e-6."""
    scfg = FG.cfg("step", TMs).replace(**ZERO_DROPOUTS)
    tcfg = FG.cfg("teacher", TMs)
    args = parse_with_config(FG.STEP_ARGV + [
        "--nar_dur_source", "argmax" if source == "durs" else source])
    tp, ts = params_from_jax(*CG.joint_trees())
    batch = TFT.batch_to(FG.step_batch(), "cpu",
                         ("text", "text_len", "mel", "mel_len", "f0"))
    if source == "durs":
        batch["durs"] = _t(golden["step/argmax/dur"]).long()
    with torch.no_grad():
        dur = TFT.teacher_durations(TFT.dur_source(args), tp, ts, tcfg, args, batch)
    assert np.array_equal(_np(dur), golden[f"step/{source}/dur"])
    sp, ss = fastspeech_from_jax(*FG.fs_trees("step"))
    tx = TFT.make_optimizer(args, TFT.make_schedule(args))
    fs = TFT.FSTrainState(sp, ss, tx.init(sp), 0)
    with zero_fixed_dropouts():
        new, m = TFT.make_distill_step(scfg, tcfg, args)(
            fs, tp, ts, torch.Generator().manual_seed(0), batch)
    keys = {k.split("/metric/")[1] for k in golden if k.startswith(f"step/{source}/metric/")}
    assert keys == set(m), (keys, set(m))
    for k in keys:
        np.testing.assert_allclose(float(m[k]), golden[f"step/{source}/metric/{k}"],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    ref = "argmax" if source == "durs" else source
    for name, tree in (("params", new.params), ("state", new.net_state)):
        flat = G.flatten(tree)
        prefix = f"step/{ref}/{name}/"
        want = {k[len(prefix):]: golden[k] for k in golden if k.startswith(prefix)}
        assert set(flat) == set(want)
        for path, v in flat.items():
            # where JAX's gradient is rounding noise, either package's first
            # Adam step takes a sign that rounding decides and moves by
            # +-lr, as tests/test_torch_ctc.py allows
            noise = (golden[f"step/{ref}/grad/{path}"] == 1 if name == "params"
                     else np.zeros(v.shape, bool))
            assert EXACT_ZERO_GRAD.search(path) or noise.mean() <= MAX_NOISE_SHARE, (
                path, noise.mean())
            np.testing.assert_allclose(v[~noise], want[path][~noise], rtol=1e-4,
                                       atol=1e-6, err_msg=path)
            assert (np.abs(v - want[path]) <= 2 * args.lr + 1e-6).all(), path


def test_eval_nar_mse_and_synthesizer_nar_match_jax(golden):
    p, s = _fwd_model()
    cfg = FG.cfg("fwd", TMs)
    mse, lens = TFT.eval_nar_mse(TFT.FSTrainState(p, s, None, 0), cfg,
                                 FG.eval_batch())
    np.testing.assert_allclose(mse, golden["eval_mse"], rtol=1e-5)
    assert np.array_equal(np.asarray(lens), golden["eval_lens"])
    jp, js = params_from_jax(*CG.joint_trees())
    syn = Synthesizer(jp, js, cfg.replace(ctc_weight=CG.CTC_WEIGHT), nar_pv=(p, s),
                      device="cpu", **FG.SYN_KW)
    mels = syn.tts_mels(FG.TEXTS)
    assert syn.last_decode_steps == []
    for i, m in enumerate(mels):
        assert m.shape == golden[f"syn/{i}"].shape
        np.testing.assert_allclose(m, golden[f"syn/{i}"], rtol=1e-5, atol=1e-5)


def test_nar_artefacts_load_with_their_stamp(golden, tmp_path):
    """A JAX pickle of save_nar_pickle loads through the bridge equal to the
    tree it was made from; the port's checkpoint round-trips; a stale stamp
    raises on both, an unversioned pair warns."""
    path = tmp_path / "nar.pkl"
    golden["nar_pickle"].tofile(path)
    want = fastspeech_from_jax(*FG.fs_trees("step"))
    got = load_jax_nar_pickle(str(path))
    ck = tmp_path / "nar.ckpt"
    TF.save_nar_checkpoint(str(ck), *want)
    for loaded in (got, TF.load_nar_checkpoint(str(ck))):
        for a, b in zip(loaded, want):
            fa, fb = tree_paths(a), tree_paths(b)
            assert fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fb)
    with open(path, "rb") as f:
        obj = pickle.load(f)
    obj["nar_format"] = 1
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    with pytest.raises(ValueError, match="format 1"):
        load_jax_nar_pickle(str(path))
    torch.save({"nar_format": 1, "pv": want}, ck)
    with pytest.raises(ValueError, match="format 1"):
        TF.load_nar_checkpoint(str(ck))
    torch.save(want, ck)
    with pytest.warns(UserWarning, match="unversioned"):
        TF.load_nar_checkpoint(str(ck))
