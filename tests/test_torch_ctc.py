"""The port's CTC family (models/ctc.py, train/ctc.py, the hybrid
CTC/attention sp objective, cm_speech_in's 'ctc' and 'spec' decodes, the
speculative decode and the beam search of models/networks.py, and
Synthesizer(ctc_pv=)) against the JAX package on the CPU.

The same weights go to both sides: the port's ctc_asr_init and unast_init
from torch seed 0 at TINY, as numpy trees (tests/torch_ctc_golden.py),
which bridge.ctc_from_jax and bridge.params_from_jax turn into the
port's. The JAX side comes from the hash-guarded golden
tests/goldens/torch_ctc.npz. Tolerances, float32 throughout: logits 1e-5
under the absolute PE (xla and flash), the chunk mask and the relative
bias; greedy, prefix-beam, forced-alignment, speculative, beam-search and
Synthesizer ids exactly equal, with the greedy margins they rest on
asserted; ctc_loss and its gradient 1e-5 relative of optax's, on a batch
whose last row no alignment fits (in float32 that row's gradient is held
to optax's float64 one, as test_ctc_loss_and_gradient_match_optax says);
the streaming step 1e-5 of the
chunk-masked forward; two make_ctc_step updates: losses 1e-6 relative,
params 1e-5; the sp objective with ctc_weight 0.3 as
tests/test_torch_train.py holds the step (losses 1e-5 relative, gradients
1e-4 relative plus 1e-5 of the largest); cm_speech_in's outputs 1e-5.
"""

import numpy as np
import pytest
import torch

import unast_tpu_torch.models as TMs
from unast_tpu_torch import nn as tnn
from unast_tpu_torch.bridge import ctc_from_jax, params_from_jax
from unast_tpu_torch.infer.serve import Synthesizer
from unast_tpu_torch.models import TINY, ctc as TC, networks as TN, unast as TU
from unast_tpu_torch.train import ctc as TCT, steps as TS
from unast_tpu_torch.train.config import parse_with_config, train_args

import torch_ctc_golden as CG
import torch_serve_golden as SG
import torch_train_golden as G

MIN_MARGIN = 1e-3   # least gap a greedy choice may have (test_torch_serve.py)
ECTX = tnn.Ctx.eval()


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
    z = np.load(CG.GOLDEN)
    assert str(z["source_hash"]) == CG.source_hash(), (
        "tests/goldens/torch_ctc.npz is stale: the JAX package, a golden "
        "module or a library version changed; run "
        "`JAX_PLATFORMS=cpu python tests/torch_ctc_golden.py`")
    out = {k: z[k] for k in z.files}
    assert str(out["init_hash"]) == G.init_hash(CG.ctc_trees()[0]), (
        "the port's ctc_asr_init changed; run the golden module again")
    assert str(out["joint_init_hash"]) == G.init_hash(CG.joint_trees()[0]), (
        "the port's unast_init changed; run the golden module again")
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mel():
    mel, lens = CG.mel_case()
    return _t(mel), _t(lens).long()


def _ctc(variant):
    return ctc_from_jax(*CG.ctc_trees(variant))


def _joint():
    return params_from_jax(*CG.joint_trees())


JCFG = TINY.replace(attn_impl="flash", ctc_weight=CG.CTC_WEIGHT)


def _assert_margins(logits, valid):
    """Each greedy choice leads its runner-up by more than MIN_MARGIN."""
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1])[valid]
    assert float(gap.min()) > MIN_MARGIN, float(gap.min())


@pytest.mark.parametrize("variant", list(CG.VARIANTS))
def test_ctc_logits_and_greedy_match_jax(golden, variant):
    cfg = CG.variant_cfg(variant, TMs)
    p, s = _ctc("rel" if variant == "rel" else variant)
    mel, lens = _mel()
    logits, pad, _ = TC.ctc_logits(p, s, ECTX, cfg, mel, lens)
    np.testing.assert_allclose(_np(logits), golden[f"{variant}/logits"],
                               atol=1e-5, rtol=1e-5)
    _assert_margins(logits, ~pad)
    ids, n = TC.ctc_greedy_decode(logits, pad, cfg.max_text_len)
    assert np.array_equal(_np(ids), golden[f"{variant}/ids"])
    assert np.array_equal(_np(n), golden[f"{variant}/lens"])
    (ids2, n2), _ = TC.ctc_asr_infer(p, s, ECTX, cfg, mel, lens)
    assert torch.equal(ids, ids2) and torch.equal(n, n2)


def test_prefix_beam_and_forced_align_match_jax(golden):
    p, s = _ctc("abs")
    mel, lens = _mel()
    logits, pad, _ = TC.ctc_logits(p, s, ECTX, TINY, mel, lens)
    lp = torch.log_softmax(logits, dim=-1)
    for i in range(2):
        got = TC.ctc_prefix_beam_search(_np(lp[i]), int(lens[i]), beam=3,
                                        max_text_len=TINY.max_text_len)
        assert got == golden[f"prefix_beam/{i}"].tolist(), i
    labels, label_lens = CG.align_labels()
    for split in (False, True):
        dur = TC.ctc_forced_align(lp, ~pad, _t(labels).long(),
                                  _t(label_lens).long(), blank_split=split)
        assert np.array_equal(_np(dur), golden[f"align/{int(split)}"]), split
        assert np.array_equal(_np(dur.sum(1)), _np((~pad).sum(1)))


def _loss_and_grad(logits, pad, labels, label_lens):
    x = _t(logits).requires_grad_(True)
    loss = TC.ctc_loss(x, _t(pad), _t(labels).long(), _t(label_lens).long())
    (grad,) = torch.autograd.grad(loss, x)
    return float(loss.detach()), grad.numpy()


def test_ctc_loss_and_gradient_match_optax(golden):
    """ctc_loss against optax.ctc_loss on a batch whose last row no
    alignment fits (its loss near 1e5: optax's log_epsilon floor). In
    float64 the value and the whole gradient agree to 1e-5 relative. In
    float32 the value does, and the gradient of the rows that fit; the
    unfit row's float32 gradient is rounding noise around the float64 one
    in optax too (its forward variables sit near -1e5, where float32's
    step is 2**-7), so both float32 gradients are held to the float64
    gradient, to 5e-3 of its largest element (ROADMAP.md queue 3)."""
    logits, pad, labels, label_lens = CG.loss_case()
    loss64, g64 = _loss_and_grad(logits.astype(np.float64), pad, labels, label_lens)
    np.testing.assert_allclose(loss64, golden["loss64/value"], rtol=1e-5)
    ref64 = golden["loss64/grad"]
    np.testing.assert_allclose(g64, ref64, rtol=1e-5, atol=1e-5 * np.abs(ref64).max())
    loss, g = _loss_and_grad(logits, pad, labels, label_lens)
    assert np.isfinite(loss) and loss > 1e4   # the unfit row
    np.testing.assert_allclose(loss, golden["loss/value"], rtol=1e-5)
    ref = golden["loss/grad"]
    np.testing.assert_allclose(g[:2], ref[:2], rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    for got in (g[2], ref[2]):
        np.testing.assert_allclose(got, ref64[2], rtol=0,
                                   atol=5e-3 * np.abs(ref64[2]).max())
    # the rows that fit take torch's ctc_loss, the unfit one optax's
    # recursion; the recursion agrees with torch's on the rows that fit
    per = TC._optax_ctc_per_seq(_t(logits)[:2], _t(pad)[:2].float(),
                                _t(labels)[:2].long(),
                                (torch.arange(6) >= _t(label_lens)[:2, None]).float())
    fit = TC.ctc_loss(_t(logits)[:2], _t(pad)[:2], _t(labels)[:2].long(),
                      _t(label_lens)[:2].long())
    np.testing.assert_allclose(float(per.mean()), float(fit), rtol=1e-5)


@pytest.mark.parametrize("variant", ["chunk", "rel"])
def test_stream_step_matches_chunk_masked_forward(variant):
    cfg = CG.variant_cfg(variant, TMs)
    p, s = _ctc(variant)
    mel, lens = _mel()
    logits, pad, _ = TC.ctc_logits(p, s, ECTX, cfg, mel, lens)
    carry = TC.ctc_stream_init(p, cfg, 2)
    outs, toks = [], []
    for c0 in range(0, mel.shape[1], cfg.ctc_chunk):
        chunk = mel[:, c0:c0 + cfg.ctc_chunk]
        carry, lg, tok = TC.ctc_stream_step(p, ECTX, cfg, carry, chunk,
                                            ~pad[:, c0:c0 + cfg.ctc_chunk])
        outs.append(lg)
        toks.append(tok)
    got = torch.cat(outs, 1)
    valid = ~pad
    np.testing.assert_allclose(_np(got[valid]), _np(logits[valid]),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(torch.cat(toks, 1)[valid], logits.argmax(-1)[valid])


def test_ctc_step_matches_jax(golden):
    """Two adamw updates: losses 1e-6 relative, grad norms 1e-5, Adam's
    first moments as tests/test_torch_train.py holds them, and the new
    params 1e-5 wherever the gradient is more than summation noise (JAX's
    first moment above 1e-7); the attention key biases, whose gradient is
    0 in exact arithmetic (softmax cancels them), move by +-lr on a
    rounding sign in either package (2 * lr, as that test allows)."""
    cfg = TINY.replace(attn_impl="flash", **TS.ZERO_DROPOUTS)
    args = parse_with_config(CG.STEP_ARGV)
    p, s = _ctc("abs")
    tx = TCT.make_optimizer(args, TCT.make_schedule(args))
    ts = TCT.CtcTrainState(p, s, tx.init(p), 0)
    step = TCT.make_ctc_step(cfg, args)
    with TS.zero_fixed_dropouts():
        for i, b in enumerate(CG.step_batches()):
            ts, m = step(ts, torch.Generator().manual_seed(i),
                         TCT.batch_to(b, "cpu"))
            np.testing.assert_allclose(float(m["ctc/loss"]),
                                       golden[f"step/{i}/loss"], rtol=1e-6)
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       golden[f"step/{i}/grad_norm"], rtol=1e-5)
    assert ts.step == 2
    ref_mu = _golden_tree(golden, "step/mu/")
    mine_mu = G.flatten(ts.opt.mu)
    top = max(np.abs(r).max() for r in ref_mu.values())
    for k, r in ref_mu.items():
        np.testing.assert_allclose(mine_mu[k], r, rtol=1e-4, atol=1e-5 * top,
                                   err_msg=k)
    mine = G.flatten(ts.params)
    ref = _golden_tree(golden, "step/params/")
    assert mine.keys() == ref.keys()
    for k, r in ref.items():
        big = np.abs(ref_mu[k]) > 1e-7
        np.testing.assert_allclose(mine[k][big], r[big], atol=1e-5, rtol=1e-5,
                                   err_msg=k)
        assert (np.abs(mine[k] - r) <= 2 * args.lr + 1e-5).all(), k


def _golden_tree(golden, prefix):
    return {k[len(prefix):]: v for k, v in golden.items() if k.startswith(prefix)}


@pytest.mark.parametrize("micro", [0, 1])
def test_sp_objective_with_ctc_matches_jax(golden, micro):
    """The sp objective with ctc_weight 0.3 (eval mode, flash on): loss and
    aux 1e-5 relative; gradients 1e-4 relative plus 1e-5 of the largest
    (tests/test_torch_train.py's tolerance) on micro-batch 1, whose rows
    all fit a CTC alignment. In micro-batch 0 one row does not: its CTC
    loss is near 1e5 * 0.3, and its gradient float32 rounding noise of
    some 1e-3 relative in either package (test_ctc_loss_and_gradient_
    match_optax), so there the gradients are held to 1e-2 of the largest."""
    p, s = _joint()
    live = TS.tree_map(lambda x: x.detach().requires_grad_(True), p)
    args = train_args(G.CONFIG, objective_eval_mode=True)
    batch = tuple(_t(a).long() if a.dtype == np.int32 else _t(a)
                  for a in CG.sp_batch(micro))
    loss, (aux, _) = TS.sp_loss_fn(live, s, None, batch, JCFG, args, 1.0)
    np.testing.assert_allclose(float(loss.detach()), golden[f"sp{micro}/loss"],
                               rtol=1e-5)
    ref_aux = _golden_tree(golden, f"sp{micro}/aux/")
    assert sorted(aux) == sorted(ref_aux) and "ctc_sp" in aux
    for k, r in ref_aux.items():
        np.testing.assert_allclose(float(aux[k].detach()), r, rtol=1e-5, err_msg=k)
    leaves = TS.tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    mine = G.flatten(TS.tree_unflatten(live, [
        torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]))
    ref = _golden_tree(golden, f"sp{micro}/grad/")
    assert mine.keys() == ref.keys()
    top = max(np.abs(r).max() for r in ref.values())
    rtol, atol = (1e-4, 1e-5 * top) if micro else (0, 1e-2 * top)
    for k, r in ref.items():
        np.testing.assert_allclose(mine[k], r, rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("text_decode", ["ctc", "spec"])
def test_cm_speech_in_ctc_and_spec_match_jax(golden, text_decode):
    p, s = _joint()
    mel, lens = _mel()
    with torch.no_grad():
        out, _ = TU.cm_speech_in(p, s, ECTX, JCFG, mel, lens, ret_enc_hid=True,
                                 text_decode=text_decode)
    for k, v in zip(("pre", "post", "stop", "latent", "text_len"), out):
        ref = golden[f"cm_{text_decode}/{k}"]
        if k == "text_len":
            assert np.array_equal(_np(v), ref)
        else:
            np.testing.assert_allclose(_np(v), ref, atol=1e-5, rtol=1e-5, err_msg=k)


def test_spec_and_beam_decodes_match_jax(golden):
    """The CTC draft, the speculative decode (ids, stop lengths and
    rounds) and the beam search equal JAX's; the speculative ids also
    equal the port's own KV-cached greedy decode, whose choices lead by
    more than MIN_MARGIN."""
    p, s = _joint()
    mel, lens = _mel()
    with torch.no_grad():
        (enc, mask), _ = TN.speech_encode(p["speech_m"], s["speech_m"], ECTX,
                                          JCFG, mel, lens)
        ids, n = TU._cm_ctc_draft(p, JCFG, enc, mask, JCFG.max_text_len)
        assert np.array_equal(_np(ids), golden["draft/ids"])
        assert np.array_equal(_np(n), golden["draft/lens"])
        logits = tnn.linear(p["speech_m"]["ctc_head"], enc).float()
        _assert_margins(logits, ~mask)
        draft, _ = TC.ctc_greedy_decode(logits, mask, JCFG.max_text_len)
        sid, sn, rounds = TN.text_tr_spec_infer(p["text_m"], ECTX, JCFG, enc,
                                                mask, draft)
        assert np.array_equal(_np(sid), golden["spec/ids"])
        assert np.array_equal(_np(sn), golden["spec/lens"])
        assert rounds == int(golden["spec/rounds"])
        gid, gn = TN.text_tr_infer(p["text_m"], ECTX, JCFG, enc, mask)
        assert torch.equal(sid, gid) and torch.equal(sn, gn)
        assert np.array_equal(_np(gid), golden["greedy/ids"])
        # the parallel scorer's margins on the greedy transcript
        tf = TN.text_tr_decode_sequence(
            p["text_m"], ECTX, JCFG, gid, torch.full_like(gn, JCFG.max_text_len),
            enc, mask)
        _assert_margins(tf, torch.arange(JCFG.max_text_len)[None] < gn[:, None])
        # a draft that is already the greedy transcript verifies in one round
        _, _, one = TN.text_tr_spec_infer(p["text_m"], ECTX, JCFG, enc, mask, gid)
        assert one == 1
        bid, bn = TN.text_tr_beam_search(p["text_m"], ECTX, JCFG, enc, mask,
                                         beam=3)
        assert np.array_equal(_np(bid), golden["beam/ids"])
        assert np.array_equal(_np(bn), golden["beam/lens"])
        with pytest.raises(ValueError, match="eval-mode"):
            TN.text_tr_spec_infer(p["text_m"], tnn.Ctx(train=True), JCFG, enc,
                                  mask, draft)


def test_synthesizer_ctc_pv_matches_jax(golden):
    p, s = _joint()
    syn = Synthesizer(p, s, JCFG, ctc_pv=_ctc("abs"), device="cpu", **CG.SYN_KW)
    for name, kw in CG.ASR_OPTIONS.items():
        got = syn.asr_ids(SG.asr_mels(), **kw)
        for i, ids in enumerate(got):
            assert np.array_equal(np.asarray(ids), golden[f"syn/{name}/{i}"]), (name, i)
        if name == "spec":
            assert syn.last_spec_rounds == golden["syn/spec_rounds"].tolist()


def test_ctc_trainer_and_checkpoint_round_trip(tmp_path, capsys):
    """python -m unast_tpu_torch.train.ctc's main (in-process, on the CPU):
    a short run on the synthetic corpus prints its PER and saves a
    torch.save checkpoint that load_ctc_pv serves from, equal to the
    trained state."""
    argv = ["--synthetic", "--synthetic_size", "2", "--ctc_steps", "2",
            "--train_batch_size", "2", "--eval_batch_size", "2",
            "--hidden", "16", "--e_in", "16", "--s_pre_hid", "16",
            "--ffn_dim", "32", "--num_layers", "1", "--nhead", "2",
            "--data_mel_len", "64", "--data_text_len", "24",
            "--max_mel_len", "64", "--max_text_len", "24",
            "--device", "cpu", "--checkpoint_path", str(tmp_path)]
    ts, per = TCT.main(argv)
    assert "greedy CTC PER" in capsys.readouterr().out and per >= 0
    from unast_tpu_torch.train.config import model_config_from_args
    args = parse_with_config(argv)
    cp, cs = TCT.load_ctc_pv(str(tmp_path), model_config_from_args(args), args,
                             device="cpu")
    a, b = G.flatten(cp), G.flatten(ts.params)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
