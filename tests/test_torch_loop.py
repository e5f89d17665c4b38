"""The port's loop slice (unast_tpu_torch: data, metrics, config, EMA and
Adafactor, evaluation, checkpoints, the training loop and its entry
points) against the JAX package on the CPU.

The datasets, the metrics and the parser are numpy or Python on both
sides and run live: arrays and values exactly equal. The batches'
JAX side is a sha256 of each array in tests/goldens/torch_loop.npz. The
optimizers are held to optax's updates in tests/goldens/torch_ops.npz
(tests/torch_ops_golden.py) at tests/test_torch_train.py's tolerances
(1e-6 relative, 1e-7 absolute). Evaluation and the loop read the JAX
side from tests/goldens/torch_loop.npz (tests/torch_loop_golden.py;
JAX's compiles take minutes): float32, SpecAugment spans at 0 on both sides, losses and
metrics.jsonl values within 1e-4 relative, greedy ids, PER and d_score
exactly equal, with the greedy margins the ids rest on asserted.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from unast_tpu.data import dataset as JD, splits as JSp
from unast_tpu.infer import metrics as JM
from unast_tpu.train import config as JC

from unast_tpu_torch import nn as tnn
from unast_tpu_torch.data import batching as TB, dataset as TD, splits as TSp
from unast_tpu_torch.infer import evaluate as TE, metrics as TM, serve, server
from unast_tpu_torch.infer import synthesize
from unast_tpu_torch.models import TINY, modules as TMod, transformer as TT
from unast_tpu_torch.models import networks as TN, unast as TU
from unast_tpu_torch.ops import attention
from unast_tpu_torch.train import checkpoint as TCk, config as TC, debug
from unast_tpu_torch.train import loop as TL, optim as TO, steps as TS

import torch_loop_golden as LG
import torch_ops_golden as OG
import torch_train_golden as G

MIN_MARGIN = 1e-3   # least gap a greedy choice may have (test_torch_serve.py)
ECTX = tnn.Ctx.eval()


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


@pytest.fixture(scope="module")
def golden():
    z = np.load(LG.GOLDEN)
    stale = ("tests/goldens/torch_loop.npz is stale: {} changed; run "
             "`JAX_PLATFORMS=cpu python tests/torch_loop_golden.py`")
    assert str(z["source_hash"]) == LG.source_hash(), stale.format(
        "the JAX package, tests/torch_loop_golden.py or the config")
    return {k: z[k] for k in z.files}


def _sub(golden, prefix):
    return {k[len(prefix):]: v for k, v in golden.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("kw", [{}, {"timbre": "formant", "pitch_jitter": 0.2,
                                     "gain_jitter": 0.3, "jitter_variants": 2}])
def test_synthetic_dataset_matches_jax(kw):
    """SyntheticSpeechDataset's items (and, for the default kw, synth_audio,
    add_realism and an include_f0 item) equal the JAX package's, whose
    digests tests/goldens/torch_ops.npz keeps (OG.dataset_case)."""
    i = OG.DATASET_KW.index(kw)
    ref = {k[len(f"dataset/{i}/"):]: str(v) for k, v in OG.load().items()
           if k.startswith(f"dataset/{i}/")}
    mine = OG.dataset_case(TD, i)
    assert mine.keys() == ref.keys() and len(mine) > 3 * 4
    for k, v in mine.items():
        assert OG.digest(v) == ref[k], k
    if i == 0:
        assert (mine["f0_item/f0"] > 0).any()


def test_manifest_splits_and_ljspeech_match_jax(tmp_path):
    names = sorted(os.listdir(JSp.REFERENCE_SPLITS_DIR))
    assert names == sorted(os.listdir(TSp.REFERENCE_SPLITS_DIR))
    for name in names:
        with open(os.path.join(JSp.REFERENCE_SPLITS_DIR, name), "rb") as a, \
                open(os.path.join(TSp.REFERENCE_SPLITS_DIR, name), "rb") as b:
            assert a.read() == b.read(), name
    val = os.path.join(TSp.REFERENCE_SPLITS_DIR, "val.csv")
    rows = TD.load_manifest(val)
    assert rows == JD.load_manifest(val) and len(rows) == 300
    assert TSp.make_splits(rows, seed=3) == JSp.make_splits(rows, seed=3)
    TSp.write_splits(TSp.make_splits(rows[:40]), str(tmp_path / "s"))
    assert TD.load_manifest(str(tmp_path / "s" / "val.csv")) == \
        JSp.make_splits(rows[:40])["val"]
    rng = np.random.default_rng(0)
    for fid, _ in rows[:2]:
        np.save(tmp_path / f"{fid}.mel.npy", rng.uniform(size=(9, 80)).astype(np.float32))
    mine = TD.LJSpeechDataset(val, str(tmp_path))
    ref = JD.LJSpeechDataset(val, str(tmp_path))
    for i in (0, 1):
        _assert_items_equal(mine[i], ref[i])
    for fid, _ in rows[:2]:
        np.save(tmp_path / f"{fid}.f0.npy", rng.uniform(size=(9,)).astype(np.float32))
    mine = TD.LJSpeechDataset(val, str(tmp_path), include_f0=True)
    ref = JD.LJSpeechDataset(val, str(tmp_path), include_f0=True)
    for i in (0, 1):
        _assert_items_equal(mine[i], ref[i])
        assert np.array_equal(mine[i]["f0"], ref[i]["f0"])


@pytest.mark.parametrize("buckets", [{}, {"text_buckets": [8, 16],
                                          "mel_buckets": [64, 128]}])
def test_batches_match_jax(golden, buckets):
    """BatchGetter.step_batches (three steps, with and without buckets),
    _val_batches, and skip_steps landing where the skipped calls would,
    against the JAX package's (tests/torch_loop_golden.py keeps each of
    its arrays as a sha256 of dtype, shape and bytes)."""
    assert buckets in LG.BATCH_BUCKETS
    i = LG.BATCH_BUCKETS.index(buckets)
    args = LG.batch_args(buckets)

    def getter():
        return TB.BatchGetter(args, *(TD.SyntheticSpeechDataset(size=n, seed=s)
                                      for n, s in LG.GETTER_SETS))
    g = getter()
    for step in range(LG.BATCH_STEPS):
        mine = g.step_batches(args, True)
        ref = _sub(golden, f"batches/{i}/{step}/")
        assert {k.split("/")[0] for k in ref} == set(mine) == {"ae", "cm", "sp", "d"}
        for k, arrays in mine.items():
            assert len(arrays) == sum(r.startswith(k + "/") for r in ref)
            for j, a in enumerate(arrays):
                assert LG.array_hash(a) == str(ref[f"{k}/{j}"]), (step, k, j)
    skipped = getter()
    skipped.skip_steps(args, True, 2)
    for a, b in zip(skipped.step_batches(args, True)["cm"], mine["cm"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # unast_tpu/train/loop.py::_val_batches (the JAX loop's golden holds the
    # whole eval too)
    val = TL._val_batches(args, TD.SyntheticSpeechDataset(size=6, seed=3))
    assert len(val) == 2 and TL._fit_eval_bs(6, 4) == 3
    for n, a in enumerate(val):
        ref = {k: str(v) for k, v in _sub(golden, f"val/{n}/").items()}
        assert LG.item_hashes(a) == ref


def test_per_and_d_score_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(30):
        b, t1, t2 = rng.integers(1, 5), rng.integers(1, 30), rng.integers(1, 30)
        gt, hyp = rng.integers(0, 6, (b, t1)), rng.integers(0, 6, (b, t2))
        gl, hl = rng.integers(0, t1 + 1, b), rng.integers(0, t2 + 1, b)
        assert list(TM.levenshtein_batch(gt, hyp, gl, hl)) == [
            JM.edit_distance(list(gt[i, :gl[i]]), list(hyp[i, :hl[i]]))
            for i in range(b)]
        assert TM.compute_per(gt, hyp, gl, hl) == JM.compute_per(gt, hyp, gl, hl)
        assert TM.edit_distance(list(gt[0]), list(hyp[0])) == \
            JM.edit_distance(list(gt[0]), list(hyp[0]))
        out, tgt = rng.normal(size=2 * b), rng.uniform(size=2 * b)
        assert TM.compute_d_score(out, tgt) == JM.compute_d_score(out, tgt)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


def test_parser_matches_jax():
    """Every flag of the JAX CLI with its default, and one more, --device;
    a config with CLI overrides gives equal namespaces and ModelConfigs."""
    mine = {a.dest: a for a in TC.build_parser()._actions}
    ref = {a.dest: a for a in JC.build_parser()._actions}
    assert mine.keys() == ref.keys() | {"device"}
    for k, a in ref.items():
        assert mine[k].default == a.default, k
        assert mine[k].choices == a.choices, k
    assert mine["device"].default == "cuda"
    argv = ["--config", "configs/transformer_d_curriculum_fast.json", "--lr",
            "0.5", "--d_attn", "none", "--use_discriminator", "false",
            "--text_buckets", "[64, 304]", "--attn_impl=flash"]
    t, j = TC.parse_with_config(argv), JC.parse_with_config(argv)
    assert {**vars(j), "device": "cuda"} == vars(t)
    assert (dataclasses.asdict(TC.model_config_from_args(t))
            == dataclasses.asdict(JC.model_config_from_args(j)))
    assert t.lr == 0.5 and t.d_attn is None and t.attn_impl == "flash"
    assert TC.train_args("configs/transformer_test.json", lr=2.0).lr == 2.0


@pytest.mark.parametrize("flags,env,match", [
    (["--dp", "2"], {"WORLD_SIZE": "2"}, "--dp 2"),
    (["--tp", "2"], {"WORLD_SIZE": "2"}, "--tp 2"),
    (["--sp", "2"], {"WORLD_SIZE": "2"}, "--sp 2"),
    (["--ep", "4", "--moe_experts", "4"], {"WORLD_SIZE": "4"}, "--ep 4"),
    (["--zero", "1"], {}, "--zero 1"),
    ([], {"JAX_COORDINATOR_ADDRESS": "localhost:1234"}, "multihost"),
    ([], {"WORLD_SIZE": "2"}, "multihost"),
])
def test_unported_runtime_options_raise(monkeypatch, flags, env, match):
    """--dp, --tp, --sp, --ep, --zero and a multi-process launch are
    taken: --dp 2, --tp 2 and --sp 2 under a 2-process launch (WORLD_SIZE
    2), --ep 4 with 4 experts under a 4-process one, and --zero 1 pass; a
    launch whose world is not dp x tp x ep x sp, a tp that does not divide
    the heads, an ep that does not divide the experts and a JAX launcher's
    coordinator raise ValueError, while an sp over MoE layers (as JAX
    builds it) is taken (tests/test_torch_parallel.py and tests/
    test_torch_sp_pp.py run the 2-rank steps)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    args = TC.parse_with_config(flags)
    if match != "multihost":
        assert TC.apply_runtime_flags(args) is None
        if match in ("--tp 2", "--ep 4"):   # the axis must fit the model
            bad = TC.parse_with_config(flags + {
                "--tp 2": ["--nhead", "3"], "--ep 4": ["--moe_experts", "6"]}[match])
            with pytest.raises(ValueError, match="must divide"):
                TC.apply_runtime_flags(bad)
        if match == "--sp 2":   # sp takes MoE layers, as JAX's mesh does
            moe = TC.parse_with_config(flags + ["--moe_experts", "4"])
            assert TC.apply_runtime_flags(moe) is None
    else:
        with pytest.raises(ValueError, match=match):
            TC.apply_runtime_flags(args)


# ---------------------------------------------------------------------------
# Optimizers: EMA and Adafactor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("optim_type,clip,ema", [
    ("adafactor", 1.0, 0.0), ("adafactor", 1e4, 0.99), ("adamw", 1.0, 0.9)])
def test_optimizers_with_ema_match_optax(optim_type, clip, ema):
    """Two updates of make_optimizers' generator chain against JAX's
    (tests/torch_ops_golden.py keeps the params and the EMA after each),
    with the global-norm clip triggered (1.0) or not (1e4): a tree with
    factored leaves (3-D with unequal largest dims, 2-D with equal ones)
    and unfactored ones (1-D, and 2-D with a dim under 128); the EMA too."""
    assert (optim_type, clip, ema) in OG.EMA_CASES
    golden = OG.load()
    key = f"ema/{optim_type}-{clip}-{ema}"
    params, grads = OG.ema_case()
    opt = TS.make_optimizers(TINY, TC.train_args(
        optim_type=optim_type, grad_clip=clip, ema_decay=ema, **OG.OPT_KW))[0]
    tp = TO.tree_map(_t, params)
    tstate = opt.init(tp)
    for step, g in enumerate(grads):
        t_updates, tstate = opt.update(TO.tree_map(_t, g), tstate, tp)
        tp = TO.apply_updates(tp, t_updates)
        pairs = [(a, golden[f"{key}/{step}/params/{i}"])
                 for i, a in enumerate(TO.tree_leaves(tp))]
        if ema:
            pairs += [(a, golden[f"{key}/{step}/ema/{i}"])
                      for i, a in enumerate(TO.tree_leaves(TO.find_ema(tstate)))]
        for a, r in pairs:
            np.testing.assert_allclose(a.numpy(), r, rtol=1e-6, atol=1e-7)
    assert (TO.find_ema(tstate) is None) == (ema == 0)
    assert sum(k.startswith(f"{key}/1/params/") for k in golden) == len(pairs) - (
        len(TO.tree_leaves(TO.find_ema(tstate))) if ema else 0)


def test_ema_params_of_a_train_state():
    args = TC.train_args(ema_decay=0.5)
    cfg = TINY.replace(use_discriminator=True)
    ts = TS.init_train_state(torch.Generator().manual_seed(0), cfg, args, "cpu")
    ema = TS.ema_params(ts)
    assert ema["discriminator"] is ts.params["discriminator"]
    for k, v in TO.tree_paths(TS.split_params(ts.params)[0]).items():
        assert torch.equal(TO.tree_paths(ema)[k], v)
    assert TS.ema_params(TS.init_train_state(torch.Generator().manual_seed(0),
                                             cfg, TC.train_args(), "cpu")) is None


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def _greedy_text_margins(tp, cfg, memory, pad_mask, ids):
    """Top-1 minus top-2 logit at every step of a greedy text decode that
    followed `ids` (tests/test_torch_serve.py::_greedy_margins)."""
    b, n = ids.shape
    cache = TT.init_cache(tp["decoder"], memory, cfg.max_text_len, cfg.nhead)
    bias = TT.padding_bias(pad_mask)
    tok = torch.full((b, 1), 1, dtype=torch.long)
    gaps = []
    for i in range(n):
        x = TMod.positional_encoding(ECTX, TMod.text_embed(tp["prenet"], ECTX,
                                                           tok, cfg), offset=i)
        h, cache = TT.decoder_step(tp["decoder"], ECTX, x, i, cache, bias,
                                   cfg.nhead, 0.0)
        top2 = torch.topk(TMod.text_postnet(tp["postnet"], ECTX, h, cfg)[:, -1],
                          2).values
        gaps.append((top2[:, 0] - top2[:, 1]).numpy())
        tok = torch.as_tensor(ids[:, i:i + 1], dtype=torch.long)
    return np.stack(gaps, axis=1)


def test_evaluate_matches_jax(golden, tmp_path, monkeypatch):
    """evaluate in test mode at TINY (discriminator, flash) against the
    golden of JAX's: losses 1e-4 relative, PER, d_score and the greedy ids
    equal, the dumped mels within 1e-4; the greedy ASR choices and the TTS
    stop decisions clear MIN_MARGIN. Also the flash forwards per batch."""
    params, state = (TO.tree_map(torch.from_numpy, t) for t in G.init_trees())
    assert str(golden["eval/init_hash"]) == G.init_hash(G.init_trees()[0])
    cfg = TINY.replace(use_discriminator=True, attn_impl="flash", **LG.NO_SPEC)
    batches = LG.eval_batches(TD.SyntheticSpeechDataset, TB.collate)
    calls = []
    forward = attention._forward
    monkeypatch.setattr(attention, "_forward",
                        lambda *a: calls.append(1) or forward(*a))
    args = TC.parse_with_config(["--out_test_dir", str(tmp_path)])
    per, losses, d_score = TE.evaluate(params, state, cfg, args, batches,
                                       is_test=True)
    assert len(calls) == LG.EVAL_BATCHES * TS.flash_calls_per_eval_batch(cfg)
    assert per == float(golden["eval/per"]) and d_score == float(golden["eval/d_score"])
    ref = _sub(golden, "eval/loss/")
    assert losses.keys() == ref.keys()
    for k, r in ref.items():
        np.testing.assert_allclose(losses[k], r, rtol=1e-4, err_msg=k)
    with open(tmp_path / "text_preds.json") as f:
        preds = json.load(f)
    assert preds.keys() == _sub(golden, "eval/pred/").keys()
    for fname, r in _sub(golden, "eval/pred/").items():
        assert preds[fname]["pred"] == r.tolist(), fname
        np.testing.assert_allclose(np.load(tmp_path / "mels" / f"{fname}.pt.npy"),
                                   golden[f"eval/mel/{fname}"], rtol=1e-4, atol=1e-4)
    for batch in batches:
        text, mel, text_len, mel_len = TE.batch_to(batch, "cpu")
        with torch.no_grad():
            (s_enc, s_mask), _ = TN.speech_encode(params["speech_m"], state["speech_m"],
                                                  ECTX, cfg, mel, mel_len)
            (ids, n), _ = TN.text_infer(params["text_m"], state["text_m"], ECTX,
                                        cfg, s_enc, s_mask)
            gaps = _greedy_text_margins(params["text_m"], cfg, s_enc, s_mask,
                                        ids.numpy())
            (_, _, stops, stop_lens), _ = TU.tts(params, state, ECTX, cfg, text,
                                                 text_len, infer=True)
        for g, k in zip(gaps, n.numpy()):
            assert g[:k].min() > MIN_MARGIN, g[:k].min()
        for s, k in zip(stops.abs().numpy(), stop_lens.numpy()):
            assert s[:k].min() > MIN_MARGIN, s[:k].min()


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _state(seed, **kw):
    """A TrainState at TINY with the discriminator; a bf16 leaf in the
    params, a BN statistic and the step moved off their init values."""
    cfg = TINY.replace(use_discriminator=True)
    ts = TS.init_train_state(torch.Generator().manual_seed(seed), cfg,
                             TC.train_args(**kw), "cpu")
    ts.params["text_m"]["bf16_leaf"] = torch.randn(3, 5).to(torch.bfloat16)
    bn = next(k for k in TO.tree_paths(ts.net_state) if k.endswith("mean"))
    TO.tree_paths(ts.net_state)[bn].add_(seed + 1.0)
    return ts._replace(step=7 + seed)


def _assert_states_equal(a, b):
    pa, pb = TO.tree_paths(list(a)), TO.tree_paths(list(b))
    assert pa.keys() == pb.keys()
    for k, x in pa.items():
        if isinstance(x, torch.Tensor):
            assert x.dtype == pb[k].dtype and torch.equal(x, pb[k]), k
        else:
            assert x == pb[k], k
    assert [type(x) for x in a] == [type(x) for x in b]


@pytest.mark.parametrize("kw", [{}, {"optim_type": "adafactor", "ema_decay": 0.9}])
def test_checkpoint_round_trip_and_roles(tmp_path, kw):
    """Exact round trip (bf16 and float32 params, BN state, step count,
    optimizer states), the four roles with their sidecar keys, the
    directory -> model_best.ckpt rule, and a template that differs."""
    ts, other = _state(0, **kw), _state(1, **kw)
    d = str(tmp_path)
    TCk.save_ckp(0, 300.0, ts, False, d, temporary_save=True, rng=[17, 3])
    TCk.save_ckp(0, 0.4, ts, True, d, rng=[17, 3])
    TCk.save_ckp(1, 0.5, other, False, d, rng=None)
    TCk.save_ckp(1, 0.5, other, False, d, epoch_save=True, rng=[17, 5])
    roles = {"model_temporary.ckpt": (1, 300.0, [17, 3], ts),
             "model_best.ckpt": (1, 0.4, [17, 3], ts),
             "model_most_recent.ckpt": (2, 0.5, None, other),
             "model_1.ckpt": (2, 0.5, [17, 5], other)}
    assert sorted(os.listdir(d)) == sorted(
        [r for r in roles] + [r + ".meta.json" for r in roles])
    template = _state(2, **kw)
    for role, (epoch, best, rng, want) in roles.items():
        with open(os.path.join(d, role + ".meta.json")) as f:
            assert json.load(f).keys() == {"epoch", "valid_loss_min", "rng"}
        e, b, got, r = TCk.load_ckp(os.path.join(d, role), template)
        assert (e, b) == (epoch, best)
        assert (r is None) if rng is None else r.tolist() == rng
        _assert_states_equal(got, want)
    _assert_states_equal(TCk.load_ckp(d, template)[2], ts)
    wrong = _state(2)._replace(disc_opt=())
    with pytest.raises(ValueError, match="differs"):
        TCk.load_ckp(d, wrong)
    with pytest.raises(FileNotFoundError):
        TCk.load_ckp(os.path.join(d, "none.ckpt"), ts)


def test_async_save_snapshots_before_it_returns(tmp_path):
    ts = _state(0)
    leaf = ts.params["text_m"]["bf16_leaf"]
    want = leaf.clone()
    TCk.save_ckp(3, 0.2, ts, False, str(tmp_path), epoch_save=True,
                 async_save=True)
    leaf.add_(1.0)     # the next train step changing the live tensors
    TCk.wait_for_saves()
    got = TCk.load_ckp(str(tmp_path / "model_3.ckpt"), _state(1))[2]
    assert torch.equal(got.params["text_m"]["bf16_leaf"], want)


# ---------------------------------------------------------------------------
# The loop and its entry points
# ---------------------------------------------------------------------------


def _assert_metrics(path, golden, steps):
    mine = LG.metrics_records(path)
    ref = {k: v for k, v in _sub(golden, "loop/metrics/").items()
           if int(k.split("/")[0]) in steps}
    assert mine.keys() == ref.keys()
    for k, r in ref.items():
        if k.endswith("eval/per"):
            assert mine[k] == float(r), k
        else:
            np.testing.assert_allclose(mine[k], float(r), rtol=1e-4, err_msg=k)


def test_loop_matches_jax_and_resumes(golden, tmp_path, monkeypatch):
    """train() on configs/transformer_test.json (synthetic, one warm-start
    step, objective_eval_mode) for one epoch, then resumed (auto_resume)
    for the second: metrics.jsonl against the JAX loop's unbroken run. The
    four roles; Synthesizer.from_checkpoint on the save directory serves
    the final state bit for bit; evaluate_main writes its dumps."""
    make_cfg = TL.model_config_from_args
    monkeypatch.setattr(TL, "model_config_from_args",
                        lambda a: make_cfg(a).replace(**LG.NO_SPEC))
    ck = str(tmp_path / "ck")

    def run(epochs, **kw):
        args = TC.parse_with_config(LG.loop_argv(
            checkpoint_path=ck, device="cpu", epochs=epochs, save_every=1, **kw))
        args.objective_eval_mode = True
        assert str(golden["loop/init_hash"]) == G.init_hash(LG.loop_init_trees(args)[0])
        return args, TL.train(args)

    args, (ts, best) = run(1)
    metrics = os.path.join(ck, "metrics.jsonl")
    _assert_metrics(metrics, golden, {1, 2})
    assert {f for f in os.listdir(ck) if f.endswith(".ckpt")} == {
        "model_temporary.ckpt", "model_most_recent.ckpt", "model_best.ckpt",
        "model_0.ckpt"}
    syn = serve.Synthesizer.from_checkpoint(ck, args, text_buckets=(8,),
                                            mel_buckets=(16,))
    for got, want in ((syn.params, ts.params), (syn.net_state, ts.net_state)):
        _assert_states_equal([got], [want])
    assert len(syn.asr_ids([np.zeros((9, 80), np.float32)])) == 1

    _, (ts2, _) = run(2, auto_resume="true")
    _assert_metrics(metrics, golden, {1, 2, 3, 4})
    assert ts2.step == ts.step + 2

    out = tmp_path / "test_out"
    args.is_eval_test, args.load_path, args.out_test_dir = True, ck, str(out)
    per, d_score = TL.evaluate_main(args)
    assert np.isfinite(per) and 0 <= d_score <= 1
    assert len(json.load(open(out / "text_preds.json"))) == len(os.listdir(out / "mels")) == 2


@pytest.mark.parametrize("entry", [TL.main, server.main, synthesize.main, debug.main])
def test_entry_points_default_to_cuda(entry):
    """Each main() runs on --device, 'cuda' by default, and raises on a host
    without a card."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    argv = {synthesize.main: ["--list_file", "x", "--mels_dir", "m", "--out_dir", "o"]}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(argv.get(entry, ["--config", str(LG.LOOP_CONFIG), "--synthetic",
                               "--load_path", "none"]))
