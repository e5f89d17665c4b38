"""The port's data parallelism (unast_tpu_torch/parallel/) against the
single-process port and the JAX package, at TINY on the CPU.

One module fixture starts a 2-rank gloo world once
(tests/torch_parallel_worker.py, which imports only torch and the port);
each rank runs every case and rank 0 writes what these tests compare. The
JAX side of the sharded steps comes from tests/goldens/torch_parallel.npz
(tests/torch_parallel_golden.py); the ZeRO leaf rule is held to JAX's
train_state_shardings live (no compile).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_golden as PG
import torch_train_golden as G
from unast_tpu_torch.models import TINY, unast_init
from unast_tpu_torch.train import steps as TS
from unast_tpu_torch.train.config import train_args

HERE = Path(__file__).resolve().parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The two ranks' records ({'rank0': ..., 'rank1': ...}); both ranks
    are joined and must exit 0."""
    out = tmp_path_factory.mktemp("dp")
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(HERE / "torch_parallel_worker.py"),
                               str(r), port, str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in (0, 1)]
    logs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return {f"rank{r}": torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in (0, 1)}


def test_zero_leaf_rule_matches_jax():
    """parallel/mesh.py::train_state_shardings against JAX's on the same
    tree (the port's TINY TrainState with the discriminator, its leaves as
    numpy arrays, in JAX's TrainState), dp = 2, zero 0, 1 and 3: the same
    dim of the same leaves goes over 'dp', and at zero 1 and 3 some
    optimizer leaves split and some stay replicated."""
    import jax
    from unast_tpu.parallel import make_mesh as jax_mesh
    from unast_tpu.parallel.mesh import train_state_shardings as jax_rule
    from unast_tpu.train.steps import TrainState as JaxTrainState
    from unast_tpu_torch.parallel import mesh as PM

    class Mesh2:   # what train_state_shardings reads of a DeviceMesh
        mesh_dim_names = ("dp",)

        def __getitem__(self, name):
            return self

        def size(self):
            return 2

    cfg = TINY.replace(use_discriminator=True)
    args = train_args(PG.CONFIG)
    ts = TS.train_state(*unast_init(torch.Generator().manual_seed(0), cfg), cfg, args)
    as_np = PM._map(lambda _, x: x.numpy() if torch.is_tensor(x) else x, ts)
    jmesh = jax_mesh(dp=2, devices=jax.devices()[:2])

    def key(k):
        return str(getattr(k, "name", getattr(k, "key", getattr(k, "idx", k))))

    for zero in PG.ZEROS:
        rule = PM.train_state_shardings(Mesh2(), ts, zero)
        mine = {p: d for (p,), (d,) in zip(
            PM._leaves(PM._map(lambda p, _: p, ts)), PM._leaves(rule))}
        ref = jax.tree_util.tree_leaves_with_path(
            jax_rule(jmesh, JaxTrainState(*as_np), zero),
            is_leaf=lambda x: hasattr(x, "spec"))
        ref = {"/".join(key(k) for k in path): next(
            (i for i, a in enumerate(s.spec) if a == "dp"), None)
            for path, s in ref}
        assert mine == ref, zero
        split = [p for p, d in mine.items() if d is not None]
        assert bool(split) == (zero > 0)
        assert all(p.startswith(("gen_opt/", "disc_opt/")) or
                   (zero == 3 and p.startswith("params/")) for p in split)
        if zero:
            opt = [d for p, d in mine.items() if p.startswith("gen_opt/mu/")]
            assert None in opt and any(d is not None for d in opt)


def _compare_steps(mine, ref, lr, old, metric_rtol, loose=2.0):
    """The train-step test's comparison (tests/test_torch_train.py::
    test_train_step_matches_jax): metrics, BN state, both optimizers'
    first Adam moments, and the new params as the normalised update (new - old) / lr, within
    1e-3 where the reference's first moment is above 1e-7 and within
    `loose` elsewhere (2: a rounding sign flip of a gradient of ~0 at an
    Adam step, whose update is at most 1)."""
    assert sorted(mine["metrics"]) == sorted(ref["metrics"])
    for k, r in ref["metrics"].items():
        np.testing.assert_allclose(mine["metrics"][k], r, rtol=metric_rtol, err_msg=k)
    for k, r in ref["state"].items():
        np.testing.assert_allclose(mine["state"][k], r, atol=1e-5, rtol=1e-5, err_msg=k)
    for name in ("gen_mu", "disc_mu"):
        if not ref[name]:   # a family step has one optimizer
            continue
        top = max(np.abs(r).max() for r in ref[name].values())
        for k, r in ref[name].items():
            np.testing.assert_allclose(mine[name][k], r, rtol=1e-4,
                                       atol=1e-5 * top, err_msg=k)
    mu = {**ref["gen_mu"], **{"discriminator/" + k: v for k, v in ref["disc_mu"].items()}}
    assert mine["params"].keys() == ref["params"].keys() == mu.keys()
    for k, r in ref["params"].items():
        u_mine, u_ref = (mine["params"][k] - old[k]) / lr, (r - old[k]) / lr
        big = np.abs(mu[k]) > 1e-7
        np.testing.assert_allclose(u_mine[big], u_ref[big], atol=1e-3, err_msg=k)
        assert (np.abs(u_mine - u_ref) <= loose + 1e-3).all(), k


def _np(rec):
    return {k: ({n: np.asarray(v) for n, v in rec[k].items()} if k != "metrics"
                else rec[k]) for k in rec}


@pytest.mark.parametrize("zero", PG.ZEROS)
def test_dp_steps_match_single_process(world, zero):
    """A dp = 2 joint step (gloo, each rank 2 of the 4 rows) under zero 0,
    1 and 3 against the port's single-process step on the whole batch,
    from the same weights: metrics within 1e-6 relative (measured 1.2e-7,
    sums reassociated over the ranks), the rest as the train-step test
    compares it (normalised updates 6e-4 where the moment is above 1e-7).
    Under ZeRO 1 and 3 each rank holds about half the optimizer state."""
    r0, r1 = world["rank0"], world["rank1"]
    old = G.flatten(G.init_trees()[0])
    lr = train_args(PG.CONFIG).lr
    _compare_steps(_np(r0[f"dp/{zero}"]), _np(r1["single"]), lr, old, 1e-6)
    whole = r0["opt_bytes/0"]
    for r in (r0, r1):
        if zero:
            assert 0.45 * whole < r[f"opt_bytes/{zero}"] < 0.55 * whole
        else:
            assert r[f"opt_bytes/{zero}"] == whole


@pytest.mark.parametrize("zero", PG.ZEROS)
def test_dp_steps_match_jax_sharded(world, zero):
    """The dp = 2 step under each ZeRO level against the JAX package's
    step sharded over a 2-device mesh with the same zero (golden), with
    the train-step test's tolerances (metrics 1e-5 relative). The
    discriminator shuffle's permutation differs by design (ROADMAP queue
    3); the loss is a mean over rows treated alone."""
    golden = PG.load()
    pre = f"{zero}/"
    ref = {name: {k[len(pre) + len(name) + 1:]: v for k, v in golden.items()
                  if k.startswith(f"{pre}{name}/")}
           for name in ("metrics", "params", "state", "gen_mu", "disc_mu")}
    ref["metrics"] = {k: float(v) for k, v in ref["metrics"].items()}
    old = G.flatten(G.init_trees()[0])
    _compare_steps(_np(world["rank0"][f"dp/{zero}"]), ref,
                   train_args(PG.CONFIG).lr, old, 1e-5)


def test_uneven_valid_frames_need_global_means(world):
    """The ranks hold different numbers of valid frames and tokens, so the
    mean of the two ranks' own single-process losses misses the global
    batch's loss (each masked mean divides by the global mask sum): the
    dp step's losses equal the single-process step's, not that mean."""
    r0, r1 = world["rank0"], world["rank1"]
    single = r1["single"]["metrics"]
    dp = r0["dp/0"]["metrics"]
    gaps = []
    for k in ("ae/s_ae", "ae/t_ae", "sp/tts", "sp/asr", "cm/s_cm"):
        per_rank = 0.5 * (r0["local_metrics"][k] + r1["local_metrics"][k])
        assert dp[k] == pytest.approx(single[k], rel=1e-6), k
        gaps.append(abs(per_rank - single[k]) / abs(single[k]))
    assert min(gaps) > 1e-3, gaps


def test_zero_checkpoint_resumes(world):
    """A ZeRO-3 state after one dp step, saved whole by rank 0
    (train/checkpoint.py), loaded on both ranks onto a fresh template and
    placed again, gives each rank the slices it kept in memory, bit for
    bit (tests/test_zero.py::test_zero_sharded_state_checkpoints)."""
    for r in ("rank0", "rank1"):
        kept, placed = world[r]["resume/kept"], world[r]["resume/placed"]
        assert kept.keys() == placed.keys()
        for k in kept:
            assert torch.equal(kept[k], placed[k]), (r, k)
    sizes = [sum(x.numel() for k, x in world[r]["resume/kept"].items()
                 if k.startswith("params/")) for r in ("rank0", "rank1")]
    assert sizes[0] == sizes[1] < sum(
        x.numel() for x in world["rank1"]["single"]["params"].values())


def test_collectives_and_global_decode_stop(world):
    """parallel/collectives.py over the 2 ranks: total sums, mean gives
    each rank its share of the global mean, sum_grad's gradient is the
    global one (d S**2 / d x_r = 2 S = 6 for x = 1, 2), any_rank is the
    global test (and the local one without a group). The speech decode
    under dp, where rank 1's row stops at its first frame and rank 0's
    never: both ranks decode until the global batch stops, so the
    train-mode postnet BatchNorm, which reads every frame of the buffer,
    gives each rank the single-process decode's row and new state."""
    for r in (0, 1):
        c = world[f"rank{r}"]["collectives"]
        assert c["total"] == 3.0 and c["mean_share"] == (r + 1) / 2
        assert c["grad"] == 6.0 and c["any"] is True and c["any_alone"] == (r == 1)
        d = world[f"rank{r}"]["decode"]
        assert d["lens"] == [d["lens_single"][r]] and d["lens_single"] == [TINY.max_mel_len, 1]
        np.testing.assert_allclose(d["post"].numpy(), d["post_single"].numpy(),
                                   atol=1e-5, rtol=1e-5)
        for k, v in d["bn_single"].items():
            np.testing.assert_allclose(d["bn"][k].numpy(), v.numpy(), atol=1e-6,
                                       rtol=1e-5, err_msg=k)


def test_host_sharded_dataset(world):
    """HostShardedDataset: rank r of 2 reads items r, r + 2, ... of 5."""
    assert world["rank0"]["host_shard"] == [0, 2, 4]
    assert world["rank1"]["host_shard"] == [1, 3]


def test_synthesizer_mesh_matches_single_process(world):
    """Synthesizer(mesh=) over 2 ranks (3 requests, padded to 4 by
    repeating the last) against the single-process Synthesizer: TTS mels
    within 1e-6, greedy ASR ids equal token for token on both ranks, every
    greedy choice leading its runner-up by more than 1e-3 (asserted), and
    max_batch 3 refused; with nar_pv, melgan_params, ctc_pv and
    quantize='int8' the waveforms within 1e-6 and the one-pass CTC ids
    equal."""
    r0, r1 = world["rank0"], world["rank1"]
    for r in (r0, r1):
        assert len(r["syn/mels"]) == len(PG.SYN_TEXTS)
        for a, b in zip(r["syn/mels"], r0["one/mels"]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
        assert [x.tolist() for x in r["syn/ids"]] == [x.tolist() for x in r0["one/ids"]]
    assert min(float(m.min()) for m in r0["one/margins"]) > 1e-3
    assert "divide over dp=2" in r0["syn/odd_batch_error"]
    # nar_pv, melgan_params, ctc_pv and quantize='int8' under the mesh
    for r in (r0, r1):
        assert len(r["syn_opts/wavs"]) == len(PG.SYN_TEXTS)
        for a, b in zip(r["syn_opts/wavs"], r0["one_opts/wavs"]):
            assert a.shape == b.shape and a.shape[0] > 0
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
        assert [x.tolist() for x in r["syn_opts/ids"]] == \
            [x.tolist() for x in r0["one_opts/ids"]]


# ---------------------------------------------------------------------------
# Model parallelism (tp, ep), the MoE capacity under dp, the family steps
# ---------------------------------------------------------------------------


def _mesh_case(world, name):
    """(mesh record, single-process record, the params before the step)
    of a worker case, from the rank that wrote it."""
    r = next(w for w in world.values() if f"{name}/mesh" in w)
    return _np(r[f"{name}/mesh"]), _np(r[f"{name}/single"]), \
        {k: v.numpy() for k, v in r[f"{name}/init"].items()}


@pytest.mark.parametrize("impl", ["dispatch", "ragged"])
def test_moe_dp_matches_single_process(world, impl):
    """An MoE (E 4, groups of 16 tokens, capacity factor 0.5: tokens
    overflow) dp = 2 zero-1 step against the single-process step on the
    whole batch, metrics within 1e-6 relative (the aux 'moe' losses too),
    the rest as the dp tests compare it. On the dispatch route the groups
    and the capacity cumsum are the global batch's: groups of 16 of the
    48 text tokens straddle the ranks' 24, so per-rank grouping (which
    regrouped each rank's rows alone) fails this test."""
    mine, ref, old = _mesh_case(world, f"moe_dp/{impl}")
    assert any(k.endswith("/moe") for k in ref["metrics"])
    _compare_steps(mine, ref, train_args(PG.CONFIG).lr, old, 1e-6)


@pytest.mark.parametrize("case", ["transformer", "conformer", "train_mode"])
def test_tp_steps_match_single_process(world, case):
    """A tp = 2 joint step (each rank its nhead / 2 heads and half of
    every column / row split, the same rows) against the single-process
    step, metrics within 1e-6 relative, the rest as the dp tests compare
    it: the transformer, and the conformer speech encoder under Adafactor
    (its block-RMS clip, which needs the whole leaves, acts from the
    second step: both sides start from one single-process step), with
    every dropout at 0, and train mode with the config's dropouts on the xla
    attention route (the attention probabilities' and the FFN hidden's
    masks drawn whole from the shared stream, each rank keeping its
    slice; guided attention over the local heads). Each rank holds about
    half of the split leaves' optimizer state."""
    mine, ref, old = _mesh_case(world, f"tp/{case}")
    # Adafactor's second update of an element is at most 1 / sqrt(1 -
    # decay) = 2 ** 0.4 (optim._factored_update at count 1), so a rounding
    # sign flip of a gradient of ~0 (a conv bias ahead of train-mode
    # BatchNorm) costs 2 * 2 ** 0.4 at most
    _compare_steps(mine, ref, train_args(PG.CONFIG).lr, old, 1e-6,
                   loose=2 * 2 ** 0.4 if case == "conformer" else 2.0)
    r = next(w for w in world.values() if f"tp/{case}/opt_bytes" in w)
    rank_bytes, whole = r[f"tp/{case}/opt_bytes"]
    assert 0.5 * whole < rank_bytes < 0.8 * whole


@pytest.mark.parametrize("impl", ["dispatch", "ragged"])
def test_ep_steps_match_single_process(world, impl):
    """An ep = 2 step with E 4 (each rank 2 experts on the same tokens,
    the combine all-reduced over ep) against the single-process step,
    metrics within 1e-6 relative, the rest as the dp tests compare it
    (top-1 routing gives each token one expert, so the all-reduced
    partial sums add zeros and the step matches bit for bit). Each rank
    holds half of the expert stacks' optimizer state."""
    mine, ref, old = _mesh_case(world, f"ep/{impl}")
    _compare_steps(mine, ref, train_args(PG.CONFIG).lr, old, 1e-6)
    r = next(w for w in world.values() if f"ep/{impl}/opt_bytes" in w)
    rank_bytes, whole = r[f"ep/{impl}/opt_bytes"]
    assert rank_bytes < whole


@pytest.mark.parametrize("case", ["ctc_tp", "distill_tp", "melgan_dp"])
def test_family_steps_match_single_process(world, case):
    """The family steps on the mesh (tests/test_sharded_families.py's
    cases): make_ctc_step and make_distill_step (the teacher's params
    split too, its cross-attention heads gathered for the durations) at
    tp = 2, make_vocoder_step at dp = 2 (each rank 2 of the 4 crops),
    against the single-process step: metrics within 1e-6 relative, the
    new params and first moments as the dp tests compare them. The CTC
    step's grad_norm is held to 4e-6: in the single process a 1e-7
    relative perturbation of the weights moves it by 9.6e-7 relative (the
    CTC gradient's posteriors amplify rounding), and the tp step's
    reassociated sums measure 1.9e-6."""
    mine, ref, old = _mesh_case(world, f"family/{case}")
    if case == "ctc_tp":
        np.testing.assert_allclose(mine["metrics"].pop("grad_norm"),
                                   ref["metrics"].pop("grad_norm"), rtol=4e-6)
    _compare_steps(mine, ref, 1e-3, old, 1e-6)


def test_tp_checkpoint_resumes(world):
    """A tp = 2 state after one step, saved whole by rank 0, loaded on
    both ranks and placed again, gives each rank the slices it kept,
    bit for bit, and those hold fewer params than the whole."""
    for r in ("rank0", "rank1"):
        kept, placed = world[r]["tp_resume/kept"], world[r]["tp_resume/placed"]
        assert kept.keys() == placed.keys()
        for k in kept:
            assert torch.equal(kept[k], placed[k]), (r, k)
    old = _mesh_case(world, "tp/transformer")[2]
    assert sum(x.numel() for k, x in world["rank0"]["tp_resume/kept"].items()
               if k.startswith("params/")) < sum(v.size for v in old.values())


@pytest.mark.parametrize("family", ["transformer", "conformer", "moe", "rnn"])
def test_model_split_rule_matches_jax(family):
    """The port's tp and ep split of every leaf of the TINY TrainState
    (parallel/mesh.py::split_rule at tp = ep = 2) against JAX's _spec_for
    called live (ep_axis on): the same dims over the same axes, except
    the leaves whose tp dim does not divide, which the port keeps
    replicated where GSPMD pads them: exactly the RNN attention's v/w
    [attn_dim, 1] and its optimizer mirrors."""
    import jax
    from unast_tpu.parallel.mesh import _spec_for as jax_spec
    from unast_tpu_torch.parallel import mesh as PM

    cfg = {"transformer": TINY, "conformer": TINY.replace(speech_encoder="conformer"),
           "moe": TINY.replace(moe_experts=4),
           "rnn": TINY.replace(model_type="rnn")}[family].replace(use_discriminator=True)
    args = train_args(PG.CONFIG)
    ts = TS.train_state(*unast_init(torch.Generator().manual_seed(0), cfg), cfg, args)
    as_np = PM._map(lambda _, x: x.numpy() if torch.is_tensor(x) else x, ts)
    ref = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(as_np):
        spec = tuple(jax_spec(path, leaf, ep_axis=True))
        key = "/".join(str(getattr(k, "name", getattr(k, "key", getattr(k, "idx", k))))
                       for k in path)
        ref[key] = {i: a for i, a in enumerate(spec) if a is not None}
    leaves = {}
    PM._map(leaves.__setitem__, ts)
    mine = {p: dict(PM.split_rule(p, tuple(x.shape), 2, 2).dims)
            for p, x in leaves.items() if torch.is_tensor(x) and x.ndim >= 1}
    assert mine.keys() <= ref.keys()
    padded = sorted(k for k in mine if mine[k] != ref[k])
    for k in padded:    # only a tp dim that does not divide differs
        assert {i: a for i, a in ref[k].items() if i not in mine[k]} == {1: "tp"}, k
        assert leaves[k].shape[1] == 1, k
    assert all(k.endswith("decoder/attn/v/w") for k in padded), padded
    assert bool(padded) == (family == "rnn")
    split = [k for k in mine if mine[k]]
    if family == "rnn":
        assert not split
    else:
        assert any("/q/w" in k for k in split) and any("/lin2/w" in k or "/down/w" in k
                                                      for k in split)
    if family == "moe":
        assert any(v == {0: "ep", 2: "tp"} for v in mine.values())
    if family == "conformer":
        assert any(k.endswith("conv_pw1/w") and v == {1: "tp"} for k, v in mine.items())
