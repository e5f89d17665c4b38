"""The port's sequence and pipeline parallelism (unast_tpu_torch/parallel/:
the sp axis, parallel/pipeline.py) against the single-process port and
the JAX package, at TINY on the CPU.

One module fixture starts a 2-rank gloo world once
(tests/torch_parallel_worker.py in its sp_pp mode, which imports only torch
and the port); each rank runs every case and writes its records. Another
starts a 4-rank world (the worker's pp4 mode) for a pp axis beside tp, ep
or sp. The JAX sides come from tests/goldens/torch_sp_pp.npz (tests/
torch_sp_pp_golden.py): its GPipe step without a mesh and its
pipeline_encoder over two devices.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_golden as PG
import torch_sp_pp_golden as SG
import torch_train_golden as G
from test_torch_parallel import _compare_steps, _free_port, _mesh_case, _np
from unast_tpu_torch.ops.attention import (flash_attention_bwd_plain,
                                           flash_attention_plain)
from unast_tpu_torch.train.config import train_args

HERE = Path(__file__).resolve().parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _start_world(tmp_path_factory, mode: str, n: int) -> dict:
    """The n ranks' records of the worker's `mode` ({'rank0': ...}); every
    rank is joined and must exit 0."""
    out = tmp_path_factory.mktemp(mode)
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(HERE / "torch_parallel_worker.py"),
                               str(r), port, str(out), mode], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(n)]
    logs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return {f"rank{r}": torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(n)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 2-rank world's records."""
    return _start_world(tmp_path_factory, "sp_pp", 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The 4-rank world's records (a pp axis with tp, ep or sp)."""
    return _start_world(tmp_path_factory, "pp4", 4)


@pytest.mark.parametrize("q_start", [3, 8])
def test_flash_plain_q_start_is_a_slice_of_causal(q_start):
    """flash_attention_plain and flash_attention_bwd_plain with q_start: a
    sequence-parallel rank's queries [q_start, q_start + n) against all
    T keys equal those rows of the whole causal attention, and its
    gradients the whole's under an output gradient on those rows only
    (float32, 1e-6)."""
    g = torch.Generator().manual_seed(q_start)
    q, k, v = (torch.randn((2, 13, 2, 16), generator=g) for _ in range(3))
    lens = torch.tensor([13, 9])
    n = 5
    whole = flash_attention_plain(q, k, v, lens, causal=True)
    part = flash_attention_plain(q[:, q_start:q_start + n], k, v, lens,
                                 causal=True, q_start=q_start)
    np.testing.assert_allclose(part.numpy(), whole[:, q_start:q_start + n].numpy(),
                               atol=1e-6)
    do = torch.zeros_like(whole)
    do[:, q_start:q_start + n] = torch.randn((2, n, 2, 16), generator=g)
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, lens, True, whole, do)
    pq, pk, pv = flash_attention_bwd_plain(q[:, q_start:q_start + n], k, v, lens,
                                           True, part, do[:, q_start:q_start + n],
                                           q_start=q_start)
    np.testing.assert_allclose(pq.numpy(), dq[:, q_start:q_start + n].numpy(), atol=1e-6)
    np.testing.assert_allclose(pk.numpy(), dk.numpy(), atol=1e-6)
    np.testing.assert_allclose(pv.numpy(), dv.numpy(), atol=1e-6)


@pytest.mark.parametrize("case", ["flash", "train_mode", "remat", "remat_dots_all",
                                  "moe_dispatch", "moe_ragged", "rnn"])
def test_sp_steps_match_single_process(world, case):
    """An sp = 2 joint step (each rank half of every sequence's frames
    through the prenets, stacks and postnets; K and V gathered, the convs'
    halos exchanged, BatchNorm over both ranks' frames) against the
    single-process step on the same batch, metrics within 1e-6 relative
    and the rest as tests/test_torch_parallel.py compares the dp steps
    (JAX holds its sp step to 2e-4): with flash, every dropout at 0; and
    in train mode with the config's dropouts on the xla route (each
    dropout draws the whole sequence's mask from the stream both ranks
    share), the conformer speech encoder and odd lengths (11 tokens, 19
    frames, cm's decodes 15 and 23: the last rank's padding frame kept out
    of the means, the BatchNorm statistics, the halos and the keys).
    The combinations the port once refused, each within the same
    tolerances: remat in train mode (the same conformer and odd lengths:
    each checkpointed layer's recompute gathers, exchanges halos, takes
    BatchNorm's statistics and draws dropout inside the region it ran in)
    and remat_policy dots_all with flash; the MoE dispatch route (E 4,
    groups of 16, capacity factor 0.5: tokens overflow, and the groups of
    JAX's flat row-then-frame order straddle the ranks' frames) and the
    ragged one on odd lengths (the padding frame takes no capacity and no
    aux mass); and the RNN backbone in train mode, its recurrences
    replicated over sp."""
    mine, ref, old = _mesh_case(world, f"sp/{case}")
    _compare_steps(mine, ref, train_args(PG.CONFIG).lr, old, 1e-6)


@pytest.mark.parametrize("case", ["flash", "train_mode"])
def test_pp_steps_match_single_process(world, case):
    """A pp = 2 joint step (each rank the 1 of the 2 layers of its stage of
    every pipelined stack, 4 micro-batches of one row, the activations and
    their gradients sent between the ranks) against the single-process
    step with the same cfg.pp = 2 (the one-process schedule), within the
    sp test's tolerances: with flash and every dropout at 0, and in train
    mode on the xla route (ae, sp and d, guided attention off, so that
    every decoder pipelines), where both draw each (layer, micro-batch)
    mask from its folded generator."""
    mine, ref, old = _mesh_case(world, f"pp/{case}")
    _compare_steps(mine, ref, train_args(PG.CONFIG).lr, old, 1e-6)


@pytest.mark.parametrize("case", ["tp_pp", "ep_pp", "sp_pp"])
def test_pp_axis_with_model_splits(world4, case):
    """A pp = 2 axis beside tp = 2 (each stage's layers split over its tp
    pair: the tp all-reduces among the ranks of one pp coordinate, the
    hops between ranks of one tp coordinate, the pipeline's all-reduce
    over pp summing the same tp slices), beside ep = 2 (the MoE stacks
    unstaged, their experts over ep) and beside sp = 2 (each stage on its
    sp rank's frames, odd lengths: the micro-batches hop as the rank's
    frames and gather K and V among the stage's sp pair), each a step of
    the 4-rank world against the single-process step with cfg.pp = 2 at
    the sp test's tolerances, every dropout at 0."""
    mine, ref, old = _mesh_case(world4, f"pp4/{case}")
    _compare_steps(mine, ref, train_args(PG.CONFIG).lr, old, 1e-6)
    for rank in world4.values():
        got, want = rank[f"pp4/{case}/bwd"]
        assert got == want, (case, got, want)


def test_remat_recompute_inside_region(world):
    """A checkpointed encoder layer (transformer._ckpt, dropout 0.3 drawn
    from one generator) inside an sp = 2 region of T = 7 (the last rank's
    fourth frame padding) has the gradients of the same layer unchecked,
    x's and every param's, within 1e-6 of a scale above 0.1 on both ranks:
    its recompute, in the backward after the region was left, re-enters
    the region (collectives.snapshot / restored) and gathers K and V,
    offsets nothing and draws the whole sequence's masks as the forward
    did."""
    for rank in world.values():
        r = rank["remat_in_region"]
        assert "error" not in r, r
        assert r["scale"] > 0.1 and r["err"] < 1e-6, r


def test_pp_step_matches_sequential_stack(world):
    """With every dropout at 0 the staged pp = 2 step equals the
    sequential stack's step (cfg.pp 1), as JAX's
    test_pp_train_step_matches_unsharded holds its (dp 2, pp 2) step
    (2e-4; here 1e-6 on the metrics)."""
    r = next(w for w in world.values() if "pp/flash/sequential" in w)
    old = {k: v.numpy() for k, v in r["pp/flash/init"].items()}
    _compare_steps(_np(r["pp/flash/mesh"]), _np(r["pp/flash/sequential"]),
                   train_args(PG.CONFIG).lr, old, 1e-6)


def test_flash_backward_calls_as_counted(world):
    """Each rank's flash backward calls in each step equal
    train/steps.py::flash_calls_per_step's (rows 4, staged on the pp
    ranks): an sp rank runs every attention on its frames, a pp rank the
    pipelined stacks' layers of its stage once per micro-batch and the
    guided-attention decoders whole."""
    for rank in world.values():
        for k, (got, want) in ((k, v) for k, v in rank.items() if k.endswith("/bwd")):
            assert got == want, k
    assert world["rank0"]["pp/flash/bwd"][0] > 0 and world["rank0"]["sp/flash/bwd"][0] > 0


def test_one_process_schedule_matches_jax(world):
    """The port's single-process step with cfg.pp = 2 (gpipe_stack's
    schedule in one process, every dropout at 0) against the JAX
    package's (its gpipe_stack without a mesh), the train-step test's
    tolerances (metrics 1e-5 relative)."""
    golden = SG.load()
    ref = {name: {k[len("pp_step/") + len(name) + 1:]: v for k, v in golden.items()
                  if k.startswith(f"pp_step/{name}/")}
           for name in ("metrics", "params", "state", "gen_mu", "disc_mu")}
    ref["metrics"] = {k: float(v) for k, v in ref["metrics"].items()}
    r = next(w for w in world.values() if "pp/flash/single" in w)
    _compare_steps(_np(r["pp/flash/single"]), ref, train_args(PG.CONFIG).lr,
                   G.flatten(G.init_trees()[0]), 1e-5)


def test_pipeline_encoder_matches_jax(world):
    """parallel/pipeline.py::pipeline_encoder on the two ranks (a stage
    each, 4 micro-batches) against JAX's on tests/test_ops.py::
    test_pipeline_encoder_uneven_microbatches' case (golden): the output
    within 2e-5 and its sum's input gradient within 2e-4, JAX's own
    tolerances, on both ranks."""
    golden = SG.load()
    for rank in world.values():
        r = rank["pipeline_encoder"]
        np.testing.assert_allclose(r["out"].numpy(), golden["encoder/out"],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["grad"].numpy(), golden["encoder/grad"],
                                   rtol=2e-4, atol=2e-4)


def test_halo_ops_match_unsplit(world):
    """nn.conv1d's symmetric (2, 2) and causal (4, 0) convs, BatchNorm in
    train mode and the conformer's depthwise conv inside a time-split
    region of T = 7 (4 frames a rank, the last rank's fourth a padding
    frame), gathered whole, against the same ops on the whole sequence:
    outputs within 1e-6 of a scale of 13, the gradients of x and of every
    param (each rank's loss 1/2, summed over the ranks) and the running
    statistics within 1e-5."""
    for rank in world.values():
        h = rank["halo"]
        assert h["scale"] > 1.0
        assert max(h["out"]) < 1e-6, h
        assert max(h["grad"]) < 1e-5 and max(h["state"]) < 1e-5, h


def test_make_mesh_matches_jax_layout(world):
    """parallel/mesh.py::mesh_dims lays the axes out as JAX's make_mesh
    does (the names, and device r at rank r's coordinates) for every
    combination of dp, tp, ep, sp and pp in {1, 2} over 8 devices or
    fewer; the world's sp and pp meshes put rank r at coordinate r."""
    import itertools

    import jax
    from unast_tpu.parallel import make_mesh as jax_mesh
    from unast_tpu_torch.parallel.mesh import mesh_dims
    for dp, tp, ep, sp, pp in itertools.product((1, 2), repeat=5):
        n = dp * tp * ep * sp * pp
        if n > len(jax.devices()):
            continue
        jm = jax_mesh(dp, tp, sp, ep, pp, devices=jax.devices()[:n])
        dims = mesh_dims(dp, tp, sp, ep, pp)
        assert tuple(k for k, _ in dims) == jm.axis_names
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        np.testing.assert_array_equal(np.arange(n).reshape([s for _, s in dims]), ids)
    for r, rank in enumerate(world.values()):
        assert rank["coords"] == {"sp": (0, 0, r), "pp": (0, 0, r)}


def test_sp_pp_refusals():
    """check_mesh refuses what JAX refuses (ValueError): tp not dividing
    nhead or ffn_dim, ep not dividing moe_experts, a pp axis that is not
    cfg.pp or does not divide the layers; a family step on an sp or pp
    mesh (JAX shards those over dp and tp only). It takes the
    combinations JAX builds: sp with MoE, remat, the RNN backbone or a pp
    axis, a pp axis with tp or ep, and configs/wide_d1024.json (remat
    under dots_all) at sp = 2, as the loop's flags check it."""
    from unast_tpu_torch.models import TINY, ModelConfig
    from unast_tpu_torch.parallel import mesh as PM
    from unast_tpu_torch.train.config import apply_runtime_flags

    for cfg, axes in ((TINY, dict(tp=3)),
                      (TINY.replace(moe_experts=4), dict(ep=3)),
                      (TINY, dict(pp=2)),
                      (TINY.replace(pp=2), dict(pp=4)),
                      (TINY.replace(pp=3, num_layers=2), dict(pp=3))):
        with pytest.raises(ValueError):
            PM.check_mesh(cfg, **axes)
    for cfg, axes in ((TINY.replace(moe_experts=4), dict(sp=2)),
                      (TINY.replace(remat=True, remat_policy="dots_all"), dict(sp=2)),
                      (TINY.replace(model_type="rnn"), dict(sp=2)),
                      (TINY.replace(pp=2), dict(sp=2, pp=2)),
                      (TINY.replace(pp=2), dict(tp=2, pp=2)),
                      (TINY.replace(pp=2, moe_experts=4), dict(ep=2, pp=2)),
                      (TINY.replace(pp=2), dict(pp=2)),
                      (TINY, dict(sp=2))):
        PM.check_mesh(cfg, **axes)
    wide = str(HERE.parent / "configs" / "wide_d1024.json")
    assert ModelConfig.from_json(wide).remat
    os.environ["WORLD_SIZE"], prev = "2", os.environ.get("WORLD_SIZE")
    try:
        apply_runtime_flags(train_args(wide, sp=2))
    finally:
        if prev is None:
            del os.environ["WORLD_SIZE"]
        else:
            os.environ["WORLD_SIZE"] = prev

    class Mesh:   # what shard_family_step reads of a DeviceMesh
        mesh_dim_names = ("dp", "tp", "sp")

        def __getitem__(self, name):
            return self

        def size(self):
            return 2

    with pytest.raises(ValueError, match="sp or pp"):
        PM.shard_family_step(lambda plan=None: None, Mesh(), None)
