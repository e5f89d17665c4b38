"""The port's MoE FFN (models/moe.py), its hooks in the train step
(train/steps.py::_moe_aux) and the bridge of expert stacks and int8 trees,
against the JAX package on the CPU.

The same weights go to both sides: the port's inits as numpy trees
(tests/torch_family_golden.py), bridged into the port's trees. The JAX
side comes from the hash-guarded golden tests/goldens/torch_family.npz.
Tolerances, float32: FFN outputs 1e-5, the aux loss 1e-6 relative; the
joint step as tests/test_torch_train.py::test_train_step_matches_jax
holds it.
"""

import numpy as np
import pytest
import torch

from unast_tpu_torch import nn as tnn
from unast_tpu_torch.bridge import _to_torch, params_from_jax
from unast_tpu_torch.models import TINY, moe as TM, unast as TU
from unast_tpu_torch.ops.attention import flash_attention
from unast_tpu_torch.train import steps as TS
from unast_tpu_torch.train.config import train_args

import torch_family_golden as FG
import torch_serve_golden as SG
import torch_train_golden as G

TOL = dict(rtol=1e-5, atol=1e-5)


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
    return FG.load("moe", "step")


def _case():
    x, pad, _, _, _ = FG.seq_case()
    return torch.from_numpy(x), torch.from_numpy(pad)


@pytest.mark.parametrize("i", range(len(FG.MOE_CASES)),
                         ids=["-".join(map(str, c)) for c in FG.MOE_CASES])
def test_moe_ffn_matches_jax(golden, i):
    """moe_ffn under each routing case (dispatch top-1 and top-2 with
    groups of 8, a capacity that overflows, ragged top-1 and top-2) and its
    load-balance aux loss. The same tokens fall through at capacity: the
    valid rows with a zero output are JAX's."""
    p = _to_torch(FG.moe_tree())
    x, pad = _case()
    ctx = tnn.Ctx(aux_losses=[])
    out = TM.moe_ffn(p, ctx, x, pad, 0.1, FG.MOE_CASES[i]).numpy()
    ref = golden[f"moe/{i}/out"]
    np.testing.assert_allclose(out, ref, **TOL)
    assert len(ctx.aux_losses) == 1
    np.testing.assert_allclose(float(ctx.aux_losses[0]),
                               float(golden[f"moe/{i}/aux"]), rtol=1e-6)
    dropped = (np.abs(out).max(-1) == 0) & ~pad.numpy()
    assert np.array_equal(dropped, (np.abs(ref).max(-1) == 0) & ~pad.numpy())
    assert dropped.any() == (i == 2)   # only the overflowing case drops


@pytest.mark.parametrize("k", [1, 2])
def test_moe_dense_decode_step_matches_jax(golden, k):
    """T == 1 (the KV-cached decode step) takes the exact dense-combine
    path and collects no aux loss."""
    p = _to_torch(FG.moe_tree())
    x, _ = _case()
    ctx = tnn.Ctx(aux_losses=[])
    out = TM.moe_ffn(p, ctx, x[:, :1], None, 0.1, (k,))
    np.testing.assert_allclose(out.numpy(), golden[f"moe/dense/{k}"], **TOL)
    assert ctx.aux_losses == []


def test_router_ties_and_groups_follow_jax():
    """lax.top_k takes the lower index on a tie (all-zero router rows tie
    exactly); jnp.argsort is stable; _auto_group picks the largest divisor
    of B*T that is at most the group size (4096 when 0)."""
    vals, idx = TM._top_k(torch.full((3, 4), 0.25), 2)
    assert idx.tolist() == [[0, 1]] * 3 and vals.eq(0.25).all()
    vals, idx = TM._top_k(torch.tensor([[0.1, 0.4, 0.1, 0.4]]), 2)
    assert idx.tolist() == [[1, 3]]
    assert TM._auto_group(8 * 816, 0) == 3264 and TM._auto_group(24, 8) == 8
    assert TM._auto_group(7, 4) == 1


def test_bridge_keeps_int8_and_expert_stacks(golden):
    """A JAX quantize_params tree of an MoE FFN (the golden's) crosses the
    bridge with its _q leaves int8 and its _scale leaves float32, and the
    expert stacks [E, ...] stay stacked; only a `layers` stack is
    unstacked."""
    jq = SG.unflatten(FG.sub(golden, "quant/moe/"))
    assert jq["lin1"]["w_q"].dtype == np.int8
    p, _ = params_from_jax({"moe": jq, "layers": {"w": np.ones((3, 2, 2))}},
                           {})
    assert p["moe"]["lin1"]["w_q"].dtype == torch.int8
    assert p["moe"]["lin1"]["w_q"].shape == (FG.N_EXPERTS, FG.D, FG.F)
    assert p["moe"]["lin1"]["w_scale"].dtype == torch.float32
    assert p["moe"]["router"]["w_q"].shape == (FG.D, FG.N_EXPERTS)
    assert isinstance(p["layers"], list) and len(p["layers"]) == 3


def test_moe_train_step_matches_jax(golden):
    """One make_train_step step of TINY with a conformer speech encoder and
    MoE FFNs (2 experts, top-2, ragged), the discriminator, guided
    attention and flash on, every dropout at 0, train mode, against the
    JAX step's golden, with the tolerances of
    test_train_step_matches_jax. The objectives' 'moe' metrics are the raw
    aux sums; the flash backward calls are flash_calls_per_step's (cm's
    pseudo-pair encoders keep their gradients under MoE)."""
    cfg = TINY.replace(**FG.STEP_KW, **TS.ZERO_DROPOUTS)
    args = train_args(G.CONFIG, sp_steps=2)
    tp, ts = (_to_torch(t) for t in FG.model_trees(FG.STEP_KW))
    batches = {k: tuple(torch.from_numpy(a).long() if a.dtype == np.int32
                        else torch.from_numpy(a) for a in v)
               for k, v in G.batches_np().items()}
    before = flash_attention.backward_calls
    with TS.zero_fixed_dropouts():
        new, metrics = TS.make_train_step(cfg, args)(
            TS.train_state(tp, ts, cfg, args), torch.Generator().manual_seed(0),
            batches)
    assert (flash_attention.backward_calls - before
            == TS.flash_calls_per_step(cfg, args)[1])
    ref = FG.sub(golden, "step/metrics/")
    assert sorted(metrics) == sorted(ref) and {"ae/moe", "cm/moe", "sp/moe"} <= set(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(float(metrics[k]), r, rtol=1e-5, err_msg=k)
    for k, r in FG.sub(golden, "step/state/").items():
        np.testing.assert_allclose(G.flatten(new.net_state)[k], r, atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    for name, opt in (("gen_mu", new.gen_opt), ("disc_mu", new.disc_opt)):
        mine, r = G.flatten(opt.mu), FG.sub(golden, f"step/{name}/")
        assert mine.keys() == r.keys()
        top = max(np.abs(v).max() for v in r.values())
        for k, v in r.items():
            np.testing.assert_allclose(mine[k], v, rtol=1e-4, atol=1e-5 * top,
                                       err_msg=k)
    old, mine = G.flatten(tp), G.flatten(new.params)
    ref = FG.sub(golden, "step/params/")
    mu = {**FG.sub(golden, "step/gen_mu/"),
          **{"discriminator/" + k: v
             for k, v in FG.sub(golden, "step/disc_mu/").items()}}
    assert mine.keys() == ref.keys()
    for k, r in ref.items():
        u_mine, u_ref = (mine[k] - old[k]) / args.lr, (r - old[k]) / args.lr
        big = np.abs(mu[k]) > 1e-7
        np.testing.assert_allclose(u_mine[big], u_ref[big], atol=1e-3, err_msg=k)
        assert (np.abs(u_mine - u_ref) <= 2 + 1e-3).all(), k
    assert TU.num_params(new.params) == int(golden["num_params_step"])
