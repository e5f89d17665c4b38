"""The port's stacking options (transformer.py's scan_layers, remat and
remat_policy, with MoE layers collecting their aux losses) against the JAX
package on the CPU, and one joint train step of each config recipe the
family slice opens: configs/wide_d1024.json (remat 'dots_all'), the
flagship with --speech_encoder conformer, and configs/transformer_trans.json
with --moe_experts 8 --moe_impl ragged.

The same weights go to both sides: the port's encoder_init and
decoder_init (torch seed 2) as numpy trees (tests/torch_family_golden.py).
The JAX side comes from the hash-guarded golden
tests/goldens/torch_family.npz. Tolerances, float32: the stacks' loss
1e-5 relative and gradients 1e-5 (relative, plus 1e-6); in train mode
with dropout, the gradient under remat equals, bit for bit, the one of
the same stack without checkpoints and with the same per-layer seeds
(scan_layers).
"""

import numpy as np
import pytest
import torch

from unast_tpu_torch import nn as tnn
from unast_tpu_torch import models as TG
from unast_tpu_torch.bridge import _to_torch
from unast_tpu_torch.models import networks as TN, transformer as TT
from unast_tpu_torch.ops import attention
from unast_tpu_torch.ops.attention import flash_attention
from unast_tpu_torch.train import steps as TS
from unast_tpu_torch.train.config import model_config_from_args, train_args

import torch_family_golden as FG
import torch_train_golden as G
from test_torch_conformer import check_conformer_train_mode

# a config's widths and depth cut to TINY's (models/config.py::TINY), and
# its decode caps to TINY's, so that cm's greedy decodes stay short
TINY_WIDTHS = dict(hidden=32, e_in=32, t_emb_dim=32, s_pre_hid=32, ffn_dim=64,
                   num_layers=2, nhead=2, attn_dim=16, disc_hid=16,
                   max_mel_len=24, max_text_len=16)
RECIPES = {
    "wide_d1024": ("configs/wide_d1024.json", {}),
    "conformer": ("configs/transformer_d_curriculum_fast.json",
                  {"speech_encoder": "conformer"}),
    "moe_ragged": ("configs/transformer_trans.json",
                   {"moe_experts": 8, "moe_impl": "ragged"}),
}


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
    return FG.load("stack0", "stack2", "conformer")


def _inputs():
    return [torch.from_numpy(a) for a in FG.seq_case()]


@pytest.mark.parametrize("form", list(FG.STACK_FORMS))
@pytest.mark.parametrize("moe", [0, 2])
def test_stacks_match_jax(golden, moe, form):
    """An encoder and a decoder over its output (dense, or MoE: ragged
    top-2 in the encoder, dispatch top-2 in the decoder, their aux losses
    in the loss), unrolled, scanned and rematerialised under each policy:
    the loss against JAX's under the same form, every gradient against
    JAX's unrolled one (the golden holds JAX's other forms within 1e-6 of
    it)."""
    p = _to_torch(FG.stack_trees(moe))
    leaves = FG.tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    loss = FG.stack_loss(TT, tnn, p, *_inputs(), moe > 0, form)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()),
                               float(golden[f"stack{moe}/{form}/loss"]), rtol=1e-5)
    if form != "unrolled":
        assert float(golden[f"stack{moe}/{form}/grad_vs_unrolled"]) <= 1e-6
    ref = FG.sub(golden, f"stack{moe}/grad/")
    paths = list(FG.flat(FG.to_np(p)))
    assert sorted(paths) == sorted(ref)
    for k, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), ref[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_conformer_under_remat_matches_jax(golden):
    """The conformer encoder rematerialised under 'dots_all' in train mode:
    output and BN state against JAX's, the gradient equal to the unrolled
    run's (tests/test_torch_conformer.py::check_conformer_train_mode)."""
    check_conformer_train_mode(golden, "remat_dots_all")


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("policy", ["", "dots", "dots_all"])
def test_remat_train_gradient_equals_unchecked(policy, impl):
    """Train mode, dropout 0.3 everywhere, MoE layers collecting: the
    checkpointed stack's loss, aux losses and gradient equal the
    un-checkpointed stack's with the same per-layer seeds (scan_layers), bit
    for bit. The recompute rebuilds each layer's generator from its seed,
    so it draws the forward's masks; the aux sums reach the ctx once."""
    p = _to_torch(FG.stack_trees(2))
    leaves = FG.tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    x, pad, y, ypad, _ = _inputs()

    def run(remat):
        ctx = tnn.Ctx(generator=torch.Generator().manual_seed(3), train=True,
                      aux_losses=[])
        kw = dict(impl=impl, scan_layers=not remat, remat=remat,
                  remat_policy=policy)
        m = TT.encoder(p["encoder"], ctx, x, pad, FG.H, 0.3,
                       moe_opts=FG.STACK_MOE_OPTS["encoder"], **kw)
        o = TT.decoder(p["decoder"], ctx, y, m, ypad, pad, FG.H, 0.3,
                       moe_opts=FG.STACK_MOE_OPTS["decoder"], **kw)
        loss = (o ** 2).mean() + sum(ctx.aux_losses)
        return loss, ctx.aux_losses, torch.autograd.grad(loss, leaves)

    loss0, aux0, g0 = run(False)
    loss1, aux1, g1 = run(True)
    assert len(aux0) == len(aux1) == 2
    assert torch.equal(loss0, loss1)
    for a, b in zip(aux0 + list(g0), aux1 + list(g1)):
        assert torch.equal(a, b)


def _batches(n_text=8, n_mel=12, b=2):
    """One micro-batch per objective: tokens 3..45 with EOS at len - 1,
    uniform mels zero past their lengths (numpy seed 7)."""
    rng = np.random.default_rng(7)
    tl, ml = np.array([n_text, 5]), np.array([n_mel, 7])
    text = rng.integers(3, 46, (1, b, n_text))
    text = np.where(np.arange(n_text) == tl[:, None] - 1, 2, text)
    text = np.where(np.arange(n_text) >= tl[:, None], 0, text)
    mel = rng.uniform(0, 1, (1, b, n_mel, 80)).astype(np.float32)
    mel = mel * (np.arange(n_mel) < ml[:, None])[..., None]
    mb = (torch.from_numpy(text), torch.from_numpy(mel),
          torch.from_numpy(tl)[None], torch.from_numpy(ml)[None])
    return {k: mb for k in ("ae", "cm", "sp", "d")}


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_config_recipe_takes_a_joint_step(recipe):
    """The port's args from the recipe's config (and flags), only the widths,
    depth and decode caps cut to TINY's (the config's remat policy, dtype,
    guided attention and discriminator kept): one joint step of
    make_train_step on the CPU, finite metrics, flash forwards (the
    registered operator's, counted where its CPU implementation runs the
    plain version, flash_attention_fwd_plain; under remat the checkpoint recompute included) and
    backward calls as flash_calls_per_step counts them; the MoE recipe
    reports its aux."""
    path, flags = RECIPES[recipe]
    args = train_args(G.ROOT / path, **flags, **TINY_WIDTHS)
    cfg = model_config_from_args(args)
    assert TN.check_ported(cfg) is None
    if recipe == "wide_d1024":
        assert cfg.remat and cfg.remat_policy == "dots_all"
        assert args.ga_weight > 0 and cfg.compute_dtype == "bfloat16"
        assert cfg.use_discriminator
    ts = TS.init_train_state(torch.Generator().manual_seed(0), cfg, args,
                             device="cpu")
    before = flash_attention.backward_calls
    forwards = []
    plain = attention.flash_attention_fwd_plain
    attention.flash_attention_fwd_plain = lambda *a: forwards.append(1) or plain(*a)
    try:
        new, metrics = TS.make_train_step(cfg, args)(
            ts, torch.Generator().manual_seed(1), _batches())
    finally:
        attention.flash_attention_fwd_plain = plain
    fwd, bwd = TS.flash_calls_per_step(cfg, args)
    flash = cfg.attn_impl == "flash"
    assert (flash_attention.backward_calls - before, len(forwards)) == (
        (bwd, fwd) if flash else (0, 0))
    assert new.step == 1
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    assert ("sp/moe" in metrics) == (recipe == "moe_ragged")
    if recipe == "conformer":
        assert set(new.net_state["speech_m"]) == {"postnet", "encoder"}


def test_flash_operator_keeps_launch_and_recompute_counts():
    """The registered operator changes no count: a TINY flash train step
    under remat 'dots_all' (whose checkpoint policy saves only aten
    mm/addmm/bmm/baddbmm outputs, so the operator is recomputed) runs the
    forwards and backwards flash_calls_per_step predicts, the recompute
    included; on this CPU host the operator's implementation runs the
    plain version (flash_attention_fwd_plain, o and lse) once a forward,
    so the forwards are counted there."""
    cfg = TG.TINY.replace(attn_impl="flash", remat=True,
                          remat_policy="dots_all", use_discriminator=True)
    args = train_args(G.CONFIG, ae_steps=1, cm_steps=0, sp_steps=1, d_steps=1,
                      objective_eval_mode=True)
    fwd, bwd = TS.flash_calls_per_step(cfg, args)
    params, state = TG.unast_init(torch.Generator().manual_seed(0), cfg)
    ts = TS.train_state(params, state, cfg, args)
    rng = np.random.default_rng(0)
    batch = tuple(x[None] for x in (
        torch.from_numpy(rng.integers(3, 46, (2, 6))), torch.rand(2, 8, 80),
        torch.tensor([6, 4]), torch.tensor([8, 5])))
    seen = []
    plain = attention.flash_attention_fwd_plain
    attention.flash_attention_fwd_plain = lambda *a: seen.append(1) or plain(*a)
    before = flash_attention.backward_calls
    try:
        TS.make_train_step(cfg, args)(ts, torch.Generator().manual_seed(1),
                                      {"ae": batch, "sp": batch, "d": batch})
    finally:
        attention.flash_attention_fwd_plain = plain
    assert (len(seen), flash_attention.backward_calls - before) == (fwd, bwd)
    assert cfg.remat and fwd > bwd + 2 * cfg.num_layers   # the recompute ran
