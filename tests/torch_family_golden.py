"""The cases of the family tests (tests/test_torch_conformer.py,
test_torch_moe.py, test_torch_quant.py, test_torch_remat.py) and the
golden of the JAX package on them: models/conformer.py, models/moe.py,
nn/quant.py, transformer.py's scan_layers / remat / MoE hooks, a joint
train step with a conformer speech encoder and MoE FFNs, Synthesizer(
quantize='int8'), the one-pass CTC ASR over a conformer, and the small
leftovers (soft_cross_entropy, mlp_discriminator, num_params).

JAX compiles the joint step for minutes on one CPU core and the
Synthesizer for tens of seconds, more than the port's test budget, so
this module runs them once and keeps what they return in
tests/goldens/torch_family.npz. The file records a hash of the JAX
package's sources, of this module and the golden module it builds on, and
of the jax, jaxlib, optax and numpy versions, and one of the weights; the
tests refuse a golden whose hashes no longer match: then run this module
again.

    JAX_PLATFORMS=cpu python tests/torch_family_golden.py

Weights come from the port's inits (torch seeds, as numpy trees), so both
sides run the same numbers: a conformer encoder (D, H, F, L, kernel
CONF_KERNEL, even, so that the 'same' pad is asymmetric), an MoE FFN of 4
experts, dense and MoE encoder + decoder stacks, unast_init at TINY (for
quantization and serving) and at TINY with STEP_KW (the joint step), a
CTC model over a conformer, an MLP discriminator. Every case is float32.
"""

import hashlib
import os
from pathlib import Path

import numpy as np

import torch_train_golden as G

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = Path(__file__).resolve().parent / "goldens" / "torch_family.npz"
D, H, F, L = 32, 2, 64, 2            # TINY's widths and depth
CONF_KERNEL = 6
N_EXPERTS = 4
# MoeOpts (top_k, capacity_factor, impl, group_size); the third overflows
# its capacity
MOE_CASES = ((1, 1.25, "dispatch", 0), (2, 1.25, "dispatch", 8),
             (1, 0.5, "dispatch", 8), (1, 1.25, "ragged", 0),
             (2, 1.25, "ragged", 0))
STACK_MOE_OPTS = {"encoder": (2, 1.25, "ragged", 0),
                  "decoder": (2, 1.25, "dispatch", 8)}
# name -> (scan_layers, remat, remat_policy)
STACK_FORMS = {"unrolled": (False, False, ""), "scan": (True, False, ""),
               "remat": (False, True, ""), "remat_dots": (False, True, "dots"),
               "remat_dots_all": (False, True, "dots_all")}
STEP_KW = dict(speech_encoder="conformer", moe_experts=2, moe_top_k=2,
               moe_impl="ragged", use_discriminator=True, attn_impl="flash")
CONF_KW = dict(speech_encoder="conformer", conformer_kernel=CONF_KERNEL)
STOP_BIAS = -100.0   # every served TTS request decodes max_mel_len frames
SYN_KW = dict(text_buckets=(8, 16), mel_buckets=(16, 24), max_batch=4)
TEXTS = ["hi there", "ok", "go now"]
MLP_HIDDEN = 16


def to_np(t):
    """A torch (or numpy) tree as numpy, dtypes kept."""
    if isinstance(t, dict):
        return {k: to_np(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [to_np(v) for v in t]
    return t.detach().numpy() if hasattr(t, "detach") else np.asarray(t)


def tree_leaves(tree):
    """The leaves of a tree in tree_paths (and flat) order."""
    from unast_tpu_torch.train.optim import tree_paths
    return list(tree_paths(tree).values())


def flat(tree):
    """{path: numpy array} of a tree, dtypes kept (int8 stays int8)."""
    from unast_tpu_torch.train.optim import tree_paths
    return {k: np.asarray(v) for k, v in tree_paths(tree).items()}


def _gen(seed):
    import torch
    return torch.Generator().manual_seed(seed)


def conformer_trees():
    """(params, state) of the port's conformer_encoder_init, torch seed 0."""
    from unast_tpu_torch.models.conformer import conformer_encoder_init
    return to_np(conformer_encoder_init(_gen(0), D, H, F, L, CONF_KERNEL))


def moe_tree():
    """The port's moe_init of N_EXPERTS experts, torch seed 1."""
    from unast_tpu_torch.models.moe import moe_init
    return to_np(moe_init(_gen(1), D, F, N_EXPERTS))


def stack_trees(moe: int):
    """{"encoder", "decoder"} of the port's encoder_init and decoder_init
    (moe experts a layer, 0 = dense), torch seed 2."""
    from unast_tpu_torch.models import transformer as T
    g = _gen(2)
    return to_np({"encoder": T.encoder_init(g, D, H, F, L, moe=moe),
                  "decoder": T.decoder_init(g, D, H, F, L, moe=moe)})


def model_trees(kw=None):
    """(params, state) of the port's unast_init at TINY.replace(**kw),
    torch seed 0."""
    from unast_tpu_torch.models import TINY, unast_init
    return to_np(unast_init(_gen(0), TINY.replace(**(kw or {}))))


def serve_trees():
    """model_trees() with the stop bias lowered by -STOP_BIAS."""
    p, s = model_trees()
    stop = p["speech_m"]["postnet"]["stop_proj"]
    stop["b"] = stop["b"] + np.float32(STOP_BIAS)
    return p, s


def ctc_trees():
    """(params, state) of the port's ctc_asr_init at TINY with CONF_KW,
    torch seed 3."""
    from unast_tpu_torch.models import TINY
    from unast_tpu_torch.models.ctc import ctc_asr_init
    return to_np(ctc_asr_init(_gen(3), TINY.replace(**CONF_KW)))


def mlp_tree():
    """The port's mlp_discriminator_init(D, MLP_HIDDEN), torch seed 4."""
    from unast_tpu_torch.models.unast import mlp_discriminator_init
    return to_np(mlp_discriminator_init(_gen(4), D, MLP_HIDDEN))


def seq_case():
    """x [2, 12, D] normal (numpy seed 30) with pad mask of lengths (12, 7);
    the decoder's input y [2, 9, D] (seed 31) with lengths (9, 5); a
    projection [D] (seed 32) for the stacks' loss."""
    rng = np.random.default_rng(30)
    x = rng.standard_normal((2, 12, D)).astype(np.float32)
    pad = np.arange(12)[None] >= np.array([12, 7])[:, None]
    rng = np.random.default_rng(31)
    y = rng.standard_normal((2, 9, D)).astype(np.float32)
    ypad = np.arange(9)[None] >= np.array([9, 5])[:, None]
    proj = np.random.default_rng(32).standard_normal(D).astype(np.float32)
    return x, pad, y, ypad, proj


def tts_case():
    """text [2, 8] ids 3..45 with lengths (8, 5), mel [2, 12, 80] uniform
    with lengths (12, 7), numpy seed 33."""
    rng = np.random.default_rng(33)
    tl = np.array([8, 5], np.int32)
    text = rng.integers(3, 46, (2, 8)).astype(np.int32)
    text = np.where(np.arange(8) < tl[:, None], text, 0).astype(np.int32)
    ml = np.array([12, 7], np.int32)
    mel = rng.uniform(0, 1, (2, 12, 80)).astype(np.float32)
    mel = mel * (np.arange(12) < ml[:, None])[..., None]
    return text, tl, mel, ml


def asr_mels():
    """The served ASR requests: uniform mels of 20 and 11 frames (seed 34)."""
    return [np.random.default_rng(34).uniform(0, 1, (n, 80)).astype(np.float32)
            for n in (20, 11)]


def ce_case():
    """logits [4, 5, 3] normal and soft targets (a softmax) over axis 1,
    numpy seed 35."""
    rng = np.random.default_rng(35)
    logits = rng.standard_normal((4, 5, 3)).astype(np.float32)
    t = np.exp(rng.standard_normal((4, 5, 3)))
    return logits, (t / t.sum(axis=1, keepdims=True)).astype(np.float32)


TREES = {"conformer": lambda: conformer_trees()[0], "moe": moe_tree,
         "stack0": lambda: stack_trees(0), "stack2": lambda: stack_trees(2),
         "model": lambda: model_trees()[0],
         "step": lambda: model_trees(STEP_KW)[0],
         "ctc": lambda: ctc_trees()[0], "mlp": mlp_tree}


def init_hash(name: str) -> str:
    """The init hash of the weight tree `name` of TREES."""
    return G.init_hash(TREES[name]())


class Golden:
    """The golden's arrays, each read from the file when first asked for."""

    def __init__(self, z):
        self._z, self._cache = z, {}
        self.files = z.files

    def __getitem__(self, key):
        if key not in self._cache:
            self._cache[key] = self._z[key]
        return self._cache[key]


def load(*names):
    """The golden (arrays read on first use), after checking its source
    hash and the init hashes of the trees `names` (the ones a test module
    uses)."""
    z = Golden(np.load(GOLDEN))
    assert str(z["source_hash"]) == source_hash(), (
        "tests/goldens/torch_family.npz is stale: the JAX package, a golden "
        "module or a library version changed; run "
        "`JAX_PLATFORMS=cpu python tests/torch_family_golden.py`")
    for name in names:
        assert str(z[f"init_hash/{name}"]) == init_hash(name), (
            f"the port's init of {name} changed; run the golden module again")
    return z


def sub(golden, prefix):
    """{rest: array} of the golden's keys under `prefix`."""
    return {k[len(prefix):]: golden[k] for k in golden.files
            if k.startswith(prefix)}


def source_hash() -> str:
    """sha256 over the JAX package's sources, this module and the golden
    module it builds on, the step's config and the library versions (read
    from the installed distributions, which costs no import)."""
    from importlib.metadata import version
    h = hashlib.sha256()
    here = Path(__file__).resolve().parent
    files = (sorted((ROOT / "unast_tpu").rglob("*.py"))
             + [Path(__file__), here / "torch_train_golden.py", G.CONFIG])
    for f in files:
        h.update(str(f.relative_to(ROOT)).encode())
        h.update(f.read_bytes())
    for lib in ("jax", "jaxlib", "optax", "numpy"):
        h.update(f"{lib} {version(lib)}".encode())
    return h.hexdigest()


def stack_loss(T, nn, p, x, pad, y, ypad, proj, moe: bool, form: str,
               impl: str = "xla"):
    """The stacks' loss, on either side (T, nn: the transformer module and
    nn package of the JAX package or of the port): encoder over (x, pad),
    decoder over (y, ypad) attending to it, in eval mode under `form`;
    sum(decoder output . proj) / 18 + the sum of the MoE aux losses."""
    scan, remat, policy = STACK_FORMS[form]
    ctx = nn.Ctx(aux_losses=[] if moe else None)
    kw = dict(scan_layers=scan, remat=remat, remat_policy=policy)
    m = T.encoder(p["encoder"], ctx, x, pad, H, 0.1, impl=impl,
                  moe_opts=STACK_MOE_OPTS["encoder"], **kw)
    o = T.decoder(p["decoder"], ctx, y, m, ypad, pad, H, 0.1, impl=impl,
                  moe_opts=STACK_MOE_OPTS["decoder"], **kw)
    loss = (o * proj).sum() / 18.0
    return loss + sum(ctx.aux_losses) if moe else loss


def freeze():
    """Run the JAX package on every case and write GOLDEN."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax
    from unast_tpu import nn
    from unast_tpu.audio.params import AudioParams
    from unast_tpu.infer.serve import Synthesizer
    from unast_tpu.models import TINY, conformer as C, ctc as CT, modules
    from unast_tpu.models import moe as MoE, transformer as T, unast as U
    from unast_tpu.train import losses as Ls
    from unast_tpu.train.config import parse_with_config
    from unast_tpu.train.optim import split_params
    from unast_tpu.train.steps import TrainState, make_optimizers, make_train_step
    from unast_tpu_torch.train.steps import ZERO_DROPOUTS, zero_fixed_dropouts

    J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    ectx = nn.Ctx.eval()
    out = {"source_hash": np.array(source_hash())}
    out.update({f"init_hash/{k}": np.array(init_hash(k)) for k in TREES})
    x, pad, y, ypad, proj = (jnp.asarray(a) for a in seq_case())

    # the conformer: one layer, the encoder in eval (both impls) and in
    # train mode (dropout 0: batch BN statistics and the new state)
    cp, cs = J(conformer_trees())
    bias = T.padding_bias(pad)
    out["conformer/layer"] = np.asarray(jax.jit(lambda p, s: C.conformer_layer(
        p, s, ectx, x, pad, bias, H, 0.1, CONF_KERNEL)[0])(
            cp["layers"][0], cs["layers"][0]))
    for impl in ("xla", "flash"):
        out[f"conformer/eval/{impl}"] = np.asarray(jax.jit(
            lambda p, s: C.conformer_encoder(p, s, ectx, x, pad, H, 0.1,
                                             CONF_KERNEL, impl=impl)[0])(cp, cs))
    tctx = nn.Ctx(rng=jax.random.PRNGKey(0), train=True)
    yt, st = jax.jit(lambda p, s: C.conformer_encoder(
        p, s, tctx, x, pad, H, 0.0, CONF_KERNEL))(cp, cs)
    out["conformer/train"] = np.asarray(yt)
    for k, v in flat(jax.device_get(st)).items():
        out[f"conformer/train_state/{k}"] = v

    # the MoE FFN: each routing case, the aux loss, the T == 1 dense path
    mp = J(moe_tree())
    for i, opts in enumerate(MOE_CASES):
        def f(p, opts=opts):
            ctx = nn.Ctx(aux_losses=[])
            o = MoE.moe_ffn(p, ctx, x, pad, 0.1, opts)
            return o, ctx.aux_losses[0]
        o, aux = jax.jit(f)(mp)
        out[f"moe/{i}/out"], out[f"moe/{i}/aux"] = np.asarray(o), np.asarray(aux)
    for k in (1, 2):
        out[f"moe/dense/{k}"] = np.asarray(jax.jit(lambda p, k=k: MoE.moe_ffn(
            p, ectx, x[:, :1], None, 0.1, (k,)))(mp))

    # the stacks: loss and gradient under every form; the gradient kept
    # whole for the unrolled form, and for the others as its largest
    # distance from the unrolled one
    for moe in (0, 2):
        p = J(stack_trees(moe))
        for form in STACK_FORMS:
            loss, g = jax.jit(jax.value_and_grad(lambda p, form=form: stack_loss(
                T, nn, p, x, pad, y, ypad, proj, moe > 0, form)))(p)
            out[f"stack{moe}/{form}/loss"] = np.asarray(loss)
            g = flat(jax.device_get(g))
            if form == "unrolled":
                for k, v in g.items():
                    out[f"stack{moe}/grad/{k}"] = v
            else:
                out[f"stack{moe}/{form}/grad_vs_unrolled"] = np.array(max(
                    float(np.abs(v - out[f"stack{moe}/grad/{k}"]).max())
                    for k, v in g.items()))

    # int8: the quantized trees, the quantized TTS forward, the Synthesizer
    mparams, mstate = J(model_trees())
    for name, tree in (("model", mparams), ("moe", mp)):
        for k, v in flat(jax.device_get(nn.quant.quantize_params(tree))).items():
            out[f"quant/{name}/{k}"] = v
    text, tl, mel, ml = (jnp.asarray(a) for a in tts_case())
    (pre, post, stop, _), _ = jax.jit(lambda p, s: U.tts(
        nn.quant.quantize_params(p), s, ectx, TINY, text, tl, mel, ml))(
            mparams, mstate)
    out["qtts/pre"], out["qtts/post"] = np.asarray(pre), np.asarray(post)
    out["qtts/stop"] = np.asarray(stop)
    sp_, ss_ = J(serve_trees())
    syn = Synthesizer(sp_, ss_, TINY, audio_params=AudioParams(n_iter=2),
                      quantize="int8", **SYN_KW)
    for i, m in enumerate(syn.tts_mels(TEXTS)):
        out[f"qsyn/tts_mels/{i}"] = np.asarray(m)
    for i, ids in enumerate(syn.asr_ids(asr_mels())):
        out[f"qsyn/asr_ids/{i}"] = np.asarray(ids)

    # the one-pass CTC ASR over a conformer
    ccfg = TINY.replace(**CONF_KW)
    kp, ks = J(ctc_trees())
    (ids, lens), _ = jax.jit(lambda p, s: CT.ctc_asr_infer(
        p, s, ectx, ccfg, mel, ml))(kp, ks)
    logits, _, _ = jax.jit(lambda p, s: CT.ctc_logits(
        p, s, ectx, ccfg, mel, ml))(kp, ks)
    out["ctc/ids"], out["ctc/lens"] = np.asarray(ids), np.asarray(lens)
    out["ctc/logits"] = np.asarray(logits)

    # the leftovers
    lg, tg = ce_case()
    for avg in (True, False):
        out[f"soft_ce/{int(avg)}"] = np.asarray(
            Ls.soft_cross_entropy(jnp.asarray(lg), jnp.asarray(tg), avg))
    out["mlp_disc"] = np.asarray(U.mlp_discriminator(J(mlp_tree()), ectx, x))
    out["num_params"] = np.array(U.num_params(mparams))
    out["num_params_step"] = np.array(U.num_params(J(model_trees(STEP_KW)[0])))

    # the joint step: conformer + MoE (2 experts, top-2, ragged), every
    # dropout at 0, train mode, from the weights of model_trees(STEP_KW)
    cfg = TINY.replace(**STEP_KW, **ZERO_DROPOUTS)
    args = parse_with_config(["--config", str(G.CONFIG), "--sp_steps", "2"])
    params, state = J(model_trees(STEP_KW))
    gen_tx, disc_tx = make_optimizers(cfg, args)
    gen_p, disc_p = split_params(params)
    ts = TrainState(params, state, gen_tx.init(gen_p), disc_tx.init(disc_p),
                    jnp.int32(0))

    def adam_mu(opt_state):
        return next(s.mu for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState))

    with zero_fixed_dropouts(modules, U):
        new, metrics = jax.jit(make_train_step(cfg, args))(
            ts, jax.random.PRNGKey(1), J(G.batches_np()))
    trees = {"metrics": dict(metrics), "params": new.params,
             "state": new.net_state, "gen_mu": adam_mu(new.gen_opt),
             "disc_mu": adam_mu(new.disc_opt)}
    for name, tree in trees.items():
        for k, v in G.flatten(jax.device_get(tree)).items():
            out[f"step/{name}/{k}"] = v

    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(ROOT))
    freeze()
