"""The golden of the JAX package for tests/test_torch_sp_pp.py: its GPipe
schedule without a pp mesh, and its pipeline_encoder over a 2-device pp
mesh.

- `pp_step`: one joint step at TINY with pp = 2 (the stacks run as
  parallel/pipeline.py::gpipe_stack without a mesh, as the loop's --pp
  does; every dropout at 0, flash, the discriminator and guided
  attention) on tests/torch_parallel_golden.py's batches and weights. Its
  metrics, new params, BN state and both first Adam moments.
- `encoder`: tests/test_ops.py::test_pipeline_encoder_uneven_microbatches'
  case (d 16, 2 heads, ffn 32, 2 layers, pp 2, 4 micro-batches, B 8, T 7,
  5 valid frames) on the port's encoder_init (torch seed 7) and numpy
  inputs (seed 8): the output and the gradient of its sum in x.

Compiling the step takes minutes, so this module runs both once and keeps
them in tests/goldens/torch_sp_pp.npz with a hash of the JAX package's
sources, of this module, the modules it builds on, its config and the
library versions, and one of the weights; the test refuses a golden whose
hashes no longer match: then run this module again.

    JAX_PLATFORMS=cpu python tests/torch_sp_pp_golden.py
"""

import hashlib
import os
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
GOLDEN = HERE / "goldens" / "torch_sp_pp.npz"
ENC = dict(d=16, nhead=2, ffn=32, layers=2, pp=2, n_micro=4, b=8, t=7, valid=5)


def encoder_case():
    """(encoder params as torch tensors, x float32 [B, T, D], pad bool
    [B, T]) of the pipeline_encoder case."""
    import torch
    from unast_tpu_torch.models import transformer as T
    p = T.encoder_init(torch.Generator().manual_seed(7), ENC["d"], ENC["nhead"],
                       ENC["ffn"], ENC["layers"])
    rng = np.random.default_rng(8)
    x = rng.standard_normal((ENC["b"], ENC["t"], ENC["d"])).astype(np.float32)
    pad = np.arange(ENC["t"])[None, :] >= np.full((ENC["b"], 1), ENC["valid"])
    return p, x, pad


def _to_np(t):
    if isinstance(t, dict):
        return {k: _to_np(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_to_np(v) for v in t]
    return t.detach().numpy()


def source_hash() -> str:
    """sha256 over the JAX package's sources, this module, the golden
    modules it builds on, the config and the library versions."""
    import jax
    import jaxlib
    import optax
    import torch_parallel_golden as PG
    h = hashlib.sha256()
    files = (sorted((ROOT / "unast_tpu").rglob("*.py"))
             + [Path(__file__), HERE / "torch_parallel_golden.py",
                HERE / "torch_train_golden.py", PG.CONFIG])
    for f in files:
        h.update(str(f.relative_to(ROOT)).encode())
        h.update(f.read_bytes())
    for lib in (jax, jaxlib, optax, np):
        h.update(f"{lib.__name__} {lib.__version__}".encode())
    return h.hexdigest()


def weights_hash() -> str:
    """sha256 of both cases' weights (the port's inits)."""
    import torch_train_golden as G
    h = hashlib.sha256(G.init_hash(G.init_trees()[0]).encode())
    h.update(G.init_hash(_to_np(encoder_case()[0])).encode())
    return h.hexdigest()


def load():
    """The golden as a dict, after checking its hashes."""
    z = np.load(GOLDEN)
    assert str(z["source_hash"]) == source_hash(), (
        "tests/goldens/torch_sp_pp.npz is stale: the JAX package, "
        "tests/torch_sp_pp_golden.py, a module it builds on, its config or a "
        "library version changed; run `JAX_PLATFORMS=cpu python "
        "tests/torch_sp_pp_golden.py`")
    assert str(z["weights_hash"]) == weights_hash(), (
        "the port's inits changed; run the golden module again")
    return {k: z[k] for k in z.files}


def freeze():
    """Run both JAX cases and write GOLDEN."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax
    import torch_parallel_golden as PG
    import torch_train_golden as G
    from unast_tpu import nn as jnn
    from unast_tpu.models import TINY, modules, unast
    from unast_tpu.models import transformer as JT
    from unast_tpu.parallel.pipeline import (make_pp_mesh, pipeline_encoder,
                                             stack_for_pipeline)
    from unast_tpu.train.config import parse_with_config
    from unast_tpu.train.optim import split_params
    from unast_tpu.train.steps import TrainState, make_optimizers, make_train_step
    from unast_tpu_torch.train.steps import zero_fixed_dropouts

    def adam_mu(opt_state):
        return next(s.mu for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState))

    out = {"source_hash": np.array(source_hash()),
           "weights_hash": np.array(weights_hash())}
    # the one-process GPipe step
    batches = jax.tree_util.tree_map(jnp.asarray, PG.batches_np())
    cfg = TINY.replace(**PG.model_overrides(), pp=2)
    argv = ["--config", str(PG.CONFIG)]
    for k, v in PG.ARGS.items():
        argv += [f"--{k}", str(v)]
    args = parse_with_config(argv)
    params, state = jax.tree_util.tree_map(jnp.asarray, PG.init_trees())
    gen_tx, disc_tx = make_optimizers(cfg, args)
    gen_p, disc_p = split_params(params)
    ts = TrainState(params, state, gen_tx.init(gen_p), disc_tx.init(disc_p),
                    jnp.int32(0))
    with zero_fixed_dropouts(modules, unast):
        new, metrics = jax.jit(make_train_step(cfg, args))(
            ts, jax.random.PRNGKey(1), batches)
    trees = {"metrics": dict(metrics), "params": new.params,
             "state": new.net_state, "gen_mu": adam_mu(new.gen_opt),
             "disc_mu": adam_mu(new.disc_opt)}
    for name, tree in trees.items():
        for path, a in G.flatten(jax.device_get(tree)).items():
            out[f"pp_step/{name}/{path}"] = a
    print(f"pp step: grad_norm {float(metrics['grad_norm'])}", flush=True)
    # pipeline_encoder over a 2-device pp mesh
    p, x, pad = encoder_case()
    p = jax.tree_util.tree_map(jnp.asarray, _to_np(p))
    sp = stack_for_pipeline(p, ENC["pp"])
    mesh = make_pp_mesh(ENC["pp"])

    def run(x):
        return pipeline_encoder(sp, jnn.Ctx.eval(), x, jnp.asarray(pad),
                                ENC["nhead"], 0.0, mesh, ENC["n_micro"])

    out["encoder/out"] = np.asarray(run(jnp.asarray(x)))
    out["encoder/grad"] = np.asarray(jax.grad(lambda x: jnp.sum(run(x)))(
        jnp.asarray(x)))
    ref = JT.encoder(p, jnn.Ctx.eval(), jnp.asarray(x), jnp.asarray(pad),
                     ENC["nhead"], 0.0)
    print("encoder: staged - sequential",
          float(np.abs(out["encoder/out"] - np.asarray(ref)).max()), flush=True)
    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    import sys
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=2")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(HERE))
    freeze()
