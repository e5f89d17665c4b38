"""The port's reference-checkpoint migration (unast_tpu_torch/compat/)
against the JAX package's (unast_tpu/compat/), which is numpy and runs
live here. The reference repository is absent, so the reference
state_dicts are synthetic: the JAX package's export_state_dict of JAX's
TINY transformer init (kept in tests/goldens/torch_serve.npz) and of the
RNN backbone with the LSTM discriminator under LSA and Luong attention
(tests/torch_rnn_golden.py's trees); for the CBHG vocoder, which the JAX
package imports but does not export, the port's export_vocoder_state_dict.
Every mapping must agree bit for bit."""

import numpy as np
import pytest
import torch

import torch_rnn_golden as RG
import torch_serve_golden as SG
from unast_tpu.compat import torch_export as JE, torch_import as JI
from unast_tpu_torch.bridge import params_from_jax
from unast_tpu_torch.compat import torch_export as TE, torch_import as TI
from unast_tpu_torch.models import ModelConfig, TINY, unast as U
from unast_tpu_torch.nn import quant as Q
from unast_tpu_torch.train.optim import tree_paths

CASES = ("transformer", "rnn_lsa", "rnn_luong")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_trees(case):
    """(params, state) numpy trees of the case as the JAX package has them."""
    if case == "transformer":
        z = np.load(SG.GOLDEN)
        return SG.models_np({k: z[k] for k in z.files})
    return RG.init_trees(case.split("_")[1])


def _flat(tree):
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in tree_paths(tree).items()}


def _equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys(), sorted(set(fa) ^ set(fb))[:8]
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k


@pytest.mark.parametrize("case", CASES)
def test_state_dict_mappings_match_jax(case):
    """The port's export_state_dict of the bridged trees gives the JAX
    package's state_dict of the same trees (keys, shapes, values); the
    port's import_state_dict of it gives the JAX package's import (and the
    original trees), bit for bit; the backbone and the attention flavour
    are read from the keys."""
    jp, js = _jax_trees(case)
    ref = JE.export_state_dict(jp, js)
    tp, ts = params_from_jax(jp, js)
    mine = TE.export_state_dict(tp, ts)
    assert mine.keys() == ref.keys()
    for k in ref:
        assert mine[k].dtype == ref[k].dtype and torch.equal(mine[k], ref[k]), k
    cfg = TINY.replace(model_type=case.split("_")[0])
    ip, is_ = TI.import_state_dict(ref, cfg)
    jip, jis = JI.import_state_dict(ref)
    _equal((ip, is_), (jip, jis))
    _equal((ip, is_), (tp, ts))
    if case != "transformer":
        assert "discriminator" in ip
    with pytest.raises(AssertionError, match="backbone"):
        TI.import_state_dict(ref, cfg.replace(
            model_type="rnn" if case == "transformer" else "transformer"))


def test_vocoder_mapping_matches_jax():
    """The CBHG vocoder: the port's import_vocoder_state_dict of the
    port's export_vocoder_state_dict gives back the trees and what the JAX
    package's import_vocoder_state_dict gives, bit for bit; trees the
    reference cannot hold (int8, MoE) refuse to export, as in JAX."""
    vp, vs = U.vocoder_init(torch.Generator().manual_seed(0), ModelConfig(hidden=8))
    sd = TE.export_vocoder_state_dict(vp, vs)
    _equal(TI.import_vocoder_state_dict(sd), (vp, vs))
    _equal(TI.import_vocoder_state_dict(sd), JI.import_vocoder_state_dict(sd))
    p, s = U.unast_init(torch.Generator().manual_seed(0), TINY)
    with pytest.raises(AssertionError, match="int8"):
        TE.export_state_dict(Q.quantize_params(p), s)
    moe, _ = U.unast_init(torch.Generator().manual_seed(0), TINY.replace(moe_experts=2))
    with pytest.raises(AssertionError, match="MoE"):
        TE.export_state_dict(moe, s)


def test_cli_round_trip(tmp_path):
    """python -m unast_tpu_torch.compat.torch_import on a reference
    checkpoint of configs/transformer_test.json's widths writes the port's
    checkpoint (its sidecar carries the epoch), and
    python -m unast_tpu_torch.compat.torch_export of that checkpoint gives
    the reference's state_dict back, bit for bit; --vocoder writes
    infer/vocoder.py's checkpoint, which loads back to the trees."""
    from unast_tpu_torch.infer.vocoder import load_vocoder_ckpt
    from unast_tpu_torch.train.config import model_config_from_args, train_args
    flags = ["--config", "configs/transformer_test.json", "--device", "cpu"]
    cfg = model_config_from_args(train_args("configs/transformer_test.json"))
    p, s = U.unast_init(torch.Generator().manual_seed(4), cfg)
    TE.export_checkpoint(p, s, str(tmp_path / "ref.ckpt"), epoch=3, best=0.5)
    TI.main([str(tmp_path / "ref.ckpt"), str(tmp_path / "ours"), *flags])
    ckpt = tmp_path / "ours" / "model_most_recent.ckpt"
    TE.main([str(ckpt), str(tmp_path / "back.ckpt"), *flags])
    ref = torch.load(tmp_path / "ref.ckpt", weights_only=False)
    back = torch.load(tmp_path / "back.ckpt", weights_only=False)
    assert (back["epoch"], back["valid_loss_min"]) == (3, 0.5)
    assert back["state_dict"].keys() == ref["state_dict"].keys()
    for k, v in ref["state_dict"].items():
        assert torch.equal(back["state_dict"][k], v), k
    vp, vs = U.vocoder_init(torch.Generator().manual_seed(1), ModelConfig(hidden=8))
    torch.save({"state_dict": TE.export_vocoder_state_dict(vp, vs)},
               tmp_path / "voc_ref.ckpt")
    TI.main([str(tmp_path / "voc_ref.ckpt"), str(tmp_path / "voc.ckpt"), "--vocoder"])
    _equal(load_vocoder_ckpt(str(tmp_path / "voc.ckpt"), device="cpu"), [vp, vs])
