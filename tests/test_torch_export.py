"""The port's serving export (unast_tpu_torch/infer/export.py) against the
JAX package's (unast_tpu/infer/export.py), at TINY on the CPU: the
bundle round trip, the Synthesizer's three exported programs against
JAX's exported programs (tests/goldens/torch_export.npz,
tests/torch_export_golden.py), and the flash operator inside the
exported graphs."""

import os

import numpy as np
import pytest
import torch

import torch_export_golden as EG
from unast_tpu_torch.infer.export import (export_bundle, export_synthesizer,
                                          load_bundle)
from unast_tpu_torch.infer.serve import Synthesizer
from unast_tpu_torch.models import TINY
from unast_tpu_torch.models import melgan as G
from unast_tpu_torch.nn import quant as Q

FLASH = torch.ops.unast.flash_attention_fwd.default


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """The TINY Synthesizer of the golden case, exported at batch 2 and
    loaded back."""
    t = EG.trees()
    syn = Synthesizer(*t["ar"], TINY.replace(attn_impl="flash"), device="cpu",
                      nar_pv=t["nar"], melgan_params=t["melgan"], ctc_pv=t["ctc"],
                      **EG.SYN_KW)
    path = os.path.join(tmp_path_factory.mktemp("export"), "syn.zip")
    export_synthesizer(syn, path, batch=EG.BATCH)
    return syn, load_bundle(path)


def test_export_bundle_roundtrip(bundle, tmp_path):
    """tests/test_export.py::test_export_bundle_roundtrip for the port: a
    program and its weights exported with export_bundle (an int8-quantized
    linear, whose integer leaves survive the weights file), loaded, called
    with the shipped weights; the bundle's MelGAN program called with
    another generator's weights (the weights swap under the fixed program);
    `platforms` other than None refused."""
    from unast_tpu_torch import nn
    lin = {"w": torch.randn(8, 4), "b": torch.randn(4)}
    qlin = Q.quantize_params({"lin": lin})["lin"]
    x = torch.randn(3, 8)
    path = str(tmp_path / "b.zip")
    export_bundle(path, {"lin": (nn.linear, (qlin, x))}, weights=qlin)
    b = load_bundle(path)
    assert b.names() == ["lin"] and b.manifest["torch_version"] == torch.__version__
    assert b.weights["w_q"].dtype == torch.int8
    np.testing.assert_allclose(b.call("lin", b.weights, x).numpy(),
                               nn.linear(qlin, x).numpy(), rtol=1e-6)
    syn, b = bundle
    mel = torch.rand((EG.BATCH, 24, 80), generator=torch.Generator().manual_seed(1))
    p2 = G.generator_init(torch.Generator().manual_seed(7), base=32)
    got = b.call("vocode", b.weights["melgan"], mel).numpy()
    got2 = b.call("vocode", p2, mel).numpy()
    np.testing.assert_allclose(got2, G.generator_forward(p2, mel).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert not np.allclose(got, got2)
    with pytest.raises(ValueError, match="platforms"):
        export_bundle(path, {}, platforms=("cpu",))


def test_load_bundle_refuses_another_flash_schema(tmp_path):
    """The manifest records the flash operator's schema: a bundle from
    before the operator returned lse beside o (a manifest with no schema,
    or with the one-output schema) is refused with a ValueError naming
    both schemas; the bundle as written loads."""
    import json
    import zipfile

    from unast_tpu_torch import nn
    from unast_tpu_torch.ops import attention
    lin = {"w": torch.randn(8, 4), "b": torch.randn(4)}
    path = str(tmp_path / "b.zip")
    export_bundle(path, {"lin": (nn.linear, (lin, torch.randn(3, 8)))})
    assert load_bundle(path).manifest["flash_schema"] == attention.FLASH_SCHEMA
    with zipfile.ZipFile(path) as z:
        files = {n: z.read(n) for n in z.namelist()}
    old = attention.FLASH_SCHEMA.replace("-> (Tensor, Tensor)", "-> Tensor")
    for schema, named in ((None, "no schema recorded"), (old, old)):
        manifest = json.loads(files["manifest.json"])
        manifest.pop("flash_schema")
        if schema is not None:
            manifest["flash_schema"] = schema
        stale = str(tmp_path / "stale.zip")
        with zipfile.ZipFile(stale, "w") as z:
            for n, data in files.items():
                z.writestr(n, json.dumps(manifest) if n == "manifest.json" else data)
        with pytest.raises(ValueError) as e:
            load_bundle(stale)
        assert named in str(e.value) and attention.FLASH_SCHEMA in str(e.value)


def test_export_synthesizer_matches_jax(bundle):
    """export_synthesizer's nar_tts, ctc_asr and vocode, loaded back and
    called, against the JAX package's exported programs at the same
    weights (golden), with the tolerances of test_torch_fastspeech.py
    (mels 1e-5), test_torch_ctc.py (ids and lengths equal) and
    test_torch_melgan.py (waveforms 1e-5); and against the eager
    Synthesizer's programs on the same inputs, exactly."""
    syn, b = bundle
    golden = EG.load()
    assert b.names() == ["ctc_asr", "nar_tts", "vocode"]
    ids, lens, mel, mlens = (torch.from_numpy(x) for x in EG.inputs())
    post, out_lens = b.call("nar_tts", b.weights["nar"], ids, lens)
    np.testing.assert_allclose(post.numpy(), golden["post"], rtol=1e-5, atol=1e-5)
    assert out_lens.tolist() == golden["out_lens"].tolist()
    got_ids, got_lens = b.call("ctc_asr", b.weights["ctc"], mel, mlens)
    assert got_ids.tolist() == golden["ids"].tolist()
    assert got_lens.tolist() == golden["lens"].tolist()
    wav = b.call("vocode", b.weights["melgan"], mel)
    np.testing.assert_allclose(wav.numpy(), golden["wav"], rtol=0, atol=1e-5)
    e_post, e_lens = syn._nar_tts_impl(ids, lens)
    assert torch.equal(post, e_post) and torch.equal(out_lens, e_lens)
    assert all(torch.equal(a, c) for a, c in zip((got_ids, got_lens),
                                                   syn._ctc_asr_impl(mel, mlens)))
    assert torch.equal(wav, G.generator_forward(syn.melgan_params, mel))


def test_exported_graphs_hold_the_flash_operator(bundle):
    """The exported nar_tts holds one unast::flash_attention_fwd node per
    text-encoder and frame-decoder layer and ctc_asr one per encoder layer
    (TINY: 2 layers), the operator itself, not its plain decomposition (no
    softmax or einsum of it in the graph); vocode holds none; a
    Synthesizer without a one-pass program refuses to export."""
    _, b = bundle

    def ops(name):
        return [n.target for n in b.programs[name].graph.nodes
                if n.op == "call_function"]

    layers = TINY.num_layers
    assert ops("nar_tts").count(FLASH) == 2 * layers
    assert ops("ctc_asr").count(FLASH) == layers
    assert FLASH not in ops("vocode")
    for name in ("nar_tts", "ctc_asr"):
        names = {str(t) for t in ops(name)}
        assert not any("softmax" in t or "einsum" in t for t in names), names
    syn = Synthesizer(*EG.trees()["ar"], TINY, device="cpu")
    with pytest.raises(ValueError, match="one-pass"):
        export_synthesizer(syn, "unused.zip")
