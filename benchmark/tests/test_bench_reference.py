"""The plain reference against the port on the CPU at tiny sizes: the
weight trees have the port's structure, the phonemiser gives the port's
ids, and in float32 the port's warm-up step and one-pass TTS equal the
reference's (the same dropout masks drawn from the same generator)."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness import core, traffic as T
from benchmark.reference import model as RM
from benchmark.reference import serve as RS
from benchmark.tests import tiny


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shapes(tree):
    return [(p, tuple(x.shape)) for p, x in RM.leaves(tree)]


@pytest.mark.parametrize("config", ["flagship_d256", "tiny"])
def test_weight_trees_have_the_port_s_structure(config):
    from unast_tpu_torch.models import fastspeech as FS, melgan as MG
    from unast_tpu_torch.models.unast import unast_init
    from unast_tpu_torch.train.config import model_config_from_args, train_args

    path = os.path.join(tiny.BENCH, "configs", "flagship_d256.json")
    with open(path) as f:
        c = json.load(f)
    if config == "tiny":
        c.update(tiny.TINY_WIDTHS)
    args = train_args(path)
    for k, v in c.items():
        setattr(args, k, v)
    cfg = model_config_from_args(args).replace(use_discriminator=False)
    g = torch.Generator().manual_seed(0)
    p, s = unast_init(g, cfg)
    assert _shapes(RM.make_weights(RM.unast_spec(c), 0, "cpu")) == _shapes(p)
    assert _shapes(RM.unast_state(c)) == _shapes(s)
    p, s = FS.fastspeech_init(g, cfg)
    assert _shapes(RM.make_weights(RS.fastspeech_spec(c), 0, "cpu")) == _shapes(p)
    assert _shapes(RS.fastspeech_state(c)) == _shapes(s)
    assert (_shapes(RM.make_weights(RS.melgan_spec(80, 64), 0, "cpu"))
            == _shapes(MG.generator_init(g, "melgan", base=64)))


def test_weights_are_the_seed_s():
    c = dict(tiny.TINY_WIDTHS, **{k: v for k, v in json.load(open(os.path.join(
        tiny.BENCH, "configs", "flagship_d256.json"))).items()
        if k not in tiny.TINY_WIDTHS})
    a = RM.leaves(RM.make_weights(RM.unast_spec(c), 9, "cpu"))
    b = RM.leaves(RM.make_weights(RM.unast_spec(c), 9, "cpu"))
    d = RM.leaves(RM.make_weights(RM.unast_spec(c), 10, "cpu"))
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
    assert not all(torch.equal(x, y) for (_, x), (_, y) in zip(a, d))


def test_phonemiser_gives_the_port_s_ids():
    from unast_tpu_torch.text import raw_text_to_phoneme_ids
    with open(os.path.join(tiny.BENCH, "traffic", "nar_melgan_serve.json")) as f:
        t = json.load(f)
    lex = RS.load_lexicon(tiny.ROOT)
    for batch in T.texts(t, lex, 2 ** 35 + 7, 2):
        for text in batch:
            assert RS.phonemize(text, lex) == raw_text_to_phoneme_ids(text)


@pytest.mark.parametrize("cell,limits", [
    ("tiny.sp", {"loss_rel": 1e-6, "grad1_rel": 1e-5, "delta_rel": 1e-3}),
    ("tiny_remat.sp", {"loss_rel": 1e-6, "grad1_rel": 1e-5, "delta_rel": 1e-3}),
    ("tiny.tts", {"dur_gap": 0.0, "wav_rms_err": 1e-4, "trim_mismatch": 0})])
def test_the_port_in_float32_equals_the_reference(tmp_path, cell, limits):
    root = tiny.make_root(str(tmp_path), compute_dtype="float32")
    r = core.run(root, cell, 2 ** 32 + 17, 0.2, 0, device="cpu")
    for key, limit in limits.items():
        assert r["checks"][key]["value"] <= limit, (key, r["checks"])


def test_the_reference_imports_nothing_of_the_program_or_jax():
    import ast
    ref = os.path.join(tiny.BENCH, "reference")
    for name in os.listdir(ref):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ref, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not set(tops) & {"jax", "jaxlib", "flax", "unast_tpu",
                                    "unast_tpu_torch", "benchmark"}, (name, tops)
