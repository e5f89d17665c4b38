"""The harness on the CPU at tiny sizes: cells defined only by new files
in a temporary root are found and run, the result line has the keys the
contract names, `correct` holds for the port and comes out false for each
fault the cells can have, and the check for JAX finds what it must."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from benchmark.harness import core
from benchmark.tests import tiny

SEED = 2 ** 34 + 99


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell,trace", [("tiny.sp", 0), ("tiny.sp", 1),
                                        ("tiny_remat.sp", 0), ("tiny.tts", 0),
                                        ("tiny.tts", 1)])
def test_a_cell_of_new_files_runs_and_is_correct(root, cell, trace):
    r = core.run(root, cell, SEED, 0.3, trace, device="cpu")
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    m = core.Cell(root, cell)
    names = {x["name"] for x in (m.per_layer if trace else m.end_to_end)}
    assert set(r["metrics"]) <= names
    if not trace:
        assert {"setup_s", "peak_mem_gib"} <= set(r["metrics"])
    else:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert len(r["breakdown"]["idle_gaps"]) <= 10


def _broken_step(monkeypatch, fault):
    from unast_tpu_torch.train import steps
    inner = steps.make_train_step

    def make(*a, **kw):
        step = inner(*a, **kw)

        def broken(ts, gen, batches):
            if fault == "unchanged":
                _, m = step(ts, gen, batches)
                return ts, m
            return step(ts, gen, {k: tuple(x[:, :x.shape[1] // 2] for x in v)
                                  for k, v in batches.items()})
        return broken
    monkeypatch.setattr(steps, "make_train_step", make)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(root, monkeypatch, fault):
    _broken_step(monkeypatch, fault)
    r = core.run(root, "tiny.sp", SEED, 0.2, 0, device="cpu")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["sample", "duration"])
def test_an_altered_answer_is_not_correct(root, monkeypatch, fault):
    from unast_tpu_torch.infer import serve
    from unast_tpu_torch.models import fastspeech as FS
    if fault == "sample":
        inner = serve.Synthesizer.tts

        def tts(self, texts):
            wavs = inner(self, texts)
            return [w if i else -w for i, w in enumerate(wavs)]
        monkeypatch.setattr(serve.Synthesizer, "tts", tts)
    else:
        inner = FS.length_regulate

        def regulate(x, durations, max_len):
            d = durations.clone()
            d[0, 0] += 1
            return inner(x, d, max_len)
        monkeypatch.setattr(FS, "length_regulate", regulate)
    r = core.run(root, "tiny.tts", SEED, 0.2, 0, device="cpu")
    assert not r["correct"], r["checks"]


def test_the_jax_check_compares_whole_top_level_names(monkeypatch):
    assert core.forbidden_modules() == [] or "unast_tpu" not in sys.modules
    import unast_tpu_torch  # noqa: F401
    assert "unast_tpu_torch" not in core.forbidden_modules()
    for name in ("jaxlib.xla_client", "unast_tpu.models", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        assert name.split(".")[0] in core.forbidden_modules()
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("jaxtyping"))
    assert "jaxtyping" not in core.forbidden_modules()


def test_a_reader_that_loads_jax_fails_the_run(root, tmp_path, monkeypatch):
    # a stub 'jax' that a later per-layer reader imports: the check runs
    # after the readers, as the last step before the line is printed
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(stub))
    with open(os.path.join(root, "benchmark", "metrics",
                           "probe_jax.train.py"), "w") as f:
        f.write("import jax  # noqa: F401\n\n\ndef read(rec):\n"
                "    return 1.0\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        man = json.load(f)
    probe = {"name": "probe_jax.train", "unit": "%", "better": "higher",
             "source": "program_counter", "layer": "train step",
             "moves": "train_frames_per_s", "workloads": ["tiny.sp"]}
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    try:
        with open(path, "w") as f:
            json.dump(dict(man, per_layer=man["per_layer"] + [probe]), f)
        with pytest.raises(SystemExit) as e:
            core.run(root, "tiny.sp", SEED, 0.2, 1, device="cpu")
        assert e.value.code != 0
    finally:
        with open(path, "w") as f:
            json.dump(man, f)
        sys.modules.pop("jax", None)
