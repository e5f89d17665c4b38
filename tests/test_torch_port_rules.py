"""Rules of the port that hold for every module of unast_tpu_torch and for
its scripts chip_smoke.py and flash_ab.py: no import of JAX or of the JAX
package, no silent fallback to the CPU, and no fallback from the kernel to
its plain version."""

import ast
import inspect
from pathlib import Path

import pytest
import torch

from unast_tpu_torch.models import TINY, unast as U
from unast_tpu_torch.infer.serve import Synthesizer
from unast_tpu_torch.ops import attention

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "unast_tpu_torch").rglob("*.py"))
              + [ROOT / "chip_smoke.py", ROOT / "flash_ab.py"])
FORBIDDEN = ("jax", "jaxlib", "unast_tpu")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_synthesizer_without_device_needs_cuda():
    params, state = U.unast_init(torch.Generator().manual_seed(0), TINY)
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Synthesizer(params, state, TINY)


@pytest.mark.parametrize("option", [
    {"mesh": object()}, {"quantize": "int8"}, {"nar_pv": ({}, {})},
    {"melgan_params": {}}, {"ctc_pv": ({}, {})}, {"melgan_chunk": 256},
    {"vocoder_pv": ({}, {})}, {"pcm16": True}])
def test_unported_synthesizer_options_raise(option):
    params, state = U.unast_init(torch.Generator().manual_seed(0), TINY)
    with pytest.raises(NotImplementedError, match="slice"):
        Synthesizer(params, state, TINY, device="cpu", **option)


@pytest.mark.parametrize("option", [{"beam": 2}, {"ctc_beam": 2}, {"spec": True}])
def test_unported_asr_options_raise(option):
    params, state = U.unast_init(torch.Generator().manual_seed(0), TINY)
    syn = Synthesizer(params, state, TINY, device="cpu")
    with pytest.raises(NotImplementedError, match="slice"):
        syn.asr_ids([torch.zeros(5, 80).numpy()], **option)
    with pytest.raises(NotImplementedError, match="slice"):
        Synthesizer(params, state, TINY.replace(model_type="rnn"), device="cpu")


def test_flash_wrapper_never_falls_back_on_cuda():
    """The plain version is reached only under the `cpu` branch, and no
    `try` surrounds the launch."""
    tree = ast.parse(inspect.getsource(attention.flash_attention))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    fn = tree.body[0]
    plain_calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                   and getattr(n.func, "id", None) == "flash_attention_plain"]
    assert len(plain_calls) == 1
    first = fn.body[1]   # after the docstring
    assert isinstance(first, ast.If) and "cpu" in ast.unparse(first.test)
    assert plain_calls[0] in list(ast.walk(first))
    q = torch.empty((1, 4, 1, 16), device="meta")
    with pytest.raises(ValueError):
        attention.flash_attention(q, q, q)
