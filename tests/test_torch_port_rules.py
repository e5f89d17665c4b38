"""Rules of the port that hold for every module of unast_tpu_torch and for
its scripts chip_smoke.py and flash_ab.py: no import of JAX or of the JAX
package, no silent fallback to the CPU, no fallback from the kernel to its
plain version, and NotImplementedError for the options of later slices."""

import ast
import inspect
from pathlib import Path

import pytest
import torch

from unast_tpu_torch import nn
from unast_tpu_torch.models import TINY, unast as U
from unast_tpu_torch.infer.serve import Synthesizer
from unast_tpu_torch.ops import attention
from unast_tpu_torch.train import make_train_step
from unast_tpu_torch.train.config import train_args

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


def _calls(tree):
    return [getattr(n.func, "id", None) or getattr(n.func, "attr", None)
            for n in ast.walk(tree) if isinstance(n, ast.Call)]


def test_flash_wrapper_never_falls_back_on_cuda():
    """flash_attention goes through its autograd.Function, whose forward is
    `_forward`, the code that chooses kernel or plain: the plain version is
    reached only under `_forward`'s `cpu` branch, and no `try` surrounds
    the launch."""
    trees = {fn: ast.parse(inspect.getsource(fn)) for fn in (
        attention.flash_attention, attention._FlashAttention, attention._forward)}
    for tree in trees.values():
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    assert "apply" in _calls(trees[attention.flash_attention])
    assert "_forward" in _calls(trees[attention._FlashAttention])
    for fn in (attention.flash_attention, attention._FlashAttention):
        assert "flash_attention_plain" not in _calls(trees[fn])
    fn = trees[attention._forward].body[0]
    plain_calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                   and getattr(n.func, "id", None) == "flash_attention_plain"]
    assert len(plain_calls) == 1
    first = fn.body[1]   # after the docstring
    assert isinstance(first, ast.If) and "cpu" in ast.unparse(first.test)
    assert plain_calls[0] in list(ast.walk(first))
    q = torch.empty((1, 4, 1, 16), device="meta")
    with pytest.raises(ValueError):
        attention.flash_attention(q, q, q)


@pytest.mark.parametrize("cfg_kw,args_kw,match", [
    ({"ctc_weight": 0.3}, {}, "ctc_weight"),
    ({"pp": 2}, {}, "pp"),
    ({"speech_encoder": "conformer"}, {}, "conformer"),
    ({}, {"cm_text_decode": "spec"}, "cm_text_decode"),
    ({}, {"cm_text_decode": "ctc"}, "cm_text_decode"),
    ({"remat": True}, {}, "remat"),
    ({"scan_layers": True}, {}, "scan_layers"),
    ({"moe_experts": 4}, {}, "moe_experts"),
])
def test_unported_train_options_raise(cfg_kw, args_kw, match):
    cfg = TINY.replace(use_discriminator=True, **cfg_kw)
    with pytest.raises(NotImplementedError, match=match):
        make_train_step(cfg, train_args(**args_kw))


@pytest.mark.parametrize("args_kw", [{"optim_type": "adafactor"},
                                     {"ema_decay": 0.999}])
def test_ported_optimizer_options_build(args_kw):
    """adafactor and ema_decay > 0, which raised before this slice, make a
    train step (tests/test_torch_loop.py holds them to optax)."""
    cfg = TINY.replace(use_discriminator=True)
    make_train_step(cfg, train_args(**args_kw))


def test_unported_vocoder_options_raise(tmp_path):
    from unast_tpu_torch.infer import server, synthesize
    params, state = U.unast_init(torch.Generator().manual_seed(0), TINY)
    with pytest.raises(NotImplementedError, match="vocoder slice"):
        synthesize.vocode("list.csv", str(tmp_path), str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="vocoder slice"):
        synthesize.synthesize_text(params, state, TINY, "hi", vocoder_pv=({}, {}))
    with pytest.raises(NotImplementedError, match="vocoder_ckpt"):
        server.main(["--vocoder_ckpt", "v.ckpt", "--device", "cpu"])


@pytest.mark.parametrize("text_decode", ["spec", "ctc"])
def test_unported_cm_text_decode_raises(text_decode):
    params, state = U.unast_init(torch.Generator().manual_seed(0), TINY)
    mel = torch.zeros((1, 8, 80))
    with pytest.raises(NotImplementedError, match="CTC head"):
        U.cm_speech_in(params, state, nn.Ctx.eval(), TINY, mel,
                       torch.tensor([8]), text_decode=text_decode)
