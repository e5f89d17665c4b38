"""Rules of the port that hold for every module of unast_tpu_torch and for
its scripts chip_smoke.py and flash_ab.py: no import of JAX or of the JAX
package, no silent fallback to the CPU, no fallback from the kernel to its
plain version, and NotImplementedError for the options of later slices
(the options that earlier slices refused and later ones ported now run)."""

import ast
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from unast_tpu_torch import nn
from unast_tpu_torch.audio.params import AudioParams
from unast_tpu_torch.models import TINY, ModelConfig, unast as U
from unast_tpu_torch.infer.serve import Synthesizer
from unast_tpu_torch.ops import attention
from unast_tpu_torch.train import make_train_step
from unast_tpu_torch.train.config import train_args
from unast_tpu_torch.train.optim import tree_paths

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "unast_tpu_torch").rglob("*.py"))
              + [ROOT / "chip_smoke.py", ROOT / "flash_ab.py"])
FORBIDDEN = ("jax", "jaxlib", "unast_tpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("option", [{"mesh": object()}, {"quantize": "int8"}])
def test_unported_synthesizer_options_raise(option):
    params, state = U.unast_init(torch.Generator().manual_seed(0), TINY)
    with pytest.raises(NotImplementedError, match="slice"):
        Synthesizer(params, state, TINY, device="cpu", **option)


def _ctc_pv(cfg=TINY):
    from unast_tpu_torch.models.ctc import ctc_asr_init
    return ctc_asr_init(torch.Generator().manual_seed(1), cfg)


def _ported_option(option, cfg):
    """The Synthesizer keywords of a ported option, at `cfg`'s widths."""
    from unast_tpu_torch.models.fastspeech import fastspeech_init
    from unast_tpu_torch.models.melgan import generator_init
    gen = torch.Generator().manual_seed(1)
    if option == "vocoder_pv":
        return {"vocoder_pv": U.vocoder_init(gen, ModelConfig(hidden=8))}
    if option == "ctc_pv":
        return {"ctc_pv": _ctc_pv(cfg)}
    if option == "nar_pv":
        p, s = fastspeech_init(gen, cfg)
        p["dur"]["fc"]["b"] += 2.0   # some frames from the untrained student
        return {"nar_pv": (p, s)}
    if option == "melgan_params":
        return {"melgan_params": generator_init(gen, base=32)}
    if option == "melgan_chunk":
        return {"melgan_params": generator_init(gen, base=32), "melgan_chunk": 256}
    if option == "pcm16":
        return {"pcm16": True}
    return {}


@pytest.mark.parametrize("option", ["vocoder_pv", "model_type='rnn'", "ctc_pv",
                                    "nar_pv", "melgan_params", "melgan_chunk",
                                    "pcm16"])
def test_ported_synthesizer_options_run(option):
    """The CBHG vocoder, the RNN backbone, the CTC model, the FastSpeech
    student, the neural vocoder with and without chunking, and PCM16
    output, which raised before their slices, serve a request
    (tests/test_torch_vocoder.py, test_torch_rnn.py, test_torch_ctc.py,
    test_torch_fastspeech.py and test_torch_melgan.py hold them to JAX)."""
    cfg = TINY.replace(max_mel_len=8, model_type="rnn" if "rnn" in option else
                       "transformer")
    params, state = U.unast_init(torch.Generator().manual_seed(0), cfg)
    syn = Synthesizer(params, state, cfg, device="cpu", text_buckets=(8,),
                      mel_buckets=(8,), audio_params=AudioParams(n_iter=1),
                      **_ported_option(option, cfg))
    wav, = syn.tts(["ok"])
    assert wav.ndim == 1 and np.isfinite(wav).all()
    assert wav.dtype == (np.int16 if option == "pcm16" else np.float32)
    ids, = syn.asr_ids([np.zeros((5, 80), np.float32)])
    assert ids.ndim == 1


@pytest.mark.parametrize("option", [{"beam": 2}, {"ctc_beam": 2}, {"spec": True}])
def test_ported_asr_options_run(option):
    """beam, ctc_beam and spec, which raised before this slice, decode a
    request (tests/test_torch_ctc.py holds them to JAX); ctc_beam and spec
    without a CTC model raise ValueError, as in JAX."""
    params, state = U.unast_init(torch.Generator().manual_seed(0), TINY)
    mel = [np.random.default_rng(0).uniform(size=(9, 80)).astype(np.float32)]
    if "beam" not in option:
        with pytest.raises(ValueError, match="ctc_pv"):
            Synthesizer(params, state, TINY, device="cpu").asr_ids(mel, **option)
    syn = Synthesizer(params, state, TINY, ctc_pv=_ctc_pv(), device="cpu")
    ids, = syn.asr_ids(mel, **option)
    assert ids.ndim == 1 and len(ids) <= TINY.max_text_len


def test_rnn_beam_search_raises_value_error():
    """As in JAX, beam search needs the transformer backbone."""
    cfg = TINY.replace(model_type="rnn")
    params, state = U.unast_init(torch.Generator().manual_seed(0), cfg)
    syn = Synthesizer(params, state, cfg, device="cpu")
    with pytest.raises(ValueError, match="transformer backbone"):
        syn.asr_ids([torch.zeros(5, 80).numpy()], beam=2)


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
    ({"pp": 2}, {}, "pp"),
    ({"speech_encoder": "conformer"}, {}, "conformer"),
    ({"remat": True}, {}, "remat"),
    ({"scan_layers": True}, {}, "scan_layers"),
    ({"moe_experts": 4}, {}, "moe_experts"),
])
def test_unported_train_options_raise(cfg_kw, args_kw, match):
    cfg = TINY.replace(use_discriminator=True, **cfg_kw)
    with pytest.raises(NotImplementedError, match=match):
        make_train_step(cfg, train_args(**args_kw))


@pytest.mark.parametrize("objective,args_kw", [
    ("sp", {}), ("cm", {"cm_text_decode": "spec"}),
    ("cm", {"cm_text_decode": "ctc"})])
def test_ported_train_options_run(objective, args_kw):
    """ctc_weight > 0 and cm_text_decode 'spec' / 'ctc', which raised before
    this slice, make a train step and run their objective at TINY
    (tests/test_torch_ctc.py holds them to JAX): a finite loss, with the
    hybrid CTC loss among the sp objective's parts."""
    from unast_tpu_torch.train import steps as TS
    cfg = TINY.replace(ctc_weight=0.3)
    args = train_args(objective_eval_mode=True, **args_kw)
    make_train_step(cfg, args)
    params, state = U.unast_init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    batch = (torch.from_numpy(rng.integers(3, 46, (2, 6))),
             torch.rand(2, 12, 80), torch.tensor([6, 4]), torch.tensor([12, 9]))
    fn = TS.sp_loss_fn if objective == "sp" else TS.cm_loss_fn
    loss, (aux, _) = fn(params, state, None, batch, cfg, args, 1.0)
    assert torch.isfinite(loss)
    assert ("ctc_sp" in aux) == (objective == "sp")


@pytest.mark.parametrize("args_kw", [{"optim_type": "adafactor"},
                                     {"ema_decay": 0.999}])
def test_ported_optimizer_options_build(args_kw):
    """adafactor and ema_decay > 0, which raised before this slice, make a
    train step (tests/test_torch_loop.py holds them to optax)."""
    cfg = TINY.replace(use_discriminator=True)
    make_train_step(cfg, train_args(**args_kw))


def test_vocoder_options_run(tmp_path, monkeypatch):
    """vocode, synthesize_text(vocoder_pv=) and the server's --vocoder_ckpt,
    which raised before this slice, run (tests/test_torch_vocoder.py holds
    the first two to JAX): a .mag.npy becomes a wav, a text becomes a
    finite waveform, and the server hands the checkpoint's trees, equal to
    the saved ones, to Synthesizer.from_checkpoint (its HTTP loop
    stubbed)."""
    from unast_tpu_torch.infer import server, synthesize, vocoder
    cfg = TINY.replace(max_mel_len=8)
    params, state = U.unast_init(torch.Generator().manual_seed(0), cfg)
    vpv = U.vocoder_init(torch.Generator().manual_seed(1), ModelConfig(hidden=8))
    (tmp_path / "list.csv").write_text("u|hi|hi\n")
    np.save(tmp_path / "u.mag.npy", np.full((6, 1025), 0.5, np.float32))
    synthesize.vocode(str(tmp_path / "list.csv"), str(tmp_path), str(tmp_path / "o"),
                      params=AudioParams(n_iter=1), device="cpu")
    assert (tmp_path / "o" / "u.wav").stat().st_size > 44
    wav = synthesize.synthesize_text(params, state, cfg, "hi", vocoder_pv=vpv,
                                     audio_params=AudioParams(n_iter=1))
    assert wav.ndim == 1 and np.isfinite(wav).all()
    vocoder.save_vocoder_ckpt(*vpv, str(tmp_path / "v.ckpt"))
    seen = {}

    class Stub:
        def __init__(self, *a, **kw):
            pass

        def warmup(self):
            pass

        def serve_forever(self):
            pass

        def close(self):
            pass
    monkeypatch.setattr(server.Synthesizer, "from_checkpoint",
                        staticmethod(lambda path, args, **kw: seen.update(kw) or Stub()))
    monkeypatch.setattr(server, "DynamicBatcher", Stub)
    monkeypatch.setattr(server, "serve_http", lambda *a, **kw: Stub())
    server.main(["--vocoder_ckpt", str(tmp_path / "v.ckpt"), "--device", "cpu"])
    for loaded, saved in zip(seen["vocoder_pv"], vpv):
        a, b = tree_paths(loaded), tree_paths(saved)
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in b)


@pytest.mark.parametrize("module", ["fastspeech", "melgan"])
def test_one_pass_trainers_default_to_cuda(module):
    """python -m unast_tpu_torch.train.fastspeech and .train.melgan run on
    --device, 'cuda' by default, and raise on a host without a card."""
    import importlib
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    main = importlib.import_module(f"unast_tpu_torch.train.{module}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--synthetic", "--synthetic_size", "1"])


@pytest.mark.parametrize("text_decode", ["spec", "ctc"])
def test_ported_cm_text_decode_runs(text_decode):
    """cm_speech_in's 'spec' and 'ctc', which raised before this slice, make
    a pseudo-transcript (tests/test_torch_ctc.py holds them to JAX); they
    need ctc_weight > 0 (ValueError otherwise, as in JAX)."""
    mel = torch.rand((1, 8, 80))
    params, state = U.unast_init(torch.Generator().manual_seed(0), TINY)
    with pytest.raises(ValueError, match="ctc_weight"):
        U.cm_speech_in(params, state, nn.Ctx.eval(), TINY, mel,
                       torch.tensor([8]), text_decode=text_decode)
    cfg = TINY.replace(ctc_weight=0.3)
    params, state = U.unast_init(torch.Generator().manual_seed(0), cfg)
    (pre, _, _, _, t_len, _), _ = U.cm_speech_in(
        params, state, nn.Ctx.eval(), cfg, mel, torch.tensor([8]),
        ret_enc_hid=True, text_decode=text_decode)
    assert pre.shape == mel.shape and 1 <= int(t_len[0]) <= cfg.max_text_len
