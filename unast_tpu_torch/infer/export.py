"""Ahead-of-time serving export of the port, mirroring
`unast_tpu/infer/export.py`: the warm one-pass serving programs are traced
by torch.export into ExportedPrograms and saved, with a weights file, in
one .zip bundle, so a deployment host can load and run them WITHOUT the
model-building Python code.

JAX lowers its programs to StableHLO (jax.export), the Pallas flash kernel
included. Here each program is an ATen graph in which the flash forward is
one node, the registered operator unast::flash_attention_fwd
(ops/attention.py): loading a bundle imports that module, so the node runs
the hand-written kernel on a CUDA tensor. The manifest records the
operator's schema, and a bundle whose schema differs from this module's
(one exported before the operator returned lse beside o) is refused. Shapes are static per export
(the serving layer works on fixed buckets), so one bundle holds one
(batch, bucket) shape per function; export the buckets you serve. A
program runs on the device its example arguments were on.

Usage:
    from unast_tpu_torch.infer.export import export_bundle, load_bundle
    export_bundle(path, fns={"vocode": (fn, example_args)}, weights=params)
    b = load_bundle(path)
    wav = b.call("vocode", b.weights, mel)      # runs the exported program

The functions take the SAME positional arguments they were exported with
(weights first by convention here, so quantized int8 trees keep working:
the program is weight-free and one weights file can be swapped under a
fixed program, e.g. after fine-tuning), in the same tree structure.
"""

import io
import json
import zipfile

import torch

from .. import nn
from ..ops import attention  # registers unast::flash_attention_fwd


class _Program(torch.nn.Module):
    """A plain function as the nn.Module that torch.export traces."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_bundle(path: str, fns: dict, weights=None, platforms=None):
    """unast_tpu/infer/export.py::export_bundle: trace `fns` ({name:
    (callable, example_args_tuple)}) with torch.export at the example
    args' shapes and dtypes and write them, a manifest (the names, the
    torch version and the flash operator's schema) and an optional weights
    tree (a torch.save file that
    loads with weights_only=True) into one .zip bundle at `path`.
    `platforms` (jax.export's backends) has no torch meaning: only None is
    taken, anything else raises ValueError."""
    if platforms is not None:
        raise ValueError("platforms has no meaning for a torch.export "
                         "bundle: a program runs on its example args' device")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        names = []
        for name, (fn, example_args) in fns.items():
            with torch.no_grad():
                ep = torch.export.export(_Program(fn), tuple(example_args),
                                         strict=False)
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            z.writestr(f"fn/{name}.pt2", buf.getvalue())
            names.append(name)
        z.writestr("manifest.json", json.dumps(
            {"names": names, "torch_version": torch.__version__,
             "flash_schema": attention.FLASH_SCHEMA}))
        if weights is not None:
            buf = io.BytesIO()
            torch.save(nn.tree_to(weights, "cpu"), buf)
            z.writestr("weights.pt", buf.getvalue())
    return path


class Bundle:
    """unast_tpu/infer/export.py::Bundle: a loaded bundle. `call(name,
    *args)` runs the exported program; `weights` is the weights tree on
    the CPU (None if not shipped); `programs` the ExportedPrograms."""

    def __init__(self, programs: dict, weights, manifest: dict):
        self.programs = programs
        self.weights = weights
        self.manifest = manifest
        self._fns = {}

    def names(self):
        return sorted(self.programs)

    def call(self, name, *args):
        if name not in self._fns:
            self._fns[name] = self.programs[name].module()
        with torch.no_grad():
            return self._fns[name](*args)


def load_bundle(path: str) -> Bundle:
    """unast_tpu/infer/export.py::load_bundle: the programs, the manifest
    and the weights (loaded with weights_only=True) of a bundle. Raises
    ValueError, naming both schemas, for a bundle whose flash operator
    schema is not this module's or that records none."""
    programs, weights = {}, None
    with zipfile.ZipFile(path, "r") as z:
        manifest = json.loads(z.read("manifest.json"))
        schema = manifest.get("flash_schema")
        if schema != attention.FLASH_SCHEMA:
            raise ValueError(
                f"{path}: its programs were exported with the flash operator "
                f"unast::{schema or '(no schema recorded)'}, this port "
                f"registers unast::{attention.FLASH_SCHEMA}; export the "
                "bundle again")
        for name in manifest["names"]:
            programs[name] = torch.export.load(io.BytesIO(z.read(f"fn/{name}.pt2")))
        if "weights.pt" in z.namelist():
            weights = torch.load(io.BytesIO(z.read("weights.pt")),
                                 weights_only=True)
    return Bundle(programs, weights, manifest)


def export_synthesizer(syn, path: str, batch: int = 8, mel_bucket: int = None,
                       text_bucket: int = None, platforms=None):
    """unast_tpu/infer/export.py::export_synthesizer: export a Synthesizer's
    active one-pass serving programs at one (batch, bucket) shape, on its
    device: whichever of NAR text->mel ('nar_tts': (post, out_lens) of
    the FastSpeech student at max_mel_len frames), neural vocoding
    ('vocode': the MelGAN/HiFi-GAN generator over a float32 mel) and CTC
    ASR ('ctc_asr': (ids, lens) of the one-pass greedy decode) it is
    configured for. Weights ship as {"nar": pv, "melgan": params, "ctc":
    pv} (the Synthesizer's own trees), so a call is
    b.call("vocode", b.weights["melgan"], mel), the weights moved to the
    program's device first."""
    from ..models import ctc as CT
    from ..models import fastspeech as FS
    from ..models import melgan as MG
    cfg = syn.cfg
    dev = syn.device
    mel_bucket = mel_bucket or syn.mel_buckets[-1]
    text_bucket = text_bucket or syn.text_buckets[-1]
    fns, weights = {}, {}
    if syn.nar_pv is not None:
        ids = torch.zeros((batch, text_bucket), dtype=torch.long, device=dev)
        lens = torch.ones((batch,), dtype=torch.long, device=dev)

        def nar_tts(pv, ids, lens):
            p, s = pv
            (_, post, out_lens, _), _ = FS.fastspeech_forward(
                p, s, nn.Ctx.eval(), cfg, ids, lens, max_len=cfg.max_mel_len)
            return post, out_lens

        fns["nar_tts"] = (nar_tts, (syn.nar_pv, ids, lens))
        weights["nar"] = syn.nar_pv
    if syn.melgan_params is not None:
        mel = torch.zeros((batch, mel_bucket, cfg.num_mels), device=dev)
        fns["vocode"] = (lambda p, m: MG.generator_forward(p, m),
                         (syn.melgan_params, mel))
        weights["melgan"] = syn.melgan_params
    if syn.ctc_pv is not None:
        mel = torch.zeros((batch, mel_bucket, cfg.num_mels), device=dev)
        mlens = torch.ones((batch,), dtype=torch.long, device=dev)

        def ctc_asr(pv, mel, mel_len):
            p, s = pv
            (ids, lens), _ = CT.ctc_asr_infer(p, s, nn.Ctx.eval(), cfg, mel,
                                              mel_len)
            return ids, lens

        fns["ctc_asr"] = (ctc_asr, (syn.ctc_pv, mel, mlens))
        weights["ctc"] = syn.ctc_pv
    if not fns:
        raise ValueError("Synthesizer has no one-pass serving programs to "
                         "export (need nar_pv / melgan_params / ctc_pv)")
    return export_bundle(path, fns, weights=weights, platforms=platforms)
