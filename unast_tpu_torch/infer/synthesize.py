"""Waveform synthesis of the port, mirroring `unast_tpu/infer/synthesize.py`:
write_wav (a PCM16 writer), vocode (Griffin-Lim of .mag.npy dumps, the
CLI below) and synthesize_text (text -> phonemes -> greedy TTS mel ->
magnitudes by the CBHG vocoder if given, else the mel pseudo-inverse lift
-> Griffin-Lim wav, on the params' device).

    python -m unast_tpu_torch.infer.synthesize --list_file x.csv \\
        --mels_dir d --out_dir o [--device cpu]
"""

import argparse
import os
import wave

import numpy as np
import torch

from ..audio import dsp, ref_dsp
from ..audio.params import DEFAULT
from ..data.dataset import load_manifest
from ..device import resolve_device


def write_wav(path: str, wav_data: np.ndarray, sr: int = 22050):
    """unast_tpu/infer/synthesize.py::write_wav: PCM16 mono WAV. Accepts
    float in [-1, 1] or already-quantized int16."""
    if wav_data.dtype == np.int16:
        pcm = wav_data
    else:
        pcm = (np.clip(wav_data, -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def vocode(list_file: str, mels_dir: str, out_dir: str, params=DEFAULT,
           device=None):
    """unast_tpu/infer/synthesize.py::vocode: per utterance of the manifest,
    <fid>.mag.npy -> mag_to_wav on `device` (None = cuda) -> <fid>.wav."""
    os.makedirs(out_dir, exist_ok=True)
    for fid, _ in load_manifest(list_file):
        mag = np.load(os.path.join(mels_dir, f"{fid}.mag.npy"))
        wav_data = dsp.mag_to_wav(mag, params, device=device)
        write_wav(os.path.join(out_dir, f"{fid}.wav"), wav_data, params.sr)


def synthesize_text(params_tree, state, cfg, text: str, vocoder_pv=None,
                    audio_params=DEFAULT) -> np.ndarray:
    """unast_tpu/infer/synthesize.py::synthesize_text: text -> phonemes ->
    greedy TTS mel -> magnitudes by the CBHG vocoder (vocoder_pv, its
    (params, state) on the same device, in the mel's dtype) or else the mel pseudo-inverse
    lift (clipped to [1e-8, 1]) -> Griffin-Lim waveform (np.float32) on
    the params' device, silence trimmed on the host."""
    from .. import nn
    from ..models import unast as U
    from ..text import raw_text_to_phoneme_ids
    from ..train.optim import tree_leaves

    dev = tree_leaves(params_tree)[0].device
    ids = torch.tensor([raw_text_to_phoneme_ids(text)], dtype=torch.long,
                       device=dev)
    with torch.inference_mode():
        (_, post, _, stop_lens), _ = U.tts(
            params_tree, state, nn.Ctx.eval(), cfg, ids,
            torch.tensor([ids.shape[1]], device=dev), infer=True)
        mel = post[:, :int(stop_lens[0])]
        if vocoder_pv is not None:
            mag, _ = U.vocoder(*vocoder_pv, nn.Ctx.eval(), mel)
        else:
            lift = torch.from_numpy(dsp.mel_to_mag_pseudo_inverse(audio_params)).to(dev)
            mag = torch.clamp(mel.float() @ lift, 1e-8, 1.0)
        wav = dsp._mag_to_wav_core(mag, audio_params)[0].cpu().numpy()
    return ref_dsp.trim_silence(wav, audio_params)[0]


def main(argv=None):
    """unast_tpu/infer/synthesize.py::main: vocode a manifest's dumps."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--list_file", required=True)
    ap.add_argument("--mels_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    vocode(args.list_file, args.mels_dir, args.out_dir,
           device=resolve_device(args.device))


if __name__ == "__main__":
    main()
