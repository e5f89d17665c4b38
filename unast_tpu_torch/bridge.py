"""Bridge from the JAX package's parameter trees to the port's.

The port keeps the JAX tree's names and layouts (linear `w` [in, out], conv
`w` [k, in, out]), so the map is name for name. The caller hands the trees
over as numpy arrays (`np.asarray` of each leaf); the port never imports
JAX.
"""

import numpy as np
import torch

def _to_torch(tree):
    if isinstance(tree, dict):
        out = {k: _to_torch(v) for k, v in tree.items()}
        layers = out.get("layers")
        if isinstance(layers, dict):
            out["layers"] = _unstack(layers)
        return out
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _unstack(stacked):
    """A layer stack with a leading [L] axis on every leaf (the JAX
    package's transformer.py::_stack_layers, used by scan_layers) -> a list
    of L per-layer trees."""
    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        elif isinstance(t, list):
            for v in t:
                yield from leaves(v)
        else:
            yield t

    def take(t, i):
        if isinstance(t, dict):
            return {k: take(v, i) for k, v in t.items()}
        if isinstance(t, list):
            return [take(v, i) for v in t]
        return t[i].clone()

    n = next(leaves(stacked)).shape[0]
    return [take(stacked, i) for i in range(n)]


def params_from_jax(params, net_state):
    """JAX (params, net_state) trees of unast_tpu/models/unast.py::unast_init,
    leaves as numpy arrays -> the port's (params, net_state) of float32 torch
    tensors on the CPU, name for name: `text_m`, `speech_m` and, where the
    model has one, the LSTM `discriminator` (its cells, reduce_h / reduce_c
    and fc2); with ctc_weight > 0 the hybrid head `speech_m.ctc_head`. The RNN backbone's trees come across the same way: the
    encoder's `layers` and reduce_h / reduce_c, the decoder's `cells` list,
    `attn` and `proj`. A layer stack stacked over a leading axis is
    unstacked into a list."""
    return _to_torch(params), _to_torch(net_state)


def vocoder_from_jax(params, vstate):
    """JAX (params, state) of unast_tpu/models/unast.py::vocoder_init (or
    unast_tpu/infer/vocoder.py's checkpoint), leaves as numpy arrays -> the
    port's float32 torch trees on the CPU, name for name: `pre`, `post` and
    the CBHG's `bank` and `bn_bank` lists, proj1 / proj2 with their BNs,
    `highway` and the `gru` layers' fwd / bwd cells; the BN state's
    `bn_bank` list and bn_proj1 / bn_proj2."""
    return _to_torch(params), _to_torch(vstate)


def ctc_from_jax(params, net_state):
    """JAX (params, state) of unast_tpu/models/ctc.py::ctc_asr_init (or of
    unast_tpu/train/ctc.py's CtcTrainState), leaves as numpy arrays -> the
    port's float32 torch trees on the CPU, name for name: `prenet`,
    `encoder`, `ctc_head` and, for ctc_pos='rel', `rel_pos` [nhead, S]."""
    return _to_torch(params), _to_torch(net_state)


def fastspeech_from_jax(params, net_state):
    """JAX (params, state) of unast_tpu/models/fastspeech.py::fastspeech_init
    (or of unast_tpu/train/fastspeech.py's FSTrainState), leaves as numpy
    arrays -> the port's float32 torch trees on the CPU, name for name:
    `prenet`, `encoder`, `dur`, `decoder`, `postnet` (its frame-level
    `mel_proj`, no `stop_proj`) and, with nar_pitch / nar_energy, `pitch`,
    `pitch_proj`, `energy`, `energy_proj`; the state's prenet and postnet
    BatchNorm statistics."""
    return _to_torch(params), _to_torch(net_state)


def load_jax_nar_pickle(path: str):
    """The (params, net_state) of a file that unast_tpu/models/fastspeech.py::
    save_nar_pickle wrote (a pickle of numpy trees with its format stamp),
    read with pickle and numpy alone, as the port's torch trees; a stale
    stamp raises ValueError and an unversioned pair warns, as
    load_nar_pickle does."""
    import pickle

    from .models.fastspeech import check_nar_format
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return fastspeech_from_jax(*check_nar_format(obj, path))


def melgan_from_jax(params):
    """JAX params of unast_tpu/models/melgan.py (melgan_init, hifigan_init,
    discriminator_init, mpd_init or adv_disc_init), leaves as numpy arrays
    -> the port's float32 torch tree on the CPU, name for name, lists kept
    as lists: `pre`, `ups`, `res` (MelGAN) or `mrf` (HiFi-GAN), `post`; a
    discriminator's scales or periods of layers, under `msd` / `mpd`."""
    return _to_torch(params)
