"""Import reference torch checkpoints into the port's param/state trees,
mirroring `unast_tpu/compat/torch_import.py`.

The reference saves `{'epoch', 'valid_loss_min', 'state_dict',
'optimizer'}` via torch.save (src/utils.py:139-163). This module maps the
`state_dict` keys directly into the port's functional trees, whose names
and layouts are the JAX package's (bridge.py maps those name for name), so
the mapping is the JAX package's, on torch tensors:

  - `Linear` wrapper -> `<p>.linear_layer.weight` [out, in]; plain
    nn.Linear -> `<p>.weight`. Ours is `{'w' [in, out], 'b'}`.
  - `Conv` wrapper -> `<p>.conv.weight` [out, in, k]; ours `w` [k, in, out].
  - nn.MultiheadAttention -> stacked `in_proj_weight` [3D, D] split into
    our q/k/v + out.
  - nn.LSTM -> `weight_ih_l{i}[_reverse]` etc.; ours
    `{'wi' [in, 4H], 'wh' [H, 4H], 'bi', 'bh'}` per direction.
  - BatchNorm1d weight/bias -> params {'scale','bias'};
    running_mean/var -> net_state {'mean','var'}.

Layer counts, bidirectionality, attention flavor, and the discriminator's
presence are all inferred from the keys, so one entry point covers every
reference config. Every leaf is a contiguous float32 CPU tensor.

CLI:  python -m unast_tpu_torch.compat.torch_import ref.ckpt out_dir \
          --config configs/transformer_d.json
writes the port's own checkpoint (train/checkpoint.py, a torch.save file
and its sidecar; JAX writes an Orbax directory there) that
`--load_path out_dir/model_most_recent.ckpt` resumes from (fresh
optimizer moments: the reference's torch Adam state is not portable);
with --vocoder, infer/vocoder.py's checkpoint file.
"""

import re

import torch


def _t(x):
    """A contiguous float32 CPU copy of a state_dict value (a tensor or an
    array)."""
    return torch.as_tensor(x).detach().to("cpu", torch.float32).contiguous()


class _SD:
    """state_dict accessor with wrapped/raw Linear+Conv fallbacks."""

    def __init__(self, sd):
        self.sd = {k: _t(v) for k, v in sd.items()}
        self.used = set()

    def has(self, key):
        return key in self.sd

    def get(self, key):
        self.used.add(key)
        return self.sd[key]

    def lin(self, prefix):
        """Reference Linear wrapper or plain nn.Linear -> {'w','b'?}."""
        for p in (f"{prefix}.linear_layer", prefix):
            if self.has(f"{p}.weight"):
                out = {"w": self.get(f"{p}.weight").t().contiguous()}
                if self.has(f"{p}.bias"):
                    out["b"] = self.get(f"{p}.bias")
                return out
        raise KeyError(f"no linear at {prefix}")

    def conv(self, prefix):
        """Reference Conv wrapper or plain nn.Conv1d -> {'w','b'?}."""
        for p in (f"{prefix}.conv", prefix):
            if self.has(f"{p}.weight"):
                out = {"w": self.get(f"{p}.weight").permute(2, 1, 0).contiguous()}
                if self.has(f"{p}.bias"):
                    out["b"] = self.get(f"{p}.bias")
                return out
        raise KeyError(f"no conv at {prefix}")

    def bn(self, prefix):
        """BatchNorm1d -> (params {'scale','bias'}, state {'mean','var'})."""
        self.used.add(f"{prefix}.num_batches_tracked")
        return ({"scale": self.get(f"{prefix}.weight"),
                 "bias": self.get(f"{prefix}.bias")},
                {"mean": self.get(f"{prefix}.running_mean"),
                 "var": self.get(f"{prefix}.running_var")})

    def mha(self, prefix):
        w = self.get(f"{prefix}.in_proj_weight")
        b = self.get(f"{prefix}.in_proj_bias")
        d = w.shape[1]
        return {
            "q": {"w": _t(w[:d].t()), "b": _t(b[:d])},
            "k": {"w": _t(w[d:2 * d].t()), "b": _t(b[d:2 * d])},
            "v": {"w": _t(w[2 * d:].t()), "b": _t(b[2 * d:])},
            "out": {"w": _t(self.get(f"{prefix}.out_proj.weight").t()),
                    "b": self.get(f"{prefix}.out_proj.bias")},
        }

    def lstm_cell(self, prefix, li, suffix=""):
        return {"wi": _t(self.get(f"{prefix}.weight_ih_l{li}{suffix}").t()),
                "wh": _t(self.get(f"{prefix}.weight_hh_l{li}{suffix}").t()),
                "bi": self.get(f"{prefix}.bias_ih_l{li}{suffix}"),
                "bh": self.get(f"{prefix}.bias_hh_l{li}{suffix}")}

    def lstm(self, prefix):
        """nn.LSTM -> [{'fwd': cell[, 'bwd': cell]}] (layer count and
        bidirectionality from the keys)."""
        layers = []
        li = 0
        while self.has(f"{prefix}.weight_ih_l{li}"):
            layer = {"fwd": self.lstm_cell(prefix, li)}
            if self.has(f"{prefix}.weight_ih_l{li}_reverse"):
                layer["bwd"] = self.lstm_cell(prefix, li, "_reverse")
            layers.append(layer)
            li += 1
        assert layers, f"no LSTM at {prefix}"
        return layers

    def count(self, pattern):
        """Number of distinct `{i}` matches for an f-pattern with one {}."""
        rx = re.compile("^" + re.escape(pattern).replace(r"\{\}", r"(\d+)"))
        return len({m.group(1) for k in self.sd if (m := rx.match(k))})


# ---------------------------------------------------------------------------
# Per-network assemblers (our param-tree layouts = models/*.py inits)
# ---------------------------------------------------------------------------


def _text_prenet(sd, m):
    p = {"embed": {"w": sd.get(f"{m}.prenet.embed.weight")}}
    bn_p, bn_s = {}, {}
    for i in (1, 2, 3):
        p[f"conv{i}"] = sd.conv(f"{m}.prenet.conv{i}")
        bn_p[f"bn{i}"], bn_s[f"bn{i}"] = sd.bn(f"{m}.prenet.batch_norm{i}")
    p["bn"] = bn_p
    return p, {"bn": bn_s}


def _speech_prenet(sd, m):
    return {"fc1": sd.lin(f"{m}.prenet.layer.fc1"),
            "fc2": sd.lin(f"{m}.prenet.layer.fc2")}


def _speech_postnet(sd, m):
    n = sd.count(f"{m}.postnet.conv_list.{{}}.")
    p = {"conv1": sd.conv(f"{m}.postnet.conv1"),
         "convs": [sd.conv(f"{m}.postnet.conv_list.{i}") for i in range(n)],
         "conv2": sd.conv(f"{m}.postnet.conv2"),
         "mel_proj": sd.lin(f"{m}.postnet.linear_project"),
         "stop_proj": sd.lin(f"{m}.postnet.stop_linear")}
    bn_p, bn_s = {}, {}
    bn_p["bn0"], bn_s["bn0"] = sd.bn(f"{m}.postnet.pre_batchnorm")
    for i in range(n):
        bn_p[f"bn{i + 1}"], bn_s[f"bn{i + 1}"] = sd.bn(
            f"{m}.postnet.batch_norm_list.{i}")
    p["bn"] = bn_p
    return p, {"bn": bn_s}


def _tr_layer(sd, prefix, is_decoder):
    p = {"lin1": sd.lin(f"{prefix}.linear1"),
         "lin2": sd.lin(f"{prefix}.linear2"),
         "ln1": _ln(sd, f"{prefix}.norm1"),
         "ln2": _ln(sd, f"{prefix}.norm2")}
    if is_decoder:
        p["self"] = sd.mha(f"{prefix}.self_attn")
        p["cross"] = sd.mha(f"{prefix}.multihead_attn")
        p["ln3"] = _ln(sd, f"{prefix}.norm3")
    else:
        p["attn"] = sd.mha(f"{prefix}.self_attn")
    return p


def _ln(sd, prefix):
    return {"scale": sd.get(f"{prefix}.weight"),
            "bias": sd.get(f"{prefix}.bias")}


def _tr_stack(sd, prefix, is_decoder):
    n = sd.count(f"{prefix}.layers.{{}}.")
    assert n, f"no transformer layers at {prefix}"
    return {"layers": [_tr_layer(sd, f"{prefix}.layers.{i}", is_decoder)
                       for i in range(n)]}


def _rnn_encoder(sd, m):
    p = {"layers": sd.lstm(f"{m}.encoder.rnn")}
    if sd.has(f"{m}.encoder.reduce_h_W.weight"):
        p["reduce_h"] = sd.lin(f"{m}.encoder.reduce_h_W")
        p["reduce_c"] = sd.lin(f"{m}.encoder.reduce_c_W")
    return p


def _rnn_decoder(sd, m):
    p = {"cells": [l["fwd"] for l in sd.lstm(f"{m}.decoder.rnn")]}
    att = f"{m}.decoder.attention_layer"
    if sd.has(f"{att}.location_layer.location_dense.linear_layer.weight"):
        p["attn"] = {
            "query": sd.lin(f"{att}.query_layer"),
            "memory": sd.lin(f"{att}.memory_layer"),
            "v": sd.lin(f"{att}.v"),
            "loc_conv": sd.conv(f"{att}.location_layer.location_conv"),
            "loc_dense": sd.lin(f"{att}.location_layer.location_dense"),
        }
    elif sd.has(f"{att}.project_hid.linear_layer.weight") or \
            sd.has(f"{att}.project_hid.weight"):
        p["attn"] = {"proj_hid": sd.lin(f"{att}.project_hid"),
                     "proj_eo": sd.lin(f"{att}.project_eo"),
                     "fc2": sd.lin(f"{att}.fc2")}
    if sd.has(f"{m}.decoder.linear_projection.linear_layer.weight"):
        p["proj"] = sd.lin(f"{m}.decoder.linear_projection")
    return p


def _gru_layers(sd, prefix):
    """nn.GRU (bidirectional) -> [{'fwd': cell, 'bwd': cell}]; torch gate
    order [r z n] matches nn.gru_cell."""
    layers = []
    li = 0
    while sd.has(f"{prefix}.weight_ih_l{li}"):
        layers.append({"fwd": sd.lstm_cell(prefix, li),
                       "bwd": sd.lstm_cell(prefix, li, "_reverse")})
        li += 1
    assert layers, f"no GRU at {prefix}"
    return layers


def import_vocoder_state_dict(state_dict):
    """unast_tpu/compat/torch_import.py::import_vocoder_state_dict: the
    reference Vocoder's (src/network.py:627-655, CBHG) state_dict ->
    (params, state) matching models/unast.py::vocoder_init.

    Note the reference CBHG hard-codes projection_size=256
    (src/module.py:541), so its Vocoder only runs with hidden_size=256
    (the first bank conv would reject any other input width); our
    parameterization (projection == hidden) covers exactly the runnable
    reference configs."""
    sd = _SD(state_dict)
    k_bank = sd.count("cbhg.convbank_list.{}.")
    bank = [sd.conv(f"cbhg.convbank_list.{i}") for i in range(k_bank)]
    assert bank[0]["w"].shape[1] == bank[0]["w"].shape[2], (
        "reference CBHG projection_size (256) != hidden_size; this "
        "checkpoint could not have run in the reference either")
    bn_bank_p, bn_bank_s = zip(*(sd.bn(f"cbhg.batchnorm_list.{i}")
                                 for i in range(k_bank)))
    p1, s1 = sd.bn("cbhg.batchnorm_proj_1")
    p2, s2 = sd.bn("cbhg.batchnorm_proj_2")
    n_hw = sd.count("cbhg.highway.linears.{}.")
    cbhg_p = {
        "bank": bank, "bn_bank": list(bn_bank_p),
        "proj1": sd.conv("cbhg.conv_projection_1"),
        "proj2": sd.conv("cbhg.conv_projection_2"),
        "bn_proj1": p1, "bn_proj2": p2,
        "highway": {
            "linears": [sd.lin(f"cbhg.highway.linears.{i}")
                        for i in range(n_hw)],
            "gates": [sd.lin(f"cbhg.highway.gates.{i}")
                      for i in range(n_hw)]},
        "gru": _gru_layers(sd, "cbhg.gru"),
    }
    params = {"pre": sd.conv("pre_projection"),
              "cbhg": cbhg_p,
              "post": sd.conv("post_projection")}
    state = {"cbhg": {"bn_bank": list(bn_bank_s),
                      "bn_proj1": s1, "bn_proj2": s2}}
    unused = set(sd.sd) - sd.used
    assert not unused, f"unmapped vocoder keys: {sorted(unused)[:8]}"
    return params, state


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def import_state_dict(state_dict, cfg=None):
    """unast_tpu/compat/torch_import.py::import_state_dict: the reference's
    `model.state_dict()` -> (params, net_state) trees of float32 CPU
    tensors matching models/unast.py::unast_init's structure. `cfg` is
    only used for a backbone cross-check (pass None to skip)."""
    sd = _SD(state_dict)
    is_tr = sd.has("text_m.encoder.transformer_encoder.layers.0"
                   ".self_attn.in_proj_weight")
    if cfg is not None:
        want = "transformer" if is_tr else "rnn"
        assert cfg.model_type == want, (
            f"checkpoint is a {want} backbone but cfg.model_type="
            f"{cfg.model_type}")

    t_prenet, t_bn_s = _text_prenet(sd, "text_m")
    s_post, s_bn_s = _speech_postnet(sd, "speech_m")
    if is_tr:
        def enc(m):
            return _tr_stack(sd, f"{m}.encoder.transformer_encoder", False)

        def dec(m):
            return _tr_stack(sd, f"{m}.decoder.transformer_decoder", True)
        sd.used.update(k for k in sd.sd if k.endswith("pos_emb.pe"))
    else:
        def enc(m):
            return _rnn_encoder(sd, m)

        def dec(m):
            return _rnn_decoder(sd, m)

    params = {
        "text_m": {"prenet": t_prenet, "encoder": enc("text_m"),
                   "decoder": dec("text_m"),
                   "postnet": {"fc": sd.lin("text_m.postnet.fc1")}},
        "speech_m": {"prenet": _speech_prenet(sd, "speech_m"),
                     "encoder": enc("speech_m"), "decoder": dec("speech_m"),
                     "postnet": s_post},
    }
    state = {"text_m": {"prenet": t_bn_s},
             "speech_m": {"postnet": s_bn_s}}

    if sd.has("discriminator.fc2.linear_layer.weight") or \
            sd.has("discriminator.fc2.weight"):
        rnn_p = {"layers": sd.lstm("discriminator.rnn.rnn")}
        if sd.has("discriminator.rnn.reduce_h_W.weight"):
            rnn_p["reduce_h"] = sd.lin("discriminator.rnn.reduce_h_W")
            rnn_p["reduce_c"] = sd.lin("discriminator.rnn.reduce_c_W")
        params["discriminator"] = {"rnn": rnn_p,
                                   "fc2": sd.lin("discriminator.fc2")}

    unused = set(sd.sd) - sd.used
    assert not unused, f"unmapped reference keys: {sorted(unused)[:8]}"
    return params, state


def load_reference_checkpoint(path, cfg=None):
    """unast_tpu/compat/torch_import.py::load_reference_checkpoint:
    torch.load a reference .ckpt (or bare state_dict) -> (params,
    net_state, epoch, valid_loss_min)."""
    blob = _load(path)
    if "state_dict" in blob:
        sd, epoch = blob["state_dict"], int(blob.get("epoch", 0))
        best = float(blob.get("valid_loss_min", float("inf")))
    else:
        sd, epoch, best = blob, 0, float("inf")
    params, state = import_state_dict(sd, cfg)
    return params, state, epoch, best


def _load(path):
    """A reference .ckpt: a pickled dict of tensors and numbers, whose
    optimizer slot may hold anything, so not weights_only."""
    return torch.load(path, map_location="cpu", weights_only=False)


def main(argv=None):
    """unast_tpu/compat/torch_import.py::main, writing the port's
    checkpoint (or, with --vocoder, infer/vocoder.py's file)."""
    import argparse
    from ..train.checkpoint import _restore, save_ckp
    from ..train.config import model_config_from_args, parse_with_config
    from ..train.steps import init_train_state

    ap = argparse.ArgumentParser(
        description="Import a reference torch UNAST checkpoint into a "
                    "unast_tpu_torch checkpoint")
    ap.add_argument("ckpt", help="reference model_*.ckpt (torch.save)")
    ap.add_argument("out", help="output checkpoint directory (or, with "
                               "--vocoder, output vocoder checkpoint path)")
    ap.add_argument("--vocoder", action="store_true",
                    help="the ckpt is a reference Vocoder (CBHG) "
                         "checkpoint; write infer/vocoder.py's checkpoint "
                         "instead of a model checkpoint")
    ap.add_argument("rest", nargs=argparse.REMAINDER,
                    help="config flags, e.g. --config configs/....json")
    ns = ap.parse_args(argv)
    if "--vocoder" in ns.rest:  # REMAINDER swallows flags after positionals
        ns.vocoder = True
        ns.rest.remove("--vocoder")
    if ns.vocoder:
        from ..infer.vocoder import save_vocoder_ckpt
        blob = _load(ns.ckpt)
        vp, vs = import_vocoder_state_dict(blob.get("state_dict", blob))
        save_vocoder_ckpt(vp, vs, ns.out)
        print(f"imported vocoder {ns.ckpt} -> {ns.out}")
        return
    args = parse_with_config(ns.rest)
    cfg = model_config_from_args(args)

    params, state, epoch, best = load_reference_checkpoint(ns.ckpt, cfg)
    ts = init_train_state(torch.Generator().manual_seed(0), cfg, args,
                          device="cpu")
    # the imported trees onto the config's (ValueError where they differ)
    ts = ts._replace(params=_restore(ts.params, params, "params"),
                     net_state=_restore(ts.net_state, state, "net_state"))
    save_ckp(epoch - 1, best, ts, is_best=False, checkpoint_path=ns.out)
    print(f"imported {ns.ckpt} (epoch {epoch}, best {best:.4f}) -> "
          f"{ns.out}/model_most_recent.ckpt")


if __name__ == "__main__":
    main()
