"""Export the port's params back to the reference's torch checkpoint
format, mirroring `unast_tpu/compat/torch_export.py`.

The inverse of torch_import: builds a `state_dict` (key -> torch tensor)
with the reference's module layout (src/module.py / src/network.py naming,
src/utils.py:139-163 save format) from the port's functional param/state
trees, so models trained here can be loaded by the reference
implementation: two-way migration.

Layout inversions mirror torch_import exactly: our Linear 'w' [in, out] ->
`weight` [out, in]; Conv 'w' [k, in, out] -> [out, in, k]; q/k/v stacks ->
`in_proj_weight`; LSTM/GRU cells -> `weight_ih_l{i}[_reverse]`; BatchNorm
params+state -> weight/bias/running_mean/running_var (num_batches_tracked
is emitted as 0: the reference never reads it). Every tensor is a
contiguous float32 CPU tensor.
"""

import math

import torch


def _t(x):
    return torch.as_tensor(x).detach().to("cpu", torch.float32).contiguous()


class _Out:
    def __init__(self):
        self.sd = {}

    def raw(self, key, x):
        self.sd[key] = _t(x)

    def lin(self, prefix, p, wrapped=True):
        base = f"{prefix}.linear_layer" if wrapped else prefix
        self.raw(f"{base}.weight", _t(p["w"]).t())
        if "b" in p:
            self.raw(f"{base}.bias", p["b"])

    def conv(self, prefix, p, wrapped=True):
        base = f"{prefix}.conv" if wrapped else prefix
        self.raw(f"{base}.weight", _t(p["w"]).permute(2, 1, 0))
        if "b" in p:
            self.raw(f"{base}.bias", p["b"])

    def bn(self, prefix, p, s):
        self.raw(f"{prefix}.weight", p["scale"])
        self.raw(f"{prefix}.bias", p["bias"])
        self.raw(f"{prefix}.running_mean", s["mean"])
        self.raw(f"{prefix}.running_var", s["var"])
        self.sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    def mha(self, prefix, p):
        w = torch.cat([_t(p[k]["w"]).t() for k in ("q", "k", "v")])
        b = torch.cat([_t(p[k]["b"]) for k in ("q", "k", "v")])
        self.raw(f"{prefix}.in_proj_weight", w)
        self.raw(f"{prefix}.in_proj_bias", b)
        self.raw(f"{prefix}.out_proj.weight", _t(p["out"]["w"]).t())
        self.raw(f"{prefix}.out_proj.bias", p["out"]["b"])

    def ln(self, prefix, p):
        self.raw(f"{prefix}.weight", p["scale"])
        self.raw(f"{prefix}.bias", p["bias"])

    def cell(self, prefix, li, c, suffix=""):
        self.raw(f"{prefix}.weight_ih_l{li}{suffix}", _t(c["wi"]).t())
        self.raw(f"{prefix}.weight_hh_l{li}{suffix}", _t(c["wh"]).t())
        self.raw(f"{prefix}.bias_ih_l{li}{suffix}", c["bi"])
        self.raw(f"{prefix}.bias_hh_l{li}{suffix}", c["bh"])

    def rnn(self, prefix, layers):
        for li, layer in enumerate(layers):
            self.cell(prefix, li, layer["fwd"])
            if "bwd" in layer:
                self.cell(prefix, li, layer["bwd"], "_reverse")


def _pos_emb(out, m, d):
    """The reference registers the sinusoidal PE table as a buffer
    (src/module.py:249-267); recompute it so strict load_state_dict works."""
    pos = torch.arange(0, 5000, dtype=torch.float).unsqueeze(1)
    div = torch.exp(torch.arange(0, d, 2).float()
                    * (-math.log(10000.0) / d))
    pe = torch.zeros(5000, d)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    out.sd[f"{m}.pos_emb.pe"] = pe.unsqueeze(0)


def export_state_dict(params, net_state):
    """unast_tpu/compat/torch_export.py::export_state_dict: (params,
    net_state) -> the reference's `model.state_dict()` dict."""
    out = _Out()
    # extensions with no reference counterpart cannot round-trip:
    # int8-quantized trees (nn/quant.py), MoE FFNs (models/moe.py), and
    # reduction_factor > 1 head shapes (stop head wider than 1).
    def _scan(node):
        if isinstance(node, dict):
            assert not any(k.endswith("_q") for k in node), (
                "cannot export an int8-quantized tree to the reference "
                "format; export the original f32 checkpoint (quantization "
                "is serve-time)")
            assert "moe" not in node, (
                "cannot export a MoE model: the reference is dense-only")
            assert "conv_dw" not in node, (
                "cannot export a conformer speech encoder: the reference "
                "has only transformer/RNN encoders")
            assert "ctc_head" not in node, (
                "cannot export a hybrid-CTC model: the reference has no "
                "CTC head")
            for v in node.values():
                _scan(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                _scan(v)
    _scan(params)
    assert params["speech_m"]["postnet"]["stop_proj"]["w"].shape[-1] == 1, (
        "cannot export reduction_factor > 1 heads: the reference decodes "
        "one frame per step")
    is_tr = "layers" in params["text_m"]["encoder"] and \
        "attn" in params["text_m"]["encoder"]["layers"][0]

    for m in ("text_m", "speech_m"):
        p, s = params[m], net_state[m]
        if m == "text_m":
            out.raw(f"{m}.prenet.embed.weight", p["prenet"]["embed"]["w"])
            for i in (1, 2, 3):
                out.conv(f"{m}.prenet.conv{i}", p["prenet"][f"conv{i}"])
                out.bn(f"{m}.prenet.batch_norm{i}",
                       p["prenet"]["bn"][f"bn{i}"],
                       s["prenet"]["bn"][f"bn{i}"])
            out.lin(f"{m}.postnet.fc1", p["postnet"]["fc"], wrapped=False)
        else:
            out.lin(f"{m}.prenet.layer.fc1", p["prenet"]["fc1"])
            out.lin(f"{m}.prenet.layer.fc2", p["prenet"]["fc2"])
            pn, pbs = p["postnet"], s["postnet"]
            out.conv(f"{m}.postnet.conv1", pn["conv1"])
            for i, c in enumerate(pn["convs"]):
                out.conv(f"{m}.postnet.conv_list.{i}", c)
                out.bn(f"{m}.postnet.batch_norm_list.{i}",
                       pn["bn"][f"bn{i + 1}"], pbs["bn"][f"bn{i + 1}"])
            out.conv(f"{m}.postnet.conv2", pn["conv2"])
            out.bn(f"{m}.postnet.pre_batchnorm", pn["bn"]["bn0"],
                   pbs["bn"]["bn0"])
            out.lin(f"{m}.postnet.linear_project", pn["mel_proj"],
                    wrapped=False)
            out.lin(f"{m}.postnet.stop_linear", pn["stop_proj"],
                    wrapped=False)

        if is_tr:
            d = p["encoder"]["layers"][0]["lin1"]["w"].shape[0]
            _pos_emb(out, m, d)
            for which, stack, is_dec in (
                    ("encoder.transformer_encoder", p["encoder"], False),
                    ("decoder.transformer_decoder", p["decoder"], True)):
                for i, lp in enumerate(stack["layers"]):
                    pre = f"{m}.{which}.layers.{i}"
                    if is_dec:
                        out.mha(f"{pre}.self_attn", lp["self"])
                        out.mha(f"{pre}.multihead_attn", lp["cross"])
                        out.ln(f"{pre}.norm3", lp["ln3"])
                    else:
                        out.mha(f"{pre}.self_attn", lp["attn"])
                    out.lin(f"{pre}.linear1", lp["lin1"], wrapped=False)
                    out.lin(f"{pre}.linear2", lp["lin2"], wrapped=False)
                    out.ln(f"{pre}.norm1", lp["ln1"])
                    out.ln(f"{pre}.norm2", lp["ln2"])
        else:
            out.rnn(f"{m}.encoder.rnn", p["encoder"]["layers"])
            if "reduce_h" in p["encoder"]:
                out.lin(f"{m}.encoder.reduce_h_W", p["encoder"]["reduce_h"],
                        wrapped=False)
                out.lin(f"{m}.encoder.reduce_c_W", p["encoder"]["reduce_c"],
                        wrapped=False)
            dec = p["decoder"]
            for li, c in enumerate(dec["cells"]):
                out.cell(f"{m}.decoder.rnn", li, c)
            att = f"{m}.decoder.attention_layer"
            if "attn" in dec and "loc_dense" in dec["attn"]:
                out.lin(f"{att}.query_layer", dec["attn"]["query"])
                out.lin(f"{att}.memory_layer", dec["attn"]["memory"])
                out.lin(f"{att}.v", dec["attn"]["v"])
                out.conv(f"{att}.location_layer.location_conv",
                         dec["attn"]["loc_conv"])
                out.lin(f"{att}.location_layer.location_dense",
                        dec["attn"]["loc_dense"])
            elif "attn" in dec:
                out.lin(f"{att}.project_hid", dec["attn"]["proj_hid"])
                out.lin(f"{att}.project_eo", dec["attn"]["proj_eo"])
                out.lin(f"{att}.fc2", dec["attn"]["fc2"])
            if "proj" in dec:
                out.lin(f"{m}.decoder.linear_projection", dec["proj"])

    if "discriminator" in params:
        dp = params["discriminator"]
        out.rnn("discriminator.rnn.rnn", dp["rnn"]["layers"])
        if "reduce_h" in dp["rnn"]:
            out.lin("discriminator.rnn.reduce_h_W", dp["rnn"]["reduce_h"],
                    wrapped=False)
            out.lin("discriminator.rnn.reduce_c_W", dp["rnn"]["reduce_c"],
                    wrapped=False)
        out.lin("discriminator.fc2", dp["fc2"], wrapped=False)
    return out.sd


def export_vocoder_state_dict(params, state):
    """The inverse of torch_import.import_vocoder_state_dict (which the JAX
    package has without an inverse): the CBHG vocoder's (params, state) ->
    a state_dict with the keys that function reads, convs and linears in
    the reference's wrapped form (`.conv.weight`, `.linear_layer.weight`),
    so a vocoder trained here round-trips through the reference's key
    layout."""
    out = _Out()
    cb, cs = params["cbhg"], state["cbhg"]
    out.conv("pre_projection", params["pre"])
    for i, (c, bp, bs) in enumerate(zip(cb["bank"], cb["bn_bank"], cs["bn_bank"])):
        out.conv(f"cbhg.convbank_list.{i}", c)
        out.bn(f"cbhg.batchnorm_list.{i}", bp, bs)
    for i in (1, 2):
        out.conv(f"cbhg.conv_projection_{i}", cb[f"proj{i}"])
        out.bn(f"cbhg.batchnorm_proj_{i}", cb[f"bn_proj{i}"], cs[f"bn_proj{i}"])
    for i, (lin, gate) in enumerate(zip(cb["highway"]["linears"],
                                        cb["highway"]["gates"])):
        out.lin(f"cbhg.highway.linears.{i}", lin)
        out.lin(f"cbhg.highway.gates.{i}", gate)
    out.rnn("cbhg.gru", cb["gru"])
    out.conv("post_projection", params["post"])
    return out.sd


def export_checkpoint(params, net_state, path, epoch=0, best=float("inf")):
    """unast_tpu/compat/torch_export.py::export_checkpoint: torch.save in
    the reference's format (src/utils.py:139-163). The optimizer slot is
    left empty ({}): the port's Adam moments follow optax's chain, not
    torch.optim's; the reference's load_ckp only restores it when resuming
    training."""
    torch.save({"epoch": int(epoch), "valid_loss_min": float(best),
                "state_dict": export_state_dict(params, net_state),
                "optimizer": {}}, path)


def main(argv=None):
    """unast_tpu/compat/torch_export.py::main, reading the port's
    checkpoint (train/checkpoint.py)."""
    import argparse
    from ..train.checkpoint import load_ckp
    from ..train.config import model_config_from_args, parse_with_config
    from ..train.steps import init_train_state

    ap = argparse.ArgumentParser(
        description="Export a unast_tpu_torch checkpoint to the "
                    "reference's torch format")
    ap.add_argument("ckpt", help="our model_*.ckpt file (or save directory)")
    ap.add_argument("out", help="output .ckpt path (torch.save)")
    ap.add_argument("rest", nargs=argparse.REMAINDER)
    ns = ap.parse_args(argv)
    args = parse_with_config(ns.rest)
    cfg = model_config_from_args(args)
    template = init_train_state(torch.Generator().manual_seed(0), cfg, args,
                                device="cpu")
    epoch, best, ts, _ = load_ckp(ns.ckpt, template)
    export_checkpoint(ts.params, ts.net_state, ns.out, epoch, best)
    print(f"exported {ns.ckpt} -> {ns.out} (reference torch format)")


if __name__ == "__main__":
    main()
