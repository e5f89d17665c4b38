"""The multi-objective train step of the port, mirroring
`unast_tpu/train/steps.py::make_train_step`.

Per outer step, ae_steps denoising-AE micro-batches, cm_steps
back-translation micro-batches and sp_steps supervised micro-batches add
their gradients (each loss scaled by 1 / accum_steps, summed in float32)
into ONE generator update, after which d_steps discriminator micro-batches
make one discriminator update on the updated generator's encodings. The
JAX lax.scan over stacked micro-batches is a Python loop that threads the
BatchNorm state; value_and_grad is torch.autograd.grad over the generator's
leaves; stop_gradient is torch.no_grad() (inside the task functions and
the discriminator objective).

Randomness: one torch.Generator, on the params' device, feeds every
dropout mask, the DAE noise, SpecAugment and the discriminator shuffle of
a step, in the order the ops run. It cannot reproduce JAX's threefry or
RBG bits, so the port matches JAX only where no draw reaches the result:
objective_eval_mode, or train mode with every drop probability and mask
at 0 (tests/test_torch_train.py checks both, and the draws' statistics).

Args are read with getattr and the JAX parser's defaults
(unast_tpu/train/config.py). `fast_prng` selects JAX's hardware RBG
generator; it has no meaning here and is not read.

Under torch.profiler a step shows its parts as record_function ranges:
'unast/train/<objective>' per objective's micro-batches, 'unast/train/
gen_update', 'unast/backward' per gradient pass, and, in the models and
ops, 'unast/text_infer', 'unast/speech_infer', 'unast/lstm_discriminator'
and 'unast/flash_attention_bwd'.
"""

import contextlib
import functools
from typing import Any, NamedTuple

import torch
from torch.profiler import record_function

from .. import nn
from ..models import ctc as CT
from ..models import modules as M
from ..models import networks as N
from ..models import unast as U
from ..models.config import ModelConfig
from ..parallel import collectives as C
from . import losses as L
from .augment import specaugment
from .optim import (ParamsEma, apply_updates, find_ema, global_norm,
                    make_optimizer, make_schedule, split_params, tree_leaves,
                    tree_map, tree_unflatten)


class TrainState(NamedTuple):
    """unast_tpu/train/steps.py::TrainState."""
    params: Any
    net_state: Any          # BatchNorm running statistics
    gen_opt: Any
    disc_opt: Any           # () when there is no discriminator
    step: int


# ModelConfig.replace keywords that set every drop probability and mask of
# the config to 0; with zero_fixed_dropouts, a step in train mode then
# draws nothing that reaches its result.
ZERO_DROPOUTS = dict(s_pre_drop=0.0, s_post_drop=0.0, t_pre_drop=0.0,
                     t_post_drop=0.0, e_drop=0.0, d_drop=0.0,
                     noise_mask_p=0.0, spec_freq_mask=0, spec_time_mask=0)


@contextlib.contextmanager
def zero_fixed_dropouts(modules=M, unast=U):
    """positional_encoding's dropout (0.1) and lstm_discriminator's (0.2)
    are fixed in code, not in the config: 0 for the `with` block, in the
    given models.modules and models.unast (the port's by default; the JAX
    package's have the same two functions)."""
    pe, disc = modules.positional_encoding, unast.lstm_discriminator
    modules.positional_encoding = functools.partial(pe, dropout_p=0.0)
    unast.lstm_discriminator = functools.partial(disc, dropout_p=0.0)
    try:
        yield
    finally:
        modules.positional_encoding, unast.lstm_discriminator = pe, disc


def flash_calls_per_step(cfg: ModelConfig, args, spec_rounds: int = 0,
                         rows: int = 0, staged: bool = False):
    """(flash-attention forwards, backwards) of one step of
    make_train_step with attn_impl='flash', per the task functions: per
    layer, an ae or sp micro-batch runs two encoders and two decoders'
    causal self-attention through flash (and both decoders'
    cross-attention too unless guided attention collects its weights,
    which needs attention_core), all with gradients, and with ctc_weight
    > 0 an sp micro-batch one more encoder (the CTC head's); a cm
    micro-batch four encoders (two of them no-grad, for the pseudo-pairs)
    and two decoders' self- and cross-attention, and with cm_text_decode
    'spec' a no-grad decoder's self- and cross-attention for each of the
    step's `spec_rounds` verify rounds (their count depends on the data:
    networks.text_tr_spec_infer.rounds); a d micro-batch two no-grad
    encoders. With MoE layers (cfg.moe_experts > 0) cm's pseudo-pair
    encoders keep their gradients (unast._pseudo_encode_grad), so each
    has a backward too, the conformer speech encoder's excepted. With
    cfg.remat every checkpointed layer with gradients runs its forward
    again in the backward: every attention with a backward call, except
    the decoders' of ae and sp under guided attention, which are not
    checkpointed (transformer.decoder). A conformer layer has one
    attention, as an encoder layer has. The RNN backbone calls no
    attention kernel: (0, 0).

    With cfg.pp > 1 the transformer stacks that pipeline (parallel/
    pipeline.py: not MoE, not the conformer, not a decoder returning its
    cross-attention weights) run each layer once per micro-batch (M:
    cfg.pp_micro, or default_micro of the `rows` each micro-batch of the
    step holds), all L layers in one process, or L / pp of them on a rank
    of a pp axis (`staged`); they are not rematerialised. Under sequence
    parallelism every rank runs every attention on its frames: the counts
    are the same."""
    if cfg.model_type != "transformer":
        return 0, 0
    ga = _ga_cfg(cfg, args)[0]
    conf = cfg.speech_encoder == "conformer"
    # the attentions a step runs per layer: encoder calls by side (text,
    # speech; with gradients: enc_g_*), decoder attentions that pipeline
    # and those that do not (under guided attention), the discriminator's
    # two encoders
    enc_t = args.ae_steps + args.sp_steps + 2 * args.cm_steps
    enc_s = args.ae_steps + args.sp_steps * (1 + (cfg.ctc_weight > 0)) + 2 * args.cm_steps
    enc_g_t = args.ae_steps + args.sp_steps + args.cm_steps
    enc_g_s = args.ae_steps + args.sp_steps * (1 + (cfg.ctc_weight > 0)) + args.cm_steps
    dec_pipe = (args.ae_steps + args.sp_steps) * (0 if ga else 4) + args.cm_steps * 4
    dec_plain = (args.ae_steps + args.sp_steps) * (2 if ga else 0)
    disc = 2 * args.d_steps if cfg.use_discriminator else 0
    fwd_pipe = enc_t + (0 if conf else enc_s) + dec_pipe + 2 * spec_rounds + (
        disc if not conf else disc // 2)
    fwd_plain = (enc_s if conf else 0) + dec_plain + (disc // 2 if conf else 0)
    bwd_pipe = enc_g_t + (0 if conf else enc_g_s) + dec_pipe
    bwd_plain = (enc_g_s if conf else 0) + dec_plain
    if cfg.moe_experts > 0:
        # cm's pseudo-pair encoders keep their gradients (the conformer's not)
        bwd_pipe += args.cm_steps * (1 + (not conf))
    L = cfg.num_layers
    if cfg.pp > 1 and cfg.moe_experts == 0:
        from ..parallel.pipeline import default_micro
        m = cfg.pp_micro or default_micro(rows, cfg.pp)
        lp = (L // cfg.pp if staged else L) * m
        remat = bwd_plain - (dec_plain if ga else 0) if cfg.remat else 0
        return (lp * fwd_pipe + L * (fwd_plain + remat),
                lp * bwd_pipe + L * bwd_plain)
    fwd, bwd = fwd_pipe + fwd_plain, bwd_pipe + bwd_plain
    if cfg.remat:
        fwd += bwd - (dec_plain if ga else 0)
    return L * fwd, L * bwd


def flash_calls_per_eval_batch(cfg: ModelConfig):
    """Flash-attention forwards of one infer/evaluate.py::eval_batch with
    attn_impl='flash' (none with gradients, so no backward), per layer:
    the four teacher-forced tasks (text_ae, speech_ae, tts, asr) one
    encoder and one decoder's self- and cross-attention each; the two cm
    tasks four each (their no-grad encoder before the greedy decode, whose
    KV-cached steps do not use flash, then one encoder and one decoder);
    the greedy ASR and TTS one encoder each; the discriminator's two
    encoders. The RNN backbone calls no attention kernel: 0."""
    if cfg.model_type != "transformer":
        return 0
    per_layer = 4 * 3 + 2 * 4 + 2 + (2 if cfg.use_discriminator else 0)
    return cfg.num_layers * per_layer


def make_optimizers(cfg: ModelConfig, args):
    """unast_tpu/train/steps.py::make_optimizers: (generator optimizer,
    discriminator optimizer) over one schedule. With ema_decay > 0 the
    generator's keeps an EMA of its params (optim.ParamsEma; ema_params
    reads it); the discriminator's does not, so that the adversary tracks
    the current generator."""
    sched = make_schedule(args)
    gen_tx = make_optimizer(args, sched)
    ema = float(getattr(args, "ema_decay", 0.0) or 0.0)
    if ema > 0.0:
        gen_tx = ParamsEma(gen_tx, ema)
    return gen_tx, make_optimizer(args, sched)


def ema_params(ts: TrainState):
    """unast_tpu/train/steps.py::ema_params: the full param tree with the
    generator partition replaced by its EMA, or None when ema_decay is
    off. The discriminator's params pass through."""
    ema = find_ema(ts.gen_opt)
    if ema is None:
        return None
    out = dict(ema)
    if "discriminator" in ts.params:
        out["discriminator"] = ts.params["discriminator"]
    return out


def train_state(params, net_state, cfg: ModelConfig, args) -> TrainState:
    """A TrainState at step 0 around given params and BN state, with fresh
    optimizer states."""
    gen_tx, disc_tx = make_optimizers(cfg, args)
    gen_params, disc_params = split_params(params)
    disc_opt = disc_tx.init(disc_params) if disc_params is not None else ()
    return TrainState(params, net_state, gen_tx.init(gen_params), disc_opt, 0)


def init_train_state(gen: torch.Generator, cfg: ModelConfig, args,
                     device=None) -> TrainState:
    """unast_tpu/train/steps.py::init_train_state: random weights from
    `gen` (a CPU generator), moved to `device` (the card unless the caller
    asks for another)."""
    from ..device import resolve_device
    dev = resolve_device(device)
    params, net_state = U.unast_init(gen, cfg)
    return train_state(nn.tree_to(params, dev), nn.tree_to(net_state, dev),
                       cfg, args)


# ---------------------------------------------------------------------------
# Discriminator batch assembly
# ---------------------------------------------------------------------------


def disc_shuffle_batch(gen, t_lat, t_len, s_lat, s_len,
                       train_discriminator: bool):
    """unast_tpu/train/steps.py::disc_shuffle_batch: zero-pad text and
    speech latents to one length, concatenate, smoothed targets (text 0.9,
    speech 0.1, flipped for generator phases), and shuffle the rows with a
    permutation drawn from `gen`."""
    s_max = max(t_lat.shape[1], s_lat.shape[1])
    pad = torch.nn.functional.pad
    t_lat = pad(t_lat, (0, 0, 0, s_max - t_lat.shape[1]))
    s_lat = pad(s_lat, (0, 0, 0, s_max - s_lat.shape[1]))
    d_hid = torch.cat([t_lat, s_lat], dim=0)
    d_len = torch.cat([t_len, s_len], dim=0)
    d_target = torch.cat([
        L.discriminator_target(t_lat.shape[0], "text", device=d_hid.device),
        L.discriminator_target(s_lat.shape[0], "speech", device=d_hid.device)])
    if not train_discriminator:
        d_target = 1.0 - d_target
    perm = torch.randperm(d_hid.shape[0], generator=gen, device=d_hid.device)
    return d_hid[perm], d_len[perm], d_target[perm]


def _disc_adv_loss(params, ctx, cfg, t_lat, t_len, s_lat, s_len):
    """unast_tpu/train/steps.py::_disc_adv_loss: the frozen discriminator's
    loss on flipped labels, for the generator phases; its gradient reaches
    the encoders through the latents."""
    d_hid, d_len, d_target = disc_shuffle_batch(
        ctx.next_rng(), t_lat, t_len, s_lat, s_len, train_discriminator=False)
    d_out = U.lstm_discriminator(params["discriminator"], ctx, d_hid, d_len)
    return L.discriminator_loss(d_out, d_target)


# ---------------------------------------------------------------------------
# Per-objective losses. Each returns (scaled loss, (aux, new_state)).
# ---------------------------------------------------------------------------


def _gold(batch):
    text, mel, text_len, mel_len = batch
    gold_stop = L.stop_label_from_lens(mel_len, mel.shape[1])
    return text, mel, text_len, mel_len, gold_stop


def seeded_generator(seed: int, index: int, device) -> torch.Generator:
    """A torch.Generator on `device` seeded from the pair (seed, index)
    (nn.fold_generator): the counterpart of
    jax.random.fold_in(PRNGKey(seed), index), by which the loop gives step
    `index` its draws, so a resumed run draws what an unbroken one would."""
    return nn.fold_generator(seed, index, device)


def _obj_ctx(gen, args, cfg: ModelConfig = None) -> nn.Ctx:
    """unast_tpu/train/steps.py::_obj_ctx: train mode (dropout, DAE noise,
    SpecAugment, batch BN statistics) unless args.objective_eval_mode; for
    an MoE config (cfg.moe_experts > 0) the ctx collects the layers'
    load-balance losses, which _moe_aux folds into the objective."""
    collect = cfg is not None and cfg.moe_experts > 0
    return nn.Ctx(generator=gen,
                  train=not getattr(args, "objective_eval_mode", False),
                  aux_losses=[] if collect else None)


def _moe_aux(ctx: nn.Ctx, args, aux: dict):
    """unast_tpu/train/steps.py::_moe_aux: moe_aux_weight (default 0.01)
    times the sum of the MoE load-balance losses collected on `ctx`, the
    raw sum recorded as aux 'moe'; 0 when none were collected."""
    if not ctx.aux_losses:
        return 0.0
    raw = sum(ctx.aux_losses)
    aux["moe"] = raw
    return float(getattr(args, "moe_aux_weight", 0.01) or 0.0) * raw


def _ga_cfg(cfg: ModelConfig, args):
    """unast_tpu/train/steps.py::_ga_cfg: guided attention (enabled, weight,
    sigma) on the teacher-forced cross-attention, transformer only."""
    w = float(getattr(args, "ga_weight", 0.0) or 0.0)
    enabled = w > 0.0 and cfg.model_type == "transformer"
    return enabled, w, float(getattr(args, "ga_sigma", 0.2) or 0.2)


def _ga_loss(ws, q_len, k_len, sigma):
    return L.guided_attention_loss(torch.stack(ws), q_len, k_len, sigma)


def ae_loss_fn(params, net_state, gen, batch, cfg: ModelConfig, args, scale):
    """unast_tpu/train/steps.py::ae_loss_fn, the denoising AE objective."""
    text, mel, text_len, mel_len, gold_stop = _gold(batch)
    ctx = _obj_ctx(gen, args, cfg)
    ga_on, ga_w, ga_sigma = _ga_cfg(cfg, args)
    t_ws = [] if ga_on else None
    s_ws = [] if ga_on else None
    aux = {}
    if cfg.use_discriminator:
        (logits, t_lat, t_l, _), st = U.text_ae(params, net_state, ctx, cfg,
                                                text, text_len, ret_enc_hid=True,
                                                cross_weights_out=t_ws)
        (pre, post, stop, s_lat, s_l, _), st = U.speech_ae(
            params, st, ctx, cfg, mel, mel_len, ret_enc_hid=True,
            cross_weights_out=s_ws)
        d_loss = _disc_adv_loss(params, ctx, cfg, t_lat, t_l, s_lat, s_l)
        aux["d_ae"] = d_loss
    else:
        logits, st = U.text_ae(params, net_state, ctx, cfg, text, text_len,
                               cross_weights_out=t_ws)
        (pre, post, stop), st = U.speech_ae(params, st, ctx, cfg, mel, mel_len,
                                            cross_weights_out=s_ws)
        d_loss = 0.0
    t_ae = L.text_loss(text, logits, args.t_eos_weight)
    s_ae = L.speech_loss(mel, gold_stop, pre, post, mel_len, stop,
                         args.s_eos_weight)
    ga = 0.0
    if ga_on:
        # speech-decoder queries are frame groups under reduction_factor
        s_q = -(-mel_len // cfg.reduction_factor)
        ga = ga_w * (_ga_loss(t_ws, text_len, text_len, ga_sigma)
                     + _ga_loss(s_ws, s_q, mel_len, ga_sigma))
        aux["ga_ae"] = ga
    moe = _moe_aux(ctx, args, aux)
    aux.update(t_ae=t_ae, s_ae=s_ae)
    return (t_ae + s_ae + d_loss + ga + moe) * scale, (aux, st)


def sp_loss_fn(params, net_state, gen, batch, cfg: ModelConfig, args, scale):
    """unast_tpu/train/steps.py::sp_loss_fn, the supervised objective with
    SpecAugment on the ASR input; with cfg.ctc_weight > 0 the hybrid
    CTC/attention loss on the speech encoder's output (aux 'ctc_sp')."""
    text, mel, text_len, mel_len, gold_stop = _gold(batch)
    ctx = _obj_ctx(gen, args, cfg)
    ga_on, ga_w, ga_sigma = _ga_cfg(cfg, args)
    tts_ws = [] if ga_on else None
    asr_ws = [] if ga_on else None
    mel_aug = (mel if not ctx.train else
               specaugment(ctx.next_rng(), mel, mel_len,
                           cfg.spec_freq_mask, cfg.spec_time_mask))
    aux = {}
    if cfg.use_discriminator:
        (pre, post, stop, _, t_lat), st = U.tts(params, net_state, ctx, cfg,
                                                text, text_len, mel, mel_len,
                                                ret_enc_hid=True,
                                                cross_weights_out=tts_ws)
        (logits, s_lat), st = U.asr(params, st, ctx, cfg, text, text_len,
                                    mel_aug, mel_len, ret_enc_hid=True,
                                    cross_weights_out=asr_ws)
        d_loss = _disc_adv_loss(params, ctx, cfg, t_lat, text_len, s_lat,
                                mel_len)
        aux["d_sp"] = d_loss
    else:
        (pre, post, stop, _), st = U.tts(params, net_state, ctx, cfg,
                                         text, text_len, mel, mel_len,
                                         cross_weights_out=tts_ws)
        logits, st = U.asr(params, st, ctx, cfg, text, text_len,
                           mel_aug, mel_len, cross_weights_out=asr_ws)
        d_loss = 0.0
    tts_l = L.speech_loss(mel, gold_stop, pre, post, mel_len, stop,
                          args.s_eos_weight)
    asr_l = L.text_loss(text, logits, args.t_eos_weight)
    ga = 0.0
    if ga_on:
        # tts: queries are mel frame groups, keys the text; asr the mirror
        s_q = -(-mel_len // cfg.reduction_factor)
        ga = ga_w * (_ga_loss(tts_ws, s_q, text_len, ga_sigma)
                     + _ga_loss(asr_ws, text_len, mel_len, ga_sigma))
        aux["ga_sp"] = ga
    ctc = 0.0
    if cfg.ctc_weight > 0:
        # hybrid CTC/attention: the CTC loss on the speech-encoder output
        # over the gold transcript; the re-encode's BN state is discarded
        # (U.asr threaded it once), as in JAX
        (mem, pad), _ = N.speech_encode(
            params["speech_m"], st["speech_m"], ctx, cfg, mel_aug, mel_len)
        ctc_logits = nn.linear(params["speech_m"]["ctc_head"], mem).float()
        ctc = cfg.ctc_weight * CT.ctc_loss(ctc_logits, pad, text, text_len)
        aux["ctc_sp"] = ctc
    moe = _moe_aux(ctx, args, aux)
    aux.update(tts=tts_l, asr=asr_l)
    return (tts_l + asr_l + d_loss + ga + moe + ctc) * scale, (aux, st)


def cm_loss_fn(params, net_state, gen, batch, cfg: ModelConfig, args, scale):
    """unast_tpu/train/steps.py::cm_loss_fn, the back-translation objective:
    the greedy pseudo-pair decodes run inside the step, without grad."""
    text, mel, text_len, mel_len, gold_stop = _gold(batch)
    ctx = _obj_ctx(gen, args, cfg)
    infer_mel = getattr(args, "cm_infer_mel_len", None) or cfg.max_mel_len
    infer_text = getattr(args, "cm_infer_text_len", None) or cfg.max_text_len
    td = getattr(args, "cm_text_decode", "ar") or "ar"
    aux = {}
    if cfg.use_discriminator:
        (pre, post, stop, t_lat, t_l, _), st = U.cm_speech_in(
            params, net_state, ctx, cfg, mel, mel_len, ret_enc_hid=True,
            infer_text_len=infer_text, text_decode=td)
        (logits, s_lat, s_l, _), st = U.cm_text_in(
            params, st, ctx, cfg, text, text_len, ret_enc_hid=True,
            infer_mel_len=infer_mel)
        d_loss = _disc_adv_loss(params, ctx, cfg, t_lat, t_l, s_lat, s_l)
        aux["d_cm"] = d_loss
    else:
        (pre, post, stop), st = U.cm_speech_in(
            params, net_state, ctx, cfg, mel, mel_len,
            infer_text_len=infer_text, text_decode=td)
        logits, st = U.cm_text_in(params, st, ctx, cfg, text, text_len,
                                  infer_mel_len=infer_mel)
        d_loss = 0.0
    s_cm = L.speech_loss(mel, gold_stop, pre, post, mel_len, stop,
                         args.s_eos_weight)
    t_cm = L.text_loss(text, logits, args.t_eos_weight)
    moe = _moe_aux(ctx, args, aux)
    aux.update(s_cm=s_cm, t_cm=t_cm)
    return (s_cm + t_cm + d_loss + moe) * scale, (aux, st)


def disc_loss_fn(disc_params, gen_params, net_state, gen, batch,
                 cfg: ModelConfig, args, scale):
    """unast_tpu/train/steps.py::disc_loss_fn: the discriminator objective
    on detached encodings with the true labels. The encodes' BN state is
    discarded."""
    text, mel, text_len, mel_len, _ = _gold(batch)
    ctx = _obj_ctx(gen, args)
    with torch.no_grad():
        (t_enc, _), _ = N.text_encode(gen_params["text_m"], net_state["text_m"],
                                      ctx, cfg, text, text_len)
        (s_enc, _), _ = N.speech_encode(gen_params["speech_m"],
                                        net_state["speech_m"], ctx, cfg,
                                        mel, mel_len)
    t_lat, s_lat = U._latent(t_enc, cfg), U._latent(s_enc, cfg)
    d_hid, d_len, d_target = disc_shuffle_batch(
        ctx.next_rng(), t_lat, text_len, s_lat, mel_len,
        train_discriminator=True)
    d_out = U.lstm_discriminator(disc_params, ctx, d_hid, d_len)
    d_loss = L.discriminator_loss(d_out, d_target)
    return d_loss * scale, {"d": d_loss}


# ---------------------------------------------------------------------------
# Gradient accumulation over stacked micro-batches
# ---------------------------------------------------------------------------


def _accumulate(loss_fn, params, wrt, net_state, gen, stacked_batches):
    """unast_tpu/train/steps.py::_accumulate: loss_fn(params, state, gen,
    micro-batch) over the leading micro-batch axis of stacked_batches,
    summing the float32 gradients with respect to the leaves `wrt` and
    threading the BatchNorm state. Returns (grads in wrt's order,
    new_state, {name: [n] stacked aux}). Under a sequence-parallel axis
    every loss is computed on whole sequences, the same on each sp rank
    (models/networks.py gathers the outputs), so each rank differentiates
    1/sp of it: the gradients summed over dp x sp are then the global
    batch's."""
    grads = [torch.zeros_like(x, dtype=torch.float32) for x in wrt]
    auxs = []
    st = net_state
    share = 1.0 / C.axis_size("sp")
    for i in range(stacked_batches[0].shape[0]):
        batch = tuple(x[i] for x in stacked_batches)
        loss, (aux, st) = loss_fn(params, st, gen, batch)
        if share != 1.0:
            loss = loss * share
        with record_function("unast/backward"):
            for acc, g in zip(grads, torch.autograd.grad(loss, wrt,
                                                         allow_unused=True)):
                if g is not None:
                    acc += g.float()
        auxs.append({k: v.detach() for k, v in aux.items()})
    return grads, st, {k: torch.stack([a[k] for a in auxs]) for k in auxs[0]}


def make_train_step(cfg: ModelConfig, args, plan=None):
    """unast_tpu/train/steps.py::make_train_step: train_step(ts, gen,
    batches) -> (new ts, metrics).

    `batches` maps 'ae', 'cm', 'sp' and, with cfg.use_discriminator, 'd'
    to stacked micro-batches (text [n, B, Tt] int, mel [n, B, Tm,
    num_mels], text_len [n, B], mel_len [n, B]) on the params' device;
    `gen` is a torch.Generator there. Metrics carry JAX's names
    ('ae/t_ae', ..., 'grad_norm', 'd/d'), each the mean over the
    micro-batches; 'param_sum' with args.param_sum_metric. Raises
    ValueError, before any step runs, when pp does not divide the layers
    (networks.check_ported).

    plan: None, or a parallel/mesh.py::MeshPlan (shard_train_step makes
    it): then `batches` are this rank's dp rows of the global batch and
    ts holds its tp / ep slices (and dp slices under ZeRO); every loss,
    normaliser and BatchNorm statistic is the global batch's and the
    split layers run their collectives (parallel/collectives.py), the
    gradients are summed over the dp x sp ranks (an sp rank's share covers
    its frames, and 1/sp of every term computed on whole sequences) and
    the metrics over the dp ranks only (a tp, ep, sp or pp rank's losses
    are its dp peer's; a pp rank's gradients are whole after the
    pipeline's backward, parallel/pipeline.py), the clip's norm counts
    each split leaf over its axes, and the update goes through the plan
    (ZeRO)."""
    N.check_ported(cfg)
    gen_tx, disc_tx = make_optimizers(cfg, args)
    scale = 1.0 / (args.ae_steps + args.cm_steps + args.sp_steps)

    def update(tx, field, grads, opt_state, params, norm):
        if plan is not None:
            return plan.update(tx, field, grads, opt_state, params, norm)
        updates, opt_state = tx.update(grads, opt_state, params, norm)
        return apply_updates(params, updates), opt_state

    def norm_of(grads, field):
        return (global_norm(grads) if plan is None
                else plan.global_norm(grads, field))

    def reduce_metrics(metrics: dict):
        # each rank's losses are its shares of the global batch's
        if plan is None or not metrics:
            return metrics
        keys = list(metrics)
        return dict(zip(keys, plan.all_reduce([metrics[k] for k in keys])))

    def train_step(ts: TrainState, gen: torch.Generator, batches):
        if plan is None:
            return step(ts, gen, batches)
        with plan.axes():
            return step(ts, gen, batches)

    def step(ts: TrainState, gen: torch.Generator, batches):
        metrics = {}
        params_in = ts.params if plan is None else plan.params_in(ts.params)
        gen_params, disc_params = split_params(params_in)
        live = tree_map(lambda x: x.detach().requires_grad_(True), gen_params)
        params = dict(live)
        if disc_params is not None:
            params["discriminator"] = disc_params
        wrt = tree_leaves(live)
        total = None
        net_state = ts.net_state
        for name, fn in (("ae", ae_loss_fn), ("cm", cm_loss_fn),
                         ("sp", sp_loss_fn)):
            if name not in batches:
                continue
            loss_fn = functools.partial(fn, cfg=cfg, args=args, scale=scale)
            with record_function(f"unast/train/{name}"):
                g, net_state, aux = _accumulate(loss_fn, params, wrt,
                                                net_state, gen, batches[name])
            total = g if total is None else [a + b for a, b in zip(total, g)]
            metrics.update({f"{name}/{k}": v.mean() for k, v in aux.items()})

        metrics = reduce_metrics(metrics)
        gen_opt = ts.gen_opt
        with torch.no_grad(), record_function("unast/train/gen_update"):
            if total is not None:
                if plan is not None:
                    total = plan.reduce_grads(total)
                gen_grads = tree_unflatten(gen_params, total)
                metrics["grad_norm"] = norm_of(gen_grads, "gen_opt")
                gen_params, gen_opt = update(
                    gen_tx, "gen_opt", gen_grads, gen_opt,
                    gen_params, metrics["grad_norm"])
        new_params = dict(gen_params)
        disc_opt = ts.disc_opt

        if cfg.use_discriminator and "d" in batches:
            d_live = tree_map(lambda x: x.detach().requires_grad_(True),
                              disc_params)

            def d_loss(disc_p, st, g, batch):
                loss, aux = disc_loss_fn(disc_p, gen_params, st, g, batch,
                                         cfg, args, 1.0 / args.d_steps)
                return loss, (aux, st)

            with record_function("unast/train/d"):
                d_grads, _, d_aux = _accumulate(d_loss, d_live,
                                                tree_leaves(d_live), net_state,
                                                gen, batches["d"])
            with torch.no_grad():
                if plan is not None:
                    d_grads = plan.reduce_grads(d_grads)
                d_grads = tree_unflatten(disc_params, d_grads)
                disc_params, disc_opt = update(
                    disc_tx, "disc_opt", d_grads, disc_opt,
                    disc_params, norm_of(d_grads, "disc_opt"))
            metrics.update(reduce_metrics(
                {f"d/{k}": v.mean() for k, v in d_aux.items()}))

        if disc_params is not None:
            new_params["discriminator"] = disc_params
        if getattr(args, "param_sum_metric", False):
            metrics["param_sum"] = (
                sum(x.abs().sum() for x in tree_leaves(new_params))
                if plan is None else
                plan.split_sum(new_params, lambda x: x.abs().sum()))
        if plan is not None:
            new_params = plan.params_out(new_params)
        return TrainState(new_params, net_state, gen_opt, disc_opt,
                          ts.step + 1), metrics

    train_step.config, train_step.plan = (cfg, args), plan
    return train_step
