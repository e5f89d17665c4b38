"""Config and flags of the port, mirroring `unast_tpu/train/config.py`:
`--config file.json` loads flat keys into the namespace and any flag given
on the command line overrides the JSON value (the reference's
parse_with_config, src/utils.py:198-229). The flags and their defaults
are the JAX package's, plus `--device` (default 'cuda'), the port's device
rule. `--fast_prng` is parsed and has no effect.

train_args(path, **overrides) is the parser's defaults, then a config
JSON, then keyword overrides, for code that drives the train step without
a command line.
"""

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="unast_tpu_torch trainer")
    add = p.add_argument
    add("--config", type=str, default=None, help="JSON config (flat keys)")

    # run control
    add("--seed", type=int, default=0)
    add("--epochs", type=int, default=300)
    add("--epoch_steps", type=int, default=50)
    add("--train_batch_size", type=int, default=4)
    add("--eval_batch_size", type=int, default=100)
    add("--num_workers", type=int, default=4)
    add("--is_eval_test", action="store_true")

    # optimizer / schedule
    add("--lr", type=float, default=0.0625)
    add("--weight_decay", type=float, default=1e-6)
    add("--optim_type", type=str, default="adamw",
        choices=["adam", "adamw", "adafactor"])
    add("--sched_type", type=str, default="transformer",
        choices=["multistep", "linear", "transformer", "none"])
    add("--warmup_steps", type=int, default=2000)
    add("--lr_milestones", type=json.loads, default=[100, 200])
    add("--lr_gamma", type=float, default=0.5)
    add("--grad_clip", type=float, default=1.0)
    add("--ema_decay", type=float, default=0.0,
        help="exponential-moving-average decay over generator params "
             "(0 = off, reference parity); when on, evaluation and "
             "best-checkpoint selection use the EMA weights")

    # objective mix (src/train.py:597-638)
    add("--ae_steps", type=int, default=4)
    add("--cm_steps", type=int, default=8)
    add("--sp_steps", type=int, default=4)
    add("--d_steps", type=int, default=4)
    add("--sp_warmup_steps", type=int, default=0,
        help="supervised-only grounding warm-start before the joint "
             "mixture (the curriculum that takes the transformer to "
             "joint PER 0 in the JAX package's convergence study)")

    # teacher forcing schedule (dormant in the reference, #51)
    add("--teacher_init_val", type=float, default=1.0)
    add("--teacher_gamma", type=float, default=0.98)
    add("--teacher_decay_start", type=int, default=301)
    add("--teacher_decay_end", type=int, default=301)

    # model dims
    add("--model_type", type=str, default="transformer",
        choices=["transformer", "rnn"])
    add("--num_mels", type=int, default=80)
    add("--hidden", type=int, default=256)
    add("--e_in", type=int, default=256)
    add("--t_emb_dim", type=int, default=256)
    add("--s_pre_hid", type=int, default=256)
    add("--ffn_dim", type=int, default=1024)
    add("--num_layers", type=int, default=4)
    add("--nhead", type=int, default=4)
    add("--s_pre_drop", type=float, default=0.5)
    add("--s_post_drop", type=float, default=0.1)
    add("--t_pre_drop", type=float, default=0.5)
    add("--t_post_drop", type=float, default=0.1)
    add("--e_drop", type=float, default=0.1)
    add("--d_drop", type=float, default=0.1)
    add("--speech_encoder", type=str, default="transformer",
        choices=["transformer", "conformer"],
        help="speech-side encoder family (conformer = conv-augmented "
             "blocks, models/conformer.py; transformer backbone only)")
    add("--conformer_kernel", type=int, default=15,
        help="conformer depthwise-conv window (odd)")
    add("--e_bi", type=lambda s: s.lower() != "false", default=True)
    add("--d_attn", type=str, default="lsa", choices=["lsa", "luong", "none"])
    add("--attn_dim", type=int, default=128)

    # discriminator
    add("--use_discriminator", type=lambda s: s.lower() != "false",
        default=False)
    add("--disc_hid", type=int, default=64)
    add("--disc_bidirectional", type=lambda s: s.lower() != "false",
        default=True)
    add("--disc_num_layers", type=int, default=2)

    # losses
    add("--s_eos_weight", type=float, default=5.0)
    add("--t_eos_weight", type=float, default=1.0)
    add("--ga_weight", type=float, default=0.0,
        help="guided-attention diagonal-prior loss weight on teacher-forced "
             "cross-attention (0 = exact reference objective; transformer "
             "only)")
    add("--ga_sigma", type=float, default=0.2,
        help="guided-attention diagonal bandwidth")
    add("--stop_threshold", type=float, default=0.5,
        help="greedy speech decode stops when sigmoid(stop) >= this "
             "(0.5 = reference)")

    # sequence caps / buckets (fixed batch shapes)
    add("--max_mel_len", type=int, default=815)
    add("--max_text_len", type=int, default=300)
    add("--data_mel_len", type=int, default=816,
        help="fixed padded mel frames for train batches")
    add("--data_text_len", type=int, default=304,
        help="fixed padded text length for train batches")
    add("--text_buckets", type=json.loads, default=None,
        help="ascending text-length buckets, e.g. [64,128,192,304]")
    add("--mel_buckets", type=json.loads, default=None,
        help="ascending mel-frame buckets, e.g. [256,512,816]")
    add("--cm_infer_mel_len", type=int, default=0,
        help="cap for pseudo-speech inference in cm steps (0 = max_mel_len)")
    add("--cm_infer_text_len", type=int, default=0,
        help="cap for pseudo-text inference in cm steps (0 = max_text_len)")

    # data
    add("--data_path", type=str, default="./data/LJSpeech-1.1")
    add("--splits_dir", type=str, default=None)
    add("--synthetic", action="store_true",
        help="use the synthetic dataset (no LJSpeech on disk)")
    add("--synthetic_size", type=int, default=64)

    # checkpoints / outputs
    add("--checkpoint_path", type=str, default="./checkpoints/run")
    add("--load_path", type=str, default=None)
    add("--save_every", type=int, default=10)
    add("--sample_path", type=str, default="./samples/run")
    add("--tb_log_path", type=str, default=None)
    add("--out_test_dir", type=str, default="./test_out")
    add("--tb_example_step", type=int, default=5)

    # precision / parallelism
    add("--compute_dtype", type=str, default="bfloat16",
        choices=["float32", "bfloat16"])
    add("--attn_impl", type=str, default="xla", choices=["xla", "flash"])
    add("--scan_layers", type=lambda s: s.lower() != "false", default=False)
    add("--remat", type=lambda s: s.lower() != "false", default=False,
        help="rematerialize transformer layers in the backward pass: "
             "trades ~1/3 extra FLOPs for O(layers) less activation "
             "memory -- enables large-width training (not in the port "
             "yet: raises). "
             "Per-layer dropout keys fold the layer index from one base "
             "key (same streams as --scan_layers)")
    add("--remat_policy", type=str, default="",
        choices=["", "dots", "dots_all"],
        help="checkpoint policy for --remat: '' recomputes "
             "everything; 'dots' saves matmul outputs with no batch dims; "
             "'dots_all' saves all dots")
    add("--device", type=str, default="cuda",
        help="torch device the run uses (the port's entry points run on "
             "the card unless the caller asks for another; 'cuda' raises "
             "where there is none)")
    add("--dp", type=int, default=1,
        help="data-parallel ranks, one process per device: launch with "
             "torchrun --nproc_per_node N and pass --dp N")
    add("--tp", type=int, default=1,
        help="tensor-parallel mesh size: megatron splits of the attention "
             "heads and FFNs over 'tp' (must divide nhead and ffn_dim)")
    add("--sp", type=int, default=1,
        help="sequence-parallel mesh size: the transformer's time axis "
             "split over 'sp' inside the train step (with MoE, remat and "
             "--pp too; the RNN backbone runs replicated over 'sp')")
    add("--ep", type=int, default=1,
        help="expert-parallel mesh size (MoE expert axis sharded over "
             "'ep'; must divide moe_experts)")
    add("--pp", type=int, default=1,
        help="pipeline-parallel stages: GPipe-stage the transformer "
             "encoder/decoder stacks inside the train step (requires "
             "num_layers %% pp == 0); the loop's mesh has no 'pp' axis, "
             "so it runs the schedule in each process, as JAX's loop")
    add("--pp_micro", type=int, default=0,
        help="micro-batches per pipelined stack call (0 = auto: the first "
             "of 4*pp/2*pp/pp dividing the batch)")
    add("--zero", type=int, default=0, choices=[0, 1, 3],
        help="ZeRO/FSDP state sharding over the dp axis: 1 shards the "
             "Adam moments, 3 also shards the parameters (FSDP). "
             "Requires --dp > 1; 0 = fully replicated state (default). "
             "Not in the port yet: nonzero raises")
    add("--moe_experts", type=int, default=0,
        help="replace the transformer FFN with a sparse MoE of this many "
             "experts (0 = dense, reference parity)")
    add("--moe_top_k", type=int, default=1,
        help="experts per token (1 = Switch, 2 = GShard-style)")
    add("--moe_capacity_factor", type=float, default=1.25,
        help="per-expert token capacity multiplier")
    add("--moe_aux_weight", type=float, default=0.01,
        help="weight of the MoE load-balance aux loss (Switch alpha)")
    add("--moe_impl", type=str, default="dispatch",
        choices=["dispatch", "ragged"],
        help="MoE execution path: GShard grouped one-hot dispatch "
             "(ep-shardable, capacity drops) or dropless sort+ragged_dot "
             "(fastest single-chip/dp)")
    add("--moe_group_size", type=int, default=0,
        help="dispatch routing group size (0 = auto <= 4096)")
    add("--reduction_factor", type=int, default=1,
        help="speech-decoder mel frames per autoregressive step (r>1 = "
             "r-fold fewer sequential decode steps; transformer only)")
    add("--fast_prng", type=lambda s: s.lower() != "false", default=False,
        help="the JAX package's hardware RBG generator; parsed so that "
             "its config files load, and without effect in the port, "
             "whose draws come from torch.Generator")
    add("--vocoder_steps", type=int, default=2000,
        help="neural-vocoder training steps (train/melgan.py CLI)")
    add("--vocoder_crop_frames", type=int, default=40,
        help="mel-frame crop length for neural-vocoder training")
    add("--melgan_base", type=int, default=256,
        help="neural-vocoder generator base channel width")
    add("--melgan_adv_steps", type=int, default=0,
        help="hinge-GAN + feature-matching fine-tune steps after the "
             "STFT pretraining phase (0 = STFT-only, the default)")
    add("--vocoder_grad_clip", type=float, default=5.0,
        help="global-norm gradient clip for the neural-vocoder steps "
             "(0 disables; load-bearing for the MRF generator — see "
             "train/melgan.py::_voc_tx)")
    add("--melgan_gen", type=str, default="melgan",
        choices=["melgan", "hifigan"],
        help="neural-vocoder generator family: MelGAN dilated resblocks "
             "or HiFi-GAN multi-receptive-field (MRF) stages")
    add("--melgan_disc", type=str, default="msd",
        choices=["msd", "mpd", "msd+mpd"],
        help="adversarial-fine-tune discriminator family: MelGAN "
             "multi-scale, HiFi-GAN multi-period, or both")
    add("--ctc_steps", type=int, default=2000,
        help="CTC ASR training steps (train/ctc.py CLI)")
    add("--nar_pitch", type=lambda s: s.lower() != "false", default=False,
        help="FastSpeech-2-style pitch adaptor in the NAR TTS model "
             "(token log-F0 predictor + pitch conditioning; pitch_shift "
             "control at inference)")
    add("--ctc_weight", type=float, default=0.0,
        help="hybrid CTC/attention: auxiliary CTC loss on the speech "
             "encoder in the supervised objective (0 = off)")
    add("--cm_text_decode", type=str, default="ar",
        choices=["ar", "spec", "ctc"],
        help="pseudo-transcript decode inside the back-translation "
             "objective: 'ar' = reference-parity sequential greedy; "
             "'spec' = CTC-drafted speculative (exact eval-mode greedy "
             "in ~errors+1 parallel passes); 'ctc' = the CTC head's "
             "one-pass output directly (cheapest). spec/ctc need "
             "--ctc_weight > 0 and the transformer backbone")
    add("--ctc_chunk", type=int, default=0,
        help="streaming CTC ASR: chunk-causal attention in the CTC "
             "model's speech encoder (frames per chunk; 0 = full "
             "context). Models trained with this stream exactly via "
             "infer/streaming.py::StreamingCtcAsr")
    add("--ctc_left", type=int, default=1,
        help="with --ctc_chunk: how many previous chunks each chunk "
             "attends to (bounds streaming state; -1 = unlimited left "
             "context, one-shot decode only)")
    add("--ctc_pos", type=str, default="abs", choices=["abs", "rel"],
        help="CTC speech-encoder positions: 'abs' sinusoid PE (streams "
             "cap at the 5000-frame table) or 'rel' learned relative "
             "bias over the chunk field (unbounded streams)")
    add("--nar_energy", type=lambda s: s.lower() != "false", default=False,
        help="FastSpeech-2-style energy adaptor (token mel-energy "
             "predictor + conditioning; energy_scale control)")
    add("--nar_soft_durations", type=lambda s: s.lower() != "false",
        default=False,
        help="distill EXPECTED attention mass per token instead of "
             "argmax counts (smoother; generalizes better on noisy "
             "teacher alignments); alias for --nar_dur_source soft")
    add("--nar_dur_source", choices=("argmax", "soft", "mas", "ctc", "uniform"),
        default=None,
        help="NAR duration distillation source: per-frame argmax counts "
             "(FastSpeech 1), expected attention mass (soft), "
             "monotonic-alignment-search Viterbi over the teacher "
             "attention (mas), or CTC forced alignment off the "
             "teacher's hybrid CTC head (ctc — needs a teacher trained "
             "with --ctc_weight > 0; the generalization-safe source per "
             "the JAX package's held-out study)")
    add("--nar_ctc_blank_split", type=int, default=1,
        help="with --nar_dur_source ctc: split interior blank runs "
             "half/half between the tokens they separate instead of "
             "attributing them all to the preceding token. Measured on "
             "the synthetic corpus's oracle phoneme grid: frame-"
             "assignment acc 0.80 -> 0.90, |boundary err| 1.15 -> 0.84 "
             "frames (models/ctc.py::ctc_forced_align). 0 = the "
             "all-to-preceding rule")
    add("--nar_steps", type=int, default=2000,
        help="FastSpeech distillation steps (train/fastspeech.py CLI)")
    add("--nar_dur_weight", type=float, default=1.0,
        help="weight of the log-duration regression term in the "
             "FastSpeech distillation loss")
    add("--async_ckpt", type=lambda s: s.lower() != "false", default=False,
        help="background checkpoint writes: save_ckp returns after the "
             "device->host snapshot and the disk write overlaps the next "
             "epoch's training")
    add("--auto_resume", type=lambda s: s.lower() != "false", default=False,
        help="resume from checkpoint_path/model_most_recent.ckpt if "
             "present (preemption-safe restarts without --load_path)")
    add("--profile_dir", type=str, default=None,
        help="write torch.profiler traces of the first epoch here")
    add("--param_sum_metric", type=lambda s: s.lower() != "false",
        default=False, help="log sum|params| per step (reference TB metric)")
    add("--log_every", type=int, default=1,
        help="fetch+log train metrics every N steps (async dispatch means "
             "the host metric fetch is the per-step sync point)")
    return p


def parse_with_config(argv=None) -> argparse.Namespace:
    """unast_tpu/train/config.py::parse_with_config: JSON values fill in;
    explicit CLI flags win (src/utils.py:198-229)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.config is not None:
        with open(args.config) as f:
            cfg = json.load(f)
        argv_l = sys.argv[1:] if argv is None else list(argv)
        cli_keys = {a.split("=")[0].lstrip("-") for a in argv_l
                    if a.startswith("--")}
        for k, v in cfg.items():
            if k not in cli_keys and hasattr(args, k):
                setattr(args, k, v)
    if args.d_attn == "none":
        args.d_attn = None
    return args


def apply_runtime_flags(args):
    """unast_tpu/train/config.py::apply_runtime_flags: check the flags that
    configure the runtime rather than the model. --fast_prng selects JAX's
    hardware RNG and means nothing here. The mesh runs one process per
    device under torchrun (parallel/multihost.py): --dp x --tp x --ep x
    --sp must equal the launch's world size (WORLD_SIZE); --tp must divide
    nhead and ffn_dim and --ep moe_experts (ValueError, parallel/mesh.py::
    check_mesh); --sp takes every model (MoE, remat, the RNN backbone); --zero
    1 or 3 shards the optimizer state (and the params) over the dp ranks
    (0 and dp 1 leave it whole, as in JAX). --pp is a model option: the
    loop's mesh has no pp axis, so each process runs the GPipe schedule
    itself, as JAX's loop does, beside --sp, --tp and --ep. A JAX launcher's JAX_COORDINATOR_ADDRESS
    raises ValueError."""
    sp = getattr(args, "sp", 1) or 1
    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        raise ValueError("JAX_COORDINATOR_ADDRESS is the JAX package's "
                         "multihost launcher; launch the port with torchrun "
                         "--nproc_per_node N -m unast_tpu_torch.train.loop --dp N")
    zero = getattr(args, "zero", 0) or 0
    if zero not in (0, 1, 3):
        raise ValueError(f"--zero must be 0, 1 or 3, got {zero}")
    dp = getattr(args, "dp", 1) or 1
    tp, ep = getattr(args, "tp", 1) or 1, getattr(args, "ep", 1) or 1
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if dp * tp * ep * sp != world:
        raise ValueError(
            f"--dp {dp} x --tp {tp} x --ep {ep} x --sp {sp} with a multihost "
            f"launch of {world} processes: the port runs one process per "
            "device, so the mesh must equal torchrun's --nproc_per_node")
    from ..parallel.mesh import check_mesh
    check_mesh(model_config_from_args(args), tp, ep, sp)


def train_args(path=None, **overrides) -> argparse.Namespace:
    """The parser's defaults, then the config JSON at `path` (if any), then
    `overrides` (keys the parser does not know are set too)."""
    args = parse_with_config([] if path is None else ["--config", str(path)])
    for k, v in overrides.items():
        setattr(args, k, v)
    return args


def model_config_from_args(args):
    """unast_tpu/train/config.py::model_config_from_args: the frozen
    ModelConfig of the flat namespace."""
    from ..models.config import ModelConfig
    return ModelConfig(
        model_type=args.model_type,
        num_mels=args.num_mels, hidden=args.hidden, e_in=args.e_in,
        t_emb_dim=args.t_emb_dim, s_pre_hid=args.s_pre_hid,
        ffn_dim=args.ffn_dim, num_layers=args.num_layers, nhead=args.nhead,
        s_pre_drop=args.s_pre_drop, s_post_drop=args.s_post_drop,
        t_pre_drop=args.t_pre_drop, t_post_drop=args.t_post_drop,
        e_drop=args.e_drop, d_drop=args.d_drop,
        e_bi=args.e_bi, d_attn=args.d_attn, attn_dim=args.attn_dim,
        speech_encoder=getattr(args, "speech_encoder", "transformer")
        or "transformer",
        conformer_kernel=getattr(args, "conformer_kernel", 15) or 15,
        nar_pitch=bool(getattr(args, "nar_pitch", False)),
        nar_energy=bool(getattr(args, "nar_energy", False)),
        ctc_weight=float(getattr(args, "ctc_weight", 0.0) or 0.0),
        ctc_chunk=int(getattr(args, "ctc_chunk", 0) or 0),
        ctc_left=int(getattr(args, "ctc_left", 1)
                     if getattr(args, "ctc_left", 1) is not None else 1),
        ctc_pos=getattr(args, "ctc_pos", "abs") or "abs",
        use_discriminator=args.use_discriminator, disc_hid=args.disc_hid,
        disc_bidirectional=args.disc_bidirectional,
        disc_num_layers=args.disc_num_layers,
        max_mel_len=args.max_mel_len, max_text_len=args.max_text_len,
        stop_threshold=getattr(args, "stop_threshold", 0.5),
        compute_dtype=args.compute_dtype,
        attn_impl=getattr(args, "attn_impl", "xla"),
        scan_layers=getattr(args, "scan_layers", False),
        remat=getattr(args, "remat", False),
        moe_experts=getattr(args, "moe_experts", 0) or 0,
        moe_top_k=getattr(args, "moe_top_k", 1) or 1,
        moe_capacity_factor=getattr(args, "moe_capacity_factor", 1.25),
        moe_impl=getattr(args, "moe_impl", "dispatch") or "dispatch",
        moe_group_size=getattr(args, "moe_group_size", 0) or 0,
        reduction_factor=getattr(args, "reduction_factor", 1) or 1,
        pp=getattr(args, "pp", 1) or 1,
        pp_micro=getattr(args, "pp_micro", 0) or 0,
        remat_policy=getattr(args, "remat_policy", "") or "",
    )
