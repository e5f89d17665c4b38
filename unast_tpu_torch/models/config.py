"""Model configuration of the port, mirroring `unast_tpu/models/config.py`.

The fields and defaults are the JAX package's, so one flat config JSON
(`configs/*.json`) builds the same model on either side. `dtype` answers
with a torch dtype.
"""

import dataclasses
import json
from typing import Optional

import torch

from ..text.symbols import symbols

VOCAB_SIZE = len(symbols)  # 46
PAD_IDX = 0
SOS_IDX = 1
EOS_IDX = 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Mirrors unast_tpu/models/config.py::ModelConfig (field for field)."""

    model_type: str = "transformer"

    num_mels: int = 80
    hidden: int = 256
    e_in: int = 256
    t_emb_dim: int = 256
    s_pre_hid: int = 256
    ffn_dim: int = 1024
    num_layers: int = 4
    nhead: int = 4

    s_pre_drop: float = 0.5
    s_post_drop: float = 0.1
    t_pre_drop: float = 0.5
    t_post_drop: float = 0.1
    e_drop: float = 0.1
    d_drop: float = 0.1

    e_bi: bool = True
    d_attn: Optional[str] = "lsa"
    attn_dim: int = 128

    use_discriminator: bool = False
    disc_hid: int = 64
    disc_bidirectional: bool = True
    disc_num_layers: int = 2

    # Inference caps: fixed-size decode buffers.
    max_mel_len: int = 815
    max_text_len: int = 300

    noise_mask_p: float = 0.3
    spec_freq_mask: int = 20
    spec_time_mask: int = 100

    # Greedy speech decode stops when sigmoid(stop) >= stop_threshold.
    stop_threshold: float = 0.5

    # Activation dtype ('bfloat16' or 'float32'); params stay float32.
    compute_dtype: str = "float32"

    # 'xla': plain attention (attention_core); 'flash': the hand-written
    # flash-attention kernel (ops/attention.py) on the encoders. The
    # KV-cached decode step always uses attention_core.
    attn_impl: str = "xla"

    scan_layers: bool = False
    remat: bool = False
    remat_policy: str = ""
    pp: int = 1
    pp_micro: int = 0

    # Speech decoder emits reduction_factor frames per step.
    reduction_factor: int = 1

    speech_encoder: str = "transformer"
    conformer_kernel: int = 15

    nar_pitch: bool = False
    nar_energy: bool = False

    ctc_weight: float = 0.0
    ctc_chunk: int = 0
    ctc_left: int = 1
    ctc_pos: str = "abs"

    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_impl: str = "dispatch"
    moe_group_size: int = 0

    @property
    def dtype(self) -> torch.dtype:
        """Activation dtype. Params stay float32; the nn apply functions cast
        weights to the activation dtype, and softmax/norms run in float32."""
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    @property
    def moe_opts(self):
        """models/moe.py::MoeOpts of the config's routing options."""
        from .moe import MoeOpts
        return MoeOpts(self.moe_top_k, self.moe_capacity_factor,
                       self.moe_impl, self.moe_group_size)

    @property
    def enc_out_dim(self) -> int:
        if self.model_type == "rnn" and self.e_bi:
            return 2 * self.hidden
        return self.hidden

    @property
    def head_dim(self) -> int:
        return self.e_in // self.nhead

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_args(cls, args) -> "ModelConfig":
        """Build from a flat config namespace/dict; unknown keys are dropped."""
        d = vars(args) if not isinstance(args, dict) else dict(args)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    @classmethod
    def from_json(cls, path: str) -> "ModelConfig":
        """Build from a flat config JSON file such as configs/*.json."""
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_args(json.load(f))

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


# Small config for tests / smoke runs (unast_tpu/models/config.py::TINY).
TINY = ModelConfig(
    hidden=32, e_in=32, t_emb_dim=32, s_pre_hid=32, ffn_dim=64,
    num_layers=2, nhead=2, attn_dim=16, disc_hid=16,
    max_mel_len=24, max_text_len=16,
)
