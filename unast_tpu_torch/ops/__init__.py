"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (counterpart of unast_tpu/ops)."""

from .attention import (flash_attention, flash_attention_bwd_plain,
                        flash_attention_plain)

__all__ = ["flash_attention", "flash_attention_bwd_plain", "flash_attention_plain"]
