"""Model stack of the port (counterpart of unast_tpu/models): the
transformer backbone's serving and training paths and the LSTM
discriminator."""

from .config import ModelConfig, TINY, VOCAB_SIZE, PAD_IDX, SOS_IDX, EOS_IDX
from . import modules, transformer, networks, rnn, unast
from .unast import unast_init, tts, asr

__all__ = [
    "ModelConfig", "TINY", "VOCAB_SIZE", "PAD_IDX", "SOS_IDX", "EOS_IDX",
    "modules", "transformer", "networks", "rnn", "unast", "unast_init", "tts", "asr",
]
