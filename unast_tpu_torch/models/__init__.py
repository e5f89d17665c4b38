"""Model stack of the port (counterpart of unast_tpu/models): the
transformer and RNN backbones' serving and training paths, the LSTM
discriminator, the CBHG vocoder, the CTC ASR model, the FastSpeech NAR
student, the MelGAN / HiFi-GAN vocoders with their discriminators, and
the family additions: the conformer speech encoder and the MoE FFN."""

from .config import ModelConfig, TINY, VOCAB_SIZE, PAD_IDX, SOS_IDX, EOS_IDX
from . import modules, transformer, networks, rnn, unast, ctc, fastspeech, melgan
from . import conformer, moe
from .unast import unast_init, num_params, tts, asr

__all__ = [
    "ModelConfig", "TINY", "VOCAB_SIZE", "PAD_IDX", "SOS_IDX", "EOS_IDX",
    "modules", "transformer", "networks", "rnn", "unast", "ctc", "fastspeech",
    "melgan", "conformer", "moe", "unast_init", "num_params", "tts", "asr",
]
