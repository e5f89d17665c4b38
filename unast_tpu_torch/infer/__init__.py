"""Serving and evaluation of the port (counterpart of unast_tpu/infer):
the Synthesizer, its HTTP front end, synthesis helpers, evaluation and
PER, and streaming TTS and ASR."""

from .serve import Synthesizer

__all__ = ["Synthesizer"]
