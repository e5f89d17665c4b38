"""Training of the port (counterpart of unast_tpu/train): the joint UNAST
train step (ae, cm and sp objectives and the LSTM discriminator), its
losses, SpecAugment and the optimizers; the config CLI, the training loop
(`python -m unast_tpu_torch.train.loop`), checkpoints, observability and
the single-modality debug trainers; the CTC ASR trainer
(`python -m unast_tpu_torch.train.ctc`), FastSpeech distillation
(`python -m unast_tpu_torch.train.fastspeech`) and the neural-vocoder
trainer (`python -m unast_tpu_torch.train.melgan`)."""

from .steps import TrainState, init_train_state, make_train_step, train_state

__all__ = ["TrainState", "init_train_state", "make_train_step", "train_state"]
