"""unast_tpu_torch: the PyTorch and CUDA port of unast_tpu for NVIDIA Hopper.

The JAX package `unast_tpu` stays the reference; this package imports
nothing of it. Its layout follows the JAX package's, so each module's
counterpart is easy to find. It serves greedy TTS and ASR
(`infer.serve.Synthesizer`, `infer.server`) and trains (`python -m
unast_tpu_torch.train.loop`: the datasets of `data`, the joint UNAST step
of `train.make_train_step` with the LSTM discriminator, PER evaluation of
`infer.evaluate`, checkpoints of `train.checkpoint`) on the transformer
backbone; with attn_impl='flash' the encoders' and the teacher-forced
decoders' attention runs through hand-written flash-attention kernels
(`ops.attention`, source in `csrc/`), whose gradient is a plain-torch
recompute backward. The RNN backbone and the CBHG vocoder serve and train
through the same entry points. `python -m unast_tpu_torch.data.prepare`
prepares a corpus into caches and packed shards (`data.shard`); the CTC
model (`models.ctc`, `python -m unast_tpu_torch.train.ctc`) serves ASR
through `Synthesizer(ctc_pv=)`.
"""
