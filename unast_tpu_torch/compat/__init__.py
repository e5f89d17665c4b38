"""Two-way migration between the reference PyTorch implementation's
checkpoints and the port's trees (unast_tpu/compat/)."""
