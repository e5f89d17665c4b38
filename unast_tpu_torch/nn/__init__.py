"""Functional NN core of the port (counterpart of unast_tpu/nn)."""

from .core import (
    Ctx,
    calculate_gain,
    xavier_uniform,
    torch_linear_uniform,
    linear_init,
    linear,
    conv1d_init,
    conv1d,
    embedding_init,
    embedding,
    batchnorm_init,
    batchnorm,
    layernorm_init,
    layernorm,
    dropout,
    lstm_cell_init,
    lstm_gates_in,
    lstm_cell,
    cast_weights,
    tree_to,
)

__all__ = [
    "Ctx", "calculate_gain", "xavier_uniform", "torch_linear_uniform",
    "linear_init", "linear", "conv1d_init", "conv1d", "embedding_init",
    "embedding", "batchnorm_init", "batchnorm", "layernorm_init",
    "layernorm", "dropout", "lstm_cell_init", "lstm_gates_in", "lstm_cell",
    "cast_weights", "tree_to",
]
