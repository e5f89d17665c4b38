"""Functional NN core of the port (counterpart of unast_tpu/nn)."""

from . import quant
from .core import (
    Ctx,
    fold_generator,
    calculate_gain,
    xavier_uniform,
    torch_linear_uniform,
    linear_init,
    weight,
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
    gru_cell_init,
    gru_gates_in,
    gru_cell,
    cast_weights,
    tree_to,
)

__all__ = [
    "quant", "Ctx", "fold_generator", "calculate_gain", "xavier_uniform", "torch_linear_uniform",
    "linear_init", "weight", "linear", "conv1d_init", "conv1d", "embedding_init",
    "embedding", "batchnorm_init", "batchnorm", "layernorm_init",
    "layernorm", "dropout", "lstm_cell_init", "lstm_gates_in", "lstm_cell",
    "gru_cell_init", "gru_gates_in", "gru_cell", "cast_weights", "tree_to",
]
