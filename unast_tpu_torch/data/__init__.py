"""Data pipeline of the port (counterpart of unast_tpu/data): the LJSpeech
manifest and splits, the synthetic corpus, fixed-shape numpy batching, the
offline preparation (`python -m unast_tpu_torch.data.prepare`) and packed
shards (`data.shard`)."""

from .dataset import LJSpeechDataset, SyntheticSpeechDataset, load_manifest
from .batching import collate, BatchIterator, BatchGetter
from .splits import make_splits, SPLIT_SIZES

__all__ = [
    "LJSpeechDataset", "SyntheticSpeechDataset", "load_manifest",
    "collate", "BatchIterator", "BatchGetter",
    "make_splits", "SPLIT_SIZES",
]
