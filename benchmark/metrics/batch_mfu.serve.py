"""batch_mfu.serve, %: the model FLOPs of the window's TTS batches (the
student and the generator at the phonemes and frames each utterance had:
benchmark/reference/flops.py) over the sum of the batches' latencies
times the bf16 tensor-core peak."""

from benchmark.reference.flops import PEAK_BF16


def read(rec):
    w = rec["window"]
    if "batches" not in w or not w["latencies"]:
        return None
    return 100.0 * w["model_flops"] / (sum(w["latencies"]) * PEAK_BF16)
