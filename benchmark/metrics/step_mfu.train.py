"""step_mfu.train, %: the model FLOPs of the window's training steps
(forward and backward at the inputs' real lengths, recompute excluded:
benchmark/reference/flops.py) over the window's seconds times the bf16
tensor-core peak."""

from benchmark.reference.flops import PEAK_BF16


def read(rec):
    w = rec["window"]
    if "steps" not in w or w["steps"] == 0:
        return None
    return 100.0 * w["model_flops"] / (w["seconds"] * PEAK_BF16)
