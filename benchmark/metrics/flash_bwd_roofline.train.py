"""flash_bwd_roofline.train, %: the flash backward kernels' share of their
roofline over the traced tail, both launches of each backward counted
(benchmark/harness/readers.py)."""

from benchmark.harness.readers import flash_roofline


def read(rec):
    return flash_roofline(rec, "bwd")
