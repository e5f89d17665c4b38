"""flash_fwd_roofline.serve, %: the flash forward kernels' share of their
roofline over the traced tail (benchmark/harness/readers.py)."""

from benchmark.harness.readers import flash_roofline


def read(rec):
    return flash_roofline(rec, "fwd")
