"""device_idle_share.train, %: the share of the traced tail's wall in
which no kernel or copy ran on the device (benchmark/harness/readers.py)."""

from benchmark.harness.readers import idle_share


def read(rec):
    return idle_share(rec)
