"""Run one cell of the benchmark of unast_tpu_torch once, on this machine's
cards, and print one JSON line last:

    python benchmark/run.py --workload flagship_d256.sp_warmup \
        --seed 12345 --seconds 30 --trace 0

Set-up (weights and inputs from the seed, the first steps that warm every
shape) counts into `setup_s`; then `--seconds` of measured work; with
`--trace 1` a short profiled tail after it, and the per-layer metrics in
place of the end-to-end ones; then the check against the plain reference
(benchmark/reference), whose numbers and limits close the line under
'checks' and are the last lines on standard error.

Exits 2, printing no result, without a CUDA card (or with fewer than the
cell asks for), and 1 on any failure, also when a module of JAX or of
the JAX package is loaded once the window has closed.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "bench_cache")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every cache of the run inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one host thread for the CPU's own math, as torchrun sets for each
    # process that drives a card: no pool of OpenMP workers competes with
    # the thread that launches the kernels
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, ROOT)

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the port on the card",
              file=sys.stderr)
        return 2
    from benchmark.harness import core
    cell = core.Cell(ROOT, args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = core.run(ROOT, args.workload, args.seed, args.seconds,
                      args.trace, device="cuda", t0=T0)
    for key, c in result["checks"].items():
        print(f"check {key}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    core.refuse_forbidden()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
