#!/usr/bin/env python3
"""A/B timing of the flash-attention backward kernels on one card across
checkouts: each tree's own chip_smoke.py::backward_case on the cases of
its phase 6 (BWD_CASES) of one dtype or both, so a tree whose operator or
kernel takes other arguments (the parent commit, a copy with a constant
changed) is measured through its own code. Trees run in turns (each in
order, then in reverse), one process a turn, after one build of every
tree's kernels, all started together.

    python3 bwd_ab.py TREE [TREE ...] [--dtype bf16|f32|all] [--cases NAME ...]

A TREE is a checkout's root (the parent unpacked with `git archive` into
a directory that .gitignore lists, or `.`). For each tree, case and turn:
the device ms of each launch of the backward (torch.profiler, the tree's
BWD_KERNELS), their sum, SDPA's autograd backward beside it, and whether
the case's checks held. Prints one JSON line per measurement and writes
them all, with the card's name and power limit, to
chiprun_out/bwd_ab.json. Needs a CUDA card and nvcc.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KEYS = ("case", "ok", "device_ms", "device_ms_per_launch", "library_device_ms",
        "bound_ms", "ms")
# run inside a tree: its own chip_smoke's backward cases, one JSON line each
TURN = """
import json, sys, torch
import chip_smoke as CS
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dtypes = {"bf16": (torch.bfloat16,), "f32": (torch.float32,),
          "all": (torch.bfloat16, torch.float32)}[sys.argv[1]]
names = set(sys.argv[2:])
for c in CS.BWD_CASES:
    if c.dtype in dtypes and (not names or c.name in names):
        r = CS.backward_case(c)
        print(json.dumps({k: r.get(k) for k in %r}), flush=True)
""" % (KEYS,)
BUILD = "from unast_tpu_torch.ops import build; build.build_all()"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--dtype", choices=("bf16", "f32", "all"), default="all")
    ap.add_argument("--cases", nargs="*", default=[])
    args = ap.parse_args()
    trees = [str(Path(t).resolve()) for t in args.trees]
    builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=t) for t in trees]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("a tree's kernels did not build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    rows = [{"card": smi, "trees": trees}]
    print(json.dumps(rows[0]), flush=True)
    for turn, tree in enumerate(trees + trees[::-1]):
        done = subprocess.run([sys.executable, "-c", TURN, args.dtype, *args.cases],
                              cwd=tree, capture_output=True, text=True)
        if done.returncode != 0:
            raise SystemExit(f"{tree} failed:\n{done.stderr[-3000:]}")
        for line in done.stdout.splitlines():
            if line.startswith("{"):
                row = {"tree": tree, "turn": turn, **json.loads(line)}
                print(json.dumps(row), flush=True)
                rows.append(row)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "bwd_ab.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
