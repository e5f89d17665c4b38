#!/usr/bin/env python3
"""A/B timing of the port's flash-attention kernels on one card: this
tree's libraries against those of another checkout (for instance the parent
commit, unpacked with `git archive` into a directory that .gitignore
lists). Both trees' libraries are built with nvcc side by side (all at
once) and called through their C entry points on the same inputs, in turns
(base, this tree, this tree, base), in one process.

    python3 flash_ab.py --base build/checkout/parent [--dtype float32]

Cases: chip_smoke.py's, by name (default: bf16 asr_encoder_qkv and
causal_qkv, float32 asr_encoder_f32), and with --dtype every case of that
dtype. For each: device ms of the call (torch.profiler; for this tree's
float32 route each kernel apart, the pre-pass first), max abs error
against the plain version, for bf16 whether every element is within one
bf16 rounding of the output, SDPA's device ms and the bounds; and each
library's ptxas report. Prints one JSON line per measurement and writes
them all to chiprun_out/flash_ab.json. Needs a CUDA card and nvcc. Both
trees' C entry points must take the same arguments (`q_start` after
`causal`, and the lse pointer after o, which the forward kernels write
beside o). The backward has its own A/B, bwd_ab.py.
"""

import argparse
import json
import re
import subprocess
from pathlib import Path

import torch

from chip_smoke import (FLASH_CASES, ROUTE_KERNELS, attention_bound,
                        case_inputs, device_ms, sdpa_call)
from unast_tpu_torch.ops import build
from unast_tpu_torch.ops.attention import bind, flash_attention_plain

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "ab"
ENTRY = {torch.bfloat16: "flash_attn_fwd_wgmma", torch.float32: "flash_attn_fwd_f32"}
DEFAULT_CASES = ("asr_encoder_qkv", "causal_qkv", "asr_encoder_f32")


def demangle(name):
    """(kernel, D) of a mangled `..<n><kernel name>I..Li<D>E..` symbol: the
    identifier is the one whose length prefix precedes it."""
    m = re.search(r"I\w*?Li(\d+)E", name)
    end = m.start()
    for n in range(1, end):
        ident = name[end - n:end]
        if name[:end - n].endswith(str(n)) and ident[0].isalpha():
            return ident, int(m.group(1))
    return name, int(m.group(1))


def ptxas_report(log):
    """[[kernel, D, registers, spill store bytes, static smem bytes]] from
    a ptxas -v log."""
    rows, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$", line)
        if m and name:
            rows.append([*demangle(name), int(m.group(1)), spill,
                         int(m.group(2) or 0)])
            name = None
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path, required=True,
                    help="root of the checkout to compare with")
    ap.add_argument("--cases", nargs="+", default=DEFAULT_CASES,
                    help="chip_smoke.py case names")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    help="also every case of this dtype")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_ab needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    base_csrc = args.base / "unast_tpu_torch" / "csrc"
    base_f32 = next(base_csrc / s for s in ("flash_attn_fwd_f32.cu",
                                            "flash_attn_fwd.cu")
                    if (base_csrc / s).exists())
    sources = {"base_bf16": base_csrc / "flash_attn_fwd_wgmma.cu",
               "base_f32": base_f32,
               "bf16": build.CSRC / "flash_attn_fwd_wgmma.cu",
               "f32": build.CSRC / "flash_attn_fwd_f32.cu"}
    OUT.mkdir(parents=True, exist_ok=True)
    done = build.compile_all({label: (src, OUT / f"{label}.so")
                              for label, src in sources.items()})
    for label, (code, log) in done.items():
        if code != 0:
            raise SystemExit(f"nvcc failed for {label}:\n{log}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    rows = [{"card": smi, "torch": torch.__version__,
             "ptxas": {label: ptxas_report(log) for label, (_, log) in done.items()}}]
    print(json.dumps(rows[0]))

    launchers = {}
    for label in sources:
        dtype = torch.float32 if label.endswith("f32") else torch.bfloat16
        launchers[label] = bind(OUT / f"{label}.so", ENTRY[dtype])
    cases = [c for c in FLASH_CASES if c.name in args.cases
             or str(c.dtype) == f"torch.{args.dtype}"]
    for c in cases:
        q, k, v, kv_lens = case_inputs(c)
        ref = flash_attention_plain(q, k, v, kv_lens, causal=c.causal,
                                    q_start=c.q_start).float()
        bound_ms, bound_by, bound_cuda_core_ms = attention_bound(q, k, kv_lens, c.causal,
                                                                 c.q_start)
        head = {"case": c.name, "dtype": str(c.dtype), "bound_ms": bound_ms,
                "bound_by": bound_by, "bound_cuda_core_ms": bound_cuda_core_ms,
                "sdpa_device_ms": device_ms(sdpa_call(q, k, v, kv_lens, c.causal,
                                                      c.q_start), (), args.iters)[""]}
        print(json.dumps(head))
        rows.append(head)
        tree = "bf16" if c.dtype == torch.bfloat16 else "f32"
        for label in (f"base_{tree}", tree, tree, f"base_{tree}"):
            def run(launch=launchers[label]):
                return launch(q, k, v, kv_lens, c.causal, c.q_start)
            out = run()[0]
            torch.cuda.synchronize()
            err = (out.float() - ref).abs()
            row = {"case": c.name, "variant": label, "max_abs_err": float(err.max()),
                   "device_ms": device_ms(run, (), args.iters)[""]}
            if c.dtype == torch.bfloat16:
                limit = 2.0 ** -7 * ref.abs() + 1e-5
                row["worst_err_over_one_rounding"] = float((err / limit).max())
                row["within_one_bf16_rounding"] = bool((err <= limit).all())
            if label == "f32":
                row["device_ms_by_kernel"] = device_ms(run, ROUTE_KERNELS[c.dtype],
                                                       args.iters)
            print(json.dumps(row))
            rows.append(row)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "flash_ab.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
