"""Build the port's CUDA kernels with nvcc into shared libraries with a plain
C interface, loaded with ctypes (ops/attention.py::bind).

Each kernel source under `unast_tpu_torch/csrc/` builds into
`build/kernels/<name>-<hash>.so` at the repository root, at first use. The
hash covers every file of `csrc/` (the sources and the headers they
include) and the flags, so an edit to a header rebuilds the libraries.
`build_all` starts one nvcc per missing library, all at once. Nothing here
runs at import time.
"""

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# kernel library name -> its source in csrc/ (also its C entry point's name)
SOURCES = {"flash_attn_fwd_f32": "flash_attn_fwd_f32.cu",
           "flash_attn_fwd_wgmma": "flash_attn_fwd_wgmma.cu",
           "flash_attn_bwd_wgmma": "flash_attn_bwd_wgmma.cu",
           "flash_attn_bwd_f32": "flash_attn_bwd_f32.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def nvcc() -> str:
    """The nvcc on PATH, else the one under CUDA_HOME (default the
    toolkit's usual prefix, /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where the library of kernel `name` lives for the current contents
    of `csrc`: keyed by its source's name, the name and bytes of every
    file under `csrc`, and the flags."""
    h = hashlib.sha256(SOURCES[name].encode())
    for path in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(str(path.relative_to(csrc)).encode() + b"\0")
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def compile_all(jobs: Dict[str, Tuple[Path, Path]]) -> Dict[str, Tuple[int, str]]:
    """Compile each job {label: (source, output library)} with nvcc and
    NVCC_FLAGS, one process per job, all started together. Returns
    {label: (nvcc's exit code, its output, the ptxas report included)}."""
    procs = {label: subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for label, (src, out) in jobs.items()}
    done = {}
    for label, proc in procs.items():
        log, _ = proc.communicate()
        done[label] = (proc.returncode, log)
    return done


def build_all() -> Dict[str, Path]:
    """Build every missing kernel library (compile_all); raises with the
    compiler's output if any build fails. The compiler's report
    (registers, shared memory, spills) is kept beside each library as
    `<lib>.log`. Returns {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in SOURCES}
    tmp = {name: out.with_name(f"{out.name}.{os.getpid()}.tmp")
           for name, out in paths.items() if not out.exists()}
    done = compile_all({name: (CSRC / SOURCES[name], tmp[name]) for name in tmp})
    failed = []
    for name, (code, log) in done.items():
        out = paths[name]
        out.with_name(out.name + ".log").write_text(log)
        if code != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp[name], out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def library(name: str) -> Path:
    """The library of kernel `name`, built first if missing."""
    path = library_path(name)
    if not path.exists():
        build_all()
    return path
