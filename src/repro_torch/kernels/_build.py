"""Build and load the port's CUDA kernels.

Route: ``nvcc`` compiles each ``csrc/*.cu`` source for ``sm_90a`` into a
shared library with a plain C interface, which ``ctypes`` loads. That takes
seconds per source, where a source that includes PyTorch's headers takes
minutes. Builds run at first use (or through :func:`build`), never at
import, into ``build/repro_torch_kernels/`` at the root of the checkout,
which ``.gitignore`` lists. A library's file name carries a hash of its
source, of every header the source includes (``#include "..."``, found
beside the source or in ``csrc/`` of this package, recursively) and of its
flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is. Each library is written under a temporary name and
renamed into place, so a reader never sees a half-written file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
#: headers shared by the kernels (``-I``)
INCLUDE_DIR = KERNELS_DIR / "csrc"
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"

#: kernel name -> CUDA source
SOURCES = {
    "fused_variation": KERNELS_DIR / "genetic" / "csrc" / "fused_variation.cu",
    "flash_attention": KERNELS_DIR / "attention" / "csrc" / "flash_attention.cu",
    "flash_attention_bwd": (KERNELS_DIR / "attention" / "csrc"
                            / "flash_attention_bwd.cu"),
    "ssd_chunk": KERNELS_DIR / "ssd" / "csrc" / "ssd_chunk.cu",
    "delay_chain": KERNELS_DIR / "delay" / "csrc" / "delay_chain.cu",
}

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# -Xptxas -v: registers and spills per kernel
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
#: flags of one source beyond NVCC_FLAGS (each source's header says why).
#: -fmad=false: no contraction of a*b+c, so every operation of the fused
#: variation rounds as the plain float32 version's does (an exact match)
EXTRA_FLAGS = {"fused_variation": ("-fmad=false",)}


def flags(name: str) -> tuple:
    return ARCH_FLAGS + NVCC_FLAGS + EXTRA_FLAGS.get(name, ())

_loaded: dict = {}


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def includes(src: Path) -> list:
    """The headers ``src`` includes with ``#include "..."``, recursively,
    each once, in the order first met; a header is looked up beside the
    file that includes it, then in INCLUDE_DIR, as nvcc does. Raises if
    one is not found."""
    found, todo = [], [Path(src)]
    while todo:
        cur = todo.pop(0)
        for rel in _INCLUDE.findall(cur.read_bytes()):
            rel = rel.decode()
            path = next((d / rel for d in (cur.parent, INCLUDE_DIR)
                         if (d / rel).is_file()), None)
            if path is None:
                raise FileNotFoundError(f"{cur}: included header {rel!r} "
                                        f"not found in {INCLUDE_DIR}")
            path = path.resolve()
            if path not in found:
                found.append(path)
                todo.append(path)
    return found


def library_path(name: str) -> Path:
    """Where the kernel's library is built: the name carries a hash of the
    source, the headers it includes and its flags."""
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for header in includes(src):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile every named kernel (default: all) whose library is missing,
    one ``nvcc`` per source, all started together. Returns
    {name: compiler output} for the kernels it compiled; raises with the
    compiler's output when a build fails."""
    names = list(SOURCES if names is None else names)
    todo = {n: library_path(n) for n in names if not library_path(n).is_file()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *flags(name), "-I", str(INCLUDE_DIR), "-o", str(tmp),
               str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, {}
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed[name] = logs[name]
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n} ---\n{log}" for n, log in failed.items()))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if it is missing."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
