"""Build the CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``csrc/`` becomes one shared library with a plain C
interface, compiled for Hopper (``sm_90a``) into ``build/repro_torch_kernels/``
at the root of the checkout (listed in ``.gitignore``).  A library's file
name carries a hash of its source and flags, so an edited source is rebuilt
and a stale library is never loaded.  Nothing is built when a module is
imported: the first launch builds what it needs, and ``build()`` builds
several sources at once, one ``nvcc`` process each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = {"masked_agg": "masked_agg.cu", "qsgd_decode": "qsgd_decode.cu",
           "swa_attention": "swa_attention.cu", "rwkv6_wkv": "rwkv6_wkv.cu",
           "mamba2_ssd": "mamba2_ssd.cu", "qsgd_encode": "qsgd_encode.cu",
           "centered_clip": "centered_clip.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: flags of one source beyond NVCC_FLAGS: the QSGD codes must equal the
#: plain version's bit for bit, so no multiply may be contracted with an add
EXTRA_FLAGS = {"qsgd_encode": ("-fmad=false",)}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the port's CUDA kernels are built from source")
    return found


def flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    """The library's path, tagged with a hash of its source, the headers
    of ``csrc/`` (which any source may include) and its flags."""
    src = (CSRC / SOURCES[name]).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named sources (all by default) that are not built yet,
    all at once.  Returns each newly built library's compiler log (the
    ``-Xptxas -v`` register and shared-memory report); raises on failure."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *flags(name), "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, building it first if needed."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]


def function(lib: str, name: str, argtypes) -> Callable[..., int]:
    """The C entry point ``name`` of library ``lib``, typed: pointers and
    the stream as ``c_void_p``, an ``int`` (CUDA error code) returned."""
    fn = getattr(load(lib), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
