"""Build the port's CUDA sources with ``nvcc`` into shared libraries with a
plain C interface, for ``ctypes``.

Each source compiles for ``sm_90a`` into ``_build/`` beside this file, on
first use and never at import, keyed by a hash of the source, of every local
header it includes (``#include "..."`` beside it, followed recursively) and
of the flags, so an edited source or header is rebuilt and an unchanged one
is not. ``build_all`` starts one ``nvcc`` per source at once and waits for
all of them. The TMA descriptors need no link flag: the sources look
``cuTensorMapEncodeTiled`` up at run time (``cudaGetDriverEntryPoint``).
"""
from __future__ import annotations

import hashlib
import os
import re
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def includes(source: Path) -> List[Path]:
    """The local headers ``source`` includes, directly or through another
    header, in the order first met."""
    found: List[Path] = []
    todo = [source]
    while todo:
        cur = todo.pop()
        for name in _INCLUDE.findall(cur.read_text()):
            header = cur.parent / name
            if header.exists() and header not in found:
                found.append(header)
                todo.append(header)
    return found


def library_path(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    for header in includes(source):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def _start(source: Path) -> Optional[subprocess.Popen]:
    lib = library_path(source)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    return subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                             str(source)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(source: Path, proc: Optional[subprocess.Popen]) -> Path:
    lib = library_path(source)
    if proc is None:
        return lib
    out, _ = proc.communicate()
    Path(f"{lib}.log").write_text(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source.name}:\n{out}")
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    os.replace(tmp, lib)     # atomic: concurrent builders never see half a file
    return lib


def build(source: Path) -> Path:
    """Compile ``source`` unless its library already exists. Returns the
    library path; ``<path>.log`` holds nvcc's ``-Xptxas -v`` report
    (registers, shared memory, spills)."""
    return _finish(source, _start(source))


def build_all(sources: Iterable[Path]) -> Dict[Path, Path]:
    """Build every source with one ``nvcc`` each, all started together."""
    procs = [(s, _start(s)) for s in sources]
    try:
        return {s: _finish(s, p) for s, p in procs}
    finally:
        for _, p in procs:
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
