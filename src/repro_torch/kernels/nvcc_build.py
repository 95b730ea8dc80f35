"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source in ``repro_torch/csrc`` has a plain C interface.  At first use
each is compiled by its own ``nvcc`` (all of one call started together) into
a shared library under ``<repo>/build/<tag>-<hash>/``, where the hash covers
the sources, the headers and the flags, so a stale library is never loaded.
Nothing here runs at import, so the port imports on machines with no CUDA
toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's kernels "
                           "are built from source at first use")
    return found


def build_dir(tag: str, sources: Dict[str, str], headers: Sequence[str],
              flags: Sequence[str], csrc: Path = CSRC) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in sorted(sources.values()) + sorted(headers):
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    return BUILD_ROOT / f"{tag}-{h.hexdigest()[:16]}"


def compile_and_load(tag: str, sources: Dict[str, str], headers: Sequence[str],
                     flags: Sequence[str], logs: Dict[str, str],
                     csrc: Path = CSRC) -> Dict[str, ctypes.CDLL]:
    """Compile every source of ``csrc`` (this package's by default) not yet
    built (one ``nvcc`` each, all started together), record each compiler's
    output in ``logs`` and load them all.  Raises with the compiler's output
    if a build fails."""
    out = build_dir(tag, sources, headers, flags, csrc)
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, src in sources.items():
        so = out / f"lib{key}.so"
        if so.exists():
            continue
        tmp = out / f"lib{key}.{os.getpid()}.tmp.so"
        procs[key] = (subprocess.Popen(
            [nvcc(), *flags, "-o", str(tmp), str(csrc / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, so)
    for key, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        logs[key] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {sources[key]}:\n{log}")
        os.replace(tmp, so)
    return {key: ctypes.CDLL(str(out / f"lib{key}.so")) for key in sources}
