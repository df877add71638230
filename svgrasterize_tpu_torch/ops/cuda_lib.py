"""Build and load the hand-written CUDA kernels (csrc/) with nvcc + ctypes.

The sources have a plain C interface (csrc/kernels.h), so nvcc compiles
them in seconds into one shared library, which ctypes loads; no PyTorch
header is compiled.  One nvcc process compiles each source to an object
file, all started together, and one more links them.  The library is built
at first use into build/kernels-<hash>/ beside the package, keyed by a hash
of the sources and the flags, so an edited source rebuilds and an unchanged
one is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"

# sm_90a: Hopper.  -fmad=false keeps every multiply and add separately
# rounded, as in the plain PyTorch versions the kernels are held against
# (see csrc/winding.cuh).
COMPILE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_vp = ctypes.c_void_p
_int = ctypes.c_int
_float = ctypes.c_float
_SIGNATURES = {
    "svgr_prepass_winding": (
        ctypes.POINTER(_vp), ctypes.POINTER(_int), ctypes.POINTER(_int), _int,
        _vp, _int, _vp,
    ),
    "svgr_scene_tiles": (
        _vp, _int, _vp, _vp, _vp, _vp, _vp, _vp, _int,
        _vp, _vp, _vp, _vp, _vp, _int, _int, _vp, _int, _int, _vp,
    ),
    "svgr_winding": (_vp, _int, _vp, _int, _int, _vp),
    "svgr_winding_batch": (_vp, _vp, _int, _int, _vp, _vp),
    "svgr_blur_level": (
        _vp, _int, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _int, _int, _int,
        _vp, _int, _vp,
    ),
    "svgr_pool_rows": (_vp, _int, _vp, _int, _vp, _vp, _int, _int, _vp),
    "svgr_part_entry": (
        _vp, _int, _vp, _int, _int, _int, _int, _int, _int, _vp, _vp, _vp, _int, _vp,
    ),
    "svgr_part_exit": (
        _vp, _int, _vp, _int, _int, _int, _int, _int, _int, _int, _int, _int, _int,
        _int, _int, _vp, _vp, _int, _int, _vp,
    ),
    "svgr_untile": (_vp, _int, _int, _vp, _int, _int, _vp),
    "svgr_fe_blur": (_vp, _int, _int, _vp, _int, _vp, _int, _int, _vp, _vp, _vp),
    "svgr_fe_turbulence": (
        _vp, _vp, _int, _int, _int, _int, *(_float,) * 8, _int, _int, _vp, _vp,
    ),
}


def _sources() -> list[Path]:
    return sorted(
        p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh", ".h")
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for p in _sources():
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return BUILD_ROOT / f"kernels-{digest.hexdigest()[:16]}" / "libsvgr_kernels.so"


def build() -> tuple[Path, float]:
    """Compile the library unless it exists; returns (path, build seconds).

    The compiler's report (-Xptxas -v: registers, shared memory, spills per
    kernel) is kept beside the library as nvcc.log.
    """
    so = library_path()
    if so.exists():
        return so, 0.0
    so.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    start = time.monotonic()
    objects, procs = [], []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = so.parent / f"{src.stem}.{tag}.o"
        objects.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs = [proc.communicate()[0] for proc in procs]
    failed = [p.returncode for p in procs if p.returncode != 0]
    if not failed:
        tmp = so.with_suffix(f".{tag}")
        link = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(o) for o in objects)],
            capture_output=True, text=True, check=False,
        )
        logs.append(link.stdout + link.stderr)
        failed = [link.returncode] if link.returncode != 0 else []
    seconds = time.monotonic() - start
    (so.parent / "nvcc.log").write_text("".join(logs))
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed}):\n{''.join(logs)[-4000:]}")
    os.replace(tmp, so)
    return so, seconds


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures set."""
    so, _seconds = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
