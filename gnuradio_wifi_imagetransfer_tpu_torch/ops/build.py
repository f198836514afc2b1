"""Build and load the port's CUDA kernels.

At first use, every ``csrc/*.cu`` source is compiled by its own nvcc
process (all started together) for ``sm_90a``, the objects are linked into
one shared library with a plain C interface, and the library is loaded
with ctypes. The library lands in ``_build/`` inside this package (listed
in ``.gitignore``) under a name that carries a hash of the sources, so an
edited source is rebuilt and a stale library is never loaded.

``--fmad=false`` keeps nvcc from contracting a multiply and an add into
one FMA: the Viterbi kernel must round every add and multiply exactly as
the plain version does to break metric ties the same way. The FIR and
resampler kernels (``csrc/fir.cu``) spell their multiply-adds as
``__fmaf_rn`` for that reason.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile csrc/*.cu into one shared library (cached by content)."""
    sources = _sources()
    lib = BUILD_DIR / f"libgwt_torch_kernels_{_digest(sources)}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [pathlib.Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for s, o in zip(sources, objs)]
        logs = [p.communicate()[0].decode(errors="replace") for p in procs]
        failed = [(s.name, log) for s, p, log in zip(sources, procs, logs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {name}\n{log}" for name, log in failed))
        tmp_lib = pathlib.Path(tmp) / lib.name
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-shared", *map(str, objs), "-o", str(tmp_lib)],
                       check=True, capture_output=True)
        os.replace(tmp_lib, lib)        # atomic: concurrent builds agree
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's signature set."""
    lib = ctypes.CDLL(str(build()))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.gwt_sync_stats.argtypes = [vp, vp, vp, vp, i64, i64, vp]
    lib.gwt_sync_stats.restype = i32
    lib.gwt_sync_detect_scratch_bytes.argtypes = [i64, i64, i64]
    lib.gwt_sync_detect_scratch_bytes.restype = i64
    lib.gwt_sync_detect.argtypes = [vp, i64, i64, ctypes.c_float, i32, i64, i64, i32,
                                    vp, vp, vp, vp, vp, vp]
    lib.gwt_sync_detect.restype = i32
    lib.gwt_viterbi_check_tables.argtypes = [vp, vp, vp, vp]
    lib.gwt_viterbi_check_tables.restype = i32
    lib.gwt_viterbi_max_steps.argtypes = []
    lib.gwt_viterbi_max_steps.restype = i64
    lib.gwt_viterbi_max_segments.argtypes = []
    lib.gwt_viterbi_max_segments.restype = i32
    lib.gwt_viterbi_decode_segments.argtypes = [vp, i32, vp]
    lib.gwt_viterbi_decode_segments.restype = i32
    lib.gwt_fir.argtypes = [vp, vp, vp, i64, i64, i64, i32, vp]
    lib.gwt_fir.restype = i32
    lib.gwt_polyphase_resample.argtypes = [vp, vp, vp, i64, i64, i64, i64, i64, i64, i64,
                                           i64, i64, i64, i32, i32, vp]
    lib.gwt_polyphase_resample.restype = i32
    lib.gwt_error_string.argtypes = [i32]
    lib.gwt_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().gwt_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
