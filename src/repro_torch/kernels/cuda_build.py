"""Build, load and count the port's CUDA kernels.

Route (b) of the port's kernel recipe: each ``csrc/*.cu`` file exports
plain C launchers and is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library, loaded with :mod:`ctypes`. Nothing happens at import
time (the CPU test suite imports every module): the first kernel launch,
or an explicit :func:`build_all`, compiles every source at once — one
``nvcc`` process per source, all started together — into ``build/kernels``
at the repository root (listed in ``.gitignore``). A library is named by
a hash of its source and flags, so an edited source is rebuilt and an
unchanged one is reused.

No fallback anywhere: a missing ``nvcc``, a failed build, or a launcher
that returns a CUDA error raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
#: launcher name -> (source file, launcher symbol, launcher argtypes); a
#: source with several launchers is built once
SOURCES = {
    "skew_metrics": ("skew_metrics.cu", "skew_metrics_launch",
                     [_P, _P, _P, _I, _I, _F, _P]),
    "triple_score": ("triple_score.cu", "triple_score_launch",
                     [_P, _LL, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "flash_attention": ("flash_attention.cu", "flash_attention_launch",
                        [_P] * 4 + [_I] * 6 + [_LL] * 9 + [_F, _P]),
    "decode_attention": ("decode_attention.cu", "decode_attention_launch",
                         [_P] * 4 + [_I] * 7 + [_LL] * 8 + [_F, _P]),
    "segment_sum_sorted": ("segment_reduce.cu", "segment_sum_sorted_launch",
                           [_P, _P, _P, _LL, _I, _I, _I, _P]),
    "embedding_bag": ("segment_reduce.cu", "embedding_bag_launch",
                      [_P, _P, _P, _LL, _I, _I, _LL, _I, _I, _P]),
}

#: Launches per kernel wrapper: each wrapper adds one where it launches
#: its kernel and nowhere else (CPU tensors take the plain version and
#: do not count).
LAUNCHES = {"skew_metrics": 0, "triple_score_batched": 0, "triple_score": 0,
            "flash_attention": 0, "decode_attention": 0,
            "segment_sum_sorted": 0, "embedding_bag": 0}

#: nvcc/ptxas output of the last build, per source stem (registers, spills).
BUILD_LOG: dict[str, str] = {}

_lock = threading.Lock()
_launchers: dict[str, object] = {}
_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's CUDA kernels are built from source at "
                           "first use")
    return str(path)


def _lib_path(src: str) -> Path:
    """Named by a hash of the source, the shared headers and the flags."""
    parts = [(CSRC / src).read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{Path(src).stem}-{digest[:12]}.so"


def build_all() -> float:
    """Compile every source that has no up-to-date library, one ``nvcc``
    per source in parallel; load every launcher. Returns the seconds
    spent."""
    t0 = time.perf_counter()
    with _lock:
        if len(_launchers) == len(SOURCES):
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for src in sorted({src for src, _, _ in SOURCES.values()}):
            out = _lib_path(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            procs[src] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failed = []
        for src, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[Path(src).stem] = log
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {src} "
                              f"(exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
        for name, (src, symbol, argtypes) in SOURCES.items():
            lib = ctypes.CDLL(str(_lib_path(src)))
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name], _launchers[name] = lib, fn
    return time.perf_counter() - t0


def check_tensor(t: "torch.Tensor", what: str, shape: tuple,
                 dtype: "torch.dtype", device: "torch.device",
                 strided: bool = False) -> None:
    """Raise unless ``t`` has this device, dtype and shape and is
    contiguous — or, with ``strided``, is a view whose last dimension is
    contiguous and whose rows start on 16-byte boundaries (the data
    pointer and the stride of every other dimension longer than 1 a
    multiple of 16 bytes), so the kernel's 16-byte loads stay aligned."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} must have shape {shape}, "
                         f"got {tuple(t.shape)}")
    if not strided:
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
        return
    per16 = 16 // t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
            st % per16 for st, n in zip(t.stride()[:-1], t.shape[:-1])
            if n > 1):
        raise ValueError(f"{what}: the last dimension must be contiguous "
                         f"and rows 16-byte aligned (strides "
                         f"{tuple(t.stride())}, data_ptr % 16 = "
                         f"{t.data_ptr() % 16})")


def launch(name: str, *args) -> None:
    """Call library ``name``'s launcher; raise on a CUDA error code."""
    if name not in _launchers:
        build_all()
    rc = _launchers[name](*args)
    if rc != 0:
        msg = _libs[name].kernel_error_string(rc).decode()
        raise RuntimeError(f"{SOURCES[name][1]} failed: CUDA error {rc} "
                           f"({msg})")
