"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` becomes one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of its source, the shared headers under
``csrc/`` (``hopper.cuh``) and the flags, so an edited source or header is
rebuilt and a stale library is never loaded.  Libraries go to
``build/`` at the repository root (or ``$REPRO_TORCH_BUILD_DIR``); the
first call that needs a kernel builds it, and :func:`build` builds several
at once, one ``nvcc`` process per source, all started together.  With
``$REPRO_TORCH_NO_BUILD=1`` (a supervisor's workers, which must load what
their parent built) a library that is not built yet raises instead of
being compiled.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("skip_matmul", "flash_attention", "linear_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[tuple[str, str], object] = {}
_LOCK = threading.Lock()


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    # src/repro_torch/kernels/build.py -> the checkout's root
    return pathlib.Path(__file__).resolve().parents[3] / "build"


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels cannot be built on this machine")


def _flags(verbose: bool) -> tuple[str, ...]:
    return NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())


def lib_path(name: str) -> pathlib.Path:
    # the hash covers the source, the shared headers it may include and the
    # flags, so an edit to any of them rebuilds
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:12]}.so"


def build(names=SOURCES, *, verbose: bool = False) -> dict[str, dict]:
    """Build the named libraries that are not built yet, concurrently.

    Returns ``{name: {"seconds": s, "log": compiler output}}`` for each
    library it compiled (``verbose`` adds ``-Xptxas -v``: registers and
    shared memory per kernel).  Raises ``RuntimeError`` with the
    compiler's output if any build fails.
    """
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    if os.environ.get("REPRO_TORCH_NO_BUILD") == "1":
        raise RuntimeError(
            f"kernel libraries {[str(lib_path(n)) for n in todo]} are not "
            "built and $REPRO_TORCH_NO_BUILD=1 forbids compiling them here")
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = lib_path(n).with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *_flags(verbose), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, time.perf_counter())
    results, failed = {}, []
    for n, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, lib_path(n))
        results[n] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            lib.pulse_error_string.argtypes = [ctypes.c_int]
            lib.pulse_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = lib.pulse_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def call(name: str, symbol: str, argtypes: list, device, what: str,
         *args) -> None:
    """Call the C launch function ``symbol`` of library ``name`` with
    ``args`` and, as its last argument, the current stream of ``device``;
    raise if it returns a CUDA error.  The function is looked up and its
    argument types set once, so a launch costs little host time."""
    import torch
    fn = _FNS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[(name, symbol)] = fn
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(_LIBS[name], err, what)
