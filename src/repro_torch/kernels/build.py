"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries
land in ``build/repro_torch_kernels/`` at the root of the checkout
(``build_dir``), named by a digest of the sources and flags, so an
edited source rebuilds and an unchanged one loads.  A build happens at first use, or
all at once through ``build`` (which ``chip_smoke.py`` calls with
``report=True`` to show the register and spill report of
``-Xptxas -v``).

Each C entry returns ``cudaGetLastError()`` after its launch; ``check``
raises if it is not 0, so a launch the card refuses never passes
silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
ROOT = Path(__file__).resolve().parents[3]  # the checkout, from src/
SOURCES = ("dcd_ell", "dcd_block", "dcd_feature")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc() -> str:
    """The CUDA compiler: on ``PATH``, else under ``$CUDA_HOME``, else
    the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def build_dir() -> Path:
    """``build/repro_torch_kernels/`` in the checkout the package runs
    from.  Raises unless ``ROOT`` (three levels above this module) is
    that checkout, with its ``pyproject.toml``: the libraries are built
    there and never beside an installed package."""
    if not (ROOT / "pyproject.toml").is_file():
        raise RuntimeError(
            f"{ROOT} holds no pyproject.toml, so it is not the repo's "
            "checkout: run repro_torch from its src/ directory "
            "(PYTHONPATH=src), where the kernels build into "
            "build/repro_torch_kernels/")
    return ROOT / "build" / "repro_torch_kernels"


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, *, report: bool = False) -> dict[str, str]:
    """Compile those of ``names`` not built yet — all of them with
    ``report`` — one ``nvcc`` each, all started together.  Returns each
    compiler's output: with ``report``, the ``-Xptxas -v`` register and
    spill report of every kernel.  Raises if one fails, or if the
    package does not run from a checkout's ``src/`` (``build_dir``)."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists() and not report:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if report else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode == 0:
            # atomic: a concurrent loader sees all of it or nothing
            os.replace(tmp, out)
        else:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def entry(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``fn`` of library ``name``, built and loaded at first
    use, with its argument types set (pointers and the stream as
    ``c_void_p``, so ctypes never cuts them to 32 bits) at its first
    lookup; later lookups return it as it is."""
    f = _entries.get((name, fn))
    if f is not None:
        return f
    if name not in _loaded:
        path = lib_path(name)
        if not path.exists():
            build((name,))
        _loaded[name] = ctypes.CDLL(str(path))
    f = getattr(_loaded[name], fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    _entries[(name, fn)] = f
    return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def ptr(t) -> int | None:
    """A tensor's device address for ctypes (``None`` → null)."""
    return None if t is None else t.data_ptr()


def stream() -> int:
    """The current CUDA stream, where every kernel launches."""
    return torch.cuda.current_stream().cuda_stream


def check_operands(device, shapes: dict, int32=()) -> None:
    """Raise unless every operand (``None`` skipped) is a contiguous
    tensor on ``device`` of its expected shape, int32 if named in
    ``int32`` and float32 otherwise.  ``shapes`` maps a name to
    ``(tensor, shape)``; a ``None`` shape is not checked."""
    for name, (t, shape) in shapes.items():
        if t is None:
            continue
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {device}")
        want = torch.int32 if name in int32 else torch.float32
        if t.dtype != want:
            raise ValueError(f"{name} must be {want}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
