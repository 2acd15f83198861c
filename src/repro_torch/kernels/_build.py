"""Build and load the CUDA kernels of ``repro_torch/csrc``.

At first use, every ``csrc/*.cu`` file is compiled with ``nvcc`` for
``sm_90a`` (one ``nvcc`` process per source, all started together) and
linked into one shared library, ``build/libreprotorch.so`` at the root of
the checkout, which is loaded with ``ctypes``.  The kernels expose a plain
C interface: every pointer and the stream pass as ``c_void_p``, sizes as
``c_int``/``c_longlong``, and each launch function returns
``cudaGetLastError()``, or a negative code for a shape its kernel cannot
take, which ``check`` turns into an exception.

The library is rebuilt whenever the sources or the flags change (a SHA-256
stamp beside it).  Nothing here runs at import time, and there is no
fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
LIB_NAME = "libreprotorch.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v: ptxas reports each kernel's registers, stack and spills
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

SM_COUNT = 132  # streaming multiprocessors of the H100 SXM
MAX_SHARED_BYTES = 227 * 1024  # a block's dynamic shared memory, opted in
# at most this much a block leaves room for a second block on the SM
# (228 KB an SM, 1 KB of it reserved per block)
TWO_BLOCK_SHARED_BYTES = 113 * 1024
# L2 bytes that take as long as one shared-memory wavefront (128 bytes an
# SM a cycle): about 5.5 TB/s of L2 against 132 SMs x 1.755 GHz
WAVEFRONT_BYTES = 24

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_functions: dict[str, ctypes._CFuncPtr] = {}
build_seconds: float | None = None  # wall time of this process's build
# source name -> nvcc's output when this process built the library
compiler_output: dict[str, str] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, or
    the ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of repro_torch cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _compile(sources: list[Path], lib_path: Path) -> None:
    """Compile every source to an object in parallel, then link."""
    compiler = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for src, obj in zip(sources, objs)]
        failed = []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            compiler_output[src.name] = out.decode(errors="replace")
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{compiler_output[src.name]}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [compiler, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *map(str, objs)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(tmp_lib, lib_path)  # atomic: a reader sees old or new


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if it is missing or stale."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            sources = sorted(CSRC.glob("*.cu"))
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            lib_path = BUILD_DIR / LIB_NAME
            stamp = BUILD_DIR / (LIB_NAME + ".sha256")
            digest = _digest()
            if not (lib_path.is_file() and stamp.is_file()
                    and stamp.read_text() == digest):
                t0 = time.perf_counter()
                _compile(sources, lib_path)
                stamp.write_text(digest)
                build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(lib_path))
            lib.reprotorch_error_string.argtypes = [ctypes.c_int]
            lib.reprotorch_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def ptxas_report(output: str) -> list[tuple[str, int, int, int, int]]:
    """(kernel, registers, stack bytes, spill store bytes, spill load
    bytes) of each entry function in one source's ``-Xptxas -v`` output,
    kernels by their mangled names."""
    rows, name, frame = [], None, (0, 0, 0)
    for line in output.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = tuple(map(int, m.groups()))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append((name, int(m.group(1)), *frame))
            name, frame = None, (0, 0, 0)
    return rows


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """Launch function ``name`` of the library with its C signature
    declared (``restype`` int: the launch status)."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def check(status: int, kernel: str) -> None:
    """Raise if a launch function returned a CUDA error, or refused a
    shape its kernel cannot take (a negative status, see csrc/common.cuh)."""
    if status != 0:
        text = library().reprotorch_error_string(status).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: status {status} "
                           f"({text})")


def cuda_device(kernel: str, dtypes: dict, **tensors) -> torch.device:
    """The one CUDA device every tensor lies on, after checking each
    tensor's dtype against ``dtypes`` (name -> dtype); raises otherwise."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{kernel} kernel needs all of {sorted(tensors)} on "
                         f"one CUDA device; got {sorted(map(str, devices))}")
    for name, t in tensors.items():
        if t.dtype != dtypes[name]:
            raise ValueError(f"{kernel}: {name} must be {dtypes[name]}, got "
                             f"{t.dtype}")
    return next(iter(devices))


def stream(device: torch.device) -> int:
    """Handle of PyTorch's current stream on ``device``, for a launch."""
    return torch.cuda.current_stream(device).cuda_stream



class TilePlan(NamedTuple):
    """One launch's tiles: ``rows`` x ``cols`` outputs a block, the grid's
    ``blocks``, a block's ``shared_bytes`` (as its launch function computes
    them), the operand bytes the grid stages from L2 (``l2_bytes``) and
    the shared-memory wavefronts its products read at most
    (``wavefronts``)."""

    rows: int
    cols: int
    blocks: int
    shared_bytes: int
    l2_bytes: int
    wavefronts: int

    @property
    def cost(self) -> int:
        """Staged bytes plus wavefronts, in L2 bytes of the same time."""
        return self.l2_bytes + WAVEFRONT_BYTES * self.wavefronts


def pick_tiles(plans: list[TilePlan]) -> TilePlan:
    """The plan a launch takes: among those whose shared memory fits, one
    with a block for every SM (else the most blocks), then one that leaves
    room for two blocks an SM, then the least ``cost``, then the least
    shared memory, then the first listed.  When none fits, the smallest,
    which its launch function refuses (status -2)."""
    fits = [p for p in plans if p.shared_bytes <= MAX_SHARED_BYTES]
    if not fits:
        return min(plans, key=lambda p: p.shared_bytes)

    def key(item):
        i, p = item
        few = p.blocks < SM_COUNT
        return (few, -p.blocks if few else 0,
                p.shared_bytes > TWO_BLOCK_SHARED_BYTES, p.cost,
                p.shared_bytes, i)

    return min(enumerate(fits), key=key)[1]
