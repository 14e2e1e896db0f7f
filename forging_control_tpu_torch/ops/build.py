"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source ``csrc/<name>.cu`` exposes a plain C interface and is compiled,
at first use, into ``build/torch_kernels/<name>-<hash>.so`` beside the
package (a directory that ``.gitignore`` lists).  The hash covers the source,
the headers of ``csrc/`` (``*.cuh``, ``*.h``) and the flags, so an edited
source is rebuilt.
Nothing here runs at import time, and nothing falls back: a missing ``nvcc``
or a failed compile raises.

:func:`build_host` compiles ``csrc/host_bodies.cpp`` with ``g++``: the
per-scenario bodies of kernels K4 and K5 and of the SQP's build and search
on the CPU, for the tests, and the count of the operations they need
(``ops.opcount``, for the kernels' bounds).  No path of the port loads it.

:func:`launch` makes every kernel launch of the port and counts it in
:data:`LAUNCHES`, keyed by the kernel's name.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..utils.profiling import annotate

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# Flags of one source beyond NVCC_FLAGS.  K4, K5 and the SQP's build and
# search follow their plain versions operation for operation, and those
# round every multiply and add on their own: without contraction K4 equals
# the plain plant bit for bit on the card, and the solvers' physics rounds
# as the plain solves' does (csrc/plant.cu, csrc/ilqr.cu,
# csrc/sqp_build.cu, csrc/sqp_search.cu).
EXTRA_FLAGS = {name: ("--fmad=false",)
               for name in ("plant", "ilqr", "sqp_build", "sqp_search")}
HOST_FLAGS = ("-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
              "-pthread")


@dataclasses.dataclass
class Built:
    """One compiled kernel library."""

    name: str
    path: Path
    lib: ctypes.CDLL
    seconds: float      # compile time of this process's build (0 if reused)
    log: str            # nvcc/ptxas output of the build (registers, spills)


_loaded: dict[str, Built] = {}

# The launches :func:`launch` made (or a CUDA graph's capture holds, once
# per replay: loop.graph), by kernel name: "ilqr" (K5), "plant" (K4),
# "plant sqrt" (K4's square-root check), "smallchol" (B1), "sqp_build",
# "sqp_search", "probe" (B3), "lstm mma" and "lstm simt" (B2's variants).
LAUNCHES: collections.Counter = collections.Counter()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _digest(src: Path, flags) -> str:
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    for header in sorted([*SOURCE_DIR.glob("*.cuh"),
                          *SOURCE_DIR.glob("*.h")]):
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str) -> tuple[Path, Path]:
    src = SOURCE_DIR / f"{name}.cu"
    return src, BUILD_DIR / f"{name}-{_digest(src, _flags(name))}.so"


def build_all(names) -> dict[str, Built]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together; then load them all.  The compile and load
    of the sources not loaded yet is the kept span ``kernels.build``, its
    ``args`` their names (``utils.profiling``)."""
    names = list(names)
    todo = [n for n in names if n not in _loaded]
    if todo:
        with annotate("kernels.build", " ".join(todo)):
            _build(todo)
    return {n: _loaded[n] for n in names}


def _build(todo) -> None:
    """Compile the sources of ``todo`` that are not built, then load all."""
    pending = []
    for name in todo:
        src, out = _target(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *_flags(name), "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending.append((name, out, tmp, proc, time.perf_counter()))
    seconds, failed = {}, []
    for name, out, tmp, proc, t0 in pending:   # wait for every nvcc
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in todo:
        _, out = _target(name)
        log_path = out.with_suffix(".log")
        _loaded[name] = Built(
            name=name, path=out, lib=ctypes.CDLL(str(out)),
            seconds=seconds.get(name, 0.0),
            log=log_path.read_text() if log_path.exists() else "")


def build_host() -> ctypes.CDLL:
    """``csrc/host_bodies.cpp`` compiled with ``g++`` (``HOST_FLAGS``) into
    ``build/torch_kernels/host_bodies-<hash>.so`` and loaded: the bodies of
    kernels K4 and K5 and of the SQP's build and search on the CPU, with
    their C interface less the stream.
    For the tests and the operation counts (``ops.opcount``); raises if
    ``g++`` is missing or the compile fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host build of the kernels' "
                           "bodies needs it")
    src = SOURCE_DIR / "host_bodies.cpp"
    out = BUILD_DIR / f"host_bodies-{_digest(src, HOST_FLAGS)}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([gxx, *HOST_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for host_bodies.cpp (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def on_card(device: torch.device) -> bool:
    """Whether a wrapper's dispatch takes its kernel for tensors on
    ``device``: True on a card, False on the CPU (the plain version);
    any other device raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {device}: the port runs on CUDA "
                     f"or the CPU")


def load(name: str) -> Built:
    """The built library for ``csrc/<name>.cu``, compiling it if needed."""
    if name not in _loaded:
        build_all([name])
    return _loaded[name]


@functools.cache
def entry(name: str, symbol: str, argtypes: tuple):
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` with its
    ``argtypes`` set and an ``int`` result (a ``cudaError_t``), bound once
    per process; the library is built at the first call."""
    fn = getattr(load(name).lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def kernel_counter(name: str, counter: str, words: int = 1,
                   reset: bool = False) -> list[int]:
    """The ``words`` values of the ``__device__`` counter that the kernel of
    ``csrc/<name>.cu`` keeps on the current card since its library was
    loaded (or last reset), read by ``fct_<name>_<counter>``.  With
    ``reset`` the counter starts again from 0.  Synchronises the card."""
    fn = entry(name, f"fct_{name}_{counter}",
               (ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int))
    out = (ctypes.c_ulonglong * words)()
    rc = fn(out, int(reset))
    if rc != 0:
        raise RuntimeError(f"reading {name}'s {counter} count failed: CUDA "
                           f"error {rc}")
    return list(out)


def current_stream_handle(index: int) -> int:
    """The ``cudaStream_t`` of device ``index``'s current stream (the
    capture stream inside ``torch.cuda.graph``), as an int: what
    ``torch.cuda.current_stream(index).cuda_stream`` gives, without building
    a ``Stream`` object on every launch."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch(what: str, fn, device: torch.device, *args) -> None:
    """``fn(*args, stream)`` with ``device``'s current stream last, counted
    in ``LAUNCHES[what]``; enters a device context only when ``device`` is
    not the current device.  Raises if the entry point returns a CUDA
    error."""
    index = device.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(device):
            rc = fn(*args, current_stream_handle(index))
    else:
        rc = fn(*args, current_stream_handle(index))
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    LAUNCHES[what] += 1
