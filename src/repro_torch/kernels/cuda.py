"""Build, load and launch the port's hand-written CUDA kernels.

Every TPU kernel on the port's path has a CUDA C++ counterpart under
``repro_torch/csrc/``.  Each source is compiled on its own by ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface and
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
Libraries are built at first use into ``build/repro_torch_kernels/`` at
the root of the checkout, under a name that carries a digest of the
source, the shared header and the flags, so an edited source is rebuilt
and a stale library is never loaded.  :func:`build_all` starts one
``nvcc`` per source, all at once.

Every C entry point launches on the stream it is given (:func:`launch`
passes the raw handle of ``torch.cuda.current_stream()``), allocates
nothing and returns ``cudaGetLastError()``; :func:`launch` raises when
that is not 0 and only then counts the call in :data:`LAUNCHES`.  Each
entry point is looked up once, with its ``argtypes``, and called
directly after that: a call costs the host one ctypes call.

Nothing here builds or launches at import time: this module is
imported on machines with no ``nvcc`` and no card, where only the
plain versions run.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, NamedTuple, Optional

from torch.autograd import _profiler_enabled

__all__ = ["SOURCES", "Kernel", "KERNELS", "LAUNCHES", "BUILD_LOG",
           "reset_launches", "build_all", "library", "launch",
           "stream_key", "check_cuda_tensor"]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"

# library name -> source file under csrc/
SOURCES = {
    "bitonic_sort": "bitonic_sort.cu",
    "searchsorted": "searchsorted.cu",
    "merge_rows": "merge_rows.cu",
    "merge_ranks": "merge_ranks.cu",
    "sort_partition": "sort_partition.cu",
    "radix_sort": "radix_sort.cu",
    "flash_attention": "flash_attention.cu",
}


class Kernel(NamedTuple):
    library: str    # the key of SOURCES that holds the kernel
    replaces: str   # the TPU kernel it ports: the reference's pallas_call


# kernel name -> where it lives and what it ports.  The pair sort, the
# argsort merge and the fused pair sort share their keys-only twins'
# sources (and networks); the bucketize histogram shares the search's.
KERNELS = {
    "bitonic_sort": Kernel("bitonic_sort", "src/repro/kernels/bitonic.py:224"),
    "bitonic_sort_kv": Kernel("bitonic_sort",
                              "src/repro/kernels/bitonic.py:254"),
    "searchsorted": Kernel("searchsorted",
                           "src/repro/kernels/bucketize.py:145"),
    "merge_rows": Kernel("merge_rows", "src/repro/kernels/bitonic.py:313"),
    "merge_rows_kv": Kernel("merge_rows", "src/repro/kernels/bitonic.py:321"),
    "merge_ranks": Kernel("merge_ranks", "src/repro/kernels/fused.py:286"),
    # the reference's ranks replayed on batch entries whose keys hold a
    # NaN, where the merge's order is not the reference's (ROADMAP C15)
    "merge_ranks_replay": Kernel("merge_ranks",
                                 "src/repro/kernels/fused.py:272"),
    "sort_partition": Kernel("sort_partition",
                             "src/repro/kernels/fused.py:87"),
    "sort_partition_kv": Kernel("sort_partition",
                                "src/repro/kernels/fused.py:118"),
    "radix_sort": Kernel("radix_sort", "src/repro/kernels/radix.py:235"),
    "bucketize_histogram": Kernel("searchsorted",
                                  "src/repro/kernels/bucketize.py:109"),
    "flash_attention": Kernel("flash_attention",
                              "src/repro/kernels/flash_attention.py:105"),
}

# No --use_fast_math and no -ftz: the kernels fold denormals themselves,
# in the bits domain, before every comparison (see csrc/network.cuh).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C entry point -> its argument types, the stream last; every
# entry point returns an int (cudaError_t).
_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
_FLASH = [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _F32, _I32,
          _I32, _P]
_SORT_SIGNATURES = {
    "bitonic_sort": [_P, _P, _P, _I64, _I64, _P],
    "searchsorted": [_P, _P, _P, _I64, _I64, _I64, _I64, _I32, _I64, _P],
    "bitonic_sort_kv": [_P] * 6 + [_I64, _I64, _P],
    "merge_rows": [_P, _P, _P, _I64, _I64, _I64, _P],
    "merge_rows_kv": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _P],
    "merge_ranks": [_P] * 11 + [_I64, _I64, _I64, _P],
    "sort_partition": [_P] * 5 + [_I64, _I64, _I64, _P],
    "sort_partition_kv": [_P] * 7 + [_I64, _I64, _I64, _P],
    "radix_sort": [_P] * 6 + [_I64, _I64, _I64, _P],
    "bucketize_histogram": [_P] * 5 + [_I64, _I64, _P],
}
# every sort-side kernel has one entry point per key dtype
SIGNATURES = {f"{fn}_{suffix}": args
              for fn, args in _SORT_SIGNATURES.items()
              for suffix in ("f32", "bf16", "i32")}
# the NaN replay: float keys only (int32 keys hold no NaN)
SIGNATURES.update({f"merge_ranks_replay_{suffix}": [_P] * 6 + [_I64] * 4
                   + [_P] for suffix in ("f32", "bf16")})
SIGNATURES.update({"flash_attention_f32": _FLASH,
                   "flash_attention_bf16": _FLASH,
                   "merge_ranks_cuts": [_I64, _I64, _I64],
                   "bucketize_histogram_workspace": [_I64],
                   "merge_rows_launch_lanes": [_I32, _I32]})
# entry points that return something other than a cudaError_t
RESTYPES = {"merge_ranks_cuts": ctypes.c_longlong,
            "bucketize_histogram_workspace": ctypes.c_longlong,
            "merge_rows_launch_lanes": ctypes.c_longlong}

# kernel name -> calls of its C entry point made through launch(); the
# counts the chip smoke run reads to show the main path went through each
# kernel.  A call is one launch for every kernel but three, each of which
# counts once a call: the rank merge launches its phases one after
# another (merge_ranks.cu: a memset of its NaN flags, phase A, then a
# cut and a merge kernel a level), the radix sort a memset and a kernel
# a pass, and the in-tile merge launches its global passes when a padded
# entry outgrows one block's shared memory (merge_rows.cu).  The query
# engine launches from several threads at once: a count is bumped under
# _COUNT_LOCK, as a Counter's += is not atomic across threads.
LAUNCHES: collections.Counter = collections.Counter()
_COUNT_LOCK = threading.Lock()
# kernel name -> {"seconds": build time, "ptxas": nvcc's -Xptxas -v}
BUILD_LOG: Dict[str, dict] = {}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# C entry point -> its ctypes function, resolved once (argtypes set)
_ENTRIES: Dict[str, ctypes._CFuncPtr] = {}
# torch's accessors of the current device and of a device's current
# stream as a raw handle, resolved at the first launch
_device = _raw_stream = None
# device index -> the one-element tensor a profiled launch fills first
_MARKERS: Dict[int, object] = {}


def reset_launches() -> None:
    with _COUNT_LOCK:
        LAUNCHES.clear()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built from source")


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet.

    One ``nvcc`` per source, all started together; waits for every one
    and raises with the compiler's output if any fails.  Returns
    :data:`BUILD_LOG`.
    """
    names = list(SOURCES) if names is None else list(names)
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / SOURCES[name])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out, time.perf_counter())
        failed = []
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                               "ptxas": log}
            if proc.returncode != 0:
                failed.append(f"--- {name} (exit {proc.returncode})\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return BUILD_LOG


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = RESTYPES.get(fn,
                                                            ctypes.c_int)
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return lib


def _stream_accessor():
    """The cheapest call that gives ``torch.cuda.current_stream()``'s raw
    handle: torch's own accessor of a device's current stream, which
    ``current_stream()`` wraps in a new ``Stream`` object on every call,
    applied to the current device."""
    import torch

    return torch._C._cuda_getDevice, torch._C._cuda_getCurrentRawStream


def stream_key() -> tuple:
    """(device index, raw handle) of the current stream: what a
    wrapper keys state by that calls on one stream must share."""
    device, raw_stream = _stream_accessor()
    index = device()
    return index, raw_stream(index)


def _entry(name: str, fn: str):
    """C entry point ``fn`` of kernel ``name``'s library, with its
    ``argtypes``; built, loaded and looked up on the first call only."""
    global _device, _raw_stream
    func = getattr(library(KERNELS[name].library), fn)
    _device, _raw_stream = _stream_accessor()
    _ENTRIES[fn] = func
    return func


def launch(name: str, fn: str, *args) -> None:
    """Call C entry point ``fn`` of kernel ``name`` on the current stream.

    ``name`` is a key of :data:`KERNELS`; ``args`` are the entry
    point's arguments before the stream: tensors' ``data_ptr()``,
    Python ints, and None for a null pointer.  Raises if the launch
    reports a CUDA error; counts the call under ``name`` otherwise.

    While torch.profiler records, the call runs inside a
    ``repro:launch:<name>`` range, after a one-element fill on the same
    stream (:func:`_profiled_call`).
    """
    func = _ENTRIES.get(fn) or _entry(name, fn)
    if _profiler_enabled():
        rc = _profiled_call(name, func, args)
    else:
        rc = func(*args, _raw_stream(_device()))
    if rc:
        lib = library(KERNELS[name].library)
        raise RuntimeError(f"{fn}: CUDA error {rc} "
                           f"({lib.error_string(rc).decode()})")
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _profiled_call(name: str, func, args) -> int:
    """A C call while torch.profiler records.  The kernels, memsets and
    copies it issues reach the profiler with no correlation to a host
    event (``ctypes`` calls a cudart that the profiler does not trace).
    So the call runs inside a ``repro:launch:<name>`` range, after a
    one-element fill (a torch op, which the profiler correlates) on the
    same stream: on the device, the events with no correlation that
    follow the fill are this call's."""
    import torch

    from ..obs.trace import profiler_range

    index = _device()
    marker = _MARKERS.get(index)
    if marker is None:
        marker = _MARKERS[index] = torch.zeros(
            1, dtype=torch.int32, device=torch.device("cuda", index))
    with profiler_range("launch:" + name):
        marker.fill_(1)
        return func(*args, _raw_stream(index))


def check_cuda_tensor(name: str, x, dtypes) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of an allowed dtype."""
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: the CUDA kernel takes {sorted(map(str, dtypes))}, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
