"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is a plain C entry point of one CUDA C++ source under
``br_tpu_torch/csrc``; a source may hold several.  The k-mer kernels have
three instantiations (``variant``): for a solid bitfield, one for 32-bit
registers (k <= 15) and one named ``<name>64`` for 64-bit registers
(k = 17); for the sorted table of a ``HashSet``, one named ``<name>_h``
(64-bit registers, a bucketed search, any k <= 31), whose entry point
takes the table's bucket index (``device_codec.SortedTable``: the
offsets, the table's entry count, ``shift`` and ``bucket_levels``) as its
last arguments before the stream.  K8 has a count and a pack kernel; K9
``hash_probe`` is the sorted-table probe on its own; K10
``merge_counts`` merges several shards' K8 counters; K11 unpacks
(``unpack_codes``) and packs (``pack_codes``) a chunk's 2-bit codes.
At first use a source is compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library under ``<repo>/build/kernels`` (git-ignored) and
loaded with ``ctypes``; every pointer and the stream pass as
``c_void_p``.
``build_all`` starts one ``nvcc`` per source, all at once.  Libraries are
named by a hash of their source, headers and flags, so an edited source
is rebuilt.  Under BR_BOUNDS_CHECK=1 the libraries are the checked build
(``CHECKED_FLAGS``), named apart.

The chain's kernels (``CHUNKED``: K1-K7) take a group of NC chunks of
one geometry in one launch: their entry points' first argument is NC,
and their wrappers take a chunk's arrays with a leading axis of NC
chunks, or without it for one chunk (NC = 1).  K11's entry points take a
flat length, a whole group's codes.

``LAUNCHES`` counts, per kernel name, the device launches its wrapper
made; a wrapper adds them right after its entry point launched and
nowhere else (two for ``chain_splice``, whose entry point launches a walk
kernel and a copy kernel).  Nothing here imports or builds anything when
the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from br_tpu_torch.correct import device_codec as dc

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

#: kernel name -> (source file, C entry point, argtypes letters:
#: p = pointer/stream (c_void_p), i = int (c_int), l = c_longlong).  A
#: chain kernel's first letter is its NC.
KERNELS = {
    "dense_probe": ("dense_probe.cu", "br_dense_probe", "i" + "pppp"
                    + "iiii" + "ppppppp" + "pp" + "p"),
    "one_sites": ("one_sites.cu", "br_one_sites", "i" + "pppppppiiiii"
                  + "pppppp" + "p"),
    "chain_splice": ("chain_splice.cu", "br_chain_splice",
                     "i" + "ppp" + "pppp" + "pppp" + "p" + "iiii"
                     + "pp" + "ppppp" + "p"),
    "reverse_slots": ("reverse_slots.cu", "br_reverse_slots",
                      "i" + "pppp" + "ii" + "p"),
    "two_sites": ("two_sites.cu", "br_two_sites", "i" + "pppppppiiiii"
                  + "pppppp" + "p"),
    "walk_sites": ("walk_sites.cu", "br_walk_sites", "i" + "pppppppp"
                   + "iiiiiiii" + "pppppp" + "p"),
    "greedy_sites": ("greedy_sites.cu", "br_greedy_sites", "i" + "ppppppp"
                     + "iiiiii" + "pppppp" + "p"),
    "solid_count": ("solid_build.cu", "br_solid_count", "plpilill" + "ii"
                    + "p" + "p"),
    "solid_pack": ("solid_build.cu", "br_solid_pack", "pliipi" + "p"),
    "hash_probe": ("hash_probe.cu", "br_hash_probe", "ppiii" + "pli" + "p"
                   + "p"),
    "merge_counts": ("merge_counts.cu", "br_merge_counts", "pilii" + "p"
                     + "p"),
    "unpack_codes": ("pack_codes.cu", "br_unpack_codes", "plp" + "p"),
    "pack_codes": ("pack_codes.cu", "br_pack_codes", "plp" + "p"),
}
#: the 64-bit instantiations (a bitfield at k = 17) of the k-mer kernels:
#: the same source and arguments, entry point ``<entry>64``.
WIDE = ("dense_probe", "one_sites", "two_sites", "walk_sites",
        "greedy_sites", "solid_count")
#: the sorted-table instantiations: entry point ``<entry>_h``, with the
#: bucket index (``SORTED_ARGS``) before the stream.
HASHED = ("dense_probe", "one_sites", "two_sites", "walk_sites",
          "greedy_sites")
KERNELS.update({f"{n}64": (KERNELS[n][0], KERNELS[n][1] + "64",
                           KERNELS[n][2]) for n in WIDE})
#: a sorted table's trailing arguments: the index offsets, the table's
#: entry count, shift and bucket_levels
SORTED_ARGS = "piii"
KERNELS.update({f"{n}_h": (KERNELS[n][0], KERNELS[n][1] + "_h",
                           KERNELS[n][2][:-1] + SORTED_ARGS + "p")
                for n in HASHED})

#: device kernels an entry point launches per call, where more than one.
PER_CALL = {"chain_splice": 2}

#: the chain's kernels, which take a group of NC chunks (first argument)
CHUNKED = ("dense_probe", "one_sites", "two_sites", "walk_sites",
           "greedy_sites", "chain_splice", "reverse_slots")
#: the most chunks of a group (a launch's grid.y)
MAX_NC = 65535

#: device launches per kernel since the last ``reset_launches``.
LAUNCHES = {name: 0 for name in KERNELS}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: the checked build's flags (``BR_CHECK`` in csrc/common.cuh), added
#: where the environment sets BR_BOUNDS_CHECK=1
CHECKED_FLAGS = ["-DBR_BOUNDS_CHECK", "-lineinfo"]

_LIBS: dict = {}
#: nvcc's report per kernel (registers, shared memory, spills).
BUILD_LOG: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU, where the CUDA toolkit is")


def variant(name: str, k: int, kind: str = "solid") -> str:
    """The kernel name of ``name``'s instantiation for k and a set of
    ``kind``: ``<name>_h`` for a sorted table, else the 64-bit one past
    ``MAX_K32``."""
    if kind == "hash":
        return f"{name}_h"
    return f"{name}64" if k > dc.MAX_K32 else name


def table_kernel(name: str, k: int, table) -> tuple:
    """(kernel name, table tensor, trailing arguments) of k-mer kernel
    ``name`` for a device table: for a ``SortedTable`` the ``_h``
    instantiation, its entries and ``sorted_args``; for bitfield words
    the bitfield's instantiation, the words and none."""
    kind = dc.table_kind(table)
    if kind == "hash":
        return variant(name, k, kind), table.table, sorted_args(table)
    return variant(name, k, kind), table, ()


def sorted_args(table) -> tuple:
    """A ``SortedTable``'s arguments after the table (``SORTED_ARGS``):
    the index offsets, the table's entry count, shift, bucket_levels."""
    return (table.starts, table.table.shape[0], table.shift,
            table.bucket_levels)


def check_table(table, k: int, device) -> None:
    """Raise unless ``table`` is a device table for k on ``device``:
    int32 bitfield words, 2^(2k-1) bits, one per canonical k-mer; or a
    ``SortedTable`` (``HashSet.device_table``'s power of two int64
    entries), its index built for k, its int32 offsets 8-byte aligned
    (the kernels read a bucket's two offsets in one load where they
    can)."""
    if dc.table_kind(table) == "solid":
        check(table, "table", torch.int32, device)
        if table.shape[0] < max(1, (1 << (2 * k - 1)) // 32):
            raise ValueError(f"table has {table.shape[0]} words, too few "
                             f"for k={k}")
        return
    check(table.table, "table", torch.int64, device)
    check(table.starts, "starts", torch.int32, device)
    n, nb = table.table.shape[0], table.buckets
    if n < 1 or n & (n - 1):
        raise ValueError(f"sorted table has {n} entries, not a power of "
                         "two")
    if nb < 1 or nb & (nb - 1):
        raise ValueError(f"bucket index has {nb} + 1 offsets, not a power "
                         "of two + 1")
    if table.shift != 2 * k - (nb.bit_length() - 1):
        raise ValueError(f"bucket index of shift {table.shift} and {nb} "
                         f"buckets was not built for k={k}")
    if not 0 <= table.bucket_levels <= 31:
        raise ValueError(f"bucket_levels {table.bucket_levels}")
    if table.starts.data_ptr() % 8:
        raise ValueError("bucket index offsets not 8-byte aligned")


def nvcc_flags() -> list:
    """``NVCC_FLAGS``, with ``CHECKED_FLAGS`` under BR_BOUNDS_CHECK=1."""
    if os.environ.get("BR_BOUNDS_CHECK") == "1":
        return NVCC_FLAGS + CHECKED_FLAGS
    return NVCC_FLAGS


def _lib_path(src: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / src]:
        h.update(p.read_bytes())
    h.update(" ".join(nvcc_flags()).encode())
    return BUILD_DIR / f"lib{Path(src).stem}_{h.hexdigest()[:12]}.so"


def sources(names=None) -> list:
    """The sources of the named kernels (all by default), each once."""
    names = list(KERNELS) if names is None else list(names)
    return list(dict.fromkeys(KERNELS[n][0] for n in names))


def build_all(names=None) -> float:
    """Compile every source of the named kernels not yet built, one nvcc
    process per source, all started together; returns the wall seconds
    spent.  ``BUILD_LOG`` gets nvcc's report per source."""
    todo = [s for s in sources(names) if not _lib_path(s).exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *nvcc_flags(), "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / n)]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong}


def bind(lib, names) -> None:
    """Set the argument and result types of the named kernels' entry
    points, and of the error text, in a loaded library."""
    for n in names:
        _src, entry, sig = KERNELS[n]
        fn = getattr(lib, entry)
        fn.argtypes = [_CTYPES[ch] for ch in sig]
        fn.restype = ctypes.c_int
    lib.br_error_string.argtypes = [ctypes.c_int]
    lib.br_error_string.restype = ctypes.c_char_p


def library(name: str):
    """The loaded ctypes library of one kernel's source (built at first
    use), shared by every kernel of that source."""
    src = KERNELS[name][0]
    lib = _LIBS.get(src)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(src)))
        bind(lib, [n for n in KERNELS if KERNELS[n][0] == src])
        _LIBS[src] = lib
    return lib


def launch(name: str, *args) -> None:
    """Call a kernel's C entry point, tensors passed as device pointers
    and PyTorch's current stream of their device appended, with that
    device current (a launch goes to the current device: a shard's
    kernel on another card than the current one would not find its
    memory); count its launches; raise on a CUDA error (the entry point
    returns ``cudaGetLastError()``)."""
    lib = library(name)
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    fn = getattr(lib, KERNELS[name][1])
    if dev.index is None or dev.index == torch.cuda.current_device():
        err = fn(*cargs, stream_of(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*cargs, stream_of(dev))
    if err != 0:
        msg = lib.br_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} ({err})")
    LAUNCHES[name] += PER_CALL.get(name, 1)


def on_cuda(t) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); any other device is refused."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: the port runs on "
                     "cuda, or on the cpu when asked")


def check(t, name: str, dtype, device, length: int | None = None,
          lead: tuple = ()) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` on
    ``device`` of shape ``lead + (n,)``, n ``length`` where given: a 1-D
    tensor by default, a chunk's row of each of a group's chunks with
    ``lead = (NC,)``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if (t.dim() != len(lead) + 1 or tuple(t.shape[:-1]) != tuple(lead)
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous tensor of shape "
                         f"{tuple(lead)} + (n,), got {tuple(t.shape)}")
    if length is not None and t.shape[-1] != length:
        raise ValueError(f"{name} has length {t.shape[-1]}, expected "
                         f"{length}")


def group_lead(codes) -> tuple:
    """The leading axes of a chain kernel's arguments, from its codes:
    () for one chunk ((CHUNK,) codes), (NC,) for a group ((NC, CHUNK))."""
    if codes.dim() == 1:
        return ()
    if codes.dim() == 2 and 1 <= codes.shape[0] <= MAX_NC:
        return (codes.shape[0],)
    raise ValueError(f"codes of shape {tuple(codes.shape)}: one chunk "
                     f"(CHUNK,) or a group of 1..{MAX_NC} chunks "
                     "(NC, CHUNK)")


def group_nc(lead: tuple) -> int:
    """A chain kernel's NC argument for arguments of leading axes
    ``lead``."""
    return lead[0] if lead else 1


def _like(t: tuple, items):
    """A tuple of ``t``'s type (a NamedTuple's too) holding ``items``."""
    items = tuple(items)
    return t._make(items) if hasattr(t, "_make") else items


def chunk_of(x, i: int):
    """Chunk i of a group's tensor, or of every tensor of a tuple."""
    if isinstance(x, tuple):
        return _like(x, (chunk_of(f, i) for f in x))
    return x[i]


def stack_chunks(outs: list):
    """Chunks' results (tensors, or tuples of them) as a group's:
    stacked along a new leading axis."""
    if isinstance(outs[0], tuple):
        return _like(outs[0], (stack_chunks(list(f)) for f in zip(*outs)))
    return torch.stack(outs)


def each_chunk(plain, before: tuple, chunked: tuple, after: tuple = ()):
    """A plain version over a group: ``plain(*before, *chunk i of each of
    chunked, *after)`` for every chunk, stacked (``stack_chunks``); for
    one chunk (its codes, ``chunked[0]``, 1-D) the one call."""
    lead = group_lead(chunked[0])
    if not lead:
        return plain(*before, *chunked, *after)
    return stack_chunks([plain(*before, *(chunk_of(x, i) for x in chunked),
                               *after) for i in range(lead[0])])


def stream_of(device) -> int:
    """The raw CUDA stream PyTorch launches on for ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
