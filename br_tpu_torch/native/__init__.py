"""ctypes bindings of the port's native host engine (``br_native.cpp``).

The engine corrects, on the host, the reads the device does not finish:
``Torch3Corrector`` hands it the impure reads, the reads too long for a
chunk and those capped after the wide retry.  ``NativeCorrector`` mirrors
the rayon pipeline of the reference: a thread pool corrects a batch of
reads in parallel (the C call releases the GIL) and collects them in
order (src/lib.rs:93-132).  The library is built by ``build.build`` at
first use; a build or load that fails raises.

A ``SolidSet`` goes in by ``br_create_solid`` (its bitfield), a
``HashSet`` by ``br_create_hash`` (its sorted canonical k-mers, passed by
pointer; the engine keeps its own hash set of them).
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_KIND = {"one": 0, "two": 1, "graph": 2, "greedy": 3, "gap-size": 4}

#: loaded libraries by path
_LIBS: dict = {}


def get_lib():
    """The engine's library, built and loaded at first use."""
    from br_tpu_torch.native.build import build

    path = build()
    lib = _LIBS.get(path)
    if lib is None:
        lib = ctypes.CDLL(path)
        lib.br_create_solid.restype = ctypes.c_void_p
        lib.br_create_solid.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                        ctypes.c_int]
        lib.br_create_hash.restype = ctypes.c_void_p
        lib.br_create_hash.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                       ctypes.c_int]
        lib.br_destroy.argtypes = [ctypes.c_void_p]
        lib.br_correct.restype = ctypes.c_long
        lib.br_correct.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_long]
        _LIBS[path] = lib
    return lib


class NativeCorrector:
    """Host batch corrector over the native engine, on ``threads`` threads
    (0: one a core)."""

    def __init__(self, valid_kmer, corrections, confirm: int, max_search: int,
                 threads: int = 0):
        from br_tpu_torch.set.hash import HashSet
        from br_tpu_torch.set.solid import SolidSet

        self._lib = get_lib()
        self.k = valid_kmer.k
        # the engine copies the set from the array (the bitfield, 1 GiB at
        # k = 17; or the sorted k-mers, into its own hash set)
        if isinstance(valid_kmer, SolidSet):
            bits = np.ascontiguousarray(valid_kmer.bits)
            self._ctx = self._lib.br_create_solid(bits.ctypes.data,
                                                  bits.nbytes, self.k)
        elif isinstance(valid_kmer, HashSet):
            kmers = np.ascontiguousarray(valid_kmer.sorted_table(),
                                         dtype=np.uint64)
            self._ctx = self._lib.br_create_hash(kmers.ctypes.data,
                                                 kmers.size, self.k)
        else:
            raise TypeError("NativeCorrector needs a br_tpu_torch SolidSet "
                            "or HashSet")
        kinds = [_KIND[c.lower().replace("_", "-")] for c in corrections]
        self._kinds = (ctypes.c_int * len(kinds))(*kinds)
        self._n = len(kinds)
        self.confirm = confirm
        self.max_search = max_search
        self.threads = threads or os.cpu_count()
        self._pool = ThreadPoolExecutor(max_workers=self.threads)

    def _one(self, seq: bytes, two_side: bool) -> bytes:
        cap = len(seq) * 2 + 256
        out = ctypes.create_string_buffer(cap)
        n = self._lib.br_correct(self._ctx, seq, len(seq), self._kinds,
                                 self._n, self.confirm, self.max_search,
                                 int(two_side), out, cap)
        if n < 0:  # grow and retry
            cap = -n + 16
            out = ctypes.create_string_buffer(cap)
            n = self._lib.br_correct(self._ctx, seq, len(seq), self._kinds,
                                     self._n, self.confirm, self.max_search,
                                     int(two_side), out, cap)
        return out.raw[:n]

    def correct_batch(self, seqs, two_side: bool):
        return list(self._pool.map(lambda s: self._one(s, two_side), seqs))

    def __del__(self):  # pragma: no cover
        if getattr(self, "_ctx", None):
            self._lib.br_destroy(self._ctx)
            self._ctx = None
