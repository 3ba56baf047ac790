"""The reference's corrections of chosen reads, in worker processes.

``correct_reads`` counts the solid set from every read of the corpus
(``kmers.solid_canonical``), then corrects the chosen reads with the
frozen oracle (``oracle.correct_read``) in ``workers`` processes started
with ``spawn`` (a worker that dies raises ``BrokenProcessPool``): each
imports only this package and NumPy, and reports
the top-level names of the modules it holds, so the caller can show that
no worker imported the program or JAX.
"""

from __future__ import annotations

import multiprocessing
import sys
from concurrent.futures import ProcessPoolExecutor

from portbench.reference import kmers, oracle

_STATE: dict = {}


def _init(k: int, canonical, chain, confirm: int, max_search: int,
          two_side: bool) -> None:
    valid = kmers.ForwardSet(k, canonical)
    _STATE["methods"] = oracle.build_methods(chain, valid, confirm,
                                             max_search)
    _STATE["two_side"] = two_side


def _correct(item):
    i, seq = item
    out = oracle.correct_read(seq, _STATE["methods"], _STATE["two_side"])
    return i, out, sorted(top_level_modules())


def top_level_modules() -> set:
    """The top-level names of the modules this process holds."""
    return {m.split(".")[0] for m in sys.modules}


def correct_reads(seqs, chosen, k: int, abundance: int, chain, confirm: int,
                  max_search: int, two_side: bool, workers: int):
    """({index: corrected read} for the indices ``chosen`` of ``seqs``,
    the top-level module names the workers held).  The solid set is
    counted from all of ``seqs``."""
    solid = kmers.solid_canonical(seqs, k, abundance)
    items = sorted(((i, seqs[i]) for i in set(chosen)),
                   key=lambda it: -len(it[1]))
    if not items:
        return {}, set()
    out, names = {}, set()
    with ProcessPoolExecutor(
            min(workers, len(items)),
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_init,
            initargs=(k, solid, list(chain), confirm, max_search,
                      two_side)) as pool:
        for i, fixed, mods in pool.map(_correct, items):
            out[i] = fixed
            names.update(mods)
    return out, names
