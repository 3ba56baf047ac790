"""Capacities and codes a correction pass shares with its kernels.

They keep the JAX package's values (br_tpu/correct/engine3.py:77-147,
:237-240, :1096, :1361-1363) so that cap flags and ``aux`` counters
compare one to one; the numbers the kernels need are compiled into
``br_tpu_torch/csrc/common.cuh`` and ``sites_common.cuh``.
"""

from typing import NamedTuple

#: "no position / no record" marker (rec_p, s_pos).
BIG = 1 << 30
#: repair records per site (applied repairs in one dirty chain).
SLOTS = 8
#: most read slots a chunk may have (the kernels stage rstart/rlen in
#: shared memory).
MAX_R = 1024
#: per-site cap reasons (aux entries 1-3).
CAP_OVERFLOW, CAP_ATTEMPT, CAP_ROUNDS = 1, 2, 4
#: dirty-simulation outcomes.
DONE_PURE, DONE_END, PENDING = 0, 1, 2
#: de Bruijn walk bound of the default profile (engine3.py:81): accepts
#: and fills longer than the profile's walk_max cap the site.
WALK_MAX = 248
#: 2-bit bases per 32-bit emit word.
BPW = 16
#: emit words per walk record: WALK_MAX + 1 bases.
EW_WALK = (WALK_MAX + 1 + BPW - 1) // BPW
#: the wide walk profile's bound (engine3.py:122); its retry sibling
#: budgets a full walk emit of slot headroom per read.
WIDE_WALK_MAX = 2040
#: steps past which a walk beyond walk_max caps (engine3.py:1096).
T3_CAP = 1 << 14
#: walk outcomes (engine3.py:143).
RUN, ACCEPT, DECLINE, CAP = 0, 1, 2, 3


class WalkProfile(NamedTuple):
    """Engineering bounds of the de Bruijn walks of one pass."""

    walk_max: int   # steps before a walk caps
    ew: int         # emit words per walk record (walk_max + 1 bases)


def walk_profile(walk_max: int) -> WalkProfile:
    """The profile of a walk bound (engine3.py:111-115, without the JAX
    tiers' history and lane widths, which the port has no use for)."""
    if not 1 <= walk_max < T3_CAP:
        raise ValueError(f"walk_max must be in 1..{T3_CAP - 1}, got "
                         f"{walk_max}")
    return WalkProfile(walk_max, (walk_max + 1 + BPW - 1) // BPW)


def emit_words(strategy: str, ew_walk: int = EW_WALK) -> int:
    """Emit words per repair record of a strategy (engine3.py:237-240)."""
    return {"one": 1, "two": 1, "greedy": 1,
            "graph": ew_walk, "gap-size": ew_walk}[strategy]


def site_capacity(chunk: int) -> int:
    """NS: listed attempt sites per chunk (engine3.py:1361); also the
    visited-record capacity NR."""
    return max(2048, chunk // 32)


def check_slots(rstart) -> None:
    """The kernels stage the slot table in shared memory: at most MAX_R
    slots per chunk (the last axis of a group's (NC, R) table)."""
    if not 1 <= rstart.shape[-1] <= MAX_R:
        raise ValueError(f"1..{MAX_R} read slots per chunk, got "
                         f"{rstart.shape[-1]}")
