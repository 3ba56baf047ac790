"""Scalar oracle: exact re-statement of natir/br's correction semantics.

The benchmark's frozen copy of ``br_tpu_torch.correct.reference`` (only
its imports changed): the per-read scan machine, the Exist scenario
framework and all five strategies (``one``, ``two``, ``graph``,
``greedy``, ``gap-size``).  Every function cites the reference construct
it mirrors (file:line into natir/br's sources).  ``valid_kmer`` is any
object with ``k`` and ``get(kmer)``: here ``kmers.ForwardSet``.

Semantics notes (load-bearing quirks, from SURVEY §3/§7.3):

* the scan only fires a repair on a valid->invalid edge
  (src/correct/mod.rs:73);
* every ``correct_error`` demands *exactly one* alternative last base
  (exist/mod.rs:123, graph.rs:52, greedy.rs:131);
* scenario iteration order is enum declaration order (one.rs:34-38,
  two.rs:35-50) and ties are broken by the ``one_more`` c+1 probe
  (exist/mod.rs:140-147);
* ScenarioTwo::DCI falls through to the default ``correct`` arm and emits
  nothing while consuming 1 (two.rs:323);
* the second pass runs on the plain-reversed (NOT complemented) bytes, and
  runs when ``--two-side`` is ABSENT (src/lib.rs:110-117).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from portbench.reference import codec
from portbench.reference.alignment import global_align_ops, OP_MATCH, OP_SUBST, OP_DEL, OP_INS


# ---------------------------------------------------------------------------
# Shared helpers (reference src/correct/mod.rs:110-152)
# ---------------------------------------------------------------------------


def add_nuc_to_end(kmer: int, nuc: int, k: int) -> int:
    return ((kmer << 2) & codec.mask(k)) ^ nuc


def next_nucs(valid_kmer, kmer: int) -> List[int]:
    """Valid successor bases of a (k-1-suffix of a) k-mer (mod.rs:118-128)."""
    k = valid_kmer.k
    return [alt for alt in range(4) if valid_kmer.get(add_nuc_to_end(kmer, alt, k))]


def alt_nucs(valid_kmer, ori: int) -> List[int]:
    """Alternative last bases for an invalid k-mer (mod.rs:114-116)."""
    return next_nucs(valid_kmer, ori >> 2)


def error_len(subseq: bytes, kmer: int, valid_kmer) -> Tuple[int, int]:
    """Advance until the rolling k-mer becomes valid again (mod.rs:130-152).

    Starts from ``subseq[1]`` (``subseq[0]`` is already absorbed in ``kmer``).
    Returns (j, kmer) where j >= 1.
    """
    k = valid_kmer.k
    j = 0
    while True:
        j += 1
        if j >= len(subseq):
            break
        kmer = add_nuc_to_end(kmer, codec.nuc2bit(subseq[j]), k)
        if valid_kmer.get(kmer):
            break
    return j, kmer


# ---------------------------------------------------------------------------
# Corrector base: the per-read scan state machine (mod.rs:44-108)
# ---------------------------------------------------------------------------


class Corrector:
    """Rolling-scan state machine; subclasses provide ``correct_error``."""

    def __init__(self, valid_kmer):
        self.valid_kmer = valid_kmer

    @property
    def k(self) -> int:
        return self.valid_kmer.k

    def correct_error(self, kmer: int, seq: bytes) -> Optional[Tuple[bytes, int]]:
        raise NotImplementedError

    def correct(self, seq: bytes) -> bytes:
        """The hot loop (mod.rs:53-107)."""
        k = self.k
        if len(seq) < k:
            return bytes(seq)

        out = bytearray(seq[:k])
        i = k
        kmer = codec.seq2bit(seq[:k])
        previous = self.valid_kmer.get(kmer)

        while i < len(seq):
            nuc = seq[i]
            kmer = add_nuc_to_end(kmer, codec.nuc2bit(nuc), k)

            if not self.valid_kmer.get(kmer) and previous:
                res = self.correct_error(kmer, seq[i:])
                if res is not None:
                    local_correct, offset = res
                    kmer >>= 2
                    for c in local_correct:
                        kmer = add_nuc_to_end(kmer, codec.nuc2bit(c), k)
                        out.append(c)
                    previous = True
                    i += offset
                else:
                    out.append(nuc)
                    i += 1
                    previous = False
            else:
                previous = self.valid_kmer.get(kmer)
                out.append(nuc)
                i += 1

        return bytes(out)


# ---------------------------------------------------------------------------
# Exist framework: scenario enumeration engine (exist/mod.rs:12-150)
# ---------------------------------------------------------------------------


class Scenario:
    """One candidate error shape; see exist/mod.rs:12-71."""

    c: int
    k: int

    def apply(self, valid_kmer, kmer: int, seq: bytes) -> Optional[Tuple[int, int]]:
        raise NotImplementedError

    def correct(self, valid_kmer, kmer: int, seq: bytes) -> Tuple[List[int], int]:
        raise NotImplementedError

    def get_score(self, valid_kmer, ori: int, seq: bytes) -> int:
        """Count consecutive valid k-mers over the next c bases
        (exist/mod.rs:21-47)."""
        applied = self.apply(valid_kmer, ori, seq)
        if applied is None:
            return 0
        kmer, offset = applied
        if not valid_kmer.get(kmer):
            return 0
        if offset + self.c > len(seq):
            return 0
        score = 0
        for nuc in seq[offset : offset + self.c]:
            kmer = add_nuc_to_end(kmer, codec.nuc2bit(nuc), valid_kmer.k)
            if valid_kmer.get(kmer):
                score += 1
            else:
                break
        return score

    def one_more(self, valid_kmer, kmer: int, seq: bytes) -> bool:
        """c+1 tie-break (exist/mod.rs:49-70)."""
        corr, offset = self.correct(valid_kmer, kmer, seq)
        if len(seq) > self.c + offset + 1:
            kmer >>= 2
            for nuc in corr:
                kmer = add_nuc_to_end(kmer, codec.nuc2bit(nuc), valid_kmer.k)
            for nuc in seq[offset : offset + self.c + 1]:
                kmer = add_nuc_to_end(kmer, codec.nuc2bit(nuc), valid_kmer.k)
            return valid_kmer.get(kmer)
        return False


class Exist(Corrector):
    """Enumerate scenarios, keep perfect scores, tie-break (exist/mod.rs:76-150)."""

    scenario_types: Sequence[type] = ()

    def __init__(self, valid_kmer, c: int):
        super().__init__(valid_kmer)
        self.c = c

    def _get_scenarii(self, kmer: int, seq: bytes) -> List[Scenario]:
        out = []
        for styp in self.scenario_types:
            scenario = styp(self.c, self.k)
            if scenario.get_score(self.valid_kmer, kmer, seq) == self.c:
                out.append(scenario)
        return out

    def correct_error(self, kmer: int, seq: bytes) -> Optional[Tuple[bytes, int]]:
        alts = alt_nucs(self.valid_kmer, kmer)
        if len(alts) != 1:
            return None
        corr = add_nuc_to_end(kmer >> 2, alts[0], self.k)
        scenarii = self._get_scenarii(corr, seq)

        if not scenarii:
            return None
        if len(scenarii) == 1:
            bases, offset = scenarii[0].correct(self.valid_kmer, corr, seq)
            return bytes(bases), offset
        scenarii = [s for s in scenarii if s.one_more(self.valid_kmer, corr, seq)]
        if len(scenarii) == 1:
            bases, offset = scenarii[0].correct(self.valid_kmer, corr, seq)
            return bytes(bases), offset
        return None


# -- One: single-error scenarios I, S, D (exist/one.rs:33-74) ----------------


class _ScenarioOneBase(Scenario):
    #: (apply offset == correct offset) per variant; emit = corrected last base.
    offset: int

    def __init__(self, c: int, k: int):
        self.c = c
        self.k = k

    def apply(self, valid_kmer, kmer, seq):
        return (kmer, self.offset)

    def correct(self, valid_kmer, kmer, seq):
        return ([codec.bit2nuc(kmer & 0b11)], self.offset)


class ScenarioOneI(_ScenarioOneBase):
    offset = 2  # one.rs:59,67


class ScenarioOneS(_ScenarioOneBase):
    offset = 1  # one.rs:60,68


class ScenarioOneD(_ScenarioOneBase):
    offset = 0  # one.rs:61,69


class One(Exist):
    scenario_types = (ScenarioOneI, ScenarioOneS, ScenarioOneD)


# -- Two: 13 two-error scenarios (exist/two.rs:34-328) -----------------------


class _ScenarioTwoBase(Scenario):
    def __init__(self, c: int, k: int):
        self.c = c
        self.k = k

    # default `correct` arm (two.rs:323): emit nothing, consume 1.
    def correct(self, valid_kmer, kmer, seq):
        return ([], 1)

    def _emit_last(self, corr: int, n: int) -> List[int]:
        """Last n bases of a k-mer, in order (two.rs:267-316)."""
        return [codec.bit2nuc((corr >> (2 * (n - 1 - t))) & 0b11) for t in range(n)]


class ScenarioTwoII(_ScenarioTwoBase):
    def apply(self, valid_kmer, kmer, seq):
        return (kmer, 3)  # two.rs:96

    def correct(self, valid_kmer, kmer, seq):
        return ([codec.bit2nuc(kmer & 0b11)], 2)  # two.rs:260


class ScenarioTwoIS(_ScenarioTwoBase):
    def apply(self, valid_kmer, kmer, seq):
        return (kmer, 2)  # two.rs:97

    def correct(self, valid_kmer, kmer, seq):
        return ([codec.bit2nuc(kmer & 0b11)], 2)  # two.rs:261


class ScenarioTwoSS(_ScenarioTwoBase):
    def apply(self, valid_kmer, kmer, seq):
        # two.rs:98-114
        if len(seq) < 2:
            return None
        k = self.k
        kmer = add_nuc_to_end(kmer, codec.nuc2bit(seq[1]), k)
        if valid_kmer.get(kmer):
            return None
        alts = alt_nucs(valid_kmer, kmer)
        if len(alts) != 1:
            return None
        return (add_nuc_to_end(kmer >> 2, alts[0], k), 2)

    def correct(self, valid_kmer, kmer, seq):
        corr, offset = self.apply(valid_kmer, kmer, seq)  # two.rs:262-274
        return (self._emit_last(corr, 2), offset)


class ScenarioTwoSD(_ScenarioTwoBase):
    def apply(self, valid_kmer, kmer, seq):
        # two.rs:115-126
        if len(seq) == 0:
            return None
        alts = alt_nucs(valid_kmer, kmer << 2)
        if len(alts) != 1:
            return None
        return (add_nuc_to_end(kmer, alts[0], self.k), 1)

    def correct(self, valid_kmer, kmer, seq):
        corr, offset = self.apply(valid_kmer, kmer, seq)
        return (self._emit_last(corr, 2), offset)


class ScenarioTwoDD(_ScenarioTwoBase):
    def apply(self, valid_kmer, kmer, seq):
        # two.rs:127-134
        alts = alt_nucs(valid_kmer, kmer << 2)
        if len(alts) != 1:
            return None
        return (add_nuc_to_end(kmer, alts[0], self.k), 0)

    def correct(self, valid_kmer, kmer, seq):
        corr, offset = self.apply(valid_kmer, kmer, seq)
        return (self._emit_last(corr, 2), offset)


class ScenarioTwoICI(_ScenarioTwoBase):
    def apply(self, valid_kmer, kmer, seq):
        # two.rs:135-148
        if len(seq) < 4:
            return None
        corr = add_nuc_to_end(kmer, codec.nuc2bit(seq[3]), self.k)
        if valid_kmer.get(corr):
            return (corr, 4)
        return None

    def correct(self, valid_kmer, kmer, seq):
        return ([codec.bit2nuc(kmer & 0b11)], 3)  # two.rs:275


class ScenarioTwoICS(_ScenarioTwoBase):
    def apply(self, valid_kmer, kmer, seq):
        # two.rs:149-166
        if len(seq) < 4:
            return None
        k = self.k
        kmer = add_nuc_to_end(kmer, codec.nuc2bit(seq[1]), k)
        if valid_kmer.get(kmer):
            return None
        alts = alt_nucs(valid_kmer, kmer)
        if len(alts) != 1:
            return None
        return (add_nuc_to_end(kmer >> 2, alts[0], k), 3)

    def correct(self, valid_kmer, kmer, seq):
        corr, offset = self.apply(valid_kmer, kmer, seq)  # two.rs:289-301
        return (self._emit_last(corr, 2), offset + 1)


class ScenarioTwoICD(_ScenarioTwoBase):
    def apply(self, valid_kmer, kmer, seq):
        # two.rs:167-181
        if len(seq) < 4:
            return None
        k = self.k
        second = add_nuc_to_end(kmer, codec.nuc2bit(seq[2]), k)
        alts = alt_nucs(valid_kmer, second << 2)
        if len(alts) != 1:
            return None
        return (add_nuc_to_end(second, alts[0], k), 3)

    def correct(self, valid_kmer, kmer, seq):
        corr, offset = self.apply(valid_kmer, kmer, seq)  # two.rs:276-288
        return (self._emit_last(corr, 2), offset - 1)


class ScenarioTwoSCI(_ScenarioTwoBase):
    def apply(self, valid_kmer, kmer, seq):
        # two.rs:182-191
        if len(seq) < 4:
            return None
        k = self.k
        kmer = add_nuc_to_end(kmer, codec.nuc2bit(seq[1]), k)
        kmer = add_nuc_to_end(kmer, codec.nuc2bit(seq[3]), k)
        return (kmer, 4)

    def correct(self, valid_kmer, kmer, seq):
        corr, offset = self.apply(valid_kmer, kmer, seq)  # two.rs:302-318
        return (self._emit_last(corr, 3), offset)


class ScenarioTwoSCS(_ScenarioTwoBase):
    def apply(self, valid_kmer, kmer, seq):
        # two.rs:192-215
        if len(seq) < 3:
            return None
        k = self.k
        kmer = add_nuc_to_end(kmer, codec.nuc2bit(seq[1]), k)
        if not valid_kmer.get(kmer):
            return None
        kmer = add_nuc_to_end(kmer, codec.nuc2bit(seq[2]), k)
        if valid_kmer.get(kmer):
            return None
        alts = alt_nucs(valid_kmer, kmer)
        if len(alts) != 1:
            return None
        return (add_nuc_to_end(kmer >> 2, alts[0], k), 3)

    def correct(self, valid_kmer, kmer, seq):
        corr, offset = self.apply(valid_kmer, kmer, seq)
        return (self._emit_last(corr, 3), offset)


class ScenarioTwoSCD(_ScenarioTwoBase):
    def apply(self, valid_kmer, kmer, seq):
        # two.rs:216-230
        if len(seq) < 2:
            return None
        k = self.k
        kmer = add_nuc_to_end(kmer, codec.nuc2bit(seq[1]), k)
        alts = alt_nucs(valid_kmer, kmer << 2)
        if len(alts) != 1:
            return None
        return (add_nuc_to_end(kmer, alts[0], k), 2)

    def correct(self, valid_kmer, kmer, seq):
        corr, offset = self.apply(valid_kmer, kmer, seq)
        return (self._emit_last(corr, 3), offset)


class ScenarioTwoDCI(_ScenarioTwoBase):
    def apply(self, valid_kmer, kmer, seq):
        # two.rs:231-240
        if len(seq) < 4:
            return None
        k = self.k
        kmer = add_nuc_to_end(kmer, codec.nuc2bit(seq[1]), k)
        kmer = add_nuc_to_end(kmer, codec.nuc2bit(seq[3]), k)
        return (kmer, 4)

    # DCI hits the default `correct` arm (two.rs:323): emit [], consume 1.


class ScenarioTwoDCD(_ScenarioTwoBase):
    def apply(self, valid_kmer, kmer, seq):
        # two.rs:241-254
        if len(seq) < 2:
            return None
        k = self.k
        kmer = add_nuc_to_end(kmer, codec.nuc2bit(seq[0]), k)
        alts = alt_nucs(valid_kmer, kmer << 2)
        if len(alts) != 1:
            return None
        return (add_nuc_to_end(kmer, alts[0], k), 1)

    def correct(self, valid_kmer, kmer, seq):
        corr, offset = self.apply(valid_kmer, kmer, seq)
        return (self._emit_last(corr, 3), offset)


class Two(Exist):
    # Declaration order = strum iteration order (two.rs:35-50).
    scenario_types = (
        ScenarioTwoII,
        ScenarioTwoIS,
        ScenarioTwoSS,
        ScenarioTwoSD,
        ScenarioTwoDD,
        ScenarioTwoICI,
        ScenarioTwoICS,
        ScenarioTwoICD,
        ScenarioTwoSCI,
        ScenarioTwoSCS,
        ScenarioTwoSCD,
        ScenarioTwoDCI,
        ScenarioTwoDCD,
    )


# ---------------------------------------------------------------------------
# Graph: unique-path de Bruijn traversal (graph.rs:29-86)
# ---------------------------------------------------------------------------


class Graph(Corrector):
    def correct_error(self, kmer: int, seq: bytes) -> Optional[Tuple[bytes, int]]:
        err_len, first_correct_kmer = error_len(seq, kmer, self.valid_kmer)

        viewed = set()
        local_corr = bytearray()

        alts = alt_nucs(self.valid_kmer, kmer)
        if len(alts) != 1:
            return None

        kmer = add_nuc_to_end(kmer >> 2, alts[0], self.k)
        local_corr.append(codec.bit2nuc(alts[0]))
        viewed.add(kmer)

        while self.valid_kmer.get(kmer):
            alts = next_nucs(self.valid_kmer, kmer)
            if len(alts) != 1:
                return None
            kmer = add_nuc_to_end(kmer, alts[0], self.k)
            if kmer in viewed:
                return None
            viewed.add(kmer)
            local_corr.append(codec.bit2nuc(alts[0]))
            if kmer == first_correct_kmer:
                break

        return bytes(local_corr), err_len + 1


# ---------------------------------------------------------------------------
# Greedy: bounded speculative walk + alignment acceptance (greedy.rs:41-173)
# ---------------------------------------------------------------------------


class Greedy(Corrector):
    def __init__(self, valid_kmer, max_search: int, nb_validate: int):
        super().__init__(valid_kmer)
        self.max_search = max_search
        self.nb_validate = nb_validate

    def _match_alignement(
        self, before_seq: bytes, read: bytes, corr: bytes
    ) -> Optional[int]:
        """greedy.rs:56-89 — global-align (before+read) vs (before+corr),
        accept at the first pair of consecutive Match ops, offset =
        (ins - del before the pair) - (trailing-indel correction)."""
        r = before_seq + read
        c = before_seq + bytes(corr)
        ops = global_align_ops(r, c)

        offset = 0
        tail = ops[len(before_seq):]
        for w in range(len(tail) - 1):
            op0, op1 = tail[w], tail[w + 1]
            if op0 == OP_DEL:
                offset -= 1
            elif op0 == OP_INS:
                offset += 1
            if op0 == OP_MATCH and op1 == OP_MATCH:
                offset_corr = 0
                for op in reversed(ops):
                    if op == OP_DEL:
                        offset_corr -= 1
                    elif op == OP_INS:
                        offset_corr += 1
                    else:
                        break
                return offset - offset_corr
        return None

    def _follow_graph(self, kmer: int) -> Optional[Tuple[int, int]]:
        alts = next_nucs(self.valid_kmer, kmer)
        if len(alts) != 1:
            return None
        kmer = add_nuc_to_end(kmer, alts[0], self.k)
        return codec.bit2nuc(alts[0]), kmer

    def _check_next_kmers(self, kmer: int, seq: bytes) -> bool:
        if len(seq) < self.nb_validate:
            return False
        for nuc in seq[: self.nb_validate]:
            kmer = add_nuc_to_end(kmer, codec.nuc2bit(nuc), self.k)
            if not self.valid_kmer.get(kmer):
                return False
        return True

    def correct_error(self, kmer: int, seq: bytes) -> Optional[Tuple[bytes, int]]:
        alts = alt_nucs(self.valid_kmer, kmer)
        if len(alts) != 1:
            return None

        viewed = set()
        local_corr = bytearray()
        before_seq = codec.kmer2seq(kmer >> 2, self.k - 1)

        kmer = add_nuc_to_end(kmer >> 2, alts[0], self.k)
        local_corr.append(codec.bit2nuc(alts[0]))
        viewed.add(kmer)

        for i in range(self.max_search):
            step = self._follow_graph(kmer)
            if step is not None:
                base, kmer = step
                local_corr.append(base)

            if kmer in viewed:
                return None
            viewed.add(kmer)

            if len(seq) < i:
                return None

            off = self._match_alignement(before_seq, seq[:i], local_corr)
            if off is not None:
                if self._check_next_kmers(kmer, seq[i:]):
                    offset = len(local_corr) + off
                    return bytes(local_corr), offset

        return None


# ---------------------------------------------------------------------------
# GapSize: measure the error region, dispatch (gap_size.rs:29-108)
# ---------------------------------------------------------------------------


class GapSize(Corrector):
    def __init__(self, valid_kmer, c: int):
        super().__init__(valid_kmer)
        self.graph = Graph(valid_kmer)
        self.one = One(valid_kmer, c)

    def ins_sub_correction(self, kmer: int, gap_size: int) -> Optional[Tuple[bytes, int]]:
        """gap_size.rs:44-89 — fill gap_size bases by unique-path walk."""
        alts = alt_nucs(self.valid_kmer, kmer)
        if len(alts) != 1:
            return None

        corr = add_nuc_to_end(kmer >> 2, alts[0], self.k)
        local_corr = bytearray([codec.bit2nuc(alts[0])])
        viewed = {corr}

        for _ in range(gap_size):
            alts = next_nucs(self.valid_kmer, corr)
            if len(alts) != 1:
                return None
            corr = add_nuc_to_end(corr, alts[0], self.k)
            if corr in viewed:
                return None
            viewed.add(corr)
            local_corr.append(codec.bit2nuc(alts[0]))

        return bytes(local_corr), len(local_corr)

    def correct_error(self, kmer: int, seq: bytes) -> Optional[Tuple[bytes, int]]:
        err_len, _ = error_len(seq, kmer, self.valid_kmer)
        if err_len < self.k:
            return self.graph.correct_error(kmer, seq)
        if err_len == self.k:
            return self.one.correct_error(kmer, seq)
        return self.ins_sub_correction(kmer, err_len - self.k)


# ---------------------------------------------------------------------------
# Method-chain assembly + per-read driver (lib.rs:106-117, 141-164)
# ---------------------------------------------------------------------------

METHOD_NAMES = ("one", "two", "graph", "greedy", "gap-size")


def build_methods(names, valid_kmer, confirm: int, max_search: int):
    """reference build_methods (src/lib.rs:141-164)."""
    methods = []
    for name in names:
        name = name.lower().replace("_", "-")
        if name == "one":
            methods.append(One(valid_kmer, confirm))
        elif name == "two":
            methods.append(Two(valid_kmer, confirm))
        elif name == "graph":
            methods.append(Graph(valid_kmer))
        elif name == "greedy":
            methods.append(Greedy(valid_kmer, max_search, confirm))
        elif name in ("gap-size", "gapsize"):
            methods.append(GapSize(valid_kmer, confirm))
        else:
            raise ValueError(f"unknown correction method: {name}")
    return methods


def correct_read(seq: bytes, methods, two_side: bool) -> bytes:
    """Per-read driver: forward chain, then (when --two-side is ABSENT) the
    chain again on plain-reversed bytes (src/lib.rs:106-117)."""
    correct = bytes(seq)
    for m in methods:
        correct = m.correct(correct)
    if not two_side:
        correct = correct[::-1]
        for m in methods:
            correct = m.correct(correct)
        correct = correct[::-1]
    return correct
