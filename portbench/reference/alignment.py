"""Global pairwise alignment compatible with rust-bio's Gotoh aligner.

The reference Greedy strategy accepts a speculative path via a global
alignment (``Aligner::with_capacity(10, 10, -1, -1, Score)`` with match=+1 /
mismatch=-1 / gap_open=-1 / gap_extend=-1; greedy.rs:56-89) and then walks
``alignment.operations``.  For parity we reproduce rust-bio's dynamic
program *and its traceback tie-breaks*:

* three-state Gotoh; a gap of length L costs ``open + L * extend``;
* per cell, the best layer is chosen in order Match/Subst, Ins, Del — a tie
  keeps the earlier layer;
* gap layers prefer *opening from S* on a tie with extending
  (``if extend > open {extend} else {open}``);
* ``Ins`` consumes x (a base of x against a gap), ``Del`` consumes y.

Calibrated against the reference's Greedy unit-test catalog
(greedy.rs:176-411).  The benchmark's frozen copy of
``br_tpu_torch.correct.alignment``.
"""

from __future__ import annotations

OP_MATCH = 0
OP_SUBST = 1
OP_DEL = 2  # consumes y only
OP_INS = 3  # consumes x only

_TB_START = 4

NEG_INF = -(1 << 30)


def global_align_ops(x: bytes, y: bytes, match: int = 1, mismatch: int = -1,
                     gap_open: int = -1, gap_extend: int = -1) -> list[int]:
    """Return the operations of the global alignment of x against y,
    start-to-end, as OP_* codes."""
    m, n = len(x), len(y)

    # score matrices, indexed [i][j]
    S = [[NEG_INF] * (n + 1) for _ in range(m + 1)]
    I = [[NEG_INF] * (n + 1) for _ in range(m + 1)]
    D = [[NEG_INF] * (n + 1) for _ in range(m + 1)]
    # traceback layers: for each cell, where each layer came from
    sb = [[_TB_START] * (n + 1) for _ in range(m + 1)]
    ib = [[_TB_START] * (n + 1) for _ in range(m + 1)]
    db = [[_TB_START] * (n + 1) for _ in range(m + 1)]

    S[0][0] = 0
    for i in range(1, m + 1):
        I[i][0] = gap_open + i * gap_extend
        S[i][0] = I[i][0]
        sb[i][0] = OP_INS
        ib[i][0] = OP_INS if i > 1 else _TB_START
    for j in range(1, n + 1):
        D[0][j] = gap_open + j * gap_extend
        S[0][j] = D[0][j]
        sb[0][j] = OP_DEL
        db[0][j] = OP_DEL if j > 1 else _TB_START

    for i in range(1, m + 1):
        xi = x[i - 1]
        for j in range(1, n + 1):
            # Ins layer: consume x[i-1] against a gap (vertical move).
            ext = I[i - 1][j] + gap_extend
            opn = S[i - 1][j] + gap_open + gap_extend
            if ext > opn:
                I[i][j] = ext
                ib[i][j] = OP_INS
            else:
                I[i][j] = opn
                ib[i][j] = sb[i - 1][j]

            # Del layer: consume y[j-1] against a gap (horizontal move).
            ext = D[i][j - 1] + gap_extend
            opn = S[i][j - 1] + gap_open + gap_extend
            if ext > opn:
                D[i][j] = ext
                db[i][j] = OP_DEL
            else:
                D[i][j] = opn
                db[i][j] = sb[i][j - 1]

            # S layer: best at cell; ties keep the earlier candidate
            # (Match/Subst, then Ins, then Del).
            sub = match if xi == y[j - 1] else mismatch
            best = S[i - 1][j - 1] + sub
            bits = OP_MATCH if xi == y[j - 1] else OP_SUBST
            if I[i][j] > best:
                best = I[i][j]
                bits = OP_INS
            if D[i][j] > best:
                best = D[i][j]
                bits = OP_DEL
            S[i][j] = best
            sb[i][j] = bits

    # Traceback from (m, n), starting in the S layer.
    ops: list[int] = []
    i, j = m, n
    layer = sb[i][j]
    while layer != _TB_START:
        if layer == OP_INS:
            ops.append(OP_INS)
            layer = ib[i][j]
            i -= 1
        elif layer == OP_DEL:
            ops.append(OP_DEL)
            layer = db[i][j]
            j -= 1
        else:  # match / subst
            ops.append(layer)
            i -= 1
            j -= 1
            layer = sb[i][j]
    ops.reverse()
    return ops
