"""The flat-packed correction engine on PyTorch and CUDA (port of
``br_tpu.correct.engine3``).

Every read of a chunk sits in its own slot of one flat buffer of 2-bit
codes, ``(rstart, rlen)`` per slot.  A pass of one strategy over a chunk
is three kernels, each with a plain PyTorch version for CPU tensors:

1. K1 ``dense_probe`` (correct/probe.py): k-mers, solid bits, the V/T
   masks and the site list;
2. the strategy's site kernel: every site's chain of attempts and its
   repair records: K2 ``one_sites`` (correct/sites.py), K5 ``two_sites``
   (correct/two.py), K6 ``walk_sites`` for ``graph`` and ``gap-size``
   (correct/walk.py), K7 ``greedy_sites`` (correct/greedy.py);
3. K3 ``chain_splice`` (correct/splice.py): the visited chain of every
   read and its spliced output.

Between the two directions of a chain, K4 ``reverse_slots``
(correct/reverse.py) reverses every read in its slot.

A pass never synchronises with the host.  Engineered bounds (the site
capacity NS, SLOTS records per site, the record capacity NR, the slot's
headroom, the walks' walk_max and T3_CAP) raise a per-read cap.  Capped
reads retry once on a sibling corrector with the wide walk profile
(walk_max = 2040), its slot headroom and smaller chunks, as the JAX
package's do (engine3.py:2112-2122, :2235-2250): long walk accepts and
long gap fills fit there, and a read capped because its chunk's sites
overflowed NS meets fewer neighbours.  Reads capped again are corrected
on the host by the native engine (``br_tpu_torch.native``), so the output
is always the reference's.

The set is a solid bitfield or a ``HashSet``.  A bitfield at an odd k up
to 15 runs the kernels' 32-bit instantiations, at k = 17 their 64-bit
ones; a ``HashSet`` (any k up to 31: br's ``large-kmer``) runs their
``_h`` instantiations, 64-bit registers probing its sorted table by a
search inside the k-mer's bucket (``kernels.table_kernel``).  The
bitfield may be a host ``SolidSet`` or a ``DeviceSolidSet`` built on the
device (``set/device_build.py``): then the table stays where it was
built, and a host copy of it is made only when the native engine first
needs one.  A ``HashSet``'s padded table is copied to the device once
and its bucket index built there (``HashSet.device_table_tensor``),
shared by the wide sibling; the native engine takes the host set itself.

A batch's chunks run in groups of up to ``NC_MAX`` (the JAX package's
chunk-batched chain, engine3.py:1905-1916, :2203-2209, :2295-2326): every
kernel of the chain takes a group's NC chunks in one launch, chunk
blockIdx.y, each with the arrays, capacities and cap rules of a chunk on
its own (``make_pass3_fn(batch=True)``), so a group makes each of a
chunk's launches once.  A group crosses the bus 2-bit packed in three
copies: K11a ``unpack_codes`` unpacks it at the chain's entry and K11b
``pack_codes`` packs it at its exit, one launch each (``device_codec``).
A short group is not padded: nothing here has a fixed shape.  With
``mesh`` set (a ``parallel.mesh.Mesh``), a batch's chunks go round robin
over the shards, chunk i on shard i mod D's device against the table's
copy there, each shard's chunks in groups (``_dispatch_sharded``); the
output, cap flags and ``last_stats`` are the one-device corrector's.
"""

from __future__ import annotations

import numpy as np
import torch

from br_tpu_torch.correct import device_codec as dc
from br_tpu_torch.correct.greedy import check_ms, greedy_sites
from br_tpu_torch.correct.layout import (
    MAX_R, WALK_MAX, WIDE_WALK_MAX, site_capacity, walk_profile)
from br_tpu_torch.correct.probe import dense_probe
from br_tpu_torch.correct.reverse import reverse_slots
from br_tpu_torch.correct.sites import one_sites
from br_tpu_torch.correct.splice import chain_splice
from br_tpu_torch.correct.two import two_sites
from br_tpu_torch.correct.walk import walk_sites

#: strategies with a ported pass: all five of br's.
PORTED = ("one", "two", "graph", "greedy", "gap-size")


def check_strategy(strategy: str) -> None:
    if strategy not in PORTED:
        raise ValueError(f"unknown correction strategy {strategy!r}")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  No CUDA and no device named is an error, never a quiet run
    on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "br_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' (CLI: --device cpu) to run the plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for and CUDA is not "
                           "available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def host_set(valid_kmer):
    """The host set of a membership set: a ``DeviceSolidSet``'s
    ``SolidSet`` (its table copied once); a ``SolidSet`` or ``HashSet``
    itself."""
    from br_tpu_torch.set.device_build import DeviceSolidSet

    if isinstance(valid_kmer, DeviceSolidSet):
        return valid_kmer.host()
    return valid_kmer


def make_pass3_fn(k: int, strategy: str, c: int, ms: int, nb: int,
                  CHUNK: int, R: int, walk_max: int = WALK_MAX,
                  batch: bool = False):
    """One pass of ``strategy`` over a chunk: a callable
    (table, codes (CHUNK,) u8, rstart (R,) i32, rlen (R,) i32) ->
    (out codes (CHUNK,) u8, out_lens (R,) i32, cap (R,) bool,
    aux (8,) i32), the signature of the JAX package's pass.  With
    ``batch`` (the JAX package's vmapped pass, engine3.py:1905-1916) it
    takes a group of NC independent chunks against one table, every
    array with a leading axis of NC, in one launch of each kernel, and
    returns (NC, CHUNK) codes, (NC, R) out_lens and cap, (NC, 8) aux:
    each chunk's as a pass over it alone gives them.

    Unused slots have rstart = CHUNK and rlen = 0; a slot's capacity is
    the distance to the next slot's start (the last: to CHUNK).  aux =
    (sites, capped sites by reason: overflow, attempt, rounds, visited
    sites, applied records, capped reads, raw site count).  Output codes
    past out_len are 0.  ``ms`` and ``nb`` are greedy's search length and
    validation count; ``walk_max`` bounds the walks of ``graph`` and
    ``gap-size`` (the wide profile: WIDE_WALK_MAX).  The table is int32
    bitfield words or a ``device_codec.SortedTable``
    (``HashSet.device_table_tensor``): its kind picks the kernels, and
    the k its kind allows is checked where it is given."""
    check_strategy(strategy)
    dc.check_k(k, "hash")
    walk_profile(walk_max)
    if strategy == "greedy":
        check_ms(ms, nb)
    if CHUNK % 4 or not 1 <= R <= MAX_R:
        raise ValueError(f"CHUNK must be a multiple of 4 and 1 <= R <= "
                         f"{MAX_R}; got CHUNK={CHUNK}, R={R}")
    NS = site_capacity(CHUNK)
    NR = NS

    def site_pass(table, codes, d, rstart, rlen):
        args = (table, codes, d.kmers, d.s_pos, d.n_sites, rstart, rlen, k)
        if strategy == "one":
            return one_sites(*args, c)
        if strategy == "two":
            return two_sites(*args, c)
        if strategy == "greedy":
            return greedy_sites(*args, ms, nb)
        return walk_sites(table, codes, d.kmers, d.V, d.s_pos, d.n_sites,
                          rstart, rlen, k, c, strategy, walk_max)

    def passfn(table, codes, rstart, rlen):
        if codes.dim() != 1 + batch:
            raise ValueError(f"a {'batched ' if batch else ''}pass takes "
                             f"{'(NC, CHUNK)' if batch else '(CHUNK,)'} "
                             f"codes, got {tuple(codes.shape)}")
        d = dense_probe(table, codes, rstart, rlen, k, NS)
        s = site_pass(table, codes, d, rstart, rlen)
        sp = chain_splice(codes, rstart, rlen, d.s_pos, d.n_sites, s,
                          d.cap_read)
        # the visited-record capacity NR spans all reads of a chunk
        # (records are compacted in read order): reads with a record past
        # it cap
        cum = torch.cumsum(sp.rec_cnt, -1)
        cap = sp.cap | ((cum > NR) & (sp.rec_cnt > 0))
        aux = sp.aux
        aux[..., 5] = cum[..., -1].clamp(max=NR)
        aux[..., 6] = cap.sum(-1)
        return sp.out, sp.out_len, cap, aux

    return passfn


# ---------------------------------------------------------------------------
# Batch driver: flat chunk packing, 2-bit packed transfers.
# ---------------------------------------------------------------------------

def _fetch(handles, j):
    """Element j of every handle as numpy arrays, in order: one stack and
    copy to the host for the handles of each device."""
    by_dev: dict = {}
    for i, h in enumerate(handles):
        by_dev.setdefault(h[j].device, []).append(i)
    out = [None] * len(handles)
    for idx in by_dev.values():
        arr = torch.stack([handles[i][j] for i in idx]).cpu().numpy()
        for r, i in enumerate(idx):
            out[i] = arr[r]
    return out


_PURE_LUT = np.zeros(256, dtype=bool)
_PURE_LUT[[65, 67, 71, 84]] = True  # 'A' 'C' 'G' 'T'
_DECODE = np.frombuffer(b"ACTG", dtype=np.uint8)


class Torch3Corrector:
    """Flat-packed batched corrector on one device (port of
    ``Tpu3Corrector``): same contract, bit-exact output; capped reads
    retry once on the sibling with the wide walk profile, and impure,
    too-long and still-capped reads are corrected on the host by the
    native engine, on ``threads`` threads (0: one a core).
    ``valid_kmer`` is a ``SolidSet``, a ``DeviceSolidSet`` or a
    ``HashSet``."""

    #: flat positions per chunk
    CHUNK = 1 << 20
    #: read slots per chunk
    R = 512
    #: most chunks of a group, run through the chain together (every
    #: kernel launched once a group); the wide sibling takes its
    #: parent's.  1 runs each chunk alone.  16: in chip_smoke.py's NC
    #: sweep on an H100 (k = 13, 26 chunks of 2^20 and 21 of 2^18) 16
    #: and 64 beat 1 by a fifth to a third of correct_s and lie within
    #: one another's run-to-run spread, and 4 is slower than 16 in every
    #: paired run; 16 is timed at its own group size (a 64-chunk group
    #: never was), at ~38 MB of device memory a chunk of a group (~0.6
    #: GB).  br_tpu keeps 1, its ops being bound by bytes on the TPU.
    NC_MAX = 16

    def __init__(self, valid_kmer, corrections, confirm: int,
                 max_search: int, chunk: int | None = None,
                 nreads: int | None = None, device=None, table=None,
                 walk_max: int = WALK_MAX, threads: int = 0, parent=None):
        from br_tpu_torch.set.device_build import DeviceSolidSet
        from br_tpu_torch.set.hash import HashSet
        from br_tpu_torch.set.solid import SolidSet

        if isinstance(valid_kmer, HashSet):
            self.kind = "hash"
        elif isinstance(valid_kmer, (SolidSet, DeviceSolidSet)):
            self.kind = "solid"
        else:
            raise TypeError("Torch3Corrector needs a br_tpu_torch SolidSet, "
                            "DeviceSolidSet or HashSet")
        dc.check_k(valid_kmer.k, self.kind)
        self.corrections = [s.lower().replace("_", "-")
                            for s in corrections]
        for s in self.corrections:
            check_strategy(s)
        self.device = resolve_device(device)
        self.k = valid_kmer.k
        self.c = confirm
        self.ms = max_search
        self.valid_kmer = valid_kmer
        if chunk is not None:
            self.CHUNK = chunk
        if nreads is not None:
            self.R = nreads
        if table is None:
            table = (valid_kmer.device_table_tensor(self.device)
                     if self.kind == "hash"
                     else valid_kmer.device_words(self.device))
        #: the device table: bitfield words, or the padded sorted table
        #: with its bucket index (a SortedTable)
        self.table = table
        #: the walk bound of this corrector's passes; a corrector on the
        #: default profile retries capped reads on a wide sibling
        self.walk_max = walk_max
        #: the batched pass of each strategy (groups of chunks)
        self._passes = {s: make_pass3_fn(self.k, s, self.c, self.ms,
                                         self.c, self.CHUNK, self.R,
                                         walk_max=walk_max, batch=True)
                        for s in set(self.corrections)}
        self._wide = None
        #: a ``parallel.mesh.Mesh`` to spread the chunks over (None: this
        #: corrector's device only); its retries run on the wide sibling,
        #: which has no mesh (engine3.py:2112-2122)
        self.mesh = None
        self._mesh_tables = None
        self.threads = threads
        #: the native host engine, built at first use; the wide sibling
        #: (its ``parent`` set) takes its parent's
        self._parent = parent
        self._engine = None
        self.last_stats: dict = {}
        self.last_host: list = []

    # -- planning (host) -----------------------------------------------------

    def _slot_len(self, n: int) -> int:
        # net-insertion headroom; overflow -> cap -> retry -> host engine.
        # A wide profile budgets a full walk emit (engine3.py:2064-2072).
        slack = max(64, n // 8)
        if self.walk_max > WALK_MAX:
            slack = max(slack, self.walk_max + 64)
        s = n + slack
        return s + (-s) % 32

    def _plan(self, seqs, skip, too_long):
        """Pack read indices into chunks of <= CHUNK positions / R slots.

        Reads in ``skip`` are left out; reads too long for one chunk are
        left out and added to ``too_long``.  Returns [(idxs, rstarts)]."""
        plans = []
        cur_idx, cur_starts, off = [], [], 0
        for i, s in enumerate(seqs):
            if i in skip:
                continue
            sl = self._slot_len(len(s))
            if sl > self.CHUNK:
                too_long.add(i)
                continue
            if off + sl > self.CHUNK or len(cur_idx) >= self.R:
                plans.append((cur_idx, cur_starts))
                cur_idx, cur_starts, off = [], [], 0
            cur_idx.append(i)
            cur_starts.append(off)
            off += sl
        if cur_idx:
            plans.append((cur_idx, cur_starts))
        return plans

    def _chunk_arrays(self, seqs, idxs, starts, out=None):
        """Host-side packing of one chunk: its 2-bit codes packed four a
        byte, and its slot tables, written into ``out`` (a group's rows:
        packed (CHUNK/4,) u8, rstart and rlen (R,) i32, rstart filled with
        CHUNK and rlen with 0) or into new arrays; returns them."""
        CHUNK, R = self.CHUNK, self.R
        if out is None:
            out = (np.empty(CHUNK // 4, np.uint8),
                   np.full(R, CHUNK, np.int32), np.zeros(R, np.int32))
        packed, rstart, rlen = out
        codes = np.zeros(CHUNK, dtype=np.uint8)
        for b, (i, lo) in enumerate(zip(idxs, starts)):
            arr = np.frombuffer(seqs[i], dtype=np.uint8)
            codes[lo : lo + len(arr)] = (arr >> 1) & 3
            rstart[b] = lo
            rlen[b] = len(arr)
        b4 = codes.reshape(CHUNK // 4, 4)
        np.bitwise_or(b4[:, 0] | (b4[:, 1] << 2), (b4[:, 2] << 4)
                      | (b4[:, 3] << 6), out=packed)
        return out

    def _group_arrays(self, seqs, group):
        """Host-side packing of a group of chunks (plans): one (NC,
        CHUNK/4) packed array and the (NC, R) slot tables, each chunk
        written into its row."""
        NC, CHUNK, R = len(group), self.CHUNK, self.R
        arrays = (np.empty((NC, CHUNK // 4), np.uint8),
                  np.full((NC, R), CHUNK, np.int32),
                  np.zeros((NC, R), np.int32))
        for c, (idxs, starts) in enumerate(group):
            self._chunk_arrays(seqs, idxs, starts,
                               tuple(a[c] for a in arrays))
        return arrays

    def _get_wide(self):
        """The retry sibling (engine3.py:2112-2122): the wide walk
        profile, chunks of at most 2^18 positions and 32 slots, sharing
        the device table and the native host engine."""
        if self._wide is None:
            self._wide = Torch3Corrector(
                self.valid_kmer, self.corrections, self.c, self.ms,
                chunk=min(self.CHUNK, 1 << 18), nreads=min(self.R, 32),
                device=self.device, table=self.table,
                walk_max=WIDE_WALK_MAX, parent=self)
        self._wide.NC_MAX = self.NC_MAX
        return self._wide

    # -- the batch interface ---------------------------------------------------

    def run_chain(self, codes, rstart, rlen, two_side: bool, table=None):
        """The full chain on a group of chunks already on the device
        ((NC, CHUNK) codes, (NC, R) slot tables; the batched passes):
        every strategy forward, then (two_side False) reverse, every
        strategy, reverse back, against ``table`` (the corrector's device
        table by default; a mesh shard's copy on its device).  Returns
        (codes, out_lens, cap) without a host synchronisation."""
        table = self.table if table is None else table
        cap_any = torch.zeros(rstart.shape, dtype=torch.bool,
                              device=codes.device)
        n = rlen

        def one_direction(a, n, cap_any):
            for strat in self.corrections:
                a, n, cap, _aux = self._passes[strat](table, a, rstart, n)
                cap_any = cap_any | cap
            return a, n, cap_any

        a, n, cap_any = one_direction(codes, n, cap_any)
        if not two_side:
            a = reverse_slots(a, rstart, n)
            a, n, cap_any = one_direction(a, n, cap_any)
            a = reverse_slots(a, rstart, n)
        return a, n, cap_any

    def _run_arrays(self, arrays, dev, table, two_side: bool):
        """A group's host arrays (``_group_arrays``) copied to ``dev``
        (three copies), unpacked (one K11a), run through the chain against
        ``table`` and packed (one K11b): one handle (packed codes,
        out_lens, cap) a chunk, views of the group's."""
        packed, rstart, rlen = arrays
        a = dc.unpack_codes(torch.from_numpy(packed).to(dev), self.CHUNK)
        rs = torch.from_numpy(rstart).to(dev)
        n = torch.from_numpy(rlen).to(dev)
        a, n, cap = self.run_chain(a, rs, n, two_side, table)
        pk = dc.pack_codes(a)
        return [(pk[c], n[c], cap[c]) for c in range(pk.shape[0])]

    def _dispatch_group(self, seqs, group, two_side: bool, dev=None,
                        table=None):
        """The chain on a group of chunks (plans) in one dispatch, on
        ``dev`` against ``table`` (this corrector's by default); returns
        a handle a chunk, like engine3.py:2295-2326, whose short groups
        are padded to NC: here nothing is."""
        return self._run_arrays(self._group_arrays(seqs, group),
                                self.device if dev is None else dev,
                                self.table if table is None else table,
                                two_side)

    def _groups(self, plans):
        """Consecutive runs of at most NC_MAX of ``plans``."""
        if not isinstance(self.NC_MAX, int) or self.NC_MAX < 1:
            raise ValueError(f"NC_MAX must be a positive int, got "
                             f"{self.NC_MAX!r}")
        return [plans[lo : lo + self.NC_MAX]
                for lo in range(0, len(plans), self.NC_MAX)]

    def _dispatch_sharded(self, seqs, plans, two_side: bool):
        """Chunk i on shard i mod D's device against the table's copy
        there, each shard's chunks in groups of NC_MAX, a group of every
        shard in turn (engine3.py:2401-2436 runs one chunk a device at a
        time, a short round padded with empty chunks, as pmap needs one a
        device; nothing here is padded).  Returns per-plan handles in
        plan order."""
        from br_tpu_torch.parallel.mesh import replicated

        mesh = self.mesh
        if self._mesh_tables is None or self._mesh_tables[0] is not mesh:
            self._mesh_tables = (mesh, replicated(mesh, self.table))
        tables = self._mesh_tables[1]
        D = mesh.size
        shards = [self._groups(list(range(d, len(plans), D)))
                  for d in range(D)]
        handles = [None] * len(plans)
        for g in range(max(len(s) for s in shards)):
            for d in range(D):
                if g < len(shards[d]):
                    idx = shards[d][g]
                    for i, h in zip(idx, self._dispatch_group(
                            seqs, [plans[i] for i in idx], two_side,
                            mesh[d], tables[d])):
                        handles[i] = h
        return handles

    def warmup(self, two_side: bool, nc: int = 1):
        """Prepare everything a batch of groups of ``nc`` chunks uses
        (engine3.py:2150-2185, where it compiles the programs): build and
        load every kernel library of this corrector's instantiation (on
        CUDA), load the native engine (a device-built set copied to the
        host), and run one group of ``nc`` chunks with no reads through
        the chain, here and on the wide sibling of a default-profile
        corrector.  After it a batch builds and loads nothing; nothing in
        the port compiles at run time."""
        from br_tpu_torch import kernels

        if self.device.type == "cuda":
            names = [kernels.variant(n, self.k, self.kind)
                     for n in ("dense_probe", "one_sites", "two_sites",
                               "walk_sites", "greedy_sites")]
            names += ["chain_splice", "reverse_slots", "unpack_codes",
                      "pack_codes"]
            kernels.build_all(names)
            for name in names:
                kernels.library(name)
        self.native_engine()
        cors = [self]
        if self.walk_max == WALK_MAX:
            cors.append(self._get_wide())
        for cor in cors:
            cor._dispatch_group([], [([], [])] * nc, two_side)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def correct_batch(self, seqs, two_side: bool):
        out = [None] * len(seqs)
        impure = {
            i for i, s in enumerate(seqs)
            if not _PURE_LUT[np.frombuffer(s, np.uint8)].all()
        }
        too_long: set = set()
        plans = self._plan(seqs, impure, too_long)
        if self.mesh is not None:
            handles = self._dispatch_sharded(seqs, plans, two_side)
        else:
            handles = [h for group in self._groups(plans)
                       for h in self._dispatch_group(seqs, group, two_side)]
        capped = []
        if handles:
            # one fetch per array kind and device for the whole batch
            a_all, n_all, cap_all = (_fetch(handles, j) for j in range(3))
        for ci, (idxs, starts) in enumerate(plans):
            a_np, n_np, cap_np = a_all[ci], n_all[ci], cap_all[ci]
            codes = np.empty(a_np.shape[0] * 4, np.uint8)
            for sh in range(4):
                codes[sh::4] = (a_np >> (2 * sh)) & 3
            for b, i in enumerate(idxs):
                if cap_np[b]:
                    capped.append(i)
                else:
                    lo = starts[b]
                    out[i] = _DECODE[codes[lo : lo + n_np[b]]].tobytes()
        host = sorted(impure | too_long)
        todo = host  # the reads this corrector's host engine corrects
        n_retried = 0
        # only a batch on the default profile retries (engine3.py:2242)
        if capped and self.walk_max == WALK_MAX:
            wide = self._get_wide()
            fixed = wide.correct_batch([seqs[i] for i in capped], two_side)
            for i, s in zip(capped, fixed):
                out[i] = s
            n_retried = len(capped)
            # capped again: the sibling's host engine corrected them
            capped = [capped[j] for j in wide.last_host]
        else:
            todo = host + capped
        #: the host/device split of the last batch: every read the device
        #: did not finish (impure bytes, too long for a chunk, capped
        #: after the retry) is corrected by the native host engine and
        #: counted in "fallback".
        self.last_stats = {
            "total": len(seqs),
            "fallback": len(host) + len(capped),
            "impure": len(impure),
            "too_long": len(too_long),
            "capped": len(capped),
            "wide_retried": n_retried,
            "chunks": len(plans),
        }
        #: batch indices of those reads
        self.last_host = host + capped
        if todo:
            fixed = self._oracle_correct_many([seqs[i] for i in todo],
                                              two_side)
            for i, s in zip(todo, fixed):
                out[i] = s
        return out

    def native_engine(self):
        """The native host engine (built and loaded at first use; a build
        or load that fails raises: no other host path is taken).  A
        device-built set is copied to the host here, once."""
        if self._parent is not None:
            return self._parent.native_engine()
        if self._engine is None:
            from br_tpu_torch.native import NativeCorrector

            self._engine = NativeCorrector(host_set(self.valid_kmer),
                                           self.corrections, self.c, self.ms,
                                           threads=self.threads)
        return self._engine

    def _oracle_correct_many(self, seqs, two_side: bool):
        """The host reads of a batch, by the native engine (the reference
        semantics of correct/reference.py, which stays the tests' oracle)."""
        return self.native_engine().correct_batch(seqs, two_side)
