#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (br_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline CSRC_DIR]

In order, each phase ending the run with a nonzero exit code if it fails:

1. toolchain and device: the card's name and power limit (nvidia-smi),
   torch's CUDA version, nvcc's version, whether triton imports;
2. build: the kernels from br_tpu_torch/csrc, one nvcc a source (each
   k-mer kernel's source holds its 32-bit instantiation, k <= 15, its
   64-bit one, k = 17, and its sorted-table one, `_h`, with `ptxas`
   registers, stack and spills of each),
   and the native host engine (br_tpu_torch/native, g++), all at once
   (started before the corpus is made, joined before first use);
3. the main path's input: a seeded corpus (br_tpu_torch.corpus: 2000
   reads over a 2 Mb genome, ~24 Mb at 95-98 % identity) and the solid set
   of the CLI's `fasta -k 13 -a 2`, on the host (Counter, the set this
   phase built before K8) and by K8 on the card (build_set): the same
   bits, each build timed;
4. kernel checks: K1-K7 on the card at the main path's shapes (the
   corpus's first chunk: CHUNK = 2^20 positions, R = 512 slots, k = 13):
   K1, then every site kernel (K2 one, K5 two, K6 graph and gap-size at
   the default walk profile, K7 greedy) on K1's output, K3 on the one and
   the graph records (one-word and multi-word emits), K4; each held
   against its plain PyTorch version on the same inputs (a site kernel
   through sites.defined, the entries it writes); the results are
   integers and must match exactly; times from CUDA events: a kernel's
   with its calls queued behind a spin kernel (device time), and also as
   the first versions of this script timed them, with the host launching
   in the loop (call_ms); the plain versions' after a first warm call;
   each kernel's ms over its bound; beside K3's time the reads that set
   it (the longest, and the one with the most visited sites); beside
   each site kernel its chain floor (chain_floor: the slowest site's
   dependent global-memory round trips, one thread a site and a warp a
   site, counted from the plain version's chains); with --baseline, the
   kernels K1-K7 whose sources differ in another tree's csrc (the parent
   commit's), built from there and called through this tree's wrappers,
   are checked too and timed beside this tree's, by the same method, in
   the order baseline, this tree, this tree, baseline; then K8 (its count
   and pack kernels, 2-bit counters at a = 2) on the whole corpus
   against their plain versions, with each kernel's bound and
   torch.unique's time on the same canonical k-mers, and the whole build
   (the counters' zeroing, K8a, K8b) timed against the function's bound
   (the packed reads read once, the bitfield written once), with its
   peak device memory (with --baseline, the other tree's K8 built and
   timed beside it, and K8a and the build at each a whose counters take
   one partition: k8_sweep); then K8's build against its plain build at
   every a of ABUNDANCES; later in the run (after phase 5's sweep) the
   chunk-batched chain's kernels on the corpus's first three chunks as
   one group, each launched once (group_checks: K11a, K1, K2, K5, K6 in
   both modes, K7, K3 on the one and the graph records, K4, K11b), held
   exactly against their plain versions on every chunk and timed against
   the group's bound, then each on a group of the first batch's 26
   chunks, and on the main path's first wide group (2^18, walk_max
   2040), held exactly against the same kernel launched once a chunk
   over them and timed beside those launches, both queued behind a
   spin, with the group's bound and, beside K11, the launch floor
   (group_checks without plain; at k = 17 and 21 the same on three 2^15
   chunks against the plain versions and on the path's first group of
   each profile against one-chunk launches, path_groups);
5. the main path: the default chain (no -c: one, two, graph, greedy,
   gap-size), forward and reversed, over the whole corpus through the
   CLI's entry points (build_set, whose K8 count is count_s, with K8's
   device ms, the reads' packing and the FASTA read beside it, then
   make_corrector, run_correction: each chunk unpacked by K11a and
   packed by K11b around its chain) with every launch count set to 0 just
   before; the passes' cap counters by reason and strategy; the host
   engine's seconds (host_oracle_s: the native engine on the reads the
   device did not finish, with its set copied at first need), its name and
   threads; fails if a kernel was not launched, if a chain kernel's
   launches are not those of the groups the path dispatched (a group of
   up to NC_MAX chunks makes each of a chunk's launches once,
   check_launches) or more than 5 % of the reads went to the host; then
   the NC sweep (nc_sweep): the same correction once at NC_MAX = 1, 4,
   16 and 64, each corrector warmed up first, byte-equal to phase 5
   with its last_stats, with correct_s split, the launches a kernel and
   the peak device memory (projected to the CLI's default
   record_buffer), and the fastest NC_MAX under 8 GB (the busy share at NC_MAX = 1 and at the
   default is measured last, after phase 13);
6. the wide profile's kernel checks, on the main path's first retry
   chunk (2^18 positions, 32 slots, walk_max 2040): K1, K2 and K5 (and
   their baselines and chain floors), K6 in both modes and K3 on the
   walks' records, and K4 (and its baseline), as in 4;
7. the long-walk chunk (long_walk_chunk: 2^20 positions, 512 slots, a
   seeded branch-free genome whose planted errors walk past 248 and past
   2,040 and revisit at 31-33, 247-249 and 2,039-2,041 steps): K6 in both
   modes at walk_max 248 and 2040 and K3 on their
   records, as in 4, with the longest walk beside each time; there the
   plain walk runs once, as the reference, timed and counted for the
   chain floor in the same run;
8. output check: a seeded sample of 100 reads, and every read the device
   did not finish (those the native engine corrected), against the port's
   Python oracle of the default chain (correct/reference.py), the judge
   independent of both, run in forked worker processes, one a host core;
9. the first slice's path, `-c one`, on the first 500 reads, with its own
   launch counts, fallback limit and oracle check;
10. k = 17 (k17_path): K8 at k = 17 against its plain build on the first
   200 reads (set bits compared on the card), and K8's count and pack
   kernels and its whole build on the whole corpus as in 4 (one
   partition of 2^33 2-bit counters, 2 GiB); the default chain at
   k = 17 through the CLI's entry points (`fasta -k 17 -a 2`: the 1 GiB
   set built by K8 over the whole corpus, then the whole corpus
   corrected), with count_s (and K8's share), correct_s, reads/s,
   rest_s, fallbacks, wide retries and the peak device memory, failing
   on a kernel not launched or more than 5 % fallbacks; the 64-bit K1,
   K2, K5, K6 (both modes, walk_max 248 and 2040) and K7 (ms 7, and 14
   and 15 on the first chunk) on its first chunk and its first retry
   chunk, each held exactly against its plain version (run once) and
   timed as in 4 (with --baseline, the first chunk's beside the other
   tree's 64-bit instantiations), and the 64-bit chain on a group of
   three chunks of 2^15 positions of its reads as in 4's group checks,
   and on the path's first group and first wide group against one-chunk
   launches; its output check, as in 8, at k = 17;
11. large k (large_k_path), two sets through `large-kmer -k 21` and the
   CLI's entry points (a HashSet, its sorted table padded to 2^21
   entries on the card with its bucket index, device_codec.SortedTable;
   the index build timed alone), each correcting all 2000 reads with the
   default chain, forward then reversed, with count_s (the set's build),
   correct_s, reads/s, rest_s, the pass seconds per strategy, the
   fallback share, wide retries, host_oracle_s and the peak device
   memory, failing on an `_h` kernel, K3 or K4 not launched, and each
   with its output check as in 8:
   a. the trusted set, `-i genome.fa -f fasta`: the corpus's genome
      written as FASTA, its 21-mers the set; the fallback share is
      logged, not held to 5 %: br's graph walk toward a k-mer the
      genome does not hold runs to the end of a branch-free genome, the
      device caps it and about a fifth of the reads go to the host
      (PERF.md); its output check takes a seeded TRUSTED_HOST_SAMPLE of
      those host reads beside the sample;
   b. the counted set, `-i solid21.csv -f csv`: the reads' 21-mers seen
      more than twice (numpy), written as a k-mer count CSV, failing on
      more than 5 % fallbacks; the `_h` kernels against their
   plain versions on its first chunk (K6 at walk_max 248, K7 at ms 7, 14
   and 15) and its first retry chunk (K6 at walk_max 2040), and K9
   (hash_probe) on the first chunk's k-mers against its plain version
   and torch.searchsorted, each timed as in 4 (with --baseline beside the
   other tree's, and K9 also through bucket
   indexes of b - 2 to b + 2 bits), with the index's statistics, the
   probes' dependent loads and the corrector's index build's time, and
   the `_h` chain on a group of three 2^15 chunks and on the path's
   first groups as at k = 17; then
   K9 and
   dense_probe_h at k = 31 on a sorted table
   of 2^27 entries (1 GiB, past the L2: the genome's k-mers and random
   ones, drawn on the card) with its index, checked and timed.
12. several devices (mesh_phase): D = max(4, device count) shards placed
   round robin over the cards (all four on one card where it is the
   only one); K10 (merge_counts) on the corpus's shard counters at w = 2
   (k = 13, a = 2) and w = 8 (the u8 view, a = 254), and K11a/K11b at
   2^20 and 2^18 codes carrying bits above the 2-bit code, each held
   exactly against its plain version and timed as in 4 against its
   bound; the launch floor (launch_floor: an empty launch,
   torch.cuda._sleep(0), timed as in 4) beside K11a, K11b and K4;
   count_sharded at k = 13 over the whole corpus, launch counts
   set to 0 just before (the u8 entry of K10 in the kernel line takes
   its launches), equal to the host Counter's u8 counts;
   solid_sharded at k = 13 and 17 (a = 2) over the whole corpus,
   its bits compared on the card with build_set's one-device build,
   timed, with its peak device memory; the mesh path, with every launch
   count set to 0 just before: solid_sharded at k = 13, then the default
   chain over the whole corpus through a corrector with the mesh set,
   byte-equal to phase 5's output with the same fallbacks and wide
   retries, reported as phase 5 is; the k = 21 counted set of phase 11
   through the mesh on its first N_MESH_LARGE reads (the sorted table
   replicated), byte-equal to the one-device corrector's output, each
   run's correct_s split into its passes and its host engine; then two
   processes (gloo, each on card rank % count) correcting their stripes
   with run_correction_striped and then run_correction_ranged, the set
   from count_stripe_merged at k = 13 (held equal to the host
   Counter(13, uint32)), each child under CHILD_TIMEOUT: the merged files
   byte-equal to phase 5's one-process output.
13. the CLI as a user runs it (cli_phase): two runs of `python -m
   br_tpu_torch.cli -v -T ms` on phase 5's corpus and set flags (`fasta
   -k 13 -a 2`), each killed past CLI_TIMEOUT, each byte-equal to phase
   5's output, each with the three stage report lines (build-set,
   correct, write) stamped as -T ms stamps them: first with `--trace
   DIR` (a temporary directory), whose torch.profiler trace must hold a
   CUDA kernel event for every launch phase 5 counted, kernel by kernel
   (K3's two kernels a call), logged with each kernel's summed device ms,
   the stage seconds and the device's busy share (the union of the
   kernel events over the range) inside the correct and the build-set
   range; then `--backend native -t 0`, all reads on the host engine on
   every core, its correct seconds the host baseline.  Last, phase 5's
   correction at NC_MAX = 1 and at the default once more under
   torch.profiler (nc_busy): the device's busy share of its correct
   range (a profiled run slows every later launch of the process, so
   it comes last).

The line before the last is the kernel summary {"kernels": [...]}: a
kernel's ms is the time of one call of its entry point, and its launches
count device kernels (two a call for chain_splice, a walk kernel and a
copy kernel); K11's entries at 2^20 and 2^18 split the main path's
launches by chunk size (one a wide sibling's group at 2^18); a
``<kernel>[group of 3...]`` entry is its group check, with a full
group's numbers (group_ms, group_nc1_ms, group_bound_ms) beside: at
k = 13 the first batch's 26 chunks, at k = 17 and 21 the path's first
group.  The
last line is {"ok": true, "device": {...}}.  Without CUDA, or without the
br_tpu_torch package beside it, the script exits nonzero and prints no
result.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

K, C, MS = 13, 5, 7
N_READS, GENOME, MEAN_LEN, MAX_LEN, SEED = 2000, 2_000_000, 12000, 62000, 42
#: reads of the corpus the `-c one` path corrects
N_ONE = 500
SAMPLE = 100
#: reads of the corpus the k = 17 path corrects, and its oracle sample;
#: reads K8 is checked on at k = 17
N17, SAMPLE17, K8_READS = 2000, 100, 200
#: the large-k path (`large-kmer -k 21`) and its oracle sample; the k and the entries of the sorted table of the K9 and
#: K1 checks past the L2 (2^27 entries, 1 GiB)
K_LARGE, SAMPLE_LARGE = 21, 100
K_BIG, BIG_ENTRIES = 31, 1 << 27
#: host reads of the trusted set's path held to the oracle (a seeded
#: sample of its ~410; checking all took ~150 s of the script's 1200)
TRUSTED_HOST_SAMPLE = 100
#: reads of the corpus the k = 21 set corrects through the mesh; seconds
#: a child process of the two-process check may take
N_MESH_LARGE, CHILD_TIMEOUT = 500, 300
#: seconds a CLI run of phase 13 may take
CLI_TIMEOUT = 300
MAX_FALLBACK = 0.05
#: the script's start (perf_counter), for the phase clock
T0 = time.perf_counter()
#: peak device memory bandwidth of an H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12

KERNEL_META = {
    "dense_probe": ("br_tpu_torch/csrc/dense_probe.cu",
                    "scripts/pallas_probe_bench.py:50"),
    "one_sites": ("br_tpu_torch/csrc/one_sites.cu",
                  "br_tpu/correct/engine3.py:1592"),
    "chain_splice": ("br_tpu_torch/csrc/chain_splice.cu",
                     "br_tpu/correct/engine3.py:1723"),
    "reverse_slots": ("br_tpu_torch/csrc/reverse_slots.cu",
                      "br_tpu/correct/engine3.py:1920"),
    "two_sites": ("br_tpu_torch/csrc/two_sites.cu",
                  "br_tpu/correct/engine3.py:359"),
    "walk_sites": ("br_tpu_torch/csrc/walk_sites.cu",
                   "br_tpu/correct/engine3.py:1179"),
    "greedy_sites": ("br_tpu_torch/csrc/greedy_sites.cu",
                     "br_tpu/correct/engine3.py:719"),
    "solid_count": ("br_tpu_torch/csrc/solid_build.cu",
                    "br_tpu/set/device_build.py:109"),
    "solid_pack": ("br_tpu_torch/csrc/solid_build.cu",
                   "br_tpu/set/device_build.py:109"),
    "hash_probe": ("br_tpu_torch/csrc/hash_probe.cu",
                   "br_tpu/correct/device_codec.py:160"),
    "merge_counts": ("br_tpu_torch/csrc/merge_counts.cu",
                     "br_tpu/parallel/mesh.py:70"),
    "unpack_codes": ("br_tpu_torch/csrc/pack_codes.cu",
                     "br_tpu/correct/engine3.py:1951"),
    "pack_codes": ("br_tpu_torch/csrc/pack_codes.cu",
                   "br_tpu/correct/engine3.py:1961"),
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0].strip()


def toolchain():
    import torch

    from br_tpu_torch import kernels

    nvcc = subprocess.run([kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    try:
        import triton  # noqa: F401

        triton_ok = f"yes ({triton.__version__})"
    except ImportError as e:
        triton_ok = f"no ({e})"
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}; triton: {triton_ok}")


def cuda_ms(fn, reps, sync, warm=True, queued=False, setup=None):
    """Mean milliseconds per call, by CUDA events around `reps` calls,
    after one warm call unless the caller made it.

    Without ``queued`` the host launches while the device runs, so where
    the host's time per call (the wrapper's checks, allocations, the
    ctypes call) is longer than the device's, that is what is measured.
    With ``queued`` (the kernels' times) the calls are put on the stream
    behind a spin kernel long enough to cover their launch, so the events
    time the device's work back to back: a run in which the device
    reached the first event before the last call was queued is repeated
    behind a spin four times as long.  With ``setup`` (queued only), it
    is queued before each call, outside the call's own pair of events
    (a count timed from zeroed counters): the mean of those spans."""
    import torch

    if warm:
        if setup:
            setup()
        fn()
    sync()
    n_ev = reps if setup else 1
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n_ev)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n_ev)]
    cycles = 0
    if queued:
        t0 = time.perf_counter()
        if setup:
            setup()
        fn()
        cycles = int(2e9 * max(1e-3, 2 * reps * (time.perf_counter() - t0)))
        sync()
    for _ in range(5):
        if cycles:
            torch.cuda._sleep(cycles)
        if not setup:
            starts[0].record()
        for r in range(reps):
            if setup:
                setup()
                starts[r].record()
            fn()
            if setup:
                ends[r].record()
        if not setup:
            ends[0].record()
        late = cycles and starts[0].query()
        sync()
        if not late:
            break
        cycles *= 4
    check(not late, "the host could not queue the timed calls ahead of "
                    "the device")
    if setup:
        return sum(a.elapsed_time(b) for a, b in zip(starts, ends)) / reps
    return starts[0].elapsed_time(ends[0]) / reps


def max_abs_err(a, b):
    err = 0
    for x, y in zip(a, b):
        check(x.shape == y.shape and x.dtype == y.dtype,
              f"shape/dtype differ: {x.shape} {x.dtype} vs {y.shape} "
              f"{y.dtype}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def record_words(out, mask=None):
    """(records, emit words) of the used records of a site kernel's
    plain output (rec_p < BIG), or of those in ``mask``: a record's words
    are ceil(rec_c / 16)."""
    from br_tpu_torch.correct.layout import BIG

    used = out.rec_p < BIG
    if mask is not None:
        used &= mask
    return (int(used.sum()),
            int(((out.rec_c.long() + 15) // 16)[used].sum()))


def sites_bytes(NS, n_eff, R, CHUNK, window, out):
    """Bytes a site kernel must move: the site list, the slot table, the
    k-mers at the sites and their code windows in; succ and cap for every
    site, rec_p for every slot, and for each used record its count, its
    consumed positions and its ceil(cnt/16) emit words out."""
    from br_tpu_torch.correct.layout import SLOTS

    n_used, words = record_words(out)
    return (4 * n_eff + 4 + 8 * R + 4 * n_eff + min(CHUNK, n_eff * window)
            + NS * 8 + NS * SLOTS * 4 + 8 * n_used + 4 * words)


def chain_visits(site_out, s_pos, n_sites, rs, rl, CHUNK):
    """K3's chain walk (every read's head site and its successors, as
    chain_splice_plain): the (NS,) bool mask of the visited sites, and per
    read its listed and its visited sites."""
    import torch

    NS = s_pos.shape[0]
    sp = s_pos[:min(int(n_sites[0]), NS)].long()
    rs, rl = rs.long(), rl.long()
    lo = torch.searchsorted(sp, rs)
    hi = torch.where((rl > 0) & (rs < CHUNK),
                     torch.searchsorted(sp, rs + rl), lo)
    succ = site_out.succ.long()
    visited = torch.zeros(NS, dtype=torch.bool, device=sp.device)
    cur = lo
    while bool((cur < hi).any()):
        live = cur < hi
        visited[cur[live]] = True
        nx = succ[cur.clamp(max=NS - 1)]
        cur = torch.where(live & (nx > cur), nx, NS)
    cum = torch.cat([visited.new_zeros(1, dtype=torch.long),
                     torch.cumsum(visited.long(), 0)])
    return visited, hi - lo, cum[hi] - cum[lo]


class OneChunk:
    """A chain kernel's library from before the chunk-batched chain: its
    entry points take this tree's arguments less the first, NC, which
    must be 1 (bound here without it)."""

    def __init__(self, lib, names):
        from br_tpu_torch import kernels

        self._lib = lib
        self._entries = {}
        for n in names:
            _src, entry, sig = kernels.KERNELS[n]
            fn = getattr(lib, entry)
            fn.argtypes = [kernels._CTYPES[ch] for ch in sig[1:]]
            self._entries[entry] = fn

    def __getattr__(self, attr):
        fn = self._entries.get(attr)
        if fn is None:
            return getattr(self._lib, attr)

        def call(nc, *args):
            check(nc == 1, "a kernel from before the chunk axis takes one "
                           f"chunk, not {nc}")
            return fn(*args)
        return call


def load_baseline(csrc):
    """K1, K2, K5, K6, K7, K3, K4 and K9 (every instantiation: 32-bit,
    64-bit and sorted-table) as built from another tree's ``csrc`` (the
    parent commit's: ``git archive <commit> br_tpu_torch/csrc``), those
    whose source or headers differ from this tree's, called through this
    tree's wrappers; and K8 (``solid_build.cu``), where it differs, as
    ``"k8"``: {"build"}, its whole build on batches grouped by shard, k and a,
    through this tree's build_words (the other tree's K8 has this tree's
    entry points).  A chain kernel whose entry points take no group (no
    ``int NC`` before the codes: the trees before the chunk-batched
    chain) is called
    with this tree's arguments less NC, on one chunk only.  Built with
    this tree's nvcc flags, one nvcc each, all at once; their calls are
    not counted in kernels.LAUNCHES.  Returns {kernel name: function with
    the arguments of the kernel's wrapper}."""
    from pathlib import Path

    from br_tpu_torch import kernels
    from br_tpu_torch.correct import (greedy, hash_probe, probe, reverse,
                                      sites, splice, two, walk)
    from br_tpu_torch.set import device_build as db

    def sources(d, name):
        d = Path(d)
        return [p.read_bytes() for p in (sorted(d.glob("*.cuh"))
                                         + [d / kernels.KERNELS[name][0]])]

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    wrappers = {"dense_probe": probe.dense_probe,
                "one_sites": sites.one_sites, "two_sites": two.two_sites,
                "walk_sites": walk.walk_sites,
                "greedy_sites": greedy.greedy_sites,
                "chain_splice": splice.chain_splice,
                "reverse_slots": reverse.reverse_slots,
                "hash_probe": hash_probe.hash_probe,
                "solid_count": db.build_words}
    for name in list(wrappers):
        if sources(csrc, name) == sources(kernels.CSRC, name):
            log(f"  baseline {name}: the same source as this tree's, "
                f"not built")
            del wrappers[name]
    procs = {}
    for name in wrappers:
        out = kernels.BUILD_DIR / f"lib{name}_baseline.so"
        procs[name] = (subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", csrc, "-o",
             str(out), os.path.join(csrc, kernels.KERNELS[name][0])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            out)
    libs = {}
    for name, (proc, out) in procs.items():
        log_, _ = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"baseline {name} build failed:\n{log_}")
        lib = ctypes.CDLL(str(out))
        if name == "solid_count":
            names = ["solid_count", "solid_count64", "solid_pack"]
        else:
            names = ([name] + ([name + "64"] if name in kernels.WIDE
                               else [])
                     + ([name + "_h"] if name in kernels.HASHED else []))
        kernels.bind(lib, names)
        src = os.path.join(csrc, kernels.KERNELS[name][0])
        with open(src, "rb") as fh:   # an entry point's NC before codes
            grouped = re.search(rb"int NC,\s*const void\s*\*\s*codes",
                                fh.read()) is not None
        if name in kernels.CHUNKED and not grouped:
            lib = OneChunk(lib, names)
        libs[name] = lib
        regs = [ln.split(":", 1)[-1].strip() for ln in log_.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"  ptxas {name} (baseline): {' | '.join(regs)}")

    def through(name, wrapper):
        """The wrapper, launching the baseline library."""
        src = kernels.KERNELS[name][0]

        def call(*args):
            own, counts = kernels._LIBS.get(src), dict(kernels.LAUNCHES)
            kernels._LIBS[src] = libs[name]
            try:
                return wrapper(*args)
            finally:
                kernels._LIBS[src] = own
                kernels.LAUNCHES.update(counts)
        return call

    out = {name: through(name, fn) for name, fn in wrappers.items()
           if name != "solid_count"}
    if "solid_count" in wrappers:
        out["k8"] = {"build": through("solid_count", db.build_words)}
    return out


def search_entries(table, cano):
    """The distinct entries of a sorted table (int64 entries) that binary
    searches of ``cano`` (canonical k-mers, int64) over the whole table
    read: every candidate of every level and the final one, as br_tpu's
    make_hash_probe and the port's first design (commit 1c24d6b) step.
    K9's and the _h K1's bound counts these, whatever the design
    reads."""
    import torch

    from br_tpu_torch.correct import device_codec as dc

    n, levels = table.shape[0], dc.table_levels(table)
    flipped, key = table ^ (-(1 << 63)), cano ^ (-(1 << 63))
    pos = torch.zeros_like(cano)
    seen = []
    for level in reversed(range(levels)):
        cand = (pos + (1 << level)).clamp(max=n - 1)
        seen.append(torch.unique(cand))
        pos = torch.where(flipped[cand] <= key, cand, pos)
    seen.append(torch.unique(pos))
    return int(torch.unique(torch.cat(seen)).numel())


def bucket_stats(st, cano):
    """A SortedTable's index and what the bucketed probes of ``cano``
    (canonical k-mers) read, stepped as device_codec.make_hash_probe
    steps: 2^b buckets, bucket_levels, the largest and the mean bucket
    (real entries over buckets), the dependent loads a probe (the index
    load and each in-bucket load: mean and most; 0 for a key past 2k
    bits), the distinct index offsets and table entries the probes read
    and their bytes (``probe_bytes``: 4 an offset, 8 an entry, each read
    once; what a bound of this design counts), and the distinct 32-byte
    sectors of the index and of the table they touch, in bytes."""
    import torch

    from br_tpu_torch.correct import device_codec as dc

    k = (st.shift + st.buckets.bit_length() - 1) // 2
    counts = st.starts.diff()
    inb = (cano >= 0) & (cano <= dc.mask(k))
    bucket = (cano[inb] >> st.shift)
    lo, hi = st.starts[bucket].long(), st.starts[bucket + 1].long()
    loads = torch.ones_like(lo)
    pos, read = lo - 1, []
    for level in reversed(range(st.bucket_levels)):
        cand = pos + (1 << level)
        ok = cand < hi
        loads += ok.long()
        read.append(torch.unique(cand[ok]))
        x = st.table[cand.clamp(max=st.table.numel() - 1)]
        pos = torch.where(ok & (x <= cano[inb]), cand, pos)
    offsets = torch.unique(torch.cat([bucket, bucket + 1]))
    read = torch.unique(torch.cat(read)) if read else bucket[:0]
    return {"buckets": st.buckets, "index_bits": st.buckets.bit_length() - 1,
            "bucket_levels": st.bucket_levels,
            "largest_bucket": int(counts.max()),
            "mean_bucket": float(st.starts[-1]) / st.buckets,
            "index_bytes": st.starts.numel() * 4,
            "dependent_loads_per_probe_mean": (
                float(loads.sum()) / max(1, cano.numel())),
            "dependent_loads_per_probe_max": int(loads.max()) if
            loads.numel() else 0,
            "offsets_read": offsets.numel(), "entries_read": read.numel(),
            "probe_bytes": 4 * offsets.numel() + 8 * read.numel(),
            "bucket_design_bytes": 32 * (torch.unique(offsets >> 3).numel()
                                         + torch.unique(read >> 2).numel())}


def two_thread_probes(probe, code_at, k, c, ii, corr, lf):
    """The dependent probes of one thread's two attempt (one thread a
    site, commit 7db8aa5's two_sites.cu), per lane: the apply steps' 25
    probes (probe(t1), the alternatives of t1 and t2, the successors of
    corr, second, t1 and t0), t3's when rem >= 4 and t2's when SCS's
    other gates hold; then per scenario, while its gate holds, its
    candidate and its window k-mers up to the first that is not solid,
    and its one_more only when it is kept and within the read."""
    from br_tpu_torch.correct import device_codec as dc
    from br_tpu_torch.correct import sites, two

    rem = lf - ii
    t1 = dc.add_nuc(corr, code_at(ii + 1), k)
    n2, _ = sites.alt_last(probe, dc.add_nuc(t1, code_at(ii + 2), k))
    count = (25 + (rem >= 4).long()
             + ((rem >= 3) & probe(t1) & (n2 == 1)).long())
    for s, (a_ok, km2) in enumerate(two.two_scenarios(probe, code_at, k, ii,
                                                      corr, rem)):
        off_a = two.APPLY_OFF[s]
        alive = a_ok & (off_a + c <= rem)
        km = km2
        count = count + alive.long()
        alive = alive & probe(km)
        for t in range(c):
            km = dc.add_nuc(km, code_at(ii + off_a + t), k)
            count = count + alive.long()
            alive = alive & probe(km)
        count = count + (alive & (rem > c + two.CORRECT_OFF[s] + 1)).long()
    return count


def chain_floor(kind, table, codes, d, rs, rl, k, c, ms, walk_max=0):
    """The chain floor of a site kernel on one chunk: the slowest site's
    count of dependent global-memory round trips under the old design
    (one thread per site: K2 and K5 up to commit 7db8aa5, K6 and K7 up to
    commit 7c58891) and under the new one (a warp per site, all four
    now), counted from the plain version's chains on this chunk; and the
    longest walk in steps (K6), with the plain version's output.  A round
    trip is a set of loads none of which waits on another's value or on a
    branch taken on one; code loads, which hit the lines the chain has
    just read, are not counted.  Per chain step: the gate, 1; the
    attempt; the dirty simulation, old one a probe it made, new 1; at the
    chain's end the successor search, old a binary search (ceil(log2(n+1))
    loads), new 1 when the successor is among the 32 listed sites from
    the site, else 1 and a 32-way warp search past them
    (ceil(log32(n+1))).  Per attempt:
    K2's One attempt 1 in both; K5's two attempt, old one a probe it made
    (two_thread_probes), new 2 (its apply steps, then every scenario's
    score and one_more); K6's err_len, old one a k-mer absorbed (up to k)
    then one a V byte read up to the valid position and the k-mer there,
    new 1 then one a 512-position block and the k-mer; K6's walk, a step
    each, and old also one a history word read in the steps up to
    walk_max (new reads shared memory); K7's walk, old ms steps, new up
    to its failing step, and its validation probes, old one each until
    one fails for every step tried, new 1.  Returns (old, new, longest
    walk, the plain version's Sites)."""
    import math

    import torch

    from br_tpu_torch.correct import device_codec as dc
    from br_tpu_torch.correct import greedy, sites, two, walk
    from br_tpu_torch.correct.layout import walk_profile

    NS, dev = d.s_pos.shape[0], codes.device
    n_eff = min(int(d.n_sites[0]), NS)
    old = torch.zeros(NS, dtype=torch.long, device=dev)
    new = torch.zeros_like(old)
    pending, longest = [], [0]
    nv = walk.next_valid(d.V) if kind in walk.MODES else None

    tc = torch_cases()

    def walk_rounds(code_at, ii, rg, corr, lf):
        with tc.record_attempts(walk, ["walk_plain"]) as calls:
            res = walk.walk_attempt_plain(probe_[0], code_at, k, c, nv,
                                          d.kmers, kind, walk_max, ii, rg,
                                          corr, lf)
        err, _fc = walk.err_len_plain(probe_[0], code_at, k, nv, d.kmers,
                                      ii, rg, lf)
        span = err - k   # V bytes read past i+k+1 (up to the valid one)
        vblocks = (ii + err + 1 - ((ii + k + 1) & ~15) + 511) // 512
        o_err = torch.where(err > k, k + span + 1, torch.clamp(err, max=k))
        n_err = torch.where(err > k, 1 + vblocks + 1, 1)
        walking = (err != k) | torch.full_like(err, kind == "graph",
                                               dtype=torch.bool)
        steps = torch.zeros_like(err)
        if calls["walk_plain"] and steps.numel():
            n = calls["walk_plain"][0][1][3]
            steps[walking.nonzero().squeeze(1)] = n - 1
            longest[0] = max(longest[0], int(steps.max()))
        s1 = steps.clamp(max=walk_max)
        o_walk = torch.where(walking, steps + s1 * (s1 + 1) // 2, 1)
        n_walk = torch.where(walking, steps, 1)
        return res, o_err + o_walk, n_err + n_walk

    def greedy_rounds(code_at, ii, rg, corr, lf):
        with tc.record_attempts(greedy, ["traceback_offset"]) as calls:
            res = greedy.greedy_attempt_plain(probe_[0], code_at, k, ms, c,
                                              ii, rg, corr, lf)
        rem = lf - ii
        wk, wks = corr, [corr]
        fail = torch.full_like(ii, ms)
        for s_ in range(ms):
            ns, sa = sites.alt_next(probe_[0], wk, k)
            nxt = torch.where(ns != 1, wk, dc.add_nuc(wk, sa, k))
            rev = torch.stack([nxt == w for w in wks]).any(0)
            fail = torch.where((fail == ms) & ((ns != 1) | rev), s_, fail)
            wks.append(nxt)
            wk = nxt
        last = torch.where(res.ok, res.cnt - 2,
                           torch.minimum(torch.minimum(fail, rem + 1),
                                         torch.full_like(ii, ms)) - 1)
        o_val = torch.zeros_like(ii)
        for it, (_args, (exists, _o)) in enumerate(
                calls["traceback_offset"]):
            km, alive = wks[it + 1], (rem - it >= c)
            tried = torch.zeros_like(ii)
            for t in range(c):
                km = dc.add_nuc(km, code_at(ii + it + t), k)
                tried = tried + alive.long()
                alive = alive & probe_[0](km)
            o_val = o_val + torch.where(exists & (it <= last), tried, 0)
        n_walk = torch.minimum(fail + 1, torch.full_like(fail, ms))
        return res, ms + o_val, n_walk + (last >= 0).long()

    probe_ = [None]

    def attempt(probe, code_at, ii, rg, corr, lf):
        probe_[0] = probe
        if kind in walk.MODES:
            res, o, n = walk_rounds(code_at, ii, rg, corr, lf)
        elif kind == "greedy":
            res, o, n = greedy_rounds(code_at, ii, rg, corr, lf)
        elif kind == "two":
            res = two.two_attempt_plain(probe, code_at, k, c, ii, rg, corr,
                                        lf)
            o = two_thread_probes(probe, code_at, k, c, ii, corr, lf)
            n = torch.full_like(ii, 2)
        else:
            res = sites.one_attempt_plain(probe, code_at, k, c, ii, corr, lf)
            o = n = torch.ones_like(ii)
        pending.append((o, n))
        return res

    log2 = math.ceil(math.log2(n_eff + 1))
    log32 = math.ceil(math.log(n_eff + 1, 32))

    def trace(act, gate, probes, search, q):
        o_att, n_att = pending.pop()
        g = gate.nonzero().squeeze(1)
        oa = torch.zeros_like(probes)
        na = torch.zeros_like(probes)
        oa[g], na[g] = o_att, n_att
        near = q - act < 32
        old[act] += 1 + oa + probes + search.long() * log2
        new[act] += (1 + na + (probes > 0).long()
                     + search.long() * torch.where(near, 1, 1 + log32))

    ew = walk_profile(walk_max).ew if kind in walk.MODES else 1
    out = sites.run_sites_plain(table, codes, d.kmers, d.s_pos, d.n_sites,
                                rs, rl, k, ew, attempt, trace)
    return int(old.max()), int(new.max()), longest[0], out


def k1_bound_bytes(table, kmers, k, R, NS, hashed):
    """K1's bytes on one chunk: the codes and the slot table in, the
    table the probes read (the distinct bitfield words, or the index
    offsets and entries of the bucketed probes), the k-mers, three masks
    and the site list out; from its plain version's ``kmers``.  Also, for
    a sorted table, the bytes of whole-table searches past the bucketed
    ones (the first design's bound), else None."""
    import torch

    from br_tpu_torch.correct import device_codec as dc

    CHUNK = kmers.shape[0]
    cano = dc.canonical_any(kmers.long()[kmers != 0], k)
    pr8 = None
    if hashed:   # the index offsets and entries the probes read
        table_bytes = bucket_stats(table, cano)["probe_bytes"]
        # the first design's: the entries of whole-table searches
        pr8 = 8 * search_entries(table.table, cano) - table_bytes
    else:        # the bitfield words the probes read
        table_bytes = 4 * int(torch.unique(cano >> 6).numel())
    return (CHUNK + 8 * R + table_bytes + CHUNK * (1 + 1 + 1) + 4 * NS + 4
            + R + CHUNK * kmers.element_size()), pr8


def k3_bound_bytes(site_out, s_pos, n_sites, rs, rl, x_plain, name):
    """K3's bytes on one chunk: the read bases it copies, the slot and
    site tables and the visited records (12 bytes and ceil(cnt/16) emit
    words each) in; the chunk's output codes and per-read results out.
    Returns (bytes, visited records, listed and visited sites a read)."""
    from br_tpu_torch.correct.layout import SLOTS

    CHUNK, R, NS = x_plain.out.shape[0], rs.shape[0], s_pos.shape[0]
    vis, listed, visits = chain_visits(site_out, s_pos, n_sites, rs, rl,
                                       CHUNK)
    n_rec, rec_w = record_words(site_out, vis.repeat_interleave(SLOTS))
    check(n_rec == int(x_plain.rec_cnt.sum()),
          f"{name}: visited records {n_rec} vs "
          f"{int(x_plain.rec_cnt.sum())}")
    n_eff = min(int(n_sites[0]), NS)
    return (int(x_plain.out_len.sum()) + 9 * R + 12 * n_eff + 12 * n_rec
            + 4 * rec_w + CHUNK + 9 * R + 32), n_rec, listed, visits


def kernel_checks(table, chunk, k, c, ms, device, sync, kind="first",
                  reps=10, plain_reps=2, baseline=None, full=True,
                  walks=None):
    """Kernels against their plain versions on one chunk: on the first
    chunk K1-K7 at the default walk profile; on a retry chunk
    (``kind="retry"``) K1, K2, K5, K6 in both modes at walk_max 2040, K3
    on the walks' records and K4 on the chunk as it came in; on the
    long-walk chunk (``kind="long"``) K6 in both modes at walk_max 248
    and 2040 and K3 on their records.  With ``plain_reps`` 0 a plain
    version runs once: its time is that call's, and a walk's is the
    chain-floor run.  ``baseline`` (from load_baseline) gives K1-K7 as
    another tree built them: each is checked and timed beside this tree's.
    At k = 17 the k-mer kernels are their 64-bit instantiations (names
    ``<name>64``), with a HashSet's SortedTable their ``_h`` ones.
    Without ``full`` (the k = 17 and large-k checks) the chain floors and
    K3 and K4, which carry codes and do not change with k, are left out;
    ``walks``, when given, names the (walk_max, strategy) pairs of K6 to
    check on the chunk in place of the default ones.  Returns {name: {ms,
    plain_ms, bound_ms, max_abs_err, ...}}; names with a bracket are a
    kernel's further configurations."""
    import torch

    from br_tpu_torch import kernels
    from br_tpu_torch.correct import device_codec as dc
    from br_tpu_torch.correct import (greedy, probe, reverse, sites, splice,
                                      two, walk)
    from br_tpu_torch.correct.layout import (
        BIG, CAP_ATTEMPT, WALK_MAX, WIDE_WALK_MAX, site_capacity)

    packed, rstart, rlen = chunk
    CHUNK, R = packed.shape[0] * 4, rstart.shape[0]
    NS = site_capacity(CHUNK)
    codes = dc.unpack_codes(torch.from_numpy(packed).to(device), CHUNK)
    rs = torch.from_numpy(rstart).to(device)
    rl = torch.from_numpy(rlen).to(device)
    base = baseline or {}
    res = {}

    tkind = dc.table_kind(table)

    def w(name):
        """The instantiation of a k-mer kernel for this k and table."""
        return kernels.variant(name, k, tkind)

    def based(name, *args):
        """The baseline's call of kernel ``name`` on args, or None."""
        if name not in base:
            return None
        return lambda: base[name](*args)

    def run(name, kern, plain, nbytes, kreps=reps, view=tuple, kb=None):
        sync()
        t0 = time.perf_counter()
        b = plain()   # also the plain version's warm call
        sync()
        plain_once = (time.perf_counter() - t0) * 1e3
        a = kern()
        sync()
        if callable(nbytes):
            nbytes = nbytes(b)
        err = max_abs_err(view(a), view(b))
        check(err == 0, f"{name}: kernel and plain version differ "
                        f"(max abs err {err})")
        res[name] = {"ms": cuda_ms(kern, kreps, sync, queued=True),
                     "call_ms": cuda_ms(kern, kreps, sync, warm=False),
                     "plain_ms": (cuda_ms(plain, plain_reps, sync, warm=False)
                                  if plain_reps else plain_once),
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "max_abs_err": err}
        log(f"kernel {name}: " + json.dumps(
            {"kernel": name, "kernel_ms": res[name]["ms"],
             "call_ms": res[name]["call_ms"],
             "plain_ms": res[name]["plain_ms"],
             "bound_ms": res[name]["bound_ms"],
             "ms_over_bound": res[name]["ms"] / res[name]["bound_ms"]}))
        if kb is not None:
            err = max_abs_err(view(kb()), view(b))
            check(err == 0, f"{name}: the baseline and the plain version "
                            f"differ (max abs err {err})")
            fns = (kb, kern)
            t = [cuda_ms(fns[i], kreps, sync, queued=True) for i in (0, 1, 1, 0)]
            res[name]["baseline_ms"] = [t[0], t[3]]
            log(f"kernel {name} beside its baseline: " + json.dumps(
                {"baseline_ms": [t[0], t[3]], "kernel_ms": [t[1], t[2]],
                 "baseline_call_ms": cuda_ms(kb, kreps, sync, warm=False),
                 "bound_ms": res[name]["bound_ms"]}))
        return b

    floors = {}

    def floor(name, *args, **kw):
        """The chain floor, counted from a plain run; the run's output."""
        o, n, longest, out = chain_floor(*args, **kw)
        floors[name] = (o, n, longest)
        return out

    def log_floor(name):
        if name not in floors:
            return
        o, n, longest = floors[name]
        res[name].update(floor_old=o, floor_new=n)
        log(f"  {name}: chain floor {o} dependent round trips one thread a "
            f"site, {n} a warp a site" + (f"; longest walk {longest} steps"
                                          if longest else ""))

    # K1: codes, slot tables, the distinct bitfield words the probes read;
    # k-mers, three masks, the site list
    d_args = (table, codes, rs, rl, k, NS)
    d_plain = probe.dense_probe_plain(*d_args)
    k1_bytes, pr8_bytes = k1_bound_bytes(table, d_plain.kmers, k, R, NS,
                                         tkind == "hash")
    n_eff = min(int(d_plain.n_sites[0]), NS)
    k1_name = w("dense_probe") + {"first": "", "retry": "[retry chunk]",
                                  "long": "[long-walk chunk]"}[kind]
    d = run(k1_name, lambda: probe.dense_probe(*d_args),
            lambda: probe.dense_probe_plain(*d_args), k1_bytes, 20,
            kb=based("dense_probe", *d_args))
    if tkind == "hash":
        res[k1_name]["pr8_bound_ms"] = ((k1_bytes + pr8_bytes)
                                        / HBM_BYTES_PER_S * 1e3)
        log(f"  {k1_name}: pr8_bound_ms {res[k1_name]['pr8_bound_ms']}")

    def site_run(name, kern, plain, window, kreps=reps, kb=None):
        """A site kernel, compared on the entries it writes; its bytes
        from the plain version's records."""
        return run(name, kern, plain,
                   lambda out: sites_bytes(NS, n_eff, R, CHUNK, window, out),
                   kreps, view=sites.defined, kb=kb)

    def walk_run(st, wm):
        w_args = (table, codes, d.kmers, d.V, d.s_pos, d.n_sites, rs, rl, k,
                  c, st, wm)
        # the walk scans V to the error's end
        where = {"first": "", "retry": "retry chunk,",
                 "long": "long-walk chunk,"}[kind]
        name = (w("walk_sites") if (kind, wm, st) == ("first", WALK_MAX,
                                                      "graph")
                else f"{w('walk_sites')}[{where}{st},walk_max={wm}]")
        f_args = (name, st, table, codes, d, rs, rl, k, c, ms)
        if not full:
            plain = lambda: walk.walk_sites_plain(*w_args)  # noqa: E731
        elif plain_reps:
            plain = lambda: walk.walk_sites_plain(*w_args)  # noqa: E731
            floor(*f_args, walk_max=wm)
        else:   # one plain run: the reference, its time and the floor
            plain = lambda: floor(*f_args, walk_max=wm)  # noqa: E731
        out = site_run(name, lambda: walk.walk_sites(*w_args), plain,
                       3 * k + c, 3,
                       kb=based("walk_sites", *w_args))
        used = out.rec_p < BIG
        log(f"  {name}: {int(used.sum())} records, longest emit "
            f"{int(out.rec_c[used].max()) if bool(used.any()) else 0} "
            f"bases, {int((out.s_cap == CAP_ATTEMPT).sum())} walk caps")
        log_floor(name)
        return out

    # K3: the read bases it copies, the slot and site tables and the
    # visited records (12 bytes and ceil(cnt/16) emit words each); the
    # chunk's output codes and per-read results.  What sets its time is
    # the read with the longest chain: logged beside it.
    def k3(name, site_out):
        x_args = (codes, rs, rl, d.s_pos, d.n_sites, site_out, d.cap_read)
        x_plain = splice.chain_splice_plain(*x_args)
        nbytes, n_rec, listed, visits = k3_bound_bytes(
            site_out, d.s_pos, d.n_sites, rs, rl, x_plain, name)
        run(name, lambda: splice.chain_splice(*x_args),
            lambda: splice.chain_splice_plain(*x_args), nbytes, 20,
            kb=based("chain_splice", *x_args))
        longest, most = int(rl.argmax()), int(visits.argmax())
        log(f"  {name}: {res[name]['ms']:.4f} ms; longest read "
            f"{int(rl[longest])} bases, {int(listed[longest])} listed "
            f"sites, {int(visits[longest])} visited; most visited "
            f"{int(visits[most])} of {int(listed[most])} listed "
            f"({int(rl[most])} bases); windows of {splice.WINDOW} sites")
        return x_plain, n_rec

    # K2 and K5 on K1's output (and their baselines)
    s_args = (table, codes, d.kmers, d.s_pos, d.n_sites, rs, rl, k)
    if kind != "long":
        tag = "" if kind == "first" else "[retry chunk]"
        s = site_run(w("one_sites") + tag,
                     lambda: sites.one_sites(*s_args, c),
                     lambda: sites.one_sites_plain(*s_args, c), c + 3 + k,
                     20, kb=based("one_sites", *s_args, c))
        if full:
            floor("one_sites" + tag, "one", table, codes, d, rs, rl, k, c,
                  ms)
        log_floor("one_sites" + tag)
        site_run(w("two_sites") + tag, lambda: two.two_sites(*s_args, c),
                 lambda: two.two_sites_plain(*s_args, c), c + 6 + k, 20,
                 kb=based("two_sites", *s_args, c))
        if full:
            floor("two_sites" + tag, "two", table, codes, d, rs, rl, k, c,
                  ms)
        log_floor("two_sites" + tag)

    # K4: the chunk in and out, the slot table in
    def k4(name, *r_args):
        kb = based("reverse_slots", *r_args)
        run(name, lambda: (reverse.reverse_slots(*r_args),),
            lambda: (reverse.reverse_slots_plain(*r_args),),
            2 * CHUNK + 8 * R, 20, kb=kb and (lambda: (kb(),)))

    if kind != "first":
        tag = "retry chunk" if kind == "retry" else "long-walk chunk"
        # the k = 17 retry chunk: both walk profiles
        profiles = ((WIDE_WALK_MAX,) if kind == "retry" and full
                    else (WALK_MAX, WIDE_WALK_MAX))
        for wm, st in (walks if walks is not None else
                       [(wm, st) for wm in profiles
                        for st in ("graph", "gap-size")]):
            wo = walk_run(st, wm)
            if full:
                k3(f"chain_splice[{tag},{st} records,walk_max={wm}]", wo)
        if kind == "retry" and full:   # the chunk as it came in
            k4("reverse_slots[retry chunk]", codes, rs, rl)
        if not full:
            site_run(f"{w('greedy_sites')}[{tag}]",
                     lambda: greedy.greedy_sites(*s_args, ms, c),
                     lambda: greedy.greedy_sites_plain(*s_args, ms, c),
                     ms + c + k, 3)
        log(f"{tag}: {int((rl > 0).sum())} reads, {int(rl.sum())} bases, "
            f"{int(d.n_sites[0])} sites")
        return res

    # the walks and greedy on K1's output
    g = walk_run("graph", WALK_MAX)
    walk_run("gap-size", WALK_MAX)
    site_run(w("greedy_sites"), lambda: greedy.greedy_sites(*s_args, ms, c),
             lambda: greedy.greedy_sites_plain(*s_args, ms, c), ms + c + k,
             3, kb=based("greedy_sites", *s_args, ms, c))
    if full:
        floor("greedy_sites", "greedy", table, codes, d, rs, rl, k, c, ms)
    log_floor("greedy_sites")
    if not full:
        # the wide profile on this chunk too
        for wm, st in (walks if walks is not None else
                       [(WIDE_WALK_MAX, "graph"),
                        (WIDE_WALK_MAX, "gap-size")]):
            walk_run(st, wm)
        for ms_ in (14, 15):   # 32 and 33 DP columns at k = 17
            site_run(f"{w('greedy_sites')}[ms={ms_}]",
                     lambda: greedy.greedy_sites(*s_args, ms_, c),
                     lambda: greedy.greedy_sites_plain(*s_args, ms_, c),
                     ms_ + c + k, 3)
        log(f"first chunk at k={k}: {int((rl > 0).sum())} reads, "
            f"{int(rl.sum())} bases, {int(d.n_sites[0])} sites")
        return res
    x, n_rec = k3("chain_splice", s)
    k3("chain_splice[graph records]", g)

    k4("reverse_slots", x.out, rs, x.out_len)
    log(f"first chunk: {int((rl > 0).sum())} reads, {int(rl.sum())} bases, "
        f"{int(d.n_sites[0])} sites, {n_rec} visited `one` records")
    return res


def to_group(arrays, device):
    """A group's host arrays (``_group_arrays``) on the card: the packed
    codes, and the slot tables."""
    import torch

    return [torch.from_numpy(x).to(device) for x in arrays]


def group_checks(table, arrays, k, c, ms, device, sync, label, checks,
                 plain=True, into=None, walk_max=None, reps=10):
    """Every kernel of the chain on one group of chunks (``arrays``, from
    ``_group_arrays``), each launched once for the group: K11a on its
    packed codes, K1, K2, K5, K6 in both modes (at ``walk_max``, by
    default the default profile's), K7, K3 on the one and the graph
    records, K4 on K3's output, K11b.

    With ``plain``, each is held exactly against its plain version on
    every chunk (``kernels.each_chunk``; a site kernel through
    sites.defined), timed queued behind a spin (ms) and with the host
    launching (call_ms), against the group's bound (its chunks' bounds
    summed), its plain version's one call beside it: the entry
    ``<kernel>[label]`` of ``checks``.  Without, each is held exactly
    against the same kernel launched once a chunk over the same chunks
    (the NC = 1 chain's launches, which kernel_checks holds against the
    plain versions), and both are timed queued, with the group's bound
    and, for K11, the launch floor: group_ms, group_nc1_ms,
    group_bound_ms, group_chunks (and floor_ms) go into the entry
    ``<kernel>[into]`` of ``checks`` where there is one.  Every result is
    logged under ``label``."""
    import torch

    from br_tpu_torch import kernels
    from br_tpu_torch.correct import device_codec as dc
    from br_tpu_torch.correct import (greedy, probe, reverse, sites, splice,
                                      two, walk)
    from br_tpu_torch.correct.layout import WALK_MAX, site_capacity

    of = kernels.chunk_of
    packed, rs, rl = to_group(arrays, device)
    NC, R = rs.shape
    CHUNK = packed.shape[1] * 4
    NS = site_capacity(CHUNK)
    tkind = dc.table_kind(table)
    walk_max = WALK_MAX if walk_max is None else walk_max
    floor = None if plain else cuda_ms(lambda: torch.cuda._sleep(0), 20,
                                       sync, queued=True)
    tag = f"[{label}]"

    def w(name):
        return kernels.variant(name, k, tkind)

    def fields(x):
        return x if isinstance(x, tuple) else (x,)

    def step(name, fn, plain_fn, before, chunked, after, nbytes,
             view=fields):
        """Kernel ``fn(*before, *chunked, *after)`` on the group, checked
        and timed as the mode says; its bytes ``nbytes(output)``."""
        def group():
            return fn(*before, *chunked, *after)

        def one(i):
            return fn(*before, *(of(x, i) for x in chunked), *after)

        if plain:
            sync()
            t0 = time.perf_counter()
            want = kernels.each_chunk(plain_fn, before, chunked, after)
            sync()
            plain_ms = (time.perf_counter() - t0) * 1e3
            got = group()
            err = max_abs_err(view(got), view(want))
            check(err == 0, f"{name}{tag}: the group's kernel and the "
                            f"plain version differ (max abs err {err})")
        else:
            got = group()
            for i in range(NC):
                err = max_abs_err(view(of(got, i)), view(one(i)))
                check(err == 0, f"{name}{tag}: the group's chunk {i} "
                                f"differs from its own launch (max abs "
                                f"err {err})")
        bound = nbytes(got) / HBM_BYTES_PER_S * 1e3
        if plain:
            t = {"ms": cuda_ms(group, reps, sync, queued=True),
                 "call_ms": cuda_ms(group, reps, sync, warm=False),
                 "plain_ms": plain_ms, "bound_ms": bound,
                 "max_abs_err": err, "chunks": NC}
            checks[name + tag] = t
            ratios = {"ms_over_bound": t["ms"] / bound}
        else:
            t = {"group_ms": cuda_ms(group, reps, sync, queued=True),
                 "group_nc1_ms": cuda_ms(
                     lambda: [one(i) for i in range(NC)], reps, sync,
                     queued=True),
                 "group_bound_ms": bound, "group_chunks": NC}
            if name.startswith(("unpack_codes", "pack_codes")):
                t["floor_ms"] = floor
            if into is not None and f"{name}[{into}]" in checks:
                checks[f"{name}[{into}]"].update(t)
            ratios = {"nc1_over_group": t["group_nc1_ms"] / t["group_ms"],
                      "group_over_bound": t["group_ms"] / bound}
        log(f"kernel {name}{tag}: " + json.dumps({**t, **ratios}))
        return got

    codes = step("unpack_codes", dc.unpack_codes, dc.unpack_codes_plain,
                 (), (packed,), (CHUNK,),
                 lambda _o: NC * (CHUNK // 4 + CHUNK))
    d = step(w("dense_probe"), probe.dense_probe, probe.dense_probe_plain,
             (table,), (codes, rs, rl), (k, NS),
             lambda dp: sum(k1_bound_bytes(table, dp.kmers[i], k, R, NS,
                                           tkind == "hash")[0]
                            for i in range(NC)))

    def site_bytes(window):
        return lambda out: sum(sites_bytes(
            NS, min(int(d.n_sites[i, 0]), NS), R, CHUNK, window,
            of(out, i)) for i in range(NC))

    s_args = (codes, d.kmers, d.s_pos, d.n_sites, rs, rl)
    so = {}
    for st, mod, fn, extra, window in (
            ("one", sites, "one_sites", (c,), c + 3 + k),
            ("two", two, "two_sites", (c,), c + 6 + k),
            ("greedy", greedy, "greedy_sites", (ms, c), ms + c + k)):
        so[st] = step(w(fn), getattr(mod, fn), getattr(mod, fn + "_plain"),
                      (table,), s_args, (k, *extra), site_bytes(window),
                      view=sites.defined)
    w_args = (codes, d.kmers, d.V, d.s_pos, d.n_sites, rs, rl)
    for st in ("graph", "gap-size"):
        so[st] = step(w("walk_sites") + ("" if st == "graph" else f"[{st}]"),
                      walk.walk_sites, walk.walk_sites_plain, (table,),
                      w_args, (k, c, st, walk_max), site_bytes(3 * k + c),
                      view=sites.defined)
    x = None
    for st in ("one", "graph"):
        xo = step("chain_splice" + ("" if st == "one" else
                                    "[graph records]"),
                  splice.chain_splice, splice.chain_splice_plain, (),
                  (codes, rs, rl, d.s_pos, d.n_sites, so[st], d.cap_read),
                  (), lambda xg, st=st: sum(k3_bound_bytes(
                      of(so[st], i), d.s_pos[i], d.n_sites[i], rs[i], rl[i],
                      of(xg, i), st)[0] for i in range(NC)))
        x = xo if x is None else x
    out = step("reverse_slots", reverse.reverse_slots,
               reverse.reverse_slots_plain, (), (x.out, rs, x.out_len), (),
               lambda _o: NC * (2 * CHUNK + 8 * R))
    step("pack_codes", dc.pack_codes, dc.pack_codes_plain, (), (out,), (),
         lambda _o: NC * (CHUNK // 4 + CHUNK))
    log(f"group {label}: {NC} chunks of {CHUNK}, {int((rl > 0).sum())} "
        f"reads, {int(rl.sum())} bases, {int(d.n_sites.sum())} sites"
        + ("" if plain else f"; launch floor {floor} ms"))


def small_group(corrector, seqs):
    """The host arrays of a group of three chunks of 2^15 positions and
    32 slots, planned as ``corrector`` plans (its first reads of
    ``seqs``): the group checks at k = 17 and 21, whose plain walks run
    long on full chunks."""
    from br_tpu_torch.correct.engine3 import Torch3Corrector

    planner = Torch3Corrector(corrector.valid_kmer, corrector.corrections,
                              corrector.c, corrector.ms, chunk=1 << 15,
                              nreads=32, device=corrector.device,
                              table=corrector.table)
    return planner._group_arrays(seqs, planner._plan(seqs, set(),
                                                     set())[:3])


def path_groups(table, inst, k, device, sync, checks,
                profiles=("default", "wide")):
    """A path's first group of each of ``profiles`` that held a read
    (instrument's first_group: the shapes the path gave its kernels, the
    default profile's up to NC_MAX chunks of 2^20, the wide sibling's of
    2^18 at walk_max 2040), each kernel held against one-chunk launches
    over its chunks (group_checks without plain); the default group's
    times go into the entries of the k's group of three."""
    from br_tpu_torch.correct.layout import WALK_MAX, WIDE_WALK_MAX

    for prof in profiles:
        arrays = inst["first_group"].get(prof)
        check(arrays is not None, f"k={k}: the path ran no {prof} group")
        group_checks(table, arrays, k, C, MS, device, sync,
                     f"first {prof} group, k={k}", checks, plain=False,
                     into=GROUP_LABEL[k] if prof == "default" else None,
                     walk_max=WALK_MAX if prof == "default"
                     else WIDE_WALK_MAX)


def torch_cases():
    """tests/torch_cases.py, the seeded generators of the port's tests
    (it imports numpy and br_tpu_torch; JAX only inside the functions
    that record the JAX package's outputs, which nothing here calls)."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import torch_cases as tc

    return tc


def long_walk_chunk(device):
    """The long-walk chunk at the main path's geometry (CHUNK = 2^20,
    R = 512, k = 13), drawn by tests/torch_cases.walk_stress_case from
    SEED: a branch-free genome, reads with planted deletions of 100-2,500
    bases (graph walks past 248 and past 2,040), random stretches (fills),
    substitutions, nested deletions past SLOTS, and chimeras into tandem
    repeats whose walks revisit at steps 31-33, 247-249 and 2,039-2,041
    (those past walk_max found by Brent).  Returns (bitfield, (packed,
    rstart, rlen))."""
    import torch

    from br_tpu_torch.correct import device_codec as dc
    from br_tpu_torch.correct.layout import WALK_MAX, WIDE_WALK_MAX
    from br_tpu_torch.set.solid import SolidSet

    pieces, codes, rstart, rlen = torch_cases().walk_stress_case(
        SEED, (WALK_MAX, WIDE_WALK_MAX), chunk=1 << 20, nreads=512,
        deletions=(100, 2500), flanks=(200, 1500))
    packed = dc.pack_codes(torch.from_numpy(codes)).numpy()
    table = SolidSet.from_sequences(pieces, K).device_words(device)
    return table, (packed, rstart, rlen)


def instrument(corrector):
    """Keep, for the corrector and its wide retry sibling, every pass's
    aux counters and CUDA events around it (no synchronisation), by
    profile and strategy, the host seconds of the oracle, the retry
    sibling's first chunk as packed, each profile's first group that
    holds a read as packed (``_group_arrays``), and the groups and chunks
    each profile dispatched; the passes, the oracle, the packing and the
    dispatch themselves are unchanged.  Returns {"kept", "oracle_s",
    "retry", "first_group": {profile: arrays}, "groups": {profile:
    [groups, chunks]}}."""
    import torch

    kept, oracle_s, retry, first_group = [], [], [], {}
    groups = {"default": [0, 0], "wide": [0, 0]}
    wide = corrector._get_wide()

    def first_chunk(seqs, idxs, starts, out=None, fn=wide._chunk_arrays):
        out = fn(seqs, idxs, starts, out)
        if not retry:
            retry.append(tuple(np.array(a) for a in out))
        return out
    wide._chunk_arrays = first_chunk
    for cor, prof in ((corrector, "default"), (wide, "wide")):
        for st, fn in list(cor._passes.items()):
            def counted(table, a, rs, n, fn=fn, tag=(prof, st)):
                ev = [torch.cuda.Event(enable_timing=True) for _ in "se"]
                ev[0].record()
                out = fn(table, a, rs, n)
                ev[1].record()
                kept.append((tag, out[3], ev))
                return out
            cor._passes[st] = counted

        def timed(seqs, two_side, fn=cor._oracle_correct_many):
            t0 = time.perf_counter()
            out = fn(seqs, two_side)
            oracle_s.append(time.perf_counter() - t0)
            return out
        cor._oracle_correct_many = timed

        def dispatch(seqs, group, *a, fn=cor._dispatch_group, n=groups[prof],
                     **kw):
            n[0] += 1
            n[1] += len(group)
            return fn(seqs, group, *a, **kw)
        cor._dispatch_group = dispatch

        def packed(seqs, group, fn=cor._group_arrays, prof=prof):
            out = fn(seqs, group)
            if prof not in first_group and out[2].any():
                first_group[prof] = tuple(np.array(a) for a in out)
            return out
        cor._group_arrays = packed
    return {"kept": kept, "oracle_s": oracle_s, "retry": retry,
            "first_group": first_group, "groups": groups}


def expected_launches(chain, groups, two_side=False, sfx=""):
    """The chain kernels' launches of a path that ran ``groups`` groups
    (both profiles' summed) of the strategies ``chain``: a group makes
    each of a chunk's launches once (K11a, K11b; K1, the strategy's site
    kernel and K3's two kernels a pass, every pass twice and K4 twice
    without two_side)."""
    d = 1 if two_side else 2
    want = dict.fromkeys(("unpack_codes", "pack_codes"), groups)
    want["dense_probe" + sfx] = d * len(chain) * groups
    want["chain_splice"] = 2 * d * len(chain) * groups
    want["reverse_slots"] = 0 if two_side else 2 * groups
    for st in chain:
        name = {"one": "one_sites", "two": "two_sites", "graph":
                "walk_sites", "gap-size": "walk_sites",
                "greedy": "greedy_sites"}[st] + sfx
        want[name] = want.get(name, 0) + d * groups
    return want


def check_launches(label, launches, inst, chain, two_side=False, sfx=""):
    """Fail unless the path's chain kernels launched exactly as its
    groups say (``expected_launches``); log the groups."""
    g = inst["groups"]
    want = expected_launches(chain, g["default"][0] + g["wide"][0],
                             two_side, sfx)
    got = {n: launches[n] for n in want}
    log(f"{label} groups: " + json.dumps({
        "groups_chunks": g, "launches": got}))
    check(got == want, f"{label}: launches {got}, expected {want} from "
                       f"the groups {g}")


def cap_reasons(kept):
    """Per profile and strategy: passes (a group's pass over its chunks
    is one) and chunk passes, their seconds on the device (CUDA events
    around each pass: K1, the site kernel, K3 and the pass's small
    PyTorch ops), capped sites by reason (aux 1-3), chunk passes whose
    chunk had more sites than NS (aux[7] > aux[0]) and the sites they
    dropped, capped reads (aux 6)."""
    import torch

    out = {}
    if not kept:
        return out
    aux = torch.cat([a.reshape(-1, 8) for _t, a, _e in kept]).long().cpu()
    rows = iter(aux.numpy())
    for tag, a, ev in kept:
        r = out.setdefault(f"{tag[0]}/{tag[1]}", {
            "passes": 0, "chunk_passes": 0, "device_s": 0.0,
            "cap_overflow": 0, "cap_attempt": 0, "cap_rounds": 0,
            "ns_overflow_passes": 0, "ns_dropped_sites": 0,
            "capped_reads": 0})
        r["passes"] += 1
        r["device_s"] += ev[0].elapsed_time(ev[1]) / 1e3
        for _ in range(a.reshape(-1, 8).shape[0]):
            row = next(rows)
            r["chunk_passes"] += 1
            r["cap_overflow"] += int(row[1])
            r["cap_attempt"] += int(row[2])
            r["cap_rounds"] += int(row[3])
            r["ns_overflow_passes"] += int(row[7] > row[0])
            r["ns_dropped_sites"] += int(row[7] - row[0])
            r["capped_reads"] += int(row[6])
    return out


def drive(args, make, sync, k8_times=None):
    """One path through the CLI's entry points (build_set, then the
    corrector ``make(solid)`` gives, then run_correction), launch counts
    set to 0 just before and read just after.  With ``k8_times`` (a
    dict), build_set's parts are timed into it: ``k8_device_ms``, CUDA
    events around device_build.build_words (K8's whole build, queued as
    build_set queues it), ``pack_reads_s``, the host's packing of the
    reads and their copy to the card, and ``read_s``, the rest of
    count_s (the FASTA read, the Python around it).  Returns the solid
    set, the corrector, the records written, count_s, correct_s and the
    launch counts."""
    import torch

    from br_tpu_torch import cli, kernels, runtime
    from br_tpu_torch.set import device_build as db

    own = db.build_words, db.pack_reads
    events, packs = [], []

    def build_words(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = own[0](*a, **kw)
        ev[1].record()
        events.append(ev)
        return out

    def pack_reads(*a, **kw):
        t0 = time.perf_counter()
        out = own[1](*a, **kw)
        packs.append(time.perf_counter() - t0)
        return out

    if k8_times is not None:
        db.build_words, db.pack_reads = build_words, pack_reads
    kernels.reset_launches()
    sync()
    t0 = time.perf_counter()
    try:
        solid = cli.build_set(args)
        sync()
    finally:
        db.build_words, db.pack_reads = own
    count_s = time.perf_counter() - t0
    if k8_times is not None:
        k8_times["k8_device_ms"] = sum(a.elapsed_time(b) for a, b in events)
        k8_times["pack_reads_s"] = sum(packs)
        k8_times["read_s"] = (count_s - k8_times["pack_reads_s"]
                              - k8_times["k8_device_ms"] / 1e3)
    corrector = make(solid)
    t0 = time.perf_counter()
    n = runtime.run_correction(args.inputs, args.outputs, solid,
                               args.corrections, args.confirm,
                               args.max_search, args.two_side,
                               record_buffer=args.record_buffer,
                               line_width=args.line_width,
                               corrector=corrector)
    sync()
    return (solid, corrector, n, count_s, time.perf_counter() - t0,
            dict(kernels.LAUNCHES))


#: what the oracle check's worker processes read (set before they fork)
_ORACLE: dict = {}


def _oracle_read(i):
    """The port's oracle on read i of the oracle check (a worker)."""
    from br_tpu_torch.correct.reference import correct_read

    return correct_read(_ORACLE["seqs"][i], _ORACLE["methods"],
                        two_side=False)


def oracle_check(label, out, seqs, chain, solid, host, k=K, sample=None,
                 host_sample=None):
    """A seeded sample of ``sample`` (SAMPLE) reads plus every
    host-corrected read (or a seeded ``host_sample`` of them) against the
    port's oracle of ``chain`` at k, the reads spread over one forked
    process a host core (the children run the Python oracle only, and
    read the set the parent holds)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from br_tpu_torch.correct.engine3 import host_set
    from br_tpu_torch.correct.reference import build_methods
    from br_tpu_torch.io.fasta import read_records

    got = [s for _d, s, _q in read_records(out)]
    check(len(got) == len(seqs), f"{label}: output record count")
    rng = np.random.default_rng(SEED)
    picked = set(rng.choice(len(seqs), SAMPLE if sample is None else sample,
                            replace=False).tolist())
    if host_sample is not None and host_sample < len(host):
        host = rng.choice(sorted(host), host_sample, replace=False).tolist()
    picked |= set(host)
    solid = host_set(solid)
    check(solid.k == k, f"{label}: the set's k is {solid.k}, not {k}")
    methods = build_methods(chain, solid, C, MS)
    solid.get(0)   # a HashSet builds its lookup set once, before the fork
    _ORACLE.update(seqs=seqs, methods=methods)
    idx = sorted(picked)
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            max_workers=os.cpu_count() or 1,
            mp_context=multiprocessing.get_context("fork")) as pool:
        want = list(pool.map(_oracle_read, idx, chunksize=1))
    _ORACLE.clear()
    bad = [i for i, w in zip(idx, want) if got[i] != w]
    check(not bad, f"{label}: {len(bad)} sampled reads differ from the "
                   f"oracle (first {bad[:5]})")
    changed = sum(got[i] != seqs[i] for i in picked)
    log(f"{label} oracle check: {len(picked)} reads equal ({changed} "
        f"corrected), {time.perf_counter() - t0:.1f} s")


#: abundances K8 is checked at on the card: every counter width (1, 2, 4
#: and 8 bits) and both ends, where nothing is counted
ABUNDANCES = (-1, 0, 1, 2, 3, 6, 7, 14, 15, 254, 255, 256)


def k8_sweep(p, k, sync, reps=10):
    """K8a and the whole build across abundances (counter widths) on one
    batch, each a whose counters take one partition under the default
    cap: the CAS updates it needs (sum of min(count, a + 1) over the
    distinct k-mers), K8a's ms from zeroed counters and again on the
    counters it left (every update past a + 1 skipped: the loads alone),
    and the whole build's ms.  Logged, one line an a (with --baseline
    only)."""
    import torch

    from br_tpu_torch.set import device_build as db

    _u, c = torch.unique(db.canonical_index(p, k), return_counts=True)
    half = 1 << (2 * k - 1)
    for a in (0, 1, 2, 3, 6, 14, 15, 254):
        w = db.counter_bits(a)
        if db.partition_size(k, w, db.DEFAULT_MAX_COUNT_BYTES) < half:
            continue
        counts = torch.zeros(half * w // 32, dtype=torch.int32,
                             device=p.codes.device)
        line = {"k": k, "a": a, "counter_bits": w, "distinct": c.numel(),
                "positions": int(c.sum()),
                "cas_updates": int(c.clamp(max=a + 1).sum())}
        line["k8a_ms"] = cuda_ms(lambda: db.count_kmers(p, k, 0, a, counts),
                                 reps, sync, queued=True, setup=counts.zero_)
        line["k8a_saturated_ms"] = cuda_ms(
            lambda: db.count_kmers(p, k, 0, a, counts), reps, sync,
            queued=True)
        del counts
        line["build_ms"] = cuda_ms(lambda: db.build_words([[p]], k, a), reps,
                                   sync, queued=True)
        log("K8 sweep: " + json.dumps(line))
        torch.cuda.empty_cache()


def solid_checks(seqs, k, device, sync, reps=10, baseline=None):
    """K8 on the card against its plain versions, on ``seqs`` at k and a
    = 2 (2-bit counters): K8a counting into the build's first partition
    of the half-space (the counter words compared exactly with the plain
    count's), K8b packing that partition (words compared exactly); each
    timed as the kernel checks time them, K8a from zeroed counters (the
    zeroing queued outside its events), with its bound and, for K8a, the
    library call on the same canonical k-mers (torch.unique with counts,
    the host in the loop: it synchronises).  K8b is timed as the build
    launches it: leaving the counters where the partition is the only
    one, clearing them where more follow (then its last launch, which
    leaves them, is logged beside it).  Then the whole build
    (build_words: the counters' zeroing, K8a, K8b), timed and held to the
    function's bound (the packed reads and the read starts read once, the
    bitfield written once), its peak device memory; with ``baseline``'s
    K8 (load_baseline's "k8"), the other tree's build and kernels
    checked and timed beside this tree's (baseline, this tree, this
    tree, baseline), and K8 across abundances (k8_sweep).  Bounds:
    ``bound_ms`` each kernel's own reads and
    writes (K8a: the packed reads, the starts, each counter word it
    changes read and written; K8b: the counters read, the bitfield
    written), ``old_bound_ms`` the same kernel's as the u32 design
    counted it (8 bytes a distinct k-mer; 4 a count read, 4 more
    cleared).  Last, K8's build against the plain build at every a of
    ABUNDANCES.  Returns {name: {...}}."""
    import torch

    from br_tpu_torch import kernels
    from br_tpu_torch.set import device_build as db

    a = 2
    w = db.counter_bits(a)
    p = db.pack_reads(seqs, k, device)
    half = 1 << (2 * k - 1)
    psize = db.partition_size(k, w, db.DEFAULT_MAX_COUNT_BYTES)
    nparts = -(-half // psize)
    idx = db.canonical_index(p, k)
    local = idx[idx < psize]
    distinct = int(torch.unique(local).numel())
    touched = int(torch.unique((local * w) >> 5).numel())
    counts = torch.zeros(psize * w // 32, dtype=torch.int32, device=device)
    want = torch.zeros_like(counts)
    sync()
    t0 = time.perf_counter()
    db.count_kmers_plain(p, k, 0, a, want)
    sync()
    count_plain_ms = (time.perf_counter() - t0) * 1e3
    db.count_kmers(p, k, 0, a, counts)
    sync()
    check(torch.equal(counts, want), f"K8a at k={k}: counters differ")
    del want
    res = {}
    name = kernels.variant("solid_count", k)
    in_bytes = p.codes.numel() + 8 * p.starts.numel()
    ms = 1e3 / HBM_BYTES_PER_S
    res[name] = {
        "ms": cuda_ms(lambda: db.count_kmers(p, k, 0, a, counts), reps,
                      sync, queued=True, setup=counts.zero_),
        "plain_ms": count_plain_ms,
        "bound_ms": (in_bytes + 8 * touched) * ms,
        "old_bound_ms": (in_bytes + 8 * distinct) * ms, "max_abs_err": 0,
        "library_ms": cuda_ms(lambda: torch.unique(local,
                                                   return_counts=True),
                              reps, sync)}
    del idx, local
    check(db.counter_fields(counts, w).max() == a + 1,
          f"K8a at k={k}: no counter saturated")
    words = torch.empty(psize // 32, dtype=torch.int32, device=device)
    wplain = torch.empty_like(words)
    db.threshold_pack(counts, a, words, clear=False)
    t0 = time.perf_counter()
    db.threshold_pack_plain(counts, a, wplain, clear=False)
    sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(words, wplain), f"K8b at k={k}: words differ")
    del wplain

    def pack_bound(clear):
        # read each counter once, write each bitfield word once; the
        # clear writes the counters back
        return ((1 + clear) * psize * w // 8 + psize // 8) * ms

    def old_pack_bound(clear):
        return ((4 + 4 * clear) * psize + psize // 8) * ms

    keep_ms = cuda_ms(lambda: db.threshold_pack(counts, a, words,
                                                clear=False),
                      reps, sync, queued=True)
    pname = "solid_pack" if k <= 15 else "solid_pack[k=17]"
    res[pname] = {"ms": keep_ms, "plain_ms": plain_ms, "max_abs_err": 0,
                  "clear": nparts > 1, "bound_ms": pack_bound(False),
                  "old_bound_ms": old_pack_bound(False), "library_ms": None}
    if nparts > 1:
        res[pname].update(
            ms=cuda_ms(lambda: db.threshold_pack(counts, a, words,
                                                 clear=True),
                       reps, sync, queued=True),
            bound_ms=pack_bound(True), old_bound_ms=old_pack_bound(True),
            last_partition_ms=keep_ms,
            last_partition_bound_ms=pack_bound(False))
        check(not counts.any(), f"K8b at k={k}: the counters were not "
                                "cleared")
    zero_ms = cuda_ms(counts.zero_, reps, sync, queued=True)
    del counts, words

    # the whole build
    want = db.solid_words_plain([p], k, a)
    torch.cuda.empty_cache()
    sync()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = db.build_words([[p]], k, a)
    sync()
    build_mem = torch.cuda.max_memory_allocated() - base_mem
    check(torch.equal(got, want), f"K8 at k={k}: the build differs from "
                                  "the plain build")
    del got
    build = {"build_ms": cuda_ms(lambda: db.build_words([[p]], k, a), reps,
                                 sync, queued=True),
             "build_bound_ms": (in_bytes + db.half_words(k) * 4) * ms,
             "zero_ms": zero_ms, "build_peak_bytes": build_mem,
             "counter_bytes": psize * w // 8, "partitions": nparts}
    k8 = (baseline or {}).get("k8")
    if k8:
        kb = lambda: k8["build"]([[p]], k, a)  # noqa: E731
        torch.cuda.empty_cache()
        sync()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        check(torch.equal(kb(), want), f"K8 at k={k}: the baseline build "
                                       "differs from the plain build")
        sync()
        old_mem = torch.cuda.max_memory_allocated() - base_mem
        torch.cuda.empty_cache()
        t = [cuda_ms(f, reps, sync, queued=True)
             for f in (kb, lambda: db.build_words([[p]], k, a),
                       lambda: db.build_words([[p]], k, a), kb)]
        build.update(baseline_build_ms=[t[0], t[3]],
                     build_ms_pair=[t[1], t[2]],
                     baseline_build_peak_bytes=old_mem)
    for r in (res[name], res[pname]):
        r.update(build)
    del want
    torch.cuda.empty_cache()
    for nm, r in res.items():
        log(f"kernel {nm}: " + json.dumps(
            {"kernel": nm, "k": k, "a": a, "counter_bits": w,
             "reads": len(seqs), "bases": p.n_bases,
             "partition_counters": psize, "partitions": nparts,
             "distinct_kmers": distinct, "touched_counter_words": touched,
             "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "old_bound_ms": r["old_bound_ms"],
             "library_ms": r["library_ms"],
             "ms_over_bound": r["ms"] / r["bound_ms"],
             **{key: r[key] for key in (
                 "clear", "last_partition_ms", "last_partition_bound_ms",
                 "baseline_ms", "baseline_clear") if key in r}}))
    log(f"K8 whole build at k={k}: " + json.dumps(
        {**build, "build_over_bound": build["build_ms"]
         / build["build_bound_ms"]}))
    if baseline:
        k8_sweep(p, k, sync, reps)
    # every abundance, on the same batch
    for ab in ABUNDANCES:
        before = dict(kernels.LAUNCHES)
        got = db.build_words([[p]], k, ab)
        check(torch.equal(got, db.solid_words_plain([p], k, ab)),
              f"K8 at k={k}, a={ab}: the build differs from the plain "
              "build")
        if 0 <= ab <= 254:
            check(kernels.LAUNCHES[name] > before[name],
                  f"K8 at k={k}, a={ab}: K8a was not launched")
        del got
        torch.cuda.empty_cache()
    log(f"K8 at k={k}: equal to the plain build at a = "
        f"{', '.join(map(str, ABUNDANCES))}")
    return res


def path_report(label, args, solid, corrector, n, count_s, correct_s,
                launches, inst, n_bases, card, need,
                max_fallback=MAX_FALLBACK, set_times=None):
    """Log a main path's numbers (``set_times``, when given, beside
    count_s: the set's further builds, in ms); fail on a kernel of
    ``need`` not launched, on a record count other than the input's or on
    more than ``max_fallback`` of the reads on the host (None: the share
    is logged, not held to a limit)."""
    kept, oracle_s = inst["kept"], inst["oracle_s"]
    st = corrector.last_stats
    reasons = cap_reasons(kept)
    log(f"{label} cap reasons: " + json.dumps(reasons))
    device_s = sum(r["device_s"] for r in reasons.values())
    engine = corrector._engine
    log(f"{label}: " + json.dumps({
        "chain": args.corrections, "k": solid.k, "card": card, "reads": n,
        "bases": n_bases, "solid_frac": (
            len(solid) if hasattr(solid, "device_table") else
            solid.count_ones()) / float(1 << (2 * solid.k - 1)),
        "count_s": count_s, **(set_times or {}), "correct_s": correct_s,
        "reads_per_s": n / correct_s, "bases_per_s": n_bases / correct_s,
        "pass_device_s": device_s, "host_oracle_s": sum(oracle_s),
        "rest_s": correct_s - device_s - sum(oracle_s),
        "host_engine": None if engine is None else {
            "name": type(engine).__name__,
            "library": os.path.basename(engine._lib._name),
            "threads": engine.threads, "calls": len(oracle_s)},
        "last_stats": st, "launches": launches}))
    for name in need:
        check(launches[name] > 0,
              f"{label}: kernel {name} was not launched")
    frac = st["fallback"] / max(1, st["total"])
    log(f"{label}: fallback share {frac:.4f} ({st['fallback']} of "
        f"{st['total']} reads on the host), correct_s {correct_s:.3f}, "
        f"host_oracle_s {sum(oracle_s):.3f}")
    if max_fallback is not None:
        check(frac <= max_fallback,
              f"{label}: {st['fallback']} of {st['total']} reads went to "
              f"the host (> {max_fallback:.0%})")
    return device_s


#: the kernels each path launches
NEED13 = ("dense_probe", "one_sites", "two_sites", "walk_sites",
          "greedy_sites", "chain_splice", "reverse_slots", "solid_count",
          "solid_pack", "unpack_codes", "pack_codes")
NEED17 = ("dense_probe64", "one_sites64", "two_sites64", "walk_sites64",
          "greedy_sites64", "chain_splice", "reverse_slots", "solid_count64",
          "solid_pack", "unpack_codes", "pack_codes")
#: the mesh path's: the k = 13 path's and K10
NEED_MESH = NEED13 + ("merge_counts",)


#: further numbers a kernel's entry of the summary line carries, where
#: its check has them: an earlier definition's bound (K9, dense_probe_h;
#: K8), and K8's whole build beside its function bound
ENTRY_EXTRAS = ("pr8_bound_ms", "old_bound_ms", "build_ms",
                "build_bound_ms", "baseline_ms", "baseline_build_ms",
                "chunks", "group_ms", "group_nc1_ms", "group_bound_ms",
                "group_chunks", "floor_ms")


NEED_LARGE = ("dense_probe_h", "one_sites_h", "two_sites_h", "walk_sites_h",
              "greedy_sites_h", "chain_splice", "reverse_slots",
              "unpack_codes", "pack_codes")


def corpus_genome():
    """The corpus's genome (ASCII bytes): the first ``rng.integers(0, 4,
    GENOME)`` draw of PCG64(SEED), as br_tpu_torch.corpus.write_corpus
    draws it before its reads."""
    from br_tpu_torch.corpus import BASES

    rng = np.random.Generator(np.random.PCG64(SEED))
    return BASES[rng.integers(0, 4, GENOME)].tobytes()


def write_solid_csv(seqs, k, a, path):
    """The solid k-mers of ``seqs`` at k as a k-mer count CSV, the input
    of br's `large-kmer -f csv` (a header row, then `kmer,count`, one row
    a canonical k-mer seen more than ``a`` times), as a k-mer counter's
    dump gives it: counted with numpy (np.unique over the reads'
    canonical k-mers).  Returns the number of rows."""
    from br_tpu_torch import codec

    parts = [codec.canonical_np(codec.rolling_kmers_np(
        codec.encode_ascii_np(np.frombuffer(s, np.uint8)), k), k)
        for s in seqs if len(s) >= k]
    kmers, counts = np.unique(np.concatenate(parts), return_counts=True)
    del parts
    keep = counts > a
    kmers, counts = kmers[keep], counts[keep]
    shifts = np.arange(2 * (k - 1), -1, -2, dtype=np.uint64)
    letters = np.frombuffer(b"ACTG", np.uint8)[
        (kmers[:, None] >> shifts[None, :]) & np.uint64(3)]
    with open(path, "w") as fh:
        fh.write("kmer,count\n")
        fh.writelines(f"{s},{c}\n" for s, c in zip(
            letters.view(f"S{k}").ravel().astype(str), counts.tolist()))
    return int(kmers.size)


def hash_probe_check(name, table, kmers, k, sync, reps=10, baseline=None,
                     index_ms=None):
    """K9 on ``kmers`` through ``table`` (a SortedTable) against its plain
    version (exactly), timed as the kernel checks time a kernel, beside
    torch.searchsorted on the same canonical k-mers and the table with its
    sentinel mapped to INT64_MAX (torch compares int64 as signed); with
    ``baseline``, beside the other tree's K9 (baseline, this tree, this
    tree, baseline).  Its bound: each k-mer read and each result written
    once, and the distinct index offsets and table entries that the
    bucketed probes read (bucket_stats' probe_bytes); ``pr8_bound_ms``
    keeps the first design's, the distinct entries that a binary search
    of the whole table reads (search_entries) in their place.  Beside
    them the index's statistics, ``index_ms`` (the index build's time)
    and, with ``baseline``, K9's time through indexes of other widths
    (b - 2 to b + 2, each built and checked: the b the port takes is
    index_bits').  Returns {name: {...}}."""
    import torch

    from br_tpu_torch.correct import device_codec as dc
    from br_tpu_torch.correct.hash_probe import hash_probe

    sync()
    t0 = time.perf_counter()
    want = dc.make_hash_probe(table, k)(kmers)
    sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = hash_probe(table, kmers, k)
    sync()
    err = max_abs_err((got,), (want,))
    check(err == 0, f"{name}: K9 and its plain version differ")
    cano = dc.canonical_any(kmers, k)
    entries_t = table.table
    mapped = torch.where(entries_t < 0, torch.iinfo(torch.int64).max,
                         entries_t)
    pos = torch.searchsorted(mapped, cano).clamp(max=entries_t.numel() - 1)
    check(torch.equal(got, mapped[pos] == cano),
          f"{name}: K9 and torch.searchsorted differ")
    entries = search_entries(entries_t, cano)
    stats = bucket_stats(table, cano)
    fn = lambda: hash_probe(table, kmers, k)  # noqa: E731
    r = {"ms": cuda_ms(fn, reps, sync, queued=True),
         "plain_ms": plain_ms,
         "bound_ms": ((9 * kmers.numel() + stats["probe_bytes"])
                      / HBM_BYTES_PER_S * 1e3),
         "pr8_bound_ms": ((9 * kmers.numel() + 8 * entries)
                          / HBM_BYTES_PER_S * 1e3),
         "max_abs_err": err,
         "library_ms": cuda_ms(lambda: torch.searchsorted(mapped, cano),
                               reps, sync, queued=True)}
    line = {"kernel": name, "k": k, "probes": kmers.numel(),
            "table_entries": entries_t.numel(),
            "levels": dc.table_levels(entries_t), **stats,
            "index_build_ms": index_ms,
            "binary_search_dependent_loads": dc.table_levels(entries_t) + 1,
            "binary_search_entries_read": entries, "hits": int(got.sum()),
            "kernel_ms": r["ms"], "plain_ms": plain_ms,
            "bound_ms": r["bound_ms"], "pr8_bound_ms": r["pr8_bound_ms"],
            "library_ms": r["library_ms"],
            "ms_over_bound": r["ms"] / r["bound_ms"],
            "ms_over_pr8_bound": r["ms"] / r["pr8_bound_ms"]}
    if baseline and "hash_probe" in baseline:
        kb = lambda: baseline["hash_probe"](table, kmers, k)  # noqa: E731
        check(torch.equal(kb(), want), f"{name}: the baseline K9 and the "
                                       "plain version differ")
        t = [cuda_ms((kb, fn)[i], reps, sync, queued=True)
             for i in (0, 1, 1, 0)]
        r["baseline_ms"] = [t[0], t[3]]
        line.update(baseline_ms=[t[0], t[3]], kernel_ms_pair=[t[1], t[2]])
        line["index_bits_sweep"] = index_sweep(name, entries_t, kmers, k,
                                               stats["index_bits"], want,
                                               sync, reps)
    log(f"kernel {name}: " + json.dumps(line))
    return {name: r}


def index_sweep(name, entries, kmers, k, b0, want, sync, reps):
    """K9 on ``kmers`` through bucket indexes of b0 - 2 to b0 + 2 bits over
    the padded sorted table ``entries``, each built, timed and held against
    ``want``: {bits: {bucket_levels, build_ms, kernel_ms}}."""
    import torch

    from br_tpu_torch.correct import device_codec as dc
    from br_tpu_torch.correct.hash_probe import hash_probe

    sweep = {}
    for b in range(max(0, b0 - 2), min(b0 + 2, dc.MAX_INDEX_BITS, 2 * k) + 1):
        sync()
        t0 = time.perf_counter()
        other = dc.sorted_table(entries, k, b)
        sync()
        build_ms = (time.perf_counter() - t0) * 1e3
        check(torch.equal(hash_probe(other, kmers, k), want),
              f"{name}: K9 through a {b}-bit index differs")
        sweep[b] = {"bucket_levels": other.bucket_levels,
                    "build_ms": build_ms,
                    "kernel_ms": cuda_ms(lambda: hash_probe(other, kmers, k),
                                         reps, sync, queued=True)}
        del other
    return sweep


def big_table_checks(chunk, device, sync, baseline=None):
    """K9 and K1 (dense_probe_h) at k = K_BIG on a sorted table of
    BIG_ENTRIES entries (1 GiB, far past the 50 MB L2, the size of a 100
    Mb genome's set): the canonical k-mers of the corpus's genome and
    random canonical k-mers, padded with the sentinel 1 << 63, drawn on
    the card, and its bucket index (built there, timed); K9 on the
    k-mers of ``chunk``'s positions, K1 on the chunk (its reads' k-mers
    hit the genome's, their errors miss); each held exactly against its
    plain version and timed (with ``baseline``, beside the other tree's).
    Returns {name: {...}}."""
    import torch

    from br_tpu_torch.correct import device_codec as dc
    from br_tpu_torch.correct import probe
    from br_tpu_torch.correct.layout import site_capacity

    k = K_BIG
    packed, rstart, rlen = chunk
    CHUNK = packed.shape[0] * 4
    codes = dc.unpack_codes(torch.from_numpy(packed).to(device), CHUNK)
    rs = torch.from_numpy(rstart).to(device)
    rl = torch.from_numpy(rlen).to(device)
    kmers = dc.rolling_kmers(codes, k)
    genome = torch.from_numpy(
        np.frombuffer(corpus_genome(), np.uint8) >> 1 & 3).to(device)
    gk = dc.canonical_any(dc.rolling_kmers(genome, k)[k - 1:], k)
    g = torch.Generator(device=device).manual_seed(SEED)
    rnd = torch.randint(0, 1 << (2 * k), (BIG_ENTRIES - BIG_ENTRIES // 8,),
                        device=device, generator=g, dtype=torch.int64)
    vals = torch.unique(torch.cat([dc.canonical_any(rnd, k), gk]))
    del rnd, gk, genome
    check(vals.numel() <= BIG_ENTRIES, "the 1 GiB table overflowed")
    table = torch.cat([vals, torch.full((BIG_ENTRIES - vals.numel(),),
                                        -(1 << 63), dtype=torch.int64,
                                        device=device)])
    del vals
    sync()
    t0 = time.perf_counter()
    table = dc.sorted_table(table, k)
    sync()
    index_ms = (time.perf_counter() - t0) * 1e3
    res = hash_probe_check("hash_probe", table, kmers, k, sync,
                           baseline=baseline, index_ms=index_ms)
    NS = site_capacity(CHUNK)
    d_args = (table, codes, rs, rl, k, NS)
    sync()
    t0 = time.perf_counter()
    dp = probe.dense_probe_plain(*d_args)
    sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_abs_err(probe.dense_probe(*d_args), dp)
    check(err == 0, "dense_probe_h at k=31 with the 1 GiB table: kernel "
                    "and plain version differ")
    pin_ok = dp.kmers != 0
    cano = dc.canonical_any(dp.kmers[pin_ok], k)
    entries = search_entries(table.table, cano)
    stats = bucket_stats(table, cano)
    nbytes = (CHUNK + 8 * rs.numel() + CHUNK * (8 + 3) + 4 * NS + 4
              + rs.numel())
    name = f"dense_probe_h[k={k},1 GiB table]"
    fn = lambda: probe.dense_probe(*d_args)  # noqa: E731
    res[name] = {"ms": cuda_ms(fn, 10, sync, queued=True),
                 "plain_ms": plain_ms,
                 "bound_ms": ((nbytes + stats["probe_bytes"])
                              / HBM_BYTES_PER_S * 1e3),
                 "pr8_bound_ms": ((nbytes + 8 * entries)
                                  / HBM_BYTES_PER_S * 1e3),
                 "max_abs_err": err}
    line = {"kernel": name, "table_entries": table.table.numel(),
            **stats, "binary_search_entries_read": entries,
            "sites": int(dp.n_sites[0]), "kernel_ms": res[name]["ms"],
            "plain_ms": plain_ms, "bound_ms": res[name]["bound_ms"],
            "pr8_bound_ms": res[name]["pr8_bound_ms"],
            "ms_over_bound": res[name]["ms"] / res[name]["bound_ms"],
            "ms_over_pr8_bound": (res[name]["ms"]
                                  / res[name]["pr8_bound_ms"])}
    if baseline and "dense_probe" in baseline:
        kb = lambda: baseline["dense_probe"](*d_args)  # noqa: E731
        check(max_abs_err(kb(), dp) == 0, f"{name}: the baseline and the "
                                          "plain version differ")
        t = [cuda_ms((kb, fn)[i], 10, sync, queued=True)
             for i in (0, 1, 1, 0)]
        res[name]["baseline_ms"] = [t[0], t[3]]
        line.update(baseline_ms=[t[0], t[3]], kernel_ms_pair=[t[1], t[2]])
    log(f"kernel {name}: " + json.dumps(line))
    return res


def large_k_run(label, workdir, fa, src, fmt, seqs, n_bases, device, sync,
                card, max_fallback, host_sample=None):
    """One `large-kmer -i src -f fmt -k K_LARGE` run through the CLI's
    entry points over the whole corpus: its numbers, the set's size, its
    bucket index (and the time of the corrector's own index build,
    beside count_s and the corrector's build) and peak device memory,
    failing on a kernel
    of NEED_LARGE not launched,
    on more than ``max_fallback`` of the reads on the host (None: not
    held to a limit) or on the output check (the SAMPLE_LARGE sample and
    every host read, or a seeded ``host_sample`` of them).  Returns
    (solid, corrector, instrumentation, launch counts)."""
    import torch

    from br_tpu_torch import DEFAULT_CORRECTIONS, cli, runtime
    from br_tpu_torch.correct import device_codec as dc

    k = K_LARGE
    out = os.path.join(workdir, f"out_large_{fmt}.fa")
    args = cli.build_parser().parse_args(
        ["-i", fa, "-o", out, "large-kmer", "-i", src, "-f", fmt, "-k",
         str(k)])
    args.corrections = args.corrections or list(DEFAULT_CORRECTIONS)
    inst = {}

    build_index = dc.sorted_table

    def timed_index(*a, **kw):
        """dc.sorted_table, its time kept: the corrector's own build."""
        sync()
        t0 = time.perf_counter()
        st = build_index(*a, **kw)
        sync()
        inst["index_build_ms"] = (time.perf_counter() - t0) * 1e3
        return st

    def make(solid):
        t0 = time.perf_counter()
        dc.sorted_table = timed_index
        try:
            cor = runtime.make_corrector(solid, args.corrections,
                                         args.confirm, args.max_search,
                                         device=device)
        finally:
            dc.sorted_table = build_index
        sync()
        inst["make_s"] = time.perf_counter() - t0
        inst.update(instrument(cor))
        return cor

    torch.cuda.reset_peak_memory_stats()
    solid, corrector, n, count_s, correct_s, launches = drive(args, make,
                                                              sync)
    peak = torch.cuda.max_memory_allocated()
    check(n == N_READS, f"{label} wrote {n} records, expected {N_READS}")
    table = corrector.table
    path_report(label, args, solid, corrector, n, count_s, correct_s,
                launches, inst, n_bases, card, NEED_LARGE,
                max_fallback=max_fallback,
                set_times={"index_build_ms": inst["index_build_ms"]})
    check_launches(label, launches, inst, args.corrections, sfx="_h")
    log(f"{label} set and device memory: " + json.dumps({
        "input": f"-i {os.path.basename(src)} -f {fmt}",
        "kmers": len(solid), "table_entries": table.table.numel(),
        "table_bytes": table.table.numel() * 8,
        "levels": dc.table_levels(table.table), "buckets": table.buckets,
        "index_bytes": table.starts.numel() * 4,
        "bucket_levels": table.bucket_levels,
        "largest_bucket": int(table.starts.diff().max()),
        "set_build_s": count_s, "corrector_build_s": inst["make_s"],
        "max_memory_allocated": peak}))
    oracle_check(f"{label} default chain", out, seqs, args.corrections,
                 solid, corrector.last_host, k=k, sample=SAMPLE_LARGE,
                 host_sample=host_sample)
    return solid, corrector, inst, launches


def large_k_path(workdir, fa, seqs, n_bases, device, sync, card,
                 baseline=None):
    """The large-k phase at k = K_LARGE, two sets through `large-kmer`
    (large_k_run): the trusted set, the corpus's genome written as FASTA
    (`-f fasta`; its fallback share logged, not held to MAX_FALLBACK: a
    fifth of the reads go to the host, PERF.md), then the counted set,
    the reads' k-mers seen more than twice counted with numpy and written
    as a k-mer count CSV (`-f csv`, the input a k-mer counter gives br;
    held to MAX_FALLBACK); on the counted set's path the _h kernels
    against their plain versions on its first chunk (K6 at walk_max 248,
    K7 at ms 7, 14 and 15) and its first retry chunk (K6 at walk_max
    2040) and K9 on the first chunk's k-mers against the path's table;
    then K9 and K1 at k = 31 past the L2 (big_table_checks); with
    ``baseline``, each beside the other tree's.  Returns (checks, launch
    counts of the counted set's path)."""
    import torch

    from br_tpu_torch.correct import device_codec as dc
    from br_tpu_torch.correct.layout import WIDE_WALK_MAX

    k = K_LARGE
    genome_fa = os.path.join(workdir, "genome.fa")
    with open(genome_fa, "wb") as fh:
        fh.write(b">genome\n" + corpus_genome() + b"\n")
    solid, corrector, _inst, _launches = large_k_run(
        f"k={k} large-kmer -f fasta path (the trusted set: the genome's "
        f"{k}-mers)", workdir, fa, genome_fa, "fasta", seqs, n_bases,
        device, sync, card, max_fallback=None,
        host_sample=TRUSTED_HOST_SAMPLE)
    del solid, corrector
    torch.cuda.empty_cache()

    csv = os.path.join(workdir, f"solid{k}.csv")
    t0 = time.perf_counter()
    rows = write_solid_csv(seqs, k, 2, csv)
    log(f"k={k} solid k-mers (count > 2) of the corpus: {rows} rows of "
        f"{csv} in {time.perf_counter() - t0:.1f} s (numpy)")
    solid, corrector, inst, launches = large_k_run(
        f"k={k} large-kmer -f csv path (the counted set: the reads' "
        f"{k}-mers seen more than twice)", workdir, fa, csv, "csv", seqs,
        n_bases, device, sync, card, max_fallback=MAX_FALLBACK)
    table = corrector.table
    idxs, starts = corrector._plan(seqs, set(), set())[0]
    first = corrector._chunk_arrays(seqs, idxs, starts)
    checks = kernel_checks(table, first, k, C, MS, device, sync,
                           plain_reps=0, full=False, walks=[],
                           baseline=baseline)
    check(bool(inst["retry"]), f"the k={k} path retried no chunk")
    checks.update(kernel_checks(
        table, inst["retry"][0], k, C, MS, device, sync, kind="retry",
        plain_reps=0, full=False,
        walks=[(WIDE_WALK_MAX, "graph"), (WIDE_WALK_MAX, "gap-size")],
        baseline=baseline))
    codes = dc.unpack_codes(torch.from_numpy(first[0]).to(device),
                            first[0].shape[0] * 4)
    checks.update(hash_probe_check(
        f"hash_probe[k={k},path table]", table, dc.rolling_kmers(codes, k),
        k, sync, baseline=baseline, index_ms=inst["index_build_ms"]))
    group_checks(table, small_group(corrector, seqs), k, C, MS, device,
                 sync, GROUP_LABEL[k], checks)
    path_groups(table, inst, k, device, sync, checks)
    del corrector, table
    torch.cuda.empty_cache()
    checks.update(big_table_checks(first, device, sync, baseline))
    return checks, launches, solid, os.path.join(workdir,
                                                 "out_large_csv.fa")


def k10_check(name, rows, w, cap, sync, reps=20):
    """K10 on the shards' counter rows (D, n) against its plain version
    (exact), timed as the kernel checks time them; bound: the D rows read
    and one written, (D + 1) n 4 bytes."""
    import torch

    from br_tpu_torch.parallel import mesh as pm
    from br_tpu_torch.set import device_build as db

    d, n = rows.shape
    got = pm.merge_counts(rows, w, cap)
    sync()
    t0 = time.perf_counter()
    want = pm.merge_counts_plain(rows, w, cap)
    sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(got, want), f"{name}: K10 differs from its plain "
                                  "version")
    fields = db.counter_fields(got, w)
    r = {"ms": cuda_ms(lambda: pm.merge_counts(rows, w, cap, got), reps,
                       sync, queued=True),
         "plain_ms": plain_ms, "max_abs_err": 0, "library_ms": None,
         "bound_ms": (d + 1) * n * 4 * 1e3 / HBM_BYTES_PER_S}
    log(f"kernel {name}: " + json.dumps({
        "kernel": name, "shards": d, "words": n, "counter_bits": w,
        "cap": cap, "saturated_counters": int((fields == cap).sum()),
        "nonzero_counters": int((fields > 0).sum()),
        "kernel_ms": r["ms"], "plain_ms": plain_ms,
        "bound_ms": r["bound_ms"], "ms_over_bound": r["ms"]
        / r["bound_ms"]}))
    return r


def k11_checks(n, device, sync, reps=20):
    """K11a and K11b at n codes (bytes of 0-255: bits above the 2-bit code
    that the pack strips) against their plain versions (exact), timed as
    the kernel checks time them; bound: n / 4 + n bytes."""
    import torch

    from br_tpu_torch.correct import device_codec as dc

    rng = np.random.default_rng(n)
    codes = torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)).to(
        device)
    packed = torch.from_numpy(rng.integers(0, 256, n // 4,
                                           dtype=np.uint8)).to(device)
    out = {}
    tag = "" if n == 1 << 20 else f"[2^{n.bit_length() - 1}]"
    for name, fn, plain, arg in (
            ("unpack_codes", lambda x: dc.unpack_codes(x, n),
             lambda x: dc.unpack_codes_plain(x, n), packed),
            ("pack_codes", dc.pack_codes, dc.pack_codes_plain, codes)):
        got = fn(arg)
        sync()
        t0 = time.perf_counter()
        want = plain(arg)
        sync()
        plain_ms = (time.perf_counter() - t0) * 1e3
        check(torch.equal(got, want), f"{name} at {n} codes differs from "
                                      "its plain version")
        r = {"ms": cuda_ms(lambda: fn(arg), reps, sync, queued=True),
             "call_ms": cuda_ms(lambda: fn(arg), reps, sync),
             "plain_ms": plain_ms, "max_abs_err": 0, "library_ms": None,
             "bound_ms": (n // 4 + n) * 1e3 / HBM_BYTES_PER_S}
        log(f"kernel {name}{tag}: " + json.dumps({
            "kernel": name, "codes": n, **r,
            "ms_over_bound": r["ms"] / r["bound_ms"]}))
        out[name + tag] = r
    return out


def launch_floor(checks, k4, sync, reps=20):
    """An empty launch (``torch.cuda._sleep(0)``) timed as the kernel
    checks time a kernel, queued behind a spin: the least device time a
    launch takes.  Logged beside K11a and K11b (from ``checks``) and K4
    (``k4``: its ms by chunk size), each as a multiple of it."""
    import torch

    ms = cuda_ms(lambda: torch.cuda._sleep(0), reps, sync, queued=True)
    near = {}
    for size, tag in (("2^20", ""), ("2^18", "[2^18]")):
        for name in ("unpack_codes", "pack_codes"):
            near[f"{name}{tag}"] = checks[name + tag]["ms"]
        near[f"reverse_slots[{size}]"] = k4[size]
    log("launch floor: " + json.dumps({
        "empty_launch_ms": ms, "kernels_ms": near,
        "over_floor": {n: t / ms for n, t in near.items()}}))
    return ms


def mesh_child(spec, workdir, line_width):
    """One process of the two-process check (``--mesh-child rank,n,port``):
    join the gloo group on card rank % count, count the corpus's stripe
    and merge the counts (count_stripe_merged, k = 13; process 0 saves
    them), threshold them into the set (a = 2, the u8 view), correct the
    stripe with run_correction_striped, then run_correction_ranged; print
    its times as one JSON line."""
    import torch

    from br_tpu_torch import DEFAULT_CORRECTIONS
    from br_tpu_torch.io.fasta import read_records
    from br_tpu_torch.parallel import multihost
    from br_tpu_torch.parallel.mesh import counts_to_u8
    from br_tpu_torch.set.solid import SolidSet

    rank, n, port = map(int, spec.split(","))
    multihost.initialize(f"localhost:{port}", n, rank, timeout_s=120)
    fa = os.path.join(workdir, "reads.fa")
    t = {"rank": rank, "device": str(multihost.local_device(rank))}
    t0 = time.perf_counter()
    seqs = [s for _d, s, _q in read_records(fa)]
    merged = multihost.count_stripe_merged(seqs, K, rank, n)
    t["count_stripe_merged_s"] = time.perf_counter() - t0
    if rank == 0:
        np.save(os.path.join(workdir, "merged13.npy"), merged)
    solid = SolidSet.from_count(K, counts_to_u8(merged), 2)
    chain = list(DEFAULT_CORRECTIONS)
    for fn, tag in ((multihost.run_correction_striped, "striped"),
                    (multihost.run_correction_ranged, "ranged")):
        t0 = time.perf_counter()
        got = fn(fa, os.path.join(workdir, f"out_{tag}.fa"), solid, chain,
                 C, MS, False, rank, n, line_width=line_width)
        torch.cuda.synchronize()
        t[f"{tag}_s"], t[f"{tag}_records"] = time.perf_counter() - t0, got
    t["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    multihost.shutdown()
    print("mesh child: " + json.dumps(t), flush=True)
    return 0


def two_processes(workdir, want, line_width, host_counts):
    """The two-process check: two children of this script (mesh_child),
    each under CHILD_TIMEOUT; a child's nonzero exit or time out fails.
    The merged striped and ranged outputs must equal ``want`` (phase 5's
    one-process output) and the merged counts ``host_counts`` (the host
    Counter(13, uint32)'s)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-child",
         f"{r},2,{port}", "--workdir", workdir, "--line-width",
         str(line_width)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = []
    try:
        deadline = time.monotonic() + CHILD_TIMEOUT
        for p in procs:
            try:
                outs.append(p.communicate(
                    timeout=max(1, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"two processes: a child ran past "
                                   f"{CHILD_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, o) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"two processes: child {r} exited "
                                 f"{p.returncode}:\n{o[-4000:]}")
        for ln in o.splitlines():
            if ln.startswith("mesh child: "):
                log(f"two processes, {ln}")
    for tag in ("striped", "ranged"):
        with open(os.path.join(workdir, f"out_{tag}.fa"), "rb") as fh:
            check(fh.read() == want, f"two processes: the {tag} output "
                                     "differs from the one-process output")
    check(np.array_equal(np.load(os.path.join(workdir, "merged13.npy")),
                         host_counts),
          "two processes: count_stripe_merged differs from the host "
          "Counter(13, uint32)")
    log("two processes: " + json.dumps({
        "processes": 2, "wall_s": wall, "striped_equal": True,
        "ranged_equal": True, "count_stripe_merged_equal": True}))


def mesh_phase(workdir, fa, seqs, n_bases, device, sync, card, main,
               large):
    """Phase 12, several devices (see the module's text): ``main`` holds
    phase 5's args, output path and corrector stats; ``large`` the k = 21
    counted set and its output.  Returns (checks, launch counts of the
    mesh path, launch counts of count_sharded)."""
    import torch

    from br_tpu_torch import cli, kernels, runtime
    from br_tpu_torch.count import Counter
    from br_tpu_torch.io.fasta import read_records
    from br_tpu_torch.parallel import mesh as pm
    from br_tpu_torch.set import device_build as db

    count = torch.cuda.device_count()
    D = max(4, count)
    mesh = pm.data_parallel_mesh([i % count for i in range(D)])
    log("mesh: " + json.dumps({"shards": D, "devices": count,
                               "placement": [str(d) for d in mesh]}))
    checks = {}
    parts = np.array_split(np.arange(len(seqs)), D)
    for a, name in ((2, "merge_counts"), (254, "merge_counts[u8]")):
        w = db.counter_bits(a)
        rows = torch.zeros((D, (1 << (2 * K - 1)) * w // 32),
                           dtype=torch.int32, device=device)
        for d, idx in enumerate(parts):
            db.count_kmers(db.pack_reads([seqs[i] for i in idx], K, device),
                           K, 0, a, rows[d])
        checks[name] = k10_check(name, rows, w, a + 1, sync)
        del rows
    for n in (1 << 20, 1 << 18):
        checks.update(k11_checks(n, device, sync))
    launch_floor(checks, main["k4"], sync)
    torch.cuda.empty_cache()

    # count_sharded over the corpus (K8a into each shard's 8-bit counters,
    # K10 at w = 8), counts set to 0 just before, against the host
    # Counter's u8 view
    host_counts = Counter(K, count_dtype=np.uint32).count_sequences(
        seqs).counts
    lens = np.fromiter(map(len, seqs), np.int64, len(seqs))
    batch = np.zeros((len(seqs), int(lens.max())), np.uint8)
    for i, s in enumerate(seqs):
        batch[i, :len(s)] = np.frombuffer(s, np.uint8)
    kernels.reset_launches()
    sync()
    t0 = time.perf_counter()
    got = pm.count_sharded(mesh, batch, lens, K)
    sync()
    count_sharded_s = time.perf_counter() - t0
    launches_u8 = dict(kernels.LAUNCHES)
    check(np.array_equal(got.cpu().numpy(), pm.counts_to_u8(host_counts)),
          "count_sharded differs from the host Counter's u8 counts")
    check(launches_u8["merge_counts"] == 1 and launches_u8["solid_count"]
          == D, f"count_sharded launched K10 {launches_u8['merge_counts']} "
          f"and K8a {launches_u8['solid_count']} times over {D} shards")
    log("count_sharded: " + json.dumps({
        "k": K, "shards": D, "reads": len(seqs), "equal": True,
        "count_sharded_s": count_sharded_s, "launches": {
            n: c for n, c in launches_u8.items() if c}}))
    del batch, got

    for k in (K, 17):
        want = cli.device_set([fa], k, 2, device).words
        sync()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = pm.solid_sharded(mesh, seqs, k, 2)
        sync()
        sharded_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        check(torch.equal(got.words, want), f"solid_sharded at k={k}: the "
              "bits differ from build_set's one-device build")
        log(f"solid_sharded at k={k}: " + json.dumps({
            "k": k, "a": 2, "shards": D, "reads": len(seqs),
            "equal": True, "solid_sharded_s": sharded_s,
            "peak_bytes": peak, "table_bytes": want.numel() * 4}))
        del got, want
        torch.cuda.empty_cache()

    # the mesh path: the set by solid_sharded, the corpus through the mesh
    args, out_main, stats = main["args"], main["out"], main["stats"]
    out = os.path.join(workdir, "out_mesh.fa")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    sync()
    t0 = time.perf_counter()
    solid = pm.solid_sharded(mesh, seqs, K, 2)
    sync()
    count_s = time.perf_counter() - t0
    cor = runtime.make_corrector(solid, args.corrections, args.confirm,
                                 args.max_search, device=device)
    cor.mesh = mesh
    inst = instrument(cor)
    t0 = time.perf_counter()
    n = runtime.run_correction([fa], [out], solid, args.corrections,
                               args.confirm, args.max_search, args.two_side,
                               record_buffer=args.record_buffer,
                               line_width=args.line_width, corrector=cor)
    sync()
    correct_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(n == N_READS, f"mesh path wrote {n} records, expected {N_READS}")
    path_report(f"mesh path ({D} shards)", args, solid, cor, n, count_s,
                correct_s, launches, inst, n_bases, card, NEED_MESH)
    check_launches(f"mesh path ({D} shards)", launches, inst,
                   args.corrections)
    with open(out, "rb") as fh, open(out_main, "rb") as fm:
        want = fm.read()
        check(fh.read() == want, "mesh path: the output differs from "
                                 "phase 5's")
    for key in ("fallback", "wide_retried", "capped", "impure", "too_long",
                "chunks"):
        check(cor.last_stats[key] == stats[key],
              f"mesh path: {key} {cor.last_stats[key]}, phase 5 "
              f"{stats[key]}")
    log("mesh path: " + json.dumps({
        "equal_to_phase5": True, "shards": D,
        "placement": [str(d) for d in mesh], "max_memory_allocated": peak,
        "allocated_before": base, "peak_over_before": peak - base,
        "table_copies": len(mesh.devices)}))
    del solid, cor, inst
    torch.cuda.empty_cache()

    # the k = 21 counted set through the mesh: the sorted table replicated
    hset, out21 = large
    fa500 = os.path.join(workdir, "reads_mesh21.fa")
    with open(fa500, "wb") as fh:
        for i, s in enumerate(seqs[:N_MESH_LARGE]):
            fh.write(b">r%d\n%s\n" % (i, s))
    res = {}
    for tag, m in (("single", None), ("mesh", mesh)):
        cor = runtime.make_corrector(hset, args.corrections, args.confirm,
                                     args.max_search, device=device)
        cor.mesh = m
        ins = instrument(cor)
        kept, oracle_s = ins["kept"], ins["oracle_s"]
        o = os.path.join(workdir, f"out_mesh21_{tag}.fa")
        t0 = time.perf_counter()
        runtime.run_correction([fa500], [o], hset, args.corrections,
                               args.confirm, args.max_search, args.two_side,
                               line_width=args.line_width, corrector=cor)
        sync()
        with open(o, "rb") as fh:
            res[tag] = (fh.read(), dict(cor.last_stats), {
                "correct_s": time.perf_counter() - t0,
                "pass_device_s": sum(r["device_s"] for r in
                                     cap_reasons(kept).values()),
                "host_oracle_s": sum(oracle_s)})
        if m is not None:
            tables = cor._mesh_tables[1]
            check(all(isinstance(t, type(cor.table)) for t in tables),
                  "k=21 mesh: the sorted table was not replicated")
        del cor
    check(res["mesh"][0] == res["single"][0], "k=21 mesh: the output "
          "differs from the one-device corrector's")
    check(res["mesh"][1] == res["single"][1], f"k=21 mesh: last_stats "
          f"{res['mesh'][1]} against {res['single'][1]}")
    ref = [s for _d, s, _q in read_records(out21)][:N_MESH_LARGE]
    got = [s for _d, s, _q in read_records(
        os.path.join(workdir, "out_mesh21_mesh.fa"))]
    check(got == ref, "k=21 mesh: the output differs from phase 11's")
    log(f"k={K_LARGE} counted set through the mesh: " + json.dumps({
        "reads": N_MESH_LARGE, "equal": True, "shards": D,
        "last_stats": res["mesh"][1], "mesh": res["mesh"][2],
        "single": res["single"][2]}))
    torch.cuda.empty_cache()

    log(f"phase clock: two processes at {time.perf_counter() - T0:.0f} s")
    two_processes(workdir, want, args.line_width, host_counts)
    return checks, launches, launches_u8


#: the port's kernels by their CUDA function names (the trace's kernel
#: events), each to its launch counter (K3's two kernels to one)
TRACE_KERNELS = {
    "dense_probe_kernel": "dense_probe", "one_sites_kernel": "one_sites",
    "two_sites_kernel": "two_sites", "walk_sites_kernel": "walk_sites",
    "greedy_sites_kernel": "greedy_sites",
    "splice_walk_kernel": "chain_splice",
    "splice_copy_kernel": "chain_splice",
    "reverse_slots_kernel": "reverse_slots",
    "solid_count_kernel": "solid_count", "solid_pack_kernel": "solid_pack",
    "hash_probe_kernel": "hash_probe", "merge_counts_kernel": "merge_counts",
    "unpack_codes_kernel": "unpack_codes", "pack_codes_kernel": "pack_codes",
}
#: a port kernel's name inside a trace event's (demangled or mangled) name
TRACE_KERNEL_RE = re.compile(r"(?<![A-Za-z_])(%s)(?![a-z_])"
                             % "|".join(TRACE_KERNELS))
#: the CLI's -v report line of a stage under -T ms
STAGE_LINE = re.compile(r"^\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d\.\d{3} INFO "
                        r"br_tpu_torch: stage (\S+) +(\d+\.\d{3})s +(\d+) "
                        r"calls$")
STAGES = ("build-set", "correct", "write")


def run_cli(argv, label):
    """``python -m br_tpu_torch.cli argv`` from the repo's root, killed
    past CLI_TIMEOUT; fails on a nonzero exit or a stage report line
    missing.  Returns {stage: seconds} from the report lines."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, "-m", "br_tpu_torch.cli",
                            "-v", "-T", "ms", *argv], cwd=root,
                           capture_output=True, text=True,
                           timeout=CLI_TIMEOUT)
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"{label}: ran past {CLI_TIMEOUT} s")
    check(r.returncode == 0, f"{label}: exited {r.returncode}:\n"
                             f"{r.stderr[-4000:]}")
    stages = {}
    for ln in r.stderr.splitlines():
        m = STAGE_LINE.match(ln)
        if m:
            stages[m.group(1)] = float(m.group(2))
    check(sorted(stages) == sorted(STAGES),
          f"{label}: stamped stage lines {sorted(stages)}, expected "
          f"{sorted(STAGES)}:\n{r.stderr[-4000:]}")
    log(f"{label}: " + json.dumps({"wall_s": time.perf_counter() - t0,
                                   "stage_s": stages}))
    return stages


def busy_share(spans, ranges):
    """The union of the kernel ``spans`` inside ``ranges`` (each a list of
    (start, end)) over the ranges' summed length."""
    busy = total = 0.0
    spans = sorted(spans)
    for lo, hi in ranges:
        total += hi - lo
        end = lo
        for a, b in spans:
            a, b = max(a, end), min(b, hi)
            if b > a:
                busy += b - a
                end = b
    return busy / total if total else 0.0


def trace_summary(path):
    """The Chrome trace of the CLI's --trace: the port's kernel events by
    launch counter (count, summed device ms), the count of every kernel
    event, and the stage ranges' busy shares."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    ranges = {name: [(e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "user_annotation"
                     and e.get("name") == name] for name in STAGES}
    mine = {}
    for e in kern:
        m = TRACE_KERNEL_RE.search(e.get("name", ""))
        if m:
            r = mine.setdefault(TRACE_KERNELS[m.group(1)],
                                {"events": 0, "device_ms": 0.0})
            r["events"] += 1
            r["device_ms"] += e["dur"] / 1e3
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in kern]
    return {"kernels": mine, "kernel_events": len(kern),
            "port_kernel_events": sum(r["events"] for r in mine.values()),
            "ranges": {n: len(r) for n, r in ranges.items()},
            "busy_share": {n: busy_share(spans, r)
                           for n, r in ranges.items() if n != "write"}}


def cli_phase(workdir, fa, want, launches):
    """Phase 13, the CLI as a user runs it (see the module's text):
    ``want`` is phase 5's output, ``launches`` its launch counts."""
    from br_tpu_torch.profiling import TRACE_FILE

    trace_dir = os.path.join(workdir, "trace")
    set_args = ["fasta", "-i", fa, "-k", str(K), "-a", "2"]
    out = os.path.join(workdir, "out_cli_trace.fa")
    stages = run_cli(["--trace", trace_dir, "-i", fa, "-o", out,
                      *set_args], "CLI trace run")
    with open(out, "rb") as fh:
        check(fh.read() == want, "CLI trace run: the output differs from "
                                 "phase 5's")
    path = os.path.join(trace_dir, TRACE_FILE)
    summary = trace_summary(path)
    mine = summary.pop("kernels")
    for name, r in sorted(mine.items()):
        log(f"CLI trace kernel {name}: " + json.dumps({
            **r, "phase5_launches": launches.get(name)}))
    log("CLI trace: " + json.dumps({
        **summary, "trace_bytes": os.path.getsize(path), "stage_s": stages}))
    events = {n: r["events"] for n, r in mine.items()}
    want_events = {n: c for n, c in launches.items() if c}
    check(events == want_events, f"CLI trace: kernel events {events}, "
                                 f"phase 5's launches {want_events}")
    check(all(summary["ranges"][n] for n in STAGES),
          f"CLI trace: stage ranges {summary['ranges']}")

    out = os.path.join(workdir, "out_cli_native.fa")
    stages = run_cli(["-t", "0", "--backend", "native", "-i", fa, "-o", out,
                      *set_args], "CLI native run")
    with open(out, "rb") as fh:
        check(fh.read() == want, "CLI native run: the output differs from "
                                 "phase 5's")
    log("host baseline: " + json.dumps({
        "backend": "native", "reads": N_READS,
        "correct_s": stages["correct"],
        "reads_per_s": N_READS / stages["correct"],
        "build_set_s": stages["build-set"], "threads": "-t 0, one a core",
        "cpu_count": os.cpu_count(), "equal_to_phase5": True}))


#: NC_MAX values of the sweep (phase 5), each timed once, in this order;
#: the peak device memory a default NC_MAX may reach at the CLI's default
#: record_buffer
NC_SWEEP = (1, 4, 16, 64)
NC_MEMORY_LIMIT = 8 << 30
#: the label of each k's group checks (group_checks)
GROUP_LABEL = {K: "group of 3", 17: "group of 3 at 2^15, k=17",
               K_LARGE: "group of 3 at 2^15, k=21"}


def sweep_corrector(args, solid, nc, chunks, device):
    """Phase 5's corrector at NC_MAX = nc, warmed up for its groups."""
    from br_tpu_torch import runtime

    cor = runtime.make_corrector(solid, args.corrections, args.confirm,
                                 args.max_search, device=device)
    cor.NC_MAX = nc
    cor.warmup(args.two_side, nc=min(nc, chunks))
    return cor


def nc_sweep(args, solid, want, main_cor, device, sync):
    """Phase 5's correction at each NC_MAX of NC_SWEEP (the set, corpus
    and flags of phase 5, a corrector warmed up for its groups first):
    byte-equal to phase 5 (``want``) with its last_stats, its launches
    as its groups say; logged: correct_s split into the passes (device),
    the host engine and the rest, the launches a kernel and the peak
    device memory.  The peak at the CLI's default record_buffer (~100
    chunks of 2^20) is projected from the per-chunk growth of the peak
    between NC_MAX 1 and 16; the fastest NC_MAX under NC_MEMORY_LIMIT is
    logged.  (The busy shares come from profiled runs at the end of the
    script, nc_busy: a torch.profiler run with CUDA activity leaves
    every later launch of the process slower.)  Returns {nc: numbers}."""
    import torch

    from br_tpu_torch import DEFAULT_RECORD_BUFFER, kernels, runtime

    chunks = main_cor.last_stats["chunks"]
    res = {}
    for nc in NC_SWEEP:
        cor = sweep_corrector(args, solid, nc, chunks, device)
        inst = instrument(cor)
        out = os.path.join(os.path.dirname(args.outputs[0]),
                           f"out_nc{nc}.fa")
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        sync()
        t0 = time.perf_counter()
        runtime.run_correction(args.inputs, [out], solid, args.corrections,
                               args.confirm, args.max_search, args.two_side,
                               record_buffer=args.record_buffer,
                               line_width=args.line_width, corrector=cor)
        sync()
        correct_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {n: c for n, c in kernels.LAUNCHES.items() if c}
        with open(out, "rb") as fh:
            check(fh.read() == want, f"NC_MAX={nc}: the output differs "
                                     "from phase 5's")
        check(cor.last_stats == main_cor.last_stats,
              f"NC_MAX={nc}: last_stats {cor.last_stats}, phase 5 "
              f"{main_cor.last_stats}")
        check_launches(f"NC_MAX={nc}", kernels.LAUNCHES, inst,
                       args.corrections, args.two_side)
        device_s = sum(r["device_s"] for r in
                       cap_reasons(inst["kept"]).values())
        host_s = sum(inst["oracle_s"])
        groups = {prof: list(n) for prof, n in inst["groups"].items()}
        res[nc] = {"correct_s": correct_s,
                   "pass_device_s": device_s, "host_oracle_s": host_s,
                   "rest_s": correct_s - device_s - host_s,
                   "reads_per_s": N_READS / correct_s,
                   "groups": groups, "launches": launches,
                   "launches_total": sum(launches.values()),
                   "max_memory_allocated": peak,
                   "allocated_before": base}
        log(f"NC sweep, NC_MAX={nc}: " + json.dumps(res[nc]))
        del cor, inst
    per_chunk = ((res[16]["max_memory_allocated"]
                  - res[1]["max_memory_allocated"]) / 15)
    full = -(-chunks * DEFAULT_RECORD_BUFFER // N_READS)
    for nc, r in res.items():
        r["projected_peak_at_record_buffer"] = int(
            r["max_memory_allocated"]
            + (min(nc, full) - min(nc, chunks)) * per_chunk)
    fit = [nc for nc in NC_SWEEP
           if res[nc]["projected_peak_at_record_buffer"] < NC_MEMORY_LIMIT]
    best = min(fit, key=lambda nc: res[nc]["correct_s"])
    log("NC sweep: " + json.dumps({
        "chunks": chunks, "default_NC_MAX": type(main_cor).NC_MAX,
        "chunks_at_record_buffer": full,
        "peak_bytes_per_chunk": per_chunk,
        "correct_s": {nc: r["correct_s"] for nc, r in res.items()},
        "projected_peak": {nc: r["projected_peak_at_record_buffer"]
                           for nc, r in res.items()},
        "fastest_under_limit": best}))
    return res


def nc_busy(args, solid, device, sync, chunks):
    """The device's busy share of the correct range (the union of the
    kernel events over it, trace_summary) at NC_MAX = 1 and at the
    default: phase 5's correction with phase 5's set once more under
    torch.profiler.  Run last: after a profiled run every launch of the
    process is slower."""
    from br_tpu_torch import runtime
    from br_tpu_torch.correct.engine3 import Torch3Corrector
    from br_tpu_torch.profiling import TRACE_FILE, device_trace

    res = {}
    for nc in (1, Torch3Corrector.NC_MAX):
        cor = sweep_corrector(args, solid, nc, chunks, device)
        trace_dir = os.path.join(os.path.dirname(args.outputs[0]),
                                 f"trace_nc{nc}")
        with device_trace(trace_dir, cuda=True):
            runtime.run_correction(args.inputs, [os.devnull], solid,
                                   args.corrections, args.confirm,
                                   args.max_search, args.two_side,
                                   record_buffer=args.record_buffer,
                                   line_width=args.line_width,
                                   corrector=cor)
            sync()
        summary = trace_summary(os.path.join(trace_dir, TRACE_FILE))
        res[nc] = {"busy_share_correct": summary["busy_share"]["correct"],
                   "kernel_events": summary["kernel_events"],
                   "port_kernel_events": summary["port_kernel_events"]}
        log(f"NC sweep, NC_MAX={nc}, profiled: " + json.dumps(res[nc]))
    return res


def main_path(workdir, device, sync, card, build, base_dir=None):
    """Corpus, the k = 13 solid set on the host and by K8, kernel checks,
    the default-chain CLI path and its output check, then the `-c one`
    path, then the k = 17 phases (k17_path), large k (large_k_path) and
    several devices (mesh_phase).  ``build`` is called before
    the first kernel is needed; ``base_dir`` is a baseline's csrc
    directory or None.  Returns the per-kernel summary entries."""
    import torch

    from br_tpu_torch import DEFAULT_CORRECTIONS, cli, runtime
    from br_tpu_torch.corpus import write_corpus
    from br_tpu_torch.count import Counter
    from br_tpu_torch.io.fasta import read_records

    fa = os.path.join(workdir, "reads.fa")
    out = os.path.join(workdir, "out.fa")
    t0 = time.perf_counter()
    n_bases = write_corpus(fa, N_READS, GENOME, MEAN_LEN, MAX_LEN, SEED)
    log(f"corpus: {N_READS} reads, {n_bases} bases "
        f"({time.perf_counter() - t0:.1f} s)")
    seqs = [s for _d, s, _q in read_records(fa)]

    # no -c: the default chain
    argv = ["-i", fa, "-o", out, "fasta", "-i", fa, "-k", str(K), "-a", "2"]
    args = cli.build_parser().parse_args(argv)
    args.corrections = args.corrections or list(DEFAULT_CORRECTIONS)
    # the set of `fasta -k 13 -a 2` on the host (Counter), as the CLI
    # built it before K8, and by K8 (build_set): the same bits
    t0 = time.perf_counter()
    host_solid = Counter(K).count_sequences(seqs).to_solid(2)
    count_host_s = time.perf_counter() - t0
    build()
    t0 = time.perf_counter()
    dsolid = cli.build_set(args)
    sync()
    count_dev_s = time.perf_counter() - t0
    check(torch.equal(dsolid.words, host_solid.device_words(device)),
          "K8 at k=13: the device set differs from Counter.to_solid(2)")
    log("K8 set check: " + json.dumps({
        "k": K, "a": 2, "reads": N_READS, "bases": n_bases,
        "solid_kmers": host_solid.count_ones(), "equal": True,
        "count_s_host": count_host_s, "count_s_device": count_dev_s}))
    planner = runtime.make_corrector(dsolid, args.corrections, args.confirm,
                                     args.max_search, device=device)
    plans = planner._plan(seqs, set(), set())
    first = planner._chunk_arrays(seqs, *plans[0])
    group3 = planner._group_arrays(seqs, plans[:3])

    baseline = load_baseline(base_dir) if base_dir else None
    checks = kernel_checks(dsolid.words, first, K, C, MS, device, sync,
                           baseline=baseline)
    checks.update(solid_checks(seqs, K, device, sync, baseline=baseline))

    inst = {}

    def make(a):
        def fn(solid):
            cor = runtime.make_corrector(solid, a.corrections, a.confirm,
                                         a.max_search, device=device)
            inst.update(instrument(cor))
            return cor
        return fn

    k8_times = {}
    torch.cuda.reset_peak_memory_stats()
    solid, corrector, n, count_s, correct_s, launches = drive(
        args, make(args), sync, k8_times)
    peak = torch.cuda.max_memory_allocated()
    check(n == N_READS, f"wrote {n} records, expected {N_READS}")
    path_report("main path", args, solid, corrector, n, count_s, correct_s,
                launches, inst, n_bases, card, NEED13, set_times=k8_times)
    main = {"args": args, "out": out, "stats": dict(corrector.last_stats)}
    log("main path device memory: " + json.dumps({
        "max_memory_allocated": peak,
        "table_bytes": solid.words.numel() * 4}))
    log(f"count_s: {count_s:.3f} s by K8 on the card (K8's device "
        f"{k8_times['k8_device_ms']:.3f} ms, the reads' packing "
        f"{k8_times['pack_reads_s']:.3f} s, the FASTA read and the rest "
        f"{k8_times['read_s']:.3f} s) against {count_host_s:.3f} s by the "
        f"host Counter (phase 3)")
    retry = inst["retry"]
    check(bool(retry), "the main path retried no chunk on the wide sibling")
    check_launches("main path", launches, inst, args.corrections)
    # K11's launches by chunk size: one unpack and one pack a group, the
    # wide sibling's (groups of 2^18 chunks) apart from the rest (2^20)
    k11 = ("unpack_codes", "pack_codes")
    launches_2e18 = dict.fromkeys(k11, inst["groups"]["wide"][0])
    launches_2e20 = dict.fromkeys(k11, inst["groups"]["default"][0])
    log("main path K11 launches by chunk size: " + json.dumps(
        {"2^20": launches_2e20, "2^18": launches_2e18}))
    with open(out, "rb") as fh:
        nc_sweep(args, solid, fh.read(), corrector, device, sync)
    group_checks(dsolid.words, group3, K, C, MS, device, sync,
                 GROUP_LABEL[K], checks)
    group_checks(dsolid.words, planner._group_arrays(seqs, plans), K, C, MS,
                 device, sync, f"first batch of {len(plans)}", checks,
                 plain=False, into=GROUP_LABEL[K])
    path_groups(corrector.table, inst, K, device, sync, checks, ("wide",))
    checks.update(kernel_checks(corrector.table, retry[0], K, C, MS, device,
                                sync, kind="retry", baseline=baseline))
    lw_table, lw_chunk = long_walk_chunk(device)
    checks.update(kernel_checks(lw_table, lw_chunk, K, C, MS, device, sync,
                                kind="long", plain_reps=0,
                                baseline=baseline))
    oracle_check("default chain", out, seqs, args.corrections, solid,
                 corrector.last_host)

    log(f"phase clock: -c one at {time.perf_counter() - T0:.0f} s")
    # the first slice's path: -c one on the first N_ONE reads
    fa1 = os.path.join(workdir, "reads_one.fa")
    out1 = os.path.join(workdir, "out_one.fa")
    with open(fa1, "wb") as fh:
        for i, s in enumerate(seqs[:N_ONE]):
            fh.write(b">r%d\n%s\n" % (i, s))
    args1 = cli.build_parser().parse_args(
        ["-i", fa1, "-o", out1, "-c", "one", "fasta", "-i", fa, "-k",
         str(K), "-a", "2"])
    solid1, one, n1, _c1, one_s, launches1 = drive(args1, make(args1), sync)
    st1 = one.last_stats
    log("-c one path: " + json.dumps({
        "reads": n1, "correct_s": one_s, "reads_per_s": n1 / one_s,
        "last_stats": st1, "launches": launches1}))
    check(n1 == N_ONE, f"-c one wrote {n1} records, expected {N_ONE}")
    for name in ("dense_probe", "one_sites", "chain_splice",
                 "reverse_slots", "solid_count", "solid_pack",
                 "unpack_codes", "pack_codes"):
        check(launches1[name] > 0, f"-c one: kernel {name} not launched")
    check_launches("-c one", launches1, inst, ["one"])
    check(st1["fallback"] / max(1, st1["total"]) <= MAX_FALLBACK,
          f"-c one: {st1['fallback']} of {st1['total']} reads to the host")
    oracle_check("-c one", out1, seqs[:N_ONE], ["one"], solid1,
                 one.last_host)
    busy_solid = solid   # phase 5's set, for nc_busy at the end
    del planner, dsolid, solid, corrector, solid1, one
    torch.cuda.empty_cache()

    log(f"phase clock: k = 17 at {time.perf_counter() - T0:.0f} s")
    checks17, launches17 = k17_path(workdir, fa, seqs, n_bases, device, sync,
                                    card, baseline)
    checks.update(checks17)
    del checks17
    torch.cuda.empty_cache()
    log(f"phase clock: large k at {time.perf_counter() - T0:.0f} s")
    checks_l, launches_l, hset, out21 = large_k_path(
        workdir, fa, seqs, n_bases, device, sync, card, baseline)
    checks.update(checks_l)
    log(f"phase clock: several devices at {time.perf_counter() - T0:.0f} s")
    main["k4"] = {"2^20": checks["reverse_slots"]["ms"],
                  "2^18": checks["reverse_slots[retry chunk]"]["ms"]}
    checks_m, launches_m, launches_u8 = mesh_phase(
        workdir, fa, seqs, n_bases, device, sync, card, main, (hset, out21))
    log(f"phase clock: the CLI at {time.perf_counter() - T0:.0f} s")
    with open(out, "rb") as fh:
        cli_phase(workdir, fa, fh.read(), launches)
    log(f"phase clock: the NC sweep's busy shares at "
        f"{time.perf_counter() - T0:.0f} s")
    nc_busy(args, busy_solid, device, sync, main["stats"]["chunks"])
    log(f"phase clock: done at {time.perf_counter() - T0:.0f} s")
    checks.update(checks_m)
    # the launches of a kernel's summary entry: K9's on the large-k path,
    # K10's on the mesh path (its u8 entry's by count_sharded), K11's on
    # the main path at the entry's chunk size, the rest on the main path
    own = {"hash_probe": launches_l, "merge_counts": launches_m,
           **dict.fromkeys(k11, launches_2e20)}
    entries = []
    for name, (source, replaces) in KERNEL_META.items():
        # a kernel's k = 17 entry: its 64-bit instantiation, or (K8b,
        # which holds no k-mer) the same kernel's k = 17 launches; its
        # large-k entry: its sorted-table instantiation, and K9's, with
        # the large-k path's launches
        for nm, cnt, key in ((name, own.get(name, launches), name),
                             (name + "64", launches17, name + "64"),
                             (name + "[k=17]", launches17, name),
                             (name + "_h", launches_l, name + "_h"),
                             (name + "[u8]", launches_u8, name),
                             (name + "[2^18]", launches_2e18, name),
                             (f"{name}[{GROUP_LABEL[K]}]", launches, name),
                             (f"{name}64[{GROUP_LABEL[17]}]", launches17,
                              name + "64"),
                             (f"{name}[{GROUP_LABEL[17]}]", launches17,
                              name),
                             (f"{name}_h[{GROUP_LABEL[K_LARGE]}]",
                              launches_l, name + "_h"),
                             (f"{name}[{GROUP_LABEL[K_LARGE]}]",
                              launches_l, name)):
            if nm not in checks:
                continue
            r = checks[nm]
            entries.append({
                "name": nm, "route": "cuda", "source": source,
                "replaces": replaces, "launches": cnt[key],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": "bytes", "library_ms": r.get("library_ms"),
                **{x: r[x] for x in ENTRY_EXTRAS if x in r}})
    return entries


def k17_path(workdir, fa, seqs, n_bases, device, sync, card,
             baseline=None):
    """The k = 17 phases: K8 against its plain build on the first K8_READS
    reads (the set-bit words compared on the card) and K8a/K8b against
    their plain versions on the whole corpus; the k = 17 default chain
    through the CLI's entry points over the first N17 reads (the set
    built by K8 over the whole corpus), with its numbers and peak device
    memory; the 64-bit kernels against their plain versions on its first
    chunk (with ``baseline``, beside the other tree's 64-bit
    instantiations); its output check.  Returns (checks, launch counts of
    the path)."""
    import torch

    from br_tpu_torch import DEFAULT_CORRECTIONS, cli, runtime
    from br_tpu_torch.set import device_build as db

    k = 17
    few = seqs[:K8_READS]
    batches = [db.pack_reads(few, k, device)]
    got = db.build_words([batches], k, 2)
    want = db.solid_words_plain(batches, k, 2)
    nz = torch.nonzero(want).squeeze(1)
    check(torch.equal(torch.nonzero(got).squeeze(1), nz)
          and torch.equal(got[nz], want[nz]),
          "K8 at k=17: the set differs from the plain build")
    log("K8 set check: " + json.dumps({
        "k": k, "a": 2, "reads": len(few), "nonzero_words": int(nz.numel()),
        "solid_kmers": db.popcount_words(want), "equal": True}))
    del got, want, nz
    checks = solid_checks(seqs, k, device, sync, baseline=baseline)

    fa17 = os.path.join(workdir, "reads17.fa")
    out17 = os.path.join(workdir, "out17.fa")
    with open(fa17, "wb") as fh:
        for i, s in enumerate(seqs[:N17]):
            fh.write(b">r%d\n%s\n" % (i, s))
    args = cli.build_parser().parse_args(
        ["-i", fa17, "-o", out17, "fasta", "-i", fa, "-k", str(k), "-a",
         "2"])
    args.corrections = args.corrections or list(DEFAULT_CORRECTIONS)
    inst = {}

    def make(solid):
        cor = runtime.make_corrector(solid, args.corrections, args.confirm,
                                     args.max_search, device=device)
        inst.update(instrument(cor))
        return cor

    k8_times = {}
    torch.cuda.reset_peak_memory_stats()
    solid, corrector, n, count_s, correct_s, launches = drive(args, make,
                                                              sync, k8_times)
    peak = torch.cuda.max_memory_allocated()
    check(n == N17, f"k=17 wrote {n} records, expected {N17}")
    n17_bases = sum(len(s) for s in seqs[:N17])
    path_report(f"k=17 path ({N17} of {N_READS} reads corrected, the set "
                f"from all {N_READS})", args, solid, corrector, n, count_s,
                correct_s, launches, inst, n17_bases, card, NEED17,
                set_times=k8_times)
    w = db.counter_bits(args.abundance)
    log("k=17 device memory: " + json.dumps({
        "max_memory_allocated": peak,
        "table_bytes": solid.words.numel() * 4,
        "count_partition_bytes": db.partition_size(
            k, w, db.DEFAULT_MAX_COUNT_BYTES) * w // 8}))
    check_launches("k=17 path", launches, inst, args.corrections,
                   sfx="64")
    idxs, starts = corrector._plan(seqs[:N17], set(), set())[0]
    first = corrector._chunk_arrays(seqs[:N17], idxs, starts)
    checks.update(kernel_checks(corrector.table, first, k, C, MS, device,
                                sync, plain_reps=0, full=False,
                                baseline=baseline))
    group_checks(corrector.table, small_group(corrector, seqs[:N17]), k, C,
                 MS, device, sync, GROUP_LABEL[k], checks)
    path_groups(corrector.table, inst, k, device, sync, checks)
    check(bool(inst["retry"]), "the k=17 path retried no chunk")
    checks.update(kernel_checks(corrector.table, inst["retry"][0], k, C, MS,
                                device, sync, kind="retry", plain_reps=0,
                                full=False))
    oracle_check("k=17 default chain", out17, seqs[:N17], args.corrections,
                 solid, corrector.last_host, k=k, sample=SAMPLE17)
    return checks, launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", metavar="CSRC_DIR",
                    help="also check and time K1-K7 at k = 13 (the 64-bit "
                         "ones at k = 17, the sorted-table ones and K9 at "
                         "k = 21 and on the 1 GiB table, and K8 and its "
                         "whole build at k = 13 and 17) as built from "
                         "this directory, those whose sources differ from "
                         "this tree's (the parent commit's csrc: git "
                         "archive <commit> br_tpu_torch/csrc)")
    # one process of phase 12's two-process check (mesh_child)
    ap.add_argument("--mesh-child", metavar="RANK,N,PORT",
                    help=argparse.SUPPRESS)
    ap.add_argument("--workdir", help=argparse.SUPPRESS)
    ap.add_argument("--line-width", type=int, default=80,
                    help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.mesh_child:
        return mesh_child(opts.mesh_child, opts.workdir, opts.line_width)
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 1
    try:
        from br_tpu_torch import kernels
        from br_tpu_torch.native import build as native_build
    except ImportError as e:
        print(f"chip_smoke: the br_tpu_torch package is not beside this "
              f"script: {e}", file=sys.stderr)
        return 1

    try:
        card = card_line()
        log(f"card: {card}")
        toolchain()
        built = {}

        def build_native():
            try:
                t0 = time.perf_counter()
                built["native"] = native_build.build()
                built["native_s"] = time.perf_counter() - t0
            except Exception as e:  # reported when the build is joined
                built["err"] = e

        def build_kernels():
            try:
                built["s"] = kernels.build_all()
            except Exception as e:
                built["err"] = e

        threads = [threading.Thread(target=build_native),
                   threading.Thread(target=build_kernels)]
        for th in threads:
            th.start()

        def join_build():
            for th in threads:
                th.join()
            if "err" in built:
                raise SmokeFailure(f"build failed: {built['err']}")
            log(f"build: {len(kernels.KERNELS)} kernels from "
                f"{len(kernels.sources())} sources in {built['s']:.1f} s "
                f"(nvcc in parallel); the native host engine "
                f"{os.path.basename(built['native'])} in "
                f"{built['native_s']:.1f} s (g++, beside them)")
            for src, rep in kernels.BUILD_LOG.items():
                fn = ""
                for ln in rep.splitlines():   # per instantiation
                    if "Function properties for" in ln:
                        fn = ln.split("for", 1)[1].strip()
                    elif "registers" in ln or "spill" in ln:
                        log(f"  ptxas {src} {fn}: "
                            f"{ln.split(':', 1)[-1].strip()}")

        device = torch.device("cuda")
        with tempfile.TemporaryDirectory() as work:
            entries = main_path(work, device, sync=torch.cuda.synchronize,
                                card=card, build=join_build,
                                base_dir=opts.baseline)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
