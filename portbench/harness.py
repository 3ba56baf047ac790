"""One run of one cell: set-up, a window of whole ``br fasta -a`` jobs of
``br_tpu_torch`` in process, the check against the plain reference, the
metrics.

Everything a cell needs is found by name from ``BENCHMARK.json`` at the
root of the checkout: the workload's configuration (its ``file``), its
traffic mix (``portbench/traffic/<traffic>.json``) and a reader for each
metric (``portbench/metrics/<name>.py``, a function ``read(run)`` that
returns a number, or None where it finds nothing to read).

A run:

1. set-up (``setup_s``, from the start of the process): the corpus made
   from the seed and written under ``TMPDIR``; the program imported and
   CUDA up; its kernels and native engine built (first run in a
   checkout) or loaded; one whole job on the corpus, as the window runs
   it, so that every shape, buffer and file the window uses is warm
   before it opens (on one H100 machine the first job of a process was
   the slowest in 9 runs of 15 at k = 17, by up to 4 s); that job's
   output is judged with the window's;
2. the window: jobs back to back, each ``br_tpu_torch.cli.main`` with the
   argv a user types, timed from its call to its return with the device
   synchronised; the window closes with the first job that ends after
   ``--seconds`` of summed job time.  Each job's output file (under
   ``TMPDIR``) is read back between jobs, outside their time, held to
   the corpus's definitions and layout, its chosen reads kept, and
   deleted;
3. one more job under ``torch.profiler``, its Chrome trace read for the
   device metrics, the end-to-end ``kernel_ms`` among them (a profiler
   session slows every later launch of its process, so it comes last,
   after the window, in every run);
4. the program's state freed, then the reference: the solid set counted
   from the corpus with NumPy and the chosen reads corrected by the
   frozen oracle in worker processes; every job's chosen reads compared
   with it.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import random
import shutil
import sys
import tempfile
import time
from pathlib import Path

from portbench import check, corpus, trace
from portbench.reference import correct as ref_correct

#: top-level module names no process of a run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "br_tpu")
#: what the reference's workers may not hold besides
FORBIDDEN_IN_REFERENCE = FORBIDDEN + ("br_tpu_torch", "torch")
#: br's default chain (src/cli.rs:121-132): no ``-c`` on the command line
DEFAULT_CHAIN = ["one", "two", "graph", "greedy", "gap-size"]


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic
    mix and metrics."""

    def __init__(self, root, name: str):
        self.root = Path(root)
        bench = json.loads((self.root / "BENCHMARK.json").read_text())
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        entry = [c for c in bench["configs"]
                 if c["name"] == self.workload["config"]][0]
        self.config = json.loads((self.root / entry["file"]).read_text())
        self.traffic = json.loads(
            (self.root / "portbench" / "traffic"
             / f"{self.workload['traffic']}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"] if _in(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _in(m, name)]

    def reader(self, metric: str):
        """The ``read`` function of ``portbench/metrics/<metric>.py``."""
        path = self.root / "portbench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + "".join(
                ch if ch.isalnum() else "_" for ch in metric), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def argv(self, reads: str, out: str, device: str) -> list:
        """The command line of one job, as a user types it."""
        c = self.config
        argv = ["-i", reads, "-o", out, "-b", str(c["record_buffer"]),
                "-C", str(c["confirm"]), "-M", str(c["max_search"])]
        if c["two_side"]:
            argv.append("-s")
        if list(c["chain"]) != DEFAULT_CHAIN:
            for m in c["chain"]:
                argv += ["-c", m]
        if device != "cuda":
            argv += ["--device", device]
        return argv + ["fasta", "-i", reads, "-k", str(c["k"]), "-a",
                       str(c["abundance"])]


def _in(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def top_level(modules) -> set:
    return {m.split(".")[0] for m in modules}


class Hooks:
    """The harness's spans and counters around calls into the program's
    correction layer, per job: the native host engine's seconds (each
    call of ``Torch3Corrector._oracle_correct_many``, on the corrector
    and on its wide sibling, also a profiler range
    ``portbench.host_engine``) and how many calls it saw, and from each
    top-level batch's ``last_stats`` the reads and the reads corrected on
    the host, with their corpus indices (``last_host``).  A job whose
    batches sent reads to the host while the span saw no call has no
    host engine reading: the program reached its host engine another
    way."""

    def __init__(self):
        self.reset()
        self._saved = None

    def reset(self) -> None:
        self.host_s = 0.0
        self.host_calls = 0
        self.reads = 0
        self.fallback = 0
        self.host_reads: list = []
        self._offset = 0
        self._depth = 0

    def host_span(self):
        """The host engine's seconds, or None where reads went to the
        host but no call of the hooked method was seen."""
        return self.host_s if self.host_calls or not self.fallback else None

    def install(self) -> None:
        import torch
        from br_tpu_torch.correct.engine3 import Torch3Corrector as T

        self._saved = (T.correct_batch, T._oracle_correct_many)
        batch, host = self._saved
        hooks = self

        def correct_batch(cor, seqs, two_side):
            hooks._depth += 1
            try:
                out = batch(cor, seqs, two_side)
            finally:
                hooks._depth -= 1
            if hooks._depth == 0:
                st = cor.last_stats
                hooks.reads += st["total"]
                hooks.fallback += st["fallback"]
                hooks.host_reads += [hooks._offset + i for i in cor.last_host]
                hooks._offset += len(seqs)
            return out

        def oracle_correct_many(cor, seqs, two_side):
            hooks.host_calls += 1
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function("portbench.host_engine"):
                    return host(cor, seqs, two_side)
            finally:
                hooks.host_s += time.perf_counter() - t0

        T.correct_batch = correct_batch
        T._oracle_correct_many = oracle_correct_many

    def uninstall(self) -> None:
        if self._saved is not None:
            from br_tpu_torch.correct.engine3 import Torch3Corrector as T

            T.correct_batch, T._oracle_correct_many = self._saved
            self._saved = None


class Runner:
    """The program side of a run: set-up, jobs, the traced job."""

    def __init__(self, cell: Cell, records, seed: int, workdir: Path,
                 device: str):
        self.cell = cell
        self.seed = seed
        self.records = records
        self.definitions = [d for d, _s in records]
        self.workdir = workdir
        self.device = device
        self.reads_path = str(workdir / "reads.fa")
        self.out_path = str(workdir / "out.fa")
        self.hooks = Hooks()
        #: every job's chosen reads together: what the reference corrects
        self.chosen: set = set()
        #: the chosen reads that every job checks
        self.fixed: set | None = None
        #: jobs run so far, the warm-up's included
        self.count = 0
        self.warm: dict | None = None
        self.jobs: list = []

    def sync(self) -> None:
        import torch

        if self.device == "cuda":
            torch.cuda.synchronize()

    def setup(self) -> None:
        """The corpus on disk, the program loaded, its kernels built, and
        the warm-up: one whole job (``self.warm``)."""
        corpus.write_fasta(self.reads_path, self.records)
        self.hooks.install()
        self.warm = self.job()

    def job(self, traced: bool = False) -> dict:
        """One whole job; its output is judged, then deleted."""
        import torch
        from br_tpu_torch import cli, profiling

        argv = self.cell.argv(self.reads_path, self.out_path, self.device)
        before = profiling.stage_totals()
        self.hooks.reset()
        rc, err = 1, None
        ctx = (torch.profiler.record_function(trace.JOB) if traced
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with ctx:
                rc = cli.main(argv)
                self.sync()
        except Exception as e:  # a job that raises is a failed job
            err = f"{type(e).__name__}: {e}"
        wall = time.perf_counter() - t0
        after = profiling.stage_totals()
        stages = {k: after[k][1] - before.get(k, (0, 0.0))[1] for k in after}
        h = self.hooks
        job = {"wall_s": wall, "reads": len(self.records), "rc": rc,
               "error": err, "stages": stages,
               "spans": {"host_engine": h.host_span()},
               "counters": {"reads": h.reads, "fallback": h.fallback,
                            "host_calls": h.host_calls}}
        self.count += 1
        chosen = self._choose(h.host_reads, 0 if traced else self.count)
        self.chosen |= chosen
        job["records_off"], job["chosen"] = len(self.records), {}
        if rc == 0 and err is None:
            with open(self.out_path, "rb") as fh:
                job["records_off"], job["chosen"] = check.read_output(
                    fh.read(), self.definitions, chosen,
                    self.cell.config["line_width"])
        if os.path.exists(self.out_path):
            os.unlink(self.out_path)
        gc.collect()
        return job

    def _choose(self, host_reads, number: int) -> set:
        """The reads of job ``number`` (the traced job: 0) that the
        reference corrects: a sample of the corpus drawn afresh a job
        from the seed, and in every job the corpus's longest read and a
        sample, drawn from the seed, of the reads the first job's host
        engine corrected (the program sends the same reads to the host
        in every job, and the reference's time goes mostly to them)."""
        c = self.cell.config["check"]
        n = len(self.records)
        rng = random.Random(self.seed * 4099 + number)
        chosen = set(rng.sample(range(n), min(c["sample_reads"], n)))
        if self.fixed is None:
            rng = random.Random(self.seed)
            host = sorted(set(host_reads))
            self.fixed = set(rng.sample(host, min(c["host_reads"],
                                                  len(host))))
            if n:
                self.fixed.add(max(range(n),
                                   key=lambda i: len(self.records[i][1])))
        return chosen | self.fixed

    def window(self, seconds: float) -> None:
        while True:
            job = self.job()
            self.jobs.append(job)
            if job["error"] or job["rc"] != 0:
                print(f"job failed: rc {job['rc']} {job['error'] or ''}",
                      file=sys.stderr)
                return
            if sum(j["wall_s"] for j in self.jobs) >= seconds:
                return

    def traced_job(self):
        """One more job under ``torch.profiler``: (the job, its trace's
        events)."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            job = self.job(traced=True)
        path = str(self.workdir / "trace.json")
        prof.export_chrome_trace(path)
        events = trace.load(path)
        os.unlink(path)
        return job, events


def run_cell(root, name: str, seed: int, seconds: float, trace_on: bool,
             device: str = "cuda", t_start: float | None = None,
             workers: int | None = None) -> tuple:
    """One run of cell ``name``: (the result line as a dict, the
    top-level module names the reference's workers held).  ``t_start`` is
    the process's start on ``time.perf_counter``."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(root, name)
    c = cell.config
    records = corpus.make_corpus(c["reads"], c["genome_size"], cell.traffic,
                                 seed)
    workdir = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        import torch

        runner = Runner(cell, records, seed, workdir, device)
        runner.setup()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        try:
            runner.window(seconds)
            traced, events = None, None
            if runner.jobs[-1]["rc"] == 0:
                traced, events = runner.traced_job()
        finally:
            runner.hooks.uninstall()
        dev = device_info(device, trace_on)
        jobs = runner.jobs
        warm = runner.warm
        chosen = runner.chosen
        del runner
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    t_ref = time.perf_counter()
    seqs = [s for _d, s in records]
    reference, names = ref_correct.correct_reads(
        seqs, sorted(chosen), c["k"], c["abundance"], c["chain"],
        c["confirm"], c["max_search"], c["two_side"],
        workers or min(8, os.cpu_count() or 1))
    judged = [warm] + jobs + ([traced] if traced else [])
    print(f"portbench: setup {setup_s:.3f} s, {len(jobs)} jobs "
          f"{sum(j['wall_s'] for j in jobs):.3f} s, window and checks "
          f"{t_ref - t_start - setup_s:.3f} s, reference of {len(reference)} "
          f"reads {time.perf_counter() - t_ref:.3f} s; job seconds "
          + " ".join(f"{j['wall_s']:.3f}" for j in jobs), file=sys.stderr)
    print("portbench: job stages (build-set/correct/host engine/write s) "
          + " ".join("/".join(f"{v:.3f}" if v is not None else "-" for v in (
              j["stages"].get("build-set"), j["stages"].get("correct"),
              j["spans"].get("host_engine"), j["stages"].get("write")))
                     for j in jobs), file=sys.stderr)
    wrong = check.records_wrong(judged, reference)
    checks = {"records_wrong": {"value": wrong,
                                "limit": c["check"]["records_wrong_limit"]}}
    run = {"setup_s": setup_s, "jobs": jobs, "traced_job": traced,
           "trace": events, "memory": {"peak_bytes": dev["memory_peak_bytes"]}}
    wanted = cell.per_layer if trace_on else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": all(v["value"] <= v["limit"] for v in checks.values()),
        "attempted": len(records) * len(judged),
        "failed": wrong,
        "metrics": metrics,
        "device": dev,
    }
    if trace_on and events is not None:
        w = trace.window(events)
        result["device"]["busy_s"] = trace.busy_us(events) / 1e6
        result["device"]["window_s"] = (w[1] - w[0]) / 1e6 if w else None
        result["breakdown"] = {"device_ops": trace.device_ops(events),
                               "idle_gaps": trace.idle_gaps(events)}
    result["checks"] = checks
    return result, names


def device_info(device: str, trace_on: bool) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": torch.cuda.max_memory_allocated()}
