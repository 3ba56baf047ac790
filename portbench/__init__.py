"""The benchmark of ``br_tpu_torch`` on one NVIDIA H100: whole
``br fasta -a`` jobs driven through the port's CLI, in process.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

run from the root of a checkout that holds ``BENCHMARK.json``.  See
``harness`` for what a run does.
"""
