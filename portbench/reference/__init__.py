"""The plain reference of ``br fasta -a``: NumPy and Python only.

``kmers`` counts the solid set from the reads; ``oracle`` is a frozen
copy of the port's scalar oracle (natir/br's five strategies);
``correct`` runs it over chosen reads in worker processes.  Nothing here
imports ``br_tpu_torch``, ``br_tpu``, ``torch`` or ``jax``.
"""
