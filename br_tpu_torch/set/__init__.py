"""Membership layer: the dense solid-k-mer bitfield and the sparse
large-k set (the port's copies of ``br_tpu.set.solid`` and
``br_tpu.set.hash``, plus their device tables)."""

from br_tpu_torch.set.hash import HashSet  # noqa: F401
from br_tpu_torch.set.solid import SolidSet, solid_words_from_numpy  # noqa: F401
