"""Several devices and several processes (the port of
``br_tpu.parallel``).

* **Correction**: pure data parallelism.  The table is copied once to each
  distinct device of a ``mesh.Mesh``; a corrector with ``mesh`` set runs
  chunk i on shard i mod ``mesh.size``'s device, and the
  order-preserving merge happens on the host, as on one device.
* **Counting**: each shard counts its reads with K8a on its device; the
  shards' saturating counters merge on the first device with K10
  (``mesh.count_sharded``, ``mesh.solid_sharded``).
* **Several processes**: ``multihost.initialize`` joins a ``gloo``
  process group; each process corrects its stripe of the input on its own
  device, and the parts merge in input order.

A device may hold several shards and a card several processes, so all of
it runs on one H100; on a host with more cards it spreads over them.
"""

from br_tpu_torch.parallel.mesh import (  # noqa: F401
    count_sharded,
    data_parallel_mesh,
    shard_batch,
)
from br_tpu_torch.parallel.multihost import (  # noqa: F401
    count_stripe_merged,
    global_mesh,
    initialize,
    run_correction_striped,
)
