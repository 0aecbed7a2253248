"""Multi-process keyed state plane: shard-host workers behind a wire protocol.

Port of ``repro.dist``.  Each shard of the keyed plane lives behind a
**process boundary**, and each worker process runs the port's engines on
the device the plane names (the CUDA card by default), launching the keyed
kernels there:

* :mod:`repro_torch.dist.wire` — the length-prefixed binary wire protocol
  (frame header + JSON meta + raw named columns), a copy of the
  reference's; frames are byte-identical between the two packages
  (``docs/wire-protocol.md``).
* :mod:`repro_torch.dist.shm` — the zero-copy shared-memory column
  transport, with the reference's ring layout: the pipe carries headers +
  meta and doubles as the doorbell, column payloads ride per-host rings,
  degrading per frame to the pipe under ring pressure.
* :mod:`repro_torch.dist.faults` — deterministic seeded fault injection.
* :mod:`repro_torch.dist.shardhost` — the worker-process serve loop owning
  ``shards_per_host`` live :class:`~repro_torch.keyed.windows.KeyedWindowEngine`
  shards, with a process-local flight recorder dumped as a black box on
  death.
* :mod:`repro_torch.dist.plane` — :class:`DistributedKeyedPlane`, the
  coordinator adapter under the port's executor, autoscaler, supervisor
  and observability stack; the executor's chunk pipeline overlaps the next
  chunk's scatter with the current chunk's tail work (``step_ahead`` /
  ``drain_ahead``).

Outputs are bit-exact against the port's in-process plane, the JAX
package's, and the serial oracle ``keyed_windows``
(``tests/test_torch_dist.py``).
"""

from repro_torch.dist import wire  # noqa: F401
from repro_torch.dist.plane import DistributedKeyedPlane  # noqa: F401
from repro_torch.dist.shm import ShmError, ShmRing, ShmTransport  # noqa: F401
