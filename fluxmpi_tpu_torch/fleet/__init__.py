"""Fleet operations: coordinated actions across the workers of one job.

Counterpart of :mod:`fluxmpi_tpu.fleet`. The
:mod:`fluxmpi_tpu_torch.telemetry.fleet` plane observes a fleet; this
package operates on one: :mod:`~fluxmpi_tpu_torch.fleet.resize`, the live
N→M world resize (drain at a flush boundary, bank a checkpoint, restart
under the new worker count, reshard through the topology manifest, every
second of it accounted as attributed badput).
"""

from . import resize  # noqa: F401

__all__ = ["resize"]
