"""ROADMAP C.21: six of the port's registered fault sites had no test that
armed them (found by the port's fluxlint, ``unregistered-fault-site``).
Each fires here, in a one-process world on the CPU, where the JAX
package's site fires: before the collective or the checkpoint read moves
any bytes, raising ``FaultInjectedError`` that names the site.
"""

import numpy as np
import pytest
import torch

import fluxmpi_tpu_torch as fm
from fluxmpi_tpu_torch import faults
from fluxmpi_tpu_torch.errors import FaultInjectedError
from fluxmpi_tpu_torch.utils import restore_checkpoint, save_checkpoint

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cpu_world():
    fm.init(device="cpu")
    yield
    fm.shutdown()


def _elastic_restore(tmp):
    path = str(tmp / "ckpt")
    save_checkpoint(path, {"w": torch.ones(4)})
    return lambda: restore_checkpoint(path, {"w": torch.zeros(4)}, mesh=fm.global_mesh())


# site -> setup(tmp_path) returning the call that reaches the site.
SITES = {
    "comm.reduce": lambda tmp: lambda: fm.reduce(torch.ones(2)),
    "comm.host_allreduce": lambda tmp: lambda: fm.host_allreduce(np.ones(2)),
    "comm.host_allgather": lambda tmp: lambda: fm.host_allgather(np.ones(2)),
    "comm.host_bcast": lambda tmp: lambda: fm.host_bcast(np.ones(2)),
    "ckpt.snapshot": lambda tmp: lambda: save_checkpoint(str(tmp / "snap"),
                                                         {"w": torch.ones(4)}),
    "elastic.restore": _elastic_restore,
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_registered_site_fires(cpu_world, tmp_path, site):
    assert site in faults.KNOWN_SITES
    call = SITES[site](tmp_path)
    with faults.scope(f"{site}@step=1"):
        with pytest.raises(FaultInjectedError, match=site.replace(".", r"\.")):
            call()
    # Disarmed, the same call goes through.
    call()
