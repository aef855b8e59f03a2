"""The port's collectives and data-parallel step in a real two-rank world:
two processes, ``torch.distributed`` over gloo through a ``FileStore``
under the test's temporary directory, one thread each, and a join
timeout so that a hang fails the test instead of stalling the suite.

Checked: ``synchronize`` lets the root win (a module, and a tree with a
non-default root); ``allreduce`` sum/mean/max, ``reduce`` on the root
only, ``bcast``, a bad root and collectives before ``init``; the loader's
per-rank shards; and one data-parallel step on two shards equals the
single-process step on the global batch (``grad_reduce="mean"``, and a
``DistributedOptimizer`` summing gradients of a loss scaled by 1/world).
Tolerance for the step: f32, the two halves' gradient sums added in
another order, atol 1e-6."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import fluxmpi_tpu_torch as tfm
from fluxmpi_tpu_torch import optim
from fluxmpi_tpu_torch.errors import FluxMPINotInitializedError
from fluxmpi_tpu_torch.models import MLP
from fluxmpi_tpu_torch.parallel import TrainState, make_train_step

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
JOIN_TIMEOUT = 180

WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world, store_path, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)

    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu_torch import optim
    from fluxmpi_tpu_torch.models import MLP
    from fluxmpi_tpu_torch.parallel import TrainState, make_train_step

    fm.init(device="cpu")  # adopts the group brought up above
    res = {"rank": rank, "world": fm.total_workers()}

    m = MLP(device="cpu", generator=torch.Generator().manual_seed(100 + rank))
    fm.synchronize(m)
    for name, p in m.named_parameters():
        res["sync_module/" + name] = p.detach().numpy()
    tree = {"a": torch.full((3,), float(rank)), "b": [torch.arange(4) * (rank + 1)],
            "n": rank}
    synced = fm.synchronize(tree, root_rank=1)
    res["sync_tree_a"], res["sync_tree_b"] = synced["a"].numpy(), synced["b"][0].numpy()
    res["sync_tree_n"] = synced["n"]
    res["tree_a_untouched"] = tree["a"].numpy()

    x = {"v": torch.tensor([1.0, 2.0]) * (rank + 1), "i": torch.tensor([rank + 1])}
    for op in ("sum", "mean", "max"):
        r = fm.allreduce(x, op=op)
        res[f"allreduce_{op}_v"], res[f"allreduce_{op}_i"] = r["v"].numpy(), r["i"].numpy()
    r = fm.reduce(x, op="sum", root=1)
    res["reduce_v"], res["reduce_i"] = r["v"].numpy(), r["i"].numpy()
    res["bcast_v"] = fm.bcast(x, root=1)["v"].numpy()
    try:
        fm.bcast(x, root=world)
        res["bad_root_raises"] = False
    except ValueError:
        res["bad_root_raises"] = True

    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (16, 1)).astype(np.float32)
    loader = fm.DistributedDataLoader(
        fm.DistributedDataContainer(fm.ArrayDataset((X, X ** 2))),
        global_batch_size=16, device="cpu")
    (xb, yb), = list(loader)
    res["local_x"] = xb.numpy()

    def run(reduce, opt, scale):
        model = MLP(device="cpu", generator=torch.Generator().manual_seed(100 + rank))
        fm.synchronize(model)

        def loss_fn(p, ms, batch):
            x, y = batch
            return ((model(x) - y) ** 2).mean() * scale, ms

        state = TrainState.create(model, opt)
        state, loss = make_train_step(loss_fn, opt, grad_reduce=reduce)(state, (xb, yb))
        return model, loss

    model, loss = run("mean", optim.adam(1e-2), 1.0)
    res["dp_loss"] = loss.numpy()
    for name, p in model.named_parameters():
        res["dp_mean/" + name] = p.detach().numpy()
    model, _ = run(None, fm.DistributedOptimizer(optim.sgd(0.1)), 1.0 / world)
    for name, p in model.named_parameters():
        res["dp_distopt/" + name] = p.detach().numpy()

    np.savez(out, **res)
    fm.shutdown()
    dist.destroy_process_group()
''')


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the worker on two ranks; returns each rank's results."""
    tmp = tmp_path_factory.mktemp("world2")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    procs, logs = [], []
    for rank in range(WORLD):
        log = open(tmp / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(rank), str(WORLD),
             str(tmp / "store"), str(tmp / f"rank{rank}.npz")],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=JOIN_TIMEOUT)
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
            p.wait()
        for log in logs:
            log.close()
    text = "\n".join((tmp / f"rank{r}.log").read_text() for r in range(WORLD))
    assert not hung, f"a rank hung past {JOIN_TIMEOUT}s:\n{text}"
    assert all(p.returncode == 0 for p in procs), text
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


def test_synchronize_lets_the_root_win(ranks):
    r0, r1 = ranks
    root = MLP(device="cpu", generator=torch.Generator().manual_seed(100))
    for name, p in root.named_parameters():
        for r in ranks:
            np.testing.assert_array_equal(r["sync_module/" + name], p.detach().numpy())
    for r in ranks:  # root_rank=1: rank 1's tree everywhere
        np.testing.assert_array_equal(r["sync_tree_a"], np.full(3, 1.0, np.float32))
        np.testing.assert_array_equal(r["sync_tree_b"], np.arange(4) * 2)
        assert int(r["sync_tree_n"]) == 1
    np.testing.assert_array_equal(r0["tree_a_untouched"], np.zeros(3, np.float32))


def test_allreduce_sum_mean_max(ranks):
    for r in ranks:
        assert int(r["world"]) == WORLD
        np.testing.assert_array_equal(r["allreduce_sum_v"], [3.0, 6.0])
        np.testing.assert_array_equal(r["allreduce_sum_i"], [3])
        np.testing.assert_array_equal(r["allreduce_mean_v"], [1.5, 3.0])
        np.testing.assert_array_equal(r["allreduce_max_v"], [2.0, 4.0])
        np.testing.assert_array_equal(r["allreduce_max_i"], [2])
        np.testing.assert_array_equal(r["bcast_v"], [2.0, 4.0])
        assert bool(r["bad_root_raises"])


def test_reduce_gives_the_result_on_the_root_only(ranks):
    r0, r1 = ranks
    np.testing.assert_array_equal(r1["reduce_v"], [3.0, 6.0])
    np.testing.assert_array_equal(r1["reduce_i"], [3])
    np.testing.assert_array_equal(r0["reduce_v"], [1.0, 2.0])  # its own input
    np.testing.assert_array_equal(r0["reduce_i"], [1])


def test_loader_gives_each_rank_its_shard(ranks):
    X = np.random.default_rng(0).uniform(-2, 2, (16, 1)).astype(np.float32)
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["local_x"], X[rank * 8:(rank + 1) * 8])


def _single_process_step(opt, scale=1.0):
    """The same step on the global batch in one process, no collective."""
    X = np.random.default_rng(0).uniform(-2, 2, (16, 1)).astype(np.float32)
    x, y = torch.from_numpy(X), torch.from_numpy(X ** 2)
    model = MLP(device="cpu", generator=torch.Generator().manual_seed(100))

    def loss_fn(p, ms, batch):
        return ((model(batch[0]) - batch[1]) ** 2).mean() * scale, ms

    state = TrainState.create(model, opt)
    state, loss = make_train_step(loss_fn, opt, grad_reduce=None)(state, (x, y))
    return model, loss


def test_data_parallel_step_equals_the_single_process_step(ranks):
    model, loss = _single_process_step(optim.adam(1e-2))
    for r in ranks:
        np.testing.assert_allclose(float(r["dp_loss"]), loss.item(), atol=1e-6, rtol=0)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(r["dp_mean/" + name], p.detach().numpy(),
                                       atol=1e-6, rtol=0, err_msg=name)


def test_distributed_optimizer_sums_scaled_gradients(ranks):
    model, _ = _single_process_step(optim.sgd(0.1))
    for r in ranks:
        for name, p in model.named_parameters():
            np.testing.assert_allclose(r["dp_distopt/" + name], p.detach().numpy(),
                                       atol=1e-6, rtol=0, err_msg=name)


def test_collectives_before_init_raise():
    assert not tfm.is_initialized()
    x = torch.ones(2)
    for call in (lambda: tfm.allreduce(x), lambda: tfm.bcast(x),
                 lambda: tfm.reduce(x), tfm.barrier, lambda: tfm.synchronize({"x": x}),
                 lambda: tfm.allreduce_gradients({"x": x}), tfm.local_rank,
                 tfm.total_workers):
        with pytest.raises(FluxMPINotInitializedError):
            call()
