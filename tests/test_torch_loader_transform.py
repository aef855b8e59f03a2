"""The loader's host-side ``transform=`` and the C++ prefetcher in the
port against the JAX package, on the CPU.

- Batches bit for bit against the JAX loader (on a one-device mesh, so
  that any batch size shards): a 2-argument transform drawing from
  ``np.random.default_rng([seed, epoch, b, rank])`` over an
  ``ArrayDataset`` (the native prefetcher's path) with a ragged tail
  (``drop_last=False``), a 1-argument transform over a list-backed
  dataset, two epochs, and a mid-epoch ``load_state_dict`` resume, which
  must also equal the uninterrupted pass.
- The arity rules (explicit flag, the callable's attribute, the
  signature's required positional parameters, the warning for a callable
  without one), the lead-dimension error and ``device_gather=True``
  refused beside a transform, as in the JAX package; ``"auto"`` keeps a
  transformed dataset on the host path.
- A 2-rank gloo world (a ``FileStore``, one thread per rank): each rank's
  batches, resumed mid-epoch too, against the reference's rule computed
  with numpy, and rank 0's against the JAX loader over the same shard.
- ``gather_rows`` and ``NativePrefetcher`` against the JAX package's and
  numpy's, and their bounds checks; 20000 prefetchers made, drained and
  destroyed in a child process without a hang (ROADMAP C.14).
Exact equality throughout: the same integers and the same f32 draws.
"""

import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import fluxmpi_tpu as jfm
import fluxmpi_tpu_torch as tfm
from fluxmpi_tpu.io import native as jnative
from fluxmpi_tpu_torch.io import NativePrefetcher, gather_rows, native_available

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SEED = 5


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3, 2)).astype(np.float32),
            np.arange(n, dtype=np.int32) * 10)


def augment(batch, rng):
    x, y = batch
    return (x + rng.standard_normal(x.shape).astype(np.float32),
            y + rng.integers(0, 5, y.shape).astype(y.dtype))


def double(batch):
    x, y = batch
    return x * 2, y + 1


class _ListDataset:
    def __init__(self, x, y):
        self.x, self.y = x, y

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _mesh1():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("dp",))


def _jax_loader(data, gbs, **kw):
    return jfm.DistributedDataLoader(data, gbs, mesh=_mesh1(), axis_name="dp", **kw)


def _np(batch):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(batch)]


def _tnp(batch):
    return [x.numpy() for x in batch]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("source,transform", [("array", augment), ("list", double),
                                              ("list", augment), ("array", double)])
def test_batches_equal_the_jax_loader_over_two_epochs(world, source, transform):
    x, y = _data(37)
    make = {"array": lambda m: m.ArrayDataset((x, y)),
            "list": lambda m: _ListDataset(x, y)}[source]
    kw = dict(shuffle=True, seed=SEED, drop_last=False, transform=transform)
    port = tfm.DistributedDataLoader(make(tfm), 8, device="cpu", **kw)
    ref = _jax_loader(make(jfm), 8, **kw)
    assert len(port) == len(ref) == 5
    for _ in range(2):
        _assert_batches_equal([_tnp(b) for b in port], [_np(b) for b in ref])


def test_a_resumed_pass_equals_the_uninterrupted_one_and_jax(world):
    x, y = _data(40)
    kw = dict(shuffle=True, seed=SEED, transform=augment)
    full = tfm.DistributedDataLoader(tfm.ArrayDataset((x, y)), 8, device="cpu", **kw)
    full.set_epoch(1)
    want = [_tnp(b) for b in full]
    first = tfm.DistributedDataLoader(tfm.ArrayDataset((x, y)), 8, device="cpu", **kw)
    first.set_epoch(1)
    it = iter(first)
    head = [_tnp(next(it)) for _ in range(2)]
    state = first.state_dict()
    assert state == {"epoch": 1, "cursor": 2, "seed": SEED}
    resumed = tfm.DistributedDataLoader(tfm.ArrayDataset((x, y)), 8, device="cpu", **kw)
    resumed.load_state_dict(state)
    tail = [_tnp(b) for b in resumed]
    _assert_batches_equal(head + tail, want)
    ref = _jax_loader(jfm.ArrayDataset((x, y)), 8, **kw)
    ref.load_state_dict(state)
    _assert_batches_equal(tail, [_np(b) for b in ref])


def _two_arg(batch, rng):
    return batch


def _defaulted(batch, rng=None):
    return batch


def _keyword_only(batch, *, training=False):
    return batch


def _var(*args):
    return args[0]


def _flagged(*args):
    return args[0]


_flagged.transform_with_rng = True


@pytest.mark.parametrize("transform,flag,arity", [
    (double, None, 1), (_two_arg, None, 2), (_defaulted, None, 1),
    (_keyword_only, None, 1), (_var, None, 1), (_flagged, None, 2),
    (_two_arg, False, 1), (double, True, 2), (max, None, 1)])
def test_arity_rules_equal_the_jax_package(world, transform, flag, arity):
    ds = np.zeros((8, 2), np.float32)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        port = tfm.DistributedDataLoader(tfm.ArrayDataset(ds), 8, device="cpu",
                                         transform=transform, transform_with_rng=flag)
        ref = _jax_loader(jfm.ArrayDataset(ds), 8, transform=transform,
                          transform_with_rng=flag)
    assert port._transform_arity == ref._transform_arity == arity
    messages = [str(w.message) for w in caught if "inspectable" in str(w.message)]
    assert len(messages) == (2 if transform is max else 0)
    assert len(set(messages)) <= 1


def test_errors_and_the_host_path_as_in_the_jax_package(world):
    ds = (np.zeros((8, 2), np.float32),)
    for make, loader in ((tfm, lambda d, **k: tfm.DistributedDataLoader(d, 8, device="cpu",
                                                                        **k)),
                         (jfm, lambda d, **k: _jax_loader(d, 8, **k))):
        with pytest.raises(ValueError, match="transform_with_rng given without"):
            loader(make.ArrayDataset(ds), transform_with_rng=True)
        with pytest.raises(ValueError, match="must be callable"):
            loader(make.ArrayDataset(ds), transform=3)
        with pytest.raises(ValueError, match="incompatible with transform"):
            loader(make.ArrayDataset(ds), transform=double, device_gather=True)
        cut = loader(make.ArrayDataset(ds), transform=lambda b: (b[0][:3],))
        with pytest.raises(ValueError, match="leading \\(batch\\) dimension"):
            list(cut)
    auto = tfm.DistributedDataLoader(tfm.ArrayDataset(ds), 8, device="cpu",
                                     transform=double)
    assert not auto.fusible() and not auto._use_device_gather(auto._array_backing())
    plain = tfm.DistributedDataLoader(tfm.ArrayDataset(ds), 8, device="cpu")
    assert plain.fusible()


WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    sys.path.insert(0, sys.argv[5])
    import fluxmpi_tpu_torch as fm
    from test_torch_loader_transform import SEED, _data, augment

    fm.init(device="cpu")
    x, y = _data(38)

    def loader():
        return fm.DistributedDataLoader(
            fm.DistributedDataContainer(fm.ArrayDataset((x, y))), 8, device="cpu",
            shuffle=True, seed=SEED, drop_last=False, transform=augment)

    res = {}
    full = loader()
    for b, (bx, by) in enumerate(full):
        res[f"x{b}"], res[f"y{b}"] = bx.numpy(), by.numpy()
    it = iter(loader())
    next(it)
    state = {**full.state_dict(), "epoch": 0, "cursor": 1}
    resumed = loader()
    resumed.load_state_dict(state)
    for b, (bx, by) in enumerate(resumed, 1):
        res[f"rx{b}"], res[f"ry{b}"] = bx.numpy(), by.numpy()
    np.savez(out, n=len(full), **res)
    fm.shutdown()
    dist.destroy_process_group()
''')


def _reference(x, y, rank, world, lbs, transform):
    """The reference's rule: this rank's contiguous shard, its local order
    shuffled by ``default_rng(seed + epoch)``, batches capped at the
    smallest shard, each transformed with ``default_rng([seed, epoch, b,
    rank])``."""
    n = len(x)
    spp = -(-n // world)
    start = rank * spp
    size = min(start + spp, n) - start
    common = n - (world - 1) * spp
    order = np.arange(size)
    np.random.default_rng(SEED + 0).shuffle(order)
    out = []
    for b in range(-(-common // lbs)):
        rows = order[b * lbs:min((b + 1) * lbs, common)] + start
        bx, by = transform((x[rows], y[rows]), np.random.default_rng([SEED, 0, b, rank]))
        out.append([bx, by])
    return out


def test_two_rank_world_batches_follow_the_reference(world, tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "2", str(tmp_path / "store"),
         str(tmp_path / f"rank{r}.npz"), str(ROOT / "tests")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    x, y = _data(38)
    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz")
        n = int(got["n"])
        batches = [[got[f"x{b}"], got[f"y{b}"]] for b in range(n)]
        want = _reference(x, y, rank, 2, 4, augment)
        assert n == len(want) == 5 and len(batches[-1][0]) == 3
        _assert_batches_equal(batches, want)
        _assert_batches_equal([[got[f"rx{b}"], got[f"ry{b}"]] for b in range(1, n)],
                              want[1:])
    # Rank 0 through the JAX loader over the same shard (one process there:
    # its rng key's process index is 0).
    ref = _jax_loader(jfm.DistributedDataContainer(jfm.ArrayDataset((x, y)), rank=0,
                                                   world=2), 4, shuffle=True, seed=SEED,
                      drop_last=False, transform=augment)
    _assert_batches_equal([_np(b) for b in ref], _reference(x, y, 0, 2, 4, augment))


@pytest.mark.parametrize("dtype,row", [(np.float32, (3, 2)), (np.int32, ()),
                                       (np.uint8, (5,)), (np.float64, (2, 2, 2))])
def test_gather_rows_and_the_prefetcher_equal_jax_and_numpy(dtype, row):
    assert native_available() and jnative.native_available()
    rng = np.random.default_rng(1)
    a = (rng.standard_normal((50,) + row) * 100).astype(dtype)
    idx = rng.integers(0, 50, size=17)
    want = a[idx]
    for got in (gather_rows(a, idx), jnative.gather_rows(a, idx)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    idx2 = rng.integers(0, 50, size=(3, 4))
    np.testing.assert_array_equal(gather_rows(a, idx2), a[idx2])
    order = rng.permutation(50)
    served = NativePrefetcher.served
    port = list(NativePrefetcher(a, order, 8))
    assert NativePrefetcher.served - served == 6
    # The reference's destroy sets its stop flag outside the mutex and can
    # lose the producer's wake-up right after the last batch (ROADMAP
    # C.14, repaired in the port's copy): its generator stays open here, so
    # its destroy runs at exit, long after the producer has gone to sleep.
    it = iter(jnative.NativePrefetcher(a, order, 8))
    _OPEN_REFERENCE_PREFETCHERS.append(it)
    ref = [next(it) for _ in range(6)]
    assert len(port) == len(ref) == 6
    for b, (p, r) in enumerate(zip(port, ref)):
        np.testing.assert_array_equal(p, a[order[b * 8:(b + 1) * 8]])
        np.testing.assert_array_equal(p, r)


# The JAX package's prefetchers of the test above, left open (see there).
_OPEN_REFERENCE_PREFETCHERS: list = []

DESTROY_STRESS = textwrap.dedent('''
    import numpy as np
    from fluxmpi_tpu_torch.io import NativePrefetcher

    a = np.arange(48, dtype=np.float32).reshape(48, 1)
    order = np.arange(48)
    for _ in range(20000):
        assert len(list(NativePrefetcher(a, order, 8, threads=1))) == 6
''')


def test_prefetcher_destroy_never_loses_its_wakeup():
    """C.14: a prefetcher destroyed just after its producer built the last
    batch must not hang (the stop flag is set under the mutex the producer
    waits with). The reference's copy hangs within a few thousand cycles;
    20000 cycles of the port's run in a child process with a timeout, so a
    hang fails the test instead of the run."""
    assert native_available()
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1])
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", DESTROY_STRESS], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_native_bounds_checks():
    a = np.zeros((4, 2), np.float32)
    with pytest.raises(IndexError, match="out of range"):
        gather_rows(a, np.array([0, 4]))
    with pytest.raises(IndexError, match="out of range"):
        NativePrefetcher(a, np.array([-1, 0]), 1)
