"""Smoke tests of the port's examples (``examples_torch/``): each runs with
``--cpu`` in a subprocess at the JAX smoke's step counts
(``tests/test_examples.py``) and prints its success sentinel; the
multi-process ones start their workers through
``fluxmpi_tpu_torch.launch`` (gloo, one thread each). Every example has a
smoke test, and ``quickstart.py``'s losses over its first two epochs are
held to the JAX example's, from the same weights (the flax MLP carried
across by ``models/convert.py``), the same batches and ``adam(3e-3)``:
within 1e-5 relative at every update (f32; 16 updates)."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

_REPO = Path(__file__).resolve().parent.parent
_EXAMPLES = _REPO / "examples_torch"

# (file, extra argv, sentinel): the JAX smoke's step counts.
_CASES = [
    ("quickstart.py", ["--epochs", "10"], "QUICKSTART_OK"),
    ("cifar_cnn.py", ["--epochs", "2"], "CIFAR_CNN_OK"),
    ("deq_regression.py", [], "DEQ_OK"),
    ("transformer_ring.py", [], "TRANSFORMER_RING_OK"),
    ("vit_classification.py", ["--epochs", "2"], "VIT_EXAMPLE_OK"),
    ("adapter_sync.py", [], "ADAPTER_SYNC_OK"),
    ("lm_pretrain.py", [], "LM_PRETRAIN_OK"),
    ("ddpm_toy.py", ["--steps", "60"], "DDPM_TOY_OK"),
    ("parallelism_3d.py", [], "PARALLELISM_3D_OK"),
    ("long_context_zigzag.py", [], "LONG_CONTEXT_ZIGZAG_OK"),
]

torch.set_num_threads(1)


def test_every_port_example_is_covered():
    """A new example must get a smoke test, and every JAX example has its
    port."""
    on_disk = {p.name for p in _EXAMPLES.glob("*.py")}
    covered = {c[0] for c in _CASES}
    assert on_disk == covered, (
        f"examples without a smoke test: {sorted(on_disk - covered)}; "
        f"smoke tests without a file: {sorted(covered - on_disk)}")
    assert on_disk == {p.name for p in (_REPO / "examples").glob("*.py")}


@pytest.mark.parametrize("name,argv,sentinel", _CASES, ids=[c[0] for c in _CASES])
def test_port_example_runs_on_the_cpu(name, argv, sentinel):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(_REPO), env.get("PYTHONPATH")) if p)
    env.pop("CUDA_VISIBLE_DEVICES", None)
    proc = subprocess.run([sys.executable, str(_EXAMPLES / name), "--cpu", *argv],
                          capture_output=True, text=True, timeout=300, env=env, cwd=_REPO)
    tail = "\n".join(proc.stdout.splitlines()[-5:] + proc.stderr.splitlines()[-15:])
    assert proc.returncode == 0, f"{name} failed (rc={proc.returncode}):\n{tail}"
    assert sentinel in proc.stdout, f"{name} missing {sentinel}:\n{tail}"


def _jax_quickstart_losses(params, epochs):
    """The JAX example's loop (``examples/quickstart.py``) from ``params``:
    every update's loss."""
    import optax

    import fluxmpi_tpu as jfm
    from fluxmpi_tpu.models import MLP as JaxMLP
    from fluxmpi_tpu.parallel import TrainState, make_train_step
    from fluxmpi_tpu.parallel.train import replicate

    mesh = jfm.global_mesh()
    xs = np.random.default_rng(0).uniform(-2, 2, size=(512, 1)).astype(np.float32)
    ys = (xs**2).astype(np.float32)

    class Squares:
        def __len__(self):
            return 512

        def __getitem__(self, i):
            return xs[i], ys[i]

    loader = jfm.DistributedDataLoader(jfm.DistributedDataContainer(Squares()),
                                       global_batch_size=64, shuffle=True)
    model, opt = JaxMLP(), optax.adam(3e-3)

    def loss_fn(p, ms, batch):
        x, y = batch
        return jnp.mean((model.apply(p, x) - y) ** 2), ms

    step = make_train_step(loss_fn, opt, mesh=mesh, style="auto")
    state = replicate(TrainState.create(params, opt), mesh)
    losses = []
    for _ in range(epochs):
        for batch in loader:
            state, loss = step(state, batch)
            losses.append(float(loss))
    return np.array(losses)


def test_quickstart_losses_match_the_jax_example(world):
    import fluxmpi_tpu_torch as fm
    from fluxmpi_tpu.models import MLP as JaxMLP
    from fluxmpi_tpu_torch.models import MLP, load_flax_params

    params = JaxMLP().init(jax.random.PRNGKey(1234), jnp.ones((1, 1)))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params["params"])[0]}
    ref = _jax_quickstart_losses(params, 2)  # the JAX step donates params
    spec = importlib.util.spec_from_file_location("_port_quickstart",
                                                  _EXAMPLES / "quickstart.py")
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    fm.init(device="cpu")
    try:
        model = load_flax_params(MLP(device="cpu"), flat)
        _, losses = quickstart.train(model, quickstart.squares_loader(), 2)
    finally:
        fm.shutdown()  # the next test file on this worker starts uninitialized
    assert len(losses) == len(ref) == 16
    np.testing.assert_allclose(losses, ref, rtol=1e-5, atol=0)
