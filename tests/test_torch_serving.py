"""The port's serving slice: the paged cache's allocator, prefill K/V and
greedy generate() against the JAX package (weights converted from JAX
params, f32, K/V within atol 1e-4, tokens equal), and the engine's streams
equal to the port's own generate() token for token through continuous and
static batching, mid-flight joins, a poisoned trash block, eos eviction
and load shedding."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluxmpi_tpu.models import TransformerLM as JaxLM
from fluxmpi_tpu.models.generate import generate as jax_generate
from fluxmpi_tpu.models.generate import prefill_kv as jax_prefill_kv
from fluxmpi_tpu_torch.errors import RequestRejectedError
from fluxmpi_tpu_torch.models import TransformerLM, generate, load_flax_params, prefill_kv
from fluxmpi_tpu_torch.serving import BlockKVCache, InferenceEngine, blocks_for_tokens

torch.set_num_threads(1)

VOCAB = 97
CFG = dict(vocab_size=VOCAB, max_len=64, num_layers=2, d_model=32, num_heads=4,
           d_ff=64)


@pytest.fixture(scope="module")
def pair():
    jlm = JaxLM(**CFG)
    params = jlm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
                      train=False)
    tlm = TransformerLM(**CFG, device="cpu")
    load_flax_params(tlm, jax.tree_util.tree_map(np.asarray, params))
    return jlm, params, tlm


@pytest.fixture(scope="module")
def models(pair):
    """The converted model under each attention mode, same weights."""
    naive = pair[2]
    flash = TransformerLM(**CFG, attention="flash", device="cpu")
    flash.load_state_dict(naive.state_dict())
    return {"naive": naive, "flash": flash}


def _prompt(rng, n):
    return rng.integers(0, VOCAB, size=(n,)).astype(np.int32)


def _reference(tlm, req):
    ref = generate(tlm, req.prompt[None], req.max_new_tokens,
                   eos_token=req.eos_token)
    ref = ref[0, len(req.prompt):].numpy()
    if req.eos_token is not None:
        hits = np.where(ref == req.eos_token)[0]
        if len(hits):
            ref = ref[: hits[0] + 1]  # the engine stops AT eos
    return ref


# ---------------------------------------------------------------------------
# Block cache / free-list allocator
# ---------------------------------------------------------------------------


def test_free_list_round_trip():
    cache = BlockKVCache(num_layers=2, num_heads=4, head_dim=8,
                         num_blocks=9, block_size=16, max_blocks_per_seq=4,
                         device="cpu")
    assert cache.free_blocks == 8  # block 0 is the reserved trash block
    assert cache.capacity_tokens == 8 * 16
    a = cache.alloc(40)  # 3 blocks
    assert len(a) == 3 and 0 not in a
    b = cache.alloc(16)
    assert cache.used_blocks == 4 and cache.high_watermark_blocks == 4
    cache.free(a)
    assert cache.free_blocks == 7
    c = cache.alloc(48)
    assert c == a[::-1]  # LIFO: the most recently freed blocks come back first
    cache.free(b)
    cache.free(c)
    assert cache.free_blocks == 8 and cache.high_watermark_blocks == 4


def test_allocator_rejects_bad_frees_and_exhaustion():
    cache = BlockKVCache(num_layers=1, num_heads=1, head_dim=4,
                         num_blocks=4, block_size=8, max_blocks_per_seq=3,
                         device="cpu")
    blocks = cache.alloc(24)  # all 3
    assert not cache.can_alloc(1)
    with pytest.raises(RuntimeError, match="exhausted"):
        cache.alloc(8)
    with pytest.raises(ValueError, match="outside the pool"):
        cache.free([0])
    cache.free(blocks)
    with pytest.raises(ValueError, match="double free"):
        cache.free([blocks[0]])
    with pytest.raises(ValueError, match="trash"):
        BlockKVCache(num_layers=1, num_heads=1, head_dim=4, num_blocks=1,
                     block_size=8, max_blocks_per_seq=1, device="cpu")


def test_blocks_for_tokens_math():
    assert blocks_for_tokens(1, 16) == 1
    assert blocks_for_tokens(16, 16) == 1
    assert blocks_for_tokens(17, 16) == 2


def test_table_row_pads_with_trash_and_pools_live_on_device():
    cache = BlockKVCache(num_layers=2, num_heads=3, head_dim=4,
                         num_blocks=8, block_size=8, max_blocks_per_seq=5,
                         dtype=torch.bfloat16, device="cpu")
    assert cache.table_row([3, 1]).tolist() == [3, 1, 0, 0, 0]
    assert cache.k_pool.shape == (2, 8, 8, 3, 4) == cache.v_pool.shape
    assert cache.k_pool.dtype == torch.bfloat16 and cache.k_pool.device.type == "cpu"
    assert cache.pool_bytes == 2 * 2 * 8 * 8 * 3 * 4 * 2
    cache.drop_pools()
    assert cache._k_pool is None


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def test_prefill_kv_matches_jax(pair):
    jlm, params, tlm = pair
    toks = np.random.default_rng(3).integers(0, VOCAB, (2, 20)).astype(np.int32)
    jk, jv, jlogits = jax_prefill_kv(jlm, params, jnp.asarray(toks))
    tk, tv, tlogits = prefill_kv(tlm, torch.from_numpy(toks))
    assert tk.shape == jk.shape == (2, 2, 20, 4, 8)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)


@pytest.mark.parametrize("plen,new,eos", [(1, 6, None), (9, 12, None), (5, 20, 3)])
def test_generate_tokens_match_jax(pair, plen, new, eos):
    jlm, params, tlm = pair
    prompt = np.random.default_rng(plen).integers(0, VOCAB, (2, plen)).astype(np.int32)
    want = np.asarray(jax_generate(jlm, params, jnp.asarray(prompt), new,
                                   eos_token=eos))
    got = generate(tlm, prompt, new, eos_token=eos).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Engine == the port's generate()
# ---------------------------------------------------------------------------


CASES = [(5, 8, None), (9, 4, None), (3, 12, None), (16, 6, None),
         (6, 20, 3), (4, 1, None)]


@pytest.mark.parametrize("attention", ["naive", "flash"])
@pytest.mark.parametrize("continuous", [True, False])
def test_engine_streams_equal_generate(models, attention, continuous):
    tlm = models[attention]
    eng = InferenceEngine(tlm, slots=3, block_size=8, continuous=continuous)
    eng.warmup(prompt_lengths=(3, 9, 16))
    rng = np.random.default_rng(7)
    reqs = [eng.submit(_prompt(rng, p), n, eos_token=e) for p, n, e in CASES]
    summary = eng.run()
    assert summary["completed"] == len(CASES) and summary["rejected"] == 0
    assert summary["tokens"] == sum(len(r.tokens) for r in reqs)
    for req in reqs:
        np.testing.assert_array_equal(np.asarray(req.tokens), _reference(tlm, req))
    assert eng.cache.free_blocks == eng.cache.num_blocks - 1
    if not continuous:
        # Static batching: the second group starts only after the first
        # drained, so the last request waited for a full group.
        assert reqs[-1].admitted_t >= max(r.finished_t for r in reqs[:3])
    eng.close()


def test_midflight_join_equals_generate(models):
    tlm = models["flash"]
    eng = InferenceEngine(tlm, slots=2, block_size=8)
    rng = np.random.default_rng(1)
    first = eng.submit(_prompt(rng, 9), 20)
    for _ in range(3):
        eng.step()
    assert first.status == "active" and len(first.tokens) == 4
    late = eng.submit(_prompt(rng, 5), 8)    # joins the running batch
    later = eng.submit(_prompt(rng, 12), 6)  # waits for a slot
    eng.run()
    for req in (first, late, later):
        np.testing.assert_array_equal(np.asarray(req.tokens), _reference(tlm, req))
    assert late.admitted_t < first.finished_t


@pytest.mark.parametrize("attention", ["naive", "flash"])
def test_poisoned_trash_block_leaves_streams_identical(models, attention):
    """Idle slots and padded prefill positions write into block 0, and
    every attend masks it: filling it with 1e6 changes nothing."""
    tlm = models[attention]
    eng = InferenceEngine(tlm, slots=3, block_size=8)
    rng = np.random.default_rng(11)
    specs = [(_prompt(rng, p), n) for p, n in ((5, 9), (11, 3), (2, 14))]
    with torch.no_grad():
        eng.cache.k_pool[:, 0] = 1e6
        eng.cache.v_pool[:, 0] = 1e6
    reqs = [eng.submit(p, n) for p, n in specs]
    eng.run()
    for req in reqs:
        np.testing.assert_array_equal(np.asarray(req.tokens), _reference(tlm, req))


def test_eos_evicts_early_and_frees_blocks(pair):
    _, _, tlm = pair
    prompt = _prompt(np.random.default_rng(5), 6)
    free_run = generate(tlm, prompt[None], 20)[0, 6:].numpy()
    eos = int(free_run[4])
    stop = int(np.where(free_run == eos)[0][0])
    eng = InferenceEngine(tlm, slots=2, block_size=8)
    seen = []
    req = eng.submit(prompt, 20, eos_token=eos, on_token=seen.append)
    eng.run()
    assert req.tokens == free_run[: stop + 1].tolist() and req.tokens[-1] == eos
    assert seen == req.tokens and list(req.stream(timeout=0)) == req.tokens
    assert req.status == "finished"
    assert eng.cache.free_blocks == eng.cache.num_blocks - 1
    np.testing.assert_array_equal(req.result()[:6], prompt)


def test_queue_full_drain_and_close_reject(pair):
    _, _, tlm = pair
    eng = InferenceEngine(tlm, slots=1, block_size=8, max_queue=2)
    rng = np.random.default_rng(2)
    kept = [eng.submit(_prompt(rng, 4), 3) for _ in range(2)]
    shed = eng.submit(_prompt(rng, 4), 3)
    assert shed.status == "rejected" and shed.reject_reason == "queue_full"
    with pytest.raises(RequestRejectedError) as info:
        shed.result(timeout=0)
    assert info.value.reject_reason == "queue_full"
    with pytest.raises(RequestRejectedError):
        list(shed.stream(timeout=0))
    eng.step()                 # admits kept[0]
    eng.drain()                # kept[1] is still queued: rejected
    assert kept[1].reject_reason == "draining"
    summary = eng.run()        # kept[0] decodes to completion
    assert kept[0].status == "finished" and summary["drained"] == 1
    assert summary["rejected"] == 2 and summary["completed"] == 1
    assert eng.submit(_prompt(rng, 4), 3).reject_reason == "draining"
    eng.close()
    assert eng.cache._k_pool is None
    with pytest.raises(ValueError, match="exceeds the engine's max_len"):
        eng.submit(_prompt(rng, 60), 10)
