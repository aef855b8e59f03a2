"""The decode loops as one program: ``generate``'s and ``beam_search``'s
ticks (``_generate_tick``, ``_beam_tick``: the JAX package's scan bodies,
the carry in device tensors) and the serving engine's decode and prefill
step programs, on the CPU at a small size (2 layers, d 64, vocabulary
97), where every tick runs eagerly:

- the eager ticks (``graphed=False``) and the cached loop (``graphed=True``:
  the static state and the ``StepGraph`` the card replays, eager here)
  against the JAX package's ``generate`` (greedy, batched and scan, with
  and without ``eos_token``: tokens equal) and ``beam_search`` (tokens
  equal, scores within 1e-5), the MoE LM's beam search included (C.31);
- both against the host loop the port ran before (a Python loop over
  ticks branching on the host position, kept here), bit for bit, sampled
  runs from one seeded generator included, and the caller's generator left
  where the eager ticks leave it;
- every tick gets the same Python arguments and the same state tensors;
- under a pretended capture, with ``Tensor.item``, ``__bool__``,
  ``__int__``, ``__float__``, ``__index__`` and ``tolist`` patched to
  raise, a ``generate`` tick, a ``beam_search`` tick, the engine's
  ``_decode_step`` and ``_prefill_step`` run through;
- the engine's decode step sees the same shapes and buffers whether one
  slot or all are active; ``close()`` releases the step graphs before the
  pools go; the loop cache is keyed, bounded and rebuilt for new
  parameter tensors.
"""

import contextlib
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluxmpi_tpu.models import MoETransformerLM as JaxMoE
from fluxmpi_tpu.models import TransformerLM as JaxLM
from fluxmpi_tpu_torch.models import (MoETransformerLM, TransformerLM, beam_search,
                                      load_flax_params)
from fluxmpi_tpu_torch.serving import BlockKVCache, InferenceEngine
from fluxmpi_tpu_torch.utils._step_graph import StepGraph

torch.set_num_threads(1)
gen_mod = importlib.import_module("fluxmpi_tpu_torch.models.generate")
jgen = importlib.import_module("fluxmpi_tpu.models.generate")

VOCAB = 97
CFG = dict(vocab_size=VOCAB, max_len=48, num_layers=2, d_model=64, num_heads=4,
           d_ff=128)
SAMPLED = dict(temperature=0.8, top_k=10, top_p=0.9)


def _pair(jcls=JaxLM, tcls=TransformerLM, **over):
    """A JAX model, its params moved off their init, and the port's with
    them."""
    cfg = {**CFG, **over}
    jlm = jcls(**cfg)
    params = {"params": jax.jit(lambda: jlm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32), train=False))()["params"]}
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)
    tlm = tcls(**cfg, device="cpu")
    load_flax_params(tlm, params)
    return jlm, params, tlm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _prompt(seed, b, plen):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, plen)).astype(np.int32)


def _eos_of(tlm, prompt, new, at=3):
    """A token the free greedy run emits, so ``eos`` fires mid-run."""
    return int(gen_mod._generate(tlm, prompt, new, graphed=False)[0, prompt.shape[1] + at])


# ---------------------------------------------------------------------------
# The host loop the port ran before the ticks became a program
# ---------------------------------------------------------------------------


@torch.no_grad()
def _host_loop_generate(model, prompt, max_new_tokens, *, temperature=0.0, top_k=None,
                        top_p=None, eos_token=None, rng=None, prefill="batched"):
    prompt = torch.as_tensor(prompt).long()
    b, plen = prompt.shape
    total = plen + max_new_tokens
    sample = temperature > 0
    twin = gen_mod._decode_twin(model)
    if prefill == "batched" and plen > 1:
        cache, _ = gen_mod.prefill_cache(model, prompt[:, : plen - 1], total)
        if sample:
            for _ in range(plen - 1):
                gen_mod._gumbel(b, VOCAB, rng, "cpu")
        start = plen - 1
    else:
        cache = gen_mod._sized_cache(twin, b, total)
        start = 0
    tok = prompt[:, start:start + 1]
    done = torch.zeros((b,), dtype=torch.bool)
    out = []
    for p in range(start, total - 1):
        logits, cache = twin(tok, train=False, pos_offset=p, cache=cache)
        logits = logits[:, -1]
        noise = gen_mod._gumbel(b, VOCAB, rng, "cpu") if sample else None
        if p + 1 < plen:
            nxt = prompt[:, p + 1]
        else:
            if sample:
                nxt = (gen_mod._filter_logits(logits, temperature, top_k, top_p)
                       + noise).argmax(dim=-1)
            else:
                nxt = logits.argmax(dim=-1)
            if eos_token is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos_token), nxt)
                done = done | (nxt == eos_token)
        out.append(nxt)
        tok = nxt[:, None]
    gen = torch.stack(out, dim=1)[:, plen - 1 - start:]
    return torch.cat([prompt, gen], dim=1)


@torch.no_grad()
def _host_loop_beam(model, prompt, max_new_tokens, *, beam_size, length_penalty=0.0,
                    eos_token=None):
    prompt = torch.as_tensor(prompt).long()
    b, plen = prompt.shape
    total = plen + max_new_tokens
    beam, rows, alpha = beam_size, b * beam_size, float(length_penalty)

    def lp(length):
        return ((5.0 + length.float()) / 6.0) ** alpha

    twin = gen_mod._decode_twin(model)
    cache, _ = gen_mod.prefill_cache(model, prompt[:, : plen - 1], total)
    cache = {k: c.repeat_interleave(beam, dim=0) if c.ndim else c for k, c in cache.items()}
    toks = torch.zeros((b, beam, total), dtype=torch.long)
    toks[:, :, :plen] = prompt[:, None, :]
    cum = torch.full((b, beam), float("-inf"))
    cum[:, 0] = 0.0
    done = torch.zeros((b, beam), dtype=torch.bool)
    flen = torch.full((b, beam), max_new_tokens, dtype=torch.long)
    base = (torch.arange(b) * beam)[:, None]
    if eos_token is not None:
        eos_row = torch.full((VOCAB,), float("-inf"))
        eos_row[eos_token] = 0.0
    for pos in range(plen - 1, total - 1):
        tok = toks.reshape(rows, total)[:, pos:pos + 1]
        logits, cache = twin(tok, train=False, pos_offset=pos, cache=cache)
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1).reshape(b, beam, VOCAB)
        if eos_token is not None:
            logp = torch.where(done[:, :, None], eos_row, logp)
        raw = (cum[:, :, None] + logp).reshape(b, beam * VOCAB)
        gen_count = pos + 2 - plen
        if alpha != 0.0:
            pen = lp(torch.where(done, flen, torch.full_like(flen, gen_count)))
            rank = (raw.reshape(b, beam, VOCAB) / pen[:, :, None]).reshape(b, -1)
        else:
            rank = raw
        top_idx = torch.topk(rank, beam, dim=1).indices
        cum = torch.gather(raw, 1, top_idx)
        parent, token = top_idx // VOCAB, top_idx % VOCAB
        toks = torch.gather(toks, 1, parent[:, :, None].expand(-1, -1, total))
        toks[:, :, pos + 1] = token
        done = torch.gather(done, 1, parent)
        flen = torch.gather(flen, 1, parent)
        if eos_token is not None:
            ends_now = (token == eos_token) & ~done
            flen = torch.where(ends_now, torch.full_like(flen, gen_count), flen)
            done = done | (token == eos_token)
        flat = (parent + base).reshape(rows)
        cache = {k: c.index_select(0, flat) if c.ndim else c for k, c in cache.items()}
    scored = cum / lp(flen)
    best = scored.argmax(dim=1)
    return toks[torch.arange(b), best], scored[torch.arange(b), best]


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_eos", [False, True])
@pytest.mark.parametrize("prefill", ["batched", "scan"])
def test_ticks_match_jax_generate(pair, prefill, with_eos):
    """Greedy tokens exactly equal to JAX's, from the eager ticks and from
    the cached loop."""
    jlm, params, tlm = pair
    prompt = _prompt(4, 3, 7)
    eos = _eos_of(tlm, prompt, 12) if with_eos else None
    want = np.asarray(jgen.generate(jlm, params, jnp.asarray(prompt), 12,
                                    eos_token=eos, prefill=prefill))
    for graphed in (False, True):
        got = gen_mod._generate(tlm, prompt, 12, graphed=graphed, eos_token=eos,
                                prefill=prefill)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"graphed={graphed}")
    if with_eos:
        row = want[0, 7:]
        assert (row == eos).any() and np.all(row[np.flatnonzero(row == eos)[0]:] == eos)


@pytest.mark.parametrize("with_eos", [False, True])
@pytest.mark.parametrize("alpha", [0.0, 0.6])
def test_beam_ticks_match_jax(pair, alpha, with_eos):
    jlm, params, tlm = pair
    prompt = _prompt(11, 2, 6)
    eos = _eos_of(tlm, prompt, 10, at=2) if with_eos else None
    want_t, want_s = jgen.beam_search(jlm, params, jnp.asarray(prompt), 10, beam_size=4,
                                      length_penalty=alpha, eos_token=eos)
    for graphed in (False, True):
        got_t, got_s = gen_mod._beam_search(tlm, prompt, 10, graphed=graphed, beam_size=4,
                                            length_penalty=alpha, eos_token=eos)
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5, rtol=0)


def test_moe_beam_search_prefills_like_jax():
    """C.31: JAX's beam search teacher-forces the prompt one tick at a
    time; the port filled the cache with one causal forward for every
    model, and for the MoE LM (capacity routing drops over-capacity prompt
    tokens in one forward that single-token ticks never drop) its scores
    left JAX's by 0.64. A model that does not declare
    ``batched_prefill_safe`` now prefills by the scan."""
    jlm, params, tlm = _pair(JaxMoE, MoETransformerLM, num_experts=4,
                             capacity_factor=0.5)
    prompt = _prompt(3, 2, 10)
    want_t, want_s = jgen.beam_search(jlm, params, jnp.asarray(prompt), 6, beam_size=3)
    got_t, got_s = beam_search(tlm, prompt, 6, beam_size=3)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# Against the host loop, bit for bit
# ---------------------------------------------------------------------------

CASES = {
    "greedy_batched": dict(prefill="batched"),
    "greedy_scan": dict(prefill="scan"),
    "eos": dict(prefill="batched", eos=True),
    "sampled_batched": dict(prefill="batched", **SAMPLED),
    "sampled_scan": dict(prefill="scan", **SAMPLED),
    "sampled_eos": dict(prefill="scan", eos=True, temperature=1.3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ticks_equal_the_host_loop_bit_for_bit(pair, case):
    """The eager ticks and the cached loop give the old host loop's tokens
    bit for bit; sampled runs draw from one seeded generator and leave it
    where the host loop leaves it; a second call at the same key (another
    generator object, another prompt length) reuses the loop."""
    tlm = pair[2]
    kw = dict(CASES[case])
    prompt = _prompt(9, 3, 8)
    if kw.pop("eos", False):
        kw["eos_token"] = _eos_of(tlm, prompt, 14, at=2)
    sample = "temperature" in kw

    def gen(seed):
        return torch.Generator().manual_seed(seed) if sample else None

    for seed, p in ((0, prompt), (1, prompt[:, :5])):
        new = 14 + prompt.shape[1] - p.shape[1]  # the same total: the same key
        rngs = [gen(seed) for _ in range(3)]
        want = _host_loop_generate(tlm, p, new, rng=rngs[0], **kw)
        eager = gen_mod._generate(tlm, p, new, graphed=False, rng=rngs[1], **kw)
        looped = gen_mod._generate(tlm, p, new, graphed=True, rng=rngs[2], **kw)
        assert torch.equal(eager, want) and torch.equal(looped, want), seed
        if sample:
            assert torch.equal(rngs[1].get_state(), rngs[0].get_state())
            assert torch.equal(rngs[2].get_state(), rngs[0].get_state())
    assert len(gen_mod._loops[tlm]) >= 1
    keys = [k for k in gen_mod._loops[tlm] if k[0] == "generate" and k[2] == 22]
    assert keys, "the cached loop at total 22"


@pytest.mark.parametrize("with_eos", [False, True])
def test_beam_ticks_equal_the_host_loop_bit_for_bit(pair, with_eos):
    tlm = pair[2]
    prompt = _prompt(5, 2, 6)
    eos = _eos_of(tlm, prompt, 9, at=1) if with_eos else None
    want_t, want_s = _host_loop_beam(tlm, prompt, 9, beam_size=3, length_penalty=0.6,
                                     eos_token=eos)
    for graphed in (False, True):
        got_t, got_s = gen_mod._beam_search(tlm, prompt, 9, graphed=graphed, beam_size=3,
                                            length_penalty=0.6, eos_token=eos)
        assert torch.equal(got_t, want_t) and torch.equal(got_s, want_s), graphed


# ---------------------------------------------------------------------------
# Every tick the same program
# ---------------------------------------------------------------------------


def _signature(args, kwargs):
    """A tick's Python arguments: tensors by identity and address, the rest
    by value; the state's tensors by address."""
    def one(v):
        if torch.is_tensor(v):
            return ("tensor", id(v), v.data_ptr(), tuple(v.shape), v.dtype)
        if isinstance(v, torch.Generator):
            return ("generator", id(v))
        if isinstance(v, torch.nn.Module):
            return ("module", id(v))
        if hasattr(v, "__dict__") and not callable(v):  # the state namespace
            return ("state", id(v), tuple(
                (k, one(t)) for k, t in sorted(vars(v).items()) if k != "cache")
                + tuple((k, one(t)) for k, t in sorted(v.cache.items())))
        return v
    return tuple(one(a) for a in args) + tuple((k, one(v)) for k, v in sorted(kwargs.items()))


@pytest.mark.parametrize("graphed", [False, True])
@pytest.mark.parametrize("what", ["generate", "beam_search"])
def test_every_tick_gets_the_same_arguments(pair, monkeypatch, what, graphed):
    tlm = pair[2]
    name = "_generate_tick" if what == "generate" else "_beam_tick"
    real, seen = getattr(gen_mod, name), []

    def recorder(*args, **kwargs):
        seen.append(_signature(args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(gen_mod, name, recorder)
    gen_mod._loops.pop(tlm, None)  # the loop binds its tick when it is made
    prompt = _prompt(6, 2, 5)
    if what == "generate":
        gen_mod._generate(tlm, prompt, 9, graphed=graphed, eos_token=3, prefill="scan",
                          rng=torch.Generator().manual_seed(0), **SAMPLED)
        ticks = 5 + 9 - 1
    else:
        gen_mod._beam_search(tlm, prompt, 9, graphed=graphed, beam_size=3,
                             length_penalty=0.6, eos_token=3)
        ticks = 9
    assert len(seen) == ticks
    assert all(s == seen[0] for s in seen)


# ---------------------------------------------------------------------------
# Nothing read on the host inside a tick or a step
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _pretended_capture(monkeypatch):
    """What a CUDA-graph capture forbids, made to raise on the CPU: every
    host read of a tensor's value; the capture checks say True."""
    from fluxmpi_tpu_torch.parallel import sharding

    def refuse(name):
        def read(self, *args, **kwargs):
            raise RuntimeError(f"host read Tensor.{name} under capture")
        return read

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
        m.setattr(sharding, "_capturing", lambda: True)
        for name in ("item", "__bool__", "__int__", "__float__", "__index__", "tolist"):
            m.setattr(torch.Tensor, name, refuse(name))
        yield


@pytest.mark.parametrize("kind", ["lm", "lm_flash", "moe"])
def test_ticks_read_nothing_on_the_host(pair, monkeypatch, kind):
    if kind == "moe":
        tlm = MoETransformerLM(**CFG, num_experts=4, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    elif kind == "lm_flash":
        tlm = TransformerLM(**CFG, attention="flash", device="cpu")
        tlm.load_state_dict(pair[2].state_dict())
    else:
        tlm = pair[2]
    prompt = torch.from_numpy(_prompt(8, 2, 6)).long()
    twin = gen_mod._decode_twin(tlm)
    st = gen_mod._generate_state(twin, 2, 16)
    gen_mod._generate_load(tlm, st, prompt, "batched")
    rng = torch.Generator().manual_seed(0)
    bst = gen_mod._beam_state(twin, 2, 3, 16, VOCAB, 5)
    gen_mod._beam_load(tlm, bst, prompt, 10, graphed=False)
    with _pretended_capture(monkeypatch):
        for _ in range(3):
            gen_mod._generate_tick(twin, st, eos_token=5, rng=rng, **SAMPLED)
            gen_mod._beam_tick(twin, bst, alpha=0.6, eos_token=5, rng=None)
    assert int(st.pos) == 8 and int(bst.pos) == 8


@pytest.mark.parametrize("attention", ["naive", "flash"])
def test_engine_steps_read_nothing_on_the_host(pair, monkeypatch, attention):
    tlm = pair[2]
    eng = InferenceEngine(tlm, slots=3, block_size=8, attention=attention)
    eng.warmup(prompt_lengths=(5,))
    mb = eng.max_blocks_per_seq
    blocks = eng.cache.alloc(16)
    table = eng.cache.table_row(blocks)
    tables = np.zeros((3, mb), np.int32)
    tables[1] = table
    with _pretended_capture(monkeypatch):
        padded = np.zeros((8,), np.int32)
        padded[:5] = _prompt(2, 1, 5)[0]
        first = eng._prefill_step(padded, 5, table)
        nxt = eng._decode_step(tables, np.asarray([0, 5, 0], np.int32),
                               np.asarray([0, first, 0], np.int32))
    assert 0 <= first < VOCAB and nxt.shape == (3,)
    eng.close()


# ---------------------------------------------------------------------------
# The engine's programs
# ---------------------------------------------------------------------------


def test_engine_step_is_the_same_with_one_or_all_slots_active(pair, monkeypatch):
    """The decode step's arguments, shapes and static buffers do not depend
    on which slots are active (one program whatever joins and leaves), and
    the streams still equal generate()'s."""
    tlm = pair[2]
    eng = InferenceEngine(tlm, slots=3, block_size=8)
    real, seen = eng._decode_step, []

    def record(tables, positions, tokens):
        out = real(tables, positions, tokens)
        graph = eng._graphs["serving.decode_step"]
        seen.append((eng.active_count,
                     tuple((a.shape, a.dtype) for a in (tables, positions, tokens)),
                     id(graph), graph.body,
                     tuple((k, v[0].data_ptr(), tuple(v[0].shape))
                           for k, v in sorted(eng._buffers.items()) if k.startswith("decode."))))
        return out

    monkeypatch.setattr(eng, "_decode_step", record)
    rng = np.random.default_rng(4)
    first = eng.submit(_prompt(1, 1, 6)[0], 12)
    for _ in range(3):
        eng.step()
    rest = [eng.submit(rng.integers(0, VOCAB, n).astype(np.int32), 5) for n in (3, 9)]
    eng.run()
    eng.close()
    counts = {s[0] for s in seen}
    assert 1 in counts and 3 in counts
    assert all(s[1:] == seen[0][1:] for s in seen)
    for req in (first, *rest):
        ref = gen_mod._generate(tlm, req.prompt[None], req.max_new_tokens, graphed=False)
        assert req.tokens == ref[0, len(req.prompt):].tolist()


def test_close_releases_the_step_graphs_before_the_pools(pair, monkeypatch):
    order = []
    real_release, real_drop = StepGraph.release_graph, BlockKVCache.drop_pools

    def release(self):
        order.append(("release", self.name))
        real_release(self)

    def drop(self):
        order.append(("drop", None))
        real_drop(self)

    monkeypatch.setattr(StepGraph, "release_graph", release)
    monkeypatch.setattr(BlockKVCache, "drop_pools", drop)
    eng = InferenceEngine(pair[2], slots=2, block_size=8)
    eng.warmup(prompt_lengths=(5, 12))
    eng.submit(_prompt(3, 1, 5)[0], 4)
    eng.run()
    eng.close()
    names = [n for what, n in order if what == "release"]
    assert set(names) == {"serving.decode_step", "serving.prefill_8", "serving.prefill_16"}
    assert order[-1] == ("drop", None) and len(order) == len(names) + 1


def test_loop_cache_is_keyed_bounded_and_rebuilt_for_new_parameters(pair, monkeypatch):
    tlm = TransformerLM(**CFG, device="cpu")
    tlm.load_state_dict(pair[2].state_dict())
    released = []
    real = StepGraph.release_graph

    def release(self):
        released.append(self.name)
        real(self)

    monkeypatch.setattr(StepGraph, "release_graph", release)
    prompt = _prompt(7, 2, 4)
    gen_mod._generate(tlm, prompt, 6, graphed=True)
    loops = gen_mod._loops[tlm]
    (key, (_, loop)), = loops.items()
    gen_mod._generate(tlm, prompt[:, :3], 7, graphed=True)  # same rows, same total
    assert list(loops) == [key] and loops[key][1] is loop
    for new in range(7, 12):  # five more totals: the first key falls out
        gen_mod._generate(tlm, prompt, new, graphed=True)
    assert len(loops) == gen_mod._LOOPS_KEPT and key not in loops
    assert released == ["generate tick"] * 2
    with torch.no_grad():
        for p in tlm.parameters():
            p.data = p.data.clone()  # other tensors: the graphs read the old ones
    last = next(reversed(loops))
    before = loops[last][1]
    want = gen_mod._generate(tlm, prompt, 11, graphed=False)
    got = gen_mod._generate(tlm, prompt, 11, graphed=True)
    assert loops[last][1] is not before and torch.equal(got, want)
