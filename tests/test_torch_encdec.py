"""The port's encoder-decoder (seamless_m4t_v2) against the JAX package's,
on the reduced config (fp32), with params carried by ``params_from_numpy``
and numpy inputs from a seed.

Tolerances (of the reference's largest magnitude): 1e-5 for attention
outputs, the encoder's output, the cross K/V, decode logits, the loss and
each gradient leaf (the same fp32 algebra with sums in other orders;
measured ~1e-6); generated tokens equal.

One test item running every check (see tests/test_torch_rglru.py on the
suite's item count under pytest-xdist).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build as jax_build
from repro.models import encdec as JED
from repro.models import layers as JL
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.types import tree_leaves, tree_map
from repro_torch.models import build, params_from_numpy
from repro_torch.models import encdec as TED
from repro_torch.models import layers as TL

ARCH = "seamless_m4t_v2"
TOL = 1e-5
ED_BF16_GAP = 2e-2
B, S_SRC, S_TGT = 2, 10, 8


def _close(got: torch.Tensor, want, tol=TOL) -> float:
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, float(np.abs(want).max()))
    return err


def _pair():
    jcfg, tcfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(3)
    frames = rng.normal(size=(B, S_SRC, jcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (B, S_TGT)).astype(np.int32)
    return jcfg, tcfg, jmodel, jparams, build(tcfg), tparams, frames, toks


def _check_attention():
    """``attention_apply`` with ``cross_kv`` (q projected alone, no RoPE,
    no cache read or written though one is passed, every source position
    visible, per-row positions ignored) and the encoder's non-causal
    self-attention, both against the JAX package; a cross-attention output
    does not move with the query positions, a non-causal one differs from
    the causal one."""
    jcfg, tcfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = JL.attention_init(jax.random.PRNGKey(1), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, 5, jcfg.d_model)).astype(np.float32)
    kv = [rng.normal(size=(B, S_SRC, jcfg.n_kv_heads, jcfg.head_dim)).astype(np.float32)
          for _ in range(2)]
    cache = {"k": np.zeros((B, 16, jcfg.n_kv_heads, jcfg.head_dim), np.float32),
             "v": np.zeros((B, 16, jcfg.n_kv_heads, jcfg.head_dim), np.float32),
             "pos": np.full((B, 16), -1, np.int32)}
    pos = np.arange(3, 8)
    # jitted: eager, the JAX package's streaming softmax compiles its scan per call
    jax_attention = jax.jit(JL.attention_apply, static_argnums=1,
                            static_argnames=("kind", "causal"))
    want, jc = jax_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), kind="global",
                                  cache=jax.tree.map(jnp.asarray, cache),
                                  cross_kv=tuple(map(jnp.asarray, kv)), causal=False)
    got, tc = TL.attention_apply(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos),
                                 cache=tree_map(torch.from_numpy, cache),
                                 cross_kv=tuple(map(torch.from_numpy, kv)), causal=False)
    assert jc is None and tc is None
    _close(got, want)
    shifted, _ = TL.attention_apply(tp, tcfg, torch.from_numpy(x),
                                    torch.tensor([[0, 1, 2, 3, 4], [9, 8, 7, 6, 5]]),
                                    cross_kv=tuple(map(torch.from_numpy, kv)))
    assert torch.equal(shifted, got)

    xs = rng.normal(size=(B, S_SRC, jcfg.d_model)).astype(np.float32)
    positions = np.arange(S_SRC)
    for causal in (False, True):
        want, _ = jax_attention(jp, jcfg, jnp.asarray(xs), jnp.asarray(positions),
                                causal=causal)
        got, _ = TL.attention_apply(tp, tcfg, torch.from_numpy(xs), torch.from_numpy(positions),
                                    causal=causal)
        _close(got, want)
        if causal:
            assert not torch.allclose(got, non_causal)
        non_causal = got


def _check_reduced_model(pair):
    """The configs field by field and the params tree of the port's own
    init; ``encode``, ``cross_kv``, teacher-forced ``decode``, ``loss_fn``
    and every gradient leaf; ``Model.prefill`` (self cache sized to the
    prompt, as the JAX package's) with its cache; the launchers refuse an
    encoder-decoder with a ``ValueError``."""
    assert ARCH in ARCH_IDS
    for reduce in (False, True):
        jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
        if reduce:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), reduce
    jcfg, tcfg, jmodel, jparams, tmodel, tparams, frames, toks = pair
    assert tcfg.encoder_layers == 2 and tcfg.n_layers == 2
    own = tmodel.init(torch.Generator().manual_seed(0))
    assert [(tuple(x.shape), x.dtype) for x in jax.tree.leaves(own)] == [
        (tuple(x.shape), x.dtype) for x in jax.tree.leaves(tparams)]
    paths = ["/".join(str(getattr(k, "key", k)) for k in p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert "dec_stack/xattn/wq" in paths and "enc_norm/scale" in paths

    ej = jax.jit(JED.encode, static_argnums=1)(jparams, jcfg, jnp.asarray(frames))
    et = TED.encode(tparams, tcfg, torch.from_numpy(frames))
    _close(et, ej)
    xj, xt = JED.cross_kv(jparams, jcfg, ej), TED.cross_kv(tparams, tcfg, et)
    assert tuple(xt["k"].shape) == (2, B, S_SRC, tcfg.n_kv_heads, tcfg.head_dim)
    for key in ("k", "v"):
        _close(xt[key], xj[key])
    lj, _ = jax.jit(JED.decode, static_argnums=1)(jparams, jcfg, jnp.asarray(toks), xj)
    lt, cache = TED.decode(tparams, tcfg, torch.from_numpy(toks), xt)
    assert cache is None
    _close(lt, lj)

    batch = {"frames": frames, "tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    lj, gj = jax.jit(jax.value_and_grad(jmodel.loss_fn))(
        jparams, jax.tree.map(jnp.asarray, batch))
    gt, lt = torch.func.grad_and_value(tmodel.loss_fn)(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(lt), float(lj), rtol=TOL)
    jleaves = jax.tree.leaves(gj)
    assert len(jleaves) == len(tree_leaves(gt))
    for a, b in zip(jleaves, tree_leaves(gt)):
        _close(b, a)

    lj, cj = jax.jit(jmodel.prefill)(jparams, jax.tree.map(jnp.asarray, batch))
    lt, ct = tmodel.prefill(tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(lt, lj)
    assert tuple(ct["self"]["k"].shape[:3]) == (2, B, S_TGT)
    for a, b in zip(jax.tree.leaves(cj), tree_leaves(ct)):
        if b.dtype == torch.int32:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            _close(b, a)

    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch

    with pytest.raises(ValueError, match="no frames.*scalar position"):
        serve_launch.serve(["--arch", ARCH, "--reduced", "--device", "cpu"])
    with pytest.raises(ValueError, match="no frames"):
        train_launch.train(["--arch", ARCH, "--reduced", "--workers", "2", "--global-batch",
                            "4", "--steps", "1", "--device", "cpu"])


def _generate(step, cache, prompt, new, argmax):
    """The prompt through ``decode_step`` at position 0, then ``new``
    greedy tokens one at a time."""
    logits, cache = step(cache, prompt, 0)
    outs, tokens = [logits], []
    for t in range(new):
        nxt = argmax(logits[:, -1])[:, None]
        tokens.append(np.asarray(nxt))
        logits, cache = step(cache, nxt, prompt.shape[1] + t)
        outs.append(logits)
    return outs, np.concatenate(tokens, 1)


def _chains(jcfg, tcfg, jmodel, jparams, tmodel, tparams, frames, toks, new, max_seq):
    """The port's and the JAX package's generation chains (same calls), and
    the port's teacher-forced decode over its generated tokens."""
    tcache = tmodel.init_cache(B, max_seq)
    assert tuple(tcache["xkv"]["k"].shape) == (2, B, max_seq, tcfg.n_kv_heads, tcfg.head_dim)
    tcache["xkv"] = TED.cross_kv(tparams, tcfg, TED.encode(tparams, tcfg,
                                                           torch.from_numpy(frames)))
    touts, ttoks = _generate(lambda c, x, p: tmodel.decode_step(tparams, c, x, p), tcache,
                             torch.from_numpy(toks), new,
                             lambda lg: lg.argmax(-1).to(torch.int32))
    jcache = jmodel.init_cache(B, max_seq)
    jcache["xkv"] = JED.cross_kv(jparams, jcfg, JED.encode(jparams, jcfg, jnp.asarray(frames)))
    jstep = jax.jit(lambda c, x, p: jmodel.decode_step(jparams, c, x, p))
    jouts, jtoks = _generate(jstep, jcache, jnp.asarray(toks), new,
                             lambda lg: jnp.argmax(lg, -1).astype(jnp.int32))
    seq = np.concatenate([toks, ttoks[:, :-1]], axis=1)
    forced, _ = TED.decode(tparams, tcfg, torch.from_numpy(seq), tcache["xkv"])
    return touts, ttoks, jouts, jtoks, forced


def _check_generation(pair):
    """Generation as the reference's functions define it: ``init_cache(B,
    max_seq)`` with its ``"xkv"`` replaced by ``cross_kv(encode(frames))``,
    the prompt at position 0, then 4 greedy tokens. The port's chain
    against the JAX chain (same calls): tokens equal, every step's logits
    within 1e-5; and against a teacher-forced ``decode(..., cache=None)``
    over the same tokens within 1e-5. In bf16 the chain stores RoPE'd keys
    rounded to bf16 where the teacher-forced decode keeps them in fp32, in
    both packages: the port's bf16 chain gives the JAX bf16 chain's tokens
    and logits within 4 bf16 ulps at max|logits| (measured 2: the two
    packages' bf16 products round in other orders), and differs
    from its teacher-forced decode by up to ED_BF16_GAP of max|logits|
    (the JAX package's own gap here: 6.1e-3; ``chip_smoke.py`` phase 13
    (c) holds full depth to 5e-2)."""
    new, max_seq = 4, 16
    touts, ttoks, jouts, jtoks, forced = _chains(*pair, new, max_seq)
    np.testing.assert_array_equal(ttoks, jtoks)
    for a, b in zip(jouts, touts):
        _close(b, a)
    _close(torch.cat(touts[:-1], 1), forced.numpy())

    jcfg, tcfg = (dataclasses.replace(c.reduced(), param_dtype="bfloat16",
                                      compute_dtype="bfloat16")
                  for c in (jax_get_config(ARCH), get_config(ARCH)))
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    frames, toks = pair[6:]
    touts, ttoks, jouts, jtoks, forced = _chains(jcfg, tcfg, jmodel, jparams, build(tcfg),
                                                 tparams, frames, toks, new, max_seq)
    np.testing.assert_array_equal(ttoks, jtoks)
    for a, b in zip(jouts, touts):
        want = np.asarray(a, np.float32)
        peak = float(np.abs(want).max())
        ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)     # bf16 spacing at max|logits|
        assert float(np.abs(b.float().numpy() - want).max()) <= 4 * ulp
    chain = torch.cat(touts[:-1], 1).float()
    gap = float((chain - forced.float()).abs().max() / forced.float().abs().max())
    assert 0 < gap <= ED_BF16_GAP, gap


@pytest.fixture
def one_thread():
    """Torch on one intra-op thread for the test: its tensors are small, and
    under pytest-xdist every worker's default pool of one thread per core
    oversubscribes the machine and slows the other workers' tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_encoder_decoder_matches_jax(one_thread):
    """Cross- and encoder attention; the reduced model, loss, gradients,
    ``prefill`` and the launchers' refusal; generation in fp32 and bf16
    (see each check)."""
    _check_attention()
    pair = _pair()
    _check_reduced_model(pair)
    _check_generation(pair)
