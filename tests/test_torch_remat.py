"""Remat of the port's layer stacks against the run without it and the JAX package.

``build(cfg, remat=...)`` recomputes each unit of an LM's layer stack (and
each layer of the encoder-decoder) in the backward through
``models/remat.py::Remat``, an ``autograd.Function`` whose forward runs
under ``no_grad`` and whose backward replays the unit with
``torch.func.vjp``; ``"dots"`` runs as ``"full"``.

Tolerances:
- with remat against without, in the port: loss and every per-worker
  gradient leaf of ``vmap(grad)`` (shared and worker-stacked params)
  bitwise: the recompute replays the same ops on the same inputs.
- each worker's against ``jax.grad`` of the JAX ``Model.loss_fn`` built
  with the same ``remat``: 1e-5 of each leaf's largest magnitude, the LM
  parity tests' tolerance (fp32 products summed in other orders); 1e-4
  for reduced mamba2_370m, whose ``a_log`` gradient sums the chunk's decay
  terms with cancellation (the second worker's reads 1.67e-5 of its max
  against the JAX package with or without remat, where the port's remat
  moves nothing; ``tests/test_torch_ssd_train.py`` holds another draw at
  1e-5); plus
  the JAX package's own gap between that gradient and its gradient
  without remat (XLA reorders the recomputed sums: up to 2.6e-6 of
  max|grad| on reduced mamba2's ``a_log``, where the port's remat moves
  nothing).
- ``prefill`` and ``decode_step`` take no gradient: bitwise equal for every
  remat.

One test item, torch on one intra-op thread (the suite's item count sets
pytest-xdist's chunk sizes, ROADMAP.md).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build as jax_build
from repro_torch.configs import get_config
from repro_torch.core.sasg import per_worker_grad_fn
from repro_torch.core.types import tree_leaves, tree_map
from repro_torch.models import build, params_from_numpy

TOL = 1e-5
M = 2
# arch -> (tokens per sequence, gradient tolerance against the JAX package)
ARCHS = {"mamba2_370m": (64, 1e-4), "llama3_8b": (16, TOL), "seamless_m4t_v2": (8, TOL)}


@pytest.fixture
def one_thread():
    """Torch on one intra-op thread: small tensors, and under pytest-xdist a
    pool of one thread per core would oversubscribe the machine. One thread
    also keeps the CPU's embedding backward in one summation order, so two
    runs can be compared bitwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got: torch.Tensor, want, tol=TOL, what=None, gap=0.0):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()) + gap, (what, err, gap,
                                                          float(np.abs(want).max()))


def _batch(jcfg, seq):
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (M, 2, seq)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=2)}
    if jcfg.is_encdec:
        batch["frames"] = rng.normal(size=(M, 2, seq, jcfg.d_model)).astype(np.float32)
    return batch


def _check_arch(arch, seq, tol):
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    stacked = tree_map(lambda x: torch.stack([x] * M), tparams)
    batch = _batch(jcfg, seq)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jax_none = jax.jit(jax.grad(jax_build(jcfg).loss_fn))
    runs = {}
    for remat in ("none", "full", "dots"):
        fn = per_worker_grad_fn(build(tcfg, remat=remat).loss_fn)
        runs[remat] = [fn(tparams, tbatch, False), fn(stacked, tbatch, True)]
    for remat in ("full", "dots"):
        for (la, ga), (lb, gb) in zip(runs[remat], runs["none"]):
            assert torch.equal(la, lb), (arch, remat)
            for a, b in zip(tree_leaves(ga), tree_leaves(gb)):
                assert torch.equal(a, b), (arch, remat)

        vag = jax.jit(jax.value_and_grad(jax_build(jcfg, remat=remat).loss_fn))
        lt, gt = runs[remat][0]
        for w in range(M):
            one = jax.tree.map(lambda v: jnp.asarray(v[w]), batch)
            lj, gj = vag(jparams, one)
            np.testing.assert_allclose(float(lt[w]), float(lj), rtol=TOL)
            jleaves = jax.tree.leaves(gj)
            assert len(jleaves) == len(tree_leaves(gt))
            for path, a, b, c in zip(jax.tree_util.tree_flatten_with_path(gj)[0], jleaves,
                                     tree_leaves(gt), jax.tree.leaves(jax_none(jparams, one))):
                _close(b[w], a, tol, what=(arch, remat, jax.tree_util.keystr(path[0])),
                       gap=float(jnp.abs(a - c).max()))

    # no gradient, no remat: prefill (and the decode step after it) alike
    one = {k: v[0] for k, v in tbatch.items()}
    outs = [build(tcfg, remat=r).prefill(tparams, one) for r in ("none", "full", "dots")]
    for logits, cache in outs[1:]:
        assert torch.equal(logits, outs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cache),
                                                    tree_leaves(outs[0][1])))


def test_remat_matches_no_remat_and_jax(one_thread):
    """Reduced mamba2_370m (SSD chunk Functions nested in the recompute),
    reduced llama3_8b (attention + MLP) and reduced seamless_m4t_v2
    (encoder and decoder layers): loss and per-worker gradients with
    ``remat="full"`` / ``"dots"`` bitwise the run without remat and within
    1e-5 of ``jax.grad`` with the same remat; prefill unchanged;
    an unknown policy refused."""
    for arch, (seq, tol) in ARCHS.items():
        _check_arch(arch, seq, tol)
    with pytest.raises(ValueError, match="unknown remat policy 'some'"):
        build(get_config("llama3_8b").reduced(), remat="some")
