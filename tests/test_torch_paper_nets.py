"""The port's paper nets against the JAX package's, with the same params
(carried over by ``params_from_numpy``) and the same numpy batches.

Tolerance rtol 1e-4 / atol 1e-5 on logits, loss and grads: both run fp32,
but XLA and PyTorch sum convolutions, GroupNorm statistics and matmuls in
different orders (fp32 reassociation). The param draws are ones whose fp32
gradients are well conditioned: some draws of the d_model=16 CNN (JAX
PRNGKey(3), for one) put the JAX package's own fp32 gradient 2e-3 away
from its fp64 gradient, and no fp32 port could match it closer than that."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.data import replay as jax_replay, synthetic as jax_synth
from repro.models import build as jax_build
from repro.models import paper_nets as JPN
from repro_torch.configs import get_config
from repro_torch.data import replay, synthetic
from repro_torch.models import build, params_from_numpy
from repro_torch.models import paper_nets as PN
from repro_torch.core.types import tree_flatten_with_paths

RTOL, ATOL = 1e-4, 1e-5


def _models(arch, d_model=None):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    if d_model:
        jcfg = dataclasses.replace(jcfg, d_model=d_model)
        tcfg = dataclasses.replace(tcfg, d_model=d_model)
    return jax_build(jcfg), build(tcfg)


def _batch(arch, n, seed):
    img = (28, 28, 1) if arch == "fc_mnist" else (32, 32, 3)
    x, y = jax_synth.synthetic_classification(64, 10, img, seed=seed)
    return {"x": x[:n], "labels": y[:n]}


@pytest.mark.parametrize("arch,d_model", [("fc_mnist", None), ("cnn_cifar", 16)])
def test_logits_loss_grads_vs_jax(arch, d_model):
    jm, tm = _models(arch, d_model)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    batch = _batch(arch, 6, seed=1)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = {"x": torch.from_numpy(batch["x"]), "labels": torch.from_numpy(batch["labels"]).long()}

    np.testing.assert_allclose(tm.prefill(tparams, tb).numpy(),
                               np.asarray(jm.prefill(jparams, jb)), rtol=RTOL, atol=ATOL)
    jl, jg = jax.value_and_grad(jm.loss_fn)(jparams, jb)
    tg, tl = torch.func.grad_and_value(tm.loss_fn)(tparams, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    paths, leaves, _ = tree_flatten_with_paths(tg)
    jpaths = ["/".join(str(k.key) for k in p)
              for p, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    assert paths == jpaths
    for p, a, b in zip(paths, leaves, jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=p)


def test_leaf_paths_and_shapes_match_jax_init():
    """The port stores params in the JAX shapes (HWIO convs, stacked trunk),
    so the per-shard block geometry is the same in both packages."""
    for arch in ("fc_mnist", "cnn_cifar"):
        jm, tm = _models(arch)
        jshapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        jflat = jax.tree_util.tree_flatten_with_path(jshapes)[0]
        paths, leaves, _ = tree_flatten_with_paths(tm.init(torch.Generator().manual_seed(0)))
        assert paths == ["/".join(str(k.key) for k in p) for p, _ in jflat]
        assert [tuple(x.shape) for x in leaves] == [tuple(s.shape) for _, s in jflat]
    assert sum(x.numel() for x in leaves) == 2_776_906 and len(leaves) == 37


@pytest.mark.parametrize("size,k,stride", [(32, 3, 2), (16, 3, 2), (8, 1, 2), (9, 3, 2), (8, 3, 1)])
def test_same_padding_vs_xla(size, k, stride):
    """XLA's SAME pads a 3x3 stride-2 conv on an even size 0 before and 1
    after; the symmetric ``padding=1`` of F.conv2d computes another
    function there."""
    rng = np.random.default_rng(size + k)
    x = rng.normal(size=(2, size, size, 4)).astype(np.float32)
    w = rng.normal(size=(k, k, 4, 8)).astype(np.float32)
    want = np.asarray(JPN._conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = PN._conv(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w), stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=RTOL, atol=ATOL)
    if (size, k, stride) == (32, 3, 2):
        sym = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(w).permute(3, 2, 0, 1), stride=2, padding=1)
        assert np.max(np.abs(sym.permute(0, 2, 3, 1).numpy() - want)) > 1e-2


def test_data_copies_are_byte_identical():
    for img in ((28, 28, 1), (32, 32, 3)):
        xj, yj = jax_synth.synthetic_classification(300, 10, img, seed=5)
        xt, yt = synthetic.synthetic_classification(300, 10, img, seed=5)
        assert xj.tobytes() == xt.tobytes() and yj.tobytes() == yt.tobytes()
        assert xj.dtype == xt.dtype and yj.dtype == yt.dtype
        sj = jax_replay.indexed_classification_stream(xj, yj, 20, seed=2)
        st = replay.indexed_classification_stream(xt, yt, 20, seed=2)
        for step in (0, 7, 19):
            assert jax_replay.batch_fingerprint(sj.batch_at(step)) == \
                jax_replay.batch_fingerprint(st.batch_at(step))
        assert jax_replay.batch_fingerprint(next(iter(sj))) == \
            jax_replay.batch_fingerprint(next(iter(st)))
