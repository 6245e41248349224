"""Training the port's Mamba-2 stack against the JAX package's, on the CPU.

The chunk term is ``kernels/ssd_scan/ops.py::SsdChunk``, a
``torch.autograd.Function`` whose CPU forward and backward are the plain
versions ``ssd_chunk_ref`` and ``ssd_chunk_bwd_ref`` (the CUDA kernels are
held to them on the card). The JAX package differentiates its jnp oracle
under ``jax.grad``.

Tolerances:
- ``ssd_chunk_bwd_ref`` against float64 autograd of ``ssd_chunk_ref``:
  1e-10 of the largest magnitude (both float64; measured ~1e-15).
- the fp32 plain backward against a float64 evaluation at full width
  (Q=256, P=64, N=128): ``checks.SSD_BWD_TOL / 5``, the budget that
  tolerance is stated from.
- ``ops.ssd_chunked``'s VJP against the JAX oracle's (``jax.grad`` of its
  outputs' inner product with the cotangents, which is ``jax.vjp``): 1e-5 of
  the largest magnitude (fp32 sums in other orders; measured ~1e-6).
- ``vmap(grad)`` over 3 workers against a loop of per-worker ``grad``s:
  bitwise (the vmap rule folds the workers into the batch of one call).
- reduced mamba2_370m's loss and each gradient leaf against ``jax.grad`` of
  the JAX ``Model.loss_fn``: 1e-5 of the leaf's largest magnitude (fp32
  products summed in other orders; measured ~1e-6).
- a reduced SASG step: sends, rounds and bits exact, loss at rtol 1e-4, as
  tests/test_torch_train_step.py.
- the backward kernel's launch geometry (``ssd_scan_bwd.py``'s helpers,
  which decode block indices as the kernel does): exact.

Three test items, torch on one intra-op thread: the suite's item count sets
pytest-xdist's chunk sizes under ``--dist load`` (ROADMAP.md, queue 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import get_config as jax_get_config
from repro.core.sasg import PRESETS as JAX_PRESETS
from repro.data import indexed_token_stream
from repro.dist.strategy import choose_strategy
from repro.models import build as jax_build
from repro.models import ssd as JS
from repro.optim import constant as jax_constant
from repro.train import build_train_step as jax_build_train_step
from repro_torch.configs import get_config
from repro_torch.core.sasg import PRESETS, per_worker_grad_fn
from repro_torch.core.types import tree_leaves, tree_map
from repro_torch.kernels import checks
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan import ssd_scan_bwd as bwd
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_bwd_ref, ssd_chunk_ref
from repro_torch.models import build, params_from_numpy
from repro_torch.optim import constant
from repro_torch.train import build_train_step

ARCH = "mamba2_370m"
TOL = 1e-5
# two of checks.ssd_cases()'s JAX test shapes: G = 3, and one with h0
CASES = {c.name: c for c in checks.ssd_cases()}
SHAPES = (CASES["jax test (2,96,6,8,3,4,32)"], CASES["jax test h0 (1,64,2,8,1,8,16)"])


@pytest.fixture
def one_thread():
    """Torch on one intra-op thread for the test: its tensors are small, and
    under pytest-xdist every worker's default pool of one thread per core
    oversubscribes the machine and slows the other workers' tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got: torch.Tensor, want, tol=TOL) -> float:
    want = np.asarray(want, dtype=np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (err, float(np.abs(want).max()))
    return err


def _check_plain_backward(case):
    """``ssd_chunk_bwd_ref`` against float64 autograd of ``ssd_chunk_ref``."""
    ins = [t.double().requires_grad_() for t in checks.ssd_chunk_inputs(case, "cpu")]
    y, st = ssd_chunk_ref(*ins)
    gen = torch.Generator().manual_seed(3)
    gy = torch.randn(y.shape, generator=gen, dtype=torch.float64)
    gst = torch.randn(st.shape, generator=gen, dtype=torch.float64)
    want = torch.autograd.grad((y * gy).sum() + (st * gst).sum(), ins)
    got = ssd_chunk_bwd_ref(*[t.detach() for t in ins], gy, gst)
    for a, b in zip(got, want):
        _close(a, b.numpy(), 1e-10)


def _check_vjp_against_jax(case):
    """``ops.ssd_chunked``'s VJP (through ``SsdChunk``) against the JAX
    oracle's, h0 where the case has one."""
    x, dt, a_log, bm, cm, h0 = (t.numpy() for t in checks.ssd_inputs(case, "cpu"))
    with_h0 = "h0" in case.name
    args = (x, dt, a_log, bm, cm) + ((h0,) if with_h0 else ())
    rng = np.random.default_rng(4)
    gy = rng.normal(size=x.shape).astype(np.float32)
    gh = rng.normal(size=(case.b, case.h, case.p, case.n)).astype(np.float32)

    def jfn(*a):
        y, h = JS.ssd_chunked(*a[:5], case.chunk, a[5] if with_h0 else None)
        return jnp.sum(y * gy) + jnp.sum(h * gh), (y, h)

    # jitted: the oracle's vjp op by op takes seconds
    want, (yj, hj) = jax.jit(jax.grad(jfn, argnums=tuple(range(len(args))), has_aux=True))(
        *map(jnp.asarray, args))

    def tfn(*a):
        return ops.ssd_chunked(*a[:5], case.chunk, a[5] if with_h0 else None)

    (yt, ht), tvjp = torch.func.vjp(tfn, *map(torch.from_numpy, args))
    got = tvjp((torch.from_numpy(gy), torch.from_numpy(gh)))
    _close(yt, yj)
    _close(ht, hj)
    assert len(got) == len(want) == len(args)
    for a, b in zip(got, want):
        _close(a, b)


def _check_vmap_grad(case, monkeypatch):
    """``vmap(grad)`` over 3 workers through ``SsdChunk``: one forward and
    one backward call of the plain versions, over the folded batch, and
    each worker's gradient bitwise its own ``grad``."""
    x, dt, a_log, bm, cm, _ = checks.ssd_inputs(case, "cpu")
    gen = torch.Generator().manual_seed(5)
    m = 3
    xs = torch.randn((m,) + x.shape, generator=gen)
    dts = torch.rand((m,) + dt.shape, generator=gen) * 0.45 + 0.05
    bs = 0.3 * torch.randn((m,) + bm.shape, generator=gen)
    cs = 0.3 * torch.randn((m,) + cm.shape, generator=gen)

    def f(a_log, x, dt, b, c):
        y, h = ops.ssd_chunked(x, dt, a_log, b, c, case.chunk)
        return (y * torch.sin(y)).sum() + h.square().sum()

    calls = []

    def counted(fn):
        return lambda *a: calls.append(a[0].shape[0]) or fn(*a)

    monkeypatch.setattr(ops, "ssd_chunk_ref", counted(ssd_chunk_ref))
    monkeypatch.setattr(ops, "ssd_chunk_bwd_ref", counted(ssd_chunk_bwd_ref))
    grad = torch.func.grad(f, argnums=(0, 1, 2, 3, 4))
    batched = torch.func.vmap(grad, in_dims=(None, 0, 0, 0, 0))(a_log, xs, dts, bs, cs)
    assert calls == [m * case.b, m * case.b]
    for w in range(m):
        for a, b in zip(batched, grad(a_log, xs[w], dts[w], bs[w], cs[w])):
            assert torch.equal(a[w], b)


def test_ssd_chunk_backward_matches_autograd_and_jax(one_thread, monkeypatch):
    """The plain backward against float64 autograd and the chunked form's
    VJP against the JAX oracle's, at a G > 1 shape and at one with h0;
    ``vmap(grad)`` through ``SsdChunk``; then the error budget behind
    ``checks.SSD_BWD_TOL`` at full width, with full-width inputs and with
    the steepest decay of ``checks.ssd_cases()``."""
    for case in SHAPES:
        _check_plain_backward(case)
        _check_vjp_against_jax(case)
    _check_vmap_grad(SHAPES[0], monkeypatch)
    for kind in ("model", "extreme"):
        case = checks.SsdCase("budget", 1, 512, 4, 64, 1, 128, 256, kind)
        ins = checks.ssd_bwd_inputs(case, "cpu")
        assert float(torch.cumsum(ins[2], dim=2).min()) < -1000
        g32 = ssd_chunk_bwd_ref(*ins)
        g64 = ssd_chunk_bwd_ref(*[t.double() for t in ins])
        for name, a, b in zip(checks.SSD_GRADS, g32, g64):
            rel = float((a.double() - b).abs().max()) / max(1.0, float(b.abs().max()))
            assert rel < checks.SSD_BWD_TOL / 5, (kind, name, rel)


def _check_bwd_grid(bnc, q, h, g, n, hs):
    """Every block of work of the backward's launches covered exactly once
    with ``hs`` heads per block, and the scratch's shapes."""
    nt, nq = -(-q // 64), -(-n // bwd.NQ)
    slices = -(-(h // g) // hs)
    blocks = bwd.blocks_per_launch(bnc, q, h, g, n, hs)
    walk = bwd.walk_work(bnc, q, h, g, hs)
    assert len(walk) == blocks["walk"] == blocks["prep"] - bnc * g * nt * (nt + 1) // 2
    # long walks first; a block's heads are one group's, at most hs of them
    assert [jt for jt, _, _ in walk] == sorted(jt for jt, _, _ in walk)
    assert all(0 < len(hd) <= hs and len({x // (h // g) for x in hd}) == 1 for _, _, hd in walk)
    seen = [(bz, x, jt) for jt, bz, hd in walk for x in hd]
    assert sorted(seen) == [(bz, x, jt) for bz in range(bnc) for x in range(h)
                            for jt in range(nt)]
    group = bwd.group_work(bnc, q, h, g, n)
    assert len(group) == blocks["group"]
    tiles = [w for w in group if w[0] != "dda"]
    assert sorted(tiles) == sorted((role, bz, gg, t, 32 * k) for role in ("db", "dc")
                                   for bz in range(bnc) for gg in range(g)
                                   for t in range(nt) for k in range(nq))
    # the longest sums of tiles first: nt - t for dB's row tile t, t + 1 for dC's
    span = [nt - w[3] if w[0] == "db" else w[3] + 1 for w in tiles]
    assert span == sorted(span, reverse=True)
    dda = [x for w in group if w[0] == "dda" for x in w[1]]
    assert dda == [(bz, x) for bz in range(bnc) for x in range(h)]
    assert all(len(w[1]) <= 8 for w in group if w[0] == "dda")
    reduced = bnc * g * (nt * (nt + 1) // 2 * 64 * 64 // 4 + 64 * nt * n)
    assert 0 <= blocks["reduce"] * bwd.THREADS - reduced < bwd.THREADS
    assert bwd.scratch_shapes(bnc, q, h, g, n, hs) == {
        "cbt": (bnc * g, nt * (nt + 1) // 2, 64, 64),
        "dcbp": (bnc * g * slices, nt * (nt + 1) // 2, 64, 64),
        "dbsp": (bnc * g * slices, 64 * nt, n), "rs": (bnc * h, 64 * nt),
        "rowp": (bnc * h, nt, 64 * nt), "aux": (bnc * h, 2, 64 * nt)}


def test_ssd_backward_kernel_grid_covers_the_work_once(one_thread):
    """The backward kernel's grid and head slice (``ssd_scan_bwd.py``): at
    the training shape (mamba2_370m, 4 workers x 1 x 512 tokens: B*NC = 8,
    Q = 256, H = 32, G = 1, N = 128) on 132 SMs, 3 heads per block and a
    walk of 352 blocks, two per SM, and 29 MB of scratch; at every case of
    ``checks.ssd_cases()`` and ``checks.ssd_tp_cases()`` (16 heads a
    rank: 1 head per block) and every head slice up to 8 (slices that do not
    divide H/G = 20 at H = 40, G = 2; Q = 1 and Q = 248) each (b*z, head,
    column tile) in exactly one walk block, each dC / dB tile in one group
    block, each (b*z, head) in one dda warp."""
    assert bwd.head_slice(8, 256, 32, 1, 128, 132) == 3
    assert bwd.blocks_per_launch(8, 256, 32, 1, 128, 3) == {
        "prep": 352 + 80, "walk": 352, "reduce": 320 + 1024, "group": 256 + 32}
    shapes = bwd.scratch_shapes(8, 256, 32, 1, 128, 3)
    assert 4 * sum(int(np.prod(s)) for s in shapes.values()) == 29_097_984
    assert bwd.head_slice(1, 64, 40, 2, 32, 132) == 1   # too few blocks for more
    for case in checks.ssd_tp_cases():
        assert bwd.head_slice(case.b * (case.s // case.chunk), case.chunk, case.h, case.g,
                              case.n, 132) == 1, case.name
    for case in checks.ssd_cases() + checks.ssd_tp_cases():
        bnc = case.b * (case.s // case.chunk)
        for hs in range(1, min(bwd.MAX_HEADS_PER_BLOCK, case.h // case.g) + 1):
            _check_bwd_grid(bnc, case.chunk, case.h, case.g, case.n, hs)
    for hs in (1, 3, 8):
        _check_bwd_grid(8, 256, 32, 1, 128, hs)


def test_reduced_mamba2_trains_like_jax(one_thread):
    """Reduced mamba2_370m (2 SSD layers, chunk 32, fp32): the loss and every
    gradient leaf against ``jax.grad`` of the JAX loss, params carried by
    ``params_from_numpy``; the per-worker gradients of the SASG step
    (``per_worker_grad_fn``) over 3 workers, shared and stacked params, each
    worker's equal to its own; two SASG steps against the JAX train step
    (2 workers on a 2x1 mesh); then 2 steps through the training launcher
    on the CPU, and its refusal of a sequence that is not whole chunks."""
    jcfg, tcfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    assert tcfg.attn_pattern == ("ssd",) and tcfg.n_layers == 2 and tcfg.ssm.chunk_size == 32
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    tmodel = build(tcfg)

    toks = np.random.default_rng(11).integers(0, jcfg.vocab_size, (3, 2, 64)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=2)}
    lj, gj = jax.jit(jax.value_and_grad(jmodel.loss_fn))(
        jparams, jax.tree.map(lambda v: jnp.asarray(v[0]), batch))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    gt, lt = torch.func.grad_and_value(tmodel.loss_fn)(
        tparams, {k: v[0] for k, v in tbatch.items()})
    assert np.isfinite(float(lt))
    np.testing.assert_allclose(float(lt), float(lj), rtol=TOL)
    jleaves = jax.tree.leaves(gj)
    assert len(jleaves) == len(tree_leaves(gt))
    for a, b in zip(jleaves, tree_leaves(gt)):
        _close(b, a)

    grad_fn = per_worker_grad_fn(tmodel.loss_fn)
    want = [gt] + [torch.func.grad(tmodel.loss_fn)(tparams, {k: v[w] for k, v in tbatch.items()})
                   for w in (1, 2)]
    stacked = tree_map(lambda x: torch.stack([x, x, x]), tparams)
    for params, is_stacked in ((tparams, False), (stacked, True)):
        loss, grads = grad_fn(params, tbatch, is_stacked)
        assert loss.shape == (3,) and float(loss[0]) == pytest.approx(float(lt), rel=1e-6)
        for w in range(3):
            for a, b in zip(tree_leaves(want[w]), tree_leaves(grads)):
                _close(b[w], a.numpy(), 1e-6)

    m, steps, lr = 2, 2, 0.05
    mesh = compat.make_mesh((m, 1), ("data", "model"), devices=jax.devices()[:m])
    strategy = choose_strategy(mesh, sasg_enabled=True)
    jbuilt = jax_build_train_step(jmodel, JAX_PRESETS["sasg"](), mesh, strategy,
                                  jax_constant(lr))
    tbuilt = build_train_step(tmodel, PRESETS["sasg"](), m, constant(lr), device="cpu")
    assert (tbuilt.bits_paper, tbuilt.bits_wire) == (jbuilt.bits_paper, jbuilt.bits_wire)
    jstate = jbuilt.init(jax.random.PRNGKey(0))
    tstate = tbuilt.init(params=params_from_numpy(jax.tree.map(np.asarray, jstate.params)))
    stream = indexed_token_stream(jcfg.vocab_size, 2 * m, 32, seed=0)
    for step in range(steps):
        b = stream.batch_at(step)
        jstate, jm = jbuilt.jit_step(jstate, b)
        tstate, tm = tbuilt.step(tstate, b)
        assert float(tm["num_sent"]) == float(jm["num_sent"]), step
        for key in ("rounds_total", "bits_paper_total", "bits_wire_total"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_array_equal(tstate.wstate.tau.numpy(), np.asarray(jstate.wstate.tau))

    from repro_torch.launch import train as launch

    lines = []
    trainer, _ = launch.train(["--arch", ARCH, "--reduced", "--algo", "sasg", "--workers", "2",
                               "--global-batch", "4", "--seq-len", "32", "--steps", "2",
                               "--lr", "1.0", "--device", "cpu"], log_fn=lines.append)
    assert f"arch={ARCH}" in lines[0]
    assert len(trainer.history) == 2
    assert all(np.isfinite(r["loss"]) for r in trainer.history)
    with pytest.raises(ValueError, match="--seq-len 48 is not a multiple of .* chunk size 32"):
        launch.train(["--arch", ARCH, "--reduced", "--seq-len", "48", "--device", "cpu"])
