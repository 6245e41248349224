"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: each test skips (inside a fixture) without a CUDA device.
On a machine with a card, from the root of the checkout:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py sets up JAX for the JAX package's
tests, and the port's card needs no JAX.) The cases are those of
``chip_smoke.py``'s kernel phase (``repro_torch.kernels.checks``): every
block geometry of the main path at 10 workers, and the edges, one view at
a time and as groups of views in one launch (whole cnn_cifar and fc_mnist
encodes, NaN rows sharing a warp, ragged rows, more than one table of
segments, misaligned views, lr != 1); for the SSD
chunk kernel and its backward the JAX package's test shapes, the serving
slice's shape, and the edges (G > 1, Q not a power of two, overflowing
decay, h0). Then
training on the card: each compressor's seeded runs bitwise repeatable,
a checkpoint of a ``cuda`` TrainState restored bitwise, and an elastic
run (resizes, a crash replayed across one) with its top-k launches and
segments exact and an injected ``KernelLaunchError`` ending it. Then the
dense-attention LMs: each reduced config's forward and a prefill + decode
chain with a frozen row, and the engine on reduced llama3_8b, on the card
against the CPU. Then the paged KV cache (a paged attention call with a
frozen row and -1 table entries, the paged engine bitwise the dense one
on the card, a small pool, the launcher without ``--dense``, mamba2's
``paged=True`` refused) and the MoE LMs (the router's picks, ties kept
on the lower expert id, logits and the engines against the CPU). Then
reduced recurrentgemma_9b (forward, chain, engine) and seamless_m4t_v2
(generation) against the CPU, recurrentgemma trained through the top-k
kernel, and reduced mamba2_370m's gradients through the SSD kernels
against the oracle's.
"""
import os

import pytest
import torch

from repro_torch.kernels import checks
from repro_torch.kernels.block_topk import block_topk
from repro_torch.kernels.block_topk import ops as bt_ops
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
from repro_torch.kernels.topk_ef import ops, topk_ef

pytestmark = pytest.mark.gpu

# deterministic cuBLAS for the training tests, set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

CASES = checks.cases(10)
GROUPS = checks.group_cases(10)
_GROUP_IDS = [c.name.replace(" ", "-") for c in GROUPS]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("case", CASES, ids=[c.name.replace(" ", "-") for c in CASES])
def test_topk_ef_kernel_bitwise(cuda, case):
    assert checks.check_topk_ef(case, cuda) == 0.0


@pytest.mark.parametrize("case", CASES, ids=[c.name.replace(" ", "-") for c in CASES])
def test_block_topk_kernel_bitwise(cuda, case):
    assert checks.check_block_topk(case, cuda) == 0.0


@pytest.mark.parametrize("case", GROUPS, ids=_GROUP_IDS)
def test_topk_ef_group_bitwise(cuda, case):
    assert checks.check_topk_ef_group(case, cuda) == 0.0


@pytest.mark.parametrize("case", GROUPS, ids=_GROUP_IDS)
def test_block_topk_group_bitwise(cuda, case):
    assert checks.check_block_topk_group(case, cuda) == 0.0


def test_grouped_entry_on_the_card_matches_the_cpu_plain_version(cuda):
    """``blocked_topk_ef_group`` launches once for a mixed tree of blocked
    views (counting one segment per view) and gives the CPU plain version's
    bits, view by view."""
    gen = torch.Generator().manual_seed(1)
    shapes = [(10, 3, 3, 64, 1, 128), (10, 4, 1, 10), (10, 2, 5, 64), (10, 7, 256)]
    kbs = [2, 1, 1, 3]
    gs = [torch.randn(s, generator=gen) for s in shapes]
    es = [0.1 * torch.randn(s, generator=gen) for s in shapes]
    before = (topk_ef.LAUNCHES.count, topk_ef.SEGMENTS.count)
    got = ops.blocked_topk_ef_group([g.to(cuda) for g in gs], [e.to(cuda) for e in es], kbs)
    assert (topk_ef.LAUNCHES.count, topk_ef.SEGMENTS.count) == (before[0] + 1,
                                                                before[1] + len(shapes))
    want = ops.blocked_topk_ef_group(gs, es, kbs)
    for outs_k, outs_p in zip(got, want):
        for a, b in zip(outs_k, outs_p):
            assert a.shape == b.shape
            assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


def test_entries_on_the_card_match_the_cpu_plain_version(cuda):
    """The public entries launch the kernel for CUDA tensors (one launch per
    call, counted) and give the CPU plain version's bits; so does the
    pipeline ring's blocked top-k encode."""
    gen = torch.Generator().manual_seed(0)
    g = torch.randn(10, 3, 3, 64, 1, 128, generator=gen)
    e = 0.1 * torch.randn(g.shape, generator=gen)
    before = topk_ef.LAUNCHES.count
    got = ops.blocked_topk_ef(g.to(cuda), e.to(cuda), 2)
    assert topk_ef.LAUNCHES.count == before + 1
    want = ops.blocked_topk_ef(g, e, 2)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
    x = torch.randn(3, 1000, generator=gen)
    pc = ops.topk_ef(x.to(cuda), torch.zeros_like(x).to(cuda), 0.05, 50, 128)[0]
    pp = ops.topk_ef(x, torch.zeros_like(x), 0.05, 50, 128)[0]
    assert torch.equal(pc.indices.cpu(), pp.indices)
    assert torch.equal(pc.values.cpu(), pp.values)
    bc = bt_ops.block_topk(x.to(cuda), 50, 128)
    bp = bt_ops.block_topk(x, 50, 128)
    assert torch.equal(bc.indices.cpu(), bp.indices) and torch.equal(bc.values.cpu(), bp.values)
    # the pipeline ring's encode (ActivationLayout, k > 0): worker-stacked
    # activations padded to whole blocks, one launch per encode; rounded
    # values put ties and zeros inside blocks
    from repro_torch.comm.transport import ActivationLayout

    a = torch.round(torch.randn(10, 5, 32, 32, 7, generator=gen), decimals=1)
    a[0, 0] = 0.0
    for lay in (ActivationLayout(k_ratio=0.05), ActivationLayout("bfloat16", 0.25, 16)):
        before = block_topk.LAUNCHES.count
        got = lay.encode(a.to(cuda), batch_dims=1)
        assert block_topk.LAUNCHES.count == before + 1
        for x, y in zip(got, lay.encode(a, batch_dims=1)):
            assert x.dtype == y.dtype and torch.equal(x.cpu(), y)
        assert torch.equal(lay.decode(got, a.shape, torch.float32, 1).cpu(),
                           lay.decode(lay.encode(a, batch_dims=1), a.shape, torch.float32, 1))


def test_wrappers_reject_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(4, 64, device=cuda)
    with pytest.raises(ValueError):
        topk_ef.topk_ef_cuda(x, x, 1.0, 65)            # kb > bc
    with pytest.raises(ValueError):
        topk_ef.topk_ef_cuda(torch.zeros(2, 4096, device=cuda),
                             torch.zeros(2, 4096, device=cuda), 1.0, 1)  # bc > 2048
    with pytest.raises(TypeError):
        topk_ef.topk_ef_cuda(x.double(), x.double(), 1.0, 1)
    with pytest.raises(ValueError):
        topk_ef.topk_ef_cuda(x.t(), x.t(), 1.0, 1)     # not contiguous
    y = torch.zeros(3, 10, device=cuda)
    with pytest.raises(ValueError):                    # a kb per view
        topk_ef.topk_ef_group([x, y], [x, y], 1.0, [1])
    with pytest.raises(ValueError):                    # grad and err differ
        topk_ef.topk_ef_group([x, y], [x, x], 1.0, [1, 1])
    with pytest.raises(ValueError):                    # one view on the CPU
        topk_ef.topk_ef_group([x, y.cpu()], [x, y.cpu()], 1.0, [1, 1])
    with pytest.raises(ValueError):                    # kb > bc in the second view
        block_topk.block_topk_group([x, y], [1, 11])
    with pytest.raises(ValueError):                    # views on two devices
        ops.blocked_topk_ef_group([x, y.cpu()], [x, y.cpu()], [1, 1])
    _ssd_wrappers_reject_what_the_kernels_do_not_take(cuda)


# ---------------------------------------------------------------------------
# SSD chunk kernel (tolerance: checks.SSD_TOL of the plain version's scale)
# ---------------------------------------------------------------------------

SSD_CASES = checks.ssd_cases()
_SSD_IDS = [c.name.replace(" ", "-") for c in SSD_CASES]


@pytest.mark.parametrize("case", SSD_CASES, ids=_SSD_IDS)
def test_ssd_chunk_kernel_matches_plain(cuda, case):
    checks.check_ssd_chunk(case, cuda)   # raises beyond checks.SSD_TOL
    # the backward: beyond checks.SSD_BWD_TOL, or two launches differing, raise
    before = ssd_scan_bwd.LAUNCHES.count
    checks.check_ssd_chunk_bwd(case, cuda)
    assert ssd_scan_bwd.LAUNCHES.count == before + 2 + len(checks.ssd_bwd_head_slices(case))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("case", SSD_CASES, ids=_SSD_IDS)
def test_ssd_chunked_on_the_card_matches_the_oracle(cuda, case, with_h0):
    before = ssd_scan.LAUNCHES.count
    checks.check_ssd_chunked(case, cuda, with_h0=with_h0)
    assert ssd_scan.LAUNCHES.count == before + 1


def _ssd_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """The SSD chunk kernel's and its backward's wrappers (one item with
    the top-k wrappers' checks: the suite's item count is budgeted)."""
    case = SSD_CASES[0]
    x, dt, da, b, c = checks.ssd_chunk_inputs(case, cuda)
    with pytest.raises(TypeError):
        ssd_scan.ssd_chunk_cuda(x.double(), dt, da, b, c)
    with pytest.raises(TypeError):
        ssd_scan.ssd_chunk_cuda(x, dt.half(), da, b, c)
    with pytest.raises(ValueError):   # not contiguous
        ssd_scan.ssd_chunk_cuda(x.transpose(3, 4).contiguous().transpose(3, 4), dt, da, b, c)
    with pytest.raises(ValueError):   # not contiguous
        ssd_scan.ssd_chunk_cuda(x, dt, da, b.transpose(2, 4).contiguous().transpose(2, 4), c)
    with pytest.raises(ValueError):   # on the CPU
        ssd_scan.ssd_chunk_cuda(x.cpu(), dt, da, b, c)
    with pytest.raises(ValueError):   # heads do not split into the groups
        ssd_scan.ssd_chunk_cuda(x[:, :, :, :3].contiguous(), dt[..., :3].contiguous(),
                                da[..., :3].contiguous(), torch.cat([b, b], 3),
                                torch.cat([c, c], 3))
    big = torch.zeros((1, 1, 4, 1, 65), device=cuda)  # P > 64
    small = torch.zeros((1, 1, 4, 1), device=cuda)
    bn = torch.zeros((1, 1, 4, 1, 8), device=cuda)
    with pytest.raises(ValueError):
        ssd_scan.ssd_chunk_cuda(big, small, small, bn, bn)
    for hs in (0, 5, 7):   # heads per block outside [1, min(6, H/G)] (H/G = 4 here)
        with pytest.raises(ValueError):
            ssd_scan.ssd_chunk_cuda(x, dt, da, b, c, heads_per_block=hs)
    before = ssd_scan.LAUNCHES.count
    y, st = ssd_scan.ssd_chunk_cuda(x, dt, da, b, c)
    assert ssd_scan.LAUNCHES.count == before + 1 and torch.isfinite(y).all()
    # the backward's wrapper: the forward's operands and the cotangents
    gy, gst = torch.ones_like(y), torch.ones_like(st)
    with pytest.raises(TypeError):
        ssd_scan_bwd.ssd_chunk_bwd_cuda(x, dt, da, b, c, gy.double(), gst)
    with pytest.raises(ValueError):   # on the CPU
        ssd_scan_bwd.ssd_chunk_bwd_cuda(x, dt, da, b, c, gy, gst.cpu())
    with pytest.raises(ValueError):   # gst's shape
        ssd_scan_bwd.ssd_chunk_bwd_cuda(x, dt, da, b, c, gy, gst[..., :-1].contiguous())
    with pytest.raises(ValueError):   # not contiguous
        ssd_scan_bwd.ssd_chunk_bwd_cuda(x, dt, da, b, c,
                                        gy.transpose(3, 4).contiguous().transpose(3, 4), gst)
    for hs in (0, 5):   # heads per block outside [1, min(8, H/G)] (H/G = 4 here)
        with pytest.raises(ValueError):
            ssd_scan_bwd.ssd_chunk_bwd_cuda(x, dt, da, b, c, gy, gst, heads_per_block=hs)
    before = ssd_scan_bwd.LAUNCHES.count
    grads = ssd_scan_bwd.ssd_chunk_bwd_cuda(x, dt, da, b, c, gy, gst)
    assert ssd_scan_bwd.LAUNCHES.count == before + 1
    assert all(torch.isfinite(t).all() for t in grads)


# ---------------------------------------------------------------------------
# training on the card: seeded compressors, checkpoints of a cuda TrainState
# ---------------------------------------------------------------------------

@pytest.fixture
def deterministic():
    """cuDNN's and scatter's deterministic kernels for the test, as training
    on the card runs when it is held bitwise."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def _gpu_built(cuda, compressor, optimizer=None):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.sasg import PRESETS
    from repro_torch.models import build
    from repro_torch.optim import constant
    from repro_torch.train import build_train_step

    scfg = PRESETS["sasg"]()
    scfg = dataclasses.replace(scfg, fold_lr=optimizer is None,
                               compressor=dataclasses.replace(scfg.compressor, name=compressor))
    return build_train_step(build(get_config("fc_mnist")), scfg, 4, constant(0.1),
                            device=cuda, optimizer=optimizer)


def _gpu_run(built, steps=4, seed=0):
    from repro_torch.data import indexed_classification_stream, synthetic_classification

    xs, ys = synthetic_classification(64, 10, (28, 28, 1), seed=0)
    stream = indexed_classification_stream(xs, ys, 8, seed=0)
    state = built.init(seed=seed)
    for step in range(steps):
        state, _ = built.step(state, stream.batch_at(step))
    return state


def _leaves_equal(a, b):
    from repro_torch.core.types import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)
        for x, y in zip(la, lb))


@pytest.mark.parametrize("compressor", ["topk_ef", "randk", "qsgd", "signsgd_ef", "terngrad"])
def test_seeded_training_is_deterministic_on_the_card(cuda, deterministic, compressor):
    """Two runs from one seed are bitwise equal; the randomized compressors
    draw other numbers under another seed. A third run under the wire log
    is bitwise the two, and each step's logged exchange bytes are the
    counters' (n-1) x bits_wire / 8 for the sparse payloads. The
    quantizers are held to their known gap: they move their decoded
    payload, 32 bits a coordinate, more than the counters bill, until the
    packed quantizer wire (ROADMAP queue 1, item 12b) lands."""
    from repro_torch.analysis import comm_audit
    from repro_torch.comm import collectives
    from repro_torch.core.types import tree_size

    built = _gpu_built(cuda, compressor)
    a, b = _gpu_run(built, seed=1), _gpu_run(built, seed=1)
    assert _leaves_equal(a, b)
    with collectives.wire_log() as rows:
        c = _gpu_run(built, seed=1)
    assert _leaves_equal(a, c)
    t = built.exchange.transport
    billed = comm_audit.expected_exchange_bytes(built)
    decoded = (t.span.size - 1) * 4 * tree_size(a.params)
    steps = 4
    exchange = [r for r in rows if r["op"] == "exchange"]
    assert exchange and len(exchange) % steps == 0
    per = len(exchange) // steps
    for i in range(steps):
        logged = sum(r["wire_bytes"] for r in exchange[i * per:(i + 1) * per])
        if t.kind == "sparse":
            assert logged == billed
        else:   # the quantizer wire gap of ROADMAP item 12b
            assert logged == decoded and logged - billed > 0, (compressor, logged, billed)
    if compressor in ("randk", "qsgd", "terngrad"):
        assert not _leaves_equal(a.params, _gpu_run(built, seed=2).params)


def test_checkpoint_round_trip_of_a_cuda_train_state(cuda, deterministic, tmp_path):
    from repro_torch.optim import momentum
    from repro_torch.train import checkpoint as ckpt

    built = _gpu_built(cuda, "topk_ef", optimizer=momentum(0.1, 0.9))
    state = _gpu_run(built, steps=3)
    ckpt.save(state, str(tmp_path), 3, blocking=False).join()
    assert ckpt.verify(str(tmp_path), 3)
    got = ckpt.restore(built.init(seed=5), str(tmp_path), 3)
    assert _leaves_equal(got, state)
    assert got.params["fc1"]["w"].is_cuda and got.seed.device.type == "cpu"
    _elastic_on_the_card(cuda, tmp_path)


def _elastic_on_the_card(cuda, tmp_path):
    """An elastic run on the card (fc_mnist, 4 -> 2 at step 2, back to 4 at
    5, a crash at 5 whose restore point, step 4, was saved at 2 workers):
    one grouped top-k launch per encode, one segment per leaf, at both
    counts, replays and worker-state starts included; a KernelLaunchError
    from the step ends an elastic run, with no recovery."""
    from repro_torch.configs import get_config
    from repro_torch.core.sasg import PRESETS
    from repro_torch.core.types import tree_leaves
    from repro_torch.data import indexed_classification_stream, synthetic_classification
    from repro_torch.kernels.build import KernelLaunchError
    from repro_torch.models import build
    from repro_torch.optim import constant
    from repro_torch.train import TrainerConfig
    from repro_torch.train.elastic import ElasticTrainer, WorkerMembership
    from repro_torch.train.faults import FaultPlan

    mem = WorkerMembership(build(get_config("fc_mnist")), PRESETS["sasg"](), constant(0.1),
                           device=cuda)
    xs, ys = synthetic_classification(64, 10, (28, 28, 1), seed=0)

    def trainer(built, name, plan):
        tc = TrainerConfig(total_steps=8, ckpt_dir=str(tmp_path / name), ckpt_every=2,
                           log_every=100)
        return ElasticTrainer(built, indexed_classification_stream(xs, ys, 8, seed=0), tc,
                              membership=mem, plan=plan, log_fn=lambda m: None)

    before = (topk_ef.LAUNCHES.count, topk_ef.SEGMENTS.count)
    tr = trainer(mem.build(4), "elastic", FaultPlan().worker_drop(2, to=2)
                 .worker_join(5, to=4).crash(5))
    state = tr.run(seed=0)
    kinds = [e["kind"] for e in tr.events]
    assert kinds == ["resize", "resize", "crash", "recovery", "resize"]
    assert tr.events[3]["restored_step"] == 4 and tr.built.num_workers == 4
    encodes = len(tr.history) + 1 + kinds.count("resize") + kinds.count("recovery")
    n_leaves = len(tree_leaves(state.params))
    assert (topk_ef.LAUNCHES.count - before[0], topk_ef.SEGMENTS.count - before[1]) == (
        encodes, n_leaves * encodes)

    b4 = mem.build(4)

    def step(state, batch, force_skip=None):
        if int(state.gstate.step) == 1:
            raise KernelLaunchError("injected kernel fault")
        return b4.step(state, batch, force_skip)

    tr = trainer(b4._replace(step=step), "kfault", FaultPlan().crash(3))
    with pytest.raises(KernelLaunchError, match="injected"):
        tr.run(seed=0)
    assert tr.events == [] and len(tr.history) == 1


# ---------------------------------------------------------------------------
# the paper's simulator and the worker group on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["sparse", "sasg"])
def test_simulator_kernel_run_equals_reference_run(cuda, deterministic, algo):
    """Table 2's simulator on fc_mnist, top-k through the kernel and through
    the reference's per-shard selection, in lockstep: sends, rounds, bits
    and params bitwise every step, one kernel launch per encode."""
    import numpy as np

    from repro_torch.benchmarks import table2_rounds_bits as t2
    from repro_torch.benchmarks.simulator import make_simulator
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_classification
    from repro_torch.models import build

    model = build(get_config("fc_mnist"))
    sims = {impl: make_simulator(t2.algo_config(algo, impl), model.loss_fn, 10, device=cuda)
            for impl in ("kernel", "sharded")}
    params = model.init(torch.Generator(device=cuda).manual_seed(0), device=cuda)
    before = topk_ef.LAUNCHES.count
    states = {impl: sim[0](params) for impl, sim in sims.items()}
    xs, ys = synthetic_classification(5120, 10, (28, 28, 1), seed=0)
    rng = np.random.default_rng(0)
    for t in range(8):
        idx = rng.integers(0, 4096, size=(10, 10))
        sent = {}
        for impl, sim in sims.items():
            states[impl], sent[impl] = sim[1](states[impl], {"x": xs[idx], "labels": ys[idx]},
                                              0.1)
        k, r = states["kernel"], states["sharded"]
        assert sent["kernel"] == sent["sharded"]
        assert (k.rounds, k.bits_paper) == (r.rounds, r.bits_paper)
        assert _leaves_equal(k.params, r.params) and torch.equal(k.wstate.tau, r.wstate.tau)
    assert topk_ef.LAUNCHES.count - before == 8 + 1   # 8 steps + the zero payload
    if algo == "sasg":
        _stacked_mesh_kernel_equals_reference(cuda)


def _stacked_mesh_kernel_equals_reference(cuda):
    """A stacked (2, 2) mesh (TP block geometry, views cut to the model
    axis), SASG on the d_model=16 CNN: 3 steps through the kernel equal
    ``topk_impl="reference"`` bitwise, one grouped launch per encode."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.sasg import PRESETS
    from repro_torch.data import indexed_classification_stream, synthetic_classification
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build
    from repro_torch.optim import constant
    from repro_torch.train import build_train_step

    cfg = dataclasses.replace(get_config("cnn_cifar"), d_model=16)
    xs, ys = synthetic_classification(64, 10, (32, 32, 3), seed=0)
    stream = indexed_classification_stream(xs, ys, 8, seed=0)
    states = {}
    for impl in ("kernel", "reference"):
        scfg = PRESETS["sasg"]()
        scfg = dataclasses.replace(scfg, compressor=dataclasses.replace(
            scfg.compressor, topk_impl=impl))
        built = build_train_step(build(cfg), scfg, None, constant(0.05), device=cuda,
                                 mesh=make_test_mesh((2, 2), ("data", "model"), device_type="cuda"))
        before = topk_ef.LAUNCHES.count
        state = built.init(seed=2)
        for step in range(3):
            state, _ = built.step(state, stream.batch_at(step))
        assert topk_ef.LAUNCHES.count - before == (4 if impl == "kernel" else 0)
        states[impl] = state
    assert _leaves_equal(states["kernel"], states["reference"])


def _nccl_exchange_rank(group):
    """A world-size-1 NCCL group's gathered exchange of 4 workers' payloads
    on the card, for the top-k and dense transports."""
    from repro_torch.comm.transport import build_transport

    out = {}
    for name, cfg, (params, payload) in _exchange_payloads(group.device):
        t = build_transport(cfg, 4, group)
        out[name] = {k: v.cpu().numpy() for k, v in t.densify(t.exchange(payload), params).items()}
    return out


def _exchange_payloads(device):
    from repro_torch.comm.transport import build_transport
    from repro_torch.core.compressors import CompressorConfig

    cases = {
        "block": CompressorConfig(name="topk_ef", k_ratio=0.1, block_size=16),
        "flat": CompressorConfig(name="topk_ef", k_ratio=0.1, layout="flat",
                                 topk_impl="exact"),
        "dense": CompressorConfig(name="identity"),
    }
    for name, cfg in cases.items():
        gen = torch.Generator(device=device).manual_seed(7)
        params = {"w": torch.zeros(12, 20, device=device), "b": torch.zeros(33, device=device)}
        g = {k: torch.randn((4,) + tuple(p.shape), generator=gen, device=device)
             for k, p in params.items()}
        t = build_transport(cfg, 4)
        payload, _ = t.encode(t.init_state(g), g)
        yield name, cfg, (params, payload)


def test_gathered_exchange_through_a_world_size_1_nccl_group(cuda, deterministic):
    from repro_torch.comm import process_group
    from repro_torch.comm.transport import build_transport

    (got,) = process_group.spawn(_nccl_exchange_rank, 1, "nccl", "cuda",
                                 join_timeout_s=300.0)
    for name, cfg, (params, payload) in _exchange_payloads(cuda):
        t = build_transport(cfg, 4)
        want = t.densify(t.exchange(payload), params)
        for k, v in want.items():
            assert (got[name][k].view("int32") == v.cpu().numpy().view("int32")).all()
    with pytest.raises(ValueError, match="refuses two ranks"):
        process_group.spawn(_nccl_exchange_rank, torch.cuda.device_count() + 1, "nccl",
                            "cuda")


# ---------------------------------------------------------------------------
# dense-attention LMs on the card: reduced configs against the CPU
# ---------------------------------------------------------------------------

DENSE_ARCHS = ["llama3_8b", "starcoder2_3b", "chatglm3_6b", "granite_20b", "internvl2_2b"]
LM_TOL = 1e-5   # of max|logits|: fp32, TF32 off, sums over K <= 256 in other orders


def _reduced_lm(arch):
    from repro_torch.configs import get_config
    from repro_torch.models import build

    cfg = get_config(arch).reduced()
    model = build(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0))


def _to(tree, device):
    from repro_torch.core.types import tree_map

    return tree_map(lambda x: x.to(device), tree)


def _lm_close(got, want):
    err = float((got.cpu().float() - want.float()).abs().max())
    assert err <= LM_TOL * float(want.float().abs().max()), err


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_reduced_lm_forward_and_chain_on_the_card_match_the_cpu(cuda, arch):
    """The full forward (the VLM with an 8-embedding prefix), and a prefill
    + decode chain with one row frozen at its second step, on the card
    against the CPU; the frozen row's cache rows stay as they were."""
    from repro_torch.core.types import tree_leaves
    from repro_torch.models import lm as LM
    from repro_torch.train.step import resolve_device

    resolve_device(cuda)
    cfg, model, params = _reduced_lm(arch)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen, dtype=torch.int32)
    kw = {}
    if cfg.frontend == "patch_embed":
        kw["prefix_embeds"] = torch.randn((2, 8, cfg.d_model), generator=gen)
    want, _ = LM.lm_forward(params, cfg, toks, **kw)
    got, _ = LM.lm_forward(_to(params, cuda), cfg, toks.to(cuda), **_to(kw, cuda))
    _lm_close(got, want)

    def chain(p, dev):
        cache = model.init_cache(2, 16, dev)
        out, cache = model.decode_step(p, cache, toks[:, :8].to(dev),
                                       torch.zeros(2, dtype=torch.int32, device=dev))
        outs, before = [out], cache
        for t in range(8, 12):
            pos = torch.tensor([t, -1 if t == 9 else t], dtype=torch.int32, device=dev)
            if t > 9:
                pos[1] = t - 1
            out, cache = model.decode_step(p, cache, toks[:, t:t + 1].to(dev), pos)
            if t == 9:
                for a, b in zip(tree_leaves(before), tree_leaves(cache)):
                    assert torch.equal(a[:, 1], b[:, 1])
            before = cache
            outs.append(out)
        return torch.cat(outs, 1)

    _lm_close(chain(_to(params, cuda), cuda), chain(params, "cpu"))
    torch.cuda.synchronize()


def test_reduced_lm_engine_on_the_card_matches_the_cpu(cuda):
    """Reduced llama3_8b through BatchedServer on the dense cache (frozen
    rows while the other slot prefills, a recycled slot): tokens equal and
    every tick's logits within LM_TOL of the CPU engine's. Then the same
    for reduced recurrentgemma_9b (forward, chain, engine) and
    seamless_m4t_v2 (generation), and recurrentgemma trained through the
    top-k kernel, and reduced mamba2_370m's per-worker gradients through
    the SSD kernels against the oracle's (``_reduced_rglru``,
    ``_reduced_encdec``, ``_rglru_trains_with_the_kernel``,
    ``_mamba2_gradients_kernel_vs_oracle``; one item, not four: see
    tests/test_torch_rglru.py on the suite's item count)."""
    import numpy as np

    from repro_torch.serve import BatchedServer, Request, build_serve
    from repro_torch.train.step import resolve_device

    resolve_device(cuda)
    cfg, model, params = _reduced_lm("llama3_8b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (9, 5, 12)]
    runs = {}
    for dev in ("cpu", cuda):
        srv = BatchedServer(build_serve(model), _to(params, dev), cfg, 2, 32, paged=False)
        records = []
        for uid, p in enumerate(prompts):
            srv.submit(Request(uid, p, 4))
        while srv.tick():
            records.append(srv.last_tick)
        runs[str(dev)] = ({r["uid"]: r["tokens"] for r in srv.completed}, records)
    (tok_h, rec_h), (tok_c, rec_c) = runs["cpu"], runs[str(cuda)]
    assert tok_c == tok_h and len(tok_c) == 3
    assert [r.plan.width for r in rec_c] == [r.plan.width for r in rec_h]
    for rc, rh in zip(rec_c, rec_h):
        act = rh.plan.active
        _lm_close(rc.logits[act], rh.logits[act])
    _reduced_rglru(cuda)
    _reduced_encdec(cuda)
    _rglru_trains_with_the_kernel(cuda)
    _mamba2_gradients_kernel_vs_oracle(cuda)


# ---------------------------------------------------------------------------
# the paged KV cache and the MoE LMs on the card
# ---------------------------------------------------------------------------

def _paged_attention_call(cuda):
    """A paged call (row 0 over blocks 2, 0 and a -1 entry, row 1 frozen)
    on the card against the CPU: outputs within LM_TOL, positions equal,
    the frozen row's and untouched blocks bitwise."""
    from repro_torch.models import layers as L
    from repro_torch.train.step import resolve_device

    resolve_device(cuda)
    cfg, _, _ = _reduced_lm("llama3_8b")
    gen = torch.Generator().manual_seed(2)
    params = L.attention_init(gen, cfg)
    pool = {"pk": torch.randn((4, 4, cfg.n_kv_heads, cfg.head_dim), generator=gen),
            "pv": torch.randn((4, 4, cfg.n_kv_heads, cfg.head_dim), generator=gen),
            "ppos": torch.full((4, 4), -1, dtype=torch.int32)}
    pool["ppos"][2] = torch.arange(4)
    bt = torch.tensor([[2, 0, -1], [1, -1, -1]], dtype=torch.int32)
    pos = torch.stack([torch.arange(4, 7), -(2 ** 30) + torch.arange(3)]).to(torch.int32)
    x = torch.randn((2, 3, cfg.d_model), generator=gen)
    want, nc_h = L.attention_apply(params, cfg, x, pos, cache=pool, block_table=bt)
    got, nc_c = L.attention_apply(_to(params, cuda), cfg, x.to(cuda), pos.to(cuda),
                                  cache=_to(pool, cuda), block_table=bt.to(cuda))
    _lm_close(got[:1], want[:1])
    assert torch.equal(nc_c["ppos"].cpu(), nc_h["ppos"])
    for key in ("pk", "pv"):
        assert torch.equal(nc_c[key].cpu()[[1, 3]], pool[key][[1, 3]])
    torch.cuda.synchronize()


def _paged_engine(cuda):
    """Reduced llama3_8b on the card: the paged engine's every tick's
    logits bitwise the dense engine's, tokens equal the CPU paged engine's;
    a 3-block pool recycles and returns every block."""
    import numpy as np

    from repro_torch.serve import BatchedServer, Request, build_serve
    from repro_torch.train.step import resolve_device

    resolve_device(cuda)
    cfg, model, params = _reduced_lm("llama3_8b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (9, 5, 12, 20)]
    runs = {}
    for dev, kw in (("cpu", dict(paged=True)), (cuda, dict(paged=True)),
                    (cuda, dict(paged=False)), (cuda, dict(paged=True, num_blocks=3))):
        srv = BatchedServer(build_serve(model), _to(params, dev), cfg, 2, 32, block_size=8,
                            **kw)
        records = []
        for uid, p in enumerate(prompts):
            srv.submit(Request(uid, p, 4))
        while srv.tick():
            records.append(srv.last_tick)
        if srv.paged:
            assert srv.allocator.free_blocks == srv.allocator.num_blocks
        runs[(str(dev), kw.get("num_blocks"), kw["paged"])] = (
            {r["uid"]: r["tokens"] for r in srv.completed}, records)
    tok_h, _ = runs[("cpu", None, True)]
    tok_p, rec_p = runs[(str(cuda), None, True)]
    tok_d, rec_d = runs[(str(cuda), None, False)]
    assert tok_p == tok_d == tok_h == runs[(str(cuda), 3, True)][0]
    assert len(rec_p) == len(rec_d)
    for a, b in zip(rec_p, rec_d):
        assert a.plan.active == b.plan.active
        assert torch.equal(a.logits[a.plan.active], b.logits[b.plan.active])
    torch.cuda.synchronize()


def _serve_launcher_pages(cuda):
    from repro_torch.launch import serve as launch
    from repro_torch.serve import BatchedServer, build_serve

    lines = []
    srv, done = launch.serve(["--arch", "llama3_8b", "--reduced", "--requests", "3",
                              "--prompt-len", "10", "--max-new", "3",
                              "--cache-dtype", "bfloat16"], log_fn=lines.append)
    assert srv.paged and len(done) == 3 and "high-water" in lines[-1]
    cfg, model, params = _reduced_lm("mamba2_370m")
    with pytest.raises(ValueError, match="no global-attention layers to page"):
        BatchedServer(build_serve(model), _to(params, cuda), cfg, 2, 64, paged=True)
    torch.cuda.synchronize()


def _reduced_moe(cuda, arch):
    """The router's top-k picks on the card equal the CPU's (ties on the
    lower expert id: a zero router picks experts 0, 1), then the forward
    within LM_TOL, then the engine's tokens (kimi paged)."""
    import numpy as np

    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.serve import BatchedServer, Request, build_serve
    from repro_torch.train.step import resolve_device

    resolve_device(cuda)
    cfg, model, params = _reduced_lm(arch)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    moe = params["unit"][0]["moe"]
    moe0 = {k: v[0] for k, v in moe.items() if k != "shared"}
    picks = [L._top_k(L._router_probs(_to(moe0, d), x.to(d)), cfg.moe.top_k)[1].cpu()
             for d in ("cpu", cuda)]
    assert torch.equal(picks[0], picks[1])
    zero = torch.zeros_like(moe0["router"]).to(cuda)
    _, tie = L._top_k(L._router_probs({"router": zero}, x.to(cuda)), 2)
    assert (tie.cpu() == torch.tensor([0, 1])).all()
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen, dtype=torch.int32)
    want, _ = LM.lm_forward(params, cfg, toks)
    got, _ = LM.lm_forward(_to(params, cuda), cfg, toks.to(cuda))
    _lm_close(got, want)
    tokens = {}
    for dev in ("cpu", cuda):
        srv = BatchedServer(build_serve(model), _to(params, dev), cfg, 2, 32)
        assert srv.paged == (arch == "kimi_k2")
        rng = np.random.default_rng(0)
        for uid in range(3):
            srv.submit(Request(uid, rng.integers(0, cfg.vocab_size, size=5).astype(np.int32), 3))
        done, _ = srv.drain(strict=True)
        tokens[str(dev)] = {r["uid"]: r["tokens"] for r in done}
    assert tokens["cpu"] == tokens[str(cuda)]
    torch.cuda.synchronize()


# two items for the checks above (see tests/test_torch_paged_cache.py on
# the suite's item count under pytest-xdist)

def test_paged_cache_on_the_card(cuda):
    """A paged attention call on the card against the CPU; the paged engine
    bitwise the dense one on the card, tokens the CPU's, a 3-block pool;
    the launcher without ``--dense``; mamba2's ``paged=True`` refused."""
    _paged_attention_call(cuda)
    _paged_engine(cuda)
    _serve_launcher_pages(cuda)


def test_reduced_moe_on_the_card_matches_the_cpu(cuda):
    for arch in ("mixtral_8x7b", "kimi_k2"):
        _reduced_moe(cuda, arch)


# ---------------------------------------------------------------------------
# the RG-LRU hybrid and the encoder-decoder on the card
# ---------------------------------------------------------------------------

def _reduced_rglru(cuda):
    """Reduced recurrentgemma_9b on the card against the CPU: the full
    forward; a prefill + decode chain against the card's own full forward
    (1e-4 of max, tests/test_serve_engine.py::test_parity_rglru_close) and
    against the CPU's chain; the engine (dense cache, 3 slots, frozen and
    recycled rows): tokens equal and every tick's logits within LM_TOL."""
    import numpy as np

    from repro_torch.models import lm as LM
    from repro_torch.serve import BatchedServer, Request, build_serve
    from repro_torch.train.step import resolve_device

    resolve_device(cuda)
    cfg, model, params = _reduced_lm("recurrentgemma_9b")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen, dtype=torch.int32)
    want, _ = LM.lm_forward(params, cfg, toks)
    got, _ = LM.lm_forward(_to(params, cuda), cfg, toks.to(cuda))
    _lm_close(got, want)

    def chain(p, dev):
        cache = model.init_cache(2, 12, dev)
        out, cache = model.decode_step(p, cache, toks[:, :8].to(dev),
                                       torch.zeros(2, dtype=torch.int32, device=dev))
        outs = [out]
        for t in range(8, 12):
            out, cache = model.decode_step(p, cache, toks[:, t:t + 1].to(dev),
                                           torch.full((2,), t, dtype=torch.int32, device=dev))
            outs.append(out)
        return torch.cat(outs, 1)

    on_card = chain(_to(params, cuda), cuda)
    assert float((on_card - got).abs().max()) <= 1e-4 * float(got.abs().max())
    _lm_close(on_card, chain(params, "cpu"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (9, 5, 12, 3, 6)]
    runs = {}
    for dev in ("cpu", cuda):
        srv = BatchedServer(build_serve(model), _to(params, dev), cfg, 3, 32)
        assert not srv.paged
        records = []
        for uid, p in enumerate(prompts):
            srv.submit(Request(uid, p, 4))
        while srv.tick():
            records.append(srv.last_tick)
        runs[str(dev)] = ({r["uid"]: r["tokens"] for r in srv.completed}, records)
    (tok_h, rec_h), (tok_c, rec_c) = runs["cpu"], runs[str(cuda)]
    assert tok_c == tok_h and len(tok_c) == 5
    assert [r.plan.width for r in rec_c] == [r.plan.width for r in rec_h]
    for rc, rh in zip(rec_c, rec_h):
        _lm_close(rc.logits[rh.plan.active], rh.logits[rh.plan.active])
    torch.cuda.synchronize()


def _reduced_encdec(cuda):
    """Reduced seamless_m4t_v2: encode, and generation as the reference's
    functions define it (``init_cache`` with the encoder's cross K/V, the
    prompt at position 0, then greedy tokens), on the card against the
    CPU: tokens equal, logits within LM_TOL."""
    from repro_torch.models import encdec as ED
    from repro_torch.train.step import resolve_device

    resolve_device(cuda)
    cfg, model, params = _reduced_lm("seamless_m4t_v2")
    gen = torch.Generator().manual_seed(3)
    frames = torch.randn((2, 10, cfg.d_model), generator=gen)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen, dtype=torch.int32)
    runs = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        enc = ED.encode(p, cfg, frames.to(dev))
        cache = model.init_cache(2, 16, dev)
        cache["xkv"] = ED.cross_kv(p, cfg, enc)
        logits, cache = model.decode_step(p, cache, prompt.to(dev), 0)
        outs, toks = [logits], []
        for t in range(4):
            nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            toks.append(nxt.cpu())
            logits, cache = model.decode_step(p, cache, nxt, 8 + t)
            outs.append(logits)
        runs[str(dev)] = (enc, outs, torch.cat(toks, 1))
    (enc_h, outs_h, tok_h), (enc_c, outs_c, tok_c) = runs["cpu"], runs[str(cuda)]
    _lm_close(enc_c, enc_h)
    assert torch.equal(tok_c, tok_h)
    for a, b in zip(outs_c, outs_h):
        _lm_close(a, b)
    torch.cuda.synchronize()


def _rglru_trains_with_the_kernel(cuda):
    """Reduced recurrentgemma_9b, SASG, 2 workers, 3 steps through the
    training launcher's trainer: the kernel run launches one or more
    grouped top-k launches per encode (3 steps and the zero payload), the
    ``topk_impl="reference"`` run none, and their params are bitwise
    equal."""
    from repro_torch.core.types import tree_leaves
    from repro_torch.launch import train as launch

    argv = ["--arch", "recurrentgemma_9b", "--reduced", "--algo", "sasg", "--workers", "2",
            "--global-batch", "4", "--seq-len", "16", "--steps", "3", "--lr", "1.0"]
    params, launches = {}, {}
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)     # as training held bitwise runs
    try:
        for impl in ("kernel", "reference"):
            topk_ef.LAUNCHES.reset()
            trainer = launch.build_trainer(launch.parse_args(argv + ["--topk-impl", impl]),
                                           log_fn=lambda m: None)
            params[impl] = trainer.run(seed=0).params
            launches[impl] = topk_ef.LAUNCHES.count
    finally:
        torch.use_deterministic_algorithms(before)
    assert launches["kernel"] >= 4 and launches["reference"] == 0
    for a, b in zip(tree_leaves(params["kernel"]), tree_leaves(params["reference"])):
        assert torch.equal(a, b)


# the kernel path's gradients against the oracle's: they differ only in the
# chunk term (fp32 sums in other orders, held to checks.SSD_TOL forward and
# checks.SSD_BWD_TOL backward), which the layers carry to every leaf; as
# chip_smoke.py's SSD_GRAD_TOL (measured ~2e-5 here, ~1e-4 at full width)
SSD_GRAD_TOL = checks.SSD_BWD_TOL


def _mamba2_gradients_kernel_vs_oracle(cuda):
    """Reduced mamba2_370m (2 SSD layers, fp32) on the card: the SASG step's
    per-worker gradients over 3 workers (``per_worker_grad_fn``) through
    the SSD forward and backward kernels (``build(cfg)``), one launch of
    each per layer whatever the workers, against the oracle under autograd
    (``build(cfg, use_kernel=False)``), the losses within LM_TOL and each
    leaf within SSD_GRAD_TOL of its largest magnitude."""
    import numpy as np

    from repro_torch.core.sasg import per_worker_grad_fn
    from repro_torch.core.types import tree_leaves
    from repro_torch.models import build

    cfg, model, params = _reduced_lm("mamba2_370m")
    params = _to(params, cuda)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 2, 64)).astype(np.int64)
    batch = {"tokens": torch.from_numpy(toks).to(cuda),
             "labels": torch.from_numpy(np.roll(toks, -1, axis=2)).to(cuda)}
    ssd_scan.LAUNCHES.reset()
    ssd_scan_bwd.LAUNCHES.reset()
    loss_k, grads_k = per_worker_grad_fn(model.loss_fn)(params, batch, False)
    assert ssd_scan.LAUNCHES.count == ssd_scan_bwd.LAUNCHES.count == cfg.n_layers
    loss_o, grads_o = per_worker_grad_fn(build(cfg, use_kernel=False).loss_fn)(params, batch,
                                                                              False)
    assert ssd_scan.LAUNCHES.count == ssd_scan_bwd.LAUNCHES.count == cfg.n_layers
    _lm_close(loss_k, loss_o.cpu())
    gap = 0.0
    for a, b in zip(tree_leaves(grads_k), tree_leaves(grads_o)):
        err = float((a - b).abs().max())
        assert err <= SSD_GRAD_TOL * float(b.abs().max()), err
        gap = max(gap, err / float(b.abs().max()))
    print(f"reduced mamba2_370m: kernel-path gradients within {gap:.3g} of each leaf's max "
          "of the oracle's")
