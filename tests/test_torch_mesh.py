"""Device meshes of gloo ranks against the stacked mesh, and checkpoints of
a multi-process run.

Two spawned groups, each shared by its items through a module fixture
(every spawn pays the ranks' start-up): 2 ranks as a (1, 2) TP mesh
(training, checkpoints, serving), and
4 ranks as a (2, 2) flat mesh, then as a (2, 2, 1) hierarchical one. The
d_model=16 CNN, SASG, 4 workers, 2 images each, on the CPU.

- A device mesh's run equals the stacked mesh's of the same shape: sends,
  rounds and bits exact on every rank; params within the top-k tier of
  ``test_torch_train_step.py`` (2e-2). Each rank holds half of every
  TP-sharded leaf. On a model axis of ranks each rank computes its
  gradient on its own shards (``tp_compute=sharded``,
  ``dist.tensor_parallel``): the products' partial sums are added over
  the ranks, so the params are no longer bitwise the stacked run's, which
  computes every full gradient in one process.
- Tensor-parallel compute against the JAX package: one gradient
  evaluation per worker (fresh and at worker-stacked params) of the
  d_model=16 CNN, reduced llama3_8b, reduced mamba2_370m (the SSD layers'
  forms), reduced recurrentgemma_9b (RG-LRU, and local attention on a
  KV head the axis does not split), reduced mixtral_8x7b (expert-parallel)
  and kimi_k2 (and its shared expert), a 3-expert mixtral (the experts
  split over d_expert) and internvl2_2b at a vocabulary of 255 (embedding
  and head whole) on the 2 ranks, at the JAX step's initial params
  (PRNGKey(2), carried as numpy) and numpy batches from a seed, within
  1e-5 of each leaf's max of ``jax.grad``, every replicated leaf's
  gradient bitwise equal on both ranks; the MoE's router picks on each
  rank equal to the unsharded port's, and some choice dropped past
  capacity; the vocabulary-parallel cross-entropy within 1e-6 of the
  gathered one; 3 SASG steps of each model but the last three on the
  (1, 2) ranks against the JAX step on a (1, 2) fake-device mesh
  (counters exact, params within 2e-2).
- The whole-leaf compressors (randk, qsgd, signsgd_ef, terngrad, topk_ef
  per_tensor and flat) run 2 SASG steps of fc_mnist on the ranks:
  counters exact and params within 2e-2 of the stacked (1, 2) run.
- The model axis's wire-log bytes of a (1, 2) step equal the figure
  worked out from the shapes: the CNN's (``_model_axis_bytes``), reduced
  mamba2_370m's (``_ssd_model_axis_bytes``) and reduced mixtral_8x7b's
  (``_moe_model_axis_bytes``).
- Checkpoints: a 2-rank run saves the one-process format (rank 0 writes
  the gathered arrays; the meta names the mesh and the strategy). A 2-rank
  restore continues bitwise equal to an uninterrupted run; a one-process
  stacked run restores the same checkpoint and continues; a restore at
  another worker count cold-starts the worker state from the restored
  params. The same for the launcher's ``--procs 2`` without
  ``--mesh-shape`` (fc_mnist): a 2-rank restore continues bitwise, and a
  one-process run restores every worker's state bitwise.
- A hierarchical strategy with FSDP over the in-pod data axis (the JAX
  package refuses it: an XLA partitioner limit) runs on the 4 ranks.
- Serving: reduced llama3_8b over the (1, 2) mesh (tensor-parallel
  forward, half of the KV heads on each rank) gives the unsharded engine's
  tokens, paged and dense; reduced mamba2_370m, recurrentgemma_9b and
  granite_20b (paged too) give the unsharded engine's tokens and the JAX
  engine's on the same params, each rank holding half of the SSD's and
  the RG-LRU's ``h`` and of the RG-LRU's conv state (their concatenation
  the unsharded engine's), the SSD's conv state and the single KV head
  whole; reduced mixtral_8x7b (a dense ring) and kimi_k2 (paged), from
  the port's init, give the unsharded engine's tokens.
- The launcher's ``--mesh-shape``: the strategy line, and ``--procs``
  that is not the mesh's size is refused.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.comm import collectives, process_group
from repro_torch.configs import ARCH_IDS, PAPER_IDS, get_config
from repro_torch.core.sasg import PRESETS
from repro_torch.core.types import tree_flatten_with_paths, tree_leaves
from repro_torch.dist import tensor_parallel
from repro_torch.dist.strategy import choose_strategy
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build
from repro_torch.optim import constant
from repro_torch.train import Trainer, TrainerConfig, build_train_step

M, STEPS, LR, SEED = 4, 4, 0.05, 2
TP_STEPS = 3
TP_SEQ = {"mamba2_370m": 64}   # whole SSD chunks (32 reduced); 16 tokens elsewhere
# the tensor-parallel checks' configs beside the reduced archs and the
# d_model=16 CNN: reduced mixtral_8x7b with 3 experts (split over d_expert
# at t = 2) and reduced internvl2_2b at a vocabulary of 255 (its embedding
# and head whole on each rank): (arch, field, value)
TP_VARIANTS = {"mixtral_8x7b_3_experts": ("mixtral_8x7b", "num_experts", 3),
               "internvl2_2b_vocab_255": ("internvl2_2b", "vocab_size", 255)}
# held by their gradients only (no SASG step: a JAX step's compile costs more)
TP_GRADS_ONLY = ("kimi_k2", "mixtral_8x7b_3_experts", "internvl2_2b_vocab_255")
# serving over (1, 2) against the unsharded engine: (paged modes, prompt
# lengths, max_seq, prefill chunk, params): "jax" serves the JAX init's
# params and holds the tokens to the JAX engine's too, "port" the port's init
SERVE_ARCHS = {"mamba2_370m": ((None,), (40, 9, 33), 64, 32, "jax"),
               "recurrentgemma_9b": ((None,), (40, 9, 33), 64, 32, "jax"),
               "granite_20b": ((None, False), (40, 9, 33), 64, 32, "jax"),
               "mixtral_8x7b": ((None,), (10, 10, 10), 32, 8, "port"),
               "kimi_k2": ((None,), (10, 10, 10), 32, 8, "port")}
PROCS_ARGV = ["--arch", "fc_mnist", "--algo", "sasg", "--workers", str(M), "--procs", "2",
              "--global-batch", str(2 * M), "--device", "cpu"]
JOIN_S = 300.0
KEYS = ("num_sent", "rounds_total", "bits_paper_total", "bits_wire_total")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return dataclasses.replace(get_config("cnn_cifar"), d_model=16)


def _axes(shape):
    return ("pod", "data", "model")[-len(shape):]


def _built(shape, group=None, workers=M, scfg=None, cfg=None):
    mesh = make_test_mesh(shape, _axes(shape), group=group)
    return build_train_step(build(cfg or _cfg()), scfg or PRESETS["sasg"](), workers,
                            constant(LR), device="cpu", group=group, mesh=mesh)


# the whole-leaf compressors: SASG with each, 2 steps of fc_mnist (both
# weights split over the model axis, both biases whole) on the (1, 2) ranks
WHOLE_LEAF = (("randk", ""), ("qsgd", ""), ("signsgd_ef", ""), ("terngrad", ""),
              ("topk_ef", "per_tensor"), ("topk_ef", "flat"))


def _whole_leaf_cfg(name, layout):
    scfg = PRESETS["sasg"]()
    return dataclasses.replace(scfg, compressor=dataclasses.replace(
        scfg.compressor, name=name, layout=layout))


def _model_axis_bytes(c=16, m=M, b=2, t=2, leaves=37, classes=10) -> int:
    """Wire-log result bytes over the model axis of one SASG step of the
    d_model=16 CNN on (1, 2) ranks (fp32; each rank's rows). Per gradient
    evaluation (two a step: the fresh gradient and the stale-params one):
    every conv input's channels gathered (``gather_for_local``: five of
    c x 32 x 32, four of 2c x 16 x 16, three of 4c x 8 x 8; the shared
    input of a block's conv1 and proj gathered once) and the head's
    features, the same count of reduce-scatters of half that in the
    backward, the logits gathered, and ``copy_to``'s sum of every vector
    used on a rank's channels (ten GroupNorm vectors of c, eight of 2c,
    eight of 4c, the head's bias), logged as the t ranks' copies. Per
    step: the rule's per-worker norm partials and the window's, one
    scalar a leaf."""
    def act(ch, hw):
        return m * b * ch * hw * hw * 4

    gathers = 5 * act(c, 32) + 4 * act(2 * c, 16) + 3 * act(4 * c, 8) + m * b * 4 * c * 4
    per_eval = (gathers + gathers // t + m * b * classes * 4
                + t * m * 4 * (10 * c + 8 * 2 * c + 8 * 4 * c + classes))
    return 2 * per_eval + t * leaves * (m + 1) * 4


def _ssd_model_axis_bytes(t=2, m=1, b=4, s=64, d=128, heads=16, d_inner=256, gn=16,
                          layers=2, leaves=11, k=4) -> int:
    """Wire-log result bytes over the model axis of one SASG step of reduced
    mamba2_370m on (1, 2) ranks (fp32; each rank's rows; ``m`` workers of
    ``b`` rows of ``s`` tokens). Per gradient evaluation (two a step): the
    embedding's sum over the ranks (``reduce``, logged as the t ranks'
    copies); per layer the fused projection gathered (2 d_inner + 2 gn +
    heads columns) and a reduce-scatter of half that in the backward, the
    ``conv_w`` (k x (d_inner + 2 gn)) reduce-scatter of each worker's
    gradient, the normed input's and the norm's variance's ``copy_to``
    sums (d and 1 a token), the variance's and ``w_out``'s ``reduce`` (1
    and d a token), and the ``copy_to`` sums of the heads' vectors (a_log,
    dt_bias, d_skip) and ``norm_scale``; the loss's hidden states
    ``copy_to`` (d a token) and its three vocabulary-parallel statistics
    (a token each). Per step: ``conv_w`` gathered in each layer, once for
    the fresh gradient and once a worker for the stale-params one; the
    rule's per-worker norm partials and the window's, one scalar a leaf."""
    tok = m * b * s * 4
    proj, conv = 2 * d_inner + 2 * gn + heads, d_inner + 2 * gn
    layer = proj * tok * (t + 1) // t + t * tok * (2 * d + 2) \
        + t * m * 4 * (3 * heads + d_inner) + m * k * conv * 4 // t
    per_eval = t * tok * d + layers * layer + t * tok * d + 3 * t * tok
    return 2 * per_eval + layers * (1 + m) * k * conv * 4 + t * leaves * (m + 1) * 4


def _moe_model_axis_bytes(t=2, m=1, b=4, s=16, d=128, experts=8, layers=2,
                          leaves=13) -> int:
    """Wire-log result bytes over the model axis of one SASG step of reduced
    mixtral_8x7b on (1, 2) ranks (fp32; each rank's rows; ``m`` workers of
    ``b`` rows of ``s`` tokens; the experts and the vocabulary split). Per
    gradient evaluation (two a step): the embedding's ``reduce`` and the
    loss's hidden states ``copy_to`` (d a token each, logged as the t
    ranks' copies); per layer the normed inputs' two ``copy_to`` sums and
    the attention's and the MoE's ``reduce`` (d a token each, t copies),
    the router's logits gathered (E a token) and reduce-scattered back
    (E / t a token); the loss's three vocabulary-parallel statistics (a
    token each, t copies, chunk by chunk). Per step: the rule's per-worker
    norm partials and the window's, one scalar a leaf."""
    tok = m * b * s * 4
    layer = 4 * t * tok * d + tok * experts + tok * experts // t
    per_eval = 2 * t * tok * d + layers * layer + 3 * t * tok
    return 2 * per_eval + t * leaves * (m + 1) * 4


def _tp_cfg(get, arch):
    """The config of ``arch``'s tensor-parallel check from ``get`` (either
    package's ``get_config``): the d_model=16 CNN, a reduced arch or a
    ``TP_VARIANTS`` entry."""
    if arch == "cnn_cifar":
        return dataclasses.replace(get(arch), d_model=16)
    base, field, value = TP_VARIANTS.get(arch, (arch, None, None))
    cfg = get(base).reduced()
    if field == "num_experts":
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=value))
    return dataclasses.replace(cfg, **{field: value}) if field else cfg


def _picks(loss_fn, params, batch):
    """The router's top-k picks of every MoE call of ``loss_fn`` on each
    worker's rows of the worker-stacked ``batch`` (no gradient; on a rank,
    from the full probabilities), and the choices dropped past capacity."""
    from repro_torch.models import layers as L

    orig, picks, drops = L.moe_apply, [], [0]

    def moe_apply(params, cfg, x, tp=None):
        tokens = x.shape[0] * x.shape[1]
        probs = torch.softmax(L.moe_router_logits(params, cfg, x.reshape(tokens, -1), tp), -1)
        tope = L._top_k(probs, cfg.moe.top_k)[1]
        picks.append(tope.numpy().copy())
        group, cap = L.moe_capacity(cfg, tokens)
        for row in tope.reshape(tokens // group, -1):
            drops[0] += int((torch.bincount(row, minlength=cfg.moe.num_experts) - cap)
                            .clamp(min=0).sum())
        return orig(params, cfg, x, tp)

    L.moe_apply = moe_apply
    try:
        with torch.no_grad():
            for w in range(batch["tokens"].shape[0]):
                loss_fn(params, {k: v[w] for k, v in batch.items()})
    finally:
        L.moe_apply = orig
    return picks, drops[0]


def _params(built, state):
    full = built.gather_state(state)
    paths, leaves, _ = tree_flatten_with_paths(full.params)
    return {p: x.numpy().copy() for p, x in zip(paths, leaves)}


def _run(shape, group=None, steps=STEPS, scfg=None, cfg=None):
    cfg = cfg or _cfg()
    built = _built(shape, group, scfg=scfg, cfg=cfg)
    state = built.init(seed=SEED)
    stream = launch.data_stream(cfg, 2 * M)
    hist, model_bytes = [], []
    for t in range(steps):
        with collectives.wire_log() as rows:
            state, mets = built.step(state, stream.batch_at(t))
        hist.append({k: float(mets[k]) for k in KEYS})
        model_bytes.append(sum(r["result_bytes"] for r in rows if r["axes"] == ["model"]))
    paths, leaves, _ = tree_flatten_with_paths(state.params)
    local = {p: tuple((x.to_local() if hasattr(x, "to_local") else x).shape)
             for p, x in zip(paths, leaves)}
    return {"history": hist, "params": _params(built, state), "local": local,
            "tp_compute": built.tp_compute, "model_bytes": model_bytes}


def _tp_grads(group, arch, params, batch):
    """One per-worker gradient evaluation of ``arch`` on this rank's shards
    of ``params`` (numpy, the JAX init), fresh (params shared by the
    workers) and stale (params stacked per worker): the local gradients
    and the leaves' specs."""
    from repro_torch.comm.process_group import axis_group
    from repro_torch.core.sasg import per_worker_grad_fn
    from repro_torch.core.types import tree_flatten, tree_map, tree_unflatten
    from repro_torch.dist.sharding import is_spec, param_specs, take_local
    from repro_torch.models import params_from_numpy

    cfg = _tp_cfg(get_config, arch)
    mesh = make_test_mesh((1, 2), ("data", "model"), group=group)
    full = params_from_numpy(params)
    specs = param_specs(full, mesh, None, "model")
    leaves, treedef = tree_flatten(full)
    spec_list = tree_leaves(specs, is_leaf=is_spec)
    local = tree_unflatten(treedef, [take_local(x, sp, mesh) for x, sp in zip(leaves, spec_list)])
    axis = tensor_parallel.ModelAxis(axis_group(group, mesh, "model"))
    loss_fn = tensor_parallel.local_model(build(cfg), axis).loss_fn
    grad_fn = per_worker_grad_fn(loss_fn)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["labels"] = tb["labels"].long()
    stacked = tree_map(lambda x: torch.stack([x, x]), local)
    out = {}
    for name, p, flag in (("fresh", local, False), ("stale", stacked, True)):
        loss, grads = grad_fn(p, tb, flag)
        paths, leaves, _ = tree_flatten_with_paths(grads)
        out[name] = {"loss": loss.numpy(), "grads": {q: x.numpy() for q, x in zip(paths, leaves)}}
    out["specs"] = dict(zip(tree_flatten_with_paths(full)[0], (tuple(sp) for sp in spec_list)))
    if cfg.moe is not None:
        out["picks"] = _picks(loss_fn, local, tb)[0]
    return out


def _tp_ce(group, hidden, head_w, labels):
    """The vocabulary-parallel cross-entropy on this rank's classes of
    ``head_w``, and the gathered one."""
    from repro_torch.comm.process_group import axis_group
    from repro_torch.models.model import chunked_ce

    mesh = make_test_mesh((1, 2), ("data", "model"), group=group)
    axis = tensor_parallel.ModelAxis(axis_group(group, mesh, "model"))
    h, w, lab = (torch.from_numpy(a) for a in (hidden, head_w, labels))
    v = w.shape[1] // 2
    return (float(chunked_ce(h, w[:, group.rank * v:(group.rank + 1) * v], lab, tp=axis)),
            float(chunked_ce(h, w, lab)))


def _tp_steps(group, arch, params, batches):
    """SASG steps of ``arch`` on the (1, 2) ranks from ``params`` (numpy, the
    JAX init): the counters and the full params after each step."""
    from repro_torch.models import params_from_numpy

    cfg = _tp_cfg(get_config, arch)
    built = _built((1, 2), group, workers=None, cfg=cfg)
    state = built.init(params=params_from_numpy(params))
    hist, model_bytes = [], []
    for batch in batches:
        with collectives.wire_log() as rows:
            state, mets = built.step(state, batch)
        hist.append({k: float(mets[k]) for k in KEYS})
        model_bytes.append(sum(r["result_bytes"] for r in rows if r["axes"] == ["model"]))
    full = built.gather_state(state)
    return {"history": hist, "params": [x.numpy().copy() for x in tree_leaves(full.params)],
            "tp_compute": built.tp_compute, "model_bytes": model_bytes}


def _tp_checks(group, ref):
    """The tensor-parallel compute's checks on the ranks (``ref``: the
    inputs the test process made from numpy seeds)."""
    logs = []
    launch.build_trainer(launch.parse_args(
        ["--arch", "cnn_cifar", "--algo", "sasg", "--mesh-shape", "1,2", "--procs", "2",
         "--workers", str(M), "--global-batch", str(2 * M), "--device", "cpu"]),
        logs.append, group)
    return {"grads": {a: _tp_grads(group, a, *ref["grads"][a]) for a in ref["grads"]},
            "ce": _tp_ce(group, *ref["ce"]),
            "steps": {a: _tp_steps(group, a, *ref["steps"][a]) for a in ref["steps"]},
            "whole_leaf": {c: _run((1, 2), group, 2, _whole_leaf_cfg(*c), get_config("fc_mnist"))
                           for c in WHOLE_LEAF},
            "logs": logs}


def _trainer(built, steps, ckpt_dir=None, every=100):
    return Trainer(built, launch.data_stream(_cfg(), 2 * M),
                   TrainerConfig(total_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=every,
                                 ckpt_async=False), log_fn=lambda m: None)


def _serve_setup(arch):
    """(prompt lengths, max_seq, prefill chunk) of ``arch``'s serving check."""
    return SERVE_ARCHS[arch][1:4] if arch in SERVE_ARCHS else ((10, 10, 10), 32, 8)


def _serve(group=None, paged=None, arch="llama3_8b", params=None):
    """Reduced ``arch`` answering 3 requests through 2 slots, unsharded or
    over a (1, 2) device mesh, from ``params`` (numpy) or the port's init:
    the completions, every tick's logits and the final cache."""
    import numpy as np

    from repro_torch.models import params_from_numpy
    from repro_torch.serve import BatchedServer, Request, build_serve

    cfg = get_config(arch).reduced()
    model = build(cfg)
    params = (model.init(torch.Generator().manual_seed(0), device="cpu") if params is None
              else params_from_numpy(params))
    serve = build_serve(model)
    if group is not None:
        mesh = make_test_mesh((1, 2), ("data", "model"), group=group)
        serve = build_serve(model, mesh, None, "model", "data", group=group)
        params = serve.place(params)
    lengths, max_seq, chunk = _serve_setup(arch)
    srv = BatchedServer(serve, params, cfg, 2, max_seq, paged=paged, block_size=8,
                        prefill_chunk=chunk)
    rng = np.random.default_rng(0)
    for i, n in enumerate(lengths):
        srv.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=n)
                           .astype(np.int32), max_new_tokens=4))
    logits = []
    while srv.tick():
        logits.append(srv.last_tick.logits.numpy().copy())
    paths, leaves, _ = tree_flatten_with_paths(srv.cache)
    return {"done": sorted((c["uid"], [int(t) for t in c["tokens"]]) for c in srv.completed),
            "logits": logits, "cache": {p: x.numpy().copy() for p, x in zip(paths, leaves)}}


def _procs_run(group, steps, ckpt=()):
    """fc_mnist through the launcher's ``--procs 2`` without ``--mesh-shape``
    (the group form): the full params and worker state, and the history."""
    trainer, state = launch.train(PROCS_ARGV + ["--steps", str(steps)] + list(ckpt),
                                  log_fn=lambda m: None, group=group)
    full = trainer.built.gather_state(state)
    paths, leaves, _ = tree_flatten_with_paths((full.params, full.wstate))
    return {"state": {p: x.numpy().copy() for p, x in zip(paths, leaves)},
            "history": trainer.history}


def _two_rank(group, ckpt_dir, ref):
    serve = {("llama3_8b", paged): _serve(group, paged) for paged in (None, False)}
    for arch, (modes, *_) in SERVE_ARCHS.items():
        for paged in modes:
            serve[arch, paged] = _serve(group, paged, arch, ref["serve"].get(arch))
    out = {"mesh": _run((1, 2), group), "tp": _tp_checks(group, ref), "serve": serve}
    for name, steps, d, every in (("u6", 6, None, 100), ("u8", 8, None, 100),
                                  ("c4", 4, ckpt_dir, 2), ("r6", 6, ckpt_dir, 100)):
        built = _built((1, 2), group)
        trainer = _trainer(built, steps, d, every)
        state = trainer.run(seed=SEED)
        out[name] = {"params": _params(built, state), "history": trainer.history}
    d = _procs_dir(ckpt_dir)
    out["procs"] = {"u6": _procs_run(group, 6),
                    "c4": _procs_run(group, 4, ["--ckpt-dir", d, "--ckpt-every", "2"]),
                    "r6": _procs_run(group, 6, ["--ckpt-dir", d])}
    return out


def _four_rank(group):
    out = {shape: _run(shape, group) for shape in ((2, 2), (2, 2, 1))}
    # FSDP over the in-pod data axis inside the hierarchical worker region:
    # the JAX package refuses it (an XLA partitioner CHECK); the port
    # gathers the params before the gradient either way
    mesh = make_test_mesh((2, 2, 1), _axes((2, 2, 1)), group=group)
    s = choose_strategy(mesh)
    built = build_train_step(build(_cfg()), PRESETS["sasg"](), M, constant(LR), device="cpu",
                             group=group, mesh=mesh, strategy=dataclasses.replace(
                                 s, fsdp_axis="data"))
    state = built.init(seed=SEED)
    stream = launch.data_stream(_cfg(), 2 * M)
    out["fsdp"] = []
    for t in range(2):
        state, mets = built.step(state, stream.batch_at(t))
        out["fsdp"].append({k: float(mets[k]) for k in KEYS + ("loss",)})
    return out


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh_ckpt"))


def _procs_dir(ckpt_dir):
    """The checkpoints of the group form's run, beside the mesh run's."""
    return ckpt_dir + "_procs"


def _jax_models():
    """The JAX package's d_model=16 CNN, reduced llama3_8b, mamba2_370m,
    recurrentgemma_9b, mixtral_8x7b (expert-parallel at t = 2) and kimi_k2
    (and its shared expert), and the ``TP_VARIANTS``."""
    from repro.configs import get_config as jax_get_config
    from repro.models import build as jax_build

    out = {}
    for arch in ("cnn_cifar", "llama3_8b", "mamba2_370m", "recurrentgemma_9b",
                 "mixtral_8x7b", "kimi_k2") + tuple(TP_VARIANTS):
        cfg = _tp_cfg(jax_get_config, arch)
        out[arch] = (cfg, jax_build(cfg))
    return out


def _tp_batches(arch, global_batch, steps):
    """The JAX package's numpy streams (CNN images; the LMs' tokens,
    ``TP_SEQ`` or 16 a row)."""
    from repro.configs import get_config as jax_get_config
    from repro.data import (indexed_classification_stream, indexed_token_stream,
                            synthetic_classification)

    if arch != "cnn_cifar":
        vocab = _tp_cfg(jax_get_config, arch).vocab_size
        stream = indexed_token_stream(vocab, global_batch, TP_SEQ.get(arch, 16), seed=0)
    else:
        xs, ys = synthetic_classification(256, 10, (32, 32, 3), seed=0)
        stream = indexed_classification_stream(xs, ys, global_batch, seed=0)
    return [stream.batch_at(t) for t in range(steps)]


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's SASG step of each model but ``TP_GRADS_ONLY`` on a
    (1, 2) fake-device mesh, and its initial state (PRNGKey(2))."""
    import jax

    from repro import compat
    from repro.core.sasg import PRESETS as JAX_PRESETS
    from repro.dist.strategy import choose_strategy as jax_choose_strategy
    from repro.optim import constant as jax_constant
    from repro.train import build_train_step as jax_build_train_step

    jmesh = compat.make_mesh((1, 2), ("data", "model"), devices=jax.devices()[:2])
    out = {}
    for arch, (_, jmodel) in _jax_models().items():
        if arch in TP_GRADS_ONLY:
            continue
        jbuilt = jax_build_train_step(jmodel, JAX_PRESETS["sasg"](), jmesh,
                                      jax_choose_strategy(jmesh), jax_constant(LR))
        out[arch] = (jbuilt, jbuilt.init(jax.random.PRNGKey(2)))
    return out


@pytest.fixture(scope="module")
def tp_ref(jax_steps):
    """Numpy inputs of the tensor-parallel checks, from seeds: each model's
    params (the JAX step's init, or the JAX init at PRNGKey(2) for
    ``TP_GRADS_ONLY``), a worker-stacked batch (2 workers x 2 rows) for the
    gradients, the CE's hidden states, head and labels, the steps'
    batches, and the served models' params (the JAX init, PRNGKey(0))."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models import build as jax_build

    rng = np.random.default_rng(7)
    grads, steps = {}, {}
    for arch, (_, jmodel) in _jax_models().items():
        init = (jmodel.init(jax.random.PRNGKey(2)) if arch in TP_GRADS_ONLY
                else jax_steps[arch][1].params)
        params = jax.tree.map(np.asarray, init)
        batches = _tp_batches(arch, 4, TP_STEPS)
        grads[arch] = (params, {k: np.asarray(v).reshape((2, 2) + np.shape(v)[1:])
                                for k, v in batches[0].items()})
        if arch not in TP_GRADS_ONLY:
            steps[arch] = (params, batches)
    ce = (rng.normal(size=(2, 16, 128)).astype(np.float32),
          (rng.normal(size=(128, 256)) / np.sqrt(128)).astype(np.float32),
          rng.integers(0, 256, size=(2, 16)).astype(np.int64))
    serve = {a: jax.tree.map(np.asarray, jax_build(jax_get_config(a).reduced()).init(
        jax.random.PRNGKey(0))) for a, setup in SERVE_ARCHS.items() if setup[4] == "jax"}
    return {"grads": grads, "ce": ce, "steps": steps, "serve": serve}


@pytest.fixture(scope="module")
def two_ranks(ckpt_dir, tp_ref):
    return process_group.spawn(_two_rank, 2, "gloo", "cpu", args=(ckpt_dir, tp_ref),
                               join_timeout_s=JOIN_S)


@pytest.fixture(scope="module")
def four_ranks():
    return process_group.spawn(_four_rank, 4, "gloo", "cpu", join_timeout_s=JOIN_S)


def _threads(world):
    """The stacked reference on the threads of one rank of ``world``
    (``process_group.spawn`` splits the cores; the CPU's kernels block
    their sums by thread count)."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))


def _same(a, b) -> bool:
    """Bitwise equal arrays (any dtype)."""
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _check(ranks, want, bitwise):
    for r in ranks:
        assert r["history"] == want["history"]
        for p, w in want["params"].items():
            got = r["params"][p]
            assert got.shape == w.shape, p
            if bitwise:
                assert np.array_equal(got.view(np.int32), w.view(np.int32)), p
            else:
                assert np.max(np.abs(got - w)) < 2e-2, p


def test_tp_mesh_matches_stacked(two_ranks, tp_ref, jax_steps):
    """Each rank computes its gradients on its own shards, so the params are
    held within the top-k tier (2e-2) and not bitwise: the partial sums of
    the sharded products are added over the ranks (the stacked run sums
    each product in one process). Counters stay exact. The whole-leaf
    compressors likewise; the model axis's bytes a step are the figure of
    ``_model_axis_bytes``; the path of every arch is stated."""
    _threads(2)
    want = _run((1, 2))
    assert want["tp_compute"] == "none" and want["model_bytes"] == [0] * STEPS
    _check([r["mesh"] for r in two_ranks], want, bitwise=False)
    split = 0
    for p, shp in two_ranks[0]["mesh"]["local"].items():
        full = want["params"][p].shape
        halves = [i for i, (a, b) in enumerate(zip(shp, full)) if a != b]
        assert len(halves) <= 1 and all(2 * shp[i] == full[i] for i in halves), (p, shp)
        split += bool(halves)
    assert split == 14   # every conv weight and the head's matrix; norms and biases whole
    for r in two_ranks:
        assert r["mesh"]["tp_compute"] == "sharded"
        assert r["mesh"]["model_bytes"] == [_model_axis_bytes()] * STEPS
        assert any("strategy=flat workers=4 stages=1 tp_compute=sharded" in m
                   for m in r["tp"]["logs"]) == (r is two_ranks[0])   # rank 0 logs
    # the whole-leaf compressors: gathered, encoded whole, sliced back
    for c in WHOLE_LEAF:
        _check([r["tp"]["whole_leaf"][c] for r in two_ranks],
               _run((1, 2), steps=2, scfg=_whole_leaf_cfg(*c), cfg=get_config("fc_mnist")),
               bitwise=False)
    # which path each arch takes over a model axis of 2, at full width and
    # reduced (the reduced configs differ only where a width decides)
    want = {"fc_mnist": "sharded", "cnn_cifar": "sharded", "llama3_8b": "sharded",
            "starcoder2_3b": "sharded", "chatglm3_6b": "sharded",
            "internvl2_2b": "sharded", "granite_20b": "sharded",
            "mixtral_8x7b": "sharded", "kimi_k2": "sharded",
            "recurrentgemma_9b": "sharded", "mamba2_370m": "sharded",
            "seamless_m4t_v2": "seamless_m4t_v2 is not a decoder-only LM"}
    assert sorted(want) == sorted(PAPER_IDS + ARCH_IDS)
    for arch, expect in want.items():
        cfgs = {"full": get_config(arch)}
        if arch not in PAPER_IDS:
            cfgs["reduced"] = get_config(arch).reduced()
        for scope, cfg in cfgs.items():
            path = tensor_parallel.compute_path(cfg, 2)
            if expect == "sharded":
                assert path == "sharded", (arch, scope, path)
            else:
                assert path.startswith("gathered (") and expect in path, (arch, scope, path)
    for arch in TP_VARIANTS:
        assert tensor_parallel.compute_path(_tp_cfg(get_config, arch), 2) == "sharded", arch
    # the MoE is refused where neither the experts nor d_expert split, and
    # where a shared expert's width does not; the rank's config keeps E
    mix = get_config("mixtral_8x7b")
    odd = dataclasses.replace(mix, moe=dataclasses.replace(mix.moe, num_experts=3,
                                                           d_expert=14335))
    assert tensor_parallel.compute_path(odd, 2) == \
        "gathered (MoE: neither 3 experts nor d_expert 14335 divisible by 2)"
    assert "MoE shared expert width 2048 not divisible by 3" in tensor_parallel.compute_path(
        get_config("kimi_k2"), 3)
    assert tensor_parallel.local_config(mix, 2).moe == mix.moe
    assert tensor_parallel.compute_path(get_config("llama3_8b"), 2, remat="full") == \
        "gathered (remat 'full')"
    assert tensor_parallel.compute_path(get_config("cnn_cifar"), 2, stages=True) == \
        "gathered (pipeline stages)"
    assert "classes 10 not divisible by 4" in tensor_parallel.compute_path(
        get_config("cnn_cifar"), 4)
    # a single KV head is whole on every rank; more KV heads than one that
    # the axis does not divide fall back (7c)
    assert tensor_parallel.local_config(get_config("granite_20b"), 2).n_kv_heads == 1
    assert "kv heads 1" not in tensor_parallel.compute_path(get_config("granite_20b"), 4)
    assert "kv heads 2 not divisible by 4 and more than one" in tensor_parallel.compute_path(
        get_config("chatglm3_6b"), 4)
    assert "kv heads 8 not divisible by 3 and more than one" in tensor_parallel.compute_path(
        get_config("llama3_8b"), 3)
    assert "SSD heads 32" in tensor_parallel.compute_path(get_config("mamba2_370m"), 3)
    _tp_compute_matches_jax(two_ranks, tp_ref, jax_steps)


# Each sharded gradient leaf is held within 1e-5 of its max of jax.grad,
# except reduced mamba2_370m's a_log, within A_LOG_TOL of its max: a sum
# over every token and head dim with heavy cancellation, where jax.grad in
# fp32 itself stands 2.8e-5 of its max from jax.grad in fp64 and the port's
# kernel path 5.9e-6 (tests/a_log_float64.py); the sharded and the
# unsharded port stand 2.28e-5 from the fp32 jax.grad here (PERF.md, PR 27).
A_LOG_TOL = 5e-5


def _tp_compute_matches_jax(two_ranks, tp_ref, jax_steps):
    """The ranks' sharded gradients, CE and SASG steps against the JAX
    package (module docstring)."""
    import jax
    import jax.numpy as jnp

    from repro_torch.models import params_from_numpy

    models = _jax_models()
    drops = {}
    for arch, (params, batch) in tp_ref["grads"].items():
        jmodel = models[arch][1]
        jparams = jax.tree.map(jnp.asarray, params)
        jb = jax.tree.map(jnp.asarray, batch)
        fresh = jax.jit(jax.vmap(jax.value_and_grad(jmodel.loss_fn), in_axes=(None, 0)))
        stale = jax.jit(jax.vmap(jax.value_and_grad(jmodel.loss_fn), in_axes=(0, 0)))
        wants = {"fresh": fresh(jparams, jb),
                 "stale": stale(jax.tree.map(lambda x: jnp.stack([x, x]), jparams), jb)}
        for name, (jl, jg) in wants.items():
            specs = two_ranks[0]["tp"]["grads"][arch]["specs"]
            r0, r1 = (r["tp"]["grads"][arch][name] for r in two_ranks)
            np.testing.assert_allclose(r0["loss"], np.asarray(jl), rtol=1e-5)
            assert r0["loss"].tobytes() == r1["loss"].tobytes()
            for path, w in jax.tree_util.tree_flatten_with_path(jg)[0]:
                p = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
                w = np.asarray(w)
                a, b = r0["grads"][p], r1["grads"][p]
                dims = [i for i, e in enumerate(specs[p]) if e == "model"]
                if dims:   # this rank's half along its model dim (behind the worker dim)
                    got = np.concatenate([a, b], axis=dims[0] + 1)
                else:      # replicated: the same bits on both ranks
                    assert a.tobytes() == b.tobytes(), (arch, name, p)
                    got = a
                err = float(np.abs(got - w).max())
                rel = A_LOG_TOL if arch == "mamba2_370m" and p.endswith("a_log") else 1e-5
                assert err <= rel * float(np.abs(w).max()), (arch, name, p, err)
        if models[arch][0].moe is not None:
            # every rank routes from the full probabilities: the unsharded
            # port's picks, MoE call by MoE call
            tb = {k: torch.from_numpy(v) for k, v in batch.items()}
            want, drops[arch] = _picks(build(_tp_cfg(get_config, arch)).loss_fn,
                                       params_from_numpy(params), tb)
            for r in two_ranks:
                got = r["tp"]["grads"][arch]["picks"]
                assert len(got) == len(want) and all(
                    np.array_equal(a, b) for a, b in zip(got, want)), arch
    # some choice past its expert's capacity, so that the sharded runs drop
    # it as the JAX package does
    assert sum(drops.values()) > 0, drops
    for r in two_ranks:
        tp_ce, gathered = r["tp"]["ce"]
        assert abs(tp_ce - gathered) <= 1e-6 * abs(gathered), (tp_ce, gathered)
    # SASG on the (1, 2) ranks against the JAX step on a (1, 2) fake-device mesh
    for arch, (_, batches) in tp_ref["steps"].items():
        jbuilt, jstate = jax_steps[arch]
        hist = []
        for batch in batches:
            jstate, jm = jbuilt.jit_step(jstate, batch)
            hist.append({k: float(jm[k]) for k in KEYS})
        for r in two_ranks:
            got = r["tp"]["steps"][arch]
            assert got["tp_compute"] == "sharded" and got["history"] == hist, (arch, hist)
            for a, b in zip(got["params"], jax.tree.leaves(jstate.params)):
                assert float(np.max(np.abs(a - np.asarray(b)))) < 2e-2, arch
            if arch == "mamba2_370m":
                assert got["model_bytes"] == [_ssd_model_axis_bytes()] * TP_STEPS
            if arch == "mixtral_8x7b":
                assert got["model_bytes"] == [_moe_model_axis_bytes()] * TP_STEPS


def test_four_rank_meshes_match_stacked(four_ranks):
    _threads(4)
    for shape in ((2, 2), (2, 2, 1)):
        _check([r[shape] for r in four_ranks], _run(shape), bitwise=False)
    # hierarchical with FSDP inside the pod runs on every rank, the same counters
    fsdp = [r["fsdp"] for r in four_ranks]
    assert all(h == fsdp[0] for h in fsdp)
    assert [h["num_sent"] for h in fsdp[0]][0] == M and all(np.isfinite(h["loss"])
                                                          for h in fsdp[0])


def test_checkpoint_of_two_ranks_continues_bitwise(two_ranks, ckpt_dir):
    from repro_torch.train import checkpoint as CKPT

    for r in two_ranks:
        # restored at step 4 and run to 6 == 6 uninterrupted steps
        for p, w in r["u6"]["params"].items():
            assert np.array_equal(r["r6"]["params"][p].view(np.int32), w.view(np.int32)), p
        assert r["r6"]["history"] == r["u6"]["history"][4:]
    meta = CKPT.manifest_meta(ckpt_dir, 4)
    assert meta["mesh_axes"] == ["data", "model"] and meta["mesh_shape"] == [1, 2]
    assert meta["strategy"] == "flat" and meta["membership"] == [True, ["data"], M]
    assert CKPT.candidate_steps(ckpt_dir) == [6, 4, 2]
    # the group form (--procs 2, no --mesh-shape): rank 0 writes every
    # worker's state, a 2-rank restore continues bitwise, and a one-process
    # run restores the same worker state bitwise (equal membership)
    d = _procs_dir(ckpt_dir)
    for r in two_ranks:
        got, want = r["procs"]["r6"], r["procs"]["u6"]
        for p, w in want["state"].items():
            assert _same(got["state"][p], w), p
        assert got["history"] == want["history"][4:]
    meta = CKPT.manifest_meta(d, 6)
    assert meta["mesh_axes"] == ["data"] and meta["mesh_shape"] == [2]
    assert meta["membership"] == [True, ["data"], M] and meta["num_workers"] == M
    cfg = get_config("fc_mnist")
    built = build_train_step(build(cfg), PRESETS["sasg"](), M, constant(0.1), device="cpu")
    logs = []
    trainer = Trainer(built, launch.data_stream(cfg, 2 * M),
                      TrainerConfig(total_steps=8, ckpt_dir=d), log_fn=logs.append)
    state, step = trainer._restore_latest(built.init(0))
    assert step == 6 and not any("changed" in m for m in logs), logs
    paths, leaves, _ = tree_flatten_with_paths((state.params, state.wstate))
    want = two_ranks[0]["procs"]["r6"]["state"]
    assert len(paths) == len(want)
    for p, x in zip(paths, leaves):
        assert _same(x.numpy(), want[p]), p


def test_checkpoint_of_two_ranks_restores_into_one_process(two_ranks, ckpt_dir, tmp_path):
    _threads(2)
    d = str(tmp_path / "ck")
    shutil.copytree(ckpt_dir, d)
    built = _built((1, 2))
    trainer = _trainer(built, 8, d)
    state = trainer.run(seed=SEED)
    want = two_ranks[0]["u8"]
    assert [{k: h[k] for k in KEYS} for h in trainer.history] == \
        [{k: h[k] for k in KEYS} for h in want["history"][6:]]
    for p, w in want["params"].items():
        assert np.max(np.abs(_params(built, state)[p] - w)) < 2e-2, p


def test_restore_at_another_worker_count_cold_starts(two_ranks, ckpt_dir, tmp_path):
    d = str(tmp_path / "ck")
    shutil.copytree(ckpt_dir, d)
    built = build_train_step(build(_cfg()), PRESETS["sasg"](), 2, constant(LR), device="cpu")
    logs = []
    trainer = Trainer(built, launch.data_stream(_cfg(), 4), TrainerConfig(
        total_steps=7, ckpt_dir=d), log_fn=logs.append)
    state, step = trainer._restore_latest(built.init(SEED))
    assert step == 6 and any("worker count changed 4 -> 2" in m for m in logs), logs
    assert torch.equal(state.wstate.tau, torch.ones(2, dtype=torch.int32))
    assert all(float(e.abs().max()) == 0.0 for e in tree_leaves(state.wstate.comp_state))
    for p, w in two_ranks[0]["r6"]["params"].items():
        got = dict(zip(*tree_flatten_with_paths(state.params)[:2]))[p].numpy()
        assert np.array_equal(got.view(np.int32), w.view(np.int32)), p


def _jax_served(arch, params, paged):
    """The JAX package's engine on a (1, 2) fake-device mesh, serving
    ``_serve``'s requests from ``params``: the completions."""
    import jax

    from repro import compat
    from repro.configs import get_config as jax_get_config
    from repro.models import build as jax_build
    from repro.serve import BatchedServer as JaxServer
    from repro.serve import Request as JaxRequest
    from repro.serve import build_serve as jax_build_serve

    cfg = jax_get_config(arch).reduced()
    jmesh = compat.make_mesh((1, 2), ("data", "model"), devices=jax.devices()[:2])
    jserve = jax_build_serve(jax_build(cfg), jmesh, None, "model")
    lengths, max_seq, chunk = _serve_setup(arch)
    srv = JaxServer(jserve, jax.device_put(params, jserve.param_shardings), cfg, 2, max_seq,
                    paged=paged, block_size=8, prefill_chunk=chunk)
    rng = np.random.default_rng(0)
    for i, n in enumerate(lengths):
        srv.submit(JaxRequest(i, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32), 4))
    done, _ = srv.drain(strict=True)
    return sorted((c["uid"], [int(t) for t in c["tokens"]]) for c in done)


def test_serving_over_a_tp_mesh_gives_the_unsharded_tokens(two_ranks, tp_ref):
    """Reduced llama3_8b, mixtral_8x7b (expert-parallel) and kimi_k2 over
    (1, 2), llama3_8b paged and dense: each rank holds half of the KV
    heads; tokens equal to the unsharded engine's, every tick's logits
    within 1e-5 of max|logits| (the sums over the model axis reassociate
    the row-parallel products). Reduced mamba2_370m,
    recurrentgemma_9b and granite_20b (paged and dense) from the JAX
    init: the same, and tokens equal to the JAX engine's; each rank holds
    half of the SSD state's heads and of the RG-LRU state's channels (the
    two halves within 1e-5 of the unsharded engine's final state), the
    SSD's conv state and the single KV head whole, equal to the unsharded
    engine's."""
    _threads(2)
    cases = [("llama3_8b", paged) for paged in (None, False)] + [
        (arch, paged) for arch, (modes, *_) in SERVE_ARCHS.items() for paged in modes]
    for arch, paged in cases:
        params = tp_ref["serve"].get(arch)
        want = _serve(None, paged, arch, params)
        if params is not None:
            assert _jax_served(arch, params, paged) == want["done"], (arch, paged)
        split = set()
        for r in two_ranks:
            got = r["serve"][arch, paged]
            assert got["done"] == want["done"] and len(got["logits"]) == len(want["logits"])
            for a, b in zip(got["logits"], want["logits"]):
                assert np.max(np.abs(a - b)) <= 1e-5 * np.max(np.abs(b)), (arch, paged)
        for p, w in want["cache"].items():
            halves = [r["serve"][arch, paged]["cache"][p] for r in two_ranks]
            assert halves[0].shape == halves[1].shape, p
            dims = [i for i, (h, n) in enumerate(zip(halves[0].shape, w.shape)) if h != n]
            if dims:   # this rank's heads / channels: half of them
                split.add(p.split("/")[-1])
                assert dims == dims[:1] and 2 * halves[0].shape[dims[0]] == w.shape[dims[0]], p
                got = np.concatenate(halves, axis=dims[0])
                assert np.max(np.abs(got - w)) <= 1e-5 * max(1.0, np.max(np.abs(w))), p
            elif np.issubdtype(w.dtype, np.integer):   # positions, block tables
                assert all(np.array_equal(h, w) for h in halves), p
            else:   # whole on both ranks
                assert all(np.max(np.abs(h - w)) <= 1e-5 * max(1.0, np.max(np.abs(w)))
                           for h in halves), p
        kv = {"pk", "pv"} if paged is None else {"k", "v"}
        assert split == {"mamba2_370m": {"h"}, "recurrentgemma_9b": {"h", "conv"},
                         "granite_20b": set(), "llama3_8b": kv, "kimi_k2": kv,
                         "mixtral_8x7b": {"k", "v"}}[arch], (arch, paged, split)


def test_launcher_mesh_shape(capsys):
    trainer, state = launch.train(
        ["--arch", "fc_mnist", "--algo", "sasg", "--mesh-shape", "2,2", "--global-batch", "8",
         "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert ("[train] arch=fc_mnist algo=sasg mesh={'data': 2, 'model': 2} strategy=flat "
            "workers=2 stages=1") in out, out
    assert trainer.built.num_workers == 2 and len(trainer.history) == 2
    launch.train(["--arch", "fc_mnist", "--algo", "sgd", "--mesh-shape", "2,2,1",
                  "--global-batch", "8", "--steps", "1", "--device", "cpu"])
    assert "strategy=plain" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launch.parse_args(["--mesh-shape", "1,2", "--procs", "3"])
    with pytest.raises(SystemExit):
        launch.parse_args(["--mesh-shape", "1,2,3,4"])
