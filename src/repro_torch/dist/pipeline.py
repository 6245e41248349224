"""Pipeline parallelism over a stage axis: GPipe and 1F1B microbatch schedules.

Port of ``repro/dist/pipeline.py``. A model's homogeneous trunk
(``models.model.PipelineDef``) is split into S contiguous stages of its
stacked layers; microbatches stream through the stages, each stage's
activations handed to the next by a ring shift every tick
(``comm.collectives``, over a ``StageAxis``: all S stages in this process
on a ``StackedMesh``, or one stage a rank of a device mesh's stage axis;
both forms compute the same bits).

Workers: every function here takes worker-stacked batches ``(M, B_m,
...)``; each stage's forward is ``torch.func.vjp`` of ``vmap(stage_fn)``
over the workers with worker-stacked params (shared params are expanded
to the worker dim, so each worker's weight gradient comes out on its own),
and the collectives move whole worker-stacked tensors.

Engines (``build_pipelined_vag``):

- ``"1f1b"``: microbatch i runs forward on stage s at tick i + s and
  backward at tick i + 2(S-1) - s; the last stage turns each microbatch
  around in the tick it finishes. In flight: a 2S-1-slot stash of
  per-stage ``torch.func.vjp`` closures (live residuals O(S) microbatches
  a stage for any n). Carries, cotangent carries and the finished-output
  broadcast move in the ``comm.transport.ActivationLayout`` wire format
  (identity by default: bitwise the dense ring; a blocked top-k through
  the block_topk kernel when compressed). The output is broadcast from the
  last stage, so the loss and the finish-side gradients replicate with no
  d-sized stage sum.
- ``"gpipe"``: every microbatch forward through every stage (n + S - 1
  ticks), then the backward in reverse tick order: what autodiff of the
  GPipe loop computes. Dense activations, whatever the layout.

Gradients (the composition with the SASG exchange, ``train/step.py``):
``stage_local=True`` (the payload-gather path) gives each stage its trunk
slice's gradient, the finish-side gradients replicated and the
prepare-side ones summed over the stages (true on stage 0, exact zeros
elsewhere: ``build_stage_local_grads``); ``stage_local=False`` (the dense
fallback) masks the non-trunk gradients to stage 0, and
``build_stage_combine`` later gathers the trunk and sums the rest. On a
``StackedMesh`` the vag returns the combined FULL tree either way.

Numerics: ``pdef.finish`` is a mean over its rows, so seeding each
microbatch's loss cotangent with ``1/n`` gives the full-batch cotangent
(bitwise for power-of-two n, else to reassociation); microbatching
changes only the order of the sums against the unpipelined gradient.
"""
from __future__ import annotations

import warnings
from typing import Callable

import torch

from repro_torch.comm import collectives
from repro_torch.comm.collectives import StageAxis
from repro_torch.comm.transport import ActivationLayout, is_trunk_path
from repro_torch.core.types import (
    Tree,
    tree_flatten_with_paths,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


def build_pipelined_forward(layer_fn: Callable, layers_per_stage: int) -> Callable:
    """Fold ``layers_per_stage`` applications of ``layer_fn(w, h) -> h`` into
    one ``stage_fn(wseg, h)`` over the stage's params stacked on a leading
    layer dim."""

    def stage_fn(wseg, h):
        for l in range(layers_per_stage):
            h = layer_fn(tree_map(lambda w: w[l], wseg), h)
        return h

    return stage_fn


def tree_get(tree, path: tuple):
    """The subtree at a (dict key / sequence index) path."""
    for k in path:
        tree = tree[k]
    return tree


def _tree_set(tree, path: tuple, value):
    """``tree`` with the subtree at ``path`` replaced (dicts and lists)."""
    if not path:
        return value
    out = dict(tree) if isinstance(tree, dict) else list(tree)
    out[path[0]] = _tree_set(tree[path[0]], path[1:], value)
    return out


def _prefix(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def resolve_microbatches(batch_size: int, requested: int) -> int:
    """Largest microbatch count <= ``requested`` that divides the batch (1
    always does). A ``requested`` the batch cannot honour degrades with a
    warning: fewer microbatches idle more stages a tick. ``requested <=
    1`` asks for no microbatching and stays silent."""
    req = min(max(requested, 1), batch_size)
    for nm in range(req, 1, -1):
        if batch_size % nm == 0:
            if nm != requested and requested > 1:
                warnings.warn(
                    f"resolve_microbatches: batch_size={batch_size} is not divisible by "
                    f"the requested {requested} microbatches; degrading to {nm}",
                    stacklevel=2)
            return nm
    if requested > 1:
        warnings.warn(
            f"resolve_microbatches: batch_size={batch_size} has no divisor <= requested "
            f"{requested}; degrading to 1 microbatch (the pipeline serializes — only one "
            "stage is busy per tick)",
            stacklevel=2)
    return 1


def stage_segments(trunk: Tree, stage: StageAxis, dim: int = 0) -> list:
    """Per local stage, its slice of the trunk leaves' layer ``dim``: the
    S contiguous slices of the full trunk on a ``StackedMesh``, the rank's
    own (already local) trunk on a device mesh."""
    if stage.group is not None:
        return [trunk]
    n = tree_leaves(trunk)[0].shape[dim] // stage.size
    return [tree_map(lambda w, s=s: w.narrow(dim, s * n, n), trunk) for s in stage.stages]


# ---------------------------------------------------------------------------
# the forward alone (GPipe)
# ---------------------------------------------------------------------------

def pipeline_apply(stage_fn: Callable, wsegs: list, micro: list, stage: StageAxis) -> list:
    """Microbatches through the stages, GPipe order: ``wsegs`` are the
    local stages' params, ``micro`` the n microbatch inputs. Returns the n
    finished outputs, the same on every local stage (broadcast from the
    last stage)."""
    n, S = len(micro), stage.size
    carry = [None] * len(stage.stages)
    out = [torch.zeros_like(micro[0]) for _ in range(n)]
    for t in range(n + S - 1):
        ys = []
        for k, s in enumerate(stage.stages):
            i = t - s
            if 0 <= i < n:
                y = stage_fn(wsegs[k], micro[i] if s == 0 else carry[k])
                if s == S - 1:
                    out[i] = y
            else:
                y = torch.zeros_like(micro[0])
            ys.append(y)
        if t < n + S - 2:
            carry = [p[0] for p in collectives.ring_shift_parts([(y,) for y in ys], stage)]
    parts = [(torch.stack(out, 1),) for _ in stage.stages]
    return list(collectives.ring_broadcast_parts(parts, stage, S - 1)[0][0].unbind(1))


def build_pipelined_loss(pdef, stage: StageAxis, microbatches: int = 0) -> Callable:
    """``loss_fn(params, batch)`` of one worker through the GPipe forward
    (params: the full tree on a ``StackedMesh``, this rank's trunk slice on
    a device mesh). The true loss, the same on every stage; differentiable
    where the stages are in this process."""

    def loss_fn(params, batch):
        trunk = tree_get(params, pdef.trunk_path)
        h = pdef.prepare(params, batch)
        b = h.shape[0]
        n = resolve_microbatches(b, microbatches or stage.size)
        mb = b // n
        wsegs = stage_segments(trunk, stage)
        stage_fn = build_pipelined_forward(pdef.layer_fn, tree_leaves(wsegs[0])[0].shape[0])
        out = pipeline_apply(stage_fn, wsegs, [h[i * mb:(i + 1) * mb] for i in range(n)], stage)
        return pdef.finish(params, torch.cat(out), batch)

    return loss_fn


# ---------------------------------------------------------------------------
# gradients (the composition with the SASG exchange)
# ---------------------------------------------------------------------------

def build_stage_local_grads(pdef, stage: StageAxis) -> Callable:
    """Per local stage, finalize the stage-local gradient trees: the
    ``pdef.prepare_paths`` leaves are true on stage 0 and exact zeros
    elsewhere, so a sum over the stages restores them everywhere (a few KB
    for the paper nets); finish-side leaves are already the same on every
    stage, and trunk leaves stay stage-local."""
    if pdef.prepare_paths is None:
        raise ValueError("stage-local gradients need PipelineDef.prepare_paths (a model "
                         "whose prepare / finish param reads are disjoint)")
    prefixes = tuple(_prefix(p) for p in pdef.prepare_paths)

    def finalize(trees: list) -> list:
        flat = [tree_flatten_with_paths(t) for t in trees]
        paths, _, treedef = flat[0]
        cols = []
        for i, path in enumerate(paths):
            xs = [f[1][i] for f in flat]
            if is_trunk_path(path, prefixes):
                x = collectives.psum_tree([[x] for x in xs], stage)[0]
                xs = [x] * len(xs)
            cols.append(xs)
        return [tree_unflatten(treedef, [c[k] for c in cols]) for k in range(len(trees))]

    return finalize


def build_stage_combine(pdef, stage: StageAxis, dim: int = 1) -> Callable:
    """Per local stage's gradient trees -> the FULL tree: trunk slices
    concatenate over the stages along the layer ``dim`` (1 behind the
    worker dim), every other leaf is a stage-0-masked partial and sums to
    its value (``collectives.stage_combine_leaf``)."""
    prefix = _prefix(pdef.trunk_path)

    def combine(trees: list) -> Tree:
        flat = [tree_flatten_with_paths(t) for t in trees]
        paths, _, treedef = flat[0]
        out = [collectives.stage_combine_leaf([f[1][i] for f in flat], stage,
                                              is_trunk_path(path, (prefix,)), dim)
               for i, path in enumerate(paths)]
        return tree_unflatten(treedef, out)

    return combine


def _worker_stacked(tree: Tree, m: int, stacked: bool) -> Tree:
    if stacked:
        return tree
    return tree_map(lambda p: p.unsqueeze(0).expand((m,) + tuple(p.shape)), tree)


class _Split:
    """A worker-stacked params tree split into its trunk and the rest (the
    trunk subtree emptied), and the vjps of prepare / finish over the rest."""

    def __init__(self, pdef, params, batch, stacked: bool):
        m = tree_leaves(batch)[0].shape[0]
        self.pdef, self.batch = pdef, batch
        params = _worker_stacked(params, m, stacked)
        self.trunk = tree_get(params, pdef.trunk_path)
        self.rest = _tree_set(params, pdef.trunk_path, {})

    def prepare(self):
        """(h (M, b, ...), its vjp over the rest)."""
        pdef, batch = self.pdef, self.batch
        return torch.func.vjp(
            lambda r: torch.func.vmap(pdef.prepare)(r, batch), self.rest)

    def finish(self, h):
        """(loss (M,), g_fin, dh) from the full-batch outputs ``h``."""
        pdef, batch = self.pdef, self.batch
        loss, fvjp = torch.func.vjp(
            lambda r, hh: torch.func.vmap(pdef.finish)(r, hh, batch), self.rest, h)
        g_fin, dh = fvjp(torch.ones_like(loss))
        return loss, g_fin, dh


def _rows(batch: Tree, lo: int, hi: int, b: int) -> Tree:
    """Rows [lo, hi) of each worker's slice of every batch leaf."""
    return tree_map(lambda v: v[:, lo:hi] if v.dim() >= 2 and v.shape[1] == b else v, batch)


def _assemble(pdef, stage: StageAxis, g_fin, g_prep0, dwsegs: list,
              stage_local: bool) -> Tree:
    """The local stages' gradient trees from the replicated finish-side
    gradients, stage 0's prepare-side ones (exact zeros on the others) and
    each stage's trunk slice: ``stage_local``, the payload path's trees;
    else the non-trunk gradients masked to stage 0. On a ``StackedMesh``
    the combined full tree."""
    zeros = tree_map(torch.zeros_like, g_fin)
    trees = []
    for s in stage.stages:
        g = tree_map(torch.add, g_fin, g_prep0 if s == 0 else zeros)
        trees.append(g if s == 0 or stage_local else zeros)
    if stage_local:
        trees = build_stage_local_grads(pdef, stage)(trees)
    trees = [_tree_set(g, pdef.trunk_path, dw) for g, dw in zip(trees, dwsegs)]
    if stage.group is not None:
        return trees[0]
    if stage_local:   # non-trunk leaves are the same on every stage
        full_trunk = tree_map(lambda *xs: torch.cat(xs, 1), *dwsegs)
        return _tree_set(trees[0], pdef.trunk_path, full_trunk)
    return build_stage_combine(pdef, stage)(trees)


def pipeline_vag_1f1b(pdef, params, batch, stage: StageAxis, microbatches: int = 0,
                      act_layout=None, stage_local: bool = False, stacked: bool = False):
    """One-forward-one-backward pipelined value-and-grad of the M stacked
    workers (module docstring). ``params``: full on a ``StackedMesh``,
    stage-local on a device mesh; worker-stacked if ``stacked``. Returns
    ``(loss (M,), grads)``."""
    layout = act_layout or ActivationLayout()
    split = _Split(pdef, params, batch, stacked)
    h, prep_vjp = split.prepare()
    m, b = h.shape[:2]
    S = stage.size
    n = resolve_microbatches(b, microbatches or S)
    mb = b // n
    micro = [h[:, i * mb:(i + 1) * mb] for i in range(n)]
    act_shape, act_dtype = tuple(micro[0].shape), micro[0].dtype
    wsegs = stage_segments(split.trunk, stage, dim=1)
    stage_fn = torch.func.vmap(build_pipelined_forward(
        pdef.layer_fn, tree_leaves(wsegs[0])[0].shape[1]))

    def mb_loss_ct(y, i):
        rows = _rows(split.batch, i * mb, (i + 1) * mb, b)
        ly, fvjp = torch.func.vjp(
            lambda yy: torch.func.vmap(pdef.finish)(split.rest, yy, rows), y)
        return fvjp(torch.full_like(ly, 1.0 / n))[0]

    def hop(values, shift):
        """Each local stage's value to stage s + shift, in wire parts; an
        idle stage, or one whose receiver ignores it, sends zero parts."""
        parts = [layout.encode(v, 1) if v is not None and 0 <= s + shift < S else
                 layout.zero_parts(act_shape, h.device, 1)
                 for s, v in zip(stage.stages, values)]
        return collectives.ring_shift_parts(parts, stage, shift)

    T, W = n + 2 * (S - 1), 2 * S - 1
    nloc = len(stage.stages)
    stash = [[None] * W for _ in range(nloc)]
    fwd_recv, bwd_recv = [None] * nloc, [None] * nloc
    dys = [None] * nloc
    out = [None] * n
    dwsegs = [None] * nloc
    dmicro = [None] * n
    for t in range(T):
        ys, dxs = [None] * nloc, [None] * nloc
        for k, s in enumerate(stage.stages):
            i = t - s
            if 0 <= i < n:                                   # forward
                x_in = micro[i] if s == 0 else layout.decode(fwd_recv[k], act_shape,
                                                             act_dtype, 1)
                y, stash[k][t % W] = torch.func.vjp(stage_fn, wsegs[k], x_in)
                ys[k] = y
                if s == S - 1:       # turned around in the tick it finishes
                    out[i] = y
                    dys[k] = mb_loss_ct(y, i)
            ib = t - 2 * (S - 1) + s
            if 0 <= ib < n:                                  # backward
                ct = dys[k] if s == S - 1 else layout.decode(bwd_recv[k], act_shape,
                                                             act_dtype, 1)
                slot = (t - 2 * (S - 1 - s)) % W
                dw, dx = stash[k][slot](ct)
                stash[k][slot] = None
                dwsegs[k] = dw if dwsegs[k] is None else tree_map(torch.add, dwsegs[k], dw)
                if s == 0:
                    dmicro[ib] = dx
                dxs[k] = dx
        if t < n + S - 2:
            fwd_recv = hop(ys, 1)
        if S - 1 <= t < T - 1:
            bwd_recv = hop(dxs, -1)

    # the finished outputs, from the last stage to every stage: encoded
    # once, every stage decodes the same values
    full_shape = (m, n) + act_shape[1:]
    parts = [layout.encode(torch.stack(out, 1), 1) if s == S - 1 else
             layout.zero_parts(full_shape, h.device, 1) for s in stage.stages]
    got = collectives.ring_broadcast_parts(parts, stage, S - 1)[0]
    h_all = layout.decode(got, full_shape, act_dtype, 1).reshape(h.shape)
    loss, g_fin, _ = split.finish(h_all)
    g_prep0 = prep_vjp(torch.cat(dmicro, 1))[0] if 0 in stage.stages else None
    return loss, _assemble(pdef, stage, g_fin, g_prep0, dwsegs, stage_local)


def pipeline_vag_gpipe(pdef, params, batch, stage: StageAxis, microbatches: int = 0,
                       stage_local: bool = False, stacked: bool = False):
    """GPipe's pipelined value-and-grad of the M stacked workers: all
    forwards (dense ring), the loss on the broadcast outputs, then all
    backwards in reverse tick order (what autodiff of the GPipe loop runs).
    Returns ``(loss (M,), grads)``."""
    split = _Split(pdef, params, batch, stacked)
    h, prep_vjp = split.prepare()
    b = h.shape[1]
    S = stage.size
    n = resolve_microbatches(b, microbatches or S)
    mb = b // n
    micro = [h[:, i * mb:(i + 1) * mb] for i in range(n)]
    wsegs = stage_segments(split.trunk, stage, dim=1)
    stage_fn = torch.func.vmap(build_pipelined_forward(
        pdef.layer_fn, tree_leaves(wsegs[0])[0].shape[1]))
    nloc = len(stage.stages)
    # each local stage's vjps, in the order of its calls: microbatch order
    vjps = {id(w): [] for w in wsegs}

    def forward(w, x):
        y, f = torch.func.vjp(stage_fn, w, x)
        vjps[id(w)].append(f)
        return y

    out = pipeline_apply(forward, wsegs, micro, stage)
    vjps = [vjps[id(w)] for w in wsegs]
    loss, g_fin, dh = split.finish(torch.stack(out, 1).reshape(h.shape))
    cts = [dh[:, i * mb:(i + 1) * mb] for i in range(n)]
    recv = [None] * nloc
    dwsegs, dmicro = [None] * nloc, [None] * n
    for t in reversed(range(n + S - 1)):
        dxs = []
        for k, s in enumerate(stage.stages):
            i = t - s
            dx = torch.zeros_like(micro[0])
            if 0 <= i < n:
                dw, dx = vjps[k][i](cts[i] if s == S - 1 else recv[k])
                vjps[k][i] = None
                dwsegs[k] = dw if dwsegs[k] is None else tree_map(torch.add, dwsegs[k], dw)
                if s == 0:
                    dmicro[i] = dx
            dxs.append(dx)
        if t > 0:
            recv = [p[0] for p in collectives.ring_shift_parts([(d,) for d in dxs], stage, -1)]
    g_prep0 = prep_vjp(torch.cat(dmicro, 1))[0] if 0 in stage.stages else None
    return loss, _assemble(pdef, stage, g_fin, g_prep0, dwsegs, stage_local)


def build_pipelined_vag(pdef, stage: StageAxis, microbatches: int = 0,
                        stage_local: bool = False, act_layout=None,
                        engine: str = "1f1b") -> Callable:
    """The pipelined ``GradFn`` of the exchange (``core.sasg``):
    ``grad_fn(params, batch, stacked) -> (loss (M,), grads)``.
    ``stage_local``: the payload-gather path's stage-local gradients
    (module docstring); ``act_layout`` is the 1F1B ring's wire format
    (GPipe moves dense activations)."""
    if engine not in ("1f1b", "gpipe"):
        raise ValueError(f"unknown pipeline engine {engine!r}")

    def grad_fn(params, batch, stacked: bool):
        if engine == "1f1b":
            return pipeline_vag_1f1b(pdef, params, batch, stage, microbatches, act_layout,
                                     stage_local, stacked)
        return pipeline_vag_gpipe(pdef, params, batch, stage, microbatches, stage_local,
                                  stacked)

    return grad_fn
