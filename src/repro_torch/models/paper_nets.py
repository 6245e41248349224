"""The paper's experiment models (Section 5.1), as functions of a param dict.

Port of ``repro/models/paper_nets.py``:

- ``fc_mnist``: two-layer fully-connected net, 512 hidden units, 10 classes.
- ``cnn_cifar``: ResNet-style CNN (3 stages x 2 basic blocks, GroupNorm).

Params are stored in the JAX package's shapes and layouts, because the
per-shard block geometry of the compressor is derived from the stored leaf
shapes (it decides which coordinates compete for top-k, each leaf's k and
the bit counts): dense ``(din, dout)``, conv HWIO ``(kh, kw, cin, cout)``,
the two full-width trunk blocks stacked on dim 0. Inputs are NHWC. The
forward permutes to NCHW / OIHW for ``F.conv2d``.

Tensor parallelism (training over a model axis, ``dist.tensor_parallel``):
with ``tp`` the params are one rank's shards (``dist.sharding.
param_specs``: every dense and conv weight split over its outputs, the
vectors whole). Activations stay channel-local: a conv gathers its input
channels (``tp.gather_for_local``) and computes its own output channels;
GroupNorm normalises the rank's 8/t contiguous groups; the skip and the
``proj`` stay channel-local; the head gathers its features, computes its
own classes and gathers the logits. Vectors used on a rank's channels or
classes enter through ``tp.local_slice``, so their gradients are whole on
every rank.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import tree_map

Params = Any

# depth of the homogeneous full-width trunk, stored stacked on dim 0
CNN_TRUNK_DEPTH = 2


def _dense_init(gen, din, dout, device):
    lim = 1.0 / math.sqrt(din)
    w = torch.empty((din, dout), dtype=torch.float32, device=device)
    w.uniform_(-lim, lim, generator=gen)
    return {"w": w, "b": torch.zeros((dout,), dtype=torch.float32, device=device)}


def fc_init(gen: torch.Generator, cfg: ModelConfig, input_dim: int = 784,
            device=None) -> Params:
    return {
        "fc1": _dense_init(gen, input_dim, cfg.d_model, device),
        "fc2": _dense_init(gen, cfg.d_model, cfg.vocab_size, device),
    }


def _vector(b: torch.Tensor, tp) -> torch.Tensor:
    """A whole vector as the rank's outputs use it."""
    return b if tp is None else tp.local_slice(b)


def fc_apply(params: Params, cfg: ModelConfig, x: torch.Tensor, tp=None) -> torch.Tensor:
    x = x.reshape(x.shape[0], -1)
    h = torch.relu(x @ params["fc1"]["w"] + _vector(params["fc1"]["b"], tp))
    if tp is None:
        return h @ params["fc2"]["w"] + params["fc2"]["b"]
    logits = tp.gather_for_local(h, 1) @ params["fc2"]["w"] + _vector(params["fc2"]["b"], tp)
    return tp.gather(logits, 1)


# ---------------------------------------------------------------------------
# compact ResNet (CIFAR)
# ---------------------------------------------------------------------------

def _conv_init(gen, kh, kw, cin, cout, device):
    fan_in = kh * kw * cin
    w = torch.empty((kh, kw, cin, cout), dtype=torch.float32, device=device)
    return w.normal_(generator=gen) * math.sqrt(2.0 / fan_in)


def _same_pads(size: int, k: int, stride: int) -> tuple:
    """XLA's "SAME" padding of one spatial dim: (before, after), with the
    odd unit after. 3x3 stride 2 on an even size pads 0 before, 1 after —
    not the symmetric 1/1 of ``padding=1``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NCHW activation x HWIO weight, "SAME" padding."""
    kh, kw = w.shape[0], w.shape[1]
    ph = _same_pads(x.shape[-2], kh, stride)
    pw = _same_pads(x.shape[-1], kw, stride)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _gn(x: torch.Tensor, params, groups: int = 8, tp=None) -> torch.Tensor:
    """GroupNorm over contiguous channel groups (population variance,
    eps 1e-5), as the JAX package computes it on NHWC; with ``tp``, the
    rank's ``groups / t`` groups of its channels."""
    if tp is not None:
        groups //= tp.size
    return F.group_norm(x, groups, _vector(params["scale"], tp), _vector(params["bias"], tp),
                        eps=1e-5)


def _gn_init(c, device):
    return {"scale": torch.ones((c,), dtype=torch.float32, device=device),
            "bias": torch.zeros((c,), dtype=torch.float32, device=device)}


def _block_init(gen, cin, cout, stride, device):
    p = {
        "conv1": _conv_init(gen, 3, 3, cin, cout, device), "gn1": _gn_init(cout, device),
        "conv2": _conv_init(gen, 3, 3, cout, cout, device), "gn2": _gn_init(cout, device),
    }
    if stride != 1 or cin != cout:
        p["proj"] = _conv_init(gen, 1, 1, cin, cout, device)
    return p


def _all_channels(x: torch.Tensor, tp) -> torch.Tensor:
    """A conv's input: the rank's channels gathered over the ranks."""
    return x if tp is None else tp.gather_for_local(x, 1)


def _block_apply(p, x, stride, tp=None):
    xa = _all_channels(x, tp)
    h = torch.relu(_gn(_conv(xa, p["conv1"], stride), p["gn1"], tp=tp))
    h = _gn(_conv(_all_channels(h, tp), p["conv2"]), p["gn2"], tp=tp)
    skip = _conv(xa, p["proj"], stride) if "proj" in p else x
    return torch.relu(h + skip)


def cnn_init(gen: torch.Generator, cfg: ModelConfig, in_ch: int = 3,
             device=None) -> Params:
    c = cfg.d_model  # base width (64)
    trunk = [_block_init(gen, c, c, 1, device) for _ in range(CNN_TRUNK_DEPTH)]
    return {
        "stem": _conv_init(gen, 3, 3, in_ch, c, device), "gn0": _gn_init(c, device),
        "trunk": tree_map(lambda *xs: torch.stack(xs), *trunk),
        "s2b1": _block_init(gen, c, 2 * c, 2, device),
        "s2b2": _block_init(gen, 2 * c, 2 * c, 1, device),
        "s3b1": _block_init(gen, 2 * c, 4 * c, 2, device),
        "s3b2": _block_init(gen, 4 * c, 4 * c, 1, device),
        "head": _dense_init(gen, 4 * c, cfg.vocab_size, device),
    }


def cnn_stem(params: Params, x: torch.Tensor, tp=None) -> torch.Tensor:
    """NHWC images -> the trunk's NCHW activations (the rank's channels
    with ``tp``: the images are whole on every rank)."""
    h = x.permute(0, 3, 1, 2)                     # NHWC -> NCHW
    return torch.relu(_gn(_conv(h, params["stem"]), params["gn0"], tp=tp))


def cnn_trunk_block(block_params: Params, h: torch.Tensor, tp=None) -> torch.Tensor:
    """One full-width (stride-1) trunk block: the pipeline's layer_fn."""
    return _block_apply(block_params, h, 1, tp)


def cnn_head(params: Params, h: torch.Tensor, tp=None) -> torch.Tensor:
    h = _block_apply(params["s2b1"], h, 2, tp)
    h = _block_apply(params["s2b2"], h, 1, tp)
    h = _block_apply(params["s3b1"], h, 2, tp)
    h = _block_apply(params["s3b2"], h, 1, tp)
    h = _all_channels(h.mean(dim=(2, 3)), tp)
    logits = h @ params["head"]["w"] + _vector(params["head"]["b"], tp)
    return logits if tp is None else tp.gather(logits, 1)


def cnn_apply(params: Params, cfg: ModelConfig, x: torch.Tensor, tp=None) -> torch.Tensor:
    h = cnn_stem(params, x, tp)
    for l in range(CNN_TRUNK_DEPTH):
        h = cnn_trunk_block(tree_map(lambda w: w[l], params["trunk"]), h, tp)
    return cnn_head(params, h, tp)
