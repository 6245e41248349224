"""A float64 witness for reduced mamba2_370m's gradients (not a pytest
item): ``jax.grad`` of the JAX package's loss in fp32 and the port's
unsharded per-worker gradients (fp32; the kernel path, ``use_kernel=True``,
which runs the chunk kernel's plain version on the CPU, and the oracle,
``use_kernel=False``) against ``jax.grad`` in fp64, on the JAX model's
init (PRNGKey(2)) and a batch of 2 workers x 2 rows of 64 tokens of the
JAX package's token stream: inputs of the kind
``tests/test_torch_mesh.py::_tp_compute_matches_jax`` holds the sharded
port to ``jax.grad`` on.

The JAX SSD keeps its state and gates in fp32 whatever the config says,
so the fp64 run rebinds ``float32`` to ``float64`` in the JAX modules'
``jnp`` while it traces (nothing under ``src/repro`` is edited). Each
line prints a leaf's max abs difference over its fp64 max.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/a_log_float64.py
"""
import dataclasses
import sys

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import indexed_token_stream  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.sasg import per_worker_grad_fn  # noqa: E402
from repro_torch.core.types import tree_flatten_with_paths, tree_leaves  # noqa: E402
from repro_torch.models import build, params_from_numpy  # noqa: E402

ARCH, SEQ = "mamba2_370m", 64


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _jax_grads(cfg, params, batch, dtype):
    model = jax_build(cfg)
    fn = jax.jit(jax.vmap(jax.value_and_grad(model.loss_fn), in_axes=(None, 0)))
    _, grads = fn(jax.tree.map(lambda a: jnp.asarray(a, dtype), params),
                  jax.tree.map(jnp.asarray, batch))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(g, np.float64) for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}


def main():
    torch.set_num_threads(2)
    cfg = jax_get_config(ARCH).reduced()
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jax_build(cfg).init(jax.random.PRNGKey(2)))
    rows = indexed_token_stream(256, 4, SEQ, seed=0).batch_at(0)
    batch = {k: np.asarray(v).reshape((2, 2) + np.shape(v)[1:]) for k, v in rows.items()}

    g32 = _jax_grads(cfg, params, batch, jnp.float32)
    saved = {}
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("repro.") and getattr(mod, "jnp", None) is jnp:
            saved[mod] = mod.jnp
            mod.jnp = _Float64Numpy()
    try:
        g64 = _jax_grads(dataclasses.replace(cfg, param_dtype="float64", compute_dtype="float64"),
                         params, batch, jnp.float64)
    finally:
        for mod, j in saved.items():
            mod.jnp = j

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["labels"] = tb["labels"].long()
    port = {}
    for use_kernel in (True, False):
        loss_fn = build(get_config(ARCH).reduced(), use_kernel=use_kernel).loss_fn
        _, grads = per_worker_grad_fn(loss_fn)(params_from_numpy(params), tb, False)
        port[use_kernel] = dict(zip(tree_flatten_with_paths(grads)[0],
                                    (x.numpy().astype(np.float64) for x in tree_leaves(grads))))

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    print(f"{'leaf':24s} {'jax32-vs-64':>12s} {'kernel-vs-64':>12s} {'oracle-vs-64':>12s} "
          f"{'kernel-vs-jax32':>15s}")
    for path, w in g64.items():
        print(f"{path:24s} {rel(g32[path], w):12.3e} {rel(port[True][path], w):12.3e} "
              f"{rel(port[False][path], w):12.3e} {rel(port[True][path], g32[path]):15.3e}")


if __name__ == "__main__":
    main()
