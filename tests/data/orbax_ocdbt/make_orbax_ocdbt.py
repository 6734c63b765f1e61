"""Write the OCDBT checkpoint that ``chip_smoke.py`` phase 3f reads on the card's host.

rxtpu's ``save_checkpoint_orbax`` (orbax's ``StandardCheckpointer``, OCDBT,
zarr v2, zstd) writes ``ckpt/``: a small rolling payload in rxtpu's layout,
optax's real ``sgd`` nesterov state of rxtpu's optimizer inside, with
``best_metric`` None and an empty ``batch_stats``, and two arrays past the
1024-byte inline limit, so that their chunks lie in the process's data
file. ``expected.npz`` holds what rxtpu's ``load_checkpoint_orbax`` restores
from it, by dotted path, and ``expected.json`` its tree, each array named by
its path.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data/orbax_ocdbt/make_orbax_ocdbt.py
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np

from rxtpu.train.checkpoint import load_checkpoint_orbax, save_checkpoint_orbax
from rxtpu.train.optim import make_optimizer

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = {"conv": {"kernel": (3, 3, 2, 8)}, "dense": {"bias": (20,), "kernel": (24, 20)}}


def main() -> None:
    rng = np.random.RandomState(19)
    seeded = lambda shape: jnp.asarray(rng.standard_normal(shape).astype(np.float32))  # noqa
    params = jax.tree_util.tree_map(seeded, SHAPES, is_leaf=lambda x: isinstance(x, tuple))
    trace_state, schedule_state = make_optimizer(0.1, 2, 1).init(params)
    opt_state = (trace_state._replace(trace=jax.tree_util.tree_map(
                     lambda a: seeded(a.shape), trace_state.trace)),
                 schedule_state._replace(count=jnp.asarray(3, jnp.int32)))
    payload = {"params": params, "batch_stats": {}, "opt_state": opt_state,
               "step": jnp.asarray(3, jnp.int32), "epoch": 1, "batch_in_epoch": 2,
               "best_metric": None, "epochs_without_improvement": 0}
    path = os.path.join(HERE, "ckpt")
    shutil.rmtree(path, ignore_errors=True)
    save_checkpoint_orbax(path, payload)
    restored = load_checkpoint_orbax(path)
    arrays = {}

    def describe(tree, prefix):
        if isinstance(tree, dict):
            return {k: describe(v, f"{prefix}{k}.") for k, v in tree.items()}
        if isinstance(tree, list):
            return [describe(v, f"{prefix}{i}.") for i, v in enumerate(tree)]
        if tree is None:
            return None
        arrays[prefix[:-1]] = tree
        return prefix[:-1]

    with open(os.path.join(HERE, "expected.json"), "w") as f:
        json.dump(describe(restored, ""), f, indent=1, sort_keys=True)
    np.savez(os.path.join(HERE, "expected.npz"), **arrays)
    print(sorted(arrays), sum(os.path.getsize(os.path.join(d, n))
                              for d, _, names in os.walk(path) for n in names))


if __name__ == "__main__":
    main()
