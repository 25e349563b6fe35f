"""Record the JAX package's three core dry-run modes that
``tests/test_torch_graft_entry.py`` holds the port's to.

    JAX_PLATFORMS=cpu python tests/fixtures/port_dryrun/make_fixtures.py

Needs the JAX package at this commit on 2 virtual CPU devices (the script
asks XLA for 8, as ``tests/conftest.py`` does).  For each core mode of
``__graft_entry__.py`` (``gspmd``, ``shard_map+ring``, ``shard_map+ring
tmmd``) on ``_dryrun_ctx(2)``'s config and macro-batch: the state
``create_state(PRNGKey(0))`` gives, the draws of its one macro-step
rebuilt from the state key (``_torch_parity.jax_draws`` for GSPMD, the
per-rank ``dp_draws`` for shard_map), and the metrics of
``jit_train_step`` on a 2-device sub-mesh.  ``reference.npz`` holds the
arrays, ``reference.json`` the metrics and the layout; the test reads
them back, starts the port's modes from those states and draws, and holds
their metrics to JAX's.  Rerun after a change to the JAX package's step or
dry run.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
NPZ = os.path.join(HERE, "reference.npz")
LAYOUT = os.path.join(HERE, "reference.json")
N = 2


def _state_key(jcfg) -> str:
    """The ring mode changes no weight: one state per network pair."""
    return "sn" if jcfg.with_sn else "plain"


def load(core_cfgs) -> dict:
    """``{mode name: dict(state=JAX TrainState, noise=[rank draws],
    metrics)}`` for ``core_cfgs`` (name, JAX config, mode), each state
    rebuilt on ``jax.eval_shape``'s structure of ``create_state``."""
    import jax
    import numpy as np
    from smmdax import train as jtrain
    with open(LAYOUT) as f:
        layout = json.load(f)
    arrays = np.load(NPZ)
    out = {}
    for name, jcfg, _ in core_cfgs:
        rec = layout["modes"][name]
        key = _state_key(jcfg)
        shapes = jax.eval_shape(lambda k: jtrain.create_state(jcfg, k), jax.random.PRNGKey(0))
        leaves = [arrays[f"state/{key}/{j}"] for j in range(layout["states"][key])]
        noise = [{d: [arrays[f"{name}/noise{r}/{d}/{j}"] for j in range(n)]
                  for d, n in draws.items()} for r, draws in enumerate(rec["noise"])]
        out[name] = dict(state=jax.tree.unflatten(jax.tree.structure(shapes), leaves),
                         noise=noise, metrics=rec["metrics"])
    return out


def main() -> None:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    import __graft_entry__ as jentry
    import test_torch_graft_entry as t
    from _torch_parity import dp_draws, jax_draws, jax_state
    from smmdax import train as jtrain
    jctx = jentry._dryrun_ctx(N)
    mesh, real = jctx["mesh"], jctx["real"]
    arrays, layout = {}, {"states": {}, "modes": {}}
    for name, jcfg, mode in t._core_cfgs(jctx["cfg"]):
        js = jax_state(jcfg)
        key = _state_key(jcfg)
        leaves = jax.tree.leaves(js)
        if key not in layout["states"]:
            layout["states"][key] = len(leaves)
            for j, leaf in enumerate(leaves):
                arrays[f"state/{key}/{j}"] = np.asarray(leaf)
        else:   # the modes of one network pair start from one state
            assert all(np.array_equal(arrays[f"state/{key}/{j}"], leaf)
                       for j, leaf in enumerate(leaves))
        if mode == "shard_map":
            noise = dp_draws(jcfg, jnp.asarray(js.rng), 1, 1, N)
        else:
            noise = [jax_draws(jcfg, jnp.asarray(js.rng), 1, 1)] * N
        step = jtrain.jit_train_step(jcfg, 1, 1, mesh=mesh, mode=mode or "gspmd")
        _, m = step(jax.device_put(js, NamedSharding(mesh, P())), real)
        rec = dict(metrics={k: float(v) for k, v in m.items()}, noise=[])
        for r, draws in enumerate(noise):
            rec["noise"].append({d: len(v) for d, v in draws.items()})
            for d, v in draws.items():
                for j, a in enumerate(v):
                    arrays[f"{name}/noise{r}/{d}/{j}"] = np.asarray(a)
        layout["modes"][name] = rec
    np.savez_compressed(NPZ, **arrays)
    with open(LAYOUT, "w") as f:
        json.dump({"generator": "tests/fixtures/port_dryrun/make_fixtures.py", **layout}, f,
                  indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
