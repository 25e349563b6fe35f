"""Record the JAX package's GSPMD steps that ``tests/test_torch_gspmd.py``
holds the port's steps over ranks to.

    JAX_PLATFORMS=cpu python tests/fixtures/port_gspmd/make_fixtures.py

Needs the JAX package at this commit on 2 virtual CPU devices (the script
asks XLA for 8, as ``tests/conftest.py`` does).  For every case of the
test (``CASES``: the configs and their batches), the JAX side: the initial ``create_state`` of each
network pair, the draws of each step rebuilt from the state key
(``_torch_parity.jax_draws``), and ``jit_train_step(mode="gspmd")`` on a
2-device mesh, its metrics and its final parameters and generator batch
statistics.  ``reference.npz`` holds the arrays (``reference.json`` the
metrics and the layout); the test reads them back and runs only the port.
Rerun after a change to the JAX package's step or to the test's cases.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
NPZ = os.path.join(HERE, "reference.npz")
LAYOUT = os.path.join(HERE, "reference.json")


def _init_key(jcfg) -> str:
    """The initial state a case starts from: one per network pair (the
    losses without spectral norm share their weights)."""
    return "sn" if jcfg.with_sn else "plain"


def _initial_state(jcfg):
    """The JAX state a case starts from (the non-SN losses from mmd's)."""
    from _torch_parity import jax_state
    if not jcfg.with_sn:
        jcfg = jcfg.replace(model="mmd", gradient_penalty=0.0)
    return jax_state(jcfg)


def _jax_run(jcfg, js, reals, n: int):
    """JAX's GSPMD steps on an n-device mesh: each step's draws (rebuilt
    from the state key it starts from), metrics, and the final state."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from _torch_parity import jax_draws
    from smmdax import train as jtrain
    mesh = jtrain.make_mesh(n)
    step = jtrain.jit_train_step(jcfg, jcfg.dsteps, jcfg.gsteps, mesh=mesh, mode="gspmd")
    # replicated from the start, as the step returns it: one compile
    state = jax.device_put(js, NamedSharding(mesh, P()))
    noises, metrics = [], []
    for real in reals:
        noises.append(jax_draws(jcfg, state.rng, jcfg.dsteps, jcfg.gsteps))
        state, m = step(state, jnp.asarray(real))
        metrics.append({k: float(v) for k, v in m.items()})
    return noises, metrics, jax.tree.map(np.asarray, state)


def load(test_module) -> dict:
    """The recorded reference: ``initial`` (the JAX TrainState of each
    network pair, rebuilt on ``jax.eval_shape``'s structure) and per case
    ``noises``, ``metrics`` and ``next`` (flattened ``d_params``,
    ``g_params``, ``g_batch_stats``)."""
    import jax
    import numpy as np
    from smmdax import train as jtrain
    with open(LAYOUT) as f:
        layout = json.load(f)
    arrays = np.load(NPZ)
    initial = {}
    for i, case in enumerate(test_module.CASES):
        jcfg, _ = test_module._cfgs(*case)
        key = _init_key(jcfg)
        if key in initial:
            continue
        shapes = jax.eval_shape(lambda k: jtrain.create_state(jcfg, k), jax.random.PRNGKey(0))
        treedef = jax.tree.structure(shapes)
        leaves = [arrays[f"initial/{key}/{j}"] for j in range(layout["initial"][key])]
        initial[key] = jax.tree.unflatten(treedef, leaves)
    cases = []
    for i, rec in enumerate(layout["cases"]):
        noises = [{name: [arrays[f"case{i}/noise{s}/{name}/{j}"] for j in range(n)]
                   for name, n in step.items()} for s, step in enumerate(rec["noises"])]
        nxt = {part: {name: arrays[f"case{i}/next/{part}/{name}"] for name in names}
               for part, names in rec["next"].items()}
        cases.append(dict(noises=noises, metrics=rec["metrics"], next=nxt))
    return dict(initial=initial, cases=cases)


def main() -> None:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import jax
    import numpy as np
    import test_torch_gspmd as t
    from smmdax_torch import convert
    arrays, layout = {}, {"initial": {}, "cases": []}
    for i, case in enumerate(t.CASES):
        jcfg, _ = t._cfgs(*case)
        js = _initial_state(jcfg)
        key = _init_key(jcfg)
        leaves = jax.tree.leaves(js)
        if key not in layout["initial"]:
            layout["initial"][key] = len(leaves)
            for j, leaf in enumerate(leaves):
                arrays[f"initial/{key}/{j}"] = np.asarray(leaf)
        else:   # the cases of one network pair start from one state
            assert all(np.array_equal(arrays[f"initial/{key}/{j}"], leaf)
                       for j, leaf in enumerate(leaves))
        reals = t._batches(jcfg, 30 + 10 * i)
        noises, metrics, nxt = _jax_run(jcfg, js, reals, t.N)
        rec = dict(metrics=metrics, noises=[], next={})
        for s, step in enumerate(noises):
            rec["noises"].append({name: len(v) for name, v in step.items()})
            for name, v in step.items():
                for j, a in enumerate(v):
                    arrays[f"case{i}/noise{s}/{name}/{j}"] = np.asarray(a)
        for part in ("d_params", "g_params", "g_batch_stats"):
            flat = convert.flatten(getattr(nxt, part))
            rec["next"][part] = sorted(flat)
            for name, a in flat.items():
                arrays[f"case{i}/next/{part}/{name}"] = np.asarray(a)
        layout["cases"].append(rec)
    np.savez_compressed(NPZ, **arrays)
    with open(LAYOUT, "w") as f:
        json.dump({"generator": "tests/fixtures/port_gspmd/make_fixtures.py", **layout}, f,
                  indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
