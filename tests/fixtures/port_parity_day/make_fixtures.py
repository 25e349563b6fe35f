"""Record the JAX package's ``tools/parity_day.py`` report on the happy
path that ``tests/test_torch_parity_day.py`` holds the port's tool to.

    python tests/fixtures/port_parity_day/make_fixtures.py

Needs the JAX package at this commit (JAX on the CPU).  ``happy_inputs``
writes the inputs (fixture CIFAR-10 batches, random Inception weights
from seed 5, a reference tree with two stub files, 48 generated samples)
into a directory; the JAX tool scores ``SCORE_N`` images of each set on
them, and ``manifest.json`` keeps its (check, status, detail) rows with
the directory's paths replaced by ``{reference}``, ``{data_dir}`` and
``{samples}``.  The test writes the same inputs, runs the port's tool, and
reads the JAX rows back with its own paths filled in.  Rerun after a
change to the JAX tool, its scoring, or the inputs.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
MANIFEST = os.path.join(HERE, "manifest.json")

# images of each scored set: the real halves and the samples (at 16 the
# two 2,048-d covariances are of rank 15; the FID and KID tolerances of
# the test hold the port there as at 48)
SCORE_N = 16


def happy_inputs(root: str) -> tuple:
    """Write the happy path's inputs under ``root``: ((reference,
    data_dir), samples path)."""
    sys.path.insert(0, ROOT)
    from smmdax_torch.eval.inception import random_state_dict
    from tests.test_real_loaders import _write_cifar10
    data_dir = os.path.join(root, "data")
    os.makedirs(data_dir)
    _write_cifar10(data_dir)
    np.savez(os.path.join(data_dir, "inception_v3.npz"),
             **random_state_dict(seed=5, include_aux=False))
    ref = os.path.join(root, "reference")
    os.makedirs(os.path.join(ref, "core"))
    with open(os.path.join(ref, "main.py"), "w") as f:
        f.write("# reference stub\n")
    with open(os.path.join(ref, "core", "mmd.py"), "w") as f:
        f.write("# reference stub\n")
    samples = os.path.join(root, "gen.npy")
    rng = np.random.default_rng(0)
    np.save(samples, rng.uniform(-1, 1, (48, 32, 32, 3)).astype(np.float32))
    return (ref, data_dir), samples


def _paths(args: tuple, samples: str) -> list:
    # the longest first: data_dir and samples lie beside the reference tree
    return sorted([(samples, "{samples}"), (args[1], "{data_dir}"), (args[0], "{reference}")],
                  key=lambda p: -len(p[0]))


def recorded_report(args: tuple, samples: str) -> list:
    """The JAX tool's recorded rows, with this run's paths filled in."""
    with open(MANIFEST) as f:
        rows = json.load(f)["report"]
    out = []
    for check, status, detail in rows:
        for path, key in _paths(args, samples):
            detail = detail.replace(key, path)
        out.append((check, status, detail))
    return out


def main() -> None:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import parity_day as jax_tool
    with tempfile.TemporaryDirectory() as root:
        args, samples = happy_inputs(root)
        report = jax_tool.run(*args, samples_path=samples, score_n=SCORE_N)
        rows = []
        for check, status, detail in report:
            for path, key in _paths(args, samples):
                detail = detail.replace(path, key)
            rows.append([check, status, detail])
    with open(MANIFEST, "w") as f:
        json.dump({"generator": "tests/fixtures/port_parity_day/make_fixtures.py",
                   "score_n": SCORE_N, "report": rows}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
