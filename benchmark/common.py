"""What every cell of the benchmark shares: the files it is driven by,
the device checks, the peak table, the per-layer metric readers and the
result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``benchmark/configs/<config>.json``: the configuration as it is run;
* ``benchmark/traffic/<traffic>.json``: the parameters of a traffic mix;
* ``benchmark/metrics/<metric>.py``: ``read(run)``, one per-layer metric;
* ``benchmark/reference/arch/<architecture>.py``: the plain reference
  networks of a configuration's ``"architecture"``
  (``benchmark/reference/arch/__init__.py`` states what such a file
  defines).
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# published dense peaks of one card, by torch.cuda.get_device_name():
# bfloat16 tensor-core FLOP/s, float32 FLOP/s outside the tensor cores,
# HBM bytes/s (NVIDIA H100 SXM5 data sheet, at its 700 W limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.4e12, "fp32": 67e12, "hbm": 3.35e12},
}

# the JAX reference package and its stack: never loaded by a run
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "smmdax")


class Refused(SystemExit):
    """A run that prints no result: the message goes to standard error."""

    def __init__(self, msg: str):
        super().__init__(f"benchmark: {msg}")


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark_file() -> dict:
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(path):
        raise Refused(f"no BENCHMARK.json beside {HERE}")
    return load_json(path)


def find(items: List[dict], name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise Refused(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(name: str) -> dict:
    return load_json(os.path.join(HERE, "configs", f"{name}.json"))


def load_traffic(name: str) -> dict:
    return load_json(os.path.join(HERE, "traffic", f"{name}.json"))


def has_cell_module(kind: str) -> bool:
    """Whether a traffic ``kind`` has its cell module, ``benchmark/<kind>_cell.py``."""
    return os.path.exists(os.path.join(HERE, f"{kind}_cell.py"))


def port_config(c: dict, seed: int):
    """The port's ``Config`` from a configuration file: every key of the
    file that is a ``Config`` field, the seed as ``random_seed``."""
    import dataclasses
    from smmdax_torch.configs import Config
    fields = {f.name for f in dataclasses.fields(Config)}
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in c.items() if k in fields}
    return Config(**kw).replace(random_seed=seed)


def check_device(chips: int) -> None:
    """Refuse to run without ``chips`` CUDA cards."""
    import torch
    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is False: the benchmark runs on a card")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards, {torch.cuda.device_count()} are visible")


def device_info(chips: int, dev, peaks: Optional[List[int]] = None) -> Dict[str, Any]:
    """The result's ``device``: the cards and the peak on the fullest, or
    the CPU of a rehearsal.  ``peaks``: each card's peak as the processes
    that used it read it (the ranks of a ``train4`` cell), read in this
    process when None."""
    import torch
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if peaks is None:
        peaks = [torch.cuda.max_memory_allocated(i) for i in range(chips)]
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(max(peaks))}


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit; one that is not finite reads
    1e300 (JSON has no infinity)."""
    return {k: {"value": numbers[k] if math.isfinite(numbers[k]) else 1e300, "limit": limits[k]}
            for k in limits}


def loaded_forbidden() -> List[str]:
    """Modules of the JAX stack in ``sys.modules``, by whole top-level name."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES})


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}

    def held(m: dict) -> bool:
        return cell in m["workloads"] if "workloads" in m else m["moves"] in moved

    return [m for m in bench["per_layer"] if held(m)]


def read_metric(name: str, run: dict) -> Optional[float]:
    """``benchmark/metrics/<name>.py``'s ``read(run)``: a number, or None
    when the run holds nothing for it to read."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(run)
    if value is None:
        return None
    value = float(value)
    return value if math.isfinite(value) else None


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """The comparisons on the last lines of standard error, then the
    result as the last line of standard output, ``checks`` last in it."""
    bad = loaded_forbidden()
    if bad:
        raise Refused("modules of the JAX stack were loaded: " + ", ".join(bad))
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}), flush=True)
