"""The benchmark of ``smmdax_torch`` on NVIDIA cards.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``<cell>`` is a ``workloads`` entry of
``BENCHMARK.json``; its configuration and traffic are the files
``benchmark/configs/<config>.json`` and ``benchmark/traffic/<traffic>.json``,
and the traffic's ``kind`` names the driver, ``benchmark/<kind>_cell.py``
(``train_cell``, ``score_cell``; ``train4_cell``, whose cards belong to rank
processes, ``benchmark.ranks``): a new kind of cell is a new file.  The
last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones, each read by
``benchmark/metrics/<metric>.py``), ``device`` and, traced,
``breakdown``; then ``checks``, each compared number beside its limit,
which also end standard error.  Without a card, with fewer cards than the
cell asks for, or with a module of the JAX stack loaded once the window
has closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    # run as a script: the checkout's root holds the packages
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import common  # noqa: E402


def _caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own CUDA build already sits in ``smmdax_torch/_build``)."""
    cache = os.path.join(common.HERE, "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def drive(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
          config: dict = None) -> dict:
    """One run of cell ``name``: the result's fields and its checks.
    ``device="cpu"`` with a small ``config`` is the rehearsal the tests
    use; the command always runs on the card."""
    bench = common.benchmark_file()
    cell = common.find(bench["workloads"], name, "workload")
    c = config if config is not None else common.load_config(cell["config"])
    t = common.load_traffic(cell["traffic"])
    if not common.has_cell_module(t["kind"]):
        raise common.Refused(f"traffic {cell['traffic']!r} has an unknown kind {t['kind']!r}")
    driver = importlib.import_module(f"benchmark.{t['kind']}_cell")
    # refuse before set-up what the reference that decides `correct` cannot follow
    from benchmark.reference import gan
    try:
        gan.arch(c)
        gan.check_objective(c)
    except ValueError as e:
        raise common.Refused(str(e)) from None
    peaks = None
    if device == "cuda":
        import torch
        peaks = common.PEAKS.get(torch.cuda.get_device_name(0))
    out = driver.run({"config": c, "traffic": t, "seed": seed, "seconds": seconds,
                      "trace": trace, "device": device, "chips": cell["chips"],
                      "peaks": peaks, "t0": T0})
    metrics = {}
    for m in common.cell_metrics(bench, name, trace):
        if trace:
            value = common.read_metric(m["name"], out["run"]) if device == "cuda" else None
        elif m["name"] == "setup_s":
            value = out["setup_s"]
        else:
            value = out["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = dict(out["device"])
    result = {"correct": all(v["value"] <= v["limit"] for v in out["checks"].values()),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    if trace and out["extra"]:
        device_info["busy_s"] = out["extra"]["busy_s"]
        device_info["window_s"] = out["extra"]["window_s"]
        result["breakdown"] = out["extra"]["breakdown"]
    return {"result": result, "checks": out["checks"]}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        raise common.Refused("--seed must be a whole number >= 0")
    bench = common.benchmark_file()
    cell = common.find(bench["workloads"], args.workload, "workload")
    _caches()
    common.check_device(cell["chips"])
    out = drive(args.workload, args.seed, args.seconds, bool(args.trace))
    common.emit(out["result"], out["checks"])


if __name__ == "__main__":
    main()
