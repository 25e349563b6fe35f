"""Asset-day parity protocol, executable, on the port.

The counterpart of the JAX package's ``tools/parity_day.py``: the same
checks, statuses and order, and the same flags, built on the port's parts
(``eval.features.find_inception_weights`` and ``InceptionFeatures`` on
``--device``, ``data.make_dataset``, ``eval.fid_from_features`` and
``kid_from_features``).  The reference mount is empty and no real dataset
or Inception weights can be fetched, so true reference parity waits on
assets; this makes that day one command:

    python -m smmdax_torch.tools.parity_day [--reference ./reference]
        [--data_dir ./data] [--samples S.npy] [--score_n 2000] [--json]
        [--device cuda]

It checks each parity prerequisite, runs every check whose assets exist,
and prints a PASS / BLOCKED report:

1. **Reference mount**: if populated, lists the tree, flags the files
   SURVEY.md §2 expects and names the verify-on-mount protocol.
2. **Inception weights**: ``data_dir/inception_v3.{pt,pth,npz}`` or the
   frozen TF graph (``classify_image_graph_def.pb``), loaded through the
   port's network on ``device``; reports the fc width and the detected
   FID-graph semantics, and extracts features of a probe.
3. **Real datasets**: per dataset, whether real assets resolve (and not
   the synthetic fallback).
4. **Real-data FID/KID self-check**: with weights and real CIFAR-10,
   FID/KID between two disjoint draws of the real data, and with
   ``--samples`` (an .npy of generated images) model against data.

Detail texts that name the JAX package's files keep naming them: those
files are the protocol's targets.  The device is ``cuda`` unless the caller
passes ``cpu``; without a card it raises instead of falling back.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Tuple

# files SURVEY.md §2 expects in the reference tree (names are [R-MED]:
# presence is informative, absence of a particular name is not fatal)
EXPECTED_REFERENCE_FILES = (
    "main.py", "core/model.py", "core/mmd.py", "core/architecture.py",
    "core/resnet.py", "core/ops.py", "core/pipeline.py", "core/utils.py",
    "compute_scores.py",
)
DATASET_SIZES = {"cifar10": 32, "imagenet64": 64, "celeba": 160, "lsun": 64}

Status = Tuple[str, str, str]          # (name, PASS|BLOCKED|INFO, detail)


def check_reference_mount(reference: str) -> List[Status]:
    out: List[Status] = []
    if not os.path.isdir(reference):
        out.append(("reference-mount", "BLOCKED",
                    f"{reference} does not exist"))
        return out
    tree = []
    for root, _dirs, files in os.walk(reference):
        for f in files:
            tree.append(os.path.relpath(os.path.join(root, f), reference))
    if not tree:
        out.append(("reference-mount", "BLOCKED",
                    f"{reference} is EMPTY (the round-1..3 state; see "
                    "SURVEY.md provenance warning). When populated, re-run "
                    "this tool FIRST, before any other parity work."))
        return out
    out.append(("reference-mount", "PASS",
                f"{len(tree)} files present — EXECUTE THE VERIFY-ON-MOUNT "
                "PROTOCOL (SURVEY.md §0.2): re-derive the §2 inventory, "
                "replace [R-*] claims with file:line citations, swap the "
                "tests/test_tf_parity.py oracle for the real core/mmd.py"))
    found = [f for f in EXPECTED_REFERENCE_FILES if f in set(tree)]
    missing = [f for f in EXPECTED_REFERENCE_FILES if f not in set(tree)]
    out.append(("reference-inventory", "INFO",
                f"expected files present: {found or 'none'}; "
                f"not found under expected names: {missing or 'none'} "
                "(names were reconstructed [R-MED] — check the actual tree)"))
    mmd_py = next((f for f in tree if f.endswith("mmd.py")), None)
    if mmd_py:
        out.append(("reference-loss-oracle", "INFO",
                    f"loss parity target: {mmd_py} — port its kernel "
                    "constants into tests/test_tf_parity.py and re-run "
                    "`pytest tests/test_tf_parity.py` (the current oracle "
                    "is our own TF re-expression of the paper math)"))
    return out


def check_inception_weights(data_dir: str, device="cuda") -> List[Status]:
    from smmdax_torch.eval.features import find_inception_weights
    path = find_inception_weights(data_dir)
    if path is None:
        return [("inception-weights", "BLOCKED",
                 f"no inception_v3.(pt|pth|npz) or "
                 f"classify_image_graph_def.pb under {data_dir}; drop a "
                 "torchvision inception_v3 state dict OR the frozen TF "
                 "FID graph itself (the file the reference's "
                 "compute_scores.py downloads) there to enable real "
                 "FID/KID/IS")]
    out: List[Status] = []
    try:
        import numpy as np

        from smmdax_torch.eval.features import InceptionFeatures
        ext = InceptionFeatures(path, device=device)
        probe = np.zeros((2, 64, 64, 3), np.float32)
        feats, probs = ext.features_and_probs(probe)
        net = ext._net
        out.append(("inception-weights", "PASS",
                    f"{path}: pool3 dim {feats.shape[1]}, fc width "
                    f"{probs.shape[1]}, fid_semantics="
                    f"{getattr(net, 'fid_semantics', 'n/a')}"))
    except Exception as e:
        out.append(("inception-weights", "BLOCKED",
                    f"{path} failed to load: {e!r}"))
    return out


def check_datasets(data_dir: str) -> List[Status]:
    from smmdax_torch.configs import Config
    from smmdax_torch.data import SyntheticImages, make_dataset
    out: List[Status] = []
    for ds, size in DATASET_SIZES.items():
        cfg = Config(dataset=ds, output_size=size, data_dir=data_dir)
        try:
            src = make_dataset(cfg)
        except (ValueError, FileNotFoundError) as e:
            out.append((f"dataset-{ds}", "BLOCKED", str(e)))
            continue
        if isinstance(src, SyntheticImages):
            out.append((f"dataset-{ds}", "BLOCKED",
                        f"no real {ds} assets under {data_dir} "
                        "(synthetic fallback would be used)"))
        else:
            out.append((f"dataset-{ds}", "PASS",
                        f"{type(src).__name__}, sample {src.sample_shape}"))
    return out


def real_data_score_check(data_dir: str, dataset: str = "cifar10",
                          n: int = 2000, samples_path: str | None = None,
                          device="cuda") -> List[Status]:
    """FID/KID with the real extractor on real data: two disjoint real
    halves (self-check: FID small, KID ~ 0 within noise), plus the
    model-vs-data score when ``samples_path`` is given."""
    from smmdax_torch.configs import Config
    from smmdax_torch.data import SyntheticImages, make_dataset
    from smmdax_torch.eval import fid_from_features, kid_from_features
    from smmdax_torch.eval.features import InceptionFeatures, find_inception_weights
    wpath = find_inception_weights(data_dir)
    if wpath is None:
        return [("real-fid-kid", "BLOCKED", "no Inception weights (above)")]
    size = DATASET_SIZES.get(dataset, 32)
    cfg = Config(dataset=dataset, output_size=size, data_dir=data_dir)
    src = make_dataset(cfg)
    if isinstance(src, SyntheticImages):
        return [("real-fid-kid", "BLOCKED",
                 f"no real {dataset} assets (above)")]
    import numpy as np
    ext = InceptionFeatures(wpath, device=device)
    a = ext(src.batch(n, key=101))
    b = ext(src.batch(n, key=202))
    fid = fid_from_features(a, b)
    kid, kid_std = kid_from_features(a, b, subset_size=min(1000, n),
                                     n_subsets=10)
    out = [("real-fid-kid-selfcheck", "PASS",
            f"{dataset} half-vs-half: FID {fid:.3f}, KID {kid:.6f} "
            f"+- {kid_std:.6f} (expect FID small, KID ~ 0: the pipeline "
            "is consistent end-to-end on real data)")]
    if samples_path:
        if not os.path.exists(samples_path):
            out.append(("model-fid-kid", "BLOCKED",
                        f"{samples_path} not found"))
            return out
        imgs = np.load(samples_path)
        if imgs.dtype == np.uint8:
            imgs = imgs.astype(np.float32) / 127.5 - 1.0
        f = ext(imgs)
        fid_m = fid_from_features(a, f)
        kid_m, kid_m_std = kid_from_features(a, f, subset_size=min(1000, n),
                                             n_subsets=10)
        out.append(("model-fid-kid", "PASS",
                    f"model vs {dataset}: FID {fid_m:.3f}, KID {kid_m:.6f} "
                    f"+- {kid_m_std:.6f} — compare against the paper table "
                    "(SURVEY.md §6) / reference runs"))
    return out


def run(reference: str, data_dir: str, samples_path: str | None = None,
        score_n: int = 2000, device="cuda") -> List[Status]:
    from smmdax_torch.train import resolve_device
    device = resolve_device(device)
    report: List[Status] = []
    report += check_reference_mount(reference)
    report += check_inception_weights(data_dir, device=device)
    report += check_datasets(data_dir)
    report += real_data_score_check(data_dir, samples_path=samples_path,
                                    n=score_n, device=device)
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reference", default="./reference")
    p.add_argument("--data_dir", default="./data")
    p.add_argument("--samples", default=None,
                   help=".npy of generated images for model-vs-data scores")
    p.add_argument("--score_n", type=int, default=2000)
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where Inception runs (default cuda; no fallback to the CPU)")
    a = p.parse_args(argv)
    report = run(a.reference, a.data_dir, samples_path=a.samples,
                 score_n=a.score_n, device=a.device)
    if a.json:
        print(json.dumps([{"check": c, "status": s, "detail": d}
                          for c, s, d in report]))
    else:
        width = max(len(c) for c, _, _ in report)
        print("=" * 72)
        print("smmdax parity-day report")
        print("=" * 72)
        for c, s, d in report:
            print(f"{c:<{width}}  [{s:^7}]  {d}")
        blocked = sum(1 for _, s, _ in report if s == "BLOCKED")
        passed = sum(1 for _, s, _ in report if s == "PASS")
        print("-" * 72)
        print(f"{passed} PASS, {blocked} BLOCKED "
              f"({'nothing further is runnable today' if blocked else 'all parity checks executed'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
