"""What decides ``correct`` in a scoring cell.

The set-up event's outputs are judged against the plain reference
(``benchmark/reference``), after the window:

* ``image_gap``: on ``CHECK_ROWS`` rows drawn from the seed, the largest
  difference of a pixel between the program's samples and the reference
  generator's: the reference's own EMA shadow and BN averages after it
  has followed the set-up's macro-steps from the seed
  (``train_check.reference_readings``), in eval mode, from the same
  latents;
* ``feature_gap``: on those rows and as many rows of the real set, the
  largest relative L2 gap of a row of pool3 features or of class
  probabilities, the reference's Inception run on the program's images of
  those rows (held by ``image_gap``) and on the reference's own real rows;
* ``score_gap``: the largest relative gap of FID, KID and IS, the
  reference computing them in float64 from the program's features of the
  whole event.  The scores are a function of all 2 x ``no_of_samples``
  feature rows, so the reference follows this stage from the program's
  features, and the stage's own input is held by ``feature_gap``.

The three-sample scheduler test runs in every event and is timed, not
compared: its statistic, computed by the program from float32 Gram sums,
reads ~1e-5 from a float64 reference, and a control one precision below
(TF32 Grams) reads no more, so no limit would separate the two.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from benchmark.reference import gan
from benchmark.reference import inception as ref_inception
from benchmark import train_check as tc
from benchmark.score_cell import REAL_KEY


def _rel_rows(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(((a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-30)).max())


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def eval_weights(c: dict, t: dict, seed: int, data: np.ndarray, dev) -> Dict[str, torch.Tensor]:
    """The reference generator's eval weights after the set-up's
    macro-steps: the EMA shadow where the configuration keeps one."""
    st = tc.reference_readings(c, seed, data, t["train_steps"], dev).state
    return st.ema if st.ema is not None else st.gen


def compare(c: dict, t: dict, seed: int, data: np.ndarray, prog: dict, weights: str, dev
            ) -> Dict[str, float]:
    rows = prog["rows"]
    n, bs = c["no_of_samples"], c["batch_size"]
    gp = {k: v.detach() for k, v in eval_weights(c, t, seed, data, dev).items()}
    g = torch.Generator(device=dev).manual_seed(seed)
    zs = [torch.rand((bs, c["z_dim"]), generator=g, device=dev) * 2.0 - 1.0
          for _ in range(math.ceil(n / bs))]
    cast = gan.to_bf16 if c["compute_dtype"] == "bfloat16" else None
    made = {}
    with torch.no_grad():
        for chunk in sorted(set(int(r) // bs for r in rows)):
            made[chunk] = gan.generator(c, gp, zs[chunk], False, cast)
    ref_images = torch.stack([made[int(r) // bs][int(r) % bs] for r in rows]).float()
    image_gap = float((prog["images"].double() - ref_images.double().cpu()).abs().max())

    params = ref_inception.load(weights, dev)
    f_ref, p_ref = ref_inception.features(params, prog["images"].to(dev))
    real = gan.real_images(data, seed, REAL_KEY, n)[rows]
    fr_ref, _ = ref_inception.features(params, torch.from_numpy(real).to(dev))
    rows_t = torch.as_tensor(rows)
    feature_gap = max(_rel_rows(prog["feats"][rows_t], f_ref),
                      _rel_rows(prog["probs"][rows_t], p_ref),
                      _rel_rows(prog["real_feats"][rows_t], fr_ref))

    feats, probs, real_feats = (prog[k].to(dev) for k in ("feats", "probs", "real_feats"))
    with ref_inception.no_tf32():
        ref_scores = {"fid": ref_inception.fid(real_feats, feats),
                      "kid": ref_inception.kid(real_feats, feats,
                                               min(c["score_subset_size"], n), c["score_subsets"]),
                      "is": ref_inception.inception_score(probs)}
    score_gap = max(_rel(prog["scores"][k], ref_scores[k]) for k in ref_scores)
    out = {"image_gap": image_gap, "feature_gap": feature_gap, "score_gap": score_gap}
    return {k: (v if math.isfinite(v) else float("inf")) for k, v in out.items()}

