"""Evaluation: FID / KID / Inception Score (port of ``smmdax/eval``): the
Inception-v3 network and its weight converters (torchvision state dicts,
the frozen TF FID graph), random-conv features and the score math.  KID
is the unbiased MMD^2 with the polynomial kernel k(x,y) = (x.y/d + 1)^3
averaged over subsets."""

from smmdax_torch.eval.scores import (  # noqa: F401
    frechet_distance,
    fid_from_features,
    polynomial_mmd,
    kid_from_features,
    inception_score,
    gaussian_stats,
    use_device_scoring,
)
from smmdax_torch.eval.features import (  # noqa: F401
    FeatureExtractor,
    InceptionFeatures,
    RandomConvFeatures,
    extract_features,
    extract_with_probs,
    find_inception_weights,
    get_feature_extractor,
)
