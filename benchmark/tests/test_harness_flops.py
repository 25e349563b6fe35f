"""Each frozen FLOP count of a configuration file, recounted over the
reference on meta tensors."""

import pytest

from benchmark import common, flops

CONFIGS = [c["name"] for c in common.benchmark_file()["configs"]]


@pytest.mark.parametrize("name", CONFIGS)
def test_macro_step_flops(name):
    c = common.load_config(name)
    assert flops.macro_step_flops(c) == c["flops_per_macro_step"]


@pytest.mark.parametrize("name", [n for n in CONFIGS
                                  if "sample_flops_per_image" in common.load_config(n)])
def test_scoring_flops(name):
    c = common.load_config(name)
    assert flops.sample_flops_per_image(c) == c["sample_flops_per_image"]
    assert flops.inception_flops_per_image() == c["inception_flops_per_image"]


def test_mmd_bound_counts_three_pair_sums_and_their_gradients():
    one = flops.bound_ms("fwd", 4096, 4096, 16, False, "rq", (0.2, 0.5, 1.0, 2.0, 5.0))
    assert 0 < one < flops.mmd2_bound_ms(4096, 16, "rq", (0.2, 0.5, 1.0, 2.0, 5.0))
