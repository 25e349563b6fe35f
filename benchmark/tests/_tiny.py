"""Tiny configurations of the benchmark's cells for CPU tests (the
card's sizes stay in the configuration files)."""

import torch

from benchmark import common

TRAIN_CELL = "cifar10_sn_smmd_resnet.train"
SCORE_CELL = "cifar10_sn_smmd_resnet.score"
TRAIN4_CELL = "imagenet64_sn_smmd_multichip.train4"


def train_config(**kw):
    c = common.load_config("cifar10_sn_smmd_resnet")
    c.update(batch_size=8, real_batch_size=8, gf_dim=8, df_dim=8, dof_dim=4, z_dim=16,
             dataset_images=200, dsteps=2, compute_dtype="float32")
    c.update(kw)
    return c


def train4_config(**kw):
    """The ImageNet-64 cell's flags at 64 px with tiny widths, 2 rows a
    rank on 4 ranks."""
    c = common.load_config("imagenet64_sn_smmd_multichip")
    c.update(batch_size=8, real_batch_size=8, gf_dim=8, df_dim=8, dof_dim=4, z_dim=16,
             dataset_images=64, dsteps=2, steps_per_dispatch=2, compute_dtype="float32")
    c.update(kw)
    return c


def score_config(**kw):
    c = common.load_config("cifar10_sn_smmd_resnet")
    c.update(batch_size=8, real_batch_size=8, gf_dim=8, df_dim=8, z_dim=16, dataset_images=64,
             no_of_samples=16, score_subset_size=8, score_subsets=3, scheduler_test_size=8)
    c.update(kw)
    return c


class threads:
    """A few torch threads for the block (several test workers share the
    cores)."""

    def __init__(self, n=2):
        self.n = n

    def __enter__(self):
        self.saved = torch.get_num_threads()
        torch.set_num_threads(self.n)

    def __exit__(self, *exc):
        torch.set_num_threads(self.saved)
