"""Configuration of the PyTorch port: a copy of ``smmdax.configs.Config``
and of its command line.

Same field names, defaults and validation as the JAX package, so a JAX
``Config`` translates field for field (``Config(**dataclasses.asdict(c))``),
and ``build_argparser`` gives the same flags as the JAX CLI.  One default
differs: ``pallas_min_rows`` is 0, so ``use_pallas="auto"`` takes the
hand-written CUDA pair-sum kernels at every size on the card (the JAX
default of 4096 rows is a TPU crossover; on the H100 the fused path is
faster than the dense one at every size from 64 to 4096 rows, PERF.md).
The fields keep their JAX names: ``use_pallas`` selects the fused CUDA
path here.

``num_data_shards``, ``dp_mode``, ``global_batch_mmd`` and
``use_ring_mmd`` are honoured as in the JAX package: the launcher
(``python -m smmdax_torch.main``) starts one rank per shard and card, the
step runs in GSPMD or shard_map mode, the ring estimators serve the losses
in shard_map mode, and ``use_ring_mmd`` implies it.  The trainer
(``smmdax_torch.trainer``) reads the scoring, scheduler and dispatch
fields and the data placement, the pool whole or sharded over the ranks.
``remat`` runs the critic under activation checkpointing.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

DEFAULT_RBF_SIGMAS: Tuple[float, ...] = (1.0, 2.0, 4.0, 8.0, 16.0)
DEFAULT_RQ_ALPHAS: Tuple[float, ...] = (0.2, 0.5, 1.0, 2.0, 5.0)

LOSSES = ("mmd", "tmmd", "smmd", "sn-smmd", "wgan-gp")
KERNELS = ("gaussian", "rq", "dot", "distance")
ARCHS = ("dcgan", "resnet", "mlp")
DATASETS = ("cifar10", "celeba", "imagenet64", "lsun", "mnist",
            "gaussian_mix", "synthetic")
SCALING_VARIANTS = ("grad", "value_and_grad")
GRAD_ESTIMATORS = ("exact", "sum", "hutchinson")
GP_VARIANTS = ("one_sided", "two_sided")


@dataclass(frozen=True)
class Config:
    # --- model selection -------------------------------------------------
    model: str = "mmd"              # mmd|tmmd|smmd|sn-smmd|wgan-gp
    kernel: str = "rq"              # gaussian|rq|dot|distance
    architecture: str = "dcgan"     # dcgan|resnet|mlp
    dataset: str = "cifar10"

    # --- shapes -----------------------------------------------------------
    batch_size: int = 64            # generated (fake) batch per update
    real_batch_size: int = 64       # real batch per update
    output_size: int = 32           # image H=W
    c_dim: int = 3
    z_dim: int = 128
    gf_dim: int = 64
    df_dim: int = 64
    dof_dim: int = 16               # critic feature dim (MMD acts on this)

    # --- optimization -----------------------------------------------------
    learning_rate: float = 1e-4
    g_learning_rate: Optional[float] = None
    d_learning_rate: Optional[float] = None
    beta1: float = 0.5
    beta2: float = 0.9
    dsteps: int = 5
    gsteps: int = 1
    start_dsteps: int = 10
    warmup_iterations: int = 500
    max_iteration: int = 150_000
    ema_decay: float = 0.0          # generator weight + BN-stats EMA (0 = off)
    ema_eval_compare: bool = False

    # --- regularizers -----------------------------------------------------
    gradient_penalty: float = 0.0
    gp_variant: str = "one_sided"
    gp_detach_sets: bool = False
    L2_discriminator_penalty: float = 0.0
    with_scaling: bool = False      # set by model=smmd / sn-smmd
    scaling_coeff: float = 10.0
    scaling_variant: str = "grad"
    scaling_grad_estimator: str = "exact"   # exact | sum | hutchinson
    with_sn: bool = False           # set by model=sn-smmd
    sn_iters: int = 1

    # --- kernel mixture constants ------------------------------------------
    rbf_sigmas: Tuple[float, ...] = DEFAULT_RBF_SIGMAS
    rq_alphas: Tuple[float, ...] = DEFAULT_RQ_ALPHAS
    kernel_add_dot: float = 0.0     # rq only: add w*<x,y> to the mixture

    # --- LR scheduling ------------------------------------------------------
    MMD_lr_scheduler: bool = True
    three_sample_test: str = "pvalue"
    scheduler_p_threshold: float = 0.1
    scheduler_test_size: int = 5000
    scheduler_test_subsets: int = 1
    scheduler_patience: int = 3
    decay_rate: float = 0.8
    lr_decay_steps: int = 0
    reload_best_on_decay: bool = False

    # --- eval / scoring -----------------------------------------------------
    compute_scores: bool = False
    score_every: int = 2000
    no_of_samples: int = 25_000
    score_subset_size: int = 1000
    score_subsets: int = 50

    # --- parallelism and execution -----------------------------------------
    num_data_shards: int = 1
    dp_mode: str = "gspmd"
    global_batch_mmd: bool = True
    use_ring_mmd: bool = False
    use_pallas: str = "auto"        # fused CUDA pair-sum path: on | off | auto
    pallas_min_rows: int = 0        # auto: fused when max(m, n) >= this
    fuse_critic_batches: bool = False
    steps_per_dispatch: int = 1
    compute_dtype: str = "float32"  # or bfloat16
    remat: bool = False
    uint8_transfer: bool = True
    on_device_data: bool = False
    data_placement: str = "host"
    device_data_pool: int = 50000
    device_data_sharding: str = "replicated"
    rss_limit_gb: float = 0.0
    auto_restart: bool = False

    # --- observability ------------------------------------------------------
    debug_nans: bool = False
    profile_steps: int = 0
    profile_start: int = 10
    tensorboard: bool = False

    # --- bookkeeping --------------------------------------------------------
    is_train: bool = True
    visualize: bool = False
    log: bool = True
    log_every: int = 100
    sample_every: int = 1000
    checkpoint_every: int = 2000
    data_dir: str = "./data"
    lsun_category: str = ""
    checkpoint_dir: str = "./checkpoints"
    sample_dir: str = "./samples"
    log_dir: str = "./logs"
    random_seed: int = 42
    suffix: str = ""

    def __post_init__(self):
        if self.model not in LOSSES:
            raise ValueError(f"model must be one of {LOSSES}, got {self.model!r}")
        if self.kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, got {self.kernel!r}")
        if self.architecture not in ARCHS:
            raise ValueError(f"architecture must be one of {ARCHS}")
        if self.scaling_variant not in SCALING_VARIANTS:
            raise ValueError(f"scaling_variant must be one of {SCALING_VARIANTS}")
        if self.gp_variant not in GP_VARIANTS:
            raise ValueError(f"gp_variant must be one of {GP_VARIANTS}")
        if self.scaling_grad_estimator not in GRAD_ESTIMATORS:
            raise ValueError(
                f"scaling_grad_estimator must be one of {GRAD_ESTIMATORS}")
        if self.dp_mode not in ("gspmd", "shard_map"):
            raise ValueError("dp_mode must be gspmd or shard_map")
        if self.steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if self.dsteps < 1 or self.gsteps < 1 or self.start_dsteps < 1:
            raise ValueError("dsteps/gsteps/start_dsteps must be >= 1")
        if not self.global_batch_mmd and (
                self.model == "tmmd" or self.gradient_penalty > 0):
            raise ValueError(
                "global_batch_mmd=False is not supported with model="
                "'tmmd' or gradient_penalty>0 (those paths compute the "
                "global-batch estimator)")
        if not (0.0 <= self.ema_decay < 1.0):
            raise ValueError(
                f"ema_decay must be in [0, 1), got {self.ema_decay}")
        if self.three_sample_test not in ("pvalue", "vote"):
            raise ValueError("three_sample_test must be pvalue or vote")
        if self.on_device_data and self.dataset != "synthetic":
            raise ValueError(
                "on_device_data synthesizes batches in-program and is only "
                "meaningful for dataset='synthetic'")
        if self.on_device_data and self.compute_scores:
            raise ValueError(
                "on_device_data draws uniform noise on-device, a different "
                "distribution from the one scoring compares against: "
                "disable compute_scores with it.")
        if self.data_placement not in ("host", "device"):
            raise ValueError("data_placement must be host or device")
        if self.device_data_sharding not in ("replicated", "sharded"):
            raise ValueError(
                "device_data_sharding must be replicated or sharded")
        if self.data_placement == "device" and self.on_device_data:
            raise ValueError(
                "data_placement=device gathers the real dataset in-program; "
                "on_device_data synthesizes noise in-program — pick one")
        up = self.use_pallas
        if isinstance(up, bool):
            up = "on" if up else "off"
        elif isinstance(up, str) and up.lower() in ("true", "1", "yes"):
            up = "on"
        elif isinstance(up, str) and up.lower() in ("false", "0", "no"):
            up = "off"
        if up not in ("on", "off", "auto"):
            raise ValueError(f"use_pallas must be on/off/auto, got {self.use_pallas!r}")
        object.__setattr__(self, "use_pallas", up)
        if self.use_ring_mmd and self.dp_mode == "gspmd" \
                and self.num_data_shards > 1:
            object.__setattr__(self, "dp_mode", "shard_map")
        # model implies regularizer wiring, mirroring the reference dispatch
        if self.model in ("smmd", "sn-smmd") and not self.with_scaling:
            object.__setattr__(self, "with_scaling", True)
        if self.model == "sn-smmd" and not self.with_sn:
            object.__setattr__(self, "with_sn", True)

    @property
    def lr_g(self) -> float:
        return self.learning_rate if self.g_learning_rate is None else self.g_learning_rate

    @property
    def lr_d(self) -> float:
        return self.learning_rate if self.d_learning_rate is None else self.d_learning_rate

    # --- toy problem -------------------------------------------------------
    toy_dim: int = 1

    @property
    def image_shape(self) -> Tuple[int, ...]:
        """Shape of one data sample (NHWC image, or the 1-D toy sample)."""
        if self.architecture == "mlp" or self.dataset == "gaussian_mix":
            return (self.toy_dim,)
        return (self.output_size, self.output_size, self.c_dim)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def run_name(self) -> str:
        tag = f"{self.dataset}_{self.architecture}_{self.model}_{self.kernel}_b{self.batch_size}"
        return tag + (f"_{self.suffix}" if self.suffix else "")


def _add_bool(p: argparse.ArgumentParser, name: str, default: bool, help: str = ""):
    p.add_argument(f"--{name}", type=lambda s: s.lower() in ("1", "true", "yes"),
                   default=default, help=help)


def build_argparser() -> argparse.ArgumentParser:
    """One flag per ``Config`` field, with the JAX CLI's names, defaults
    and types."""
    p = argparse.ArgumentParser("smmdax_torch", description=__doc__)
    defaults = Config()
    for f in dataclasses.fields(Config):
        if f.type == "bool" or isinstance(getattr(defaults, f.name), bool):
            _add_bool(p, f.name, getattr(defaults, f.name))
        elif f.name in ("rbf_sigmas", "rq_alphas"):
            p.add_argument(f"--{f.name}", type=float, nargs="+",
                           default=list(getattr(defaults, f.name)))
        elif f.name in ("g_learning_rate", "d_learning_rate"):
            p.add_argument(f"--{f.name}", type=float, default=None)
        else:
            p.add_argument(f"--{f.name}", type=type(getattr(defaults, f.name)),
                           default=getattr(defaults, f.name))
    return p


def config_from_namespace(ns: argparse.Namespace) -> Config:
    """Config from a parsed namespace, ignoring any non-Config attributes
    (so entry points can add flags of their own, such as ``--device``)."""
    names = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in vars(ns).items() if k in names}
    kw["rbf_sigmas"] = tuple(kw["rbf_sigmas"])
    kw["rq_alphas"] = tuple(kw["rq_alphas"])
    return Config(**kw)


def config_from_args(argv: Optional[Sequence[str]] = None) -> Config:
    return config_from_namespace(build_argparser().parse_args(argv))
