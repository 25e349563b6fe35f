"""Measurement tools of the port, each run as ``python -m
smmdax_torch.tools.<name>``: bench_large (the large-image configs on
device-drawn data, with a host-fed row) and profile_ablation (the
flagship's step under feature ablations).  They take the per-card peaks
from ``smmdax_torch.bench``."""
