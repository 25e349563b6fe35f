"""Tools of the port, each run as ``python -m smmdax_torch.tools.<name>``:
the measurement tools bench_large (the large-image configs on
device-drawn data, with a host-fed row) and profile_ablation (the
flagship's step under feature ablations), which take the per-card peaks
from ``smmdax_torch.bench``; and the asset tools make_assets (every
dataset format at production volume, the JAX tool's bytes) and
parity_day (the asset-day protocol)."""
