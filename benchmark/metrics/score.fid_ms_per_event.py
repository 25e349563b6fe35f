"""Host ms per scoring event in FID: the ``eval.gaussian_stats`` (the
generated set's mean and covariance) and ``eval.frechet`` (the
eigendecompositions) spans of window A of ``benchmark.program_trace``."""

from benchmark import program_trace


def read(run):
    if run.get("kind") != "score":
        return None
    w = program_trace.windows(run)
    if not w or "eval.frechet" not in w["host"]:
        return None
    return program_trace.per_unit(w, ("eval.gaussian_stats", "eval.frechet"), "host_ms", "a")
