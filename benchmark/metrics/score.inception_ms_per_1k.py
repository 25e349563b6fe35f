"""Host ms per 1,000 images of the inception span (synchronized at both
ends) of the untraced window's scoring events."""


def read(run):
    spans = run.get("spans", {}).get("inception")
    if run.get("kind") != "score" or not spans:
        return None
    n = run["config"]["no_of_samples"]
    return 1e3 * sum(spans) / (len(spans) * n / 1e3)
