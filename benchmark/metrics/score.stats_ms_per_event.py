"""Host ms per scoring event of FID, KID, IS and the three-sample test
(the stats span) in the untraced window."""


def read(run):
    spans = run.get("spans", {}).get("stats")
    if run.get("kind") != "score" or not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
