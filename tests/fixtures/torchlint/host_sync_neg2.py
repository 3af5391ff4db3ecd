"""torchlint fixture: NEGATIVE for host-sync.

Same loop-body `.item()` pattern as the positives, but this module's
path is not a hot-loop module — the rule is scoped to the iteration
runtime, the SGD rounds and the online estimators' batches.
"""


def batch_stats(tables):
    out = []
    for t in tables:
        out.append(t.mean().item())
    return out
