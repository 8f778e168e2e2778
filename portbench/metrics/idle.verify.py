"""idle.verify: the card's idle share over the verify spans, 1 - (union
of kernel intervals) / (span length), from the profiler."""


def read(run):
    return run.idle_share(("verify",))
