"""idle.prove: the card's idle share over the commit and prove spans,
1 - (union of kernel intervals) / (span length), from the profiler."""


def read(run):
    return run.idle_share(("commit", "prove"))
