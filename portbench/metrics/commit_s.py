"""commit_s: host seconds of the commit phase per statement of the traced
window (the benchmark's span around the port's commit call)."""


def read(run):
    secs = [r.seconds["commit"] for r in run.records]
    return sum(secs) / len(secs) if secs else None
