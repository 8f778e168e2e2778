"""verify_s.fs: host seconds of verify per statement of the traced window,
in the Fiat-Shamir cell (where the untraced `verify_s` spreads too widely
between runs to hold a bound; it moves `statement_s`). The profiler's
sessions lengthen the host-bound phases."""


def read(run):
    secs = [r.seconds["verify"] for r in run.records]
    return sum(secs) / len(secs) if secs else None
