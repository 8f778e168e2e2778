"""prove_s.fs: host seconds of commit and prove per statement of the
traced window, in the Fiat-Shamir cell (where the untraced `prove_s`
spreads too widely between runs to hold a bound; it moves `statement_s`).
The profiler's sessions lengthen the host-bound phases."""


def read(run):
    secs = [r.seconds["commit"] + r.seconds["prove"] for r in run.records]
    return sum(secs) / len(secs) if secs else None
