"""g1_launches.prove: launches of K2 and K3 (`kernels.launches["g1_add"]`
and `["g1_double"]`, counted by `curve/cuda_group.py`) per statement over
its commit and prove calls: the rise of the counters over each, summed
and averaged over the traced window. An MSM whose windows run in more
chunks scans more often, so the window plan moves it."""

KERNELS = ("g1_add", "g1_double")
PHASES = ("commit", "prove")


def read(run):
    counts = [sum(r.launches[p].get(k, 0) for p in PHASES for k in KERNELS)
              for r in run.records]
    if not any(counts):
        return None
    return sum(counts) / len(counts)
