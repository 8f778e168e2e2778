"""k1_launches.verify: launches of K1 (`kernels.launches["mont_mul"]`,
counted by `fields/cuda_limb.py`) per verification: the counter's rise
over each verify call of the window, averaged."""


def read(run):
    counts = [r.launches["verify"].get("mont_mul", 0) for r in run.records]
    if not any(counts):
        return None
    return sum(counts) / len(counts)
