"""g1_roofline.prove: the least time of the K2 and K3 launches in the
commit and prove spans (`portbench.roofline`, launch by launch at its
exact width and `times`), as a percentage of their device time by kernel
name in the profiler's trace."""

from portbench import roofline

PHASES = ("commit", "prove")


def read(run):
    least = sum(roofline.least_seconds(kernel, points, times)
                for s in run.spans(PHASES)
                for kernel, points, times in s.g1_launches)
    device = run.device_seconds(PHASES, roofline.KERNELS.values())
    if least <= 0 or device <= 0:
        return None
    return 100.0 * least / device
