"""Shared by the kernels' roofline readers: the least time of every
recorded call of the kernel (its roofline module's operations and
bytes), over the device time of the kernels of that name in the trace,
in percent. Kernels are attributed by name; where the trace holds
another number of launches than calls were recorded, nothing is
read."""
import sys


def share(run, kernel):
    calls = run.trace.calls.get(kernel, [])
    mod = run.roofline(kernel)
    device_s, launches = run.trace.kernel(mod.KERNEL)
    if not calls or not device_s:
        return None
    if launches != len(calls):
        print(f"portbench: {kernel}: {launches} launches in the trace, "
              f"{len(calls)} calls recorded; roofline not read",
              file=sys.stderr)
        return None
    return 100.0 * sum(mod.bound_s(c) for c in calls) / device_s
