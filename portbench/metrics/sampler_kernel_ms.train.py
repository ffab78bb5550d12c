"""Milliseconds of the bucketed sampler's kernel a launch: the device time
of the operations whose names hold ``bucketed_sample``
(``csrc/bucketed_sample.cu``, one launch an epoch where the bucketed
sampler draws) in the traced window, over their launches.  A program
without the kernel reads None."""


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.op_seconds('bucketed_sample')
    if launches == 0:
        return None
    return 1e3 * seconds / launches
