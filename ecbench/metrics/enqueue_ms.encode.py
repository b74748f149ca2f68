"""Host time from the call into the rs entry to its return, before the
fence: mean a call, over the calls the profiler did not see."""


def read(run):
    return run.entry_ms("rs.")
