"""Host time from the call into decode.decode_prepared to its return,
before the fence: mean a call, over the calls the profiler did not
see."""


def read(run):
    return run.entry_ms("decode.decode_prepared")
