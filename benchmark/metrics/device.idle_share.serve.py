"""device.idle_share.serve: the share of the traced requests' wall time
in which no kernel ran, in %: the stream's first seconds again, on the
same schedule, under the profiler; 1 - busy / wall."""


def read(run):
    dev = run["devices"][0]
    if dev["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
