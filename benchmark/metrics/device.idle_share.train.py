"""device.idle_share.train: the share of the traced epoch's wall time in
which no kernel ran, in %: 1 - busy / wall, both of that epoch. (Against
the untraced epoch's wall, profile_train_step.py's arithmetic, a replayed
epoch read below 0: the profiler lengthens the kernels it records by more
than the half per cent the epoch idles.)"""


def read(run):
    dev = run["devices"][0]
    if dev["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
