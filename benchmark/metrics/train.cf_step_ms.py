"""train.cf_step_ms: host ms of a CF step, the window's CF phases (each
ending in a synchronisation) over their steps."""


def read(run):
    span = run["spans"].get("cf_phase")
    if not span or span[1] == 0:
        return None
    return span[0] / span[1] * 1e3
