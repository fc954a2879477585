"""recommend.refresh_ms: host ms of the serving forward after a
refresh() (attention, then propagation), synchronised."""


def read(run):
    span = run["spans"].get("refresh")
    if not span or span[1] == 0:
        return None
    return span[0] / span[1] * 1e3
