"""parallel.collective_ms: device ms of NCCL kernels per CF step in the
traced epoch's CF phase, the least over the processes: the process that
waits least for its peers comes nearest the transfer itself."""


def read(run):
    per = []
    for d in run["devices"]:
        span = d["spans"].get("cf_phase")
        if not span:
            continue
        s = sum(v[0] for name, v in span["kernels"].items()
                if "nccl" in name.lower())
        if s > 0:
            per.append(s / run["steps"]["cf"] * 1e3)
    if len(per) < 2:
        return None
    return min(per)
