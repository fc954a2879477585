"""multihost.idle_share_max: the highest device idle share among the
processes, one per card, in %. NCCL's kernels run from a collective's
start to its end, waiting for the peers, so they count as idle here
(``tools/profile_train_step.py``'s "busy without them"): on each card
1 - (busy seconds of the traced epoch less its NCCL kernels' seconds) /
(the window's seconds per epoch)."""


def read(run):
    shares = []
    for d in run["devices"]:
        if d["busy_s"] <= 0:
            continue
        nccl = sum(v[0] for name, v in d["kernels"].items()
                   if "nccl" in name.lower())
        shares.append(1.0 - (d["busy_s"] - nccl) / d["untraced_s"])
    if len(shares) < 2:
        return None
    return 100.0 * max(shares)
