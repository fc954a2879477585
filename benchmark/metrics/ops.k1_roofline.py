"""ops.k1_roofline: the share of its roofline that K1 (the SpMM,
``segment_sum.cu``: forward and on the reverse CSR) reaches in the traced
epoch, in %. The least time is counted per call from what the data needs
(``counts.k1_least_s_per_cf_step``: bytes over 3.35 TB/s or float32
operations over 67 TFLOP/s, the larger), six calls a CF step; the time is
K1's summed device time (its unit kernel and the split rows' second
pass)."""

from benchmark import counts

NAMES = ("csr_units_kernel", "fixup_kernel")


def read(run):
    dev = run["devices"][0]
    spent = sum(s for name, (s, _) in dev["kernels"].items()
                if any(k in name for k in NAMES))
    if spent <= 0 or not run["sizes"]:
        return None
    least = (counts.k1_least_s_per_cf_step(run["sizes"], run["model"])
             * run["steps"]["cf"])
    return 100.0 * least / spent
