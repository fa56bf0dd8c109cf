"""scan_roofline.query: The index scans' bytes read once (``counts.scan_bytes``: brute, every
live row; IVF, the rows of the blocks the probe plan lists) in the
profiled stretch at the HBM rate, over the scan kernel's (the ring,
``ivf_tma_kernel``) device time there, %."""

from portbench.bench import counts


def read(m):
    t = sum(s for n, s in m.trace["by_name"].items() if "ivf_tma_kernel" in n)
    nbytes = sum(counts.scan_bytes(rows, rb) for _, rows, rb in m.profiled_scans)
    return 100.0 * nbytes / counts.HBM_BYTES / t if t > 0 and nbytes > 0 else None
