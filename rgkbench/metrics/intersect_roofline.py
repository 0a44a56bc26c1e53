"""Share of the intersection kernels' roofline over one eager block: the
least time of the block's queries at the card's bandwidth (`_intersect`)
over the device time of its K1-K4 kernels, in %."""

from rgkbench.metrics import _intersect as ix


def read(rec):
    if "queries" not in rec:
        return None
    ms = ix.kernel_ms(rec["kernels"], True)
    if ms <= 0:
        return None
    q = rec["queries"]
    nbytes = ix.least_bytes(q["closest"], rec["block_rays"], q["any"],
                            q["any_rays"], rec["triangles"])
    return 100.0 * nbytes / ix.PEAK_BYTES_PER_S / (ms / 1e3)
