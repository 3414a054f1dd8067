"""Device time of all kernels in the traced window (``torch.profiler``), in
ms per 1,000 reads; none without a device trace."""


def read(rec):
    dev = rec.get("device")
    if dev is None or rec["reads"] <= 0 or dev["kernel_launches"] == 0:
        return None
    return 1e6 * dev["kernel_s"] / rec["reads"]
