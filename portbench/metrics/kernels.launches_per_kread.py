"""Kernel launches on the device in the traced window, per 1,000 reads;
none without a device trace."""


def read(rec):
    dev = rec.get("device")
    if dev is None or rec["reads"] <= 0 or dev["kernel_launches"] == 0:
        return None
    return 1e3 * dev["kernel_launches"] / rec["reads"]
