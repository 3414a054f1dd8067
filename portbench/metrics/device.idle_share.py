"""Share of the traced window in which nothing ran on the device (the
complement of the union of kernel, copy and set intervals), in %; none
without a device trace or where nothing ran there."""


def read(rec):
    dev = rec.get("device")
    if dev is None or dev["span_s"] <= 0 or dev["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["span_s"])
