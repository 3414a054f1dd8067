"""The window's wall outside every phase of the program (FASTQ parsing,
batch building, the writer, and the paired path's steps before PAIR), in
ms per 1,000 reads."""


def read(rec):
    if rec["reads"] <= 0:
        return None
    return 1e6 * rec["unphased_s"] / rec["reads"]
