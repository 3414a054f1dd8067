"""Host seconds of the program's ``FASTQ`` phase (its ``PhaseTimers`` span:
each pull of the next batch: FASTQ parsing and batch building of one end or
both) in the window, in ms per 1,000 reads; none where the phase never ran."""


def read(rec):
    s = rec["phase_s"].get("FASTQ")
    if s is None or rec["reads"] <= 0:
        return None
    return 1e6 * s / rec["reads"]
