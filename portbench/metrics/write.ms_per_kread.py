"""Host seconds of the program's ``WRITE`` phase (its ``PhaseTimers`` span: a
batch's SAM text to the output, and the progress line) in the window, in ms
per 1,000 reads; none where the phase never ran."""


def read(rec):
    s = rec["phase_s"].get("WRITE")
    if s is None or rec["reads"] <= 0:
        return None
    return 1e6 * s / rec["reads"]
