"""Host seconds of the program's ``DEDUP`` phase (its ``PhaseTimers`` span: the
paired path's sort / dedup / patch rounds before PAIR) in the window, in ms
per 1,000 reads; none where the phase never ran."""


def read(rec):
    s = rec["phase_s"].get("DEDUP")
    if s is None or rec["reads"] <= 0:
        return None
    return 1e6 * s / rec["reads"]
