"""Host seconds of the program's ``REGS`` phase (its ``PhaseTimers`` span: one
``AlnReg`` object a region, in ``Aligner.regions_batch``) in the window, in
ms per 1,000 reads; none where the phase never ran."""


def read(rec):
    s = rec["phase_s"].get("REGS")
    if s is None or rec["reads"] <= 0:
        return None
    return 1e6 * s / rec["reads"]
