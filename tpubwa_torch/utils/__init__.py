from tpubwa_torch.utils.dna import (  # noqa: F401
    encode,
    decode,
    revcomp_codes,
    revcomp_str,
    pack_2bit,
    unpack_2bit,
)
from tpubwa_torch.utils.timers import PhaseTimers  # noqa: F401
