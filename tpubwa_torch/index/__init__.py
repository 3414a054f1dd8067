from tpubwa_torch.index.fmindex import FMIndex, CP_BLOCK  # noqa: F401
from tpubwa_torch.index.sais import suffix_array  # noqa: F401
