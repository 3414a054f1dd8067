from tpubwa_torch.io.fasta import read_fasta, Contig  # noqa: F401
from tpubwa_torch.io.fastq import read_fastq, ReadBatch, batch_reads  # noqa: F401
from tpubwa_torch.io.sam import sam_header, SamRecord  # noqa: F401
