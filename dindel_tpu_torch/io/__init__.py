from .fasta import FastaFile, write_fasta  # noqa: F401
from .bam import BamReader, BamWriter, BamRecord, BamHeader  # noqa: F401
