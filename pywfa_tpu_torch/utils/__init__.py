from .io import read_fasta, read_fastx, write_fasta  # noqa: F401
from .check import check_alignment  # noqa: F401
from .profiler import Timer, Counter  # noqa: F401
