"""Host-side IO: FASTQ/BAM codecs and the fixed-shape device batcher.

Reference analog: htsiter.cc + htslib (SURVEY.md §3.1 C6/C7; mount empty,
§0).  The replacement here is vectorized NumPy parsing (mmap +
frombuffer newline scanning) feeding fixed-shape int8 batches, per
SURVEY.md §8.1 L0; the BAM/BGZF path gets a native C++ codec
(kbbq_tpu/io/native).
"""

from .fastq import FastqData, read_fastq, write_fastq_with_quals
from .batcher import Batcher, ReadArrays
