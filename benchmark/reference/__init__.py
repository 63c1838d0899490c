"""The plain reference of the benchmark: NumPy and ``zlib`` only.

It decodes BAM files, sorts records by coordinate, builds BAI indexes
and overlaps records with intervals, from the bytes of the files alone.
It imports nothing of the program under test and takes nothing the
program made: the jobs hand it the benchmark's own input files and the
program's outputs, and it judges those outputs.
"""
