"""Median over the traced stretch's chunks of how long a chunk's finished
device work waited before the program began reading it: the start of
``sht.resolve[c]`` less the latest end of the device events launched
inside ``sht.dispatch[c]``, at least 0."""

from port_bench.harness import program_spans


def read(run):
    return program_spans.chunk_hold_ms(run)
