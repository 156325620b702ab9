"""Share (%) of the traced stretch in which the device runs nothing while
the host is inside a ``sht.dispatch[c]`` span: idle left by enqueuing."""

from port_bench.harness import program_spans


def read(run):
    return program_spans.idle_share_within(run, ('dispatch',))
