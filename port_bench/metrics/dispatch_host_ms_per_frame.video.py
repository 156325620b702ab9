"""Host ms the program spent enqueuing the stretch's chunks (its
``sht.dispatch[c]`` spans, summed), over the stretch's frames."""

from port_bench.harness import program_spans, readers


def read(run):
    st = readers.stretch(run)
    got = program_spans.spans(run, 'dispatch')
    if st is None or got is None:
        return None
    return sum(s.end - s.start for s in got) / 1e6 / st[3]
