"""1 - the union of device activity (kernels, memcpys, memsets) over the
traced stretch, in %."""

from port_bench.harness import readers


def read(run):
    st = readers.stretch(run)
    if st is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_ns(st[0], st[1]) / (st[1] - st[0]))
