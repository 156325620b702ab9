"""CUDA runtime launch calls (kernels, memcpys, memsets, graph launches)
the host made in the traced stretch, over the frames of its chunks."""

from port_bench.harness import readers


def read(run):
    st = readers.stretch(run)
    if st is None:
        return None
    return len(run.trace.launches(st[0], st[1])) / st[3]
