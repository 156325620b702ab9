"""K2 (``sht::basic_chain``, ``csrc/fused_block.cu``): its share of the
roofline over its launches in the traced stretch. Each call's shapes come
from the op's recorded inputs (x, packed weights, biases)."""

from port_bench.harness import bound, readers


def counts(shapes, dtypes):
    size = readers.itemsize(dtypes[0])
    nbytes, ops = bound.chain(shapes[0], shapes[1], shapes[2], size)
    return nbytes, ops, 'bf16' if size == 2 else 'f32'


def read(run):
    return readers.op_roofline(run, 'sht::basic_chain', r'conv3x3', counts)
