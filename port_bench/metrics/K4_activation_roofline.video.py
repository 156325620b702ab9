"""K4 (``csrc/activation.cu``, the detector's SiLU): its share of the
roofline over its launches in the traced stretch. K4 is no custom op, so
each launch's size comes from the configuration's list of the detector's
activation sizes a frame (``kernels.k4_elems_per_frame``, one entry a
launch of a forward, in launch order) times the span's frames; a span
whose K4 launches do not number as many is left out."""

from port_bench.harness import bound, readers


def read(run):
    elems = run.cell.config.get('kernels', {}).get('k4_elems_per_frame')
    if not elems:
        return None
    got = readers.span_device_s(run, 'detector', r'activation_kernel')
    if got is None:
        return None
    _, _, hits, spans = got
    least = busy = 0.0
    for span, kernels in zip(spans, hits):
        if len(kernels) != len(elems):
            continue
        frames = readers.batch_of(span)
        for n, k in zip(elems, kernels):
            nbytes, ops = bound.activation(n * frames, 'silu')
            least += bound.least_s(nbytes, ops, 'f32')[0]
            busy += (k.end - k.start) / 1e9
    return 100.0 * least / busy if busy > 0 else None
