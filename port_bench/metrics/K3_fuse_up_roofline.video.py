"""K3 (``sht::fuse_up``, ``csrc/fuse_up.cu``): its share of the roofline
over its launches in the traced stretch. The base branch's shape comes
from the op's recorded input; the profiler records no shapes of its
tensor-list inputs, so the lower branches follow from the configuration's
count of sources a call (``kernels.k3_sources_in_call_order``, in the
pose network's launch order): source j of (B, H, W, C) is (B, H / 2^j,
W / 2^j, C 2^j) with a (C 2^j, C) weight. A pose span whose calls do not
number as many is left out."""

from port_bench.harness import bound, readers


def read(run):
    sources = run.cell.config.get('kernels', {}).get(
        'k3_sources_in_call_order')
    st = readers.stretch(run)
    if not sources or st is None:
        return None
    calls = run.trace.ops('sht::fuse_up', st[0], st[1])
    spans = run.trace.spans('port_bench.pose', st[0], st[1])
    kernels = run.trace.launched_within(calls, r'fuse_up')
    least = busy = 0.0
    for span in spans:
        inside = [(c, k) for c, k in zip(calls, kernels)
                  if span.start <= c.start < span.end]
        if len(inside) != len(sources):
            continue
        for n, (call, ks) in zip(sources, inside):
            b, h, w, c = call.shapes[0]
            size = readers.itemsize(call.dtypes[0])
            ys = [(b, h >> j, w >> j, c << j) for j in range(1, n + 1)]
            ws = [(c << j, c) for j in range(1, n + 1)]
            nbytes, ops = bound.fuse_up(call.shapes[0], ys, ws,
                                        call.shapes[3], size)
            least += bound.least_s(nbytes, ops, 'bf16' if size == 2
                                   else 'f32')[0]
            busy += sum(e.end - e.start for e in ks) / 1e9
    return 100.0 * least / busy if busy > 0 else None
