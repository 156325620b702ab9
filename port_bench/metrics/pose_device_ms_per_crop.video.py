"""Device ms of the kernels launched inside the pose network's forward
(the harness's span on its ``nn.Module``), over the crop slots its
batches held."""

from port_bench.harness import readers


def read(run):
    got = readers.span_device_s(run, 'pose')
    if got is None or got[1] == 0:
        return None
    return 1e3 * got[0] / got[1]
