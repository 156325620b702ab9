"""Device ms of the kernels launched inside the detector network's forward
(the harness's span on its ``nn.Module``), over the frames it took."""

from port_bench.harness import readers


def read(run):
    got = readers.span_device_s(run, 'detector')
    if got is None or got[1] == 0:
        return None
    return 1e3 * got[0] / got[1]
