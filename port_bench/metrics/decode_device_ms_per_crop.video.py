"""Device ms of the events launched inside the program's
``sht.decode[k]`` spans (the argmax decode), over the crop slots they
hold."""

from port_bench.harness import program_spans


def read(run):
    return program_spans.device_ms_per_count(run, 'decode')
