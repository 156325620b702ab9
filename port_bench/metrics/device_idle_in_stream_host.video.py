"""Share (%) of the traced stretch in which the device runs nothing while
the host is inside a ``sht.stack[c]``, ``sht.upload[c]`` or
``sht.resolve[c]`` span: idle left by the stream's serial host work
(stacking, pinning and copying frames; reading and finishing results).
With ``device_idle_in_dispatch.video`` it leaves, of
``device_idle_share.video``, the idle in no program span: the caller's."""

from port_bench.harness import program_spans


def read(run):
    return program_spans.idle_share_within(run,
                                           ('stack', 'upload', 'resolve'))
