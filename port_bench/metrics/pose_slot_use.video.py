"""Detected people in the stretch's frames over the crop slots the
program's pose batches held (its ``sht.pose[k]`` spans), in %: the share
of the pose model's work that was not padding."""

from port_bench.harness import program_spans, readers


def read(run):
    got = program_spans.spans(run, 'pose')
    fp = readers.frames_people(run)
    slots = sum(readers.batch_of(s) for s in got or ())
    if fp is None or slots == 0:
        return None
    return 100.0 * fp[1] / slots
