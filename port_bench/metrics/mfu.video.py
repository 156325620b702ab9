"""The whole step's share of the card's bf16 peak: the model FLOPs the
stretch's inputs need (the detector's FLOPs a frame for every frame, the
pose model's FLOPs a crop for every detected person, padding slots and
the phase stem's zero taps not counted; counted once with
``torch.utils.flop_counter`` on the reference models and kept in the
configuration) over the stretch's seconds, over 989 TFLOP/s."""

from port_bench.harness import bound, readers


def read(run):
    st = readers.stretch(run)
    got = readers.frames_people(run)
    if st is None or got is None:
        return None
    flops = run.cell.config['flops']
    need = got[0] * flops['detector_per_frame'] \
        + got[1] * flops['pose_per_crop']
    return 100.0 * need / ((st[1] - st[0]) / 1e9) / bound.PEAK_OPS['bf16']
