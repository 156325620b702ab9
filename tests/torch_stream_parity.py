"""Helpers of the port's stream parity tests: the JAX twin of
``VaryStub``, facade pairs and the comparison of two streams.

Geometry: HRNet-W8 at 64x64. The JAX facade runs under x64, where its PIL
crops are exact, as the port's are. Tolerances, as in
tests/test_torch_api.py: boxes exact; heatmaps and confidences 2e-4;
keypoint coordinates 1e-4 px.
"""

import numpy as np

import jax
import jax.numpy as jnp
from torch_stream_stubs import VaryStub, stub_rows

from simple_hrnet_tpu import SimpleHRNet as JaxSimpleHRNet

from simple_hrnet_tpu_torch import SimpleHRNet

RES = (64, 64)
KW = dict(resolution=RES, yolo_model_def='yolov3-tiny',
          return_heatmaps=True, return_bounding_boxes=True)


class JaxVaryStub:
    """The JAX facade's side of ``VaryStub`` (tests/test_api.py's
    ``_VaryStub``): a traceable ``pure_fn`` with the same rows."""

    params = {}

    def pure_fn(self, in_hw):
        rows0 = jnp.asarray(stub_rows())

        def fn(params, frames):
            rows = jnp.broadcast_to(rows0, (frames.shape[0], *rows0.shape))
            n = jnp.clip((frames.mean(axis=(1, 2, 3)) / 32.0)
                         .astype(jnp.int32), 0, rows0.shape[0])
            return rows, jnp.arange(rows0.shape[0])[None, :] < n[:, None]
        return fn


def port_facade(path, **kw):
    port = SimpleHRNet(8, 17, path, device='cpu', **{**KW, **kw})
    port.detector = VaryStub()
    return port


def stub_facades(path, **kw):
    """Both facades with the VaryStub pair (the JAX facade built without a
    detector, then given the stub, as tests/test_api.py does)."""
    port = port_facade(path, **kw)
    ref = JaxSimpleHRNet(8, 17, path, multiperson=False, **{**KW, **kw})
    ref.multiperson = True
    ref.detector = JaxVaryStub()
    return port, ref


def jax_stream(ref, frames, **kw):
    with jax.enable_x64(True):  # exact PIL crops, as the port's
        return list(ref.predict_stream(frames, **kw))


def assert_same_frame(out, ref):
    """One frame's (heatmaps, boxes, keypoints) against the reference."""
    (hm, boxes, pts), (rhm, rboxes, rpts) = out, ref
    for a, b in ((hm, rhm), (boxes, rboxes), (pts, rpts)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    np.testing.assert_array_equal(boxes, rboxes)
    np.testing.assert_allclose(hm, rhm, rtol=0, atol=2e-4)
    np.testing.assert_allclose(pts[..., :2], rpts[..., :2], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(pts[..., 2], rpts[..., 2], rtol=0, atol=2e-4)


def assert_same_stream(out, ref, counts=None):
    assert len(out) == len(ref)
    for i, (o, r) in enumerate(zip(out, ref)):
        if counts is not None:
            assert o[2].shape[0] == counts[i]
        assert_same_frame(o, r)
