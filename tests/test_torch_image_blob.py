"""A served image's blob built by `rlod::image_blob` (`ops/image_blob.py`)
and `Detector`'s staged input path (`engine/serve.py`), on the CPU:

- the op's plain version equals `prep_im_for_blob` + the 32-pad
  (`im_list_to_blob`) bit for bit: the serve pool's eight COCO sizes, a
  downscale, 1-pixel edges, sizes where h·scale lies at .5, f32 and uint8
  input; `Detector.inputs` gives the same blob and im_info from the numpy
  image as the caller holds it (a BGR-flipped view included);
- the `pad_to` canvas where the image fits and where it does not;
- `Detector.detect` returns what the host-built blob gives;
- the staging buffer grows only when a larger image arrives;
- the op refuses what it does not take.

The kernel against this plain version is `tests/test_torch_gpu.py -k
image_blob`, on the card.
"""

import numpy as np
import pytest
import torch

from rlobjectdetection_tpu_torch import config
from rlobjectdetection_tpu_torch.data.blob import (PIXEL_MEANS_BGR, blob_scale, pad_shape,
                                                   prep_im_for_blob, resized_shape)
from rlobjectdetection_tpu_torch.data.minibatch import im_list_to_blob
from rlobjectdetection_tpu_torch.engine.detect import postprocess_detections
from rlobjectdetection_tpu_torch.engine.serve import Detector
from rlobjectdetection_tpu_torch.models import FasterRCNN
from rlobjectdetection_tpu_torch.ops.image_blob import image_blob, image_blob_plain
from rlobjectdetection_tpu_torch.utils import tracing
import torch_threads  # noqa: F401  (xdist workers share the cores)

MEANS = torch.tensor(PIXEL_MEANS_BGR.reshape(3))

# (h, w, target, dtype): the serve pool's eight COCO sizes at 800 (h×w of its
# w×h list), a downscale, 1-pixel edges (h·scale and w·scale at .5 too),
# h·scale and w·scale at .5 (np.rint rounds 7.5 up and 2.5 down), uint8
CASES = [(480, 640, 800, "float32"), (640, 480, 800, "float32"),
         (427, 640, 800, "float32"), (640, 427, 800, "float32"),
         (375, 500, 800, "float32"), (500, 375, 800, "float32"),
         (612, 612, 800, "float32"), (512, 640, 800, "float32"),
         (61, 97, 40, "float32"), (1, 7, 5, "float32"), (9, 1, 3, "float32"),
         (4, 6, 5, "float32"), (6, 4, 5, "float32"), (2, 5, 5, "float32"),
         (61, 97, 150, "uint8"), (480, 640, 800, "uint8"), (4, 6, 5, "uint8")]


def _image(h, w, dtype, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(dtype)


def _host_blob(im, target):
    """The blob and im_info as the host built them: `prep_im_for_blob`, then
    `im_list_to_blob`'s 32-pad."""
    resized, scale = prep_im_for_blob(im, PIXEL_MEANS_BGR, target)
    info = np.array([[resized.shape[0], resized.shape[1], scale]], dtype=np.float32)
    return im_list_to_blob([resized]), info


def _cfg(target):
    return config.Config(TEST=config.TestConfig(SCALES=(target,)))


def _same_bits(got, want):
    got = np.ascontiguousarray(got)
    return got.shape == want.shape and np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("h,w,target,dtype", CASES)
def test_plain_blob_is_prep_im_for_blob_and_the_pad_to_the_bit(h, w, target, dtype):
    im = _image(h, w, dtype)
    want, want_info = _host_blob(im, target)
    scale = blob_scale(h, w, target)
    size = resized_shape(h, w, scale)
    assert tuple(want_info[0, :2]) == size
    got = image_blob(torch.from_numpy(im), MEANS, scale, size, pad_shape(*size))
    assert got.dtype == torch.float32 and _same_bits(got.numpy(), want)
    # the detector's staged path, from the image and from a BGR-flipped view
    detector = Detector(torch.nn.Identity(), _cfg(target), "cpu")
    rgb = np.ascontiguousarray(im[:, :, ::-1])
    for src in (im, rgb[:, :, ::-1]):
        data, info = detector.inputs(src)
        assert _same_bits(data.numpy(), want) and _same_bits(info.numpy(), want_info)


@pytest.mark.parametrize("pad_to,fits", [((1000, 1300), True), ((600, 1400), False)])
def test_pad_to_canvas(pad_to, fits):
    """The `pad_to` canvas (snapped up to multiples of 32) where the 32-padded
    blob fits in it, the image's own padded shape where it does not."""
    im = _image(480, 640, "float32", seed=1)
    want, want_info = _host_blob(im, 800)
    if fits:
        canvas = np.zeros((1, *pad_shape(*pad_to), 3), dtype=np.float32)
        canvas[0, :want.shape[1], :want.shape[2]] = want[0]
        want = canvas
    data, info = Detector(torch.nn.Identity(), _cfg(800), "cpu", pad_to=pad_to).inputs(im)
    assert tuple(data.shape) == ((1, 1024, 1312, 3) if fits else (1, 800, 1088, 3))
    assert _same_bits(data.numpy(), want) and _same_bits(info.numpy(), want_info)


TINY = config.Config(
    TEST=config.TestConfig(RPN_PRE_NMS_TOP_N=128, RPN_POST_NMS_TOP_N=32, SCALES=(96,),
                           MAX_DETS_PER_IMAGE=10),
    DTYPE="float32", NMS_TILE=64)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_detect_returns_what_the_host_blob_gave(dtype):
    """`Detector.detect` on the tiny net equals the model and post-process on
    the host-built blob and im_info, array for array."""
    model = FasterRCNN(4, "tiny", TINY, device="cpu", seed=3)
    detector = Detector(model, TINY, "cpu")
    im = _image(70, 100, dtype, seed=2)
    blob, info = (torch.from_numpy(a) for a in _host_blob(im, 96))
    with torch.inference_mode():
        out = model(blob, info)
        want = postprocess_detections(
            out["rois"][0], out["cls_prob"][0], out["bbox_pred"][0], info[0],
            out["roi_valid"][0], num_classes=model.num_classes,
            class_agnostic=model.class_agnostic, max_per_image=TINY.TEST.MAX_DETS_PER_IMAGE,
            nms_thresh=TINY.TEST.NMS, score_thresh=model.test_score_thresh)
    got = detector.detect(im)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.numpy().dtype
        np.testing.assert_array_equal(g, w.numpy())


def test_staging_buffer_grows_only_for_a_larger_image():
    detector = Detector(torch.nn.Identity(), _cfg(64), "cpu")
    allocs = lambda: tracing.totals().get("blob.staging_allocs", 0)
    steps = [((40, 60), "float32", 1), ((40, 60), "float32", 0), ((60, 40), "float32", 0),
             ((30, 30), "float32", 0), ((40, 60), "uint8", 0), ((50, 60), "float32", 1),
             ((50, 60), "float32", 0)]
    for (h, w), dtype, grew in steps:
        n = allocs()
        staged = detector.blob(_image(h, w, dtype))
        assert allocs() - n == grew, ((h, w), dtype)
        assert staged.host.numel() == 16 + h * w * 3 * np.dtype(dtype).itemsize


@pytest.mark.parametrize("image,size,pad", [
    (torch.zeros(8, 8, 3, dtype=torch.float64), (8, 8), (32, 32)),
    (torch.zeros(8, 8, 4), (8, 8), (32, 32)),
    (torch.zeros(8, 8, 3), (40, 8), (32, 32)),
    (torch.zeros(8, 8, 3), (8, 8), (32, 30))])
def test_image_blob_refuses_what_it_does_not_take(image, size, pad):
    with pytest.raises(ValueError, match="image_blob"):
        image_blob_plain(image, MEANS, 1.0, size, pad)


@pytest.mark.parametrize("dtype", ["float64", "int32", "float16"])
def test_other_dtypes_are_taken_as_f32(dtype):
    """An image of another dtype is staged as f32, as `prep_im_for_blob`'s
    `astype` takes it."""
    im = _image(30, 50, dtype, seed=3)
    want, want_info = _host_blob(im, 64)
    data, info = Detector(torch.nn.Identity(), _cfg(64), "cpu").inputs(im)
    assert _same_bits(data.numpy(), want) and _same_bits(info.numpy(), want_info)
