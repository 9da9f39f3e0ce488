"""The port's detector CLI chain on the CPU at the `tiny` size: train →
checkpoint → `test_net --load_dir` → `demo`, each called in process with
`--device cpu` on a synthetic VOC devkit (the `TINY_SET` flags of
`tests/test_cli.py`); resume equality through `engine/resume_validate.py`;
and the logging helpers against the JAX package's.

- `trainval_net` runs one epoch (2 steps at batch 2), writes
  `faster_rcnn_1_1.pth` with the step, schedule and class names, and with
  `--profile 1` a Chrome trace;
- `test_net --load_dir ... --checkepoch 1` prints the AP table and "Mean
  AP", and `--batch 2` the same table; the checkpoint's pooling_mode
  replaces the config's;
- `demo --load_name` writes a `_det.jpg` for each image, and the
  detections behind each are `Detector.detect`'s on the same image and
  weights, exactly; `--pad_to` is snapped to multiples of 32;
- `resume_validate` at `tiny`: two epochs in one process equal one epoch
  and a resume in a fresh process, to the bit.
"""

import os

import numpy as np
import pytest
import torch

from rlobjectdetection_tpu.utils import logging as jax_logging
from rlobjectdetection_tpu_torch.config import Config, cfg_from_list
from rlobjectdetection_tpu_torch.data import synthetic
from rlobjectdetection_tpu_torch.data.blob import read_image_bgr
from rlobjectdetection_tpu_torch.engine import demo, resume_validate, test_net, trainval_net
from rlobjectdetection_tpu_torch.engine.checkpoint import load_checkpoint, read_checkpoint
from rlobjectdetection_tpu_torch.engine.serve import Detector
from rlobjectdetection_tpu_torch.models import FasterRCNN
from rlobjectdetection_tpu_torch.utils import logging as port_logging
from test_torch_data import VOC_CLASSES, data_dir
import torch_threads  # noqa: F401  (xdist workers share the cores)

TINY_SET = [
    "TRAIN.RPN_PRE_NMS_TOP_N", "256", "TRAIN.RPN_POST_NMS_TOP_N", "64",
    "TRAIN.BATCH_SIZE", "32", "TRAIN.SCALES", "[128]", "TRAIN.USE_FLIPPED", "False",
    "TEST.RPN_PRE_NMS_TOP_N", "128", "TEST.RPN_POST_NMS_TOP_N", "32",
    "TEST.SCALES", "[128]", "TEST.MAX_DETS_PER_IMAGE", "10",
    "ANCHOR_SCALES", "(2,3,5)", "DTYPE", "float32", "NMS_TILE", "64",
]


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The devkit, one epoch of training in a working directory of its own
    (checkpoints under models/, the trace under logs/), and the result."""
    root = tmp_path_factory.mktemp("voc")
    synthetic.make_voc_devkit(str(root), num_images=4, image_size=(128, 160),
                              classes=VOC_CLASSES)
    work = tmp_path_factory.mktemp("work")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with data_dir(root):
            result = trainval_net.main([
                "--dataset", "pascal_voc", "--net", "tiny", "--epochs", "1", "--bs", "2",
                "--lr", "0.002", "--disp_interval", "1", "--save_dir", "models",
                "--profile", "1", "--nw", "2", "--device", "cpu", "--pooling_mode", "crop",
                "--set", *TINY_SET])
    finally:
        os.chdir(cwd)
    return dict(root=root, work=work, result=result,
                ckpt=str(work / "models" / "tiny" / "pascal_voc" / "faster_rcnn_1_1.pth"))


def _test_net(chain, capsys, *flags):
    cwd = os.getcwd()
    os.chdir(chain["work"])
    try:
        with data_dir(chain["root"]):
            test_net.main(["--dataset", "pascal_voc", "--net", "tiny", "--device", "cpu",
                           "--load_dir", "models", "--checkepoch", "1", *flags,
                           "--set", *TINY_SET])
    finally:
        os.chdir(cwd)
    return capsys.readouterr().out


def test_trainval_writes_the_epoch_checkpoint_and_trace(chain):
    r = chain["result"]
    assert r["step"] == 2 and r["checkpoints"] == [os.path.join(
        "models", "tiny", "pascal_voc", "faster_rcnn_1_1.pth")]
    stats = r["epochs"][0]
    assert (stats["epoch"], stats["steps"], stats["images"], stats["steady_images"]) == (1, 2, 4, 2)
    assert stats["assembly_ms_per_image"] > 0 and stats["save_ms"] > 0
    ck = read_checkpoint(chain["ckpt"])
    assert (ck["session"], ck["epoch"], ck["step"], ck["scheduler"]["last_epoch"]) == (1, 1, 2, 2)
    assert ck["pooling_mode"] == "crop" and len(ck["classes"]) == 21
    assert ck["classes"][:3] == ["__background__", "aeroplane", "bicycle"]
    assert len(ck["optimizer"]["state"]) == 20
    trace = chain["work"] / "logs" / "trace" / "trace.json"
    assert trace.exists() and "traceEvents" in trace.read_text()


def test_test_net_scores_the_checkpoint(chain, capsys):
    out = _test_net(chain, capsys)
    assert "Mean AP" in out
    assert "load checkpoint models/tiny/pascal_voc/faster_rcnn_1_1.pth (pooling_mode crop)" in out


def test_test_net_batch_2_gives_the_same_ap_table(chain, capsys):
    ap = lambda out: [l for l in out.splitlines() if "AP" in l]
    assert ap(_test_net(chain, capsys, "--batch", "2")) == ap(_test_net(chain, capsys))


def _detector(chain):
    cfg = cfg_from_list(Config(), TINY_SET)
    payload = read_checkpoint(chain["ckpt"])
    model = FasterRCNN(len(payload["classes"]), "tiny",
                       cfg_from_list(cfg, ["POOLING_MODE", payload["pooling_mode"]]),
                       device="cpu")
    load_checkpoint(payload, model)
    return Detector(model, model.cfg, "cpu")


def test_demo_draws_detector_detect(chain, tmp_path):
    image_dir = chain["root"] / "VOCdevkit2007" / "VOC2007" / "JPEGImages"
    out_dir = tmp_path / "out"
    dets = demo.main(["--net", "tiny", "--image_dir", str(image_dir), "--out_dir", str(out_dir),
                      "--load_name", chain["ckpt"], "--vis_thresh", "0.0", "--device", "cpu",
                      "--set", *TINY_SET])
    names = sorted(os.listdir(image_dir))
    assert sorted(dets) == names and len(names) == 8
    assert sorted(os.listdir(out_dir)) == [n[:-4] + "_det.jpg" for n in names]
    detector = _detector(chain)
    drawn = 0
    for name in names:
        want = detector.detect(read_image_bgr(str(image_dir / name)))
        for got, w in zip(dets[name], want):
            np.testing.assert_array_equal(got, w)
        drawn += int(want[3].sum())
    assert drawn > 0


def test_demo_pad_to_snaps_to_multiples_of_32(chain):
    """`--pad_to 100 150` is the 128×160 canvas; an image that does not fit
    keeps its own shape."""
    detector = _detector(chain)
    detector.pad_to = None
    im = read_image_bgr(str(chain["root"] / "VOCdevkit2007" / "VOC2007" / "JPEGImages" /
                            "000000.jpg"))
    own, info = (t.numpy() for t in detector.inputs(im))
    padded = Detector(detector.model, detector.cfg, "cpu", pad_to=(100, 150))
    assert padded.pad_to == (128, 160)
    blob, info2 = (t.numpy() for t in padded.inputs(im))
    assert blob.shape == (1, 128, 160, 3) and np.array_equal(info, info2)
    h, w = int(info[0, 0]), int(info[0, 1])
    np.testing.assert_array_equal(blob[0, :h, :w], own[0, :h, :w])
    assert not blob[0, h:].any() and not blob[0, :, w:].any()
    small = Detector(detector.model, detector.cfg, "cpu", pad_to=(32, 32))
    assert small.inputs(im)[0].shape == own.shape


@pytest.mark.parametrize("argv,what", [(["--webcam_num", "0"], "cv2"),
                                        (["--net", "tiny", "--device", "cuda:7"], None)])
def test_demo_refusals(argv, what, capsys):
    """The webcam waits for cv2 (exit 2); without a card the default device
    raises rather than run on the CPU."""
    if what is None:
        if torch.cuda.is_available():
            pytest.skip("a card is present: the device resolves")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            demo.main(argv)
        return
    with pytest.raises(SystemExit) as e:
        demo.main(argv)
    assert e.value.code == 2 and what in capsys.readouterr().err


def test_trainval_raises_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the device resolves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainval_net.main(["--dataset", "pascal_voc", "--net", "tiny"])


def test_resume_validate_is_bitwise_on_the_cpu(tmp_path):
    result = resume_validate.main(["--net", "tiny", "--device", "cpu", "--work_dir",
                                   str(tmp_path)])
    assert result["ok"] and result["max_abs_delta"] == 0.0
    assert result["n_leaves"] == 42
    assert result["device"] == "cpu"


def test_logging_helpers_match_jax():
    """AveMeter's window, top-k accuracy and the rank-0 logger."""
    rng = np.random.RandomState(0)
    got, want = port_logging.AveMeter(3), jax_logging.AveMeter(3)
    for v in rng.randn(7):
        got.update(v)
        want.update(v)
        assert got.avg == want.avg and got.val == want.val
    scores, labels = rng.randn(50, 6), rng.randint(0, 6, 50)
    assert port_logging.accuracy(scores, labels, (1, 3)) == jax_logging.accuracy(
        scores, labels, (1, 3))
    log = port_logging.init_log("port_test_log")
    assert port_logging.init_log("port_test_log") is log
    assert len(log.handlers) == 1 and len(log.filters) == 1
