"""The cv2-typed shim of the port: ``tests/test_cv2_compat.py``'s three cases
against cv2 and the reference's shim, and every OpenCV code the port keeps as
a literal against cv2's own constant (the port never imports cv2; this test
may). Float outputs within the repo's 1e-4 (the warp within 2e-2: cv2's CPU
warp quantizes coordinates to 1/32 px)."""

import cv2
import numpy as np
import pytest

from conftest import check_float
from cvgpuspeedup_tpu.interop import cv2_compat as JcvGS
from cvgpuspeedup_tpu_torch.interop import cv2_compat as cvGS


def _run(*ops):
    return cvGS.executeOperations(*ops, device="cpu").numpy()


def test_flagship_via_shim(rng):
    frame = rng.integers(0, 256, (296, 384, 3)).astype(np.uint8)
    rects = [[i, i, 60, 120] for i in range(6)]

    def pipeline(m):
        return (m.resize_batch(frame, rects, (64, 128), usedPlanes=6, backgroundValue=128.0,
                               interpolation=cv2.INTER_LINEAR),
                m.convertTo(cv2.CV_32F, alpha=0.3), m.cvtColor(cv2.COLOR_RGB2BGR),
                m.subtract((3.2, 0.6, 11.8)), m.divide((128.0,) * 3), m.split_tensor())

    out = _run(*pipeline(cvGS))
    assert out.shape == (6, 3, 128, 64)
    crop = frame[2:122, 2:62].astype(np.float32)
    r = cv2.resize(crop, (64, 128)) * np.float32(0.3)
    r = (r[..., ::-1] - np.array([3.2, 0.6, 11.8], np.float32)) / 128.0
    check_float(out[2], r.transpose(2, 0, 1), msg="shim plane 2")
    check_float(out, np.asarray(JcvGS.executeOperations(*pipeline(JcvGS))),
                msg="against the reference's shim")


def test_shim_rejects_unsupported():
    with pytest.raises(ValueError):
        cvGS.cvtColor(cv2.COLOR_BGR2HSV)
    with pytest.raises(ValueError):
        cvGS.resize(np.zeros((8, 8, 3), np.uint8), (4, 4), interpolation=cv2.INTER_CUBIC)
    with pytest.raises(ValueError):
        cvGS.convertTo(7)  # CV_16F


def test_shim_warp_and_crop(rng):
    img = rng.integers(0, 256, (40, 40, 3)).astype(np.uint8)
    m = cv2.getRotationMatrix2D((20, 20), 15, 1.0)
    out = _run(cvGS.warpAffine(img, m, (40, 40)))
    check_float(out, cv2.warpAffine(img.astype(np.float32), m, (40, 40)), tol=2e-2, msg="shim warp")
    check_float(out, np.asarray(JcvGS.executeOperations(JcvGS.warpAffine(img, m, (40, 40)))),
                msg="warp against the reference's shim")
    h = np.array([[1.0, 0.05, 2.0], [0.02, 0.95, 1.0], [1e-4, 2e-4, 1.0]])
    check_float(_run(cvGS.warpPerspective(img, h, (40, 40), borderValue=3.0)),
                np.asarray(JcvGS.executeOperations(JcvGS.warpPerspective(img, h, (40, 40),
                                                                         borderValue=3.0))),
                msg="perspective against the reference's shim")
    c = _run(cvGS.crop(img, (4, 6, 16, 12)))
    assert c.shape == (12, 16, 3) and np.array_equal(c, img[6:18, 4:20])
    bound = _run(cvGS.resize(img, (20, 10)), cvGS.crop((2, 1, 8, 4)), cvGS.write())
    assert bound.shape == (4, 8, 3)


@pytest.mark.parametrize("name", ["CV_8U", "CV_8S", "CV_16U", "CV_16S", "CV_32S", "CV_32F",
                                  "CV_64F", "INTER_LINEAR"])
def test_depth_and_interpolation_literals_are_cv2s(name):
    assert getattr(cvGS, name) == getattr(cv2, name)


@pytest.mark.parametrize("name", sorted(cvGS.CV_COLOR_CODES))
def test_color_code_literals_are_cv2s(name):
    assert cvGS.CV_COLOR_CODES[name] == getattr(cv2, f"COLOR_{name}")
    assert cvGS.cvtColor(getattr(cv2, f"COLOR_{name}")).code.name == JcvGS.cvtColor(
        getattr(cv2, f"COLOR_{name}")).code.name


@pytest.mark.parametrize("cv_type,dtype", [
    ("CV_8UC3", np.uint8), ("CV_8SC1", np.int8), ("CV_16UC4", np.uint16), ("CV_16SC3", np.int16),
    ("CV_32SC2", np.int32), ("CV_32FC3", np.float32), ("CV_64FC1", np.float64)])
def test_mat_type_codes_reduce_to_their_depth(cv_type, dtype):
    code = getattr(cv2, cv_type)
    assert cvGS._dtype_of(code) == dtype == JcvGS._dtype_of(code)
    assert code & cvGS.CV_MAT_DEPTH_MASK == getattr(cv2, cv_type[:-2].rstrip("C"))


def test_the_whitelist_has_sixteen_codes_and_the_shims_surface():
    assert len(cvGS.CV_COLOR_CODES) == 16
    public = lambda m: {n for n in dir(m) if not n.startswith("_") and callable(getattr(m, n))
                        and n[0].islower()}
    assert public(JcvGS) <= public(cvGS)
