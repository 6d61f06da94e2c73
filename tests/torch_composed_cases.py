"""The composed-read kernel's cases C1-C8 and its batches B1-B7 at a reduced
size, built with the factories of either package (``M`` is
``cvgpuspeedup_tpu`` or ``cvgpuspeedup_tpu_torch``: the same names), from
numpy seeds. ``chip_smoke.py`` runs the same compositions at full width (a
1080p frame, a 4K one for C1 and C4, a 6K NV12 buffer for C8; eight 1080p
cameras and the 4K frame for B1-B7).

``mixed_frames`` and ``mixed_cases`` make M1-M6, batches whose planes
differ in geometry (cameras of three resolutions, regions of their own
sizes, letterboxes of their own widths), over each source family.

``frames(h, w)`` makes the inputs for an ``h`` x ``w`` frame (a multiple of
6 on both sides); ``cases(M, f, values)`` the op lists, where ``values`` 1
moves every runtime value (crop origins, the warp's angle, the border
value) and keeps the structure, so it builds no plan. ``cameras(seed)``
and ``batch_cases(M, f, values)`` do the same for B1-B7: five planes of
36x48 cameras from two source arrays, plane 4 a repeat of plane 0.
"""

import numpy as np

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
#: the composed kernel's instance per source dtype, as the C entry of
#: ``csrc/composed.cu`` sends each type code: uint8, float32 (and int32,
#: read as float32's words) have their own, the six other dtypes share one;
#: an NV12 buffer has its own too (``instance``)
INSTANCES = {"uint8": "composed.cu", "float32": "composed_f32.cu", "int32": "composed_f32.cu",
             **dict.fromkeys(("int8", "uint16", "int16", "float16", "int64", "float64"),
                             "composed_any.cu")}
NAMES = ("c1_roi_crop_resize", "c2_compute_what_you_see", "c3_letterbox", "c4_warp_of_a_crop",
         "c5_border_then_resize", "c6_crop_batch", "c7_crop_of_fused_gray",
         "c8_nv12_to_u8_resize")


def rotation(center, angle: float, scale: float = 1.0) -> np.ndarray:
    """``cv2.getRotationMatrix2D``."""
    a = np.deg2rad(angle)
    al, be = scale * np.cos(a), scale * np.sin(a)
    cx, cy = center
    return np.array([[al, be, (1 - al) * cx - be * cy], [-be, al, be * cx + (1 - al) * cy]])


def frames(h: int, w: int, seed: int = 0) -> dict:
    """A frame (h, w, 3), one of twice its sides (C1, C4) and an NV12 buffer
    of three times its sides (C8), uint8."""
    rng = np.random.default_rng(seed)
    return {"hd": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            "big": rng.integers(0, 256, (2 * h, 2 * w, 3), dtype=np.uint8),
            "nv12": rng.integers(0, 256, (3 * h * 3 // 2, 3 * w), dtype=np.uint8)}


def normalize(M):
    return (M.convert_to(np.float32, alpha=1 / 255.0), M.subtract(MEAN), M.divide(STD))


def cases(M, f: dict, values: int = 0) -> dict:
    """``name -> op list`` of C1-C8; C1-C7 read ``f["hd"]`` and ``f["big"]``
    whatever their dtype."""
    hd, big, nv12 = f["hd"], f["big"], f["nv12"]
    h, w = hd.shape[:2]
    dst = M.Size(w // 3, h // 3)
    roi = M.Rect(w // 2 + 3 * values, h // 2 - 2 * values, w, h)
    pad = (w // 3 - h // 3) // 2
    side = h // 5
    origins = [(k * (w - side) // 15, (k * 7) % (h - side)) for k in range(16)]
    origins[3] = (w - side // 2, 5 + values)  # off the frame's right edge: clamped
    origins[9] = (-3 - values, 7)             # left of it: from the far edge, then clamped
    if values:
        origins = [(x + 1, y) for x, y in origins]
    return {
        "c1_roi_crop_resize": (M.resize(M.crop(M.image(big), roi), dst), *normalize(M),
                               M.split_tensor()),
        "c2_compute_what_you_see": (
            M.resize(M.fuse(M.image(hd), M.vector_reorder(2, 1, 0),
                            M.convert_to(np.float32, alpha=1 / 255.0)), dst),
            M.split_tensor()),
        "c3_letterbox": (
            M.make_border(M.resize(M.image(hd), dst), pad, pad, 0, 0, M.BorderMode.CONSTANT,
                          114 - 14 * values),
            M.convert_to(np.float32, alpha=1 / 255.0), M.split_tensor()),
        "c4_warp_of_a_crop": (
            M.warp(M.crop(M.image(big), roi), rotation((w / 2, h / 2), 10.0 + 5 * values),
                   M.Size(w, h)),
            *normalize(M), M.split_tensor()),
        "c5_border_then_resize": (
            M.resize(M.make_border(M.image(hd), 8, 8, 8, 8, M.BorderMode.REFLECT_101), dst),
            *normalize(M), M.split_tensor()),
        "c6_crop_batch": (M.crop_batch(hd, [M.Rect(x, y, side, side) for x, y in origins]),
                          *normalize(M), M.split_tensor()),
        "c7_crop_of_fused_gray": (
            M.crop(M.fuse(M.image(hd), M.cvt_color(M.ColorConversionCode.COLOR_RGB2GRAY)),
                   M.Rect(w // 6 + values, h // 6, 2 * w // 3, 2 * h // 3)),
            M.convert_to(np.float32), M.write()),
        "c8_nv12_to_u8_resize": (
            M.resize(M.fuse(M.read_yuv(nv12), M.convert_yuv_to_rgb(out_dtype=np.uint8)),
                     M.Size(w, h)),
            M.split_tensor()),
    }


BATCH_NAMES = ("b1_cameras_resized", "b2_cameras_resized_ragged", "b3_rois_resized",
               "b4_letterboxes", "b5_warps_of_crops", "b6_crops_of_a_frame_ragged",
               "b7_bare_cameras")
#: the source array of each of the five planes (plane 4 repeats plane 0)
PLANE_SRC = (0, 1, 0, 1, 0)


def cameras(seed: int = 0, h: int = 36, w: int = 48) -> dict:
    """Two uint8 cameras (h, w, 3) and a frame of twice their sides."""
    rng = np.random.default_rng(seed)
    return {"cams": [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(2)],
            "big": rng.integers(0, 256, (2 * h, 2 * w, 3), dtype=np.uint8)}


def batch_cases(M, f: dict, values: int = 0, used=None, default=0.0) -> dict:
    """``name -> op list`` of B1-B7 over ``f["cams"]`` (plane z reads
    ``cams[PLANE_SRC[z]]``) and ``f["big"]``; ``values`` 1 moves every
    runtime value (origins, angles, the border value, ``used_planes``).
    ``used`` and ``default`` replace B2's and B6's ``used_planes`` and
    default."""
    cams, big = f["cams"], f["big"]
    h, w = cams[0].shape[:2]
    srcs = [cams[k] for k in PLANE_SRC]
    n = len(srcs)
    ragged = dict(used_planes=(3 - values) if used is None else used, default=default)
    roi = [((7 * z + 3 * values) % (w - 20), (5 * z + values) % (h - 15)) for z in range(n)]
    roi[3] = (-4 - values, 30)   # from the far edge, then clamped (dynamic_slice)
    roi[4] = roi[0]
    crops = [((11 * z + values) % (2 * w - 12), (13 * z) % (2 * h - 12)) for z in range(n)]
    crops[2] = (2 * w - 5, 3 + values)  # off the frame's right edge: clamped
    angles = [5.0 + 35.0 * z / (n - 1) + 3 * values for z in range(n)]
    angles[4] = angles[0]
    return {
        "b1_cameras_resized": (M.batch_read([M.resize(M.image(s), M.Size(24, 16)) for s in srcs]),
                               *normalize(M), M.split_tensor()),
        "b2_cameras_resized_ragged": (
            M.batch_read([M.resize(M.image(s), M.Size(24, 16)) for s in srcs], **ragged),
            *normalize(M), M.split_tensor()),
        "b3_rois_resized": (
            M.batch_read([M.resize(M.crop(M.image(s), M.Rect(x, y, 20, 15)), M.Size(12, 12))
                          for s, (x, y) in zip(srcs, roi)]),
            *normalize(M), M.split_tensor()),
        "b4_letterboxes": (
            M.batch_read([M.make_border(M.resize(M.image(s), M.Size(24, 14)), 5, 5, 0, 0,
                                        M.BorderMode.CONSTANT, 114 - 14 * values) for s in srcs]),
            M.convert_to(np.float32, alpha=1 / 255.0), M.split_tensor()),
        "b5_warps_of_crops": (
            M.batch_read([M.warp(M.crop(M.image(s), M.Rect(2 * z + values, z, 24, 18)),
                                 rotation((12, 9), a), M.Size(24, 16))
                          for z, (s, a) in enumerate(zip(srcs, angles))]),
            *normalize(M), M.split_tensor()),
        "b6_crops_of_a_frame_ragged": (
            M.batch_read([M.crop(M.image(big), M.Rect(x, y, 12, 12)) for x, y in crops],
                         **ragged),
            *normalize(M), M.split_tensor()),
        "b7_bare_cameras": (M.batch_read([M.image(s) for s in srcs]), M.convert_to(np.float32),
                            M.write_tensor()),
    }


MIXED_NAMES = ("m1_cameras_resized", "m2_cameras_resized_ragged", "m3_rois_resized",
               "m4_letterboxes", "m5_warps_of_crops", "m6_crops_of_cameras")
#: the source families of the composed kernel's instances: uint8, float32,
#: the shared "any" instance (int16) and NV12 buffers
FAMILIES = ("uint8", "float32", "int16", "nv12")
#: the mixed batches' cameras (h, w): three resolutions; an NV12 buffer's
#: image even on both sides
MIXED_SIZES = ((29, 37), (48, 64), (41, 23))
MIXED_NV12_SIZES = ((28, 36), (48, 64), (40, 22))
MIXED_BIG = (60, 80)
MIXED_DST = (16, 12)


def _family_frame(rng, family: str, h: int, w: int) -> np.ndarray:
    if family == "nv12":
        return rng.integers(0, 256, (h * 3 // 2, w), dtype=np.uint8)
    if family == "float32":
        return (rng.random((h, w, 3)) * 255).astype(np.float32)
    if family == "int16":
        return rng.integers(-2000, 2000, (h, w, 3)).astype(np.int16)
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8).astype(family)


def mixed_frames(family: str = "uint8", seed: int = 0, sizes=None) -> dict:
    """Three cameras of three resolutions (``MIXED_SIZES``, or
    ``MIXED_NV12_SIZES`` for NV12 buffers, unless ``sizes``) and a frame of
    ``MIXED_BIG``, of one source family (``FAMILIES``, or any numpy dtype's
    name), from a numpy seed."""
    rng = np.random.default_rng(seed)
    sizes = sizes or (MIXED_NV12_SIZES if family == "nv12" else MIXED_SIZES)
    return {"family": family, "cams": [_family_frame(rng, family, h, w) for h, w in sizes],
            "big": _family_frame(rng, family, *MIXED_BIG)}


def letterbox(w: int, h: int, side: int):
    """``(inner (w, h), (top, bottom, left, right))`` of a ``w`` x ``h``
    region resized into a ``side`` x ``side`` square, aspect kept, centred."""
    scale = side / max(w, h)
    iw, ih = max(1, round(w * scale)), max(1, round(h * scale))
    top, left = (side - ih) // 2, (side - iw) // 2
    return (iw, ih), (top, side - ih - top, left, side - iw - left)


def rotation_to(center, angle: float, scale: float, to) -> np.ndarray:
    """:func:`rotation` about ``center`` whose centre lands on ``to``."""
    m = rotation(center, angle, scale)
    m[:, 2] += np.asarray(to, np.float64) - np.asarray(center, np.float64)
    return m


def mixed_cases(M, f: dict, values: int = 0, used=None, default=0.0) -> dict:
    """``name -> op list`` of the batches whose planes share one shape but
    not one geometry, over ``f`` (:func:`mixed_frames`): M1 the three
    cameras each resized to ``MIXED_DST`` and normalized; M2 M1 with
    ``used_planes`` 2 (1 with ``values``), default 0, unless ``used`` and
    ``default``; M3 regions of interest of three sizes and aspects of
    ``f["big"]`` resized; M4 such regions letterboxed into a 16x16 square
    (each its own inner size and border widths, CONSTANT 114); M5 crops of
    three sizes of the cameras, each rotated about its centre into
    ``MIXED_DST``; M6 crops of one size from the three cameras (the
    one-pixel core). An NV12 family reads each frame as C8 does, converted
    into uint8 RGB per tap (``fuse(read_yuv, convert_yuv_to_rgb)``).
    ``values`` 1 moves every runtime value (origins, angles, the border
    value, ``used_planes``) and keeps every size."""
    cams, big = f["cams"], f["big"]
    nv12 = f.get("family") == "nv12"

    def base(src):
        if nv12:
            return M.fuse(M.read_yuv(src), M.convert_yuv_to_rgb(out_dtype=np.uint8))
        return M.image(src)

    def side(src):  # (h, w) of a frame's image
        return (src.shape[0] * 2 // 3, src.shape[1]) if nv12 else src.shape[:2]

    dst = M.Size(*MIXED_DST)
    bh, bw = side(big)
    rois = [(20, 15), (12, 30), (33, 9)]
    roi_at = [((7 * z + 3 * values) % (bw - rw), (5 * z + 2 * values) % (bh - rh))
              for z, (rw, rh) in enumerate(rois)]
    roi_at[2] = (bw - 33 - values, 4)  # at the frame's right edge
    boxes = [(22, 16), (12, 20), (18, 18)]
    crops = [(20, 15), (24, 18), (14, 22)]
    angles = [5.0 + 17.5 * z + 3 * values for z in range(3)]
    ragged = dict(used_planes=(2 - values) if used is None else used, default=default)
    letterboxed = []
    for z, (rw, rh) in enumerate(boxes):
        (iw, ih), (t, b, l, r) = letterbox(rw, rh, 16)
        x, y = (3 * z + values) % (bw - rw), (2 * z + 1) % (bh - rh)
        letterboxed.append(M.make_border(M.resize(M.crop(base(big), M.Rect(x, y, rw, rh)),
                                                  M.Size(iw, ih)),
                                         t, b, l, r, M.BorderMode.CONSTANT, 114 - 14 * values))
    warped = []
    for z, (src, (cw, ch), a) in enumerate(zip(cams, crops, angles)):
        h, w = side(src)
        x, y = (z + values) % (w - cw + 1), (2 * z) % (h - ch + 1)
        warped.append(M.warp(M.crop(base(src), M.Rect(x, y, cw, ch)),
                             rotation_to((cw / 2, ch / 2), a, 0.8, (dst.width / 2,
                                                                    dst.height / 2)), dst))
    cropped = []
    for z, src in enumerate(cams):
        h, w = side(src)
        x, y = (5 * z + values) % (w - 10), (3 * z) % (h - 8)
        if z == 1:
            x = -4 - values  # from the far edge, then clamped (dynamic_slice)
        cropped.append(M.crop(base(src), M.Rect(x, y, 10, 8)))
    resized = [M.resize(base(c), dst) for c in cams]
    return {
        "m1_cameras_resized": (M.batch_read(resized), *normalize(M), M.split_tensor()),
        "m2_cameras_resized_ragged": (M.batch_read(resized, **ragged), *normalize(M),
                                      M.split_tensor()),
        "m3_rois_resized": (
            M.batch_read([M.resize(M.crop(base(big), M.Rect(x, y, rw, rh)), dst)
                          for (rw, rh), (x, y) in zip(rois, roi_at)]),
            *normalize(M), M.split_tensor()),
        "m4_letterboxes": (M.batch_read(letterboxed), M.convert_to(np.float32, alpha=1 / 255.0),
                           M.split_tensor()),
        "m5_warps_of_crops": (M.batch_read(warped), *normalize(M), M.split_tensor()),
        "m6_crops_of_cameras": (M.batch_read(cropped), *normalize(M), M.split_tensor()),
    }


NESTED_NAMES = ("n1_top_view_resized", "n2_resize_then_rotate", "n3_two_level_downscale",
                "n4_crop_of_a_downscale_resized", "n5_letterbox_of_a_normalized_resize",
                "n6_top_views_of_8_cameras_ragged")
#: the planes of N6, and the planes it uses
N6_PLANES, N6_USED = 8, 6


def top_view(w: int, h: int, k: int = 0) -> np.ndarray:
    """A homography of a road camera's frame to a top view, of a ``w`` x
    ``h`` frame into the same size: the trapezoid the road fills widened
    into a rectangle; ``k`` tilts it a little (a camera of its own)."""
    unit = np.array([[1.0, -0.25 - 0.02 * k, 0.125 + 0.01 * k], [0.0, 0.7, 0.1 + 0.005 * k],
                     [0.0, -0.4 + 0.01 * k, 1.0]])
    return np.diag([w, h, 1.0]) @ unit @ np.diag([1.0 / w, 1.0 / h, 1.0])


def nested_frames(h: int, w: int, seed: int = 0) -> dict:
    """A frame (h, w, 3), one of twice its sides, and N6's cameras of h x w,
    uint8."""
    rng = np.random.default_rng(seed)
    return {"hd": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            "big": rng.integers(0, 256, (2 * h, 2 * w, 3), dtype=np.uint8),
            "cams": [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(N6_PLANES)]}


def nested_cases(M, f: dict, values: int = 0) -> dict:
    """``name -> op list`` of N1-N6, two levels of resampling or a fused
    read above the core: N1 a top view (a perspective warp, CONSTANT 0) of
    ``f["hd"]`` resized to a third; N2 ``f["big"]`` resized to a third and
    rotated 10 degrees about its centre; N3 ``f["big"]`` resized to half,
    then to a sixth; N4 a crop of half of that half resized to a square;
    N5 a letterbox of a resize of ``f["hd"]`` fused with x1/255, its border
    value already normalized, no chain; N6 N1 of each of ``f["cams"]``, its
    own homography, ``used_planes`` 6, default 0. ``values`` 1 moves every
    runtime value (the maps, the crop's origin, the border value,
    ``used_planes``) and keeps the structure."""
    hd, big, cams = f["hd"], f["big"], f["cams"]
    h, w = hd.shape[:2]
    third = M.Size(w // 3, h // 3)
    persp = dict(warp_type=M.WarpType.PERSPECTIVE, default=0.0)
    mid = M.Size(2 * w // 3, 2 * h // 3)
    side = h // 4
    pad = (w // 3 - h // 3) // 2
    return {
        "n1_top_view_resized": (
            M.resize(M.warp(M.image(hd), top_view(w, h, values), M.Size(w, h), **persp), third),
            *normalize(M), M.split_tensor()),
        "n2_resize_then_rotate": (
            M.warp(M.resize(M.image(big), mid),
                   rotation((mid.width / 2, mid.height / 2), 10.0 + 5 * values), mid),
            *normalize(M), M.split_tensor()),
        "n3_two_level_downscale": (
            M.resize(M.resize(M.image(big), M.Size(w, h)), third), *normalize(M),
            M.split_tensor()),
        "n4_crop_of_a_downscale_resized": (
            M.resize(M.crop(M.resize(M.image(big), M.Size(w, h)),
                            M.Rect(w // 4 + values, h // 4 - values, w // 2, h // 2)),
                     M.Size(side, side)),
            *normalize(M), M.split_tensor()),
        "n5_letterbox_of_a_normalized_resize": (
            M.make_border(M.fuse(M.resize(M.image(hd), third),
                                 M.convert_to(np.float32, alpha=1 / 255.0)),
                          pad, pad, 0, 0, M.BorderMode.CONSTANT, 0.447 - 0.1 * values),
            M.split_tensor()),
        "n6_top_views_of_8_cameras_ragged": (
            M.batch_read([M.resize(M.warp(M.image(c), top_view(w, h, k + values), M.Size(w, h),
                                          **persp), third) for k, c in enumerate(cams)],
                         used_planes=N6_USED - values, default=0.0),
            *normalize(M), M.split_tensor()),
    }


NESTED_MIXED_NAMES = ("nm1_top_views_of_cameras_of_3_sizes_ragged",
                      "nm2_normalized_letterboxes_of_rois", "nm3_half_size_resize_then_rotate",
                      "nm4_roi_crops_of_a_downscale")
#: NM4's middle image (w, h), the crops of it (w, h) and their output side:
#: a crop smaller than the output is an upscale, whose tiles share taps
#: (``stage2`` 1), a larger one a downscale (``stage2`` 0)
NM4_MID, NM4_CROPS, NM4_SIDE = (40, 30), ((6, 4), (24, 18), (5, 5)), 12


def nested_mixed_cases(M, f: dict, values: int = 0, used=None, default=0.0) -> dict:
    """``name -> op list`` of the batches of nested planes that share one
    shape but not one geometry, over ``f`` (:func:`mixed_frames`): NM1 N6's
    tree over the three cameras, each warped to its own top view at its own
    size (perspective, CONSTANT 0), then resized to ``MIXED_DST``, with
    ``used_planes`` 2 (1 with ``values``), default 0, unless ``used`` and
    ``default``; NM2 N5's tree at M4's geometry: regions of three sizes of
    ``f["big"]`` each resized into its letterbox's inner size, fused with
    x1/255 and bordered (CONSTANT 0.447) into a 16x16 square, no chain; NM3
    each camera resized to half its size, then rotated about its centre
    into ``MIXED_DST`` at the scale that fits; NM4 each camera resized to
    ``NM4_MID``, then a crop of one of ``NM4_CROPS`` resized to a square of
    ``NM4_SIDE`` (its planes disagree on ``stage2``). All planar float32,
    normalized as M1 unless said; every region inside its frame. An NV12
    family reads each frame as C8 does. ``values`` 1 moves every runtime
    value (the maps, origins, angles, the border value, ``used_planes``)
    and keeps every size."""
    cams, big = f["cams"], f["big"]
    nv12 = f.get("family") == "nv12"

    def base(src):
        if nv12:
            return M.fuse(M.read_yuv(src), M.convert_yuv_to_rgb(out_dtype=np.uint8))
        return M.image(src)

    def side(src):  # (h, w) of a frame's image
        return (src.shape[0] * 2 // 3, src.shape[1]) if nv12 else src.shape[:2]

    dst = M.Size(*MIXED_DST)
    persp = dict(warp_type=M.WarpType.PERSPECTIVE, default=0.0)
    ragged = dict(used_planes=(2 - values) if used is None else used, default=default)
    top_views = []
    for k, src in enumerate(cams):
        h, w = side(src)
        top_views.append(M.resize(M.warp(base(src), top_view(w, h, k + values), M.Size(w, h),
                                         **persp), dst))
    bh, bw = side(big)
    boxes = []
    for z, (rw, rh) in enumerate(((22, 16), (12, 20), (18, 18))):
        (iw, ih), (t, b, l, r) = letterbox(rw, rh, 16)
        x, y = (3 * z + values) % (bw - rw), (2 * z + 1) % (bh - rh)
        boxes.append(M.make_border(
            M.fuse(M.resize(M.crop(base(big), M.Rect(x, y, rw, rh)), M.Size(iw, ih)),
                   M.convert_to(np.float32, alpha=1 / 255.0)),
            t, b, l, r, M.BorderMode.CONSTANT, 0.447 - 0.1 * values))
    rotated = []
    for z, src in enumerate(cams):
        h, w = side(src)
        half = M.Size(w // 2, h // 2)
        scale = min(dst.width / half.width, dst.height / half.height)
        rotated.append(M.warp(M.resize(base(src), half),
                              rotation_to((half.width / 2, half.height / 2),
                                          5.0 + 17.5 * z + 3 * values, scale,
                                          (dst.width / 2, dst.height / 2)), dst))
    mw, mh = NM4_MID
    rois = []
    for z, (src, (cw, ch)) in enumerate(zip(cams, NM4_CROPS)):
        x, y = (7 * z + 2 * values) % (mw - cw), (5 * z + values) % (mh - ch)
        rois.append(M.resize(M.crop(M.resize(base(src), M.Size(mw, mh)), M.Rect(x, y, cw, ch)),
                             M.Size(NM4_SIDE, NM4_SIDE)))
    return {
        "nm1_top_views_of_cameras_of_3_sizes_ragged": (
            M.batch_read(top_views, **ragged), *normalize(M), M.split_tensor()),
        "nm2_normalized_letterboxes_of_rois": (M.batch_read(boxes), M.split_tensor()),
        "nm3_half_size_resize_then_rotate": (M.batch_read(rotated), *normalize(M),
                                             M.split_tensor()),
        "nm4_roi_crops_of_a_downscale": (M.batch_read(rois), *normalize(M), M.split_tensor()),
    }


def centred(m: np.ndarray, center, to) -> np.ndarray:
    """A forward map ``m`` (2x3) moved so that ``center`` lands on ``to``."""
    m = np.array(m, np.float64)
    m[:, 2] += np.asarray(to, np.float64) - m[:, :2] @ np.asarray(center) - m[:, 2]
    return m


def more_nested_cases(M, u8_border=300.0) -> dict:
    """Other two-level trees at a small size: a warp of a warp, NV12 into
    uint8 under a warp under a resize, CONSTANT borders above and below an
    int32 FusedRead2, a fused gray above the core, an int16 fused read under
    a crop under a resize under a warp, a REFLECT border between two
    resizes, a uint8 FusedRead2 under a saturating CONSTANT border,
    FusedRead chains of 300 rows at either level (their tables staged in
    chunks), a warp at a quarter of the scale of a 200x150 resize (a
    16x16 block's footprint past the staging budget: it evaluates per tap)
    and a 2.5x upscale of a downscale (a block's taps shared, under one
    core value a pixel). ``u8_border`` is the saturating border's value: the
    reference's lowering casts a numpy value with numpy (it wraps), a
    device value with XLA's convert (it saturates, as the port does), so
    the reference is given a ``jnp`` value."""
    img, big = _img((36, 48, 3), 21), _img((72, 96, 3), 22)
    nv12 = _img((36 * 3 // 2, 48), 23)
    m1, m2 = rotation((24, 18), 12.0), rotation((20, 15), -8.0)
    persp = np.array([[0.9, 0.05, 2.0], [-0.04, 1.1, 1.0], [0.001, -0.0005, 1.0]])
    gray = M.ColorConversionCode.COLOR_RGB2GRAY
    loop = M.static_loop(M.multiply(1.001), 300)
    return {
        "warp_of_a_warp": (
            M.warp(M.warp(M.image(img), m1, M.Size(40, 30), default=(5.0, 6.0, 7.0)), m2,
                   M.Size(32, 24), default=-3.0),
            M.split_tensor()),
        "resize_of_a_warp_of_nv12_to_u8": (
            M.resize(M.warp(M.fuse(M.read_yuv(nv12), M.convert_yuv_to_rgb(out_dtype=np.uint8)),
                            m1, M.Size(40, 30)), M.Size(20, 14)),
            M.split_tensor()),
        "resize_of_borders_around_a_fused_int32_resize": (
            M.resize(M.make_border(M.fuse(M.make_border(M.resize(M.image(img), M.Size(30, 20)),
                                                        2, 1, 3, 2, M.BorderMode.CONSTANT, -7),
                                          M.convert_to(np.int32, alpha=70000.0)),
                                   1, 3, 2, 1, M.BorderMode.CONSTANT, 9), M.Size(22, 17)),
            M.convert_to(np.float32, alpha=1e-4), M.split_tensor()),
        "crop_of_fused_gray_of_a_resize": (
            M.crop(M.fuse(M.resize(M.image(big), M.Size(40, 30)), M.cvt_color(gray)),
                   M.Rect(3, 4, 30, 20)),
            M.write()),
        "warp_of_a_resize_of_a_crop_of_a_fused_int16_read": (
            M.warp(M.resize(M.crop(M.fuse(M.image(img), M.convert_to(np.int16, alpha=-3.0)),
                                   M.Rect(-5, 2, 40, 30)), M.Size(33, 25)),
                   persp, M.Size(30, 22), warp_type=M.WarpType.PERSPECTIVE, default=7.0),
            M.split_tensor()),
        "resize_of_a_reflect_border_of_a_resize": (
            M.resize(M.make_border(M.resize(M.image(big), M.Size(40, 30)), 3, 3, 4, 4,
                                   M.BorderMode.REFLECT), M.Size(21, 16)),
            *normalize(M), M.split_tensor()),
        "border_of_a_fused_u8_resize": (
            M.make_border(M.fuse(M.resize(M.image(img), M.Size(20, 14)),
                                 M.convert_to(np.uint8, alpha=1.3)),
                          2, 2, 1, 1, M.BorderMode.CONSTANT, u8_border),
            M.write()),
        "resize_of_a_long_fused_chain_of_a_resize": (
            M.resize(M.fuse(M.resize(M.image(img), M.Size(30, 20)), loop), M.Size(17, 13)),
            M.split_tensor()),
        "resize_of_a_resize_of_a_long_fused_chain": (
            M.resize(M.resize(M.fuse(M.image(img), M.convert_to(np.float32), loop),
                              M.Size(30, 20)), M.Size(17, 13)),
            M.split_tensor()),
        "quarter_scale_warp_of_a_resize": (
            M.warp(M.resize(M.image(big), M.Size(200, 150)),
                   centred(rotation((100, 75), 10.0, 0.25), (100, 75), (25, 19)), M.Size(50, 38),
                   default=(1.0, 2.0, 3.0)),
            *normalize(M), M.split_tensor()),
        "upscale_of_a_downscale": (
            M.resize(M.resize(M.image(big), M.Size(40, 30)), M.Size(100, 75)), *normalize(M),
            M.split_tensor()),
    }


#: forward maps whose inverse holds -1e-39 at c01, then at c10 (the
#: factories invert on the host)
SUBNORMAL_MAPS = {"c01": ((1, 1e-39, 0), (0, 1, 0)), "c10": ((1, 0, 0), (1e-39, 1, 0))}


def subnormal_source(seed: int = 9):
    """A float32 (1024, 40, 3) source of -3..3: -1e-39 * Y is a normal
    float from Y = 12 on, where a flushed product is 0."""
    return np.random.default_rng(seed).uniform(-3, 3, (1024, 40, 3)).astype(np.float32)


def subnormal_map_cases(M, src) -> dict:
    """A warp map with a subnormal coefficient at either level of a nested
    read, an infinite border channel: the outer level's warp of a resize
    (c01, then c10), and a resize of the inner level's warp."""
    m = {k: np.array(v) for k, v in SUBNORMAL_MAPS.items()}
    size, border = M.Size(40, 1024), (np.inf, -2.0, 5.0)
    return {
        **{f"warp_{k}_of_a_resize": (
            M.warp(M.resize(M.image(src), M.Size(40, 1024)), m[k], size, default=border),
            M.write()) for k in m},
        **{f"resize_of_a_warp_{k}": (
            M.resize(M.warp(M.image(src), m[k], size, default=border), M.Size(20, 512)),
            M.write()) for k in m},
    }


def _img(shape, seed, dtype=np.uint8):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(dtype)


def more_cases(M) -> dict:
    """The other compositions the reference fuses, at a small size: every
    border mode somewhere, a perspective warp, NV21 in limited range, an
    int16 and an int32 fused chain, stages on both sides of a fused read."""
    img, big = _img((36, 48, 3), 1), _img((72, 96, 3), 2)
    nv12 = _img((36 * 3 // 2, 48), 3)
    m = rotation((24, 18), 15.0)
    persp = np.array([[0.9, 0.05, 2.0], [-0.04, 1.1, 1.0], [0.001, -0.0005, 1.0]])
    gray = M.ColorConversionCode.COLOR_RGB2GRAY
    return {
        "resize_of_a_border": (M.resize(M.make_border(M.image(img), 3, 5, 2, 4,
                                                      M.BorderMode.CONSTANT, 9), M.Size(20, 16)),
                               M.split_tensor()),
        "crop_of_a_resize": (M.crop(M.resize(M.image(big), M.Size(64, 48)),
                                    M.Rect(5, 7, 32, 24)), M.write()),
        "warp_of_a_border": (M.warp(M.make_border(M.image(img), 4, 4, 4, 4, M.BorderMode.WRAP), m,
                                    M.Size(40, 30)), M.split_tensor()),
        "warp_of_a_fused_read": (M.warp(M.fuse(M.image(img), M.convert_to(np.float32, alpha=0.5)),
                                        m, M.Size(40, 30), default=(1.0, 2.0, 3.0)),
                                 M.split_tensor()),
        "perspective_warp_of_a_crop": (
            M.warp(M.crop(M.image(big), M.Rect(-7, 3, 60, 40)), persp, M.Size(50, 36),
                   warp_type=M.WarpType.PERSPECTIVE, default=7.0),
            M.convert_to(np.uint8), M.split_tensor()),
        "crop_of_fused_gray": (M.crop(M.fuse(M.image(img), M.cvt_color(gray)),
                                      M.Rect(4, 2, 30, 20)), M.write()),
        "resize_of_nv12_to_u8": (M.resize(M.fuse(M.read_yuv(nv12), M.convert_yuv_to_rgb(
            out_dtype=np.uint8)), M.Size(20, 14)), M.split_tensor()),
        "resize_of_a_crop_of_nv21_limited": (
            M.resize(M.crop(M.fuse(M.read_yuv(nv12, M.PixelFormat.NV21),
                                   M.convert_yuv_to_rgb(M.ColorRange.LIMITED,
                                                        M.ColorStandard.BT709, alpha=True)),
                            M.Rect(6, 4, 30, 24)), M.Size(20, 14)),
            M.split_tensor()),
        "border_of_a_crop_of_a_resize": (
            M.make_border(M.crop(M.resize(M.image(big), M.Size(64, 48)), M.Rect(1, 2, 40, 30)),
                          2, 2, 3, 3, M.BorderMode.REFLECT, 0),
            M.multiply(2.0), M.write()),
        "resize_of_a_border_over_a_fused_int16_read": (
            M.resize(M.make_border(M.fuse(M.image(img), M.convert_to(np.int16, alpha=-3.0)),
                                   2, 2, 2, 2, M.BorderMode.CONSTANT, -7), M.Size(30, 25)),
            M.split_tensor()),
        "resize_of_a_fused_int32_read_over_a_border": (
            M.resize(M.fuse(M.make_border(M.image(img), 3, 1, 2, 2, M.BorderMode.REPLICATE),
                            M.convert_to(np.int32, alpha=70000.0)), M.Size(22, 17)),
            M.convert_to(np.float32, alpha=1e-4), M.split_tensor()),
        "fused_gray_under_a_border_of_a_crop": (
            M.make_border(M.crop(M.fuse(M.crop(M.image(big), M.Rect(10, 5, 50, 40)),
                                        M.cvt_color(gray)), M.Rect(3, 4, 30, 20)),
                          1, 2, 3, 4, M.BorderMode.CONSTANT, 200),
            M.write()),
    }


def instance(plan) -> tuple:
    """The source file of the kernel instance a ``ComposedPlan`` launches
    and its taps per output pixel (1 without a resample, else 4); a batch
    whose planes differ in geometry launches its kind's mixed-geometry
    instance from the same file."""
    src = "composed_nv12.cu" if plan.base == "yuv" else INSTANCES[str(plan.src_dtype)[6:]]
    return src, 1 if plan.core == "none" else 4


def pixels_per_thread(outputs: int, resident: int, taps: int = 1) -> int:
    """The adjacent output pixels a thread of the composed kernel takes, as
    ``csrc/composed.cuh::kc::pixels_per_thread`` chooses them from a
    launch's output pixels (planes x rows x columns), the card's resident
    threads (SMs x threads per SM: 270,336 on an H100) and the taps per
    pixel (``instance``): a one-pixel read 4 where a thread per 4 pixels
    still fills half of the resident threads, else 1; a resample 1."""
    return 4 if taps == 1 and outputs >= 2 * resident else 1


DIVERGENT_NAMES = ("dv1_letterboxes_and_warps", "dv2_rois_of_two_sensors",
                   "dv3_store_casts_and_a_ragged_group", "dv4_one_pixel_groups")
#: each divergent case's output side at the test size (``chip_smoke.py``:
#: 640, 224, 320 and 256)
DIVERGENT_SIDES = {"dv1": 16, "dv2": 12, "dv3": 16, "dv4": 16}


def divergent_frames(seed: int = 0, scale: int = 1, sensor_dtype: str = "uint16") -> dict:
    """The divergent cases' inputs, uint8 from a numpy seed: eight 16:9
    cameras (``wide``, 36x64 times ``scale``), eight 4:3 ones (``four3``,
    48x64), a frame (``big``, 64x96) and a 3-channel sensor frame
    (``sensor``, 48x64, 12-bit values, of ``sensor_dtype``)."""
    rng = np.random.default_rng(seed)

    def img(h, w, n=None):
        shape = (h * scale, w * scale, 3)
        if n is None:
            return rng.integers(0, 256, shape, dtype=np.uint8)
        return [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(n)]

    sensor = rng.integers(0, 4096, (48 * scale, 64 * scale, 3))
    if sensor_dtype in ("int8", "uint8"):
        sensor = sensor >> 5 if sensor_dtype == "int8" else sensor >> 4
    return {"wide": img(36, 64, 8), "four3": img(48, 64, 8), "big": img(64, 96),
            "sensor": sensor.astype(sensor_dtype)}


def _rois(h: int, w: int, values: int, n: int = 16, lo: float = 0.16, hi: float = 0.65):
    """``n`` regions ``(x, y, w, h)`` of an ``h`` x ``w`` frame, each of its
    own size (a side from ``lo`` to ``hi`` of the frame's height) and
    aspect, ``values`` 1 moving their origins."""
    out = []
    for k in range(n):
        s = max(2, round(h * (lo + (hi - lo) * k / (n - 1))))
        rw, rh = (s, max(2, round(s * 0.75))) if k % 2 else (max(2, round(s * 0.75)), s)
        out.append(((k * 331 + 3 * values) % (w - rw + 1), (k * 173 + 2 * values) % (h - rh + 1),
                    rw, rh))
    return out


def divergent_cases(M, f: dict, values: int = 0) -> dict:
    """``name -> (plane ids, (op list of each sequence))`` of DV1-DV4 over
    :func:`divergent_frames`, with ``M``'s factories (either package):

    - DV1 eight planes, ids ``[1, 1, 2, 2] * 2``: letterboxes of the 16:9
      cameras (a resize to the side's width, CONSTANT 114 above and below)
      beside affine warps of the 4:3 cameras (rotations of 5-15 degrees at
      0.6 of the output's side over the camera's width, the camera's centre
      on the output's), x1/255, -mean, /std, planar;
    - DV2 sixteen planes, ids ``[1, 2] * 8``: regions of interest of their
      own sizes of ``big`` (uint8) resized, x1/255, beside regions of the
      sensor frame, x1/4095, planar;
    - DV3 eight planes into a uint8 batch, ids ``[1, 2] * 4``: the
      letterboxes under ``convert_to(uint8, 0.5, 3.0)`` beside warps of
      crops of the 4:3 cameras under x0.9, +3.25 (float32: truncated and
      saturated into the batch), ragged at ``used_planes`` 3 with a default
      of 300.7, packed;
    - DV4 eight planes, ids ``[1, 2] * 4``: ``crop_batch`` of ``big``
      beside ``make_border(crop)`` of smaller regions of it (a sixteenth of
      the side each way, REFLECT_101), x1/255, planar.

    ``values`` 1 moves every runtime value (origins, angles, the border
    value, ``used_planes``) and keeps every size: no plan."""
    wide, four3, big, sensor = f["wide"], f["four3"], f["big"], f["sensor"]
    seq = M.build_operation_sequence

    def boxes(side):
        h, w = wide[0].shape[:2]
        (iw, ih), (t, b, l, r) = letterbox(w, h, side)
        return M.batch_read([M.make_border(M.resize(M.image(c), M.Size(iw, ih)), t, b, l, r,
                                           M.BorderMode.CONSTANT, 114 - 14 * values)
                             for c in wide])

    def warps(side, crop=None):
        h, w = four3[0].shape[:2]
        out = []
        for k, c in enumerate(four3):
            src = M.image(c)
            cw, ch = w, h
            if crop:
                cw, ch = int(w * crop), int(h * crop)
                src = M.crop(src, M.Rect((3 * k + values) % (w - cw + 1), k % (h - ch + 1),
                                         cw, ch))
            angle = 5.0 + 10.0 * k / 7 + 2.0 * values
            out.append(M.warp(src, rotation_to((cw / 2, ch / 2), angle, 0.6 * side / cw * 2,
                                               (side / 2, side / 2)), M.Size(side, side)))
        return out

    def rois(frame, side):
        h, w = frame.shape[:2]
        return M.batch_read([M.resize(M.crop(M.image(frame), M.Rect(x, y, rw, rh)),
                                      M.Size(side, side)) for x, y, rw, rh in _rois(h, w, values)])

    s1, s2, s3, s4 = (DIVERGENT_SIDES[k] for k in ("dv1", "dv2", "dv3", "dv4"))
    bh, bw = big.shape[:2]
    b4 = max(1, s4 // 16)
    tiles = [((k * 37 + 5 * values) % (bw - s4), (k * 11 + 3 * values) % (bh - s4))
             for k in range(8)]
    inner = [((k * 29 + 3 * values) % (bw - s4), (k * 7 + values) % (bh - s4)) for k in range(8)]
    return {
        "dv1_letterboxes_and_warps": ([1, 1, 2, 2] * 2, (
            (boxes(s1), *normalize(M), M.split_tensor()),
            (M.batch_read(warps(s1)), *normalize(M), M.split_tensor()))),
        "dv2_rois_of_two_sensors": ([1, 2] * 8, (
            (rois(big, s2), M.convert_to(np.float32, alpha=1 / 255.0), M.split_tensor()),
            (rois(sensor, s2), M.convert_to(np.float32, alpha=1 / 4095.0), M.split_tensor()))),
        "dv3_store_casts_and_a_ragged_group": ([1, 2] * 4, (
            (boxes(s3), M.convert_to(np.uint8, alpha=0.5, beta=3.0), M.write_tensor()),
            (M.batch_read(warps(s3, 0.75), used_planes=3 - values, default=300.7),
             M.multiply(0.9), M.add(3.25), M.write_tensor()))),
        "dv4_one_pixel_groups": ([1, 2] * 4, (
            (M.crop_batch(M.image(big), [M.Rect(x, y, s4, s4) for x, y in tiles]),
             M.convert_to(np.float32, alpha=1 / 255.0), M.split_tensor()),
            (M.batch_read([M.make_border(M.crop(M.image(big), M.Rect(x, y, s4 - 2 * b4,
                                                                      s4 - 2 * b4)),
                                         b4, b4, b4, b4, M.BorderMode.REFLECT_101)
                           for x, y in inner]),
             M.convert_to(np.float32, alpha=1 / 255.0), M.split_tensor()))),
    }



DIVERGENT_NESTED_NAMES = ("dvn1_top_views_beside_letterboxes",
                          "dvn2_top_views_beside_rotated_downscales",
                          "dvn3_normalized_letterboxes_beside_a_12bit_sensor",
                          "dvn4_nv12_top_views_beside_nv12_letterboxes")
#: DVN2's top views' ``used_planes`` (one fewer with ``values`` 1), counted
#: over the batch's eight planes
DVN2_USED = 6


def divergent_nested_frames(seed: int = 0, sensor_dtype: str = "uint16") -> dict:
    """The nested divergent cases' inputs from a numpy seed: eight 16:9
    uint8 cameras (``wide``, 36x64), a 3-channel sensor frame (``sensor``,
    48x64, 12-bit values, of ``sensor_dtype``) and eight NV12 buffers of
    36x64 images (``nv12``, 54x64)."""
    rng = np.random.default_rng(seed)
    wide = [rng.integers(0, 256, (36, 64, 3), dtype=np.uint8) for _ in range(8)]
    sensor = rng.integers(0, 4096, (48, 64, 3))
    if sensor_dtype in ("int8", "uint8"):
        sensor = sensor >> 5 if sensor_dtype == "int8" else sensor >> 4
    nv12 = [rng.integers(0, 256, (54, 64), dtype=np.uint8) for _ in range(8)]
    return {"wide": wide, "sensor": sensor.astype(sensor_dtype), "nv12": nv12}


def divergent_nested_cases(M, f: dict, values: int = 0) -> dict:
    """``name -> (plane ids, (op list of each sequence))`` of DVN1-DVN4, the
    divergent batches with a nested group, over
    :func:`divergent_nested_frames` with ``M``'s factories (either package);
    ``side`` is a quarter of a camera's width (16), every plane reads its
    own camera or buffer, every region lies inside its frame:

    - DVN1 eight planes, ids ``[1, 1, 2, 2] * 2``: letterboxes of the
      cameras into ``side`` squares (DV1's: a resize to the side's width,
      CONSTANT 114 above and below) beside top views of the others (a
      perspective warp into the camera's size, CONSTANT 0, then a resize to
      the square), normalized, planar: nested beside one-level;
    - DVN2 eight planes, ids ``[1, 2] * 4``: N6's top views resized to a
      third of the camera (per tap), ``used_planes`` ``DVN2_USED``, default
      0, beside each camera resized to half, then rotated 5-15 degrees
      about its centre at scale 2/3 into that third (staged), normalized,
      planar;
    - DVN3 eight planes, ids ``[1, 2] * 4``: N5's letterboxes (a resize
      fused with x1/255, then CONSTANT 0.447 above and below, no chain: a
      FusedRead2 alone) beside regions of their own sizes of the sensor
      frame resized to half, each resized to the square, x1/4095: two
      source dtypes, the general instances;
    - DVN4 eight planes, ids ``[1, 2] * 4``: DVN1's trees over the NV12
      buffers converted into uint8 RGB per tap (``fuse(read_yuv,
      convert_yuv_to_rgb)``), one conversion.

    ``values`` 1 moves every runtime value (the maps, angles, origins, the
    border values, ``used_planes``) and keeps every size: no plan."""
    wide, sensor, nv12 = f["wide"], f["sensor"], f["nv12"]
    h, w = wide[0].shape[:2]
    side = w // 4
    square, third, half = M.Size(side, side), M.Size(w // 3, h // 3), M.Size(w // 2, h // 2)
    persp = dict(warp_type=M.WarpType.PERSPECTIVE, default=0.0)
    (iw, ih), (t, b, l, r) = letterbox(w, h, side)

    def rgb(buf):
        return M.fuse(M.read_yuv(buf), M.convert_yuv_to_rgb(out_dtype=np.uint8))

    def boxes(reads):
        return M.batch_read([M.make_border(M.resize(src, M.Size(iw, ih)), t, b, l, r,
                                           M.BorderMode.CONSTANT, 114 - 14 * values)
                             for src in reads])

    def top_views(reads, dst, **ragged):
        return M.batch_read([M.resize(M.warp(src, top_view(w, h, k + values), M.Size(w, h),
                                             **persp), dst) for k, src in enumerate(reads)],
                            **ragged)

    rotated = [M.warp(M.resize(M.image(c), half),
                      rotation_to((half.width / 2, half.height / 2), 5.0 + 10.0 * k / 7 + 2 * values,
                                  2 / 3, (third.width / 2, third.height / 2)), third)
               for k, c in enumerate(wide)]
    fused = [M.make_border(M.fuse(M.resize(M.image(c), M.Size(iw, ih)),
                                  M.convert_to(np.float32, alpha=1 / 255.0)),
                           t, b, l, r, M.BorderMode.CONSTANT, 0.447 - 0.1 * values) for c in wide]
    sh, sw = sensor.shape[:2]
    sensor_half = M.Size(sw // 2, sh // 2)
    rois = [M.resize(M.crop(M.resize(M.image(sensor), sensor_half), M.Rect(x, y, rw, rh)), square)
            for x, y, rw, rh in _rois(sh // 2, sw // 2, values, n=8, lo=0.3, hi=0.9)]
    images, buffers = [M.image(c) for c in wide], [rgb(buf) for buf in nv12]
    return {
        "dvn1_top_views_beside_letterboxes": ([1, 1, 2, 2] * 2, (
            (boxes(images), *normalize(M), M.split_tensor()),
            (top_views(images, square), *normalize(M), M.split_tensor()))),
        "dvn2_top_views_beside_rotated_downscales": ([1, 2] * 4, (
            (top_views(images, third, used_planes=DVN2_USED - values, default=0.0),
             *normalize(M), M.split_tensor()),
            (M.batch_read(rotated), *normalize(M), M.split_tensor()))),
        "dvn3_normalized_letterboxes_beside_a_12bit_sensor": ([1, 2] * 4, (
            (M.batch_read(fused), M.split_tensor()),
            (M.batch_read(rois), M.convert_to(np.float32, alpha=1 / 4095.0), M.split_tensor()))),
        "dvn4_nv12_top_views_beside_nv12_letterboxes": ([1, 2] * 4, (
            (boxes(buffers), *normalize(M), M.split_tensor()),
            (top_views(buffers, square), *normalize(M), M.split_tensor()))),
    }


SPLIT_NAMES = ("dk1_ring_beside_letterboxes", "dk2_crops_beside_aligned_faces",
               "dk3_stack_resized_beside_sensor_rois", "dk4_nv12_beside_top_views")
#: the more split batches of ``split_cases``
SPLIT_MORE = ("dk1_ring_descending", "dk5_ragged_groups", "dk6_float_part_into_a_u8_batch",
              "dk7_integer_part_into_a_f32_batch", "dk8_staged_warps_into_a_u16_batch",
              "dk9_fused2_into_a_f16_batch", "ring_beside_a_composed_group",
              "resize_batch_beside_a_composed_group", "nested_group_beside_a_ring")
#: the scale that brings a ring of each dtype to a few hundred
RING_SCALE = {"uint8": 1.0, "int8": 2.0, "uint16": 1 / 16.0, "float16": 1.0}


def _cast(a, dtype: str):
    """``a``, a numpy array or a tensor, as ``dtype`` (a name)."""
    if isinstance(a, np.ndarray):
        return a.astype(dtype)
    import torch

    return a.to(getattr(torch, dtype))


def split_frames(seed: int = 0, ring_dtype: str = "uint8") -> dict:
    """The split batches' inputs from a numpy seed: eight 16:9 uint8
    cameras (``wide``, 36x64), a ring of eight 16x16 planes (``ring``, of
    ``ring_dtype``: uint8 values, int8 halved and centred, uint16 12-bit,
    float16 with a fraction), a frame (``big``, 64x96), a stack of eight
    24x32 images (``stack``), a 3-channel 12-bit uint16 sensor frame
    (``sensor``, 48x64) and eight NV12 buffers of 36x64 images (``nv12``,
    54x64)."""
    rng = np.random.default_rng(seed)
    wide = [rng.integers(0, 256, (36, 64, 3), dtype=np.uint8) for _ in range(8)]
    ring = rng.integers(0, 256, (8, 16, 16, 3))
    ring = {"uint8": ring.astype(np.uint8), "int8": (ring // 2 - 64).astype(np.int8),
            "uint16": (ring * 16 + 7).astype(np.uint16),
            "float16": (ring + 0.25).astype(np.float16)}[ring_dtype]
    return {"wide": wide, "ring": ring,
            "big": rng.integers(0, 256, (64, 96, 3), dtype=np.uint8),
            "stack": rng.integers(0, 256, (8, 24, 32, 3), dtype=np.uint8),
            "sensor": rng.integers(0, 4096, (48, 64, 3)).astype(np.uint16),
            "nv12": [rng.integers(0, 256, (54, 64), dtype=np.uint8) for _ in range(8)]}


def split_cases(M, f: dict, values: int = 0, names=None) -> dict:
    """``name -> (plane ids, (op list of each sequence))`` of the divergent
    batches that neither the divergent kernel nor the composed kernel's
    divergent plan takes alone, over :func:`split_frames` with ``M``'s
    factories (either package), each a group of a kind only the divergent
    kernel reads (a ring, ``resize_batch`` of a frame or of a stack, NV12
    reads) beside composed read trees, ids ``[1, 2] * 4`` (``chip_smoke.py``
    runs DK1-DK4 at full width):

    - DK1 a tracker's ring (``first`` 3, -5 with ``values``; the ring's
      dtype ``f["ring"]``'s, scaled by ``RING_SCALE``) beside letterboxes
      of the cameras into 16x16, normalized, planar; ``dk1_ring_descending``
      the ring descending from -2 (-11);
    - DK2 ``resize_batch`` of eight rects of ``big`` to 12x12 beside
      similarity warps of crops of it to 12x12, x1/255, -0.5, /0.5, planar;
    - DK3 ``resize_batch`` of the stack's eight images to 16x12, x1/255,
      beside regions of the sensor frame resized to 16x12, x1/4095, planar;
    - DK4 the NV12 buffers converted into float32 RGB and resized to 16x12
      (the divergent kernel's NV12 kind) beside top views of the cameras
      resized to 16x12 (nested), normalized, planar;
    - DK5 DK2's crops ragged at ``used_planes`` 5 (4) with a background per
      channel beside the letterboxes into 12x12 ragged at 6 (5) with a
      default of 0.25, x1/255, planar;
    - DK6 the uint8 ring, no chain, beside ``crop_batch`` of ``big`` under
      ``convert_to(float32, 0.5, 3.25)``: a float32 part stored into the
      uint8 batch (exact halves: truncated alike everywhere), packed;
    - DK7 the letterboxes normalized beside the uint8 ring, no chain: a
      uint8 part stored into the float32 batch, planar;
    - DK8 a 12-bit uint16 ring, no chain, beside the cameras resized to half
      and rotated into 16x12 (a second resample staged), x16: a float32
      part stored into the uint16 batch;
    - DK9 a float16 ring, no chain, beside N5's letterboxes (a resize fused
      with x1/255, CONSTANT 0.447 above and below: a FusedRead2 alone): a
      float32 part stored into the float16 batch;
    - the three batches ``test_torch_divergent_composed.py`` kept eager
      before this route: a ring beside a one-level group (cameras resized to
      24x20), ``resize_batch`` beside a one-level group, a nested group
      (top views rotated, resized) beside a ring.

    ``values`` 1 moves every runtime value (``first``, rects, matrices,
    origins, border values, ``used_planes``) and keeps every size: no
    plan. ``names``, where given, builds those cases alone."""
    wide, ring, big, stack, sensor, nv12 = (f[k] for k in ("wide", "ring", "big", "stack",
                                                           "sensor", "nv12"))
    h, w = wide[0].shape[:2]
    ring_dtype = str(ring.dtype).replace("torch.", "")
    scale = RING_SCALE[ring_dtype]
    ring_norm = (M.convert_to(np.float32, alpha=scale / 255.0), M.subtract(MEAN), M.divide(STD))

    def boxes(side, **ragged):
        (iw, ih), (t, b, l, r) = letterbox(w, h, side)
        return M.batch_read([M.make_border(M.resize(M.image(c), M.Size(iw, ih)), t, b, l, r,
                                           M.BorderMode.CONSTANT, 114 - 14 * values)
                             for c in wide], **ragged)

    bh, bw = big.shape[:2]
    rects = np.array([[(k * 7 + 3 * values) % (bw - 40), (k * 5 + values) % (bh - 36),
                       20 + 2 * k, 18 + 2 * k] for k in range(8)], np.int32)

    def faces(side):
        out = []
        for k, (x, y, rw, rh) in enumerate(rects):
            m = rotation_to((rw / 2, rh / 2), -12.0 + 3.0 * k + 2.0 * values, side / rw,
                            (side / 2, side / 2))
            out.append(M.warp(M.crop(M.image(big), M.Rect(int(x) + 2, int(y) + 1, int(rw),
                                                           int(rh))), m, M.Size(side, side)))
        return M.batch_read(out)

    sh, sw = sensor.shape[:2]
    persp = dict(warp_type=M.WarpType.PERSPECTIVE, default=0.0)
    unit = (M.convert_to(np.float32, alpha=1 / 255.0), M.subtract(0.5), M.divide(0.5))
    ring_u8 = ring if ring_dtype == "uint8" else stack[:, :16, :16]
    half, third = M.Size(w // 2, h // 2), M.Size(16, 12)
    (iw, ih), (t, b, l, r) = letterbox(w, h, 16)

    def rois():
        return M.batch_read([M.resize(M.crop(M.image(sensor), M.Rect(x, y, rw, rh)),
                                      M.Size(16, 12))
                             for x, y, rw, rh in _rois(sh, sw, values, n=8, lo=0.3, hi=0.9)])

    def top_views():
        return M.batch_read([M.resize(M.warp(M.image(c), top_view(w, h, k + values),
                                             M.Size(w, h), **persp), M.Size(16, 12))
                             for k, c in enumerate(wide)])

    def nv12_rgb():
        return M.batch_read([M.resize(M.fuse(M.read_yuv(buf), M.convert_yuv_to_rgb(
            out_dtype=np.float32)), M.Size(16, 12)) for buf in nv12])

    def tiles():
        return [M.Rect((k * 9 + 2 * values) % (bw - 16), (k * 6 + values) % (bh - 16), 16, 16)
                for k in range(8)]

    def rotated():
        return M.batch_read([M.resize(M.warp(M.image(c), rotation((w / 2, h / 2), 5.0 + k + values),
                                             M.Size(w, h)), M.Size(24, 20))
                             for k, c in enumerate(wide)])

    def staged():
        return M.batch_read([M.warp(M.resize(M.image(c), half), rotation_to(
            (half.width / 2, half.height / 2), 5.0 + 10.0 * k / 7 + 2 * values, 2 / 3,
            (third.width / 2, third.height / 2)), third) for k, c in enumerate(wide)])

    def fused():
        return M.batch_read([M.make_border(M.fuse(M.resize(M.image(c), M.Size(iw, ih)),
                                                  M.convert_to(np.float32, alpha=1 / 255.0)),
                                           t, b, l, r, M.BorderMode.CONSTANT, 0.447 - 0.1 * values)
                             for c in wide])

    cases = {
        "dk1_ring_beside_letterboxes": lambda: ([1, 2] * 4, (
            (M.circular_batch_read(ring, first=3 - 8 * values), *ring_norm, M.split_tensor()),
            (boxes(16), *normalize(M), M.split_tensor()))),
        "dk1_ring_descending": lambda: ([1, 2] * 4, (
            (M.circular_batch_read(ring, first=-2 - 9 * values, ascendent=False), *ring_norm,
             M.split_tensor()),
            (boxes(16), *normalize(M), M.split_tensor()))),
        "dk2_crops_beside_aligned_faces": lambda: ([1, 2] * 4, (
            (M.resize_batch(big, rects=rects, dsize=M.Size(12, 12)), *unit, M.split_tensor()),
            (faces(12), *unit, M.split_tensor()))),
        "dk3_stack_resized_beside_sensor_rois": lambda: ([1, 2] * 4, (
            (M.resize_batch(list(stack), dsize=M.Size(16, 12)),
             M.convert_to(np.float32, alpha=1 / 255.0), M.split_tensor()),
            (rois(), M.convert_to(np.float32, alpha=1 / 4095.0), M.split_tensor()))),
        "dk4_nv12_beside_top_views": lambda: ([1, 2] * 4, (
            (nv12_rgb(), M.multiply(1 / 255.0), M.subtract(MEAN), M.divide(STD), M.split_tensor()),
            (top_views(), *normalize(M), M.split_tensor()))),
        "dk5_ragged_groups": lambda: ([1, 2] * 4, (
            (M.resize_batch(big, rects=rects, dsize=M.Size(12, 12), used_planes=5 - values,
                            background=(7.0, 8.0, 9.0)),
             M.convert_to(np.float32, alpha=1 / 255.0), M.split_tensor()),
            (boxes(12, used_planes=6 - values, default=0.25),
             M.convert_to(np.float32, alpha=1 / 255.0), M.split_tensor()))),
        "dk6_float_part_into_a_u8_batch": lambda: ([1, 2] * 4, (
            (M.circular_batch_read(ring_u8, first=1 + values), M.write_tensor()),
            (M.crop_batch(M.image(big), tiles()), M.convert_to(np.float32, alpha=0.5, beta=3.25),
             M.write_tensor()))),
        "dk7_integer_part_into_a_f32_batch": lambda: ([1, 2] * 4, (
            (boxes(16), *normalize(M), M.split_tensor()),
            (M.circular_batch_read(ring_u8, first=2 - 5 * values), M.split_tensor()))),
        "dk8_staged_warps_into_a_u16_batch": lambda: ([1, 2] * 4, (
            (M.circular_batch_read(_cast(_cast(stack[:, :12, :16], "int32") * 16, "uint16"),
                                   first=3 + values),
             M.split_tensor()),
            (staged(), M.multiply(16.0), M.split_tensor()))),
        "dk9_fused2_into_a_f16_batch": lambda: ([1, 2] * 4, (
            (M.circular_batch_read(_cast(stack[:, :16, :16] / 4.0, "float16"),
                                   first=-3 - values), M.split_tensor()),
            (fused(), M.split_tensor()))),
        "ring_beside_a_composed_group": lambda: ([1, 2] * 4, (
            (M.batch_read([M.resize(M.image(c), M.Size(24, 20)) for c in wide]),
             M.convert_to(np.float32, alpha=1 / 255.0), M.split_tensor()),
            (M.circular_batch_read(_cast(stack[:, :20, :24], "float32"), first=1 + values),
             M.multiply(1 / 255.0), M.split_tensor()))),
        "resize_batch_beside_a_composed_group": lambda: ([1, 2] * 4, (
            (M.batch_read([M.resize(M.image(c), M.Size(8, 6)) for c in wide]),
             M.convert_to(np.float32, alpha=1 / 255.0), M.split_tensor()),
            (M.resize_batch(wide[values], rects=np.array([[z + values, z, 10, 8] for z in range(8)],
                                                          np.int32), dsize=M.Size(8, 6)),
             M.multiply(1 / 255.0), M.split_tensor()))),
        "nested_group_beside_a_ring": lambda: ([1, 2] * 4, (
            (rotated(), M.convert_to(np.float32, alpha=1 / 255.0), M.split_tensor()),
            (M.circular_batch_read(_cast(stack[:, :20, :24], "float32"), first=-1 - values),
             M.multiply(1 / 255.0), M.split_tensor()))),
    }
    return {k: make() for k, make in cases.items() if names is None or k in names}
