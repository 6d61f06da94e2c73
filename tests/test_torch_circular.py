"""``CircularBatchRead`` and ``CircularTensor``: the port against the JAX
package, as ``tests/test_circular_tensor.py`` pins the reference.

- ``CircularBatchRead``: output plane z reads ring plane (first + z) mod N
  (ascending) or (first - z) mod N, with the floor modulo;
- ``CircularTensor``: after k updates NEWEST_FIRST plane z holds frame
  k - z and OLDEST_FIRST plane z holds frame k - (BATCH - 1 - z), in each
  of the three layouts; an update writes exactly one slot.

Both packages run the same updates from the same numpy frames; the rings
must agree bit for bit (the chains here are exact in float32, and a resize
update equals the reference's op-by-op lowering bit for bit).
"""

import numpy as np
import pytest
import torch

import cvgpuspeedup_tpu as J
import cvgpuspeedup_tpu_torch as T
from cvgpuspeedup_tpu_torch.exec import executor
from cvgpuspeedup_tpu_torch.interop.from_jax import from_jax
from cvgpuspeedup_tpu_torch.ops.memory import CircularBatchRead

W, H, C, BATCH = 8, 6, 3, 4


def _on_cpu(m):
    """The port's entry points default to the card; the reference has no
    ``device`` argument."""
    return {"device": "cpu"} if m is T else {}


def _frame(k):
    """Frame k's value encodes (frame, channel, y, x)."""
    base = np.arange(H * W, dtype=np.float32).reshape(H, W)
    return np.stack([base + 1000 * k + 100 * c for c in range(C)], axis=-1)


def _ring():
    return np.stack([_frame(k) for k in range(BATCH)])


def _same(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype, (port.shape, port.dtype,
                                                                 ref.shape, ref.dtype)
    np.testing.assert_array_equal(port, ref)


# --- CircularBatchRead -----------------------------------------------------------


@pytest.mark.parametrize("ascendent", [True, False])
@pytest.mark.parametrize("first", [-5, -1, 0, 2, BATCH + 2])
def test_circular_batch_read_both_directions(first, ascendent):
    data = _ring()
    out = T.execute_operations(T.circular_batch_read(data, first=first, ascendent=ascendent),
                               device="cpu")
    for z in range(BATCH):
        src = (first + z) % BATCH if ascendent else (first - z) % BATCH
        np.testing.assert_array_equal(out.numpy()[z], data[src], err_msg=f"z={z}")
    _same(out, J.execute_operations(J.circular_batch_read(data, first=first, ascendent=ascendent),
                                    backend=J.ParBackend.XLA))


def test_circular_batch_read_fused_chain():
    data = _ring()
    out = T.execute_operations(T.circular_batch_read(data, first=1), T.add(3.0), T.split_tensor(),
                               device="cpu")
    assert tuple(out.shape) == (BATCH, C, H, W)
    for z in range(BATCH):
        np.testing.assert_array_equal(out.numpy()[z],
                                      (data[(1 + z) % BATCH] + 3.0).transpose(2, 0, 1))
    _same(out, J.execute_operations(J.circular_batch_read(data, first=1), J.add(3.0),
                                    J.split_tensor(), backend=J.ParBackend.XLA))


def test_host_rings_are_packed_and_carried_across_packed():
    data = _ring()
    read = T.circular_batch_read(data, first=3)
    assert read.packed_channels == C and tuple(read.data.shape) == (BATCH, H, W * C)
    jread = J.circular_batch_read(data, first=3)
    carried = from_jax(jread)
    assert isinstance(carried, CircularBatchRead) and carried.packed_channels == C
    assert tuple(carried.data.shape) == (BATCH, H, W * C)
    _same(T.execute_operations(carried,
                               device="cpu"), J.execute_operations(jread, backend=J.ParBackend.XLA))
    # a ring on the device stays as it is; channels= declares a packed one
    tensor_read = T.circular_batch_read(torch.from_numpy(data), first=3)
    assert tensor_read.packed_channels == 0
    _same(T.execute_operations(tensor_read, device="cpu"), T.execute_operations(read, device="cpu"))
    packed = T.circular_batch_read(data.reshape(BATCH, H, W * C), first=3, channels=C)
    _same(T.execute_operations(packed, device="cpu"), T.execute_operations(read, device="cpu"))
    with pytest.raises(ValueError, match="packed"):
        T.circular_batch_read(data, first=0, channels=C)
    with pytest.raises(ValueError, match="packed"):
        T.circular_batch_read(data.reshape(BATCH, H, W * C), first=0, channels=5)


def test_lower_planes_takes_only_the_planes_asked_for():
    data = _ring()
    t = CircularBatchRead(data=torch.from_numpy(data), first=torch.tensor(-1, dtype=torch.int32),
                          ascendent=False)
    got = t.lower_planes((2, 0))
    np.testing.assert_array_equal(got.numpy(), data[[(-1 - 2) % BATCH, (-1 - 0) % BATCH]])
    jread = J.circular_batch_read(data, first=-1, ascendent=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jread.lower_planes((2, 0))))
    with pytest.raises(ValueError, match="batched"):
        T.crop(data[0], T.Rect(0, 0, 2, 2)).lower_planes((0,))


def test_a_new_first_builds_no_plan():
    data = _ring()
    outs, builds = [], []
    for first in (0, 1, 2):
        outs.append(T.execute_operations(T.circular_batch_read(data, first=first), T.add(1.0),
                                         device="cpu"))
        builds.append(executor.PLAN_BUILDS)
    assert builds[1] == builds[0] == builds[2]
    np.testing.assert_array_equal(outs[2].numpy()[0], data[2] + 1.0)


# --- CircularTensor ---------------------------------------------------------------


@pytest.mark.parametrize("order,expected", [
    ("NEWEST_FIRST", lambda k, z: k - z),
    ("OLDEST_FIRST", lambda k, z: k - (BATCH - z - 1)),
])
@pytest.mark.parametrize("planes", ["STANDARD", "TRANSPOSED", "PACKED"])
def test_circular_tensor_orders_and_layouts(order, expected, planes):
    rings = []
    for m in (T, J):
        kw = dict(width=W, height=H, channels=C, batch=BATCH, order=m.CircularTensorOrder[order],
                  planes=m.ColorPlanes[planes], **_on_cpu(m))
        ct = m.CircularTensor(**kw)
        for k in range(1, 8):
            ct.update(m.image(_frame(k)), m.multiply(2.0))
        rings.append(ct)
    port, ref = rings
    t = port.tensor.numpy()
    for z in range(BATCH):
        fk = expected(7, z)
        want = _frame(fk) * 2.0 if fk >= 1 else np.zeros((H, W, C), np.float32)
        got = {"STANDARD": lambda: t[z].transpose(1, 2, 0),
               "TRANSPOSED": lambda: t[:, z].transpose(1, 2, 0),
               "PACKED": lambda: t[z]}[planes]()
        np.testing.assert_array_equal(got, want, err_msg=f"z={z}")
    _same(port.tensor, ref.tensor)
    _same(port.snapshot(), ref.snapshot())
    assert port.shape == ref.shape and port.size_in_bytes() == ref.size_in_bytes()


def test_update_with_input_arrays():
    rings = []
    for m in (T, J):
        ct = m.CircularTensor(width=W, height=H, channels=C, batch=2, **_on_cpu(m))
        ct.update(input=_frame(1).astype(np.uint8))
        ct.update(input=_frame(2).astype(np.uint8))
        rings.append(ct)
    t = rings[0].tensor.numpy()
    np.testing.assert_array_equal(t[0].transpose(1, 2, 0),
                                  _frame(2).astype(np.uint8).astype(np.float32))
    _same(rings[0].tensor, rings[1].tensor)


def test_matching_write_op_accepted_other_layouts_refused():
    ct = T.CircularTensor(width=W, height=H, channels=C, batch=2, device="cpu")
    ct.update(T.image(_frame(1)), T.convert_to(np.float32), T.split_tensor())
    with pytest.raises(ValueError, match="does not match"):
        ct.update(T.image(_frame(1)), T.split_tensor_transposed())
    packed = T.CircularTensor(W, H, C, 2, planes=T.ColorPlanes.PACKED, device="cpu")
    packed.update(T.image(_frame(1)), T.write_tensor())
    with pytest.raises(ValueError, match="does not match"):
        packed.update(T.image(_frame(1)), T.split_tensor())
    with pytest.raises(ValueError, match="read op"):
        ct.update(T.multiply(2.0))
    with pytest.raises(TypeError, match="unexpected op"):
        ct.update(T.image(_frame(1)), T.image(_frame(2)))
    with pytest.raises(ValueError, match="ring holds"):
        ct.update(T.image(_frame(1)[:, :4]))


def test_uint8_ring():
    rings = []
    for m in (T, J):
        ct = m.CircularTensor(width=W, height=H, channels=C, batch=3, dtype=np.uint8,
                              **_on_cpu(m))
        for k in range(1, 4):
            ct.update(m.image(_frame(k)), m.convert_to(np.uint8))
        rings.append(ct)
    t = rings[0].tensor
    assert t.dtype == torch.uint8
    want = np.clip(np.rint(_frame(3)), 0, 255).astype(np.uint8).transpose(2, 0, 1)
    np.testing.assert_array_equal(t.numpy()[0], want)
    _same(t, rings[1].tensor)


def test_float_values_into_a_uint8_ring_clamp_then_truncate():
    """A slot stores a float value as the reference's ``astype`` does:
    clamp, then truncate (3.7 -> 3, 297.5 -> 255, -0.5 -> 0)."""
    vals = np.array([3.7, 297.5, -0.5, 254.9, 0.4, 128.5], np.float32)
    frame = np.broadcast_to(vals[None, :, None], (2, 6, 1)).copy()
    rings = []
    for m in (T, J):
        ct = m.CircularTensor(width=6, height=2, channels=1, batch=2, dtype=np.uint8,
                              **_on_cpu(m))
        ct.update(m.image(frame))
        rings.append(ct)
    np.testing.assert_array_equal(rings[0].tensor.numpy()[0, 0, 0], [3, 255, 0, 254, 0, 128])
    _same(rings[0].tensor, rings[1].tensor)


def test_resize_update_equals_the_reference():
    """The reference's CircularTensor row: a frame resized and scaled into
    the ring (on the card the update runs the full-frame kernel)."""
    frames = [np.random.default_rng(k).integers(0, 256, (36, 60, 3)).astype(np.uint8)
              for k in range(5)]
    rings = []
    for m in (T, J):
        ct = m.CircularTensor(16, 12, 3, 4, **_on_cpu(m))
        for f in frames:
            ct.update(m.resize(m.image(f), m.Size(16, 12)), m.convert_to(np.float32, alpha=1 / 255.0))
        rings.append(ct)
    port = rings[0].tensor.numpy()
    ref = np.stack([np.asarray(J.build_pipeline(J.resize(J.image(f), J.Size(16, 12)),
                                                J.convert_to(np.float32, alpha=1 / 255.0))
                               .lower()).transpose(2, 0, 1) for f in frames[::-1][:4]])
    np.testing.assert_array_equal(port, ref)  # the op-by-op lowering, bit for bit
    assert np.abs(port - np.asarray(rings[1].tensor)).max() <= 1e-6
    assert T.last_backend() == "torch"


def test_save_load(tmp_path):
    ct = T.CircularTensor(width=W, height=H, channels=C, batch=3,
                          order=T.CircularTensorOrder.OLDEST_FIRST, planes=T.ColorPlanes.TRANSPOSED,
                          device="cpu")
    for k in range(1, 5):
        ct.update(T.image(_frame(k)))
    path = str(tmp_path / "ring")
    ct.save(path)
    saved = ct.tensor
    again = T.CircularTensor.load(path, device="cpu")
    assert again.order == ct.order and again.planes == ct.planes and again.shape == ct.shape
    _same(again.tensor, ct.tensor)
    ct.update(T.image(_frame(5)))
    again.update(T.image(_frame(5)))
    _same(again.tensor, ct.tensor)
    # the reference reads the port's file and the port the reference's
    _same(saved, J.CircularTensor.load(path + ".npz").tensor)
    ref_path = str(tmp_path / "ref_ring.npz")
    jct = J.CircularTensor(W, H, C, 3)
    for k in range(1, 3):
        jct.update(J.image(_frame(k)))
    jct.save(ref_path)
    _same(T.CircularTensor.load(ref_path, device="cpu").tensor, jct.tensor)
    sd = again.state_dict()
    assert sd["order"] == "oldest_first" and sd["planes"] == "transposed" and sd["batch"] == 3


@pytest.mark.parametrize("order", ["NEWEST_FIRST", "OLDEST_FIRST"])
def test_read_batch_presents_the_logical_order(order):
    ct = T.CircularTensor(W, H, C, BATCH, order=T.CircularTensorOrder[order], device="cpu")
    builds = None
    for k in range(1, 11):  # 2.5 wraparounds of a 4-ring
        ct.update(T.image(_frame(k)), T.multiply(2.0))
        via_read = T.execute_operations(ct.read_batch(), device="cpu")
        _same(via_read, ct.tensor)
        if builds is None:
            builds = executor.PLAN_BUILDS
    assert executor.PLAN_BUILDS == builds  # a new `first` builds no plan
    newest = 10 if order == "NEWEST_FIRST" else 7
    np.testing.assert_array_equal(via_read.numpy()[0].transpose(1, 2, 0), 2.0 * _frame(newest))


def test_read_batch_fused_chain():
    ct = T.CircularTensor(W, H, C, BATCH, planes=T.ColorPlanes.PACKED, device="cpu")
    for k in range(1, 6):
        ct.update(T.image(_frame(k)))
    out = T.execute_operations(ct.read_batch(), T.subtract((1.0, 2.0, 3.0)), T.split_tensor(),
                               device="cpu")
    assert tuple(out.shape) == (BATCH, C, H, W)
    want = (ct.tensor.numpy() - np.array([1.0, 2.0, 3.0], np.float32)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(out.numpy(), want)


def test_read_batch_transposed_raises():
    ct = T.CircularTensor(W, H, C, BATCH, planes=T.ColorPlanes.TRANSPOSED, device="cpu")
    with pytest.raises(ValueError, match="TRANSPOSED"):
        ct.read_batch()


@pytest.mark.parametrize("planes", ["STANDARD", "TRANSPOSED", "PACKED"])
def test_update_writes_one_slot_in_place(planes):
    ct = T.CircularTensor(W, H, C, BATCH, planes=T.ColorPlanes[planes], device="cpu")
    ring = ct._ring
    axis = 1 if planes == "TRANSPOSED" else 0
    for k in range(1, 6):
        before = ring.clone()
        ct.update(T.image(_frame(k)))
        assert ct._ring is ring  # written in place, never reallocated
        changed = [z for z in range(BATCH)
                   if not torch.equal(before.select(axis, z), ring.select(axis, z))]
        assert changed == [(k - 1) % BATCH]


def test_ring_in_a_divergent_batch():
    """A ring's read_batch as one sequence of a divergent batch."""
    ct = T.CircularTensor(W, H, C, BATCH, planes=T.ColorPlanes.PACKED, device="cpu")
    for k in range(1, 7):
        ct.update(T.image(_frame(k)))
    flat = np.stack([_frame(-k) for k in range(BATCH)])
    out = T.launch_divergent_batch([1, 2, 1, 2], T.build_operation_sequence(ct.read_batch()),
                                   T.build_operation_sequence(T.image(flat), T.add(1.0)),
                                   device="cpu")
    assert T.last_backend() == "torch:divergent"
    logical = ct.tensor.numpy()
    np.testing.assert_array_equal(out.numpy()[0], logical[0])
    np.testing.assert_array_equal(out.numpy()[2], logical[2])
    np.testing.assert_array_equal(out.numpy()[1], flat[1] + 1.0)


# --- update through out=: the slot's view is the pipeline's output ----------------


RING_DTYPES = {"f32": np.float32, "u8": np.uint8, "i16": np.int16, "u16": np.uint16}


@pytest.mark.parametrize("head", ["plain", "crop", "resize", "u8_chain"])
@pytest.mark.parametrize("ring_dtype", RING_DTYPES)
@pytest.mark.parametrize("order", ["NEWEST_FIRST", "OLDEST_FIRST"])
@pytest.mark.parametrize("planes", ["STANDARD", "TRANSPOSED", "PACKED"])
def test_update_into_the_slots_view_equals_the_three_steps(planes, order, ring_dtype, head):
    """``update`` hands the slot's view to the pipeline as its output. The
    ring must equal, bit for bit, what the three steps gave: run the
    pipeline into a temporary, ``astype`` it (float -> integer clamps, then
    truncates), ``copy_`` the permuted value into the slot; and the
    reference's ring within 1e-4 (integers within 1: XLA contracts the
    chain's multiply-add and the lerps)."""
    from cvgpuspeedup_tpu_torch.interop.from_jax import ring_from_jax
    from cvgpuspeedup_tpu_torch.utils import dtypes as dt

    dtype = RING_DTYPES[ring_dtype]
    w, h, batch = 10, 6, 3
    rng = np.random.default_rng(31)

    def ops(m, k, frame):
        if head == "resize":
            return (m.resize(m.image(frame), m.Size(w, h)), m.convert_to(np.float32, alpha=1.7),
                    m.add(-70.25))
        if head == "u8_chain":
            return (m.image(frame), m.multiply(1.7), m.add(-20.5))
        read = m.image(frame) if head == "plain" else m.crop(m.image(frame), m.Rect(k, 2 * k, w, h))
        return (read, m.convert_to(np.float32, alpha=1.7), m.add(-70.25))

    shape = (h, w, 3) if head in ("plain", "u8_chain") else (4 * h, 4 * w, 3)
    ring = T.CircularTensor(w, h, 3, batch, order=T.CircularTensorOrder[order],
                            planes=T.ColorPlanes[planes], dtype=dtype, device="cpu")
    steps = torch.zeros(ring.shape, dtype=ring.dtype)
    jring = J.CircularTensor(w, h, 3, batch, order=J.CircularTensorOrder[order],
                             planes=J.ColorPlanes[planes], dtype=dtype)
    for k in range(5):
        frame = rng.integers(0, 256, shape).astype(np.uint8)
        ring.update(*ops(T, k, frame))
        x = dt.astype(T.execute_operations(*ops(T, k, frame), device="cpu"), ring.dtype)
        slot = k % batch
        if planes == "PACKED":
            steps[slot].copy_(x)
        elif planes == "STANDARD":
            steps[slot].copy_(x.permute(2, 0, 1))
        else:
            steps[:, slot].copy_(x.permute(2, 0, 1))
        jring.update(*ops(J, k, frame))
    assert torch.equal(ring._ring, steps)
    want = np.asarray(jring.tensor)
    got = ring.tensor.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    # the reference's jitted update contracts x * 1.7 - 70.25 into an FMA:
    # 1e-4 on the 0..255 scale for floats, one step for integers
    tol = 1e-4 * max(1.0, float(np.abs(want).max()) / 255) if dtype == np.float32 else 1
    assert np.abs(got.astype(np.float64) - want.astype(np.float64)).max() <= tol
    carried = ring_from_jax(jring, device="cpu")
    assert carried.order.name == order and carried.planes.name == planes
    np.testing.assert_array_equal(carried.tensor.numpy(), want)


def test_ring_from_jax_carries_the_window_and_goes_on_updating():
    from cvgpuspeedup_tpu_torch.interop.from_jax import ring_from_jax

    jring = J.CircularTensor(W, H, C, 3, order=J.CircularTensorOrder.OLDEST_FIRST)
    for k in range(4):
        jring.update(input=_frame(k + 1))
    ring = ring_from_jax(jring, device="cpu")
    np.testing.assert_array_equal(ring.tensor.numpy(), np.asarray(jring.tensor))
    jring.update(input=_frame(9))
    ring.update(input=_frame(9))
    np.testing.assert_array_equal(ring.tensor.numpy(), np.asarray(jring.tensor))


def test_update_refuses_a_batch_of_planes_and_a_wrong_size():
    ring = T.CircularTensor(8, 4, 3, 2, device="cpu")
    with pytest.raises(ValueError, match="one frame"):
        ring.update(T.image(np.zeros((2, 4, 8, 3), np.uint8)))
    with pytest.raises(ValueError, match="ring holds"):
        ring.update(T.image(np.zeros((4, 9, 3), np.uint8)))
    assert ring._count == 0
