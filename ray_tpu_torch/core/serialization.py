"""Value serialization with zero-copy buffer support.

Parity: reference ``python/ray/_private/serialization.py`` (cloudpickle +
pickle-5 out-of-band buffers, zero-copy numpy reads from plasma).

Wire layout of a serialized object:

    [8B magic+version][4B meta_len][meta pickle][4B n_buffers]
    ([8B len][pad to 64][buffer bytes]) * n_buffers

The metadata pickle is produced with ``cloudpickle`` (protocol 5) using a
``buffer_callback`` so large contiguous buffers (numpy arrays, torch
tensors, bytes) are extracted out-of-band.  On read, buffers are
reconstructed as memoryviews directly over the shared-memory mapping —
numpy arrays alias store memory with no copy; torch tensors are copied
once (torch has no read-only tensor, so an alias would let an in-place
op write into the sealed object).  Buffers are 64-byte aligned.

ObjectRefs found inside values are serialized specially so the ownership
layer can track borrowed references (reference ``serialization.py``'s
object-ref hooks); the contained refs are collected into the header.
"""

from __future__ import annotations

import io
import pickle
import struct
import sys
import warnings
import weakref
from typing import Any, Callable, List, Optional, Tuple

import cloudpickle

_MAGIC = b"RTPUOBJ1"
_ALIGN = 64

# Sentinel metadata for special object kinds (parity: reference object
# metadata strings like RAW / ACTOR_DIED etc.).
META_EXCEPTION = b"__rtpu_exc__"


#: buffers below this stay in-band (pickle stream); also the fast-
#: path bound for small str/bytes in serialize() — keep in sync
_INBAND_LIMIT = 512


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


class SerializedObject:
    """A serialized value: a metadata blob plus out-of-band buffers."""

    __slots__ = ("meta", "buffers", "contained_refs")

    def __init__(self, meta: bytes, buffers: List, contained_refs: List):
        self.meta = meta
        self.buffers = buffers
        self.contained_refs = contained_refs

    def total_size(self) -> int:
        size = len(_MAGIC) + 4 + len(self.meta) + 4
        for buf in self.buffers:
            size = _pad(size + 8) + memoryview(buf).nbytes
        return size

    def write_to(self, dest: memoryview) -> int:
        """Write the wire format into ``dest``; returns bytes written."""
        offset = 0

        def put(data) -> None:
            nonlocal offset
            n = len(data)
            dest[offset : offset + n] = bytes(data) if not isinstance(
                data, (bytes, bytearray, memoryview)
            ) else data
            offset += n

        put(_MAGIC)
        put(struct.pack("<I", len(self.meta)))
        put(self.meta)
        put(struct.pack("<I", len(self.buffers)))
        for buf in self.buffers:
            view = memoryview(buf).cast("B")
            header_end = offset + 8
            data_start = _pad(header_end)
            put(struct.pack("<Q", view.nbytes))
            # zero pad for determinism
            dest[offset:data_start] = b"\x00" * (data_start - offset)
            offset = data_start
            dest[offset : offset + view.nbytes] = view
            offset += view.nbytes
        return offset

    def to_bytes(self) -> bytes:
        out = bytearray(self.total_size())
        n = self.write_to(memoryview(out))
        return bytes(out[:n])


class _RefAwarePickler(cloudpickle.CloudPickler):
    """CloudPickler that records contained ObjectRefs via persistent_id.

    Defined at module scope — building this class per serialize() call
    (a closure class) measured 63 us per empty-dict serialize, i.e. the
    bulk of the per-task submission cost on the hot path."""

    def __init__(self, sink, buffers: List, contained: List):
        super().__init__(sink, protocol=5,
                         buffer_callback=self._buffer_callback)
        self._oob_buffers = buffers
        self._contained = contained

    def _buffer_callback(self, buf: pickle.PickleBuffer) -> bool:
        view = buf.raw()
        if view.nbytes >= _INBAND_LIMIT:  # tiny buffers travel in-band
            self._oob_buffers.append(view)
            return False  # out-of-band
        return True

    def persistent_id(self, obj):  # noqa: N802 (pickle API name)
        from ray_tpu_torch.core.object_ref import ObjectRef

        if isinstance(obj, ObjectRef):
            self._contained.append(obj)
            return ("rtpu_ref", obj.binary(), obj.owner_address())
        return None


class _HeldAwarePickler(_RefAwarePickler):
    """The pickler of a process that holds CUDA tensors on the host: a
    held tensor too small for the buffer path still travels as CUDA."""

    def reducer_override(self, obj):
        held = _HELD_ON_HOST
        if held is not None and held.get(id(obj)) is obj:
            return tensor_reduce(obj)
        return super().reducer_override(obj)


_EMPTY_DICT_WIRE: Any = None
_NONE_WIRE: Any = None


# ---------------------------------------------------------------------------
# zero-copy buffer fast path
# ---------------------------------------------------------------------------

def _rebuild_bytes(buf) -> bytes:
    return bytes(buf)


def _rebuild_bytearray(buf) -> bytearray:
    return bytearray(buf)


#: CPU tensors that stand for CUDA ones, by id, while this process
#: holds CUDA tensors on the host (``hold_cuda_on_host``); None otherwise
_HELD_ON_HOST: Optional["weakref.WeakValueDictionary"] = None


def hold_cuda_on_host() -> None:
    """From now on a CUDA tensor read in this process lands on the CPU
    and keeps its kind: written again (to the store, or by
    ``tensor_reduce``), it travels as a CUDA tensor.  For a process that
    only relays values, as the ray:// client server does, and so must
    neither start CUDA nor turn a reader's CUDA tensor into a CPU one."""
    global _HELD_ON_HOST
    if _HELD_ON_HOST is None:
        _HELD_ON_HOST = weakref.WeakValueDictionary()


def device_kind(value) -> str:
    """``value``'s device type as the wire names it: ``"cuda"`` for a
    tensor held on the host for CUDA (``hold_cuda_on_host``)."""
    held = _HELD_ON_HOST
    if held is not None and held.get(id(value)) is value:
        return "cuda"
    return value.device.type


def _rebuild_tensor(shape, dtype, device_type, buf):
    """A tensor of ``shape`` and ``dtype`` (its name in ``torch``) from
    its raw bytes, in one copy: on the reader's current CUDA device if
    the putter's tensor was on CUDA (one host-to-device copy; raises
    where there is no CUDA), else on the CPU.  A process that holds CUDA
    tensors on the host (``hold_cuda_on_host``) keeps them on the CPU."""
    import torch  # the putter had torch imported; readers import it lazily

    held = device_type == "cuda" and _HELD_ON_HOST is not None
    if held:
        device = torch.device("cpu")
    elif device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA tensor was read in a process without CUDA; put a "
                "CPU tensor (t.cpu()) for readers without a GPU")
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    out = torch.empty(shape, dtype=getattr(torch, dtype), device=device)
    if out.numel():
        with warnings.catch_warnings():
            # the store's mapping is read-only and is only read from
            warnings.simplefilter("ignore", UserWarning)
            src = torch.frombuffer(buf, dtype=torch.uint8)
        out.view(-1).view(torch.uint8).copy_(src)
    if held:
        _HELD_ON_HOST[id(out)] = out
    return out


def _tensor_wire(torch_mod, value) -> Optional["_BufferWire"]:
    """A dense CPU or CUDA tensor as raw bytes plus shape, dtype and
    device kind (bf16 has no numpy dtype, so the bytes travel raw, as the
    JAX package ships its extended dtypes).  A CUDA tensor takes one
    device-to-host copy here, as ``jax.device_get`` does; a
    non-contiguous one is made contiguous.  ``requires_grad`` is dropped
    (a ``jax.Array`` has none).  None for layouts this wire does not
    carry."""
    if (type(value) is not torch_mod.Tensor
            or value.layout is not torch_mod.strided
            or value.device.type not in ("cpu", "cuda")
            or value.is_quantized):
        return None
    host = value.detach().resolve_conj().resolve_neg().cpu().contiguous()
    raw = host.reshape(-1).view(torch_mod.uint8).numpy()
    return _BufferWire(_rebuild_tensor,
                       (tuple(value.shape),
                        str(value.dtype).removeprefix("torch."),
                        device_kind(value)), raw)


def tensor_reduce(value) -> Any:
    """``value``'s reduction for a pickle stream (in band), by the
    store's rule: a CUDA tensor comes back on the reader's card, or
    raises where the reader has no CUDA.  NotImplemented for anything
    but a plain dense tensor, so a ``reducer_override`` can return it
    as is."""
    torch_mod = loaded_torch()
    if torch_mod is None or not isinstance(value, torch_mod.Tensor):
        return NotImplemented
    wire = _tensor_wire(torch_mod, value)
    return NotImplemented if wire is None else wire.__reduce__()


class _BufferWire:
    """Pickles as ``rebuild(*args, <out-of-band buffer>)``: the payload
    rides as a raw out-of-band buffer next to a few-byte meta pickle,
    never through the pickle stream."""

    __slots__ = ("rebuild", "args", "buf")

    def __init__(self, rebuild: Callable, args: tuple, buf) -> None:
        self.rebuild = rebuild
        self.args = args
        self.buf = buf

    def __reduce__(self):
        return (self.rebuild, (*self.args, pickle.PickleBuffer(self.buf)))


def _serialize_buffer_fast(value: Any) -> Optional["SerializedObject"]:
    """Zero-pickle-copy fast path for flat buffer values.

    Large ``bytes``/``bytearray``, contiguous numpy arrays and torch
    tensors (``_tensor_wire``) serialize as a tiny handwritten meta
    pickle plus the payload as an out-of-band buffer, so a plasma put's
    only copy of the data is the final write into the writer's mapped
    slab — the cloudpickle path copies ``bytes`` wholesale into the meta
    stream.  Returns None when the value doesn't qualify (caller falls
    back to cloudpickle).  Flat buffers cannot contain ObjectRefs, so
    skipping the ref-aware pickler is sound.  torch is looked up in
    ``sys.modules``: a process that never imported it holds no tensor.
    """
    vt = type(value)
    buffers: List = []
    if vt is bytes or vt is bytearray:
        if len(value) < _INBAND_LIMIT:
            return None
        rebuild = _rebuild_bytes if vt is bytes else _rebuild_bytearray
        meta = pickle.dumps(_BufferWire(rebuild, (), value), protocol=5,
                            buffer_callback=buffers.append)
        return SerializedObject(meta, buffers, [])
    np_mod = sys.modules.get("numpy")
    if np_mod is not None and vt is np_mod.ndarray:
        if (value.nbytes < _INBAND_LIMIT or value.dtype.hasobject
                or not (value.flags["C_CONTIGUOUS"]
                        or value.flags["F_CONTIGUOUS"])):
            return None
        # plain pickle (protocol 5): numpy's own reduce extracts the
        # data buffer out-of-band; no CloudPickler / persistent_id
        # traversal on a pure array
        meta = pickle.dumps(value, protocol=5,
                            buffer_callback=buffers.append)
        return SerializedObject(meta, buffers, [])
    torch_mod = loaded_torch()
    if torch_mod is not None and isinstance(value, torch_mod.Tensor):
        if value.numel() * value.element_size() < _INBAND_LIMIT:
            return None  # small tensors take the cloudpickle path
        wire = _tensor_wire(torch_mod, value)
        if wire is None:
            return None
        meta = pickle.dumps(wire, protocol=5,
                            buffer_callback=buffers.append)
        return SerializedObject(meta, buffers, [])
    return None


def loaded_torch():
    """torch, where this process has imported it; None where it has not,
    or where another thread is still importing it.  An actor's methods
    run beside its other threads: a train loop's ``import torch`` takes
    seconds, and a result serialized meanwhile met a partial module
    without ``torch.Tensor`` (an AttributeError that killed the actor's
    executor).  No tensor exists before torch's import completes."""
    mod = sys.modules.get("torch")
    if mod is None or getattr(getattr(mod, "__spec__", None),
                              "_initializing", False):
        return None
    return mod


def serialize(value: Any) -> SerializedObject:
    """Serialize ``value``, extracting large buffers out-of-band and
    collecting any contained ObjectRefs."""
    global _EMPTY_DICT_WIRE, _NONE_WIRE
    if value is None:
        # the commonest task return; cache the meta bytes (a fresh
        # SerializedObject each call — serialize_exception mutates .meta)
        if _NONE_WIRE is None:
            sink = io.BytesIO()
            _RefAwarePickler(sink, [], []).dump(None)
            _NONE_WIRE = sink.getvalue()
        return SerializedObject(_NONE_WIRE, [], [])
    if type(value) is dict and not value:
        # every no-kwarg task submission serializes {}; cache the bytes
        if _EMPTY_DICT_WIRE is None:
            sink = io.BytesIO()
            _RefAwarePickler(sink, [], []).dump({})
            _EMPTY_DICT_WIRE = sink.getvalue()
        return SerializedObject(_EMPTY_DICT_WIRE, [], [])
    vt = type(value)
    if vt in (int, float, bool) or (
            vt in (str, bytes) and len(value) < _INBAND_LIMIT):
        # primitives can contain neither ObjectRefs nor out-of-band
        # buffers: plain C pickle, skipping the CloudPickler object +
        # persistent_id traversal (~half the per-call serialize cost on
        # small-result actor storms)
        return SerializedObject(pickle.dumps(value, protocol=5), [], [])
    fast = _serialize_buffer_fast(value)
    if fast is not None:
        return fast
    buffers: List = []
    contained: List = []
    sink = io.BytesIO()
    pickler = (_RefAwarePickler if _HELD_ON_HOST is None
               else _HeldAwarePickler)
    pickler(sink, buffers, contained).dump(value)
    return SerializedObject(sink.getvalue(), buffers, contained)


def serialize_exception(exc: BaseException) -> SerializedObject:
    from ray_tpu_torch.core.exceptions import TaskError

    if not isinstance(exc, TaskError):
        exc = TaskError.from_exception(exc)
    try:
        out = serialize(exc)
    except Exception:
        out = serialize(TaskError(None, exc.remote_traceback, exc.task_desc))
    out.meta += META_EXCEPTION  # flag so get() raises instead of returning
    return out


def deserialize(data, out_of_band_owner: Any = None) -> Tuple[Any, bool]:
    """Deserialize wire bytes; returns ``(value, is_exception)``.

    ``data`` may be any buffer (bytes or a memoryview over shared memory).
    Buffers inside the mapping are NOT copied; numpy arrays alias it.
    ``out_of_band_owner`` is attached to reconstructed ObjectRefs so
    borrow-tracking knows where the value came from.
    """
    view = memoryview(data).cast("B")
    if bytes(view[: len(_MAGIC)]) != _MAGIC:
        raise ValueError("corrupt serialized object (bad magic)")
    offset = len(_MAGIC)
    (meta_len,) = struct.unpack_from("<I", view, offset)
    offset += 4
    meta = view[offset : offset + meta_len]
    offset += meta_len
    (n_buffers,) = struct.unpack_from("<I", view, offset)
    offset += 4
    buffers: List[memoryview] = []
    for _ in range(n_buffers):
        (buf_len,) = struct.unpack_from("<Q", view, offset)
        offset = _pad(offset + 8)
        buffers.append(view[offset : offset + buf_len])
        offset += buf_len

    meta_bytes = bytes(meta)
    is_exception = meta_bytes.endswith(META_EXCEPTION)
    if is_exception:
        meta_bytes = meta_bytes[: -len(META_EXCEPTION)]

    value = _unpickle(meta_bytes, buffers)
    return value, is_exception


class _RefAwareUnpickler(pickle.Unpickler):
    """Module-scope twin of _RefAwarePickler (building the class per
    deserialize() call showed up as ~7 us/object on nop-task storms)."""

    def persistent_load(self, pid):  # noqa: N802 (pickle API name)
        from ray_tpu_torch.core.object_ref import ObjectRef

        tag, ref_bytes, owner_addr = pid
        if tag != "rtpu_ref":
            raise pickle.UnpicklingError(f"unknown persistent id {tag!r}")
        return ObjectRef._restore(ref_bytes, owner_addr)


def _unpickle(meta: bytes, buffers: List[memoryview]) -> Any:
    return _RefAwareUnpickler(io.BytesIO(meta), buffers=buffers).load()
