"""A small msgpack decoder for the JAX package's model and optimizer files.

``nsdp_tpu/training/checkpoints.py`` writes ``model_*`` / ``modelbest_*``
files as ``flax.serialization.to_bytes({"params", "batch_stats"})`` and
``opt_*`` files as ``to_bytes({"opt_state", "step"})`` of the optax state: a
msgpack map whose array leaves are flax's ndarray extension (ExtType code
1, the payload itself msgpack of ``(shape, dtype name, C-order bytes)``,
``flax/serialization.py::_ndarray_to_bytes``), numpy scalars ExtType code
3 in the same layout.  This module reads that layout with the standard
library only, so the port needs neither ``msgpack`` nor ``flax``.

It decodes maps (empty ones too: optax's stateless stages, ``clip`` and
``add_decayed_weights``, serialise as ``{}``), arrays, strings, bin, ints,
floats, nil and bool.  Array
leaves come back as CPU ``torch.Tensor``s in their stored dtype
(``bfloat16`` included, which numpy has no type for); a numpy scalar as a
0-d tensor.  Any other extension code, and flax's chunked layout for leaves
above 1 GiB, raise ``ValueError`` naming what they met.
"""

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY = 1  # flax's _MsgpackExtType.ndarray
EXT_NATIVE_COMPLEX = 2
EXT_NPSCALAR = 3
_EXT_NAMES = {EXT_NDARRAY: "ndarray", EXT_NATIVE_COMPLEX: "native_complex",
              EXT_NPSCALAR: "npscalar"}
CHUNKED_KEY = "__msgpack_chunked_array__"


def is_msgpack_map(head: bytes) -> bool:
    """Whether a file's first byte starts a non-empty msgpack map (fixmap,
    map16, map32), as every flax model file does.  The empty fixmap, 0x80,
    is left out: it is also how a pickle (a legacy torch file) starts."""
    return bool(head) and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: (">B", bytes), 0xC5: (">H", bytes), 0xC6: (">I", bytes),
            0xD9: (">B", self.str), 0xDA: (">H", self.str), 0xDB: (">I", self.str),
            0xDC: (">H", self.array), 0xDD: (">I", self.array),
            0xDE: (">H", self.map), 0xDF: (">I", self.map),
        }
        if b in sized:
            fmt, read = sized[b]
            n = self.unpack(fmt)
            return bytes(self.take(n)) if read is bytes else read(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at offset {self.pos - 1}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if CHUNKED_KEY in out:
            raise ValueError(
                "msgpack: flax's chunked array layout (a leaf above 1 GiB) is not read")
        return out

    def ext(self, n: int) -> torch.Tensor:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            name = _EXT_NAMES.get(code, "unknown")
            raise ValueError(f"msgpack: extension type {code} ({name}) is not read")
        return _ndarray(payload)


def _ndarray(payload: bytes) -> torch.Tensor:
    """flax's ``(shape, dtype name, C-order bytes)`` as a CPU tensor."""
    shape, name, buf = unpackb(payload)
    if not isinstance(name, str) or not isinstance(buf, bytes):
        raise ValueError("msgpack: malformed ndarray extension")
    if name == "bfloat16":
        flat = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
    else:
        flat = torch.from_numpy(np.frombuffer(buf, dtype=np.dtype(name)).copy())
    return flat.reshape(tuple(shape))


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that fills ``data``."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"msgpack: {len(data) - reader.pos} bytes after the object")
    return out


def read_flax_variables(path: str) -> Tuple[dict, dict]:
    """``(params, batch_stats)`` of a model file written by the JAX
    package (``nsdp_tpu.training.checkpoints.save_checkpoints``)."""
    with open(path, "rb") as f:
        tree = unpackb(f.read())
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{path}: not a flax model file (no 'params')")
    return tree["params"], tree.get("batch_stats", {})


def read_flax_optimizer(path: str) -> Tuple[dict, int]:
    """``(opt_state, step)`` of an optimizer file written by the JAX package
    (``nsdp_tpu.training.checkpoints.save_checkpoints``).  ``opt_state`` is
    the optax chain's state as flax serialises it: one map per stage, keyed
    ``"0"``, ``"1"``, ...; Adam's ``{"count" (a 0-d int32 tensor), "mu",
    "nu"}``, SGD's ``{"trace"}``, the moments shaped as the params tree;
    ``step`` the train state's step count as an int."""
    with open(path, "rb") as f:
        tree = unpackb(f.read())
    if not isinstance(tree, dict) or "opt_state" not in tree:
        raise ValueError(f"{path}: not a flax optimizer file (no 'opt_state')")
    return tree["opt_state"], int(tree.get("step", 0))
