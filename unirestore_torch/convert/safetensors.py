"""A reader of the safetensors format in numpy, for the checkpoint converters.

Diffusers ships sd-turbo as ``vae/`` and ``unet/diffusion_pytorch_model.safetensors``;
``tools/convert_sd_turbo.py:27-33`` reads them through the ``safetensors``
package, which the port does not need. The format: an 8-byte little-endian
header length N, N bytes of JSON (padded with spaces), then the raw
little-endian data. Each header entry ``{"dtype", "shape", "data_offsets":
[begin, end]}`` locates its tensor by offsets counted from the end of the
header; ``__metadata__`` holds strings only.

``load_file(path)`` gives what ``safe_open(path, framework="numpy")`` gives,
keys sorted as its ``keys()`` lists them: numpy arrays in the stored dtype.
BF16 and the F8 types have no numpy dtype, so a file holding one is refused
with the key and the dtype named, as the JAX tool's numpy reader refuses it.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4", "I16": "<i2",
          "I8": "i1", "U8": "u1", "BOOL": "?"}


def load_file(path) -> dict:
    """Every tensor of a ``.safetensors`` file as a numpy array, by sorted key."""
    size = os.path.getsize(path)
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        raw = f.read(n)
        if len(raw) != n:
            raise ValueError(f"{path}: header of {n} bytes, the file holds {len(raw)}")
        header = json.loads(raw)
        header.pop("__metadata__", None)
        start = 8 + n
        for key in sorted(header):
            entry = header[key]
            if entry["dtype"] not in DTYPES:
                raise ValueError(f"{path}: tensor {key!r} is {entry['dtype']}, which numpy "
                                 f"cannot hold (readable: {', '.join(DTYPES)})")
            dtype = np.dtype(DTYPES[entry["dtype"]])
            shape = tuple(entry["shape"])
            begin, end = entry["data_offsets"]
            if not 0 <= begin <= end or start + end > size:
                raise ValueError(f"{path}: tensor {key!r} has offsets {begin}-{end} past "
                                 f"the data's {size - start} bytes")
            if end - begin != dtype.itemsize * int(np.prod(shape)):
                raise ValueError(f"{path}: tensor {key!r} of {entry['dtype']} {list(shape)} "
                                 f"spans {end - begin} bytes")
            buf = bytearray(end - begin)
            f.seek(start + begin)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{path}: tensor {key!r} is cut short")
            arr = np.frombuffer(buf, dtype).reshape(shape)
            out[key] = arr.astype(dtype.newbyteorder("="), copy=False)
    return out
