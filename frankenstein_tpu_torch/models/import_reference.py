"""Reference checkpoint files (``frankenstein_tpu/models/import_reference.py``,
its file layer): ``load_state_dict`` and ``save_state_dict``.

The reference trains torch modules and saves ``state_dict()`` tensors as
``.safetensors`` (e.g. ``step_5000_loss_3.1739.safetensors``). The port's
modules carry the reference's names and layouts, so loading such a file
into a port model is ``models/weights.py:load_strict(model,
load_state_dict(path))``; no name map is needed. For a SoundStream,
``soundstream_state`` first completes the quantizer's state as the JAX
``soundstream_params`` reads it.

The port reads and writes the safetensors layout itself, so it needs no
``safetensors`` package: an 8-byte little-endian header length, a JSON
header (``{name: {"dtype", "shape", "data_offsets": [begin, end]}}``,
offsets into the data that follows, and an optional ``__metadata__``),
then the tensors' raw little-endian bytes. torch ``.pt`` / ``.pth`` /
``.bin`` pickles load with ``weights_only=True``, as a plain state dict or
inside a ``{'state_dict' | 'model': ...}`` wrapper.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

# safetensors dtype names <-> torch dtypes
DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
          "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
          "BOOL": torch.bool}
NAMES = {v: k for k, v in DTYPES.items()}


def load_state_dict(path) -> dict:
    """A reference checkpoint file as ``{name: CPU tensor}``: a
    ``.safetensors`` file, or a torch pickle (``.pt``, ``.pth``, ``.bin``)
    holding a state dict or a ``{'state_dict' | 'model': ...}`` wrapper."""
    path = Path(path)
    if path.suffix == ".safetensors":
        return _read_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(wrapper), dict):
            obj = obj[wrapper]
    return {k: v.detach() for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


def _read_safetensors(path: Path) -> dict:
    raw = path.read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    data = memoryview(raw)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             f"not one of {sorted(DTYPES)}")
        begin, end = info["data_offsets"]
        dtype = DTYPES[info["dtype"]]
        out[name] = (torch.frombuffer(bytearray(data[begin:end]),
                                      dtype=dtype).reshape(info["shape"])
                     if end > begin else torch.empty(info["shape"],
                                                     dtype=dtype))
    return out


def save_state_dict(sd: Mapping, path) -> None:
    """Write ``sd`` (tensors or numpy arrays) as a ``.safetensors`` file
    that the reference, the ``safetensors`` package and ``load_state_dict``
    read: tensors in name order, packed, the header padded to 8 bytes."""
    tensors = {}
    for name, value in sd.items():
        t = value if isinstance(value, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(value))
        t = t.detach().to("cpu").contiguous()
        if t.dtype not in NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             "name")
        tensors[name] = t
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name]
        blob = t.reshape(-1).view(torch.uint8).numpy().tobytes() \
            if t.numel() else b""
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for blob in blobs:
            f.write(blob)


def soundstream_state(sd: Mapping) -> dict:
    """A reference SoundStream state dict with its quantizer state as the
    port's ``quantizer._codebook.*`` buffers hold it: the codebook (the
    first ``quantizer.*embed`` tensor) as [K, D] (newer
    vector_quantize_pytorch saves [1, K, D]), cluster sizes of one where
    the file has none, ``embed_avg`` = embed * cluster_size, and
    ``initted`` 1: a trained codebook is not k-means initialised again."""
    embed_keys = [k for k in sd
                  if k.startswith("quantizer.") and k.endswith("embed")]
    if not embed_keys:
        raise ValueError("no quantizer codebook ('quantizer.*embed') found")
    embed = torch.as_tensor(sd[embed_keys[0]]).float()
    embed = embed.reshape(embed.shape[-2:])
    cs_keys = [k for k in sd if k.startswith("quantizer.")
               and k.endswith("cluster_size")]
    cluster = (torch.as_tensor(sd[cs_keys[0]]).float().reshape(-1)
               if cs_keys else torch.ones(embed.shape[0]))
    out = {k: v for k, v in sd.items() if not k.startswith("quantizer.")}
    book = "quantizer._codebook."
    out.update({book + "embed": embed, book + "cluster_size": cluster,
                book + "embed_avg": embed * cluster[:, None],
                book + "initted": torch.ones(1)})
    return out
