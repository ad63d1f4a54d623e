"""Minimal PLY I/O with named fields, numpy only (a copy of
``pointsecguard_tpu/data/ply.py``).

Fresh implementation of the functionality of the reference's
`RandLA-Net/helper_ply.py` (`read_ply:116`, `write_ply:217`): PLY vertex
clouds with arbitrary named scalar properties, returned as a numpy
structured array. Reads and writes binary PLY, as the reference does
(ascii raises, as `helper_ply.py:162-163` does).
"""

from __future__ import annotations

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "int8": "i1", "uint8": "u1",
    "int16": "i2", "uint16": "u2", "int32": "i4", "uint32": "u4",
    "float": "f4", "double": "f8", "float32": "f4", "float64": "f8",
}
_INV_DTYPES = {
    "i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
    "i4": "int", "u4": "uint", "f4": "float", "f8": "double",
}


_FORMAT_ENDIAN = {
    "binary_little_endian": "<",
    "binary_big_endian": ">",
}


def read_ply(path: str) -> np.ndarray:
    """Read a binary (LE/BE) PLY file → structured array of the
    vertex element's properties."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        count = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline().decode("ascii").strip()
            if line == "end_header":
                break
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                if parts[1] != "vertex" and not props:
                    # a non-vertex element BEFORE vertex would shift the
                    # binary payload — skipping it needs per-element
                    # sizes we don't parse; refuse loudly instead of
                    # silently misreading vertex data
                    raise NotImplementedError(
                        f"PLY element {parts[1]!r} precedes the vertex "
                        "element; only vertex-first layouts are supported"
                    )
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    count = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                if parts[1] == "list":
                    raise NotImplementedError(
                        "PLY list properties on the vertex element are "
                        "not supported (variable-length rows)"
                    )
                props.append((parts[2], _PLY_DTYPES[parts[1]]))
        if fmt not in _FORMAT_ENDIAN:
            raise NotImplementedError(f"PLY format {fmt} not supported")
        dtype = np.dtype(
            [(name, _FORMAT_ENDIAN[fmt] + t) for name, t in props]
        )
        return np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype)


def write_ply(path: str, arrays, field_names: list[str]) -> None:
    """Write columns (a sequence of 1-D/2-D arrays whose total column count
    equals len(field_names)) as a binary-little-endian PLY vertex cloud."""
    cols: list[np.ndarray] = []
    for a in arrays:
        a = np.asarray(a)
        if a.ndim == 1:
            cols.append(a)
        else:
            cols.extend(a[:, i] for i in range(a.shape[1]))
    if len(cols) != len(field_names):
        raise ValueError(
            f"{len(cols)} columns but {len(field_names)} field names"
        )
    # PLY has no 64-bit integer or bool types: narrow BEFORE touching the
    # file (a mid-write failure would leave a truncated header on disk).
    # int64 is numpy's default integer, so np.argmax(...) predictions are
    # the common case.
    _NARROW = {"i8": "i4", "u8": "u4", "b1": "u1"}
    cols = [
        c.astype(c.dtype.str[0] + _NARROW[c.dtype.str[1:]])
        if c.dtype.str[1:] in _NARROW else c
        for c in cols
    ]
    for name, c in zip(field_names, cols):
        if c.dtype.str[1:] not in _INV_DTYPES:
            raise ValueError(
                f"column {name!r} has dtype {c.dtype} with no PLY "
                f"equivalent (supported: {sorted(_INV_DTYPES)})"
            )
    n = len(cols[0])
    dtype = np.dtype(
        [(name, "<" + c.dtype.str[1:]) for name, c in zip(field_names, cols)]
    )
    rec = np.empty(n, dtype=dtype)
    for name, c in zip(field_names, cols):
        rec[name] = c
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for name, c in zip(field_names, cols):
            f.write(f"property {_INV_DTYPES[c.dtype.str[1:]]} {name}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())
