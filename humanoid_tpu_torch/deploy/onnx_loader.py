"""A numpy reader of an ONNX MLP (a Gemm/Elu chain, such as the actor that
deploy/export.py writes): the reference package's deploy/onnx_loader.py.

It parses just enough of the protobuf wire format, with no onnx package,
to pull out the initializers and the node order: ModelProto.graph,
GraphProto nodes and initializers, float32 TensorProtos (raw_data or
float_data), and Gemm (with transB), Elu, Identity, Flatten and Cast.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """(field, wire type, value) of each field of a message."""
    pos, n = 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + ln], pos + ln
        elif wire == 5:
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: bytes):
    """TensorProto: dims 1, data_type 2, float_data 4, name 8, raw_data 9."""
    dims: List[int] = []
    name, dtype, floats, raw = "", 1, [], b""
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 0:
            dims.append(val)
        elif field == 2 and wire == 0:
            dtype = val
        elif field == 4:
            if wire == 5:
                floats.append(struct.unpack("<f", val)[0])
            elif wire == 2:
                floats.extend(np.frombuffer(val, dtype="<f4").tolist())
        elif field == 8 and wire == 2:
            name = val.decode()
        elif field == 9 and wire == 2:
            raw = val
    if dtype != 1:
        raise ValueError(f"tensor {name}: only float32 is read, got data type {dtype}")
    arr = np.frombuffer(raw, dtype="<f4").copy() if raw else np.array(floats, dtype=np.float32)
    return name, arr.reshape(dims or (-1,))


def _parse_attr(buf: bytes):
    """AttributeProto: name 1, f 2, i 3."""
    name, value = "", None
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 2:
            name = val.decode()
        elif field == 2 and wire == 5:
            value = struct.unpack("<f", val)[0]
        elif field == 3 and wire == 0:
            value = val
    return name, value


def _parse_node(buf: bytes):
    """NodeProto: input 1, output 2, op_type 4, attribute 5."""
    inputs, outputs, op, attrs = [], [], "", {}
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 2:
            inputs.append(val.decode())
        elif field == 2 and wire == 2:
            outputs.append(val.decode())
        elif field == 4 and wire == 2:
            op = val.decode()
        elif field == 5 and wire == 2:
            name, v = _parse_attr(val)
            attrs[name] = v
    return op, inputs, outputs, attrs


def parse_graph(path: str):
    """(initializers {name: array}, nodes [(op, inputs, outputs, attrs)])."""
    with open(path, "rb") as f:
        buf = f.read()
    graph = None
    for field, wire, val in _iter_fields(buf):
        if field == 7 and wire == 2:
            graph = val
    if graph is None:
        raise ValueError(f"no graph in {path}")
    initializers: Dict[str, np.ndarray] = {}
    nodes = []
    for field, wire, val in _iter_fields(graph):
        if field == 1 and wire == 2:
            nodes.append(_parse_node(val))
        elif field == 5 and wire == 2:
            name, arr = _parse_tensor(val)
            initializers[name] = arr
    return initializers, nodes


def load_onnx_mlp(path: str):
    """A numpy callable obs (B, in) -> (B, out) of the Gemm/Elu chain in
    `path`; its `layers` are the (W (in, out), b) pairs."""
    initializers, nodes = parse_graph(path)
    layers, ops = [], []
    for op, inputs, _, attrs in nodes:
        if op == "Gemm":
            W = initializers[inputs[1]]
            b = initializers[inputs[2]] if len(inputs) > 2 else 0.0
            if attrs.get("transB", 0):
                W = W.T
            layers.append((W.astype(np.float32), np.asarray(b, np.float32)))
            ops.append("gemm")
        elif op == "Elu":
            ops.append("elu")
        elif op not in ("Identity", "Flatten", "Cast"):
            raise ValueError(f"unsupported op {op}")

    def forward(x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32)
        li = 0
        for op in ops:
            if op == "gemm":
                W, b = layers[li]
                x = x @ W + b
                li += 1
            else:
                x = np.where(x > 0, x, np.expm1(x))
        return x

    forward.layers = layers
    return forward
