"""Policy export: the reference package's three artifacts (deploy/export.py)
from the port's ActorCritic.

  policy.npz            actor_w{i}/actor_b{i}, vel_w{i}/vel_b{i} (kernels
                        (in, out)), std, meta_*; read by deploy/npz_policy.py
  policy_1.pt,          TorchScript float32 ELU nn.Sequentials on the CPU:
  base_lin_vel.pt       the actor and the velocity head
  policy.onnx           the actor as Gemm/Elu (transB=1, opset 13, dynamic
                        batch), protobuf written here with no onnx package;
                        read by deploy/onnx_loader.py

Every artifact is float32, whatever the net's compute dtype.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch


def _mlp_arrays(mlp, prefix: str) -> Dict[str, np.ndarray]:
    """{prefix_w{i}: (in, out) kernel, prefix_b{i}: bias} in layer order."""
    out = {}
    for i, lin in enumerate(mlp.layers):
        out[f"{prefix}_w{i}"] = lin.weight.detach().float().cpu().numpy().T.copy()
        out[f"{prefix}_b{i}"] = lin.bias.detach().float().cpu().numpy().copy()
    return out


def export_policy_npz(net, path: str, meta: Optional[Dict] = None) -> str:
    arrays = {**_mlp_arrays(net.actor, "actor"), **_mlp_arrays(net.vel_est, "vel"),
              "std": net.std.detach().float().cpu().numpy().copy()}
    for k, v in (meta or {}).items():
        arrays[f"meta_{k}"] = np.asarray(v)
    np.savez(path, **arrays)
    return path


def _sequential(mlp) -> torch.nn.Sequential:
    """A float32 CPU copy of an MLP as Linear/ELU layers."""
    mods = []
    last = len(mlp.layers) - 1
    for i, lin in enumerate(mlp.layers):
        copy = torch.nn.Linear(lin.in_features, lin.out_features)
        with torch.no_grad():
            copy.weight.copy_(lin.weight.detach().float().cpu())
            copy.bias.copy_(lin.bias.detach().float().cpu())
        mods.append(copy)
        if i < last:
            mods.append(torch.nn.ELU())
    return torch.nn.Sequential(*mods).eval()


def export_policy_torchscript(net, out_dir: str) -> Dict[str, str]:
    """policy_1.pt (the actor) and base_lin_vel.pt (the velocity head)."""
    paths = {}
    for mlp, fname in ((net.actor, "policy_1.pt"), (net.vel_est, "base_lin_vel.pt")):
        path = os.path.join(out_dir, fname)
        torch.jit.script(_sequential(mlp)).save(path)
        paths[fname] = path
    return paths


# ---- the protobuf wire format, as much of ONNX's ModelProto as the actor needs ----

def _pb_varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _pb_field(field: int, wire: int, payload: bytes) -> bytes:
    return _pb_varint((field << 3) | wire) + payload


def _pb_len(field: int, payload: bytes) -> bytes:
    return _pb_field(field, 2, _pb_varint(len(payload)) + payload)


def _pb_int(field: int, v: int) -> bytes:
    return _pb_field(field, 0, _pb_varint(v))


def _pb_str(field: int, s: str) -> bytes:
    return _pb_len(field, s.encode())


def _onnx_tensor(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims, data_type FLOAT, name, raw_data."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    return (b"".join(_pb_int(1, d) for d in arr.shape) + _pb_int(2, 1) + _pb_str(8, name)
            + _pb_len(9, arr.tobytes()))


def _onnx_value_info(name: str, dim1: int) -> bytes:
    """ValueInfoProto of a float tensor of shape [batch, dim1]."""
    shape = _pb_len(1, _pb_str(3, "batch")) + _pb_len(1, _pb_int(1, dim1))
    tensor_type = _pb_int(1, 1) + _pb_len(2, shape)
    return _pb_str(1, name) + _pb_len(2, _pb_len(1, tensor_type))


def _onnx_node(op: str, inputs, outputs, attrs=()) -> bytes:
    """NodeProto with integer attributes."""
    buf = b"".join(_pb_str(1, i) for i in inputs) + b"".join(_pb_str(2, o) for o in outputs)
    buf += _pb_str(4, op)
    for name, ival in attrs:
        buf += _pb_len(5, _pb_str(1, name) + _pb_int(3, ival) + _pb_int(20, 2))  # type INT
    return buf


def export_policy_onnx(net, path: str, num_obs: int) -> str:
    """The actor as Gemm (transB=1) / Elu nodes on input [batch, num_obs]."""
    layers = net.actor.layers
    nodes = inits = b""
    x = "input"
    for i, lin in enumerate(layers):
        w = lin.weight.detach().float().cpu().numpy()          # (out, in): transB
        b = lin.bias.detach().float().cpu().numpy()
        inits += _pb_len(5, _onnx_tensor(f"w{i}", w)) + _pb_len(5, _onnx_tensor(f"b{i}", b))
        y = "output" if i == len(layers) - 1 else f"h{i}"
        nodes += _pb_len(1, _onnx_node("Gemm", [x, f"w{i}", f"b{i}"], [y], [("transB", 1)]))
        if i < len(layers) - 1:
            nodes += _pb_len(1, _onnx_node("Elu", [y], [f"a{i}"]))
            x = f"a{i}"
    graph = (nodes + _pb_str(2, "actor") + inits
             + _pb_len(11, _onnx_value_info("input", num_obs))
             + _pb_len(12, _onnx_value_info("output", layers[-1].out_features)))
    model = (_pb_int(1, 8) + _pb_str(2, "humanoid_tpu_torch") + _pb_len(7, graph)
             + _pb_len(8, _pb_str(1, "") + _pb_int(2, 13)))
    with open(path, "wb") as f:
        f.write(model)
    return path
