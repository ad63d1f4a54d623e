"""Serving artifacts of the port (port of ``pointsecguard_tpu/utils/export.py``
without its StableHLO parts).

The evaluation forward is traced once by ``torch.export`` and saved beside
a flat ``.npz`` of the weights. A serving process then needs only
``load_artifact``: no model code and no re-trace; the kernels run as the
custom ops ``torch.ops.psg.*``, so the program launches the same kernels
as the live model (on a CPU tensor their plain versions).

The weights are ARGUMENTS of the program, never constants: the program is
``forward(state, *inputs)``, ``state`` the model's state dict (parameters
and BatchNorm statistics), bound through ``torch.func.functional_call``.
That is the JAX artifact's "params are arguments" rule.

Layout of an artifact directory:
    forward.pt2    ``torch.export.save`` of the ``ExportedProgram``
    params.npz     the variables under the JAX artifact's ``//``-joined
                   flax paths and layouts (``utils/convert.py``): the same
                   file the JAX package writes for the same weights
    meta.json      ``platforms``, ``in_avals`` (the data inputs), ``model``,
                   ``checkpoint_step`` and ``precision`` as in JAX, plus
                   ``device`` (where the program was traced) and ``params``
                   ({flax path: state-dict key}) for ``load_artifact``

A program traced on one device runs on another through
``torch.export.passes.move_to_device_pass``, which moves the devices the
trace burnt into the graph (``torch.arange(..., device=...)`` and such).
"""

from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np
import torch

SEP = "//"  # the JAX artifact's path joiner
PLATFORMS = ("cuda", "cpu")


class _Served(torch.nn.Module):
    """``call(model, *inputs)`` as a module's forward."""

    def __init__(self, model: torch.nn.Module, call: Callable):
        super().__init__()
        self.model = model
        self.call = call

    def forward(self, *inputs):
        return self.call(self.model, *inputs)


class _Functional(torch.nn.Module):
    """The served forward with the model's state dict as the first
    argument (``torch.func.functional_call``). The model is kept out of the
    registered children, so that ``torch.export`` lifts none of its
    tensors into the program."""

    def __init__(self, model: torch.nn.Module, call: Callable):
        super().__init__()
        self._held = (_Served(model, call),)

    def forward(self, state: dict[str, torch.Tensor], *inputs):
        return torch.func.functional_call(
            self._held[0], {f"model.{k}": v for k, v in state.items()}, inputs)


def export_forward(module: torch.nn.Module, example_inputs: tuple,
                   call: Callable | None = None) -> torch.export.ExportedProgram:
    """``torch.export`` (non-strict) of ``call(module, *inputs)`` — by
    default ``module(*inputs)`` — in evaluation mode, with the state dict
    as the first argument. The shapes of ``example_inputs`` are baked in."""
    module.eval()
    fn = _Functional(module, call or (lambda m, *a: m(*a)))
    with torch.no_grad():
        state = {k: v.detach() for k, v in module.state_dict().items()}
        exported = torch.export.export(fn, (state, *example_inputs), strict=False)
    # the trace puts a dtype / device assertion beside every ``.to()``; the
    # program's input specs are fixed, so they check nothing, and they are
    # over a quarter of ResGCN's nodes (its channel-by-channel norms)
    graph = exported.graph_module.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
    exported.graph_module.recompile()
    return exported


def flax_variables(model: str, state: dict[str, torch.Tensor],
                   resgcn_conv: str = "edge") -> dict[str, np.ndarray]:
    """The state dict of a ``cli.export --model`` as JAX's flat flax
    variables ("/"-joined paths, flax layouts; ``utils/convert.py``)."""
    from pointsecguard_tpu_torch.utils import convert

    if model == "resgcn":
        return convert.resgcn_to_jax_variables(state, conv=resgcn_conv)
    families = {"pointnet2": convert.to_jax_variables,
                "pointnet2_msg": convert.pointnet2_msg_to_jax_variables,
                "pointnet": convert.pointnet_to_jax_variables,
                "randla": convert.randla_to_jax_variables}
    if model in families:
        return families[model](state)
    return convert.cls_to_jax_variables(model, state)


def _param_names(state: dict[str, torch.Tensor], flat: dict[str, np.ndarray]
                 ) -> dict[str, str]:
    """{JAX path: state-dict key}. Every ``*_to_jax_variables`` writes one
    leaf per state-dict entry, in the entry's order; the values are held to
    that pairing (a Linear's weight is the transposed kernel)."""
    if len(flat) != len(state):
        raise ValueError(f"{len(flat)} flax leaves for {len(state)} state tensors")
    names = {}
    for (key, t), (path, arr) in zip(state.items(), flat.items()):
        want = t.detach().cpu().numpy()
        if not np.array_equal(arr.T if path.endswith("/kernel") else arr, want):
            raise ValueError(f"flax leaf {path} does not hold state tensor {key}")
        names[path.replace("/", SEP)] = key
    return names


def _aval(t: torch.Tensor) -> str:
    """JAX's aval notation: ``float32[1,4096,9]``."""
    return f"{str(t.dtype).removeprefix('torch.')}[{','.join(map(str, t.shape))}]"


def _data_inputs(exported: torch.export.ExportedProgram, n_state: int) -> list:
    """The traced values of the program's inputs after the state dict."""
    user = set(exported.graph_signature.user_inputs)
    vals = [n.meta["val"] for n in exported.graph.nodes
            if n.op == "placeholder" and n.name in user]
    return vals[n_state:]


def save_artifact(path: str, exported: torch.export.ExportedProgram,
                  state: dict[str, torch.Tensor], meta: dict, *,
                  resgcn_conv: str = "edge") -> None:
    """Write forward.pt2, params.npz and meta.json under ``path``.

    ``state`` is the state dict the program runs with, ``meta`` carries at
    least ``model`` (a ``cli.export --model``, which names the flax layout)
    and ``platforms``; ``resgcn_conv`` names ResGCN's graph conv, which
    its state dict does not show."""
    flat = flax_variables(meta["model"], state, resgcn_conv)
    names = _param_names(state, flat)
    inputs = _data_inputs(exported, len(state))
    os.makedirs(path, exist_ok=True)
    exported.example_inputs = None  # they would carry the weights into the file
    torch.export.save(exported, os.path.join(path, "forward.pt2"))
    np.savez(os.path.join(path, "params.npz"),
             **{p.replace("/", SEP): np.asarray(a) for p, a in flat.items()})
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({**meta, "in_avals": [_aval(t) for t in inputs],
                   "device": str(inputs[0].device), "params": names}, f, indent=2)


def load_artifact(path: str, device: str | torch.device = "cuda"
                  ) -> tuple[Callable[..., torch.Tensor], dict]:
    """An artifact directory → (forward(*inputs), meta) on ``device``.

    Imports the port's op registration and nothing of its models. Applies
    ``utils.runtime.set_float32_modes`` (no TF32, float32 reductions of bf16
    products), as the live model runs under it. ``device`` must be one of
    the artifact's platforms; the program is moved there when it was traced
    elsewhere."""
    from torch.export.passes import move_to_device_pass

    from pointsecguard_tpu_torch.ops import cuda  # noqa: F401  (registers psg::*)
    from pointsecguard_tpu_torch.utils.runtime import set_float32_modes

    device = torch.device(device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if device.type not in meta["platforms"]:
        raise ValueError(f"{path} was exported for {meta['platforms']}, not {device.type}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    set_float32_modes()
    program = torch.export.load(os.path.join(path, "forward.pt2"))
    if torch.device(meta["device"]) != device:
        program = move_to_device_pass(program, device)
    with np.load(os.path.join(path, "params.npz")) as z:
        # flax kernels are [in, out]; a Linear's weight [out, in]
        state = {key: torch.from_numpy(np.ascontiguousarray(
                     z[p].T if p.endswith(SEP + "kernel") else z[p])).to(device)
                 for p, key in meta["params"].items()}
    module = program.module()

    def forward(*inputs):
        with torch.no_grad():
            return module(state, *inputs)

    return forward, meta
