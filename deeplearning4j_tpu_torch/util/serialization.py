"""Model serialization — the reference's zip checkpoint format.

Counterpart of the JAX package's `util/serialization.py`. The zip holds:

- configuration.json : MultiLayerConfiguration or
                       ComputationGraphConfiguration JSON
- coefficients.npz   : params, keys are '/'-joined paths (``1/attn/Wq``,
                       ``1/ln1/gamma``, ``0/W``, ``5/b``; a graph's start
                       with the vertex name, ``stem_conv/W``)
- state.npz          : layer state (BatchNormalization's running
                       ``mean``/``var``)
- metadata.json      : model type, iteration/epoch counters, version
- updaterState.bin   : the optimizer state, in optax's state-dict layout,
                       as flax's msgpack writes it (`to_bytes`): a map per
                       dict level, arrays as ext type 1 holding msgpack
                       ``(shape, dtype name, C-order bytes)``.

So a zip written by either package loads in the other, and training
resumes there with its optimizer state. Weights keep their (in, out) and
HWIO layouts: nothing is transposed.
"""
from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.util import msgpack
from deeplearning4j_tpu_torch.util.platform import DeviceLike

_FORMAT_VERSION = 1

# flax.serialization's ext type codes; flax splits leaves above 1 GiB
# into chunks, which the port neither writes nor reads
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_MAX_LEAF_BYTES = 2 ** 30


def iter_leaves(tree, prefix: Tuple[str, ...] = ()) \
        -> Iterator[Tuple[Tuple[str, ...], object]]:
    """(path, leaf) pairs of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from iter_leaves(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def _tree_to_npz_bytes(tree) -> bytes:
    arrays = {}
    for path, leaf in iter_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            if leaf.dtype == torch.bfloat16:
                raise ValueError("npz cannot hold bfloat16; save float32 "
                                 "parameters")
            leaf = leaf.numpy()
        arrays["/".join(path)] = np.asarray(leaf)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _npz_bytes_to_tree(data: bytes) -> dict:
    tree: dict = {}
    with np.load(io.BytesIO(data)) as loaded:
        for key in loaded.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.array(loaded[key])
    return tree


def _leaf_to_numpy(leaf) -> np.ndarray:
    """A tensor or array -> a C-order numpy array; bfloat16 as its raw
    16-bit words (numpy has no bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().contiguous()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy()
        return leaf.numpy()
    return np.ascontiguousarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return _leaf_to_numpy(leaf).dtype.name


def _ext_pack(leaf):
    arr = _leaf_to_numpy(leaf)
    if arr.nbytes > _MAX_LEAF_BYTES:
        raise ValueError(f"updaterState.bin: a {arr.nbytes}-byte leaf is "
                         "above flax's 1 GiB chunking limit")
    return msgpack.ExtType(_EXT_NDARRAY, msgpack.packb(
        (tuple(arr.shape), _dtype_name(leaf), arr.tobytes("C"))))


def _ext_unpack(code, data):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"updaterState.bin: unknown msgpack ext type {code}")
    shape, name, buf = msgpack.unpackb(data)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        arr = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16) \
            .reshape(shape)
    else:
        arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)
    return arr


def updater_state_to_bytes(state) -> bytes:
    """An optimizer state (nested dicts of tensors, optax's state-dict
    layout) -> the bytes flax's `to_bytes` writes for the same state."""
    return msgpack.packb(state, default=_ext_pack)


def updater_state_from_bytes(data: bytes, template):
    """Bytes written by `updater_state_to_bytes` or by flax's `to_bytes`
    -> a state with `template`'s structure, dtypes and device. Keys and
    shapes must match the template's (a freshly built state) exactly."""
    loaded = msgpack.unpackb(data, ext_hook=_ext_unpack)

    def walk(node, tmpl, path):
        where = "/".join(path) or "<root>"
        if isinstance(tmpl, dict):
            if not isinstance(node, dict) or set(node) != set(tmpl):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"updaterState.bin {where}: keys {got} != "
                                 f"expected {sorted(tmpl)}")
            return {k: walk(node[k], v, path + (k,)) for k, v in tmpl.items()}
        t = node if isinstance(node, torch.Tensor) \
            else torch.from_numpy(np.array(node))
        if tuple(t.shape) != tuple(tmpl.shape):
            raise ValueError(f"updaterState.bin {where}: shape "
                             f"{tuple(t.shape)} != expected "
                             f"{tuple(tmpl.shape)}")
        return t.to(device=tmpl.device, dtype=tmpl.dtype)

    return walk(loaded, template, ())


def params_from_numpy(tree, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None, template=None):
    """A parameter tree of numpy arrays (the JAX package's params as
    `np.asarray` leaves, or an npz read back) -> the port's tree of
    tensors on `device`, floats cast to `dtype` when given.

    A list in `tree` (the reference keeps a VAE's MLP as one) becomes a
    dict keyed by the index, the port's layout of it.

    With `template` (an initialized network's params), the result has the
    template's structure: subtrees missing from `tree` (parameter-free
    layers, which npz drops) stay as they are, and a shape or key that
    disagrees with the template raises."""
    from deeplearning4j_tpu_torch.util.platform import resolve_device
    dev = resolve_device(device)

    def convert(a):
        t = torch.from_numpy(np.array(a))   # an owned, writable copy
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    def walk(node, tmpl, path):
        if isinstance(node, (list, tuple)):     # a VAE's MLP stack
            node = {str(i): v for i, v in enumerate(node)}
        if tmpl is None:
            if isinstance(node, dict):
                return {k: walk(v, None, path + (k,)) for k, v in node.items()}
            return convert(node)
        if isinstance(tmpl, dict):
            node = {} if node is None else node
            if not isinstance(node, dict):
                raise ValueError(f"{'/'.join(path)}: expected a subtree")
            extra = set(node) - set(tmpl)
            if extra:
                raise ValueError(f"{'/'.join(path) or '<root>'}: unexpected "
                                 f"keys {sorted(extra)}")
            return {k: walk(node.get(k), v, path + (k,))
                    for k, v in tmpl.items()}
        if node is None:
            raise ValueError(f"{'/'.join(path)}: missing from the checkpoint")
        t = convert(node)
        if tuple(t.shape) != tuple(tmpl.shape):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)} != "
                             f"expected {tuple(tmpl.shape)}")
        return t.to(dtype=tmpl.dtype) if t.is_floating_point() else t

    return walk(tree, template, ())


def save_model(model, path, save_updater: bool = True, atomic: bool = True,
               extra_entries: Optional[dict] = None,
               compression: int = zipfile.ZIP_DEFLATED):
    """Write a model checkpoint zip (ModelSerializer.writeModel), with
    updaterState.bin when `save_updater` and the model has an optimizer
    state. `atomic`: written to a temp file and renamed, so a kill
    mid-save never leaves a truncated zip at `path`. `extra_entries`
    ({name: str|bytes}) adds caller entries to the archive (the
    checkpoint manager's resilience.json). `compression` is the zip
    method of every entry: deflate by default, as the reference writes;
    the checkpoint manager stores them (deflate runs at tens of MB/s on
    the host, and a resilient fit waits for each save)."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    if isinstance(model, MultiLayerNetwork):
        model_type = "MultiLayerNetwork"
    elif isinstance(model, ComputationGraph):
        model_type = "ComputationGraph"
    else:
        raise ValueError(f"Cannot serialize {type(model)}")
    meta = {"format_version": _FORMAT_VERSION,
            "model_type": model_type,
            "iteration_count": model.iteration_count,
            "epoch_count": model.epoch_count}
    atomic = atomic and isinstance(path, (str, os.PathLike))
    target = f"{path}.tmp.{os.getpid()}" if atomic else path
    try:
        with zipfile.ZipFile(target, "w", compression) as zf:
            zf.writestr("configuration.json", model.conf.to_json())
            zf.writestr("coefficients.npz", _tree_to_npz_bytes(model.params))
            zf.writestr("state.npz", _tree_to_npz_bytes(model.state))
            zf.writestr("metadata.json", json.dumps(meta))
            if save_updater and model.opt_state is not None:
                zf.writestr("updaterState.bin",
                            updater_state_to_bytes(model.opt_state))
            for name, data in (extra_entries or {}).items():
                zf.writestr(name, data)
        if atomic:
            os.replace(target, path)
    except BaseException:
        if atomic and os.path.exists(target):
            os.remove(target)
        raise
    return path


def _restore(path, expect_type: Optional[str], device: DeviceLike,
             load_updater: bool):
    from deeplearning4j_tpu_torch.nn.conf.network import (
        ComputationGraphConfiguration, MultiLayerConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    kinds = {"MultiLayerNetwork": (MultiLayerConfiguration,
                                   MultiLayerNetwork),
             "ComputationGraph": (ComputationGraphConfiguration,
                                  ComputationGraph)}
    with zipfile.ZipFile(path, "r") as zf:
        meta = json.loads(zf.read("metadata.json"))
        model_type = meta["model_type"]
        if expect_type and model_type != expect_type:
            raise ValueError(f"Checkpoint holds a {model_type}, expected "
                             f"{expect_type}")
        if model_type not in kinds:
            raise ValueError(f"unknown model_type {model_type!r}")
        conf_cls, model_cls = kinds[model_type]
        conf = conf_cls.from_json(zf.read("configuration.json").decode())
        model = model_cls(conf, device=device).init()
        model.params = params_from_numpy(
            _npz_bytes_to_tree(zf.read("coefficients.npz")), model.device,
            template=model.params)
        model.state = params_from_numpy(
            _npz_bytes_to_tree(zf.read("state.npz")), model.device,
            template=model.state)
        model.iteration_count = meta.get("iteration_count", 0)
        model.epoch_count = meta.get("epoch_count", 0)
        if load_updater and "updaterState.bin" in zf.namelist():
            model.opt_state = updater_state_from_bytes(
                zf.read("updaterState.bin"), model.optimizer_state_template())
    return model


def restore_multilayer_network(path, device: DeviceLike = None,
                               load_updater: bool = True):
    return _restore(path, "MultiLayerNetwork", device, load_updater)


def restore_computation_graph(path, device: DeviceLike = None,
                              load_updater: bool = True):
    return _restore(path, "ComputationGraph", device, load_updater)


def load_model(path, device: DeviceLike = None, load_updater: bool = True):
    """Load a checkpoint zip onto `device` (default CUDA; raises without
    it), with its optimizer state from updaterState.bin when present and
    `load_updater`."""
    return _restore(path, None, device, load_updater)
