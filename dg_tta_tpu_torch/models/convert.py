"""Checkpoint IO for `PlainConvUNet`: nnUNet `.pth` files and the JAX
package's flat `.npz` parameter archives.

* `.pth`: an nnUNet `state_dict`, or a full `checkpoint_final.pth` dict (key
  `network_weights`), loads with a plain `load_state_dict` after
  `clean_state_dict` strips the `module.` (DDP) and `_orig_mod.`
  (torch.compile) prefixes and drops the aliases nnUNet modules register
  twice (`all_modules.*`, `decoder.encoder.*`).
* `.npz`: the JAX package writes parameter trees flat, one array per leaf
  named by its path (`encoder/stages/0/convs/0/conv/w`), channels-last
  (`dg_tta_tpu/models/convert.py::params_to_flat_npz`).  `params_from_jax`
  and `params_to_jax` relabel and transpose between that tree and a torch
  `state_dict`:

    Conv3d          (kd, kh, kw, I, O) <-> (O, I, kd, kh, kw)
    ConvTranspose3d (kd, kh, kw, O, I) <-> (I, O, kd, kh, kw)
    InstanceNorm3d  norm.scale / norm.bias <-> norm.weight / norm.bias
"""

from typing import Dict

import numpy as np
import torch

_CONV_LEAVES = {("conv", "w"): "conv.weight", ("conv", "b"): "conv.bias",
                ("norm", "scale"): "norm.weight", ("norm", "bias"): "norm.bias"}


def _to_torch_layout(arr):
    return np.ascontiguousarray(np.asarray(arr).transpose(4, 3, 0, 1, 2))


def _to_jax_layout(t: torch.Tensor):
    return np.ascontiguousarray(t.detach().cpu().numpy().transpose(2, 3, 4, 1, 0))


def _leaf(arr, name):
    arr = np.asarray(arr)
    if name.endswith("weight") and arr.ndim == 5:
        arr = _to_torch_layout(arr)
    return torch.from_numpy(np.array(arr, dtype=np.float32))


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX `unet_apply` parameter tree (nested dicts and lists of arrays)
    -> nnUNet-named f32 `state_dict` of CPU tensors."""
    sd = {}

    def put_stage(prefix, stage):
        for c, blk in enumerate(stage["convs"]):
            for (mod, leaf), name in _CONV_LEAVES.items():
                full = f"{prefix}.convs.{c}.{name}"
                sd[full] = _leaf(blk[mod][leaf], full)

    for s, stage in enumerate(tree["encoder"]["stages"]):
        put_stage(f"encoder.stages.{s}.0", stage)
    dec = tree["decoder"]
    for s, stage in enumerate(dec["stages"]):
        put_stage(f"decoder.stages.{s}", stage)
    for kind in ("transpconvs", "seg_layers"):
        for i, p in enumerate(dec[kind]):
            sd[f"decoder.{kind}.{i}.weight"] = _leaf(p["w"], "weight")
            sd[f"decoder.{kind}.{i}.bias"] = _leaf(p["b"], "bias")
    return sd


def params_to_jax(state_dict) -> dict:
    """Inverse of `params_from_jax`: nnUNet `state_dict` -> the JAX
    package's parameter tree of numpy arrays."""
    sd = clean_state_dict(state_dict)
    enc, dec_stages, transp, seg = {}, {}, {}, {}

    def arr(t):
        return _to_jax_layout(t) if t.dim() == 5 else t.detach().cpu().numpy()

    for k, t in sd.items():
        parts = k.split(".")
        if parts[0] == "encoder":      # encoder.stages.s.0.convs.c.mod.leaf
            s, c, mod, leaf = int(parts[2]), int(parts[5]), parts[6], parts[7]
            target = enc
        elif parts[1] == "stages":     # decoder.stages.s.convs.c.mod.leaf
            s, c, mod, leaf = int(parts[2]), int(parts[4]), parts[5], parts[6]
            target = dec_stages
        else:                          # decoder.{transpconvs,seg_layers}.i.x
            slot = (transp if parts[1] == "transpconvs" else seg)
            slot.setdefault(int(parts[2]), {})[
                "w" if parts[3] == "weight" else "b"] = arr(t)
            continue
        jleaf = {"conv": {"weight": "w", "bias": "b"},
                 "norm": {"weight": "scale", "bias": "bias"}}[mod][leaf]
        target.setdefault(s, {}).setdefault(c, {}).setdefault(
            mod, {})[jleaf] = arr(t)

    def stages(d):
        return [{"convs": [d[s][c] for c in sorted(d[s])]} for s in sorted(d)]

    return {
        "encoder": {"stages": stages(enc)},
        "decoder": {
            "transpconvs": [transp[i] for i in sorted(transp)],
            "stages": stages(dec_stages),
            "seg_layers": [seg[i] for i in sorted(seg)],
        },
    }


def clean_state_dict(state_dict) -> Dict[str, torch.Tensor]:
    """Unwrap `network_weights`, strip DDP / torch.compile prefixes, drop
    nnUNet's duplicate module aliases, and make every value a tensor."""
    if "network_weights" in state_dict:
        state_dict = state_dict["network_weights"]
    out = {}
    for k, v in state_dict.items():
        for pre in ("module.", "_orig_mod."):
            if k.startswith(pre):
                k = k[len(pre):]
        if "all_modules" in k or k.startswith("decoder.encoder."):
            continue
        out[k] = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
    return out


def load_torch_checkpoint(path) -> Dict[str, torch.Tensor]:
    """A `.pth` checkpoint's cleaned `state_dict`, loaded on the CPU.  The
    file is unpickled in full (nnUNet checkpoints hold plain Python objects
    beside the weights), so load only checkpoints you trust."""
    return clean_state_dict(
        torch.load(path, map_location="cpu", weights_only=False))


def load_flat_npz(path) -> Dict[str, torch.Tensor]:
    """A `.npz` archive in the JAX package's flat format -> `state_dict`."""
    with np.load(path) as z:
        items = {k: z[k] for k in z.files}
    root = {}
    for name, a in items.items():
        parts = name.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return params_from_jax(listify(root))


def save_flat_npz(state_dict, path):
    """Write a `state_dict` in the JAX package's flat `.npz` format, which
    `dg_tta_tpu/models/convert.py::flat_npz_to_params` reads."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}")
        else:
            flat[prefix] = node

    walk(params_to_jax(state_dict), "")
    np.savez(path, **flat)
