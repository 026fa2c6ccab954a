"""Reference torch checkpoints -> flax-layout variables, NumPy only: the
port's copy of ``ensemble_svs_with_interactions_tpu/utils/torch_port.py``.

Lets packed voicebanks trained with the reference NNSVS (or ENUNU) run on
the port without retraining: the reference ``state_dict`` is grouped into
layer units (Linear / Conv1d / LSTM / BatchNorm1d / Embedding) in
definition order, the flax-layout parameter tree of the port's module is
grouped the same way in its key order, and units are matched pairwise
with shape checks.  ``utils/flax_port.flax_to_torch`` then loads the
result into the port's module, as it loads a pack's weights.

This ``torch_to_flax`` turns a *reference* state dict (the reference's own
module layout, ``nn.LSTM``'s ``weight_ih_l0``, ``(out, in)`` kernels)
into flax variables on a template.  ``utils/flax_port.torch_to_flax``,
of the same name, goes the other way for the *port's* modules: it reads a
port module's weights out as its flax variables.

Key conversions:
  * Linear:  torch (out, in)       -> flax kernel (in, out)
  * Conv1d:  torch (out, in, k)    -> flax kernel (k, in, out)
  * LSTM:    torch weight_ih_l{k}l (4H, in) gate order [i, f, g, o]
             -> flax OptimizedLSTMCell i{i,f,g,o}/kernel (in, H);
             torch b_ih + b_hh     -> flax h{i,f,g,o}/bias
  * BatchNorm1d: weight/bias -> scale/bias; running stats -> batch_stats
  * weight-normed convs (weight_g, weight_v) are materialized first.

This matches architectures that are 1:1 module-for-module (the model
zoo mirrors the reference's definition order).  Mismatched unit kinds or
shapes raise with a side-by-side report.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "torch_to_flax",
    "port_torch_checkpoint",
    "transformer_scope_pairs",
]


def transformer_scope_pairs(
    num_layers: int, torch_prefix: str = "encoder.", flax_prefix: str = ""
) -> List[Tuple[str, str]]:
    """Scope pairs for porting the reference transformer encoder.

    The torch encoder groups all layers per ModuleList (attn_layers.*,
    norm_layers_1.*, ffn_layers.*, norm_layers_2.* — reference
    nnsvs/transformer/encoder.py:104-128) while the flax encoder interleaves
    per block; the per-layer norms share shapes, so order-based matching
    would cross-assign them without these scopes.
    """
    pairs: List[Tuple[str, str]] = []
    for i in range(num_layers):
        blk = f"{flax_prefix}/_TransformerBlock_{i}"
        # no trailing dot: norm units are named by their module path itself
        pairs += [
            (f"{torch_prefix}attn_layers.{i}.", f"{blk}/attn"),
            (f"{torch_prefix}norm_layers_1.{i}", f"{blk}/norm_1"),
            (f"{torch_prefix}ffn_layers.{i}.", f"{blk}/ffn_conv"),
            (f"{torch_prefix}norm_layers_2.{i}", f"{blk}/norm_2"),
        ]
    return pairs


# ---------------------------------------------------------------- torch side
def _materialize_weight_norm(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in sd.items():
        if k.endswith("weight_v"):
            g = sd[k[: -len("weight_v")] + "weight_g"]
            v = np.asarray(v)
            g = np.asarray(g)
            norm = np.sqrt((v**2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
            out[k[: -len("weight_v")] + "weight"] = g * v / np.maximum(norm, 1e-12)
        elif k.endswith("weight_g"):
            continue
        else:
            out[k] = np.asarray(v)
    return out


def _torch_units(sd: Dict[str, np.ndarray]) -> List[Tuple[str, str, Dict]]:
    """Group a state dict into (kind, name, tensors) units in order."""
    sd = _materialize_weight_norm(
        {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    )
    units: List[Tuple[str, str, Dict]] = []
    seen = set()
    keys = list(sd.keys())
    for k in keys:
        if k in seen:
            continue
        prefix, leaf = k.rsplit(".", 1) if "." in k else ("", k)

        def _p(name):
            return f"{prefix}.{name}" if prefix else name

        if leaf == "weight_ih" or leaf.startswith("weight_ih_l"):
            # nn.LSTM per-layer weights (weight_ih_l0[_reverse]) or a bare
            # nn.LSTMCell (weight_ih)
            suffix = leaf[len("weight_ih") :].lstrip("_")
            sep = "_" if suffix else ""
            names = [
                _p(f"weight_ih{sep}{suffix}"),
                _p(f"weight_hh{sep}{suffix}"),
                _p(f"bias_ih{sep}{suffix}"),
                _p(f"bias_hh{sep}{suffix}"),
            ]
            tensors = {n.rsplit(".", 1)[-1]: sd[n] for n in names if n in sd}
            seen.update(n for n in names if n in sd)
            units.append(("lstm_cell", f"{prefix}.{suffix}", tensors))
        elif leaf == "weight":
            w = sd[k]
            bias_k = _p("bias")
            mean_k = _p("running_mean")
            if mean_k in sd:  # BatchNorm
                tensors = {
                    "weight": w,
                    "bias": sd[bias_k],
                    "running_mean": sd[mean_k],
                    "running_var": sd[_p("running_var")],
                }
                seen.update([k, bias_k, mean_k, _p("running_var")])
                units.append(("batchnorm", prefix, tensors))
            elif w.ndim == 3:
                tensors = {"weight": w}
                seen.add(k)
                if bias_k in sd:
                    tensors["bias"] = sd[bias_k]
                    seen.add(bias_k)
                units.append(("conv1d", prefix, tensors))
            elif w.ndim == 4:
                tensors = {"weight": w}
                seen.add(k)
                if bias_k in sd:
                    tensors["bias"] = sd[bias_k]
                    seen.add(bias_k)
                units.append(("conv2d", prefix, tensors))
            elif w.ndim == 1 and bias_k in sd:
                # LayerNorm / affine norm (no running stats)
                tensors = {"weight": w, "bias": sd[bias_k]}
                seen.update([k, bias_k])
                units.append(("batchnorm", prefix, tensors))
            else:
                tensors = {"weight": w}
                seen.add(k)
                if bias_k in sd:
                    tensors["bias"] = sd[bias_k]
                    seen.add(bias_k)
                units.append(("linear", prefix, tensors))
        elif leaf == "in_proj_weight":
            # fairseq-style MultiheadAttention combined qkv projection
            # (reference diffsinger/fs2.py:132) — a linear unit
            tensors = {"weight": sd[k]}
            seen.add(k)
            if _p("in_proj_bias") in sd:
                tensors["bias"] = sd[_p("in_proj_bias")]
                seen.add(_p("in_proj_bias"))
            units.append(("linear", prefix, tensors))
        elif leaf == "in_proj_bias":
            continue  # consumed with in_proj_weight
        elif leaf == "gamma" and _p("beta") in sd:
            # custom LayerNorm with gamma/beta leaves (reference
            # nnsvs/transformer/encoder.py:9-21)
            tensors = {"weight": sd[k], "bias": sd[_p("beta")]}
            seen.update([k, _p("beta")])
            units.append(("batchnorm", prefix, tensors))
        elif leaf == "bias" or leaf.startswith("bias_") or leaf.startswith(
            "weight_hh"
        ):
            continue  # consumed with its weight
        elif leaf == "beta" and _p("gamma") in sd:
            continue  # consumed with its gamma
        else:
            seen.add(k)
            units.append(("param", k, {"value": sd[k]}))
    return units


# ----------------------------------------------------------------- flax side
def _flax_units(params: Dict, path: str = "") -> List[Tuple[str, str, Dict]]:
    """Group the flax param tree into units in insertion order."""
    units: List[Tuple[str, str, Dict]] = []
    if not isinstance(params, dict):
        return units
    keys = set(params.keys())
    if {"ii", "if", "ig", "io", "hi", "hf", "hg", "ho"} <= keys:
        units.append(("lstm_cell", path, params))
        return units
    if "kernel" in keys:
        rank = np.ndim(params["kernel"])
        kind = {3: "conv1d", 4: "conv2d"}.get(rank, "linear")
        units.append((kind, path, params))
        return units
    if "scale" in keys and "bias" in keys and len(keys) == 2:
        units.append(("batchnorm", path, params))
        return units
    if "embedding" in keys:
        units.append(("embedding", path, params))
        return units
    # flax nn.WeightNorm stores a per-output-channel scale under a sibling
    # "WeightNorm_X/<wrapped_name>/kernel/scale"; attach it to the wrapped
    # conv/dense unit so the port can reconstruct (kernel, scale) from the
    # materialized torch weight.
    wn_scales = {}
    for k, v in params.items():
        if k.startswith("WeightNorm_") and isinstance(v, dict):
            for sub_key in v:
                # flax stores the scale under one flat key like
                # "Conv_0/kernel/scale"
                if sub_key.endswith("/kernel/scale"):
                    wrapped_name = sub_key.split("/", 1)[0]
                    wn_scales[wrapped_name] = (v, sub_key)

    leaf_items = {k: v for k, v in params.items() if not isinstance(v, dict)}
    for k, v in leaf_items.items():
        units.append(("param", f"{path}/{k}", {"value": v}))
    for k, v in params.items():
        if not isinstance(v, dict) or k.startswith("WeightNorm_"):
            continue
        sub_units = _flax_units(v, f"{path}/{k}")
        if k in wn_scales:
            for kind, upath, unode in sub_units:
                if kind in ("conv1d", "linear") and upath == f"{path}/{k}":
                    unode["_wn_scale_node"] = wn_scales[k]
        units.extend(sub_units)
    return units


def _set_path(tree: Dict, path: str, leaf: str, value):
    node = tree
    for part in [p for p in path.split("/") if p]:
        node = node[part]
    node[leaf] = value.astype(np.asarray(node[leaf]).dtype)


def _set_wn_scale(funit, kernel):
    """flax WeightNorm computes scale * kernel/||kernel|| per output
    channel; setting scale = ||kernel|| reproduces the materialized torch
    weight exactly."""
    ref = funit.get("_wn_scale_node")
    if ref is None:
        return
    node, key = ref
    axes = tuple(range(kernel.ndim - 1))
    norms = np.sqrt((kernel**2).sum(axis=axes))
    node[key] = norms.astype(np.asarray(node[key]).dtype)


def _assign(new_params, new_stats, kind, fpath, funit, tensors):
    if kind == "linear":
        w = np.ascontiguousarray(tensors["weight"].T)
        _set_path(new_params, fpath, "kernel", w)
        _set_wn_scale(funit, w)
        if "bias" in tensors and "bias" in funit:
            _set_path(new_params, fpath, "bias", tensors["bias"])
    elif kind == "conv1d":
        # (out, in, k) -> (k, in, out)
        w = np.ascontiguousarray(tensors["weight"].transpose(2, 1, 0))
        _set_path(new_params, fpath, "kernel", w)
        _set_wn_scale(funit, w)
        if "bias" in tensors and "bias" in funit:
            _set_path(new_params, fpath, "bias", tensors["bias"])
    elif kind == "conv2d":
        # (out, in, kh, kw) -> (kh, kw, in, out)
        w = np.ascontiguousarray(tensors["weight"].transpose(2, 3, 1, 0))
        _set_path(new_params, fpath, "kernel", w)
        _set_wn_scale(funit, w)
        if "bias" in tensors and "bias" in funit:
            _set_path(new_params, fpath, "bias", tensors["bias"])
    elif kind == "lstm_cell":
        w_ih = tensors[[k for k in tensors if k.startswith("weight_ih")][0]]
        w_hh = tensors[[k for k in tensors if k.startswith("weight_hh")][0]]
        b_ih = tensors.get(
            next((k for k in tensors if k.startswith("bias_ih")), ""), None
        )
        b_hh = tensors.get(
            next((k for k in tensors if k.startswith("bias_hh")), ""), None
        )
        H = w_hh.shape[1]
        node = new_params
        for part in [p for p in fpath.split("/") if p]:
            node = node[part]
        for gi, gate in enumerate(("i", "f", "g", "o")):
            sl = slice(gi * H, (gi + 1) * H)
            node[f"i{gate}"]["kernel"] = np.ascontiguousarray(
                w_ih[sl].T
            ).astype(np.asarray(node[f"i{gate}"]["kernel"]).dtype)
            node[f"h{gate}"]["kernel"] = np.ascontiguousarray(
                w_hh[sl].T
            ).astype(np.asarray(node[f"h{gate}"]["kernel"]).dtype)
            if b_ih is not None and b_hh is not None:
                node[f"h{gate}"]["bias"] = (
                    b_ih[sl] + b_hh[sl]
                ).astype(np.asarray(node[f"h{gate}"]["bias"]).dtype)
    elif kind == "batchnorm":
        _set_path(new_params, fpath, "scale", tensors["weight"])
        _set_path(new_params, fpath, "bias", tensors["bias"])
        if new_stats and "running_mean" in tensors:
            node = new_stats
            ok = True
            for part in [p for p in fpath.split("/") if p]:
                if part not in node:
                    ok = False
                    break
                node = node[part]
            if ok:
                node["mean"] = tensors["running_mean"].astype(
                    np.asarray(node["mean"]).dtype
                )
                node["var"] = tensors["running_var"].astype(
                    np.asarray(node["var"]).dtype
                )
    elif kind == "embedding":
        _set_path(new_params, fpath, "embedding", tensors["weight"])
    elif kind == "param" and "weight" in tensors:
        # depthwise FIR conv kernel -> taps: squeeze + un-flip (the torch
        # kernel's LAST index is the current sample, dsp.py:119/129)
        taps = np.ascontiguousarray(tensors["weight"][:, 0, ::-1])
        _set_path(new_params, *fpath.rsplit("/", 1), taps)
    else:
        _set_path(new_params, *fpath.rsplit("/", 1), tensors["value"])


def _shapes_compatible(kind, funit, tensors) -> bool:
    if kind == "linear":
        return tuple(np.shape(funit["kernel"])) == tuple(tensors["weight"].T.shape)
    if kind == "conv1d":
        return tuple(np.shape(funit["kernel"])) == tuple(
            tensors["weight"].transpose(2, 1, 0).shape
        )
    if kind == "conv2d":
        return tuple(np.shape(funit["kernel"])) == tuple(
            tensors["weight"].transpose(2, 3, 1, 0).shape
        )
    if kind == "lstm_cell":
        w_ih = tensors[[k for k in tensors if k.startswith("weight_ih")][0]]
        H = np.shape(funit["hi"]["kernel"])[0]
        return w_ih.shape[0] == 4 * H and np.shape(funit["ii"]["kernel"])[0] == (
            w_ih.shape[1]
        )
    if kind == "batchnorm":
        return tuple(np.shape(funit["scale"])) == tuple(tensors["weight"].shape)
    if kind == "embedding":
        return tuple(np.shape(funit["embedding"])) == tuple(tensors["weight"].shape)
    if kind == "param":
        if "weight" in tensors:  # depthwise FIR conv -> taps param
            w = tensors["weight"]
            return tuple(np.shape(funit["value"])) == (w.shape[0], w.shape[2])
        # bare parameters pair by order WITHIN matching shapes — without
        # this check two same-kind params in different definition order
        # would be assigned blindly
        return tuple(np.shape(funit["value"])) == tuple(
            np.shape(tensors["value"])
        )
    return True


def torch_to_flax(
    state_dict: Dict,
    variables: Dict,
    scope_pairs: Optional[List[Tuple[str, str]]] = None,
) -> Tuple[Dict, int]:
    """Port a torch state dict onto a flax variables template.

    ``scope_pairs`` maps torch submodule prefixes to flax scope prefixes
    (e.g. ``[("encoder.", "/_encoder"), ("lf0_model.", "/_lf0")]``) for
    composite models where identically-shaped layers exist in several
    submodules — units are then matched within each scope group only.

    Returns (new_variables, n_units_ported).  Raises ValueError with a
    side-by-side unit report on order/kind/shape mismatch.
    """
    import copy

    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    tunits = _torch_units(sd)
    params = copy.deepcopy(_tree_to_numpy(variables["params"]))
    stats = _tree_to_numpy(variables.get("batch_stats", {}))
    funits = _flax_units(params)

    if scope_pairs:
        total_aligned = []
        t_used = [False] * len(tunits)
        f_used = [False] * len(funits)
        groups = list(scope_pairs) + [None]  # None = everything else
        for pair in groups:
            if pair is None:
                tg = [i for i in range(len(tunits)) if not t_used[i]]
                fg = [i for i in range(len(funits)) if not f_used[i]]
            else:
                tp, fp = pair
                tg = [
                    i
                    for i, (_, name, _t) in enumerate(tunits)
                    if not t_used[i] and name.startswith(tp)
                ]
                fg = [
                    i
                    for i, (_, path, _t) in enumerate(funits)
                    if not f_used[i] and path.startswith(fp)
                ]
            for i in tg:
                t_used[i] = True
            for i in fg:
                f_used[i] = True
            sub_aligned = _match_units(
                [tunits[i] for i in tg], [funits[i] for i in fg]
            )
            total_aligned.extend(sub_aligned)
        aligned = total_aligned
        for fkind, fpath, funit, tensors in aligned:
            _assign(params, stats, fkind, fpath, funit, tensors)
        _strip_helper_keys(params)
        new_vars = dict(variables)
        new_vars["params"] = params
        if stats:
            new_vars["batch_stats"] = stats
        return new_vars, len(aligned)

    aligned = _match_units(tunits, funits)

    for fkind, fpath, funit, tensors in aligned:
        _assign(params, stats, fkind, fpath, funit, tensors)
    _strip_helper_keys(params)

    new_vars = dict(variables)
    new_vars["params"] = params
    if stats:
        new_vars["batch_stats"] = stats
    return new_vars, len(aligned)


def _match_units(tunits, funits):
    """Match per kind in order, with shape-aware lookahead: flax's lifted
    transforms (nn.scan) can reorder siblings alphabetically, so strict
    positional pairing fails on locally-permuted units.  Within a kind,
    each flax unit takes the first unused torch unit whose shapes are
    compatible — identical-shape units keep their relative order."""

    def _eff_kind(tkind, tensors, fkind):
        if fkind == "embedding" and tkind == "linear" and "bias" not in tensors:
            return "embedding"
        if (
            fkind == "param"
            and tkind == "conv1d"
            and "bias" not in tensors
            and np.ndim(tensors["weight"]) == 3
            and tensors["weight"].shape[1] == 1
        ):
            # depthwise FIR filter: torch TrTimeInvFIRFilter stores taps as
            # a flipped (C, 1, K) conv kernel (reference dsp.py:119); the
            # flax filter keeps a bare (C, K) 'taps' param with taps[:, 0]
            # the current sample
            return "param"
        return tkind

    if len(tunits) != len(funits):
        fk = [k for k, _, _ in funits]
        tk = [k for k, _, _ in tunits]
        raise ValueError(
            f"unit count mismatch: {len(tunits)} torch vs {len(funits)} "
            f"flax units (torch kinds {tk}, flax kinds {fk})"
        )
    used = [False] * len(tunits)
    aligned = []
    for fkind, fpath, funit in funits:
        choice = None
        for ti, (tkind, tname, tensors) in enumerate(tunits):
            if used[ti] or _eff_kind(tkind, tensors, fkind) != fkind:
                continue
            if _shapes_compatible(fkind, funit, tensors):
                choice = ti
                break
        if choice is None:
            raise ValueError(
                f"shape mismatch: no unused torch {fkind} unit fits flax "
                f"{fpath}"
            )
        used[choice] = True
        aligned.append((fkind, fpath, funit, tunits[choice][2]))
    if not all(used):
        left = [tunits[i][1] for i in range(len(tunits)) if not used[i]]
        raise ValueError(f"torch units left over after matching: {left}")
    return aligned


def _strip_helper_keys(tree):
    if isinstance(tree, dict):
        tree.pop("_wn_scale_node", None)
        for v in tree.values():
            _strip_helper_keys(v)


def _tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def port_torch_checkpoint(
    checkpoint_path,
    variables: Dict,
    state_dict_key: Optional[str] = "state_dict",
) -> Tuple[Dict, int]:
    """Load a torch checkpoint file and port it onto flax variables."""
    import torch

    ckpt = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    sd = ckpt.get(state_dict_key, ckpt) if isinstance(ckpt, dict) else ckpt
    sd = {k: v.numpy() for k, v in sd.items()}
    return torch_to_flax(sd, variables)


# ------------------------------------------------- the port's templates
# JAX runs these scopes under ``nn.scan``, whose lifted variables come back
# with their children in name order, not in creation order
SCANNED_SCOPES = ("_ARDecoderCore",)
# flax's OptimizedLSTMCell creates its gates' input and hidden kernels in turn
_CELL_ORDER = ("ii", "hi", "if", "hf", "ig", "hg", "io", "ho")


def template_variables(module, seed: int = 0) -> Dict:
    """Flax-layout variables of the port's ``module`` to port a reference
    checkpoint onto: the values of ``utils/flax_init.init_variables`` (every
    leaf is overwritten by the port or stays a seeded draw), the keys in
    the order the JAX package's ``utils/templates.init_template`` gives the
    flax twin, which decides how same-shaped units pair up (and the key
    order of the ``.params`` written).  That order is the module tree's
    (``utils/flax_port.torch_to_flax``), an LSTM cell's gates as flax
    creates them, a module's scope in its ``FLAX_ORDER`` where it names
    one, and the scopes of ``SCANNED_SCOPES`` modules sorted by name."""
    from ensemble_svs_with_interactions_tpu_torch.utils import flax_port
    from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
        init_variables,
    )

    values = init_variables(module, seed)
    order = flax_port.torch_to_flax(module)
    subs = dict(module.named_modules())
    scanned = {tuple(name.split(".")) for name, sub in subs.items()
               if name and type(sub).__name__ in SCANNED_SCOPES}

    def arrange(keys_node, value_node, path, in_scan):
        in_scan = in_scan or path in scanned
        keys = list(keys_node)
        if in_scan:
            keys = sorted(keys)
        elif set(keys) == set(_CELL_ORDER):
            keys = list(_CELL_ORDER)
        else:
            order = getattr(subs.get(".".join(path)), "FLAX_ORDER", ())
            keys = [k for k in order if k in keys_node] + [
                k for k in keys if k not in order]
        return {k: (arrange(keys_node[k], value_node[k], path + (k,), in_scan)
                    if isinstance(keys_node[k], dict) else value_node[k])
                for k in keys}

    out = {"params": arrange(order["params"], values["params"], (), False)}
    if "batch_stats" in values:
        out["batch_stats"] = arrange(order["batch_stats"],
                                     values["batch_stats"], (), False)
    return out
