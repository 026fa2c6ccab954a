"""Merge separately trained stream postfilters into one packed
``MultistreamPostFilter`` (``postfilter_model.{yaml,params}`` in the flax
layout, which both packages' ``SPSVS`` open).

Usage: python -m ensemble_svs_with_interactions_tpu_torch.bin.merge_postfilters
       <out_dir> --mgc-config c.yaml --mgc-ckpt p.ckpt
       [--bap-config c.yaml --bap-ckpt p.ckpt] [--stream-sizes 60,1,1,5]

A config whose ``netG`` is a plain postfilter (a ``Conv2dPostFilter``)
becomes the merged filter's ``mgc_postfilter`` (``bap_postfilter``) with
its checkpoint's whole params, as in the JAX package's
``bin/merge_postfilters.py``.  A config whose ``netG`` is itself a
``MultistreamPostFilter`` (the shipped ``postfilter_mgc.yaml`` and
``postfilter_bap.yaml``) gives its trained ``mgc_postfilter``
(``bap_postfilter``), with that subtree of the params and its offset, as
the reference's ``utils/merge_postfilters.py`` takes the
``mgc_postfilter.*`` (``bap_postfilter.*``) weights.  The JAX merge nests
such a ``netG`` whole, and its pack cannot run: the nested filter splits
the 58 mgc dims as 60 + 1 + 1 + 5 and gives its frame-wise noise layer 56
inputs where it was trained on 58.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ensemble_svs_with_interactions_tpu_torch.utils import flax_msgpack
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    load_config,
    save_config,
)

_PF = "ensemble_svs_with_interactions_tpu.models.postfilters."


def _load_params(ckpt_path):
    tree = flax_msgpack.from_bytes(Path(ckpt_path).read_bytes())
    return tree.get("params", tree)


def stream_postfilter(config_path, ckpt_path, name: str):
    """(netG config, params or None, offset or None) of the ``name``
    (``mgc_postfilter`` / ``bap_postfilter``) postfilter trained with the
    config at ``config_path`` into ``ckpt_path`` (None: no params)."""
    net = dict(load_config(config_path).netG)
    params = _load_params(ckpt_path) if ckpt_path else None
    if not str(net["_target_"]).endswith("MultistreamPostFilter"):
        return net, params, None
    if net.get(name) is None:
        raise ValueError(f"{config_path}: its MultistreamPostFilter trains "
                         f"no {name}")
    offset = net.get(f"{name[:3]}_offset", 2 if name[:3] == "mgc" else 0)
    return (dict(net[name]), None if params is None else params[name],
            int(offset))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out_dir")
    ap.add_argument("--mgc-config", required=True)
    ap.add_argument("--mgc-ckpt", required=True)
    ap.add_argument("--bap-config", default=None)
    ap.add_argument("--bap-ckpt", default=None)
    ap.add_argument("--stream-sizes", default="60,1,1,5")
    args = ap.parse_args(argv)

    stream_sizes = [int(s) for s in args.stream_sizes.split(",")]
    netG = {"_target_": _PF + "MultistreamPostFilter",
            "mgc_postfilter": None, "bap_postfilter": None,
            "lf0_postfilter": None, "stream_sizes": stream_sizes}
    params = {}
    for name, cfg, ckpt in (("mgc_postfilter", args.mgc_config,
                             args.mgc_ckpt),
                            ("bap_postfilter", args.bap_config,
                             args.bap_ckpt)):
        if cfg is None:
            continue
        net, tree, offset = stream_postfilter(cfg, ckpt, name)
        netG[name] = net
        if offset is not None:
            netG[f"{name[:3]}_offset"] = offset
        if tree is not None:
            params[name] = tree
    merged_cfg = {
        "netG": netG,
        "stream_sizes": stream_sizes,
        "has_dynamic_features": [False] * len(stream_sizes),
        "num_windows": 1,
    }
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    save_config(merged_cfg, out_dir / "postfilter_model.yaml")
    with open(out_dir / "postfilter_model.params", "wb") as f:
        flax_msgpack.dump({"params": params}, f)
    print(f"merged postfilter -> {out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
